"""Matrix printing: format_matrix, print_matrix (port of
slate_tpu/drivers/printing.py; ref: src/print.cc, Option::PrintVerbose /
PrintEdgeItems / PrintWidth / PrintPrecision, enums.hh:80-90).

The gather is ``to_numpy()`` (one copy to the host) and the renderer is
the reference's numpy host code, so a matrix and its options give the
reference's string character for character.  Verbosity:

    0  print nothing
    1  metadata only (type, dims, tiling, grid)
    2  edgeitems view: corners + ellipses (numpy printoptions style)
    3  full matrix when it fits (<= 2*edgeitems per dim), else edgeitems
    4  full matrix always
"""

from __future__ import annotations

import numpy as np

from ..core.matrix import (BaseBandMatrix, BaseMatrix, BaseTrapezoidMatrix,
                           HermitianBandMatrix)
from ..options import Option, Options, get_option


def _meta_line(name: str, A: BaseMatrix) -> str:
    kind = type(A).__name__
    extra = ""
    if isinstance(A, BaseBandMatrix):
        if isinstance(A, HermitianBandMatrix):
            extra = f", kd={A.kd}"
        else:
            extra = f", kl={A.kl}, ku={A.ku}"
    if isinstance(A, BaseTrapezoidMatrix):
        extra += f", uplo={A.uplo.name}"
    g = A.grid
    dtype = str(A.dtype).replace("torch.", "")
    return (f"% {name}: {kind} {A.m}x{A.n}, tiles {A.mb}x{A.nb}, "
            f"grid {g.p}x{g.q}{extra}, dtype {dtype}")


def format_matrix(name: str, A: BaseMatrix,
                  opts: Options | None = None) -> str:
    """Render a matrix to a string (print.cc's formatting core)."""
    verbose = get_option(opts, Option.PrintVerbose)
    if verbose == 0:
        return ""
    lines = [_meta_line(name, A)]
    if verbose == 1:
        return "\n".join(lines)

    edge = get_option(opts, Option.PrintEdgeItems)
    width = get_option(opts, Option.PrintWidth)
    prec = get_option(opts, Option.PrintPrecision)
    d = A.to_numpy()

    full = (verbose == 4 or
            (verbose == 3 and max(A.m, A.n) <= 2 * edge))
    threshold = d.size + 1 if full else 2 * edge
    with np.printoptions(precision=prec, linewidth=max(79, (width + 2) * 8),
                         threshold=threshold, edgeitems=edge,
                         suppress=False):
        body = np.array2string(d)
    lines.append(f"{name} = [")
    lines.append(body)
    lines.append("];")
    return "\n".join(lines)


def print_matrix(name: str, A: BaseMatrix,
                 opts: Options | None = None) -> None:
    """Print a matrix of any type (ref: slate::print overload set,
    src/print.cc), as the Print* options ask."""
    s = format_matrix(name, A, opts)
    if s:
        print(s)
