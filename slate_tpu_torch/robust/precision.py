"""Precision policy seam: the one place dtype decisions are made (port of
slate_tpu/robust/precision.py).

``Option.Precision`` is resolved once per boundary, dtype spellings are
canonicalized by one helper (``normalize_dtype``: torch dtypes, numpy
dtypes and strings in, the reference's numpy names out), and every cast
between the two working precisions of the bf16 rung goes through
``demote``/``promote``.  The low precision is bf16 storage with f32
accumulation; acceptance is decided a-posteriori (robust/certify.py),
never at the cast site.
"""

from __future__ import annotations

import numpy as np
import torch

from ..exceptions import SlateUnsupportedDtypeError
from ..options import Option, Options, Precision, get_option

# canonical spellings of the two working precisions of the bf16 rung
HIGH = "float32"
LOW = "bfloat16"

# spellings np.dtype would mangle or reject; values are the canonical form
_ALIASES = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32",
            "f64": "float64", "fp64": "float64"}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64, "float16": torch.float16,
          "complex64": torch.complex64, "complex128": torch.complex128}


def normalize_dtype(dtype, *,
                    supported: tuple[str, ...] | None = None) -> str:
    """Canonicalize a dtype spelling (``torch.bfloat16``, a numpy dtype, a
    tensor's or array's ``.dtype``, or a string) to its numpy name, the one
    spelling the serving gate, the plan keys and the bucket ladders use.
    With ``supported`` given, a name outside the set raises
    :class:`SlateUnsupportedDtypeError` instead of letting the caller take
    a slow route quietly."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(getattr(dtype, "name", None), str):
        name = dtype.name
    else:
        spelled = _ALIASES.get(dtype, dtype) if isinstance(dtype, str) \
            else dtype
        if spelled == "bfloat16":
            name = "bfloat16"          # numpy has no bfloat16
        else:
            try:
                name = np.dtype(spelled).name
            except TypeError as exc:
                raise SlateUnsupportedDtypeError(
                    f"unrecognized dtype spelling {dtype!r}",
                    str(dtype)) from exc
    if supported is not None and name not in supported:
        raise SlateUnsupportedDtypeError(
            f"dtype {name} not supported here (supported: "
            f"{', '.join(supported)})", name)
    return name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a canonical name."""
    return _TORCH[normalize_dtype(name)]


def resolve_precision(opts: Options | None) -> bool:
    """Resolve Option.Precision once at a boundary: True only for an
    explicit ``Precision.Bf16`` (Auto means F32, so default numerics are
    unchanged)."""
    return get_option(opts, Option.Precision) is Precision.Bf16


def demote(x: torch.Tensor) -> torch.Tensor:
    """Cast to the low working precision (bf16 storage)."""
    return x.to(torch.bfloat16)


def promote(x: torch.Tensor) -> torch.Tensor:
    """Cast to the high working precision (f32): the refine/certify side of
    the factor-low/refine-high split."""
    return x.to(torch.float32)


def round_through(x: torch.Tensor) -> torch.Tensor:
    """Round through bf16 storage and back to ``x``'s own dtype: exact for
    values bf16 holds (identity blocks, zero padding), a half bf16 ulp
    otherwise."""
    return x.to(torch.bfloat16).to(x.dtype)
