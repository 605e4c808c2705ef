"""Options / enums (the port's copy of slate_tpu/options.py).

The keys and values are the reference's, so an options map written for
``slate_tpu`` means the same here.
"""

from __future__ import annotations

import enum
from typing import Any, Mapping


class Target(enum.Enum):
    """Execution target (ref: enums.hh:33-39).

    auto    pick from the matrix' grid (mesh if p*q > 1 else single)
    single  one device, blocked algorithm on the whole matrix
    mesh    the distributed kernels over the grid's process group
            (slate_tpu_torch.parallel), where the grid has one
    """

    auto = "auto"
    single = "single"
    mesh = "mesh"

    # Reference spellings kept as aliases so ported call sites read naturally.
    HostTask = "single"
    Devices = "mesh"


class ErrorPolicy(enum.Enum):
    """Failure-surfacing contract for factor/solve drivers (robust/health.py).

    Raise  raise the typed exception (SlateNotPositiveDefiniteError, ...)
    Nan    never raise; failed results are NaN-poisoned
    Info   never raise, never poison; also return the HealthInfo
    """

    Raise = "raise"
    Nan = "nan"
    Info = "info"


class Speculate(enum.Enum):
    """Speculate-then-certify execution mode; Auto currently means Off."""

    Auto = "auto"
    Off = "off"
    On = "on"


class Abft(enum.Enum):
    """Algorithm-based fault tolerance mode; Auto currently means Off."""

    Auto = "auto"
    Off = "off"
    On = "on"


class Precision(enum.Enum):
    """Working-precision policy of the certified low-precision rung; Auto
    currently means F32."""

    Auto = "auto"
    F32 = "f32"
    Bf16 = "bf16"


class Option(enum.Enum):
    """Option keys (ref: enums.hh:69-101)."""

    Lookahead = "lookahead"
    BlockSize = "block_size"
    InnerBlocking = "inner_blocking"
    MaxPanelThreads = "max_panel_threads"
    MaxIterations = "max_iterations"
    Tolerance = "tolerance"
    Target = "target"
    ErrorPolicy = "error_policy"
    Speculate = "speculate"
    Abft = "abft"
    Precision = "precision"
    UseFallbackSolver = "use_fallback_solver"
    PivotThreshold = "pivot_threshold"
    MethodGemm = "method_gemm"
    MethodHemm = "method_hemm"
    MethodTrsm = "method_trsm"
    MethodCholQR = "method_cholqr"
    MethodGels = "method_gels"
    MethodLU = "method_lu"
    MethodEig = "method_eig"
    MethodSvd = "method_svd"
    HoldLocalWorkspace = "hold_local_workspace"
    Depth = "depth"
    PrintVerbose = "print_verbose"
    PrintEdgeItems = "print_edgeitems"
    PrintWidth = "print_width"
    PrintPrecision = "print_precision"


class MethodGemm(enum.Enum):
    """gemm variant selection (ref: method.hh:76-112).  On one device both
    variants are the same product; the choice is read and validated."""

    Auto = "auto"
    gemmA = "gemmA"  # stationary A, reduce over C owners
    gemmC = "gemmC"  # stationary C (SUMMA); default for nt >= 2


class MethodTrsm(enum.Enum):
    """trsm variant (ref: method.hh:25-74): the operand that stays where
    it is when A and B live on different grids."""

    Auto = "auto"
    trsmA = "trsmA"  # stationary A
    trsmB = "trsmB"  # stationary B; default


class MethodHemm(enum.Enum):
    Auto = "auto"
    hemmA = "hemmA"
    hemmC = "hemmC"


class MethodCholQR(enum.Enum):
    """A^H A accumulation method inside cholqr (ref: method.hh:114-160)."""

    Auto = "auto"
    GemmA = "gemmA"
    GemmC = "gemmC"
    HerkC = "herkC"


class MethodGels(enum.Enum):
    """Least-squares path (ref: method.hh:236-275)."""

    Auto = "auto"
    QR = "qr"
    CholQR = "cholqr"


class MethodLU(enum.Enum):
    """LU pivoting variant (ref: method.hh:277-316)."""

    Auto = "auto"
    PartialPiv = "PPLU"
    CALU = "CALU"  # tournament pivoting (tntpiv)
    NoPiv = "NoPiv"


class MethodEig(enum.Enum):
    """Stage-2 eigensolver seam (ref: heev.cc:79 MethodEig).

    Auto: eigendecompose the stage-1 band directly with the library's
    eigh (no bulge chase: the library's dense eigh is O(n^3) whatever the
    bandwidth).  QR / DC: the parity routes, through the hb2st bulge chase
    to a true tridiagonal, then the library's eigh of T (QR, the steqr2
    analog) or the native divide and conquer (DC, drivers/stedc.py)."""

    Auto = "auto"
    QR = "qr"
    DC = "dc"


class MethodSvd(enum.Enum):
    """Stage-2 SVD seam, as MethodEig (ref: svd.cc:286 bdsqr).

    Auto: SVD of the stage-1 band directly.  Bidiag: the parity route,
    the tb2bd bulge chase to a true bidiagonal, then the bdsqr seam."""

    Auto = "auto"
    Bidiag = "bidiag"


class NormScope(enum.Enum):
    """What a norm reduces over (ref: enums.hh NormScope)."""

    Columns = "columns"
    Rows = "rows"
    Matrix = "matrix"


class GridOrder(enum.Enum):
    """Process-grid numbering order (ref: enums.hh:127-131)."""

    Col = "col"
    Row = "row"


Options = Mapping[Option, Any]

# The defaults of the options the ported slices read; every other key reads
# as None until the slice that uses it brings its default over.
_DEFAULTS = {
    Option.MaxPanelThreads: 4,
    Option.Lookahead: 1,
    Option.InnerBlocking: 16,
    Option.MaxIterations: 30,
    Option.Tolerance: None,
    Option.Target: Target.auto,
    Option.ErrorPolicy: ErrorPolicy.Raise,
    Option.Speculate: Speculate.Auto,
    Option.Abft: Abft.Auto,
    Option.Precision: Precision.Auto,
    Option.UseFallbackSolver: True,
    Option.PivotThreshold: 1.0,
    Option.MethodGemm: MethodGemm.Auto,
    Option.MethodHemm: MethodHemm.Auto,
    Option.MethodTrsm: MethodTrsm.Auto,
    Option.MethodCholQR: MethodCholQR.Auto,
    Option.MethodGels: MethodGels.Auto,
    Option.MethodLU: MethodLU.Auto,
    Option.MethodEig: MethodEig.Auto,
    Option.MethodSvd: MethodSvd.Auto,
    Option.HoldLocalWorkspace: False,
    Option.Depth: 2,
    Option.PrintVerbose: 4,
    Option.PrintEdgeItems: 16,
    Option.PrintWidth: 10,
    Option.PrintPrecision: 4,
}

_UNSET = object()

# string spellings ({Option.Target: "mesh"}) are coerced to the enum here
_ENUM_VALUED = {Option.Target: Target, Option.ErrorPolicy: ErrorPolicy,
                Option.Speculate: Speculate, Option.Abft: Abft,
                Option.Precision: Precision}


def options_fingerprint(opts: Options | None) -> tuple:
    """Canonical, hashable digest of an options dict, the key of a cached
    callable or graph (serve/cache.py, posv's HoldLocalWorkspace).
    Order-insensitive; enum keys and values collapse to their names so
    equivalent spellings agree."""
    items = []
    for k, v in (opts or {}).items():
        kn = getattr(k, "name", str(k))
        vn = getattr(v, "name", None) or str(v)
        items.append((kn, vn))
    return tuple(sorted(items))


def get_option(opts: Options | None, key: Option,
               default: Any = _UNSET) -> Any:
    """Read one option with framework defaults (ref: types.hh:180-206).
    An explicitly passed ``default`` wins even when it is None."""
    if opts and key in opts:
        val = opts[key]
    elif default is not _UNSET:
        val = default
    else:
        val = _DEFAULTS.get(key)
    coerce = _ENUM_VALUED.get(key)
    if coerce is not None and isinstance(val, str):
        val = coerce(val)
    return val


def resolve_target(opts: Options | None, matrix) -> Target:
    """Target::auto resolution: mesh iff the matrix lives on a >1-device
    grid (ref: options.py:308).  A driver takes its mesh route where the
    target is mesh AND the grid carries a process group; on a serial grid
    ``Target.mesh`` takes the single route, as the reference's drivers do
    when the grid has no mesh."""
    t = get_option(opts, Option.Target)
    if t is not Target.auto:
        return t
    grid = getattr(matrix, "grid", None)
    if grid is not None and grid.size > 1:
        return Target.mesh
    return Target.single


def on_mesh(opts: Options | None, matrix) -> bool:
    """True when a driver takes its mesh route: the target resolves to
    mesh and the matrix' grid carries a process group (the reference's
    ``target is Target.mesh and grid.mesh is not None``)."""
    return (resolve_target(opts, matrix) is Target.mesh
            and matrix.grid.group is not None)


def resolve_speculate(opts: Options | None) -> bool:
    """Resolve Option.Speculate once at a driver boundary: True only for
    an explicit ``Speculate.On``.  The resolution is noted into the open
    obs event frame."""
    resolved = get_option(opts, Option.Speculate) is Speculate.On
    from .obs import events as _obs_events
    _obs_events.note_resolved("speculate", resolved)
    return resolved


def method_option(opts: Options | None, key: Option, enum_cls):
    """Read a method option (MethodGemm, MethodHemm, MethodCholQR,
    MethodGels), validated: a value that is not of its enum raises."""
    m = get_option(opts, key)
    if not isinstance(m, enum_cls):
        raise ValueError(f"{key.name}: expected a {enum_cls.__name__}, got "
                         f"{m!r}")
    return m


def select_gemm_method(opts: Options | None, nt: int) -> MethodGemm:
    """ref: method.hh:87-98: gemmA when C is a single block column, else
    gemmC."""
    m = method_option(opts, Option.MethodGemm, MethodGemm)
    if m is not MethodGemm.Auto:
        return m
    return MethodGemm.gemmA if nt < 2 else MethodGemm.gemmC


def select_trsm_method(opts: Options | None, nt: int) -> MethodTrsm:
    """ref: method.hh:56-74: trsmB (B stays) unless asked otherwise."""
    m = method_option(opts, Option.MethodTrsm, MethodTrsm)
    if m is not MethodTrsm.Auto:
        return m
    return MethodTrsm.trsmB


def select_gels_method(opts: Options | None, m: int, n: int) -> MethodGels:
    """ref: method.hh:236-275: CholQR for tall-skinny problems (m >= 3 n),
    else Householder QR."""
    meth = method_option(opts, Option.MethodGels, MethodGels)
    if meth is not MethodGels.Auto:
        return meth
    return MethodGels.CholQR if m >= 3 * n else MethodGels.QR


def select_lu_method(opts: Options | None) -> MethodLU:
    """MethodLU.Auto resolves to partial pivoting (ref: options.py:367)."""
    m = get_option(opts, Option.MethodLU)
    if m is not MethodLU.Auto:
        return m
    return MethodLU.PartialPiv


def resolve_abft(opts: Options | None) -> bool:
    """Resolve Option.Abft once at a driver boundary: True only for an
    explicit ``Abft.On``; Auto and Off resolve to False, so default
    drivers pay no checksum work.  Every consumer below the boundary
    receives the resolved boolean, never the knob.  The resolution is
    noted into the open obs event frame."""
    resolved = get_option(opts, Option.Abft) is Abft.On
    from .obs import events as _obs_events
    _obs_events.note_resolved("abft", resolved)
    return resolved
