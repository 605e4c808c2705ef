"""Analytic flop/byte models per public op: the MFU denominator (port of
slate_tpu/obs/flops.py).

Every GFLOP/s and roofline bound the port prints comes from here
(``chip_smoke.py`` reads ``op_flops`` and the chip table below), so a
smoke line and any later benchmark line for the same shapes agree about
what "the flops" are.  Formulas follow the reference tester's nominal
counts (gemm 2mnk ref src/gemm.cc:24, potrf n^3/3 ref src/potrf.cc:334,
getrf 2n^3/3, geqrf 2mn^2 - 2n^3/3 -- testsweeper gflop helpers); methods
that do different work (gels via CholQR, svd via one- vs two-stage)
report the NOMINAL count for the op, as the reference tester does.  Ops
whose drivers the port does not carry yet keep their models: a model is
arithmetic, and the tests hold every one against the reference.

A model receives the recorded ``shapes`` (one entry per Matrix-like
argument) and may return ``None`` when those shapes cannot determine the
cost.  The ``batch_*`` models also accept the serving layer's per-problem
live-size vector and sum LIVE work only.

Byte models are the analytic minimum traffic -- each operand read once
plus a result of the first operand's footprint written once -- used for
``achieved_gbps``; real traffic is higher, so the number is a lower bound
on attained bandwidth.
"""

from __future__ import annotations

import contextlib
import threading

_MODELS: dict = {}
_PEAK_LOCK = threading.Lock()
_PEAK: dict = {}                   # dtype name -> cached peak (or None)
_PEAK_OVERRIDE: list = [None]

#: dense peaks per card, keyed by a lowercase substring of
#: ``torch.cuda.get_device_name()`` and by STORAGE dtype.  f32 is the rate
#: of the CUDA cores, and every f32 ``mfu`` is taken against it: the port
#: never runs an f32 product as one TF32 pass.  Its one f32 product on the
#: tensor cores, K2's update at nb = 256..512, is a split product (3xTF32:
#: each operand as two TF32 parts, three passes, ~f32 accuracy), bounded
#: by :func:`split_product_seconds` against TF32_TABLE.  float64 is ABSENT:
#: an f64 line reads ``mfu: n/a``.
PEAK_TABLE = (
    # NVIDIA H100 SXM5 datasheet: FP32 67 TFLOP/s, BF16 tensor core
    # 989 TFLOP/s dense (1979 is with 2:4 sparsity); the card reports
    # itself as "NVIDIA H100 80GB HBM3" (700 W board)
    ("h100", {"bfloat16": 989e12, "float32": 67e12}),
)

#: the tensor cores' dense TF32 rate per card (FLOP/s), same keys as
#: PEAK_TABLE; read only by :func:`split_product_seconds`
TF32_TABLE = (
    # NVIDIA H100 SXM5 datasheet: TF32 tensor core 494.7 TFLOP/s dense
    # (989.4 is with 2:4 sparsity)
    ("h100", 494.7e12),
)

#: memory rate per card (bytes/s), same keys as PEAK_TABLE
BANDWIDTH_TABLE = (
    # NVIDIA H100 SXM5 datasheet: HBM3, 3.35 TB/s ("NVIDIA H100 80GB HBM3")
    ("h100", 3.35e12),
)

#: dtype assumed when a caller does not say (the reference's: the
#: headline rate of every card is its bf16 one)
DEFAULT_PEAK_DTYPE = "bfloat16"


def register(*names):
    """Register one analytic flop model under the given op names."""
    def deco(fn):
        for name in names:
            if name in _MODELS:
                raise ValueError(f"duplicate flops model for {name!r}")
            _MODELS[name] = fn
        return fn
    return deco


def registered_ops() -> frozenset:
    return frozenset(_MODELS)


def op_flops(op: str, shapes, sizes=None) -> float | None:
    """Analytic flop count for one call of ``op`` on ``shapes`` (the
    argument shapes), or None when unregistered or the shapes cannot
    determine the cost.  ``sizes`` is the serving layer's live-size
    vector, consumed by the ``batch_*`` models only."""
    model = _MODELS.get(op)
    if model is None:
        return None
    try:
        return model([tuple(int(d) for d in s) for s in shapes], sizes)
    except (TypeError, ValueError, IndexError):
        return None


def op_bytes(op: str, shapes, dtype) -> float | None:
    """Analytic minimum memory traffic: every operand read once plus a
    result the size of the first operand written once."""
    if op not in _MODELS or not shapes:
        return None
    item = _itemsize(dtype)
    try:
        elems = sum(_prod(s) for s in shapes) + _prod(shapes[0])
    except (TypeError, ValueError):
        return None
    return float(elems) * item


def _itemsize(dtype) -> int:
    name = str(dtype or "")
    for tag, size in (("128", 16), ("64", 8), ("32", 4), ("16", 2),
                      ("8", 1)):
        if name.endswith(tag):
            return size
    return 4


def _prod(shape) -> float:
    out = 1.0
    for d in shape:
        out *= int(d)
    return out


# ---------------------------------------------------------------- peak


def _peak_dtype(dtype) -> str:
    """Normalize a peak-table dtype key through the one shared spelling
    helper (robust/precision.py).  Observability never throws: an
    unrecognized spelling degrades to itself and misses the table."""
    if dtype is None:
        return DEFAULT_PEAK_DTYPE
    from ..robust.precision import normalize_dtype
    try:
        return normalize_dtype(dtype)
    except Exception:
        return str(dtype)


def _device_kind() -> str | None:
    """The local card's name in lowercase, or None off the card."""
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name().lower()
    except Exception:                        # no driver at all
        return None


def chip_peak(dtype=None):
    """(dense peak FLOP/s or None, device kind) for the local card --
    PEAK_TABLE keyed by ``torch.cuda.get_device_name()`` and the storage
    ``dtype`` (default bf16).  Off the card: ``(None, "cpu")``."""
    dt = _peak_dtype(dtype)
    kind = _device_kind()
    if kind is None:
        return None, "cpu"
    for key, peaks in PEAK_TABLE:
        if key in kind:
            return peaks.get(dt), kind
    return None, kind


def chip_bandwidth():
    """(memory rate in bytes/s or None, device kind) for the local card,
    from BANDWIDTH_TABLE.  Off the card: ``(None, "cpu")``."""
    kind = _device_kind()
    if kind is None:
        return None, "cpu"
    for key, rate in BANDWIDTH_TABLE:
        if key in kind:
            return rate, kind
    return None, kind


def split_product_seconds(flops: float,
                          kind: str | None = None) -> float | None:
    """The least time of an f32 product of ``flops`` (2 m n k) run on the
    tensor cores as a 3xTF32 split product (three TF32 passes: hi*hi +
    hi*lo + lo*hi): 3 * flops / the TF32 rate of the card named ``kind``
    (default: the local card), from TF32_TABLE.  None off the card or for
    a card the table lacks."""
    kind = _device_kind() if kind is None else kind.lower()
    if kind is None:
        return None
    for key, rate in TF32_TABLE:
        if key in kind:
            return 3 * flops / rate
    return None


def peak(dtype=None) -> float | None:
    """The cached card peak (FLOP/s) for ``dtype`` (default bf16),
    honoring :func:`peak_override` -- an override pins EVERY dtype."""
    if _PEAK_OVERRIDE[0] is not None:
        return _PEAK_OVERRIDE[0]
    dt = _peak_dtype(dtype)
    with _PEAK_LOCK:
        if dt not in _PEAK:
            _PEAK[dt] = chip_peak(dt)[0]
        return _PEAK[dt]


@contextlib.contextmanager
def peak_override(value: float | None):
    """Pin the card peak for the scope (tests, off-card MFU)."""
    prev = _PEAK_OVERRIDE[0]
    _PEAK_OVERRIDE[0] = value
    try:
        yield
    finally:
        _PEAK_OVERRIDE[0] = prev


def mfu(flops: float | None, seconds: float | None,
        dtype=None) -> float | None:
    """flops / seconds as a fraction of the card peak for ``dtype``
    (default bf16), or None when any ingredient (flops model, timing,
    known peak) is missing."""
    p = peak(dtype)
    if not flops or not seconds or seconds <= 0 or not p:
        return None
    return round(flops / seconds / p, 4)


def achieved_gbps(nbytes: float | None, seconds: float | None
                  ) -> float | None:
    if not nbytes or not seconds or seconds <= 0:
        return None
    return round(nbytes / seconds / 1e9, 3)


# -------------------------------------------------------------- models
#
# Dimension conventions: _s(shapes, i) is the i-th recorded argument
# shape; k (rhs count) defaults to the second shape's trailing dim.


def _s(shapes, i):
    if i >= len(shapes) or len(shapes[i]) < 1:
        raise ValueError("missing shape")
    return shapes[i]


def _rhs(shapes, default=1):
    try:
        s = _s(shapes, 1)
        return s[-1] if len(s) >= 2 else default
    except ValueError:
        return default


@register("gemm")
def _f_gemm(shapes, sizes):
    (m, k), (_, n) = _s(shapes, 0)[:2], _s(shapes, 1)[:2]
    return 2.0 * m * k * n


@register("trsm", "trmm")
def _f_trsm(shapes, sizes):
    m = _s(shapes, 0)[0]
    return float(m) * m * _rhs(shapes)


@register("herk", "syrk")
def _f_herk(shapes, sizes):
    n, k = _s(shapes, 0)[:2]
    return float(n) * n * k


@register("her2k", "syr2k")
def _f_her2k(shapes, sizes):
    n, k = _s(shapes, 0)[:2]
    return 2.0 * n * n * k


@register("hemm")
def _f_hemm(shapes, sizes):
    m = _s(shapes, 0)[0]
    return 2.0 * m * m * _rhs(shapes)


@register("potrf", "potrf_ooc")
def _f_potrf(shapes, sizes):
    n = _s(shapes, 0)[0]
    return n ** 3 / 3.0


@register("potrs", "hetrs", "getrs")
def _f_potrs(shapes, sizes):
    n = _s(shapes, 0)[0]
    return 2.0 * n * n * _rhs(shapes)


@register("posv", "posv_mixed", "posv_mixed_gmres", "hesv")
def _f_posv(shapes, sizes):
    n, k = _s(shapes, 0)[0], _rhs(shapes)
    return n ** 3 / 3.0 + 2.0 * n * n * k


@register("potri", "trtri", "trtrm")
def _f_potri(shapes, sizes):
    n = _s(shapes, 0)[0]
    return n ** 3 / 3.0


@register("getrf", "getrf_nopiv", "getrf_tntpiv", "getrf_rbt", "hetrf",
          "getrf_ooc")
def _f_getrf(shapes, sizes):
    n = min(_s(shapes, 0)[:2]) if len(_s(shapes, 0)) >= 2 \
        else _s(shapes, 0)[0]
    return 2.0 * n ** 3 / 3.0


@register("gesv", "gesv_mixed", "gesv_mixed_gmres")
def _f_gesv(shapes, sizes):
    n, k = _s(shapes, 0)[0], _rhs(shapes)
    return 2.0 * n ** 3 / 3.0 + 2.0 * n * n * k


@register("getri", "getriOOP")
def _f_getri(shapes, sizes):
    n = _s(shapes, 0)[0]
    return 4.0 * n ** 3 / 3.0


@register("geqrf", "gelqf")
def _f_geqrf(shapes, sizes):
    m, n = _s(shapes, 0)[:2]
    hi, lo = max(m, n), min(m, n)           # gelqf is the transpose count
    return 2.0 * hi * lo * lo - 2.0 * lo ** 3 / 3.0


@register("unmqr", "unmlq")
def _f_unmqr(shapes, sizes):
    m, k = _s(shapes, 0)[:2]
    return 4.0 * m * k * _rhs(shapes, default=k)


@register("cholqr")
def _f_cholqr(shapes, sizes):
    m, n = _s(shapes, 0)[:2]
    return 2.0 * m * n * n + n ** 3 / 3.0


@register("gels", "gels_cholqr", "gels_qr")
def _f_gels(shapes, sizes):
    # nominal QR-path count regardless of method, as the reference tester
    m, n = _s(shapes, 0)[:2]
    return (2.0 * m * n * n - 2.0 * n ** 3 / 3.0
            + 4.0 * m * n * _rhs(shapes))


@register("heev", "heevd", "heev_vals", "stedc")
def _f_heev(shapes, sizes):
    n = _s(shapes, 0)[0]
    return 4.0 * n ** 3 / 3.0


@register("hegst")
def _f_hegst(shapes, sizes):
    n = _s(shapes, 0)[0]
    return float(n) ** 3


@register("hegv")
def _f_hegv(shapes, sizes):
    n = _s(shapes, 0)[0]
    return 8.0 * n ** 3 / 3.0               # hegst + potrf + heev


@register("steqr")
def _f_steqr(shapes, sizes):
    n = _s(shapes, 0)[0]
    return 6.0 * n ** 3 if any(len(s) >= 2 for s in shapes) else 9.0 * n * n


@register("sterf", "bdsqr", "tb2bd", "hb2st")
def _f_sterf(shapes, sizes):
    # values-only tridiagonal/band stages: O(n^2) nominal (the band
    # width is not an event shape; this is a documented lower bound)
    n = _s(shapes, 0)[0]
    return 9.0 * float(n) * n


@register("svd", "svd_vals")
def _f_svd(shapes, sizes):
    m, n = _s(shapes, 0)[:2]
    hi, lo = max(m, n), min(m, n)
    return 4.0 * hi * lo * lo - 4.0 * lo ** 3 / 3.0


@register("gecondest", "trcondest")
def _f_condest(shapes, sizes):
    n = _s(shapes, 0)[0]
    return 8.0 * float(n) * n               # a handful of n^2 solves


# serving batch kernels: live sizes sum when the vector is supplied,
# full-bucket nominal otherwise


def _batch_dims(shapes):
    s = _s(shapes, 0)
    if len(s) < 3:
        raise ValueError("batch op needs a [B, m, n] operand")
    return s[0], s[1], s[2]


@register("batch_potrf")
def _f_batch_potrf(shapes, sizes):
    b, _, n = _batch_dims(shapes)
    if sizes is not None:
        return sum(float(ni) ** 3 / 3.0 for ni in sizes)
    return b * n ** 3 / 3.0


@register("batch_getrf")
def _f_batch_getrf(shapes, sizes):
    b, _, n = _batch_dims(shapes)
    if sizes is not None:
        return sum(2.0 * float(ni) ** 3 / 3.0 for ni in sizes)
    return b * 2.0 * n ** 3 / 3.0


@register("batch_geqrf")
def _f_batch_geqrf(shapes, sizes):
    b, m, n = _batch_dims(shapes)
    if sizes is not None:
        return sum(2.0 * float(mi) * n * n - 2.0 * n ** 3 / 3.0
                   for mi in sizes)
    return b * (2.0 * m * n * n - 2.0 * n ** 3 / 3.0)


#: serving front-end op -> the driver model that prices one problem
SERVE_OP_MODEL = {"solve": "gesv", "chol_solve": "posv",
                  "least_squares_solve": "gels"}


def serve_flops(op: str, problems) -> float | None:
    """Summed LIVE flops for one served batch: ``problems`` is an
    iterable of (a_shape, b_shape) per real request — filler slots and
    padding contribute nothing, so MFU from this number is
    waste-adjusted by construction."""
    model_op = SERVE_OP_MODEL.get(op)
    if model_op is None:
        return None
    total = 0.0
    for a_shape, b_shape in problems:
        fl = op_flops(model_op, [a_shape, b_shape])
        if fl is None:
            return None
        total += fl
    return total
