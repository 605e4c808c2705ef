"""Scalar/structure type vocabulary (the port's copy of slate_tpu/types.py).

The enums keep the reference's values so that a view's ``op``/``uplo``
metadata carries over between the two packages by value
(slate_tpu_torch/convert.py).
"""

from __future__ import annotations

import enum

import torch


class Op(enum.Enum):
    NoTrans = "n"
    Trans = "t"
    ConjTrans = "c"


class Uplo(enum.Enum):
    Lower = "l"
    Upper = "u"
    General = "g"


class Diag(enum.Enum):
    NonUnit = "n"
    Unit = "u"


class Side(enum.Enum):
    Left = "l"
    Right = "r"


class Layout(enum.Enum):
    ColMajor = "c"
    RowMajor = "r"


class Norm(enum.Enum):
    One = "1"
    Inf = "i"
    Max = "m"
    Fro = "f"


class TileKind(enum.Enum):
    """Provenance of a tile buffer: user-imported, framework-allocated or
    transient workspace (ref: Tile.hh TileKind)."""

    SlateOwned = "owned"
    UserOwned = "user"
    Workspace = "workspace"


def compose_op(a: Op, b: Op) -> Op:
    """op composition for stacked transpose views (ref: Tile.hh:40-90)."""
    if b is Op.NoTrans:
        return a
    if a is Op.NoTrans:
        return b
    if a is b:
        return Op.NoTrans
    # Trans o ConjTrans = Conj: the reference forbids this too.
    raise ValueError("unsupported op composition (conj-only view)")


def is_complex(dtype: torch.dtype) -> bool:
    return dtype.is_complex


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype if dtype.is_complex \
        else dtype


def lower_precision(dtype: torch.dtype) -> torch.dtype:
    """Factorisation precision of the mixed solvers (ref: types.py:87-97):
    f64 -> f32, c128 -> c64, f32 -> bf16; any other dtype maps to
    itself."""
    return {torch.float64: torch.float32, torch.complex128: torch.complex64,
            torch.float32: torch.bfloat16}.get(dtype, dtype)


def eps(dtype: torch.dtype) -> float:
    return float(torch.finfo(real_dtype(dtype)).eps)
