"""Error hierarchy (the port's copy of slate_tpu/exceptions.py).

The classes and their attributes match the reference one for one, so a
caller's ``except`` clauses carry over unchanged.
"""

from __future__ import annotations


class SlateError(Exception):
    """Base error (ref: Exception.hh ``slate::Exception``)."""


class SlateValueError(SlateError, ValueError):
    """Invalid argument (shape/uplo/op mismatches)."""


class SlateUnsupportedDtypeError(SlateValueError):
    """A boundary was handed a dtype it cannot serve; ``dtype`` carries the
    canonical spelling that was rejected."""

    def __init__(self, msg: str, dtype: str = ""):
        super().__init__(msg)
        self.dtype = dtype


class SlateNotConvergedError(SlateError):
    """Iterative routine failed to converge."""

    def __init__(self, msg: str, iters: int = -1):
        super().__init__(msg)
        self.iters = iters


class SlateNotPositiveDefiniteError(SlateError):
    """potrf encountered a non-positive-definite matrix."""

    def __init__(self, msg: str, info: int = 0):
        super().__init__(msg)
        self.info = info


class SlateSingularError(SlateError):
    """Factorization hit an exactly-zero (or non-finite) pivot; ``info`` is
    the 1-based index of the first unusable pivot, 0 when unknown."""

    def __init__(self, msg: str, info: int = 0):
        super().__init__(msg)
        self.info = info


class SlateServeError(SlateError):
    """Serving front-door failure (admission, flush, watchdog)."""


class SlateServeTimeoutError(SlateServeError):
    """A request or flush ran out of time; ``reason`` says which."""

    def __init__(self, msg: str, reason: str = "timeout"):
        super().__init__(msg)
        self.reason = reason


class SlateServeOverloadError(SlateServeError):
    """Admission control rejected or shed a request; ``policy`` names the
    overflow policy that fired."""

    def __init__(self, msg: str, policy: str = "reject"):
        super().__init__(msg)
        self.policy = policy


class SlateCheckpointError(SlateError):
    """A checkpoint could not be trusted for resume; ``reason`` names the
    rung that refused, ``step`` the panel step it claimed (-1 unknown)."""

    def __init__(self, msg: str, reason: str = "corrupt", step: int = -1):
        super().__init__(msg)
        self.reason = reason
        self.step = step


def slate_error(cond: bool, msg: str = "error") -> None:
    """Raise SlateValueError unless ``cond`` (ref: Exception.hh slate_error)."""
    if not cond:
        raise SlateValueError(msg)


def slate_assert(cond: bool, msg: str = "assertion failed") -> None:
    """Internal-consistency assert (ref: Exception.hh slate_assert)."""
    if not cond:
        raise AssertionError(msg)
