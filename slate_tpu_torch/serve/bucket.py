"""Shape bucketing for the serving layer: ladder + ragged packing (port of
slate_tpu/serve/bucket.py).

Mixed-size requests share a batch only when their shapes agree, so every
request is rounded UP to a bucket shape drawn from a ladder.  The default
ladder is geometric (each rung double the last, from 32): it bounds
padding waste by a constant factor while the number of distinct batch
shapes stays logarithmic in the size range, unless the plan cache holds
tuned rungs for this card (``python -m slate_tpu_torch.tune --serve-hist``,
read back through ``tune.serve_buckets``).

Packing is exact: a problem of size n in an n_b bucket is augmented with
the identity, blockdiag(A, I), so the augmented system decouples and the
first n components solve the original problem.  For least squares the
identity block goes into fresh rows, keeping the padded operand full-rank
and its Gram matrix HPD.  The packers take and return torch tensors on the
device they are given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_BASE = 32
DEFAULT_MAX = 8192


class BucketLadder(NamedTuple):
    """Ascending rung sizes; ``bucket_for`` rounds a size up to a rung.
    ``source`` records where the rungs came from ('geometric' or
    'tuned')."""

    rungs: tuple
    source: str = "geometric"

    def bucket_for(self, n: int) -> int:
        n = int(n)
        if n <= 0:
            raise ValueError(f"bucket_for: need a positive size, got {n}")
        for r in self.rungs:
            if n <= r:
                return int(r)
        # beyond the top rung: keep doubling so oversize requests still
        # bucket instead of erroring
        top = int(self.rungs[-1])
        while top < n:
            top *= 2
        return top


def geometric_ladder(base: int = DEFAULT_BASE,
                     top: int = DEFAULT_MAX) -> BucketLadder:
    rungs = []
    r = int(base)
    while r <= top:
        rungs.append(r)
        r *= 2
    return BucketLadder(tuple(rungs), "geometric")


def default_ladder(dtype: str = "float32") -> BucketLadder:
    """The serving ladder: the tuned rungs of the plan cache for this card
    and dtype when it has them (``source`` "tuned"), else the geometric
    default."""
    from ..robust.precision import normalize_dtype
    from ..tune.plans import serve_buckets
    tuned = serve_buckets(normalize_dtype(dtype))
    if tuned:
        return BucketLadder(tuple(int(r) for r in tuned), "tuned")
    return geometric_ladder()


def next_pow2(n: int) -> int:
    """Batch-count bucket: smallest power of two >= n (>= 1)."""
    n = max(int(n), 1)
    p = 1
    while p < n:
        p *= 2
    return p


def pad_square(a: torch.Tensor, nb: int) -> torch.Tensor:
    """blockdiag(A, I) in an (nb, nb) bucket: nonsingular iff A is, HPD
    iff A is."""
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"pad_square: need square A, got {tuple(a.shape)}")
    if n > nb:
        raise ValueError(f"pad_square: A ({n}) exceeds bucket ({nb})")
    out = torch.eye(nb, dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    return out


def pad_rows(b: torch.Tensor, mb: int, kb: int) -> torch.Tensor:
    """Zero-pad an (m, k) right-hand side into an (mb, kb) bucket."""
    m, k = b.shape
    if m > mb or k > kb:
        raise ValueError(f"pad_rows: B {tuple(b.shape)} exceeds bucket "
                         f"({mb}, {kb})")
    out = torch.zeros((mb, kb), dtype=b.dtype, device=b.device)
    out[:m, :k] = b
    return out


def pad_tall(a: torch.Tensor, mb: int, nb: int) -> torch.Tensor:
    """Identity-augment a tall (m, n) operand into an (mb, nb) bucket: the
    nb - n extra columns get an identity block in FRESH rows m : m + nb - n,
    so the columns stay independent and x_pad = [x; 0] exactly.  Needs
    mb >= m + (nb - n), which ``least_squares_buckets`` guarantees."""
    m, n = a.shape
    if m < n:
        raise ValueError(f"pad_tall: need m >= n, got {tuple(a.shape)}")
    extra = nb - n
    if m + extra > mb:
        raise ValueError(f"pad_tall: bucket ({mb}, {nb}) cannot hold "
                         f"{tuple(a.shape)} plus its {extra} identity rows")
    out = torch.zeros((mb, nb), dtype=a.dtype, device=a.device)
    out[:m, :n] = a
    if extra:
        out[m:m + extra, n:] = torch.eye(extra, dtype=a.dtype,
                                         device=a.device)
    return out


def solve_buckets(ladder: BucketLadder, n: int, k: int):
    """Bucket dims (nb, kb) for a square solve of (n, n) x (n, k)."""
    return ladder.bucket_for(n), next_pow2(k)


def least_squares_buckets(ladder: BucketLadder, m: int, n: int, k: int):
    """Bucket dims (mb, nb, kb) for least squares: nb first, then mb large
    enough for the identity-augmentation rows."""
    nb = ladder.bucket_for(n)
    mb = ladder.bucket_for(m + (nb - n))
    return mb, nb, next_pow2(k)


def padded_fraction(real_elems: int, bucket_elems: int) -> float:
    """Padding waste of one batch: 1 - real/bucket element ratio."""
    if bucket_elems <= 0:
        return 0.0
    return 1.0 - real_elems / bucket_elems
