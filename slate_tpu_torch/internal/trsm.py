"""internal::trsm: triangular inverses and blocked triangular solves (port
of slate_tpu/internal/trsm.py).

The reference has no Pallas kernel here: these are batched torch ops
(``torch.linalg.solve_triangular`` on small diagonal blocks, matmuls for
everything else), as the reference leaves them to XLA.  Every function
takes a leading batch of matrices where the reference vmaps.
"""

from __future__ import annotations

import torch

from ..exceptions import not_ported


def _diag_tiles(ad: torch.Tensor, K: int, nb: int) -> torch.Tensor:
    """[..., K, nb, nb] diagonal blocks of [..., K nb, K nb]."""
    t = ad.reshape(*ad.shape[:-2], K, nb, K, nb)
    return t.diagonal(dim1=-4, dim2=-2).movedim(-1, -3)


def tri_inv_lower(L: torch.Tensor, unit_diag: bool = False,
                  base: int = 32) -> torch.Tensor:
    """Inverse of lower-triangular [..., n, n] blocks in log depth: all
    ``base``-sized diagonal blocks inverted in one batched solve, then each
    doubling level merges sibling pairs,

      inv([[A, 0], [C, B]]) = [[inv(A), 0], [-inv(B) C inv(A), inv(B)]],

    after padding to a power-of-two multiple of ``base`` with an identity
    diagonal (exact: inv(blockdiag(L, I)) = blockdiag(inv(L), I))."""
    n = L.shape[-1]
    batch = L.shape[:-2]
    eye_n = torch.eye(n, dtype=L.dtype, device=L.device)
    if n <= base:
        return torch.linalg.solve_triangular(
            L, eye_n.expand_as(L), upper=False, unitriangular=unit_diag)
    n2 = base
    while n2 < n:
        n2 *= 2
    if n2 > n:
        Lp = torch.zeros(*batch, n2, n2, dtype=L.dtype, device=L.device)
        Lp[..., :n, :n] = L
        Lp[..., torch.arange(n, n2), torch.arange(n, n2)] = 1
    else:
        Lp = L
    d = _diag_tiles(Lp, n2 // base, base)
    eye = torch.eye(base, dtype=L.dtype, device=L.device)
    X = torch.linalg.solve_triangular(d, eye.expand_as(d), upper=False,
                                      unitriangular=unit_diag)
    s = base
    while s < n2:
        A, B = X[..., 0::2, :, :], X[..., 1::2, :, :]
        C = _diag_tiles(Lp, n2 // (2 * s), 2 * s)[..., s:, :s]
        off = -(B @ C @ A)
        top = torch.cat([A, torch.zeros_like(A)], dim=-1)
        bot = torch.cat([off, B], dim=-1)
        X = torch.cat([top, bot], dim=-2)
        s *= 2
    return X[..., 0, :n, :n]


def tri_inv_upper(U: torch.Tensor, unit_diag: bool = False,
                  base: int = 32) -> torch.Tensor:
    """inv(U) for upper-triangular U: inv(U) = inv(U^T)^T."""
    return tri_inv_lower(U.mT, unit_diag=unit_diag, base=base).mT


def _pad_tri(ad: torch.Tensor, nb: int):
    """Identity-augment a triangular [n, n] up to the next multiple of nb.
    blockdiag(A, I) is triangular in either triangle and its identity pad
    is invariant under transpose/conjugate, so padding before the op is
    exact.  Returns (padded, n)."""
    n = ad.shape[0]
    n2 = -(-n // nb) * nb
    if n2 == n:
        return ad, n
    out = torch.zeros((n2, n2), dtype=ad.dtype, device=ad.device)
    out[:n, :n] = ad
    r = torch.arange(n, n2, device=ad.device)
    out[r, r] = 1
    return out, n


def _op_blocks(ad, nb, *, trans, conj, lower, unit):
    """(op(A), inverted diagonal blocks of op(A), eff_lower)."""
    K = ad.shape[0] // nb
    a_op = ad.conj() if conj else ad
    d = _diag_tiles(a_op, K, nb)           # tiles first: no dense transpose
    if trans:
        a_op, d = a_op.T, d.mT
    eff_lower = lower != trans
    inv = tri_inv_lower if eff_lower else tri_inv_upper
    return a_op, inv(d, unit_diag=unit), eff_lower


def trsm_left_blocked(ad, bd, *, lower: bool, trans: bool, conj: bool,
                      unit: bool, nb: int, check: bool = False):
    """Solve op(A) X = B, A triangular [n, n], by block substitution with
    every diagonal block inverted in one batched log-depth pass: each step
    is then two matmuls.  A ragged n is identity-augmented (_pad_tri)."""
    if check:
        raise not_ported("checksum-verified trsm (Option.Abft)",
                         "queue 1, item 6 (robustness)")
    ad, n0 = _pad_tri(ad, nb)
    n = ad.shape[0]
    if n > n0:
        bd = torch.cat([bd, bd.new_zeros((n - n0, bd.shape[1]))])
    a_op, dinv, eff_lower = _op_blocks(ad, nb, trans=trans, conj=conj,
                                       lower=lower, unit=unit)
    K = n // nb
    x = torch.empty_like(bd)
    for k in (range(K) if eff_lower else range(K - 1, -1, -1)):
        k0, k1 = k * nb, (k + 1) * nb
        acc = bd[k0:k1]
        if eff_lower and k > 0:
            acc = acc - a_op[k0:k1, :k0] @ x[:k0]
        elif not eff_lower and k < K - 1:
            acc = acc - a_op[k0:k1, k1:] @ x[k1:]
        x[k0:k1] = dinv[k] @ acc
    return x[:n0]


def trsm_right_blocked(ad, bd, *, lower: bool, trans: bool, conj: bool,
                       unit: bool, nb: int, check: bool = False):
    """Solve X op(A) = B by block substitution over block columns (right
    side twin of trsm_left_blocked; ragged n identity-augmented)."""
    if check:
        raise not_ported("checksum-verified trsm (Option.Abft)",
                         "queue 1, item 6 (robustness)")
    ad, n0 = _pad_tri(ad, nb)
    n = ad.shape[0]
    if n > n0:
        bd = torch.cat([bd, bd.new_zeros((bd.shape[0], n - n0))], dim=1)
    a_op, dinv, eff_lower = _op_blocks(ad, nb, trans=trans, conj=conj,
                                       lower=lower, unit=unit)
    K = n // nb
    x = torch.empty_like(bd)
    # X_k depends on later X_j for lower (B_k - sum_{j>k} X_j A[j,k]),
    # earlier for upper
    for k in (range(K - 1, -1, -1) if eff_lower else range(K)):
        k0, k1 = k * nb, (k + 1) * nb
        acc = bd[:, k0:k1]
        if eff_lower and k < K - 1:
            acc = acc - x[:, k1:] @ a_op[k1:, k0:k1]
        elif not eff_lower and k > 0:
            acc = acc - x[:, :k0] @ a_op[:k0, k0:k1]
        x[:, k0:k1] = acc @ dinv[k]
    return x[:, :n0]
