"""Symmetric-indefinite solvers: hetrf / hetrs / hesv, blocked Aasen (port
of slate_tpu/drivers/hetrf.py; ref: src/hetrf.cc, src/hetrs.cc,
src/hesv.cc).

P A P^H = L T L^H with L unit lower triangular, its first block column
[I; 0], and T a Hermitian band of bandwidth nb factored once by band LU
(internal/band.py gbtrf).  Each of the ~n/nb block columns does one tall
product W = A[j0:, j] - L[j0:, :j0] H[:j0, j]; pivoting stays inside the
panel LU (internal/getrf.panel_lu), applied as one symmetric row and
column permutation of the trailing part.  The reference computes all of
it outside any Pallas kernel, so on the card these are library calls.
On a mesh (the target mesh and a grid with a process group) the
factorization keeps A and L in row blocks over the grid's ranks
(:func:`_hetrf_mesh`); the factors come back replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.matrix import HermitianMatrix, Matrix, SymmetricMatrix
from ..core.storage import TileStorage
from ..exceptions import SlateSingularError, slate_error
from ..internal.band import _tri_solve, gbtrf_banded, gbtrs_banded
from ..internal.getrf import panel_lu
from ..options import Options, on_mesh
from ..robust import certify as _certify
from ..robust import faults as _faults
from ..robust import health as _health
from ..types import is_complex
from ..util.trace import annotate


class HEFactors(NamedTuple):
    """Blocked Aasen factors: P A P^H = L T L^H.

    ``L``     [n, n] dense unit lower (block column 0 = [I; 0])
    ``Tdiag`` [Nt, nb, nb] Hermitian diagonal blocks of T (padded space)
    ``Tsub``  [Nt-1, nb, nb] subdiagonal blocks T[j+1, j] (upper
              triangular: the panel LU's U factors); T[j, j+1] = Tsub^H
    ``piv``   [n] symmetric permutation: A[piv][:, piv] = L T L^H
    ``nb``    panel width = T's bandwidth
    ``Tlu``/``Tperms``  T's band-LU factors, computed once in hetrf
    """
    L: torch.Tensor
    Tdiag: torch.Tensor
    Tsub: torch.Tensor
    piv: torch.Tensor
    nb: int
    Tlu: torch.Tensor
    Tperms: torch.Tensor

    @property
    def n(self) -> int:
        return self.L.shape[0]

    def T_dense(self) -> torch.Tensor:
        """The band matrix T as a dense [n, n] tensor."""
        nb = self.nb
        Nt = self.Tdiag.shape[0]
        t = torch.zeros((Nt * nb, Nt * nb), dtype=self.Tdiag.dtype,
                        device=self.Tdiag.device)
        for j in range(Nt):
            j0 = j * nb
            t[j0:j0 + nb, j0:j0 + nb] = self.Tdiag[j]
            if j + 1 < Nt:
                t[j0 + nb:j0 + 2 * nb, j0:j0 + nb] = self.Tsub[j]
                t[j0:j0 + nb, j0 + nb:j0 + 2 * nb] = self.Tsub[j].mH
        return t[:self.n, :self.n]


def _aasen_blocked(a: torch.Tensor, nb: int):
    """Blocked Aasen on a dense Hermitian matrix (both triangles
    populated).  Returns (L, Tdiag, Tsub, piv) over the nb-padded space
    (the pad block is the identity; pivots never select its rows)."""
    n0 = a.shape[0]
    dt, dev = a.dtype, a.device
    Nt = max(1, -(-n0 // nb))
    n = Nt * nb
    ap = torch.zeros((n, n), dtype=dt, device=dev)
    ap[:n0, :n0] = a
    pad = torch.arange(n0, n, device=dev)
    ap[pad, pad] = 1
    L = torch.zeros((n, n), dtype=dt, device=dev)
    L[:nb, :nb] = torch.eye(nb, dtype=dt, device=dev)
    Tdiag = torch.zeros((Nt, nb, nb), dtype=dt, device=dev)
    Tsub = torch.zeros((max(Nt - 1, 1), nb, nb), dtype=dt, device=dev)
    piv = torch.arange(n, device=dev)

    for j in range(Nt):
        j0, j1 = j * nb, (j + 1) * nb
        Ljj = L[j0:j1, j0:j1]
        if j > 0:
            # H[k, j] = T[k,k-1] L[j,k-1]^H + T[k,k] L[j,k]^H
            #           + T[k,k+1] L[j,k+1]^H   for k < j
            LbH = L[j0:j1, :j1].reshape(nb, j + 1, nb).permute(1, 2, 0)
            LbH = LbH.conj()                         # [j+1, nb, nb]
            H = torch.bmm(Tdiag[:j], LbH[:j])
            if j > 1:
                H[1:] += torch.bmm(Tsub[:j - 1], LbH[:j - 1])
            H = H + torch.bmm(Tsub[:j].mH, LbH[1:j + 1])
            # the hot op: one tall product (ref: hetrf.cc trailing gemms)
            W = ap[j0:, j0:j1] - L[j0:, :j0] @ H.reshape(j * nb, nb)
        else:
            W = ap[:, :nb]

        Hjj = _tri_solve(Ljj, W[:nb], lower=True, unit=True)
        rhs = Hjj if j == 0 else (
            Hjj - Tsub[j - 1] @ L[j0:j1, j0 - nb:j0].mH)
        Tjj = _tri_solve(Ljj.mH, rhs, lower=False, left=False, unit=True)
        Tdiag[j] = (Tjj + Tjj.mH) / 2

        if j + 1 < Nt:
            V = W[nb:] - L[j1:, j0:j1] @ Hjj
            R = _tri_solve(Ljj.mH, V, lower=False, left=False, unit=True)
            # pivot only among the live rows: an exactly-zero R column
            # ties every row at 0, and a pad row must never be chosen
            wl = n0 - j1
            lu, perm = panel_lu(R[:wl])                  # R[perm] = Lp Up
            k = min(wl, nb)
            Tsub[j] = 0
            Tsub[j, :k] = torch.triu(lu[:nb])[:k]
            # the symmetric permutation of the trailing rows and columns
            rows = j1 + perm
            ap[j1:j1 + wl] = ap[rows]
            ap[:, j1:j1 + wl] = ap[:, rows]
            L[j1:j1 + wl] = L[rows]
            piv[j1:j1 + wl] = piv[rows]
            Lp = torch.zeros((n - j1, nb), dtype=dt, device=dev)
            Lp[:wl] = (torch.tril(lu, -1)[:wl]
                       + torch.eye(wl, nb, dtype=dt, device=dev))
            L[j1:, j1:j1 + nb] = Lp

    return L[:n0, :n0], Tdiag, Tsub, piv[:n0]


def _hetrf_health(A, F: HEFactors) -> _health.HealthInfo:
    """Health of an Aasen factorization: T's band-LU pivot record (a zero
    or non-finite U diagonal, packed row 2 kd, is a singular T) and the
    LDL^T certificate against the original matrix, which catches what the
    pivot record cannot (a bit-flipped L is finite with a healthy T)."""
    n0 = F.n
    kd = min(F.nb, max(n0 - 1, 0))
    udiag = F.Tlu[2 * kd, :n0]
    cert = _certify.certify_ldlt(A.to_dense(), F.L, F.T_dense(), F.piv)
    return _health.merge(_health.from_pivots(udiag), cert,
                         _health.from_result(F.L))


def _hetrf_exc(h):
    return SlateSingularError(
        f"hetrf: singular band T: Aasen's tridiagonal factor has a "
        f"zero/non-finite pivot ({h.describe()})", info=h.info)


@annotate("slate.hetrf")
def hetrf(A, opts: Options | None = None):
    """Blocked Aasen factorization of a Hermitian indefinite matrix (ref:
    src/hetrf.cc).  Returns HEFactors; T has bandwidth A.nb.  Under
    ``ErrorPolicy.Info`` returns ``(HEFactors, HealthInfo)``; a singular
    band T raises ``SlateSingularError(info=k)`` under Raise."""
    slate_error(isinstance(A, (HermitianMatrix, SymmetricMatrix)),
                "hetrf: need HermitianMatrix/SymmetricMatrix")
    slate_error(isinstance(A, HermitianMatrix) or not is_complex(A.dtype),
                "hetrf: complex SymmetricMatrix unsupported (use "
                "HermitianMatrix)")
    nb = A.nb
    if on_mesh(opts, A):
        F = _hetrf_mesh(A, nb)
    else:
        L, Tdiag, Tsub, piv = _aasen_blocked(A.to_dense(), nb)
        L = _faults.maybe_corrupt("post_stage1", L)
        F = _finish_factors(L, Tdiag, Tsub, piv, nb)
    return _health.finalize("hetrf", F, _hetrf_health(A, F), opts,
                            _hetrf_exc)


def _hetrf_mesh(A, nb: int) -> HEFactors:
    """The mesh Aasen (ref: hetrf.py:225-252, which runs the blocked Aasen
    under a row-sharding constraint over all devices): the same
    arithmetic with the pivoted A and the growing L in contiguous row
    blocks over the grid's ranks.  Each step forms its rows of the hot
    product W = A[j0:, j] - L[j0:, :j0] H with H replicated, gathers the
    panel (W and L's block column) with one all-reduce, factors it
    replicated, and applies the symmetric pivot as one exchange of the
    <= 2 nb displaced rows and a local swap of the columns.  Panel-sized
    objects (H, the T blocks, the panel LU) are replicated on every rank,
    and so is L once it is done, for the band factor and the solves."""
    from ..comm import collectives as cc
    grid = A.grid
    ad = A.to_dense()
    n0 = ad.shape[0]
    dt, dev = ad.dtype, ad.device
    Nt = max(1, -(-n0 // nb))
    n = Nt * nb
    rb = -(-n // grid.size)
    lo = min(grid.rank * rb, n)
    hi = min(lo + rb, n)
    h = hi - lo
    # this rank's rows [lo, hi) of the padded A and of L, and one spare
    # row that the pivot exchange writes the rows it does not own to
    apb = torch.zeros((rb + 1, n), dtype=dt, device=dev)
    Lb = torch.zeros((rb + 1, n), dtype=dt, device=dev)
    ap, L = apb[:h], Lb[:h]
    live = max(0, min(hi, n0) - lo)
    ap[:live, :n0] = ad[lo:lo + live]
    for g in range(max(lo, n0), hi):
        ap[g - lo, g] = 1
    for g in range(lo, min(hi, nb)):
        L[g - lo, g] = 1
    del ad
    Tdiag = torch.zeros((Nt, nb, nb), dtype=dt, device=dev)
    Tsub = torch.zeros((max(Nt - 1, 1), nb, nb), dtype=dt, device=dev)
    piv = torch.arange(n, device=dev)

    def gather_rows(part, g0: int, g1: int):
        """Rows [g0, g1) of a row-distributed array on every rank, from
        each rank's ``part`` (its rows from max(lo, g0) down): one
        all-reduce of the zero-padded rows."""
        buf = torch.zeros((g1 - g0, part.shape[1]), dtype=dt, device=dev)
        a0, a1 = max(lo, g0), min(hi, g1)
        if a1 > a0:
            buf[a0 - g0:a1 - g0] = part[:a1 - a0]
        return cc.reduce_grid(buf, grid)

    for j in range(Nt):
        j0, j1 = j * nb, (j + 1) * nb
        s0 = max(lo, j0) - lo
        if j > 0:
            Lrow = gather_rows(L[max(lo, j0) - lo:, :j1], j0, j1)
            Ljj = Lrow[:, j0:j1]
            LbH = Lrow.reshape(nb, j + 1, nb).permute(1, 2, 0).conj()
            H = torch.bmm(Tdiag[:j], LbH[:j])
            if j > 1:
                H[1:] += torch.bmm(Tsub[:j - 1], LbH[:j - 1])
            H = H + torch.bmm(Tsub[:j].mH, LbH[1:j + 1])
            # the hot op, row-parallel: this rank's rows of W
            W_own = ap[s0:, j0:j1] - L[s0:, :j0] @ H.reshape(j * nb, nb)
        else:
            Ljj = torch.eye(nb, dtype=dt, device=dev)
            W_own = ap[s0:, :nb]
        WL = gather_rows(torch.cat([W_own, L[s0:, j0:j1]], dim=1), j0, n)
        W, Lcol = WL[:, :nb], WL[:, nb:]

        Hjj = _tri_solve(Ljj, W[:nb], lower=True, unit=True)
        rhs = Hjj if j == 0 else (
            Hjj - Tsub[j - 1] @ Lrow[:, j0 - nb:j0].mH)
        Tjj = _tri_solve(Ljj.mH, rhs, lower=False, left=False, unit=True)
        Tdiag[j] = (Tjj + Tjj.mH) / 2

        if j + 1 < Nt:
            V = W[nb:] - Lcol[nb:] @ Hjj
            R = _tri_solve(Ljj.mH, V, lower=False, left=False, unit=True)
            wl = n0 - j1
            lu, perm = panel_lu(R[:wl])                  # R[perm] = Lp Up
            k = min(wl, nb)
            Tsub[j] = 0
            Tsub[j, :k] = torch.triu(lu[:nb])[:k]
            # the symmetric permutation: the displaced rows of A and L
            # move in one exchange, the columns of A swap locally
            iota = torch.arange(wl, device=dev)
            key = torch.where(perm != iota, wl - iota, 0)
            moved = torch.topk(key, min(2 * nb, wl)).indices
            src, dst = j1 + perm[moved], j1 + moved
            mine = (src >= lo) & (src < hi)
            at = (src - lo).clamp(0, max(h - 1, 0))
            rows = torch.cat([apb[at], Lb[at]], dim=1)
            rows = cc.reduce_grid(torch.where(mine[:, None], rows,
                                              torch.zeros_like(rows)), grid)
            slot = torch.where((dst >= lo) & (dst < hi), dst - lo, h)
            apb[slot] = rows[:, :n]
            Lb[slot] = rows[:, n:]
            ap[:, dst] = ap[:, src]
            piv[j1:j1 + wl] = piv[j1 + perm]
            Lp = torch.zeros((n - j1, nb), dtype=dt, device=dev)
            Lp[:wl] = (torch.tril(lu, -1)[:wl]
                       + torch.eye(wl, nb, dtype=dt, device=dev))
            if hi > j1:
                L[max(lo, j1) - lo:, j1:j1 + nb] = Lp[max(lo, j1) - j1:
                                                      hi - j1]

    Lfull = torch.cat(cc.allgather_grid(Lb[:rb], grid))
    return _finish_factors(Lfull[:n0, :n0], Tdiag, Tsub, piv[:n0], nb)


def _finish_factors(L, Tdiag, Tsub, piv, nb: int) -> HEFactors:
    """Band-LU T once (ref: hetrf.cc factors T with gbtrf inside the
    factorization)."""
    n0 = L.shape[0]
    kd = min(nb, max(n0 - 1, 0))
    gp = _packed_band_T(Tdiag, Tsub, nb, n0, kd)      # [2kd+1, n0]
    work = torch.zeros((3 * kd + 1, n0), dtype=gp.dtype, device=gp.device)
    work[kd:] = gp
    w = min(max(nb, 1), max(n0, 1))
    Tlu, Tperms = gbtrf_banded(work, kd, kd, n0, w)
    return HEFactors(L, Tdiag, Tsub, piv, nb, Tlu, Tperms)


def _packed_band_T(Tdiag, Tsub, nb: int, n0: int, kd: int):
    """General packed band [2kd+1, n0] of T straight from its block
    arrays: P[kd + i - c, c] = T[i, c], with the three block cases diag,
    sub and super (the conjugate of sub)."""
    dev = Tdiag.device
    Nt = Tdiag.shape[0]
    rr = torch.arange(2 * kd + 1, device=dev)[:, None]
    c = torch.arange(n0, device=dev)[None, :]
    i = c + rr - kd                                   # global row index
    bi, il = torch.div(i, nb, rounding_mode="floor"), i % nb
    bc, cl = torch.div(c, nb, rounding_mode="floor"), c % nb
    bc, cl = bc.expand_as(i), cl.expand_as(i)
    valid = (i >= 0) & (i < n0)
    diag = Tdiag[bc.clamp(0, Nt - 1), il, cl]
    ns = Tsub.shape[0]
    sub = Tsub[bc.clamp(0, ns - 1), il, cl]
    sup = Tsub[bi.clamp(0, Nt - 1).clamp(0, ns - 1), cl, il].conj()
    zero = torch.zeros((), dtype=Tdiag.dtype, device=dev)
    out = torch.where(bi == bc, diag,
                      torch.where(bi == bc + 1, sub,
                                  torch.where(bi == bc - 1, sup, zero)))
    return torch.where(valid, out, zero)


@annotate("slate.hetrs")
def hetrs(F: HEFactors, B, opts: Options | None = None):
    """Solve from Aasen factors (ref: src/hetrs.cc):
    x = P^H L^-H T^-1 L^-1 P b, with T's band-LU factors from hetrf."""
    b = B.to_dense() if isinstance(B, Matrix) else torch.as_tensor(B)
    n0 = F.n
    kd = min(F.nb, max(n0 - 1, 0))
    w = min(max(F.nb, 1), max(n0, 1))
    z = _tri_solve(F.L, b[F.piv], lower=True, unit=True)
    y = gbtrs_banded(F.Tlu, F.Tperms, kd, kd, n0, w, z.to(F.Tlu.dtype))
    wv = _tri_solve(F.L.mH, y.to(F.L.dtype), lower=False, unit=True)
    x = torch.zeros_like(wv).index_copy_(0, F.piv, wv)
    x = _faults.maybe_corrupt("solve", x)
    if isinstance(B, Matrix):
        return Matrix(TileStorage.from_dense(x, B.mb, B.nb, B.grid))
    return x


@annotate("slate.hesv")
def hesv(A, B, opts: Options | None = None):
    """Solve A X = B for Hermitian indefinite A (ref: src/hesv.cc).
    Returns (HEFactors, X); under ``ErrorPolicy.Info``,
    ``(F, X, HealthInfo)``.  A singular band T falls back to densified LU
    ``gesv`` with ``Option.UseFallbackSolver`` (see
    ``recovery.hesv_with_recovery``)."""
    from ..robust.recovery import hesv_with_recovery
    return hesv_with_recovery(A, B, opts)
