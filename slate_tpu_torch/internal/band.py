"""Packed-band kernels: storage conversion and blocked band factor/solve
(port of slate_tpu/internal/band.py; ref: src/gbtrf.cc, src/pbtrf.cc,
src/tbsm.cc, src/gbmm.cc, src/hbmm.cc).

The band lives in LAPACK-style packed storage, a dense
``[bandwidth + 1, n]`` tensor, and every routine walks the block columns
with dense windows gathered from and scattered back to it: the
reference's ``lax.scan`` over block columns is a Python loop over the
same windows here.  The reference computes all of it outside any Pallas
kernel (XLA's Cholesky, LU, triangular solve and matmul), so here they
are torch's (cuSOLVER and cuBLAS on the card).

Packed layouts (LAPACK conventions):
- Hermitian/lower-triangular band, bandwidth kd: ``Lp[i, j] = A[j+i, j]``
  for ``0 <= i <= kd`` (shape ``[kd+1, n]``).
- General band kl/ku: ``P[ku+i-j, j] = A[i, j]`` (shape ``[kl+ku+1, n]``).
- gbtrf working array: ``[2kl+ku+1, n]``: kl extra TOP rows hold the U
  fill-in from partial pivoting (LAPACK's dgbtrf ldab layout).
"""

from __future__ import annotations

import torch

from .getrf import panel_lu


def _idx(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


# ------------------------------------------------------------- conversions

def dense_to_banded(a: torch.Tensor, kl: int, ku: int) -> torch.Tensor:
    """Dense [m, n] -> general packed band [kl+ku+1, n]."""
    m, n = a.shape
    r = _idx(kl + ku + 1, a.device)[:, None]
    j = _idx(n, a.device)[None, :]
    i = j + (r - ku)
    valid = (i >= 0) & (i < m)
    return torch.where(valid, a[i.clamp(0, m - 1), j.expand_as(i)],
                       torch.zeros((), dtype=a.dtype, device=a.device))


def banded_to_dense(p: torch.Tensor, kl: int, ku: int, m: int,
                    n: int) -> torch.Tensor:
    """General packed band [kl+ku+1, n] -> dense [m, n]."""
    i = _idx(m, p.device)[:, None]
    j = _idx(n, p.device)[None, :]
    r = ku + i - j
    valid = (r >= 0) & (r <= kl + ku)
    return torch.where(valid, p[r.clamp(0, kl + ku), j.expand_as(r)],
                       torch.zeros((), dtype=p.dtype, device=p.device))


def band_transpose(p: torch.Tensor, kl: int, ku: int, n: int,
                   conj: bool = False) -> torch.Tensor:
    """Packed band of op(A) from the packed band of A (m == n):
    T[rt, c] = P[kl+ku-rt, c+rt-kl]; the result has (kl', ku') = (ku, kl)."""
    nr = kl + ku + 1
    rt = _idx(nr, p.device)[:, None]
    c = _idx(n, p.device)[None, :]
    src_r = (kl + ku - rt).expand(nr, n)
    src_c = c + rt - kl
    valid = (src_c >= 0) & (src_c < n)
    out = torch.where(valid, p[src_r, src_c.clamp(0, n - 1)],
                      torch.zeros((), dtype=p.dtype, device=p.device))
    return out.conj_physical() if conj else out


def hermitian_band_expand(lp: torch.Tensor, kd: int, n: int) -> torch.Tensor:
    """Lower Hermitian packed [kd+1, n] -> general packed [2kd+1, n]
    (ku = kl = kd), mirroring the strictly lower part conjugated."""
    up = band_transpose(lp, kd, 0, n, conj=True)   # [kd+1, n], (0, kd)
    g = torch.zeros((2 * kd + 1, n), dtype=lp.dtype, device=lp.device)
    g[kd:] = lp                                    # rows kd..2kd: lower
    g[:kd + 1] += up                               # rows 0..kd: upper
    g[kd] -= lp[0]                                 # diagonal counted twice
    return g


# ---------------------------------------------------- window gather/scatter

class _Window:
    """The index maps of one window shape: ``gather`` reads the dense
    window W[r, c] = strip[ku + r - c, c] from a packed strip
    [kl+ku+1, Wc] (out-of-band = 0), ``scatter`` writes a dense window's
    in-band values back into the strip."""

    def __init__(self, kl: int, ku: int, Wr: int, Wc: int, device):
        r = _idx(Wr, device)[:, None]
        c = _idx(Wc, device)[None, :]
        rr = ku + r - c
        self.g_valid = (rr >= 0) & (rr <= kl + ku)
        self.g_rows = rr.clamp(0, kl + ku)
        self.g_cols = c.expand(Wr, Wc)
        nr = kl + ku + 1
        sr = _idx(nr, device)[:, None]
        sw = c + (sr - ku)
        self.s_valid = (sw >= 0) & (sw < Wr)
        self.s_rows = sw.clamp(0, Wr - 1)
        self.s_cols = c.expand(nr, Wc)

    def gather(self, strip: torch.Tensor) -> torch.Tensor:
        return torch.where(self.g_valid, strip[self.g_rows, self.g_cols],
                           torch.zeros((), dtype=strip.dtype,
                                       device=strip.device))

    def scatter(self, strip: torch.Tensor, w_new: torch.Tensor
                ) -> torch.Tensor:
        return torch.where(self.s_valid, w_new[self.s_rows, self.s_cols],
                           strip)


def _padded(p: torch.Tensor, rows: int, n: int, n_pad: int,
            diag_row: int) -> torch.Tensor:
    """``p``'s first n columns in a [rows, n_pad] array whose pad columns
    hold a unit diagonal at ``diag_row`` (the pad block factors to the
    identity)."""
    out = torch.zeros((rows, n_pad), dtype=p.dtype, device=p.device)
    out[:p.shape[0], :n] = p[:, :n]
    out[diag_row, n:] = 1
    return out


def _tri_solve(a, b, *, lower: bool, left: bool = True, unit: bool = False):
    return torch.linalg.solve_triangular(a, b, upper=not lower, left=left,
                                         unitriangular=unit)


# ------------------------------------------------------------- pbtrf / pbtrs

def pbtrf_banded(lp: torch.Tensor, kd: int, n: int, w: int) -> torch.Tensor:
    """Blocked band Cholesky of a Hermitian positive-definite band matrix
    in lower packed storage [kd+1, n] -> packed L (ref: src/pbtrf.cc).
    Each of the ceil(n/w) steps factors a (w+kd) x (w+kd) window:
    potrf(W11), L21 = W21 L11^-H, W22 -= L21 L21^H.  A block that is not
    positive definite NaN-fills its factor, as the reference's XLA
    Cholesky does, so the failure reads on the packed diagonal."""
    nblk = -(-n // w)
    sz = w + kd
    lpp = _padded(lp, kd + 1, n, nblk * w + kd, 0)
    win = _Window(kd, 0, sz, sz, lp.device)
    for k in range(nblk):
        k0 = k * w
        strip = lpp[:, k0:k0 + sz]
        W = win.gather(strip)
        w11 = W[:w, :w]
        w11 = w11 + torch.tril(w11, -1).conj().T
        l11, info = torch.linalg.cholesky_ex(w11)
        l11 = torch.where(info == 0, l11, torch.full_like(l11, torch.nan))
        l21 = _tri_solve(l11.mH, W[w:, :w], lower=False, left=False)
        w22 = W[w:, w:] - l21 @ l21.mH
        Wn = torch.zeros_like(W)
        Wn[:w, :w] = torch.tril(l11)
        Wn[w:, :w] = l21
        Wn[w:, w:] = torch.tril(w22)
        lpp[:, k0:k0 + sz] = win.scatter(strip, Wn)
    return lpp[:, :n]


def banded_trsm_lower(lp: torch.Tensor, kd: int, n: int, w: int,
                      b: torch.Tensor, *, conj_trans: bool = False,
                      unit_diag: bool = False) -> torch.Tensor:
    """Solve L X = b (or L^H X = b when ``conj_trans``) with L lower band
    in packed storage; b [n, nrhs].  Blocked forward (or backward)
    substitution over (w+kd)-row windows."""
    nblk = -(-n // w)
    n_pad = nblk * w + kd
    sz = w + kd
    lpp = _padded(lp, kd + 1, n, n_pad, 0)
    bp = torch.zeros((n_pad, b.shape[1]), dtype=b.dtype, device=b.device)
    bp[:n] = b
    win = _Window(kd, 0, sz, sz, lp.device)
    steps = range(nblk - 1, -1, -1) if conj_trans else range(nblk)
    for k in steps:
        k0 = k * w
        W = win.gather(lpp[:, k0:k0 + sz])
        l11, l21 = W[:w, :w], W[w:, :w]
        bw = bp[k0:k0 + sz]
        if not conj_trans:
            y = _tri_solve(l11, bw[:w], lower=True, unit=unit_diag)
            rest = bw[w:] - l21 @ y
            bp[k0:k0 + w] = y
            bp[k0 + w:k0 + sz] = rest
        else:
            rhs = bw[:w] - l21.conj().T @ bw[w:]
            bp[k0:k0 + w] = _tri_solve(l11.mH, rhs, lower=False,
                                       unit=unit_diag)
    return bp[:n]


def pbtrs_banded(lp: torch.Tensor, kd: int, n: int, w: int,
                 b: torch.Tensor) -> torch.Tensor:
    """Solve A X = b from pbtrf's packed L: L (L^H X) = b."""
    y = banded_trsm_lower(lp, kd, n, w, b)
    return banded_trsm_lower(lp, kd, n, w, y, conj_trans=True)


# ------------------------------------------------------------- gbtrf / gbtrs

def gbtrf_banded(gp: torch.Tensor, kl: int, ku: int, n: int, w: int):
    """Blocked band LU with partial pivoting (ref: src/gbtrf.cc).

    ``gp`` is the [2kl+ku+1, n] input array (the band in rows
    kl..2kl+ku, the top kl rows zero fill space).  Returns ``(factored,
    perms)``: the factored array carries kl+w-1 multiplier rows below the
    diagonal (in-panel pivoting can displace rows downward within the
    (w+kl)-row window), and ``perms`` [nblk, w+kl] holds each block's
    window-local row permutation (panel[perm] = L U), replayed by
    gbtrs."""
    kuw = kl + ku                                  # working upper bandwidth
    klx = kl + w - 1                               # extended L bandwidth
    nblk = -(-n // w)
    Wr, Wc = w + kl, w + kuw
    gpp = _padded(gp, klx + kuw + 1, n, nblk * w + kuw, kuw)
    win = _Window(klx, kuw, Wr, Wc, gp.device)
    perms = []
    for k in range(nblk):
        k0 = k * w
        strip = gpp[:, k0:k0 + Wc]
        W = win.gather(strip)
        lu, perm = panel_lu(W[:, :w])
        Wp = W[perm]
        u12 = _tri_solve(lu[:w, :w], Wp[:w, w:], lower=True, unit=True)
        w22 = Wp[w:, w:] - lu[w:, :w] @ u12
        Wn = torch.cat([lu, torch.cat([u12, w22], dim=0)], dim=1)
        gpp[:, k0:k0 + Wc] = win.scatter(strip, Wn)
        perms.append(perm)
    return gpp[:, :n], torch.stack(perms)


def gbtrs_banded(gp: torch.Tensor, perms: torch.Tensor, kl: int, ku: int,
                 n: int, w: int, b: torch.Tensor) -> torch.Tensor:
    """Solve A X = b from gbtrf's factors (``gp`` [kl+w-1 + kl+ku + 1, n]):
    each block's permutation and the banded unit-L forward solve, then the
    banded U (bandwidth kl+ku) backward solve."""
    kuw = kl + ku
    klx = kl + w - 1
    nblk = -(-n // w)
    n_pad = nblk * w + kuw
    Wr, Wc = w + kl, w + kuw
    gpp = _padded(gp, klx + kuw + 1, n, n_pad, kuw)
    bp = torch.zeros((n_pad, b.shape[1]), dtype=b.dtype, device=b.device)
    bp[:n] = b
    win = _Window(klx, kuw, Wr, Wc, gp.device)
    for k in range(nblk):
        k0 = k * w
        W = win.gather(gpp[:, k0:k0 + Wc])
        bw = bp[k0:k0 + Wr][perms[k]]
        y = _tri_solve(W[:w, :w], bw[:w], lower=True, unit=True)
        bp[k0:k0 + w] = y
        bp[k0 + w:k0 + Wr] = bw[w:] - W[w:, :w] @ y
    for k in range(nblk - 1, -1, -1):
        k0 = k * w
        U = win.gather(gpp[:, k0:k0 + Wc])[:w]
        xw = bp[k0:k0 + Wc]
        rhs = xw[:w] - U[:, w:] @ xw[w:]
        bp[k0:k0 + w] = _tri_solve(U[:, :w], rhs, lower=False)
    return bp[:n]


def banded_trsm_upper(up: torch.Tensor, ku: int, n: int, w: int,
                      b: torch.Tensor, *, unit_diag: bool = False
                      ) -> torch.Tensor:
    """Solve U X = b with U upper band (packed [ku+1, n], kl = 0)."""
    nblk = -(-n // w)
    n_pad = nblk * w + ku
    Wc = w + ku
    upp = _padded(up, ku + 1, n, n_pad, ku)
    bp = torch.zeros((n_pad, b.shape[1]), dtype=b.dtype, device=b.device)
    bp[:n] = b
    win = _Window(0, ku, Wc, Wc, up.device)
    for k in range(nblk - 1, -1, -1):
        k0 = k * w
        U = win.gather(upp[:, k0:k0 + Wc])[:w]
        xw = bp[k0:k0 + Wc]
        rhs = xw[:w] - U[:, w:] @ xw[w:]
        bp[k0:k0 + w] = _tri_solve(U[:, :w], rhs, lower=False,
                                   unit=unit_diag)
    return bp[:n]


# ------------------------------------------------------------- gbmm

def gbmm_banded(gp: torch.Tensor, kl: int, ku: int, m: int, n: int,
                b: torch.Tensor, alpha, beta, c):
    """C = alpha A B + beta C with A an m x n band in general packed
    storage, B [n, nrhs], C [m, nrhs] (ref: src/gbmm.cc): one fused
    multiply-add over the full right-hand side block per stored
    diagonal."""
    nrhs = b.shape[1]
    dt = torch.promote_types(gp.dtype, b.dtype)
    # the accumulator holds every diagonal's n-row window ([o, o+n) for o
    # up to kl+ku) and the m output rows at [ku, ku+m)
    cp = torch.zeros((max(m, n) + kl + ku, nrhs), dtype=dt, device=b.device)
    j = _idx(n, b.device)
    zero = torch.zeros((), dtype=gp.dtype, device=gp.device)
    for o in range(kl + ku + 1):
        # diagonal o holds A[i, j] with i = j + o - ku
        i = j + o - ku
        d = torch.where((i >= 0) & (i < m), gp[o], zero)
        cp[o:o + n] += d[:, None] * b
    out = cp[ku:ku + m]
    return alpha * out + (beta * c if c is not None else 0)
