"""internal QR: the Householder panel, the block reflector T and the larfb
apply (port of slate_tpu/internal/qr.py).

Conventions (LAPACK's): A = Q R with Q = H_0 H_1 ... H_{r-1},
H_j = I - tau_j v_j v_j^H, v_j[j] = 1, v_j[:j] = 0, and Q = I - V T V^H
with T the larft Forward/Columnwise triangle.

``geqrf_panel`` is the tuned panel seam.  Under the default plan an f32
panel of at most 2^20 elements, within the limits K5 reports (on the
card, up to 128 columns, or 256, 384 or 512), goes to K5
(internal/qr_kernels.py); past that cap
a Householder panel would read a tall panel from device memory once a
column, so such panels (and f64, complex, or the library plan) take
``householder_panel_blocked``: CholQR2 with Householder reconstruction
for tall panels, all matmuls and one small no-pivot LU, else the
recursive rank-1 scan.  The reference's
``precision=HIGH`` Gram products are plain f32 here (never TF32).
``rolled_apply`` is the back-transform engine of the spectral drivers'
two-stage reductions (drivers/heev.py, drivers/svd.py).
"""

from __future__ import annotations

import torch

from ..tune.plans import resolve_plan
from .getrf import _lu_nopiv_square
from .qr_kernels import panel_fits, qr_panel
from .trsm import tri_inv_lower, tri_inv_upper

# The largest panel (mm * w elements) K5 takes: 4 MB in f32, the
# reference's VMEM cap kept as this card's L2 policy (PERF.md, PR 4).
QR_PANEL_MAX_ELEMS = 2 ** 20


def _larfg(alpha, x):
    """The larfg scalars of the panel loop and householder_vec: given the
    pivot ``alpha`` and the tail ``x`` (entries outside the tail already
    zero), (tau, beta, scale, live).  beta = -mu if Re(alpha) >= 0 else
    +mu; ``live`` False (identity reflector, tau = 0) when mu == 0."""
    sigma2 = (x * x.conj()).real.sum()
    mu = torch.sqrt((alpha * alpha.conj()).real + sigma2)
    beta = torch.where(alpha.real >= 0, -mu, mu)
    live = mu > 0
    safe_beta = torch.where(live, beta, torch.ones_like(beta))
    zero = torch.zeros_like(alpha)
    tau = torch.where(live, (safe_beta - alpha) / safe_beta, zero)
    one = torch.ones_like(alpha)
    scale = torch.where(live, 1 / torch.where(live, alpha - safe_beta, one),
                        zero)
    return tau, beta, scale, live


def phase_of(z: torch.Tensor) -> torch.Tensor:
    """z / |z| elementwise, with phase 1 where z == 0."""
    az = z.abs()
    return torch.where(az > 0, z / torch.where(az > 0, az,
                                                torch.ones_like(az)),
                       torch.ones_like(z))


def householder_panel(a: torch.Tensor):
    """Householder QR of a panel [mm, w] (mm >= 1, any w), one rank-1 step
    a column.  Returns (packed, taus): R in and above the diagonal, the
    Householder vectors below it (unit diagonal implied); taus [w]."""
    mm, w = a.shape
    a = a.clone()
    taus = torch.zeros(w, dtype=a.dtype, device=a.device)
    for j in range(min(mm, w)):
        colj = a[:, j].clone()
        alpha = colj[j]
        x = colj[j + 1:]
        tau, beta, scale, live = _larfg(alpha, x)
        v = torch.cat([torch.ones_like(colj[j:j + 1]), x * scale])
        # trailing update: a[j:, j+1:] -= conj(tau) v (v^H a[j:, j+1:])
        wrow = v.conj() @ a[j:, j + 1:]
        a[j:, j + 1:] -= tau.conj() * v[:, None] * wrow[None, :]
        newc = torch.cat([beta.to(a.dtype)[None], x * scale])
        a[j:, j] = torch.where(live, newc, colj[j:])  # mu == 0: leave it
        taus[j] = tau
    return a, taus


def panel_qr_cholqr(a: torch.Tensor):
    """CholQR2 with Householder reconstruction of a tall panel [mm, w]:
    G = P^H P, R1 = chol(G)^H, Q = P R1^-1, twice; then, with s_j =
    -phase(Q_jj), the unpivoted LU of E - Q S (E = [I_w; 0]) gives V
    exactly and T = W V1^-H.  Returns (packed, T, ok); ok is False when
    a Gram Cholesky broke down or an output is not finite."""
    mm, w = a.shape
    eye = torch.eye(w, dtype=a.dtype, device=a.device)
    iw = torch.arange(w, device=a.device)
    G = a.conj().T @ a
    L1, info1 = torch.linalg.cholesky_ex(G)
    Q = a @ tri_inv_lower(L1).conj().T
    G2 = Q.conj().T @ Q
    L2, info2 = torch.linalg.cholesky_ex(G2)
    Q = Q @ tri_inv_lower(L2).conj().T
    R = L2.conj().T @ L1.conj().T
    s = -phase_of(torch.diagonal(Q[:w]))
    M = -Q * s[None, :]
    M[iw, iw] += 1                                   # E - Q S
    lu_top = _lu_nopiv_square(M[:w])
    V1 = torch.tril(lu_top, -1) + eye
    W = torch.triu(lu_top)
    V2 = M[w:] @ tri_inv_upper(W)
    T = W @ tri_inv_lower(V1, unit_diag=True).conj().T
    # A = (I - V T V^H) E (S^-1 R); S is unitary diagonal, S^-1 = conj(S)
    Rs = torch.triu(R * s.conj()[:, None])
    packed = torch.cat([Rs + torch.tril(V1, -1), V2])
    # the library's Cholesky stops at a non-positive pivot and leaves
    # finite values behind (the reference's gives NaN): check both
    ok = bool((info1 == 0) & (info2 == 0) & torch.isfinite(packed).all()
              & torch.isfinite(T).all())
    return packed, T, ok


def householder_panel_blocked(a: torch.Tensor, base_w: int = 32,
                              rows: int | None = None):
    """Blocked Householder QR of a panel [mm, w]: tall panels (mm >= 2 w,
    w >= 8) take :func:`panel_qr_cholqr` and fall back to the recursive
    scan only when its Gram Cholesky breaks down; the recursion splits
    the columns, factors the left half, applies it to the right, factors
    the right and merges T = [[T1, -T1 (V1^H V2) T2], [0, T2]].  Returns
    (packed, T).

    ``rows`` (>= mm) is the panel's height in the reference's zero-padded
    frame, where the two-stage reductions factor the live rows of a
    taller panel whose rows below are zero: the route is chosen on it, as
    the reference chooses (zero rows change neither route's arithmetic,
    but the two routes differ in the sign convention of a square panel's
    last reflector)."""
    mm, w = a.shape
    if (mm if rows is None else rows) >= 2 * w and w >= 8 and mm >= w:
        pc, Tc, ok = panel_qr_cholqr(a)
        if ok:
            return pc, Tc
    return _householder_blocked_rec(a, base_w)


def _qr_panel_ok(a: torch.Tensor) -> bool:
    """True when the plan routes this panel through K5: real f32, at most
    QR_PANEL_MAX_ELEMS elements, the "cuda" plan, and on the card the
    kernel's own limits, asked of the kernel (``slate_qr_panel_fits``:
    w <= 128 or w in {256, 384, 512}, the slab width, T and scratch within
    one block's shared memory).  The plain version that CPU tensors take
    has no such limits."""
    mm, w = a.shape
    if not (a.dtype == torch.float32 and 1 <= w <= mm
            and mm * w <= QR_PANEL_MAX_ELEMS):
        return False
    plan = resolve_plan("geqrf_panel", mm, "float32")
    if plan.kernel != "cuda":
        return False
    return a.device.type == "cpu" or panel_fits(a.device, mm, w, plan.bw)


def geqrf_panel(a: torch.Tensor, base_w: int = 32):
    """The tuned panel seam of geqrf/gels: K5 (``qr_panel``) when
    :func:`_qr_panel_ok`, else :func:`householder_panel_blocked`.
    Returns (packed, T)."""
    if _qr_panel_ok(a):
        return qr_panel(a, bw=resolve_plan("geqrf_panel", a.shape[0]).bw)
    return householder_panel_blocked(a, base_w)


def _householder_blocked_rec(a: torch.Tensor, base_w: int = 32):
    """The scan-based recursive panel (see householder_panel_blocked)."""
    mm, w = a.shape
    if w <= base_w or mm < w:
        packed, taus = householder_panel(a)
        return packed, build_t(packed, taus)
    h = w // 2
    p1, T1 = _householder_blocked_rec(a[:, :h], base_w)
    right = apply_q_left(p1, T1, a[:, h:], conj_trans=True)
    p2, T2 = _householder_blocked_rec(right[h:], base_w)
    packed = torch.cat([p1, torch.cat([right[:h], p2])], dim=1)
    # V2's top h rows are zero: the Gram product runs over V1's rows below
    T12 = -T1 @ (unit_lower(p1)[h:].conj().T @ unit_lower(p2)) @ T2
    T = torch.zeros((w, w), dtype=a.dtype, device=a.device)
    T[:h, :h] = T1
    T[h:, h:] = T2
    T[:h, h:] = T12
    return packed, T


def unit_lower(packed: torch.Tensor, r: int | None = None) -> torch.Tensor:
    """V (unit lower trapezoid) of a packed panel [mm, w]."""
    mm, w = packed.shape
    r = min(mm, w) if r is None else r
    v = torch.tril(packed, -1)
    k = torch.arange(min(r, mm, w), device=packed.device)
    v[k, k] = 1
    return v


def build_t(packed: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Block-reflector triangle T [w, w] (larft Forward/Columnwise):
    Q = I - V T V^H, T[j, j] = tau_j, T[:j, j] = -tau_j T V^H v_j."""
    mm, w = packed.shape
    V = unit_lower(packed)
    G = V.conj().T @ V
    T = torch.zeros((w, w), dtype=G.dtype, device=G.device)
    for j in range(min(mm, w)):
        T[:j, j] = -taus[j] * (T[:j, :j] @ G[:j, j])
        T[j, j] = taus[j]
    return T


def householder_vec(x: torch.Tensor):
    """One Householder reflector mapping x to beta e_0: (v, tau, beta) with
    H = I - tau v v^H, v[0] = 1, beta real; zero (or already reduced) x
    gives tau = 0."""
    alpha = x[0]
    tail = x[1:]
    tau, beta, scale, live = _larfg(alpha, tail)
    v = torch.cat([torch.ones_like(x[:1]), tail * scale])
    return v, tau, torch.where(live, beta, alpha.real)


# ---- larfb: apply the block reflector.  Q = I - V T V^H, Q^H = I - V T^H V^H

def apply_q_left(packed, T, C, conj_trans: bool) -> torch.Tensor:
    """Q C (conj_trans=False) or Q^H C (True); the rows of C match packed."""
    V = unit_lower(packed)
    W = V.conj().T @ C
    Tm = T.conj().T if conj_trans else T
    return C - V @ (Tm @ W)


def apply_q_right(packed, T, C, conj_trans: bool) -> torch.Tensor:
    """C Q (conj_trans=False) or C Q^H (True); the columns of C match
    packed."""
    V = unit_lower(packed)
    W = C @ V
    Tm = T.conj().T if conj_trans else T
    return C - (W @ Tm) @ V.conj().T


def rolled_apply(Vstack, Tstack, offsets, Z) -> torch.Tensor:
    """Z <- (prod_k Q_k) Z over stacked panels, the last panel first: the
    back-transform of the two-stage reductions (heev's he2hb, svd's ge2tb;
    ref: src/unmtr_he2hb.cc, unmbr_ge2tb).  Panel k is stored from its
    local row 0 and acts on the rows ``offsets[k]`` (a host int) and below
    of Z; its rows past Z's height are zero.  The reference zero-pads each
    panel to Z's height and rolls it into place; here panel k multiplies
    the row slice ``Z[offsets[k]:]`` directly, the same product without a
    full-height copy a panel."""
    Z = Z.clone()
    rows = Z.shape[0]
    for k in reversed(range(Tstack.shape[0])):
        off = int(offsets[k])
        h = min(rows - off, Vstack.shape[1])
        if h <= 0:
            continue
        V = unit_lower(Vstack[k, :h])
        Zk = Z[off:off + h]
        Zk -= V @ (Tstack[k] @ (V.conj().T @ Zk))
    return Z
