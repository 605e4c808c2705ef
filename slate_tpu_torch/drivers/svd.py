"""SVD by two-stage bidiagonalization: ge2tb -> tb2bd -> bdsqr -> back
(port of slate_tpu/drivers/svd.py; ref: src/svd.cc:65-363, ge2tb.cc,
tb2bd.cc).

- ge2tb: alternating QR (left) and LQ (right) Householder panels, the
  panels by ``householder_panel_blocked``, the updates larfb matmuls; the
  band is upper triangular with bandwidth nb.  As in heev's he2hb, each
  panel pair works on the shrinking trailing view in place where the
  reference re-anchors it into a fresh zero matrix, and the returned
  stacks keep the reference's shapes.
- stage 2 (MethodSvd): Auto takes the library's SVD of the band; Bidiag
  chases the band to a real upper bidiagonal (tb2bd, a right and a left
  reflector a step, no host read inside the chase), then the library's
  SVD of the bidiagonal (the bdsqr seam).
- vectors: U = Q_qr [Un; 0], V = V1 Vn, the stage-1 panels applied by
  ``rolled_apply``.

On a grid with a process group (``Target.mesh``, auto on more than one
rank) svd takes ``_svd_mesh``: stage 1 distributed
(parallel/dist_ge2tb.py) on the rank's tiles, only the O(n nb) band
gathered (``_band_upper_from_tiles``), stage 2 replicated on every rank,
as the reference's is, both back-transforms distributed; the certificate's
health is folded over the grid before any rank reads it.  ``Target.mesh``
on a grid without a group takes the single route, as the reference does.
"""

from __future__ import annotations

import torch

from ..core.layout import assemble_band
from ..core.matrix import Matrix
from ..core.storage import TileStorage
from ..exceptions import SlateNotConvergedError, slate_error
from ..internal.qr import (apply_q_left, apply_q_right,
                           householder_panel_blocked, householder_vec,
                           phase_of, rolled_apply)
from ..options import (ErrorPolicy, MethodSvd, Option, Options, get_option,
                       on_mesh)
from ..robust import certify as _certify
from ..robust import faults as _faults
from ..robust import health as _health
from ..types import Op, is_complex
from ..util.trace import annotate, span
from .heev import _library_call, _vec


def _notconv_exc(name):
    return lambda h: SlateNotConvergedError(
        f"{name}: singular value decomposition failed certification "
        f"({h.describe()})", iters=int(h.iters))


# ---------------------------------------------------------------- stage 1

def _ge2tb_scan(a: torch.Tensor, nb: int):
    """Dense m x n (m >= n) -> upper triangular band of bandwidth nb, one
    QR + LQ panel pair at a time on the shrinking trailing view (ref:
    src/ge2tb.cc).

    Returns (Vqs, Tqs, Vls, Tls, Ds, Ss) in the reference's shapes: QR
    panels [K, Mp, nb] (panel k's row 0 is global row k nb), LQ panels
    [K, Np-nb, nb] conjugate-transposed to column form (row 0 is global
    column (k+1) nb; the last is zero), their T triangles, the band's
    diagonal tiles Ds [K, nb, nb] (R in the triu) and superdiagonal tiles
    Ss [K, nb, nb] (L in the tril).  Mp = ceil(m/nb) nb, Np = ceil(n/nb)
    nb, K = Np / nb."""
    m, n = a.shape
    dt, dev = a.dtype, a.device
    Mp = -(-m // nb) * nb
    Np = -(-n // nb) * nb
    K = Np // nb
    A = torch.zeros((Mp, Np), dtype=dt, device=dev)
    A[:m, :n] = a
    if Np == nb:
        # a single block column: one QR panel, no LQ side
        packed_q, Tq = householder_panel_blocked(A)
        return (packed_q[None], Tq[None],
                torch.zeros((0, 1, nb), dtype=dt, device=dev),
                torch.zeros((0, nb, nb), dtype=dt, device=dev),
                packed_q[None, :nb, :nb],
                torch.zeros((1, nb, nb), dtype=dt, device=dev))
    Vqs = torch.zeros((K, Mp, nb), dtype=dt, device=dev)
    Tqs = torch.zeros((K, nb, nb), dtype=dt, device=dev)
    Vls = torch.zeros((K, Np - nb, nb), dtype=dt, device=dev)
    Tls = torch.zeros((K, nb, nb), dtype=dt, device=dev)
    Ds = torch.empty((K, nb, nb), dtype=dt, device=dev)
    Ss = torch.zeros((K, nb, nb), dtype=dt, device=dev)
    iw = torch.arange(nb, device=dev)[:, None]
    for k in range(K):
        o = k * nb
        live = A[o:, o:]
        packed_q, Tq = householder_panel_blocked(live[:, :nb], rows=Mp)
        trail = apply_q_left(packed_q, Tq, live[:, nb:], conj_trans=True)
        Vqs[k, :Mp - o] = packed_q
        Tqs[k] = Tq
        Ds[k] = packed_q[:nb, :nb]               # R -> band diagonal tile
        width = trail.shape[1]
        if width == 0:
            break                                # the last LQ panel: zero
        # LQ panel on the leading nb rows of the trailing columns: factor
        # blk^H = Q_l R_l, so blk Q_l = [L 0] with L = R_l^H
        packed_l, Tl = householder_panel_blocked(trail[:nb].conj().T,
                                                 rows=Np - nb)
        ell = torch.triu(packed_l).conj().T      # [nb, width]
        vrows = packed_l.conj().T
        jk = torch.arange(width, device=dev)[None, :]
        Ss[k] = torch.where(jk <= iw, ell, vrows)[:, :nb]
        Vls[k, :width] = packed_l
        Tls[k] = Tl
        A[o + nb:, o + nb:] = apply_q_right(packed_l, Tl, trail[nb:],
                                            conj_trans=False)
    return Vqs, Tqs, Vls, Tls, Ds, Ss


def _band_upper_from_stacks(Ds, Ss, n: int, nb: int):
    """The dense upper band from ge2tb's band tiles."""
    bd = assemble_band(torch.triu(Ds), torch.tril(Ss), lower=False)
    return _band_upper_of(bd[:n, :n], n, nb)


def _band_upper_of(a_packed, n: int, kd: int):
    """The n x n upper band (0 <= j - i <= kd) of ge2tb's packing."""
    return torch.triu(torch.tril(a_packed[:n, :n], kd))


# ---------------------------------------------------------------- stage 2

def _tb2bd(band: torch.Tensor, kd: int, want_uv: bool):
    """Upper band (bandwidth kd) -> real upper bidiagonal (d, e) by
    alternating right and left bulge-chase reflectors (ref: tb2bd.cc),
    one (sweep, pair) step after another.  Returns (d, e, U2, V2) with
    band = U2 B V2^H.

    The band sits at offset 2 kd in a matrix padded to N = n + 4 kd + 2, as
    the reference pads it, so that every window lies inside it.  No step
    reads the host."""
    n = band.shape[0]
    dt, dev = band.dtype, band.device
    if n == 1:
        d = band[0, 0].abs()[None]
        eye = torch.eye(1, dtype=dt, device=dev)
        return (d, torch.zeros((0,), dtype=d.dtype, device=dev),
                phase_of(band[0, 0]) * eye if want_uv else None,
                eye if want_uv else None)
    kd = max(1, min(kd, n - 1))
    off = 2 * kd
    N = n + 4 * kd + 2
    A = torch.zeros((N, N), dtype=dt, device=dev)
    A[off:off + n, off:off + n] = band
    U = torch.eye(N, dtype=dt, device=dev) if want_uv else None
    V = torch.eye(N, dtype=dt, device=dev) if want_uv else None
    check = dev.type == "cpu"
    umax = max(1, -(-(n - 1) // kd))
    for j in range(n - 1):
        for u in range(umax):
            if j + 1 + u * kd >= n:
                break
            # right sub-step: clear row r beyond its first superdiagonal
            r = (j if u == 0 else j + 1 + (u - 1) * kd) + off
            cb = j + 1 + u * kd + off
            v, tau, _ = householder_vec(A[r, cb:cb + kd].conj())
            Wr = A[cb - kd:cb + kd, cb:cb + kd]
            if check:
                assert Wr.shape == (2 * kd, kd)
            Wr.sub_(tau * (Wr @ v)[:, None] * v.conj()[None, :])
            if want_uv:
                Vc = V[:, cb:cb + kd]
                Vc.sub_(tau * (Vc @ v)[:, None] * v.conj()[None, :])
            # left sub-step: clear column rb below its diagonal
            rb = cb
            v2, tau2, _ = householder_vec(A[rb:rb + kd, rb])
            W2 = A[rb:rb + kd, rb:rb + 2 * kd + 1]
            if check:
                assert W2.shape == (kd, 2 * kd + 1)
            W2.sub_(tau2.conj() * v2[:, None] * (v2.conj() @ W2)[None, :])
            if want_uv:
                Uc = U[:, rb:rb + kd]
                Uc.sub_(tau2 * (Uc @ v2)[:, None] * v2.conj()[None, :])
    sq = A[off:off + n, off:off + n]
    d_c = sq.diagonal().clone()
    e_c = sq.diagonal(1).clone()
    if want_uv:
        U = U[off:off + n, off:off + n].clone()
        V = V[off:off + n, off:off + n].clone()
    if not is_complex(dt):
        return d_c, e_c, U, V
    # phase-normalise to a real bidiagonal (zbdsqr needs real d, e): with
    # l_j = phase(d_j r_j), r_{j+1} = conj(phase(conj(l_j) e_j)), r_0 = 1
    ls, rs = [], [torch.ones((), dtype=dt, device=dev)]
    for j in range(n):
        lj = phase_of(d_c[j] * rs[-1])
        ls.append(lj)
        if j + 1 < n:
            rs.append(phase_of(lj.conj() * e_c[j]).conj())
    ls, rs = torch.stack(ls), torch.stack(rs)
    d = (ls.conj() * d_c * rs).real
    e = (ls[:-1].conj() * e_c * rs[1:]).real
    if want_uv:
        # band = (U L) B_real (V R)^H, L = diag(ls), R = diag(rs)
        U = U * ls[None, :]
        V = V * rs[None, :]
    return d, e, U, V


def _bd_svd(d, e, want_uv: bool):
    """The bdsqr seam (ref: svd.cc:286): the library's SVD of the assembled
    bidiagonal.  Returns (s, U, Vh)."""
    B = torch.diag(d)
    if d.shape[0] > 1:
        B = B + torch.diag(e, 1)
    if want_uv:
        Ub, s, Vbh = _library_call(torch.linalg.svd, B)
        return s, Ub, Vbh
    return _library_call(torch.linalg.svdvals, B), None, None


@annotate("slate.bdsqr")
def bdsqr(d, e, opts: Options | None = None, *, device=None):
    """SVD of the real upper bidiagonal (d, e) (ref: src/bdsqr.cc): (s, U,
    Vh); under ``ErrorPolicy.Info``, ``(s, U, Vh, HealthInfo)``.  Host
    arrays go to ``device`` (None: CUDA)."""
    d = _vec(d, device)
    s, U, Vh = _bd_svd(d, _vec(e, d.device), True)
    return _health.finalize_flat("bdsqr", (s, U, Vh),
                                 _health.from_result(s), opts,
                                 _notconv_exc("bdsqr"))


@annotate("slate.tb2bd")
def tb2bd(TB, opts: Options | None = None, *, want_uv: bool = True):
    """Band -> bidiagonal bulge chase (ref: src/tb2bd.cc) of an upper
    TriangularBandMatrix: (d, e, U2, V2) with band = U2 B V2^H; under
    ``ErrorPolicy.Info``, ``(d, e, U2, V2, HealthInfo)``."""
    from ..core.matrix import TriangularBandMatrix
    slate_error(isinstance(TB, TriangularBandMatrix),
                "tb2bd: need TriangularBandMatrix")
    d, e, U2, V2 = _tb2bd(TB.to_dense(), TB.kd, want_uv=want_uv)
    h = _health.batch_merge(_health.batch_from_result(d[None]),
                            _health.batch_from_result(e[None]))
    return _health.finalize_flat("tb2bd", (d, e, U2, V2), h.to_list()[0],
                                 opts, _notconv_exc("tb2bd"))


def _stage2_svd(band, nb: int, jobu: bool, opts: Options | None):
    """Stage 2 and the bidiagonal seam by MethodSvd: (s, Un, Vn,
    BatchHealth) with band = Un diag(s) Vn^H (None when not jobu).  The
    fault sites ``post_stage1`` (the band) and ``post_chase`` (the chased
    diagonal) fire here.  Auto: the library's SVD of the band (it returns
    Vh; V = Vh^H); Bidiag: the tb2bd chase, then the bdsqr seam."""
    band = _faults.maybe_corrupt("post_stage1", band)
    if get_option(opts, Option.MethodSvd) is MethodSvd.Auto:
        if jobu:
            Ub, s, Vbh = _library_call(torch.linalg.svd, band)
            return s, Ub, Vbh.conj().T, _health.batch_from_result(s[None])
        s = _library_call(torch.linalg.svdvals, band)
        return s, None, None, _health.batch_from_result(s[None])
    d, e, U2, V2 = _tb2bd(band, nb, want_uv=jobu)
    d = _faults.maybe_corrupt("post_chase", d)
    s, Ub, Vbh = _bd_svd(d, e, jobu)
    h = _health.batch_merge(_health.batch_from_result(d[None]),
                            _health.batch_from_result(e[None]),
                            _health.batch_from_result(s[None]))
    if not jobu:
        return s, None, None, h
    return s, U2 @ Ub.to(U2.dtype), V2 @ Vbh.to(V2.dtype).conj().T, h


def _unmbr_ge2tb_u(Vqs, Tqs, nb: int, Z):
    """Z <- Q_qr Z (ref: unmbr_ge2tb, U side): panel k acts on rows k nb
    and below; Z has Mp rows."""
    return rolled_apply(Vqs, Tqs, [k * nb for k in range(Tqs.shape[0])], Z)


def _unmbr_ge2tb_v(Vls, Tls, nb: int, Z):
    """Z <- V1 Z, V1 = W_0 W_1 ... (ref: unmbr_ge2tb, V side): W_k acts on
    rows (k+1) nb and below; Z has Np rows."""
    return rolled_apply(Vls, Tls,
                        [(k + 1) * nb for k in range(Tls.shape[0])], Z)


def _svd_compute(A: Matrix, opts: Options | None, jobu: bool):
    """svd's recursion: (s, Um, Vm, BatchHealth), no policy and no
    certificate (m < n recurses on A^H with U and V swapped; the
    certificate comes once, in svd_info)."""
    slate_error(type(A) is Matrix,
                "svd: need a general Matrix (convert structured types "
                "with .general())")
    m, n = A.m, A.n
    if m < n:
        s, V, U, h = _svd_compute(_conj_t_root(A), opts, jobu)
        return s, U, V, h
    if on_mesh(opts, A):
        return _svd_mesh(A, opts, jobu)
    nb = A.nb
    ad = A.to_dense()
    with span("slate.svd/ge2tb"):
        Vqs, Tqs, Vls, Tls, Ds, Ss = _ge2tb_scan(ad, nb)
        band = _band_upper_from_stacks(Ds, Ss, n, nb)
    with span("slate.svd/stage2"):
        s, Un, Vn, h = _stage2_svd(band, nb, jobu, opts)
    if not jobu:
        return s, None, None, h
    with span("slate.svd/backtransform"):
        dt, dev = ad.dtype, ad.device
        Mp = Vqs.shape[1]
        Np = -(-n // nb) * nb
        Upad = torch.zeros((Mp, n), dtype=dt, device=dev)
        Upad[:n, :n] = Un.to(dt)
        Ufull = _unmbr_ge2tb_u(Vqs, Tqs, nb, Upad)[:m]
        Ufull = _faults.maybe_corrupt("post_backtransform", Ufull)
        Vpad = torch.zeros((Np, n), dtype=dt, device=dev)
        Vpad[:n] = Vn.to(dt)
        Vfull = _unmbr_ge2tb_v(Vls, Tls, nb, Vpad)[:n]
        g = A.grid
        Um = Matrix(TileStorage.from_dense(Ufull, A.mb, A.nb, g))
        Vm = Matrix(TileStorage.from_dense(Vfull, A.nb, A.nb, g))
    return s, Um, Vm, h


def _band_upper_from_tiles(st, n: int, nb: int) -> torch.Tensor:
    """The n x n upper band from the ge2tb-packed storage: the triu of the
    diagonal tiles and the tril of the superdiagonal ones (ref:
    svd.py:373, TriangularBandMatrix::ge2tbGather): only the O(n nb) band
    tiles leave the grid."""
    from .heev import _band_diag_tiles
    Ntn = -(-n // nb)
    dd = torch.triu(_band_diag_tiles(st, 0)[:Ntn])
    ss = (torch.tril(_band_diag_tiles(st, -1)[:Ntn - 1]) if Ntn > 1
          else torch.zeros((0, nb, nb), dtype=st.dtype, device=st.device))
    bd = assemble_band(dd, ss, lower=False)
    return _band_upper_of(bd[:n, :n], n, nb)


def _svd_mesh(A: Matrix, opts, jobu: bool):
    """svd's mesh route for m >= n (ref: svd.py:388-440): stage 1
    distributed (``dist_ge2tb``) on the rank's tiles (in place for a root
    NoTrans view in square tiles, else densified first), the band
    gathered, stage 2 replicated, U = U1 [Un; 0] and V = V1 Vn by the
    distributed panel chains, Un padded to m x n in tile space, never as a
    replicated dense m x n.  Returns (s, Um, Vm, BatchHealth)."""
    from ..parallel.dist_ge2tb import (dist_ge2tb, dist_unmbr_ge2tb_u,
                                       dist_unmbr_ge2tb_v)
    from ..parallel.dist_lu import SUPERBLOCKS, superblock
    m, n, nb, grid = A.m, A.n, A.nb, A.grid
    if (A.op is Op.NoTrans and A.is_root_view()
            and A.storage.mb == A.storage.nb):
        st_in = A.storage
    else:
        st_in = TileStorage.from_dense(A.to_dense(), nb, nb, grid)
    la = max(1, int(get_option(opts, Option.Lookahead)))
    with span("slate.svd/ge2tb"):
        data, Tqs, Tls = dist_ge2tb(st_in.data, st_in.Mt, st_in.Nt, m, n,
                                    grid, sb=superblock(max(st_in.Nt, 1),
                                                        SUPERBLOCKS * la))
        band = _band_upper_from_tiles(TileStorage(data, m, n, nb, nb, grid),
                                      n, nb)
    with span("slate.svd/stage2"):
        s, Uns, Vns, h = _stage2_svd(band, nb, jobu, opts)
    if not jobu:
        return s, None, None, h
    with span("slate.svd/backtransform"):
        dt = data.dtype
        un = TileStorage.from_dense(Uns.to(dt), nb, nb, grid)
        vn = TileStorage.from_dense(Vns.to(dt), nb, nb, grid)
        # [Un; 0]: local tile row s is global row r + p s in both storages
        uf = TileStorage.zeros(m, n, nb, nb, grid, dt, data.device)
        uf.data[:un.mtl] = un.data
        u_data = dist_unmbr_ge2tb_u(data, Tqs, uf.data, grid, m)
        u_data = _faults.maybe_corrupt("post_backtransform", u_data)
        v_data = dist_unmbr_ge2tb_v(data, Tls, vn.data, grid, n)
    return (s, Matrix(TileStorage(u_data, m, n, nb, nb, grid)),
            Matrix(TileStorage(v_data, n, n, nb, nb, grid)), h)


def svd_info(A: Matrix, opts: Options | None = None, *, jobu: bool = True):
    """svd's body: ``((s, Um, Vm), HealthInfo)``, no policy resolution
    (the recovery ladder escalates on it).  The health merges stage 2's
    flags with the SVD certificate of the back-transformed factors against
    the original A (``certify.certify_svd``), folded over the grid on a
    mesh and read from the device once."""
    s, Um, Vm, h = _svd_compute(A, opts, jobu)
    if jobu:
        with span("slate.svd/certify"):
            h = _health.batch_merge(
                _certify.certify_svd(A.to_dense(), s, Um.to_dense(),
                                     Vm.to_dense()), h)
    return (s, Um, Vm), _health.batch_fold(h, A.grid).to_list()[0]


@annotate("slate.svd")
def svd(A: Matrix, opts: Options | None = None, *, jobu: bool = True):
    """Singular value decomposition A = U diag(s) V^H (ref: src/svd.cc):
    (s, U, V) with thin U [m, r], V [n, r], r = min(m, n); (s, None, None)
    when not jobu; under ``ErrorPolicy.Info`` the HealthInfo is appended.
    m < n factors A^H.  Every result is certified (residual, left and
    right orthogonality); a failed certificate escalates MethodSvd Auto ->
    Bidiag before the ErrorPolicy resolves (``recovery.svd_with_recovery``)."""
    from ..robust.recovery import svd_with_recovery
    return svd_with_recovery(A, opts, jobu=jobu)


@annotate("slate.svd_vals")
def svd_vals(A: Matrix, opts: Options | None = None):
    """Singular values only (ref: simplified_api svd_vals).  Under
    ``ErrorPolicy.Info``, ``(s, HealthInfo)``."""
    res = svd(A, opts, jobu=False)
    if _health.error_policy(opts) is ErrorPolicy.Info:
        s, _, _, h = res
        return s, h
    return res[0]


def _conj_t_root(A) -> Matrix:
    return Matrix(TileStorage.from_dense(A.to_dense().conj().T, A.nb, A.mb,
                                         A.grid))
