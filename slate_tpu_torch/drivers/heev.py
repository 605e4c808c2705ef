"""Two-stage Hermitian eigensolver: he2hb -> hb2st -> tridiagonal eig ->
back-transform (port of slate_tpu/drivers/heev.py; ref: src/heev.cc:56-177,
he2hb.cc:25, hb2st.cc:41-314, unmtr_he2hb.cc).

- he2hb: blocked Householder band reduction, the two-sided her2k-form
  update of each panel three matmuls; the panels factor by
  ``householder_panel_blocked`` as the reference's do.  The reference
  re-anchors the trailing block to the origin of a fresh zero N x N
  matrix every panel so that XLA compiles one scan body; eagerly, each
  panel updates the shrinking trailing view in place instead (zero rows
  are fixed points of the update, so the product is the same), and the
  returned stacks keep the reference's shapes.
- stage 2 (MethodEig): Auto eigendecomposes the band with the library's
  eigh; QR and DC chase the band to a real tridiagonal (hb2st, one
  reflector pair a step, no host read inside the chase) and then take the
  library's eigh of T (QR) or the native divide and conquer (DC,
  drivers/stedc.py).
- eigenvectors: Z = Q1 (Q2 Z_tri), Q1 applied panel by panel
  (internal/qr.py ``rolled_apply``).

The reference runs all of it outside any Pallas kernel, so on the card it
is library calls; ``hegv`` factors B with ``potrf`` (K2 and K0 on the
card; on a mesh ``dist_potrf``, K1 on each diagonal tile).

On a grid with a process group (``Target.mesh``, auto on more than one
rank) heev takes ``_heev_mesh``: stage 1 runs distributed
(parallel/dist_he2hb.py) on the rank's tiles, only the O(n nb) band
leaves the grid (``_band_from_tiles``), stage 2 runs replicated on every
rank, as the reference's does, with stedc's merges row-distributed on
the DC route, and the back-transform is distributed.  The health that
picks a ladder rung is folded over the grid before any rank reads it.
``Target.mesh`` on a grid without a group takes the single route, as the
reference does where the grid has no mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.layout import assemble_band
from ..core.matrix import HermitianMatrix, Matrix, SymmetricMatrix
from ..core.storage import TileStorage, as_tensor
from ..exceptions import SlateNotConvergedError, slate_error
from ..internal.qr import (householder_panel_blocked, householder_vec,
                           phase_of, rolled_apply, unit_lower)
from ..options import (ErrorPolicy, MethodEig, Option, Options, get_option,
                       on_mesh)
from ..robust import certify as _certify
from ..robust import faults as _faults
from ..robust import health as _health
from ..types import Op, Uplo, is_complex
from ..util.trace import annotate, span


def _notconv_exc(name):
    return lambda h: SlateNotConvergedError(
        f"{name}: eigensolve failed certification ({h.describe()})",
        iters=int(h.iters))


def _vec(x, device):
    """A tridiagonal's host data on ``device``; tensors stay where they
    are."""
    return x if isinstance(x, torch.Tensor) else as_tensor(np.asarray(x),
                                                           device)


def _library_call(fn, x, *, hermitian: bool = False):
    """``fn(x)`` of a library eigen- or singular value routine, as XLA's
    routine answers.  ``hermitian``: the input is symmetrized, (x + x^H) /
    2, first, as jnp.linalg.eigh does (the library's eigh would read the
    lower triangle alone, so a struck upper entry would go unseen).  A
    non-finite input makes every output NaN: the library refuses it
    ("failed to converge") where XLA returns NaN, so the guard hands the
    library zeros and poisons its outputs, with no host read."""
    if hermitian:
        x = 0.5 * (x + x.conj().transpose(-2, -1))
    ok = torch.isfinite(x).all()
    out = fn(torch.where(ok, x, torch.zeros_like(x)))
    nan = float("nan")
    if isinstance(out, torch.Tensor):
        return torch.where(ok, out, nan)
    return tuple(torch.where(ok, o, nan) for o in out)


# ---------------------------------------------------------------- stage 1

def _he2hb_scan(a: torch.Tensor, nb: int):
    """Full Hermitian (both triangles) -> band of bandwidth nb, one panel
    at a time on the shrinking trailing view (ref: he2hb.cc:438-578).

    Returns (Vs, Ts, Ds, Ss) in the reference's shapes: packed panels
    [K, N-nb, nb] (panel k's row 0 is global row (k+1) nb, zero below its
    live rows), T triangles [K, nb, nb], band diagonal tiles Ds
    [Mt, nb, nb] and subdiagonal R tiles Ss [K, nb, nb].  N = Mt nb."""
    n = a.shape[0]
    dt, dev = a.dtype, a.device
    Mt = -(-n // nb)
    N = Mt * nb
    K = Mt - 1
    A = torch.zeros((N, N), dtype=dt, device=dev)
    A[:n, :n] = a
    Vs = torch.zeros((K, max(N - nb, 0), nb), dtype=dt, device=dev)
    Ts = torch.zeros((K, nb, nb), dtype=dt, device=dev)
    Ds = torch.empty((Mt, nb, nb), dtype=dt, device=dev)
    Ss = torch.zeros((K, nb, nb), dtype=dt, device=dev)
    for k in range(K):
        o = k * nb
        Ds[k] = A[o:o + nb, o:o + nb]
        packed, T = householder_panel_blocked(A[o + nb:, o:o + nb],
                                              rows=N - nb)
        V = unit_lower(packed)
        # A <- A - V W^H - W V^H, W = Y T - 1/2 V (T^H (V^H Y) T), Y = A V
        trail = A[o + nb:, o + nb:]
        Y = trail @ V
        VY = V.conj().T @ Y
        W = Y @ T - 0.5 * (V @ (T.conj().T @ (VY @ T)))
        trail.sub_(V @ W.conj().T).sub_(W @ V.conj().T)
        Vs[k, :N - o - nb] = packed
        Ts[k] = T
        Ss[k] = packed[:nb, :nb]
    Ds[K] = A[K * nb:, K * nb:]
    return Vs, Ts, Ds, Ss


def _band_from_stacks(Ds, Ss, n: int, nb: int):
    """The dense Hermitian band from he2hb's band tiles."""
    bd = assemble_band(Ds, torch.triu(Ss), lower=True)
    return _band_of(bd[:n, :n], nb)


def _band_of(a_packed: torch.Tensor, kd: int) -> torch.Tensor:
    """The Hermitian band (both triangles) of bandwidth kd from he2hb's
    lower packing, its diagonal real."""
    low = torch.tril(torch.triu(a_packed, -kd))
    diag = low.diagonal().real.clone()
    full = low + low.conj().T
    full.diagonal().copy_(diag.to(full.dtype))
    return full


def _band_diag_tiles(st, off: int) -> torch.Tensor:
    """The tile diagonal at row offset ``off`` (tiles (g + max(off, 0),
    g + max(-off, 0))) of a storage sharded over a grid with a process
    group, never a full ``canonical()`` (ref: heev.py:129): each rank
    fills the tiles it owns and one all-reduce over the grid gives them
    all to every rank (the others add zeros)."""
    from ..comm.collectives import reduce_grid
    count = max(min(st.Mt - max(off, 0), st.Nt - max(-off, 0)), 0)
    gi = np.arange(count) + max(off, 0)
    gj = np.arange(count) + max(-off, 0)
    g = st.grid
    r, c = g.coords
    mine = np.nonzero((gi % g.p == r) & (gj % g.q == c))[0]
    out = torch.zeros((count, st.mb, st.nb), dtype=st.dtype,
                      device=st.device)
    out[mine] = st.data[gi[mine] // g.p, gj[mine] // g.q]
    return reduce_grid(out, g)


def _band_from_tiles(st, n: int, nb: int) -> torch.Tensor:
    """The Hermitian band (dense [n, n], both triangles) from the
    he2hb-packed storage: the diagonal tiles and the triu of the
    subdiagonal R blocks (ref: heev.py:142, HermitianBandMatrix::
    he2hbGather): only the O(n nb) band tiles leave the grid."""
    dd = _band_diag_tiles(st, 0)
    ss = (torch.triu(_band_diag_tiles(st, 1)) if st.Mt > 1
          else torch.zeros((0, nb, nb), dtype=st.dtype, device=st.device))
    bd = assemble_band(dd, ss, lower=True)
    return _band_of(bd[:n, :n], nb)


def _unmtr_he2hb_stack(Vs, Ts, nb: int, Z):
    """Z <- Q1 Z, Q1 he2hb's panel product (ref: unmtr_he2hb.cc): panel k
    acts on rows (k+1) nb and below; Z has N = Mt nb rows."""
    return rolled_apply(Vs, Ts, [(k + 1) * nb for k in range(Ts.shape[0])],
                        Z)


# ---------------------------------------------------------------- stage 2

def _chase_steps(n: int, kd: int) -> int:
    """The (sweep, step) pairs of hb2st's chase of an n x n band of
    bandwidth kd (tb2bd's chase takes as many pairs, two reflectors
    each)."""
    kd = max(1, min(kd, n - 1))
    tmax = max(1, -(-(n - 1) // kd))
    return sum(1 for j in range(n - 1) for t in range(tmax)
               if j + 1 + t * kd < n)


def _hb2st(band: torch.Tensor, kd: int, want_q: bool):
    """Band (full Hermitian, bandwidth kd) -> real tridiagonal (d, e) by
    Householder bulge chasing (ref: hb2st.cc:41-314), one (sweep, step)
    pair after another.  Returns (d [n], e [n-1], Q2 [n, n] or None) with
    band = Q2 T Q2^H.

    The matrix is padded to N = n + 3 kd + 2, as the reference pads it, so
    that every window lies inside it (the reference's dynamic_slice would
    clamp a window that ran out; a tensor slice would truncate it).  No
    step reads the host."""
    n = band.shape[0]
    dt, dev = band.dtype, band.device
    if n == 1:
        d = band.diagonal().real.clone()
        return d, torch.zeros((0,), dtype=d.dtype, device=dev), (
            torch.eye(1, dtype=dt, device=dev) if want_q else None)
    kd = max(1, min(kd, n - 1))
    N = n + 3 * kd + 2
    A = torch.zeros((N, N), dtype=dt, device=dev)
    A[:n, :n] = band
    Q = torch.eye(N, dtype=dt, device=dev) if want_q else None
    W = 3 * kd + 1
    check = dev.type == "cpu"
    tmax = max(1, -(-(n - 1) // kd))
    for j in range(n - 1):
        for t in range(tmax):
            b = j + 1 + t * kd                   # window row base
            if b >= n:
                break
            c = j if t == 0 else b - kd          # column being cleared
            v, tau, _ = householder_vec(A[b:b + kd, c])
            # left: rows [b, b+kd) x cols [c, c+W): H^H A
            Wr = A[b:b + kd, c:c + W]
            # right: rows [c, c+W) x cols [b, b+kd): A H
            Wc = A[c:c + W, b:b + kd]
            if check:
                assert Wr.shape == (kd, W) and Wc.shape == (W, kd)
            Wr.sub_(tau.conj() * v[:, None] * (v.conj() @ Wr)[None, :])
            Wc.sub_(tau * (Wc @ v)[:, None] * v.conj()[None, :])
            if want_q:
                Qc = Q[:, b:b + kd]
                Qc.sub_(tau * (Qc @ v)[:, None] * v.conj()[None, :])
    d = A.diagonal()[:n].real.clone()
    e_c = A.diagonal(-1)[:n - 1]
    if is_complex(dt):
        # phase-normalise the subdiagonal (LAPACK zhbtrd's final scaling):
        # T_real = D^H T D, D folded into Q
        D = torch.cat([torch.ones((1,), dtype=dt, device=dev),
                       torch.cumprod(phase_of(e_c), dim=0)])
        e = e_c.abs()
        if want_q:
            Q[:, :n] *= D[None, :]
    else:
        e = e_c.clone()
    return d, e, (Q[:n, :n].clone() if want_q else None)


def _tridiag(d, e):
    T = torch.diag(d)
    if d.shape[0] > 1:
        T = T + torch.diag(e, -1) + torch.diag(e, 1)
    return T


def _tridiag_eig(d, e, want_z: bool, opts: Options | None = None,
                 grid=None):
    """Tridiagonal kernel seam (ref: heev.cc:141-153): MethodEig.DC runs
    the divide and conquer (drivers/stedc.py; its merge products
    row-distributed when ``grid`` carries a process group); otherwise the
    library's eigh of the assembled T (the steqr2 analog).  Returns (w, Z
    or None, BatchHealth)."""
    dev = d.device
    if (get_option(opts, Option.MethodEig) is MethodEig.DC and want_z
            and d.shape[0] > 1):
        from .stedc import _stedc_device
        # heev certifies its own (w, Z) against A: only the merges' flags
        w, z, ok = _stedc_device(d, e, grid)
        h = _health.batch_merge(
            _health.batch_healthy(1, dev)._replace(converged=ok.reshape(1)),
            _health.batch_from_result(w[None]))
        return w, z, h
    T = _tridiag(d, e)
    if want_z:
        w, z = _library_call(torch.linalg.eigh, T, hermitian=True)
        return w, z, _health.batch_from_result(w[None])
    w = _library_call(torch.linalg.eigvalsh, T, hermitian=True)
    return w, None, _health.batch_from_result(w[None])


def _stage2_eig(band, nb: int, jobz: bool, opts: Options | None,
                grid=None):
    """Stage 2 and the tridiagonal seam by MethodEig: (w, Z2, BatchHealth)
    with band = Z2 diag(w) Z2^H (Z2 None when not jobz).  The fault sites
    ``post_stage1`` (the band) and ``post_chase`` (the chased diagonal)
    fire here.  Auto: the library's eigh of the band, no chase; QR and
    DC: the hb2st chase, then the (d, e) seam (``grid``: see
    :func:`_tridiag_eig`)."""
    band = _faults.maybe_corrupt("post_stage1", band)
    if get_option(opts, Option.MethodEig) is MethodEig.Auto:
        if jobz:
            w, Z2 = _library_call(torch.linalg.eigh, band, hermitian=True)
        else:
            w = _library_call(torch.linalg.eigvalsh, band, hermitian=True)
            Z2 = None
        return w, Z2, _health.batch_from_result(w[None])
    d, e, Q2 = _hb2st(band, nb, want_q=jobz)
    d = _faults.maybe_corrupt("post_chase", d)
    w, ztri, h = _tridiag_eig(d, e, jobz, opts, grid)
    h = _health.batch_merge(h, _health.batch_from_result(d[None]),
                            _health.batch_from_result(e[None]))
    if not jobz:
        return w, None, h
    return w, Q2 @ ztri.to(Q2.dtype), h


@annotate("slate.sterf")
def sterf(d, e, opts: Options | None = None, *, device=None):
    """Eigenvalues of the real symmetric tridiagonal (d, e), no vectors
    (ref: src/sterf.cc).  Under ``ErrorPolicy.Info``, ``(w, HealthInfo)``.
    Host arrays go to ``device`` (None: CUDA)."""
    d = _vec(d, device)
    w, _, h = _tridiag_eig(d, _vec(e, d.device), False, opts)
    return _health.finalize("sterf", w, h.to_list()[0], opts,
                            _notconv_exc("sterf"))


@annotate("slate.steqr")
def steqr(d, e, opts: Options | None = None, *, device=None):
    """Eigendecomposition of the real symmetric tridiagonal (d, e)
    (ref: src/steqr2.cc; the library's eigh, or stedc under MethodEig.DC).
    Returns (w, Z); under ``ErrorPolicy.Info``, ``(w, Z, HealthInfo)``."""
    d = _vec(d, device)
    w, z, h = _tridiag_eig(d, _vec(e, d.device), True, opts)
    return _health.finalize_flat("steqr", (w, z), h.to_list()[0], opts,
                                 _notconv_exc("steqr"))


@annotate("slate.hb2st")
def hb2st(HB, opts: Options | None = None, *, want_q: bool = True):
    """Band -> tridiagonal bulge chase (ref: src/hb2st.cc) of a
    HermitianBandMatrix: (d, e, Q2) with band = Q2 T Q2^H; under
    ``ErrorPolicy.Info``, ``(d, e, Q2, HealthInfo)``."""
    from ..core.matrix import HermitianBandMatrix
    slate_error(isinstance(HB, HermitianBandMatrix), "hb2st: need "
                "HermitianBandMatrix")
    d, e, Q2 = _hb2st(HB.to_dense(), HB.kd, want_q=want_q)
    h = _health.batch_merge(_health.batch_from_result(d[None]),
                            _health.batch_from_result(e[None]))
    return _health.finalize_flat("hb2st", (d, e, Q2), h.to_list()[0], opts,
                                 _notconv_exc("hb2st"))


def heev_info(A, opts: Options | None = None, *, jobz: bool = True):
    """heev's body: ``((w, Zm), HealthInfo)``, no policy resolution (the
    recovery ladder escalates on it).  The health merges stage 2's flags
    with the eigen-certificate of the back-transformed pairs against the
    original A (``certify.certify_eig``), folded over the grid on a mesh
    and read from the device once."""
    slate_error(isinstance(A, (HermitianMatrix, SymmetricMatrix)),
                "heev: need HermitianMatrix/SymmetricMatrix")
    # a complex symmetric matrix has no eigendecomposition of this form
    slate_error(isinstance(A, HermitianMatrix) or not is_complex(A.dtype),
                "heev: complex SymmetricMatrix is not Hermitian — "
                "no eigensolver for complex-symmetric matrices")
    if on_mesh(opts, A):
        w, Zm, h = _heev_mesh(A, opts, jobz)
        if jobz:
            # to_dense on a grid with a group is an all-gather (every rank)
            with span("slate.heev/certify"):
                h = _health.batch_merge(_certify.certify_eig(
                    A.to_dense(), w, Zm.to_dense()), h)
        return (w, Zm), _health.batch_fold(h, A.grid).to_list()[0]
    n, nb = A.m, A.nb
    ad = A.to_dense()
    with span("slate.heev/he2hb"):
        Vs, Ts, Ds, Ss = _he2hb_scan(ad, nb)
        band = _band_from_stacks(Ds, Ss, n, nb)
    with span("slate.heev/stage2"):
        w, Z2, h = _stage2_eig(band, nb, jobz, opts)
    Zm = None
    if jobz:
        with span("slate.heev/backtransform"):
            N = Ds.shape[0] * nb
            Zpad = torch.zeros((N, n), dtype=Z2.dtype, device=Z2.device)
            Zpad[:n] = Z2
            Z = _unmtr_he2hb_stack(Vs, Ts, nb, Zpad)[:n]
            Z = _faults.maybe_corrupt("post_backtransform", Z)
            Zm = Matrix(TileStorage.from_dense(Z, A.mb, A.nb, A.grid))
        with span("slate.heev/certify"):
            h = _health.batch_merge(_certify.certify_eig(ad, w, Z), h)
    return (w, Zm), h.to_list()[0]


def _heev_mesh(A, opts, jobz: bool):
    """heev's mesh route (ref: heev.py:398-441): stage 1 distributed
    (``dist_he2hb``) on the rank's tiles, the band gathered, stage 2
    replicated, the back-transform distributed (``dist_unmtr_he2hb``).
    Returns (w, Zm or None, BatchHealth).  The input is used in place
    when it is a Lower-stored root view in square tiles whose op leaves a
    Hermitian matrix as it is (NoTrans, ConjTrans, and Trans when real);
    the Trans view of a complex Hermitian is conj(A), and an Upper view
    must be normalised, so those are densified first."""
    from ..parallel.dist_he2hb import dist_he2hb, dist_unmtr_he2hb
    from ..parallel.dist_lu import SUPERBLOCKS, superblock
    n, nb, grid = A.m, A.nb, A.grid
    safe = ((Op.NoTrans, Op.ConjTrans) if is_complex(A.dtype)
            else (Op.NoTrans, Op.ConjTrans, Op.Trans))
    if (A.uplo is Uplo.Lower and A.op in safe and A.is_root_view()
            and A.storage.mb == A.storage.nb):
        st_in = A.storage
    else:
        st_in = TileStorage.from_dense(A.to_dense(), nb, nb, grid)
    # Option.Lookahead sizes the reference's superblocks, which choose the
    # panel routine's route; the pipeline depth is dist_he2hb's own
    la = max(1, int(get_option(opts, Option.Lookahead)))
    with span("slate.heev/he2hb"):
        data, Ts = dist_he2hb(st_in.data, st_in.Nt, grid, n=n,
                              sb=superblock(max(st_in.Nt - 1, 1),
                                            SUPERBLOCKS * la))
        band = _band_from_tiles(TileStorage(data, n, n, nb, nb, grid), n,
                                nb)
    with span("slate.heev/stage2"):
        w, Z2, h = _stage2_eig(band, nb, jobz, opts, grid)
    if not jobz:
        return w, None, h
    with span("slate.heev/backtransform"):
        z0 = TileStorage.from_dense(Z2, nb, nb, grid)
        z_data = dist_unmtr_he2hb(data, Ts, z0.data, st_in.Nt, grid, n=n)
        z_data = _faults.maybe_corrupt("post_backtransform", z_data)
    return w, Matrix(TileStorage(z_data, n, n, nb, nb, grid)), h


@annotate("slate.heev")
def heev(A, opts: Options | None = None, *, jobz: bool = True):
    """Eigendecomposition A = Z diag(w) Z^H of a Hermitian or real
    symmetric A (ref: src/heev.cc).  Returns (w, Z), Z None when not jobz;
    under ``ErrorPolicy.Info``, ``(w, Z, HealthInfo)``.  Every result is
    certified (residual and orthogonality); a failed certificate escalates
    MethodEig Auto -> DC -> QR before the ErrorPolicy resolves
    (``recovery.heev_with_recovery``)."""
    from ..robust.recovery import heev_with_recovery
    return heev_with_recovery(A, opts, jobz=jobz)


@annotate("slate.heevd")
def heevd(A, opts: Options | None = None):
    """Eigenvalues and vectors, the LAPACK heevd contract: heev(A)."""
    return heev(A, opts, jobz=True)


@annotate("slate.heev_vals")
def heev_vals(A, opts: Options | None = None):
    """Eigenvalues only (ref: heev with Job::NoVec).  Under
    ``ErrorPolicy.Info``, ``(w, HealthInfo)``."""
    res = heev(A, opts, jobz=False)
    if _health.error_policy(opts) is ErrorPolicy.Info:
        w, _, h = res
        return w, h
    return res[0]


def _lower_factor(L):
    """The lower Cholesky factor of B = L L^H, given L or an upper U with
    B = U^H U."""
    return L.conj_transpose() if L._uplo_logical() is Uplo.Upper else L


@annotate("slate.hegst")
def hegst(A, L, opts: Options | None = None, *, itype: int = 1):
    """Reduce a generalized Hermitian-definite problem to standard form,
    B = L L^H (ref: src/hegst.cc:40-41): itype 1, C = L^-1 A L^-H (two
    trsm); itype 2 and 3, C = L^H A L (two trmm).  An upper factor U (B =
    U^H U, what ``potrf`` returns for an Upper-stored B) is taken as L =
    U^H; the reference applies the formulas to U itself, which is wrong."""
    from .blas3 import trmm, trsm
    slate_error(itype in (1, 2, 3), "hegst: itype must be 1, 2, or 3")
    L = _lower_factor(L)
    Ag = A.general() if not isinstance(A, Matrix) else A
    if itype == 1:
        G = trsm("l", 1.0, L, Ag, opts)
        G2 = trsm("r", 1.0, L.conj_transpose(), G, opts)
    else:
        G = trmm("l", 1.0, L.conj_transpose(), Ag, opts)
        G2 = trmm("r", 1.0, L, G, opts)
    return HermitianMatrix._from_view(G2, Uplo.Lower)


@annotate("slate.hegv")
def hegv(A, B, opts: Options | None = None, *, jobz: bool = True,
         itype: int = 1):
    """Generalized Hermitian-definite eigenproblem (ref: src/hegv.cc:22-35):
    itype 1, A x = w B x; 2, A B x = w x; 3, B A x = w x.  B = L L^H by
    ``potrf`` (K2 and K0 on the card; on a mesh ``dist_potrf``, K1 on
    each diagonal tile, then the mesh trsm or trmm and heev; an
    Upper-stored B's factor U is taken as L = U^H, where the reference
    uses U and is wrong); returns
    (w, X), X None when not jobz; under ``ErrorPolicy.Info``, ``(w, X,
    HealthInfo)`` merging the Cholesky and eigensolve healths."""
    from .blas3 import trmm, trsm
    from .cholesky import potrf
    slate_error(itype in (1, 2, 3), "hegv: itype must be 1, 2, or 3")
    info = _health.error_policy(opts) is ErrorPolicy.Info
    if info:
        L, h_chol = potrf(B, opts)
    else:
        L = potrf(B, opts)                   # Raise / Nan resolve inside
    L = _lower_factor(L)
    C = hegst(A, L, opts, itype=itype)
    res = heev(C, opts, jobz=jobz)
    if info:
        w, Z, h_eig = res
        h = _health.merge(h_chol, h_eig)
    else:
        w, Z = res
    if not jobz:
        return (w, None, h) if info else (w, None)
    if itype == 3:
        X = trmm("l", 1.0, L, Z, opts)
    else:
        X = trsm("l", 1.0, L.conj_transpose(), Z, opts)
    if info:
        return w, X, _health.merge(h, _health.from_result(X.storage.data,
                                                          X.grid))
    return w, X
