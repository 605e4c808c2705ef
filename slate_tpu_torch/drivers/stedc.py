"""stedc: divide and conquer symmetric tridiagonal eigensolver (port of
slate_tpu/drivers/stedc.py; ref: src/stedc.cc:46-96, stedc_merge.cc:232,
stedc_deflate.cc:595, stedc_secular.cc:271, stedc_sort.cc).

- Recursion: static halving down to <= LEAF-sized problems, torn by the
  rank-one split d1[m-1] -= rho, d2[0] -= rho.  The leaves are gathered
  first and eigendecomposed by the library's eigh, one batched call for
  each leaf size (the reference calls eigh a leaf).
- Rank-one merge diag(D) + rho z z^T: z deflation is masked (deflated
  entries keep z = 0); near-equal d's are rotated together by a Givens
  chain (ref: stedc_deflate.cc).  A chain step is the identity unless its
  pair is close and both z's are nonzero, and a step that rotates leaves a
  nonzero z behind, so which steps rotate is known before the chain runs:
  the rotating steps run in waves, wave t holding the t-th step of every
  run of consecutive rotating steps, which is the sequential chain's
  arithmetic in the sequential chain's order within each run.  The same
  waves apply the rotations to the eigenvector columns.
- Secular roots: log-space bisection on the offset from the nearest pole,
  80 steps (the code's count; the reference's docstring says 64), for all
  roots at once, taken in row chunks so that no temporary exceeds
  _CHUNK_ELEMS elements.
- Orthogonality: Gu-Eisenstat's zhat from the computed roots, then the
  eigenvectors u_i = zhat_j / (d_j - lambda_i), normalized; the merge's
  eigenvectors are one product Q0 @ U.

The reference pins its products to "highest" precision; here every merge
runs with TF32 off.  On a grid with a process group each merge's product
Qm = Q0 U is row-distributed (``_merge_gemm``): every rank forms its own
block of rows, U replicated, and one all-gather over the grid gives the
whole Qm to every rank; deflation and the secular solves stay replicated.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.storage import as_tensor, grid_device
from ..exceptions import SlateNotConvergedError
from ..options import Options
from ..robust import certify as _certify
from ..robust import faults as _faults
from ..robust import health as _health
from ..types import eps as _eps
from ..util.trace import annotate, span
from .heev import _library_call

LEAF = 32
# the largest [rows, n] temporary of the secular bisection: 64 MB in f32
_CHUNK_ELEMS = 1 << 24


def _limits(dt: torch.dtype):
    """(log_range, tiny, log_max) of the dtype: the log-space bisection and
    the log-product guards stay inside its exp range (f32 overflows exp
    past ~88)."""
    fi = np.finfo(str(dt).replace("torch.", ""))
    log_max = float(np.log(fi.max)) * 0.9
    return log_max, float(fi.tiny), log_max


@contextlib.contextmanager
def _full_precision():
    """Products in full f32 inside the merges (the reference's
    ``default_matmul_precision("highest")``): TF32 off, whatever the
    caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _secular_roots(cd, cz2, rho, na):
    """Roots of 1 + rho sum_j cz2_j / (cd_j - lambda) in each active
    interval, each anchored at its nearest pole (the laed4 discipline).

    Returns (delta, use_up): lambda_i = cd_{i + use_up_i} + delta_i.
    rho > 0, cd ascending over the active prefix, cz2 zero elsewhere,
    ``na`` the active count (a 0-d tensor)."""
    n = cd.shape[0]
    i_all = torch.arange(n, device=cd.device)
    cd_next = torch.cat([cd[1:], cd[-1:]])
    last = i_all == na - 1
    ub = torch.where(last, cd + rho, cd_next)
    gap = torch.clamp(ub - cd, min=0.0)
    lrange, tiny, _ = _limits(cd.dtype)
    safe_gap = torch.clamp(gap, min=tiny)
    step = max(1, _CHUNK_ELEMS // n)

    def bisect(anchor, sgn, flip):
        """Log-space bisection, off = sgn * gap * e^t, t in [-lrange, 0],
        80 steps, a chunk of rows at a time."""
        out = torch.empty_like(gap)
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            dij = cd[None, :] - anchor[r0:r1, None]      # cd_j - anchor_i
            sg = safe_gap[r0:r1]
            lo = torch.full_like(sg, -lrange)
            hi = torch.zeros_like(sg)
            for _ in range(80):
                mid = 0.5 * (lo + hi)
                off = sgn * sg * torch.exp(mid)
                den = dij - off[:, None]                 # cd_j - lambda_i
                safe = torch.where(den == 0, torch.ones_like(den), den)
                terms = torch.where(den == 0, torch.zeros_like(safe),
                                    cz2[None, :] / safe)
                fm = 1.0 + rho * terms.sum(dim=1)
                go_hi = (fm < 0) != flip
                lo, hi = torch.where(go_hi, mid, lo), torch.where(go_hi, hi,
                                                                 mid)
            out[r0:r1] = sgn * sg * torch.exp(0.5 * (lo + hi))
        return out

    # lower-anchored: f increases with off > 0; upper-anchored: off < 0
    # and f decreases as t grows (off -> -gap), hence the flipped branch
    mu = bisect(cd, 1.0, False)
    nu = bisect(ub, -1.0, True)
    # the last root has no upper pole (d_last + rho is not a singularity)
    use_up = (mu > 0.5 * gap) & ~last & (i_all < na)
    return torch.where(use_up, nu, mu), use_up


def _zhat(num, cd, cz, rho, na):
    """Gu-Eisenstat: |zhat_j|^2 = prod_i (lambda_i - cd_j) /
    (rho prod_{i != j} (cd_i - cd_j)) over the active set, in log space;
    ``num[i, j] = lambda_i - cd_j`` comes anchored from the caller."""
    n = cz.shape[0]
    i_all = torch.arange(n, device=cz.device)
    act_i = (i_all < na)[:, None]
    offdiag = i_all[:, None] != i_all[None, :]
    dij = cd[:, None] - cd[None, :]                      # cd_i - cd_j
    _, tiny, log_max = _limits(cz.dtype)

    def logprod(terms, mask):
        t = torch.where(mask, terms, torch.ones_like(terms))
        return torch.log(t.abs() + tiny).sum(dim=0)

    lnum = logprod(num, act_i)
    lden = logprod(dij, act_i & offdiag)
    ratio = torch.exp(torch.clamp(lnum - lden - torch.log(rho), -log_max,
                                  log_max))
    zh = torch.sqrt(torch.clamp(ratio, min=0.0))
    return torch.where(i_all < na, torch.where(cz < 0, -zh, zh),
                       torch.zeros_like(zh))


def _chain_waves(rot):
    """The rotating steps of a Givens chain in waves: wave t holds the t-th
    step of every run of consecutive rotating steps (``rot`` [n] bool,
    rot[0] False).  Returns a list of index tensors, one host read."""
    n = rot.shape[0]
    idx = torch.arange(n, device=rot.device)
    start = torch.cummax(torch.where(rot, 0, idx), dim=0).values
    pos = torch.where(rot, idx - start - 1, -1)
    waves = int(pos.max()) + 1 if n else 0
    return [torch.nonzero(pos == t).flatten() for t in range(waves)]


def _on_group(grid) -> bool:
    return grid is not None and getattr(grid, "group", None) is not None


def _merge_gemm(Q0, ut, grid):
    """The merge product Qm = Q0 @ ut, row-distributed on a grid with a
    process group (ref: stedc.py:155, stedc_merge.cc's Z block rows): rank
    i forms rows [i b, (i+1) b) of Qm, b = ceil(n / p q) (an uneven split:
    the last blocks may be short or empty, padded to b for the
    all-gather), and one all-gather over the grid returns the whole Qm to
    every rank.  Every rank takes the same route.  Other grids: one
    product."""
    if not _on_group(grid):
        return Q0 @ ut
    from ..comm.collectives import allgather_grid
    n = Q0.shape[0]
    b = -(-n // grid.size)
    lo = min(grid.rank * b, n)
    hi = min(lo + b, n)
    blk = torch.zeros((b, ut.shape[1]), dtype=Q0.dtype, device=Q0.device)
    blk[:hi - lo] = Q0[lo:hi] @ ut
    return torch.cat(allgather_grid(blk, grid))[:n]


def _merge(d1, Q1, d2, Q2, rho, grid=None):
    """Eigendecomposition of [[T1, rho e e^T], [rho e e^T, T2]] from the
    halves' decompositions (ref: stedc_merge.cc).  Returns (lam, Qm, ok),
    ``ok`` a 0-d bool tensor: the deflation-mask NaN guard and the
    secular-root sanity check.  ``grid``: see :func:`_merge_gemm`."""
    dt, dev = d1.dtype, d1.device
    n1 = d1.shape[0]
    d = torch.cat([d1, d2])
    n = d.shape[0]
    z = torch.cat([Q1[-1, :], Q2[0, :]])
    # a NaN z compares False against tol and would stay active: flag it
    defl_ok = torch.isfinite(d).all() & torch.isfinite(z).all()
    # mirror to rho > 0: eig(D + rho z z^T) = -eig(-D + (-rho) z z^T)
    sgn = torch.where(rho >= 0, torch.ones((), dtype=dt, device=dev),
                      -torch.ones((), dtype=dt, device=dev))
    dm = sgn * d
    rho_m = sgn * rho
    znorm2 = (z * z).sum()
    rho_eff = rho_m * znorm2
    zn = z / torch.sqrt(torch.clamp(znorm2, min=_limits(dt)[1]))

    order = torch.argsort(dm, stable=True)
    ds = dm[order]
    zs = zn[order]
    amax = torch.maximum(ds.abs().max(), rho_eff.abs())
    tol = 8.0 * _eps(dt) * amax                # relative: no abs floor

    # z deflation (ref: stedc_deflate z test)
    zdef = (rho_eff * zs).abs() <= tol
    zs = torch.where(zdef, torch.zeros_like(zs), zs)
    # actives first (stable: d stays ascending in each group)
    act1 = zs != 0
    pi1 = torch.argsort(torch.where(act1, 0, 1), stable=True)
    cd = ds[pi1]
    cz = zs[pi1].clone()

    # close-d deflation: the Givens chain over adjacent active pairs
    close = torch.zeros(n, dtype=torch.bool, device=dev)
    close[1:] = (cd[1:] - cd[:-1]) <= tol
    close[1:] &= (cz[:-1] != 0) & (cz[1:] != 0)
    cs = torch.zeros((n, 2), dtype=dt, device=dev)
    cs[:, 0] = 1.0
    waves = _chain_waves(close)
    for i in waves:
        zp, zi = cz[i - 1], cz[i]
        r = torch.sqrt(zp * zp + zi * zi)
        rs = torch.where(r == 0, torch.ones_like(r), r)
        cz[i - 1] = 0.0
        cz[i] = r
        cs[i, 0] = zi / rs                     # G^T [zp, zi] = [0, r]
        cs[i, 1] = zp / rs

    # actives first again: the chain zeroed some z's
    act = cz != 0
    pi2 = torch.argsort(torch.where(act, 0, 1), stable=True)
    cd = cd[pi2]
    cz = cz[pi2]
    na = act.sum()

    delta, use_up = _secular_roots(cd, cz * cz, rho_eff, na)
    delta = _faults.maybe_corrupt("post_secular", delta)
    i_all = torch.arange(n, device=dev)
    live = i_all < na
    # every active root offset finite and inside the merged spectrum's span
    width = (cd.max() - cd.min()) + rho_eff.abs()
    sec_ok = torch.where(live, torch.isfinite(delta)
                         & (delta.abs() <= width + tol), True).all()
    # anchored lambda_i - cd_j = (cd_anchor_i - cd_j) + delta_i
    anchor = torch.clamp(i_all + use_up.to(i_all.dtype), 0, n - 1)
    anchor_d = cd[anchor]
    num = (anchor_d[:, None] - cd[None, :]) + delta[:, None]
    zh = _zhat(num, cd, cz, rho_eff, na)

    # eigenvectors of the compacted rank-one problem, rows i = eigvec i
    den = -num                                  # cd_j - lambda_i
    del num
    u = zh[None, :] / torch.where(den == 0, torch.ones_like(den), den)
    del den
    u = torch.where(live[None, :], u, torch.zeros_like(u))
    nrm = torch.sqrt((u * u).sum(dim=1, keepdim=True))
    u = u / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    eye = torch.eye(n, dtype=dt, device=dev)
    u = torch.where(live[:, None], u, eye)      # deflated slots: unit vectors
    lam_c = torch.where(live, anchor_d + delta, cd)

    # Q0: the halves' vectors, permuted, rotated by the chain, permuted
    Q0 = torch.zeros((n, n), dtype=dt, device=dev)
    Q0[:n1, :n1] = Q1
    Q0[n1:, n1:] = Q2
    Q0 = Q0[:, order[pi1]]
    for i in waves:
        c, s = cs[i, 0], cs[i, 1]
        qp, qi = Q0[:, i - 1], Q0[:, i]
        Q0[:, i - 1] = c * qp - s * qi
        Q0[:, i] = s * qp + c * qi
    Q0 = Q0[:, pi2]

    Qm = _merge_gemm(Q0, u.T, grid)             # columns = eigenvectors
    lam = sgn * lam_c
    fin = torch.argsort(lam, stable=True)
    return lam[fin], Qm[:, fin], defl_ok & sec_ok


def _tear(d, e, off, leaves):
    """Walk the static halving, collecting each leaf (offset, d, e) with
    the rank-one tears applied to its ends."""
    n = d.shape[0]
    if n <= LEAF:
        leaves.append((off, d, e))
        return
    m = n // 2
    rho = e[m - 1]
    d1 = d[:m].clone()
    d1[m - 1] = d1[m - 1] + (-rho)
    d2 = d[m:].clone()
    d2[0] = d2[0] + (-rho)
    _tear(d1, e[:m - 1], off, leaves)
    _tear(d2, e[m:], off + m, leaves)


def _leaf_eigh(leaves):
    """The library's eigh of every leaf tridiagonal, one batched call for
    each leaf size.  Returns {offset: (w, Q)}."""
    by_size = {}
    for off, d, e in leaves:
        by_size.setdefault(d.shape[0], []).append((off, d, e))
    out = {}
    for s, group in by_size.items():
        dd = torch.stack([d for _, d, _ in group])
        T = torch.diag_embed(dd)
        if s > 1:
            ee = torch.stack([e for _, _, e in group])
            T = T + torch.diag_embed(ee, 1) + torch.diag_embed(ee, -1)
        w, Q = _library_call(torch.linalg.eigh, T, hermitian=True)
        for k, (off, _, _) in enumerate(group):
            out[off] = (w[k], Q[k])
    return out


def _stedc_rec(d, e, off, leaf_eigs, grid=None):
    n = d.shape[0]
    if n <= LEAF:
        w, Q = leaf_eigs[off]
        return w, Q, torch.ones((), dtype=torch.bool, device=d.device)
    m = n // 2
    rho = e[m - 1]
    w1, Q1, ok1 = _stedc_rec(d[:m], e[:m - 1], off, leaf_eigs, grid)
    w2, Q2, ok2 = _stedc_rec(d[m:], e[m:], off + m, leaf_eigs, grid)
    lam, Qm, okm = _merge(w1, Q1, w2, Q2, rho, grid)
    return lam, Qm, ok1 & ok2 & okm


def _stedc_device(d, e, grid=None):
    """The recursion on the device: (w, Z, ok), ``ok`` a 0-d bool tensor
    (every merge's secular and deflation flags), no host read; the merge
    products row-distributed over ``grid`` when it carries a process
    group."""
    leaves = []
    _tear(d, e, 0, leaves)
    with _full_precision():
        return _stedc_rec(d, e, 0, _leaf_eigh(leaves), grid)


def stedc_info(d, e, grid=None, certify: bool = True, *, device=None):
    """stedc's body: ``((w, Z), HealthInfo)``, no policy resolution.

    The health merges every merge's flags (secular sanity, the deflation
    NaN guard) into ``converged`` and, with ``certify``, the eigen-
    certificate of (w, Z) against T itself (``certify.certify_eig``), read
    from the device in one copy.  ``d`` and ``e`` stay where they are when
    they are tensors; host data goes to ``device`` (None: the device of a
    grid with a process group, else CUDA).  On a grid with a group the
    merge products are row-distributed (:func:`_merge_gemm`) and the
    health is folded over the grid, so every rank reads the same."""
    if _on_group(grid):
        device = grid_device(grid, device)
    d = d if isinstance(d, torch.Tensor) else as_tensor(np.asarray(d),
                                                        device)
    e = e if isinstance(e, torch.Tensor) else as_tensor(np.asarray(e),
                                                        d.device)
    if d.shape[0] == 1:
        w, Z = d.clone(), torch.ones((1, 1), dtype=d.dtype, device=d.device)
        return (w, Z), _health.from_result(w)
    with span("slate.stedc/recurse"):
        w, Z, ok = _stedc_device(d, e, grid)
    hb = _health.batch_merge(
        _health.batch_healthy(1, d.device)._replace(converged=ok.reshape(1)),
        _health.batch_from_result(w[None]))
    if certify:
        with span("slate.stedc/certify"), _full_precision():
            T = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
            hb = _health.batch_merge(_certify.certify_eig(T, w, Z), hb)
    return (w, Z), _health.batch_fold(hb, grid).to_list()[0]


@annotate("slate.stedc")
def stedc(d, e, grid=None, opts: Options | None = None, *, device=None):
    """Eigendecomposition of the symmetric tridiagonal (d, e) by divide and
    conquer (ref: src/stedc.cc).  Returns (w, Z) ascending; under
    ``ErrorPolicy.Info``, ``(w, Z, HealthInfo)`` with the merges' flags in
    ``converged`` and the residual and orthogonality certificate.  Host
    arrays go to ``device`` (None: CUDA; "cpu" for the plain route)."""
    (w, Z), h = stedc_info(d, e, grid, device=device)
    return _health.finalize_flat(
        "stedc", (w, Z), h, opts,
        lambda hh: SlateNotConvergedError(
            f"stedc: secular solve / certification failed "
            f"({hh.describe()})", iters=int(hh.iters)))
