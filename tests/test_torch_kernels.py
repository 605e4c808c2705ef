"""The port's kernels K0-K2 against the reference's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held against ``slate_tpu``'s Pallas kernels run as the reference's own tests
run them (``interpret=True``), on the same numpy inputs.  The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from slate_tpu.internal import trsm as ref_trsm
from slate_tpu.internal.pallas_chol import chol_panel_fused as ref_panel
from slate_tpu.internal.pallas_chol import chol_tile_pallas
from slate_tpu.internal.pallas_tri import upper_tri_inv as ref_tri_inv

from slate_tpu_torch.internal import chol_kernels as ck
from slate_tpu_torch.internal import potrf as ip
from slate_tpu_torch.internal import trsm as it
from slate_tpu_torch.internal.tri_inv import (TRI_INV,
                                              back_substitution_plain,
                                              upper_tri_inv)
from slate_tpu_torch.tune.plans import (LIBRARY_PLAN, TilePlan,
                                        plan_override, resolve_plan)


def _spd(rng, n, dtype=np.float32):
    g = rng.standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(dtype)


def _spd_panel(rng, m, nb, k):
    """(col, left, lead) with an SPD top block in col - left @ lead (the
    construction of tests/test_pallas.py)."""
    base = rng.standard_normal((m, nb)).astype(np.float32)
    top = base[:nb] @ base[:nb].T / nb + nb * np.eye(nb, dtype=np.float32)
    target = np.concatenate([top, base[nb:]], axis=0)
    left = rng.standard_normal((m, k)).astype(np.float32) * 0.01
    lead = left[:nb].T.copy()
    return target + left @ lead, left, lead


# f32 tolerances: the plain versions repeat the reference's arithmetic, so
# the two sides differ only in the order of f32 sums (XLA's dots vs torch's
# matmuls): ~n eps relative on these well-conditioned inputs (cond <= ~5).
RTOL, ATOL = 2e-5, 2e-5


@pytest.mark.parametrize("n", [8, 32, 128])
def test_upper_tri_inv_plain_matches_pallas_helper(n):
    u = np.linalg.cholesky(_spd(np.random.default_rng(n), n)).T.copy()
    u[np.tril_indices(n, -1)] = 7.0      # below the diagonal is ignored
    got = upper_tri_inv(torch.from_numpy(u))
    want = np.asarray(ref_tri_inv(jnp.asarray(u)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy() @ np.triu(u), np.eye(n),
                               atol=1e-5)


@pytest.mark.parametrize("n", [5, 24, 96, 100])
def test_upper_tri_inv_doubling_at_ragged_sizes(n):
    """K0's blocked doubling where n is no power of two (a short last
    pair) or no multiple of its 8 x 8 diagonal blocks: against the
    reference's helper and against back substitution."""
    u = np.linalg.cholesky(_spd(np.random.default_rng(n), n)).T.copy()
    got = upper_tri_inv(torch.from_numpy(u))
    want = np.asarray(ref_tri_inv(jnp.asarray(u)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), back_substitution_plain(torch.from_numpy(u)).numpy(),
        rtol=RTOL, atol=ATOL)
    assert np.all(np.tril(got.numpy(), -1) == 0)
    assert TRI_INV.launches == 0


@pytest.mark.parametrize("bw", [8, 16, 32])
@pytest.mark.parametrize("n", [32, 64, 96, 128])
def test_chol_tile_plain_matches_pallas(n, bw):
    """K1's plain version (the reference's bw slabs; the CUDA kernel's own
    32-column blocks are held against it on the card) at every tile size
    and slab width the kernel takes, RTOL/ATOL 2e-5 (f32 sums in another
    order, cond <= ~5)."""
    a = _spd(np.random.default_rng(5), n)
    got = ck.chol_tile(torch.from_numpy(a), bw=bw).numpy()
    want = np.asarray(chol_tile_pallas(jnp.asarray(a), bw=bw,
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(np.triu(got, 1) == 0)          # exact-zero upper contract


@pytest.mark.parametrize("n,bw,bad", [(64, 8, 37), (128, 32, 90)])
def test_chol_tile_plain_first_bad_pivot_matches_pallas(n, bw, bad):
    """An indefinite tile whose pivot at column ``bad`` is ~ -6: the plain
    version's first non-finite or non-positive diagonal entry (the health
    read's info) is ``bad``, as the reference's is, every later one is
    non-finite in both, and the columns before it agree within RTOL/ATOL
    2e-5."""
    a = _spd(np.random.default_rng(bad), n)
    a[bad, bad] -= 8.0              # diagonal ~2, pivot^2 <= a[bad, bad]
    got = ck.chol_tile(torch.from_numpy(a), bw=bw).numpy()
    want = np.asarray(chol_tile_pallas(jnp.asarray(a), bw=bw,
                                       interpret=True))

    def first_bad(l):
        d = np.diag(l)
        return int(np.flatnonzero(~(np.isfinite(d) & (d > 0)))[0])
    assert first_bad(got) == first_bad(want) == bad
    assert not np.isfinite(np.diag(got)[bad + 1:]).any()
    assert not np.isfinite(np.diag(want)[bad + 1:]).any()
    np.testing.assert_allclose(got[:bad, :bad], want[:bad, :bad], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k", [0, 128, 100])
def test_chol_panel_plain_matches_pallas(k):
    """M = 256, nb = 128; K = 100 is the ragged K the Pallas version pads
    with zeros and the CUDA kernel masks."""
    m, nb = 256, 128
    col, left, lead = _spd_panel(np.random.default_rng(k), m, nb, k)
    upd, fac = ck.chol_panel_fused(torch.from_numpy(col),
                                   torch.from_numpy(left),
                                   torch.from_numpy(lead), bw=8)
    rupd, rfac = ref_panel(jnp.asarray(col), jnp.asarray(left),
                           jnp.asarray(lead), bw=8, interpret=True)
    # upd entries are O(nb) on the diagonal: absolute error ~ nb eps
    np.testing.assert_allclose(upd.numpy(), np.asarray(rupd), rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_allclose(fac.numpy(), np.asarray(rfac), rtol=RTOL,
                               atol=ATOL)


def test_wrappers_check_shapes_and_take_plain_on_cpu():
    rng = np.random.default_rng(6)
    col, left, lead = (torch.from_numpy(x) for x in _spd_panel(rng, 256, 64,
                                                               32))
    for got, want in zip(ck.chol_panel_fused(col, left, lead, 8),
                         ck.chol_panel_plain(col, left, lead, 8)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ck.chol_panel_fused(col[:200], left[:200], lead, 8)   # M % nb
    with pytest.raises(ValueError):
        ck.chol_panel_fused(col, left, lead, 7)               # nb % bw
    with pytest.raises(ValueError):
        ck.chol_tile(col[:64, :60], 8)                        # not square
    assert ck.CHOL_PANEL.launches == 0 and ck.CHOL_TILE.launches == 0
    assert TRI_INV.launches == 0


def test_potrf_gates_carry_hopper_limits():
    f32, f64 = torch.float32, torch.float64
    assert ip.potrf_panel_ok(f32, 384, 128, 128)
    assert not ip.potrf_panel_ok(f32, 384, 256, 256)     # > 227 KB / block
    assert not ip.potrf_panel_ok(f32, 384, 100, 128)     # ragged last panel
    assert not ip.potrf_panel_ok(f64, 384, 128, 128)
    assert ip._tile_plan_ok(f32, 128) and not ip._tile_plan_ok(f32, 256)
    with plan_override("potrf_panel", LIBRARY_PLAN):
        assert not ip.potrf_panel_ok(f32, 384, 128, 128)
        assert ip._tile_plan_ok(f32, 128)
    with plan_override("potrf_tile", TilePlan("cuda", 48)):
        assert not ip._tile_plan_ok(f32, 128)            # 128 % 48
    assert resolve_plan("potrf_tile", 128, "float64") == LIBRARY_PLAN
    with pytest.raises(ValueError):
        with plan_override("potrf_tile", TilePlan("pallas", 8)):
            pass


def test_potrf_tile_library_route_nan_fills_a_failed_factor():
    """f64 goes to torch.linalg.cholesky_ex; a failed factor is NaN from
    the first failing minor's column on (its columns before are the
    leading minor's factor), so the first bad diagonal is the one K1's
    loop finds.  (The reference's XLA route NaN-fills the tile whole.)"""
    a = _spd(np.random.default_rng(7), 64, np.float64)
    L = ip.potrf_tile(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(a), rtol=1e-12,
                               atol=1e-12)
    a[10, 10] = -5.0
    L = ip.potrf_tile(torch.from_numpy(a)).numpy()
    assert np.isnan(L[:, 10:]).all() and not np.isnan(L[:, :10]).any()
    np.testing.assert_allclose(L[:10, :10], np.linalg.cholesky(a[:10, :10]),
                               rtol=1e-12, atol=1e-12)
    batch = torch.from_numpy(np.stack([a, _spd(np.random.default_rng(8), 64,
                                                np.float64)]))
    Lb = ip.potrf_tile(batch).numpy()
    assert np.isnan(Lb[0, :, 10:]).all() and not np.isnan(Lb[1]).any()


@pytest.mark.parametrize("n,unit", [(32, False), (100, False), (256, True)])
def test_tri_inv_lower_matches_reference(n, unit):
    lo = np.tril(np.random.default_rng(n).standard_normal((n, n))) \
        + 4 * np.eye(n)
    got = it.tri_inv_lower(torch.from_numpy(lo), unit_diag=unit).numpy()
    want = np.asarray(ref_trsm.tri_inv_lower(jnp.asarray(lo),
                                             unit_diag=unit))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    up = it.tri_inv_upper(torch.from_numpy(lo.T.copy())).numpy()
    np.testing.assert_allclose(up, np.linalg.inv(lo.T), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("lower,trans,conj,n", [
    (True, False, False, 256), (True, True, True, 200),
    (False, False, False, 230), (False, True, False, 256)])
def test_trsm_blocked_matches_reference(lower, trans, conj, n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
         + 8 * np.eye(n))
    b = rng.standard_normal((n, 5)) + 1j * rng.standard_normal((n, 5))
    kw = dict(lower=lower, trans=trans, conj=conj, unit=False, nb=64)
    got = it.trsm_left_blocked(torch.from_numpy(a), torch.from_numpy(b),
                               **kw).numpy()
    want = np.asarray(ref_trsm.trsm_left_blocked(jnp.asarray(a),
                                                 jnp.asarray(b), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    got_r = it.trsm_right_blocked(torch.from_numpy(a),
                                  torch.from_numpy(b.T.copy()), **kw).numpy()
    want_r = np.asarray(ref_trsm.trsm_right_blocked(
        jnp.asarray(a), jnp.asarray(b.T.copy()), **kw))
    np.testing.assert_allclose(got_r, want_r, rtol=1e-10, atol=1e-12)
    # the checked solve (Option.Abft) finds nothing to repair in a clean
    # solve and returns the unchecked bits, as the reference's does
    for fn, rhs in ((it.trsm_left_blocked, b), (it.trsm_right_blocked,
                                                b.T.copy())):
        got_c = fn(torch.from_numpy(a), torch.from_numpy(rhs), check=True,
                   **kw)
        assert torch.equal(got_c, fn(torch.from_numpy(a),
                                     torch.from_numpy(rhs), **kw))
