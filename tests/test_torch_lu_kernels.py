"""The port's LU kernels K3 and K4, K0 on pivoted U, and the panel
factorizations of internal/getrf.py, against the reference on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held against ``slate_tpu``'s Pallas kernels run as the reference's own tests
run them (``interpret=True``) and against its XLA routes, on the same numpy
inputs.  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from slate_tpu.internal import getrf as ref_getrf
from slate_tpu.internal.pallas_lu import lu_panel_fused as ref_lu_panel
from slate_tpu.internal.pallas_lu import lu_select_pallas
from slate_tpu.internal.pallas_tri import upper_tri_inv as ref_tri_inv
from slate_tpu.tune import TilePlan as RefPlan
from slate_tpu.tune import plan_override as ref_override

from slate_tpu_torch.internal import getrf as ig
from slate_tpu_torch.internal import lu_kernels as lk
from slate_tpu_torch.internal.tri_inv import (TRI_INV,
                                              back_substitution_plain,
                                              upper_tri_inv)
from slate_tpu_torch.tune.plans import LIBRARY_PLAN, TilePlan, plan_override

NB = 128


def _gauss(seed, m, n=NB):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _calu_permuted(seed, m):
    """A Gaussian panel in the row order the reference's CALU tournament
    gives it: the panel the CALU final factor hands K3."""
    g = _gauss(seed, m)
    _, perm = ref_getrf.panel_lu_tournament(jnp.asarray(g), 128)
    return g[np.asarray(perm)]


@pytest.mark.parametrize("w,nrows", [(256, None), (1024, None), (256, 160)])
def test_k4_plain_selects_the_pallas_kernels_rows(w, nrows):
    """Exact indices: on tie-free rows the masked argmax of both versions
    and lax.linalg.lu's partial pivoting pick the same rows in order."""
    x = _gauss(w + (nrows or 0), w)
    got = lk.lu_select(torch.from_numpy(x)[None], nrows=nrows)[0].numpy()
    want = np.asarray(lu_select_pallas(
        jnp.asarray(x), None if nrows is None else jnp.int32(nrows), bw=8,
        interpret=True))
    np.testing.assert_array_equal(got, want)
    if nrows is None:
        _, _, perm = jax.lax.linalg.lu(jnp.asarray(x))
        np.testing.assert_array_equal(got, np.asarray(perm)[:NB])
    else:
        assert got.max() < nrows and len(set(got.tolist())) == NB


def test_k4_plain_breaks_a_tie_across_row_ranges_to_the_lower_row():
    """A 512-row chunk whose column 0 has its largest |v| twice, +10 in row
    3 and -10 in row 300: in different halves of the chunk, so on the card
    in different CTAs of a two-CTA cluster.  The plain version picks row 3
    first, as lu_select_pallas (interpret) and lax.linalg.lu do, and every
    later row as they do."""
    x = _gauss(11, 512)
    x[3, 0], x[300, 0] = 10.0, -10.0
    got = lk.lu_select(torch.from_numpy(x)[None])[0].numpy()
    want = np.asarray(lu_select_pallas(jnp.asarray(x), None, bw=8,
                                       interpret=True))
    assert got[0] == 3
    np.testing.assert_array_equal(got, want)
    _, _, perm = jax.lax.linalg.lu(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(perm)[:NB])


def test_k4_batch_is_each_chunk_alone():
    """One call takes a whole round [G, W, nb], with a live-row count per
    chunk; bw changes only the order of the updates, not the rows."""
    x = torch.from_numpy(np.stack([_gauss(s, 256) for s in (1, 2, 3)]))
    nrows = torch.tensor([256, 200, 130])
    got = lk.lu_select(x, nrows=nrows)
    assert got.shape == (3, NB) and got.dtype == torch.int64
    for g in range(3):
        assert torch.equal(got[g], lk.lu_select(x[g:g + 1], int(nrows[g]))[0])
    assert torch.equal(lk.lu_select(x, nrows=nrows, bw=16), got)
    with pytest.raises(ValueError, match="bw"):
        lk.lu_select(x, bw=48)
    assert lk.LU_SELECT.launches == 0


def test_k3_plain_matches_pallas_on_a_diagonally_dominant_panel():
    x = _gauss(4, 384)
    x[:NB] += NB * np.eye(NB, dtype=np.float32)
    got = lk.lu_panel_fused(torch.from_numpy(x), bw=8).numpy()
    want = np.asarray(ref_lu_panel(jnp.asarray(x), bw=8, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_k3_plain_matches_the_xla_route_on_a_pivoted_panel():
    """On the CALU final factor's kind of panel (U of a pivoted LU, cond
    ~100) the port's K3 plain version stays within 1e-4 of the reference's
    XLA no-pivot route: the same blocked arithmetic, with K0's back
    substitution where the reference's Pallas kernel uses the series."""
    x = _calu_permuted(5, 512)
    got = lk.lu_panel_fused(torch.from_numpy(x), bw=8).numpy()
    want, _ = ref_getrf.panel_lu_nopiv(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def _zero_pivot_tile(j, n=NB):
    """A tile whose pivot j is exactly 0 in f32: A = L U with small integer
    entries (L unit lower, U's other pivots +-1, U[j, j] = 0), plus integers
    in column j below the diagonal, so that every multiplier before column
    j is an exact integer, pivot j is 0 and the entries under it are not."""
    rng = np.random.default_rng(100 + j)
    lo = np.tril(rng.integers(-1, 2, (n, n)), -1) + np.eye(n)
    up = np.triu(rng.integers(-2, 3, (n, n)), 1) + np.diag(
        rng.choice([-1.0, 1.0], n))
    up[j, j] = 0
    a = lo @ up
    a[j + 1:, j] += rng.integers(-2, 3, n - j - 1)
    return a.astype(np.float32)


@pytest.mark.parametrize("j,bw", [(0, 4), (0, 8), (5, 4), (5, 8), (37, 4),
                                  (37, 8)])
def test_k3_plain_zero_pivot_health_matches_pallas(j, bw):
    """A planted exact-zero pivot at j: the reference divides by 1 inside
    its bw slab and leaves the rows below the slab Inf or NaN.  The plain
    tile and panel (a Gaussian block below the tile) give the health read
    the same info and nonfinite as lu_panel_fused (interpret), the finite
    entries of both agree within 1e-4 + 1e-4 |ref| (exact integers up to
    column j, then back substitution where the reference takes its
    series), and column j is finite in the pivot's slab and non-finite
    past it in both."""
    from slate_tpu.robust.health import from_pivots as ref_from_pivots
    from slate_tpu_torch.robust.health import from_pivots
    tile = _zero_pivot_tile(j)
    panel = np.concatenate([tile, _gauss(j, NB)])
    ref = np.asarray(ref_lu_panel(jnp.asarray(panel), bw=bw,
                                  interpret=True))
    want = ref_from_pivots(np.diag(ref[:NB]))
    slab_end = j - j % bw + bw
    for got in (lk.lu_tile_plain(torch.from_numpy(tile), bw).numpy(),
                lk.lu_panel_plain(torch.from_numpy(panel), bw).numpy()):
        h = from_pivots(torch.from_numpy(np.diag(got[:NB]).copy()))
        assert (h.info, h.nonfinite) == (int(want.info), bool(want.nonfinite))
        assert h.info == j + 1 and h.nonfinite
        both = np.isfinite(got) & np.isfinite(ref[:len(got)])
        np.testing.assert_allclose(got[both], ref[:len(got)][both],
                                   rtol=1e-4, atol=1e-4)
        for lu in (got, ref):
            assert np.isfinite(lu[j + 1:slab_end, j]).all()
            assert not np.isfinite(lu[slab_end:NB, j]).any()


def test_reference_fused_route_misses_on_a_pivoted_panel():
    """The reference's own K3 (interpret mode) is 1e-2 off its XLA route on
    the same panel: its nilpotent-series U^-1 is inaccurate on pivoted U.
    The reference's default plan is XLA, so its users never meet this;
    the port takes its kernels by default, hence K0's back substitution."""
    x = _calu_permuted(5, 512)
    fused = np.asarray(ref_lu_panel(jnp.asarray(x), bw=8, interpret=True))
    xla, _ = ref_getrf.panel_lu_nopiv(jnp.asarray(x))
    assert np.abs(fused - np.asarray(xla)).max() > 1e-3


def _inv_err(inv, u):
    want = np.linalg.inv(np.triu(u).astype(np.float64))
    return np.abs(inv - want).max() / np.abs(want).max()


@pytest.mark.parametrize("m", [512, 4096])
def test_k0_plain_inverts_a_pivoted_u_to_f64_accuracy(m):
    """K0's plain version (blocked doubling) on U = triu(LU) of a pivoted
    Gaussian panel: within 1e-5 of the f64 inverse, where the reference's
    series is off by more than ten times that."""
    lu, _, _ = jax.lax.linalg.lu(jnp.asarray(_gauss(m, m)))
    u = np.triu(np.asarray(lu)[:NB])
    assert _inv_err(upper_tri_inv(torch.from_numpy(u)).numpy(), u) < 1e-5
    assert _inv_err(np.asarray(ref_tri_inv(jnp.asarray(u))), u) > 1e-4
    assert TRI_INV.launches == 0


@pytest.mark.parametrize("n", [8, 40, 100, 128])
def test_back_substitution_plain_inverts_a_pivoted_u_to_f64_accuracy(n):
    """The back substitution of K3's plain slabs (lu_tile_plain), and K0's
    blocked doubling, on the leading n x n of a pivoted
    Gaussian panel's U: both within 1e-5 of the f64 inverse, and within
    ~n eps of each other."""
    lu, _, _ = jax.lax.linalg.lu(jnp.asarray(_gauss(3, 1024)))
    u = np.triu(np.asarray(lu)[:n, :n])
    back = back_substitution_plain(torch.from_numpy(u)).numpy()
    doubling = upper_tri_inv(torch.from_numpy(u)).numpy()
    assert _inv_err(back, u) < 1e-5
    assert _inv_err(doubling, u) < 1e-5
    assert np.abs(back - doubling).max() <= 1e-5 * np.abs(back).max()
    assert TRI_INV.launches == 0


@pytest.mark.parametrize("m,k", [(20, 8), (300, 128), (128, 128)])
def test_pivots_to_perm_replays_lapack_swaps(m, k):
    rng = np.random.default_rng(m + k)
    piv = np.array([rng.integers(i, m) for i in range(k)])
    piv[k // 2] = k // 2                          # a step that keeps its row
    want = np.arange(m)
    for i, p in enumerate(piv):
        want[[i, p]] = want[[p, i]]
    got = ig.pivots_to_perm(torch.from_numpy(piv), m)
    np.testing.assert_array_equal(got.numpy(), want)
    batch = ig.pivots_to_perm(torch.from_numpy(np.stack([piv, piv])), m)
    assert torch.equal(batch[1], got)


def test_panel_lu_matches_lax_lu():
    """perm exact; the factor within 1e-4 (two LAPACK-style eliminations of
    a [300, 128] Gaussian panel, |U| up to ~20, sums in another order)."""
    x = _gauss(6, 300)
    lu, perm = ig.panel_lu(torch.from_numpy(x))
    rlu, _, rperm = jax.lax.linalg.lu(jnp.asarray(x))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    np.testing.assert_allclose(lu.numpy(), np.asarray(rlu), rtol=0,
                               atol=1e-4)


def test_panel_lu_threshold_matches_reference():
    x = _gauss(7, 256, 64)
    lu, perm = ig.panel_lu_threshold(torch.from_numpy(x), 0.5)
    rlu, rperm = ref_getrf.panel_lu_threshold(jnp.asarray(x), 0.5)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    np.testing.assert_allclose(lu.numpy(), np.asarray(rlu), rtol=0,
                               atol=1e-4)
    assert not np.array_equal(perm.numpy(), np.arange(256))


def test_panel_lu_nopiv_library_route_matches_reference():
    x = _gauss(8, 384)
    x[:NB] += NB * np.eye(NB, dtype=np.float32)
    with plan_override("getrf_panel", LIBRARY_PLAN):
        lu, perm = ig.panel_lu_nopiv(torch.from_numpy(x))
    want, _ = ref_getrf.panel_lu_nopiv(jnp.asarray(x))
    np.testing.assert_allclose(lu.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(perm.numpy(), np.arange(384))


@pytest.mark.parametrize("w,block_rows,route", [
    (640, 256, "cuda"), (640, 256, "torch"), (300, 128, "cuda")])
def test_panel_lu_tournament_matches_reference(w, block_rows, route):
    """perm exact, lu within 1e-4, on an orthogonal panel (every column a
    real pivot choice); the port's rounds take K4 (plain) or the library,
    the reference's lax.linalg.lu.  W = 640 has a round 1 and a padded
    tree; W = 300 is ragged (sentinel pad rows)."""
    q = np.linalg.qr(np.random.default_rng(w).standard_normal((w, w)))[0]
    x = q[:, :NB].astype(np.float32) * np.sqrt(w)
    plan = LIBRARY_PLAN if route == "torch" else TilePlan()
    with plan_override("lu_select", plan):
        lu, perm = ig.panel_lu_tournament(torch.from_numpy(x), block_rows)
    rlu, rperm = ref_getrf.panel_lu_tournament(jnp.asarray(x), block_rows)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    np.testing.assert_allclose(lu.numpy(), np.asarray(rlu), rtol=0,
                               atol=1e-4)


def test_tournament_on_a_singular_panel_keeps_a_permutation():
    """Fewer nonzero rows than nb: every later column is a tie among zero
    rows.  Against the reference with its Pallas selection (interpret),
    which breaks ties as K4 does, perm is exact and a permutation."""
    x = np.zeros((384, NB), np.float32)
    x[200:260] = _gauss(9, 60)
    with ref_override("lu_select", RefPlan("pallas", NB, 8)):
        _, rperm = ref_getrf.panel_lu_tournament(jnp.asarray(x), 128)
    perm = ig.tournament_perm(torch.from_numpy(x), 128).numpy()
    np.testing.assert_array_equal(perm, rperm)
    np.testing.assert_array_equal(np.sort(perm), np.arange(384))


def test_gates_carry_hopper_limits():
    panel = torch.zeros((384, NB))
    assert ig._nopiv_fused_ok(panel)
    # K3's limits are the kernel's own (slate_lu_panel_fits, asked on the
    # card: nb <= 128 there, tests/test_torch_cuda.py); the plain version
    # that a CPU panel takes has none, and at nb = 256 the reference's gate
    # takes its fused panel too
    assert ig._nopiv_fused_ok(torch.zeros((512, 256)))
    assert not ig._nopiv_fused_ok(panel.double())
    assert not ig._nopiv_fused_ok(torch.zeros((64, NB)))   # W < nb
    with plan_override("getrf_panel", LIBRARY_PLAN):
        assert not ig._nopiv_fused_ok(panel)
    with plan_override("getrf_panel", TilePlan("cuda", 48)):
        assert not ig._nopiv_fused_ok(panel)               # 128 % 48
    # K4 takes rounds past the reference's W <= 4096 and W % 128 == 0; the
    # card's shared memory limits W there (tests/test_torch_cuda.py)
    blocks = torch.zeros((2, 4096, NB))
    assert ig._lu_select_ok(blocks, NB)
    assert ig._lu_select_ok(torch.zeros((2, 5120, NB)), NB)
    assert ig._lu_select_ok(torch.zeros((2, 300, NB)), NB)
    # past 128, the reference's wide widths: 256, 384, 512 (the kernel
    # walks them by 128-column blocks), and no width between or beyond
    assert ig._lu_select_ok(torch.zeros((2, 512, 256)), 256)
    assert ig._lu_select_ok(torch.zeros((2, 768, 384)), 384)
    assert ig._lu_select_ok(torch.zeros((2, 1024, 512)), 512)
    assert not ig._lu_select_ok(torch.zeros((2, 512, 200)), 200)
    assert not ig._lu_select_ok(torch.zeros((2, 1280, 640)), 640)
    assert not ig._lu_select_ok(blocks.double(), NB)
    with plan_override("lu_select", LIBRARY_PLAN):
        assert not ig._lu_select_ok(blocks, NB)
    with plan_override("lu_select", TilePlan("cuda", 48)):
        assert not ig._lu_select_ok(blocks, NB)      # 128 % 48
    with pytest.raises(ValueError):
        lk.lu_panel_fused(torch.zeros((200, NB)), 8)   # W % nb


@pytest.mark.parametrize("which", ["panel", "select"])
def test_stamped_trace_launches_refuse_the_cpu(which):
    """K3's and K4's stamped trace launches (lu_panel_stamps,
    lu_select_stamps, behind chip_smoke.py's split lines) run only on the
    card: a CPU tensor is refused before any library is loaded, and so is
    a width the wide routes do not take."""
    if which == "panel":
        with pytest.raises(ValueError, match="lu_panel_stamps"):
            lk.lu_panel_stamps(torch.zeros(512, 256))
        with pytest.raises(ValueError, match="lu_panel_stamps"):
            lk.lu_panel_stamps(torch.zeros(256, 128))
    else:
        with pytest.raises(ValueError, match="lu_select_stamps"):
            lk.lu_select_stamps(torch.zeros(2, 512, 256))
