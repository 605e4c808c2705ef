"""The port's out-of-core layer against slate_tpu's, on the CPU: the
TileMap (residency, round trip, prefetch/fetch/store/drain, the forced
drain, permute_rows), the four panel steps (``ooc_chol_update``,
``ooc_chol_panel``, ``ooc_lu_panel``, ``ooc_lu_trailing``) against the
reference's jitted ones, and ``potrf_ooc``/``getrf_ooc`` against the
reference's drivers on the same numpy inputs.

Tolerances: 1e-12 in f64 and 1e-5 in f32, relative to the largest
magnitude; the LU permutation is equal on Gaussian inputs.  The
reference's drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so a fixture restores it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import slate_tpu as ref
from slate_tpu.core.storage import TileMap as RefTileMap
from slate_tpu.internal import getrf as ref_getrf
from slate_tpu.internal import potrf as ref_potrf
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch.core import storage
from slate_tpu_torch.internal import getrf as port_getrf
from slate_tpu_torch.internal import potrf as port_potrf
from slate_tpu_torch.robust import faults

TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True)
def _ref_drivers(tmp_path, monkeypatch):
    monkeypatch.setenv("SLATE_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _close(got, want, tol):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


def _spd(seed, n, dtype):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(dtype)


def _gauss(seed, m, n, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


# ------------------------------------------------------------- TileMap


def _drive(tm, to_dev):
    """The same protocol on either package's TileMap: prefetch, fetch (hit
    and miss), store, a conflicting fetch, permute_rows; residency read
    after each step."""
    seen = []
    tm.prefetch(0, 24, 8, 16)
    seen.append(tm.residency_counts())
    hit = np.asarray(tm.fetch(0, 24, 8, 16))
    miss = np.asarray(tm.fetch(8, 24, 0, 8))
    seen.append((tm.residency(0, 1), tm.residency(1, 0)))
    tm.store(8, 24, 0, 8, to_dev(miss * 3.0))
    seen.append((tm.residency(1, 0), tm.residency(0, 0)))
    again = np.asarray(tm.fetch(0, 24, 0, 8))     # overlaps: drains first
    seen.append(tm.residency_counts())
    odd = np.asarray(tm.fetch(4, 20, 4, 13))      # parts of two tile columns
    tm.store(4, 20, 4, 13, to_dev(odd - 1.0))
    seen.append(tm.residency_counts())
    tm.permute_rows(8, 0, 16, np.r_[3, 0, 1, 2, 4:16])
    return seen, hit, miss, again, odd, tm.to_dense()


def test_tilemap_protocol_matches_the_reference():
    a = _gauss(1, 24, 20)
    got = _drive(st.TileMap(a, 8, 8, device="cpu"), torch.from_numpy)
    want = _drive(RefTileMap(a, 8, 8), jnp.asarray)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w)
    assert not np.array_equal(got[-1], a)


def test_tilemap_round_trip_and_forced_drain():
    a = _gauss(2, 32, 32)
    storage.reset_traffic()
    tm = st.TileMap(a, 8, 8, max_pending=2, device="cpu")
    for j in range(3):
        tm.store(0, 32, 8 * j, 8 * j + 8,
                 tm.fetch(0, 32, 8 * j, 8 * j + 8) + 1.0)
        # depth 3 > max_pending 2 forces the drain at the third store
        want_dirty = 0 if j == 2 else 4 * (j + 1)
        assert tm.residency_counts()["dirty"] == want_dirty
    expect = a.copy()
    expect[:, :24] += 1.0
    np.testing.assert_array_equal(tm.to_dense(), expect)
    assert tm.residency_counts() == {"host": 16, "device": 0, "dirty": 0}
    assert storage.TRAFFIC["h2d"] == storage.TRAFFIC["d2h"] == 3 * 32 * 8 * 8
    with pytest.raises(st.SlateValueError):
        tm.store(0, 8, 0, 8, torch.zeros(4, 8, dtype=torch.float64))


def test_tilemap_staged_copy_is_stale_after_a_store():
    """A staged clean copy overlapping a later store is dropped, so the
    next fetch sees the stored bytes (the reference's rule)."""
    a = _gauss(3, 16, 16)
    tm = st.TileMap(a, 8, 8, device="cpu")
    tm.prefetch(0, 16, 0, 8)
    tm.store(0, 16, 0, 8, torch.zeros(16, 8, dtype=torch.float64))
    assert tm.residency(0, 0) == "dirty"
    assert not tm.fetch(0, 16, 0, 8).any()


def test_tilemap_permute_rows_touches_only_moved_rows():
    a = _gauss(4, 20, 12)
    perm = np.arange(14)
    perm[[0, 5, 9]] = [9, 0, 5]
    tm = st.TileMap(a, 4, 4, device="cpu")
    tm.permute_rows(6, 0, 8, perm)
    expect = a.copy()
    expect[6:, :8] = a[6:, :8][perm]
    np.testing.assert_array_equal(tm.to_dense(), expect)
    with pytest.raises(st.SlateValueError):
        tm.permute_rows(6, 0, 8, perm[:-1])


def test_tilemap_on_the_default_device_raises_without_a_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.TileMap(np.eye(4), 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.potrf_ooc(np.eye(4), nb=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.getrf_ooc(np.eye(4), nb=2)


def test_tilemap_traffic_counters():
    storage.reset_traffic()
    st.getrf_ooc(_gauss(5, 24, 24), nb=8, device="cpu")
    # step k fetches and stores its panel and trailing columns, rows k0:
    cols = [(24 - k0) * (24 - k0) for k0 in (0, 8, 16)]
    assert storage.TRAFFIC["h2d"] == storage.TRAFFIC["d2h"] == 8 * sum(cols)


# ------------------------------------------------------------ panel steps


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ooc_chol_steps_match_the_reference(dtype):
    spd = _spd(6, 40, dtype)
    acc, left = spd[8:, 8:16], _gauss(7, 32, 8, dtype)
    upd_ref = np.asarray(ref_potrf.ooc_chol_update(
        jnp.asarray(acc), jnp.asarray(left), jnp.asarray(left[:8])))
    upd = port_potrf.ooc_chol_update(torch.from_numpy(acc),
                                     torch.from_numpy(left),
                                     torch.from_numpy(left[:8]))
    _close(upd, upd_ref, TOL[dtype])
    for w in (8, 32):           # K1's plain version on the f32 32 tile
        panel = spd[:, :w] if w == 32 else spd[:, 8:16][8:]
        want = np.asarray(ref_potrf.ooc_chol_panel(jnp.asarray(panel)))
        _close(port_potrf.ooc_chol_panel(torch.from_numpy(panel)), want,
               TOL[dtype] * 10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("W,w", [(40, 8), (24, 7), (16, 16)])
def test_ooc_lu_steps_match_the_reference(dtype, W, w):
    panel, colj = _gauss(8 + W, W, w, dtype), _gauss(9 + W, W, 5, dtype)
    lu_ref, perm_ref = ref_getrf.ooc_lu_panel(jnp.asarray(panel))
    lu, perm = port_getrf.ooc_lu_panel(torch.from_numpy(panel))
    assert np.array_equal(perm.numpy(), np.asarray(perm_ref))
    _close(lu, np.asarray(lu_ref), TOL[dtype])
    want = ref_getrf.ooc_lu_trailing(jnp.asarray(colj), lu_ref, perm_ref)
    got = port_getrf.ooc_lu_trailing(torch.from_numpy(colj), lu, perm)
    _close(got, np.asarray(want), TOL[dtype] * 10)


# ------------------------------------------------------------ the drivers


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,nb", [(64, 32), (40, 16), (96, 32)])
def test_potrf_ooc_matches_the_reference(dtype, n, nb):
    spd = _spd(10 + n, n, dtype)
    want = ref.potrf_ooc(spd, nb=nb)
    got = st.potrf_ooc(spd, nb=nb, device="cpu")
    _close(got, want, TOL[dtype])
    assert np.array_equal(got, np.tril(got))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,nb", [(64, 64, 16), (48, 30, 8), (30, 48, 8),
                                    (45, 45, 13)])
def test_getrf_ooc_matches_the_reference(dtype, m, n, nb):
    a = _gauss(20 + m + n, m, n, dtype)
    want = ref.getrf_ooc(a, nb=nb)
    got = st.getrf_ooc(a, nb=nb, device="cpu")
    assert np.array_equal(got.perm, np.asarray(want.perm))
    _close(got.LU, np.asarray(want.LU), TOL[dtype] * 10)


def test_ooc_default_width_is_the_tuned_seam():
    """Without ``nb`` both drivers take ``ooc_panel_width`` (256 untuned,
    clamped to n), as the reference does."""
    a = _gauss(30, 40, 40)
    F = st.getrf_ooc(a, device="cpu")
    assert np.array_equal(F.perm, np.asarray(ref.getrf_ooc(a).perm))
    spd = _spd(31, 40, np.float64)
    _close(st.potrf_ooc(spd, device="cpu"), ref.potrf_ooc(spd), 1e-12)


def _first_failing_minor(a):
    for k in range(1, len(a) + 1):
        try:
            np.linalg.cholesky(a[:k, :k])
        except np.linalg.LinAlgError:
            return k
    return 0


@pytest.mark.parametrize("policy", ["Info", "Raise", "Nan"])
def test_ooc_error_policies_match_the_reference(policy):
    spd = _spd(32, 24, np.float64)
    bad = spd.copy()
    bad[10, 10] = -1e3
    sing = _gauss(33, 24, 24)
    sing[:, 9] = 0.0
    for drv, x, exc in ((("potrf_ooc"), bad,
                         st.SlateNotPositiveDefiniteError),
                        ("getrf_ooc", sing, st.SlateSingularError)):
        ropts = {ref.Option.ErrorPolicy: getattr(ref.ErrorPolicy, policy)}
        popts = {st.Option.ErrorPolicy: getattr(st.ErrorPolicy, policy)}
        if policy == "Raise":
            with pytest.raises(exc):
                getattr(st, drv)(x, nb=8, opts=popts, device="cpu")
            continue
        got = getattr(st, drv)(x, nb=8, opts=popts, device="cpu")
        want = getattr(ref, drv)(x, nb=8, opts=ropts)
        if policy == "Info":
            (got, h), (want, hr) = got, want
            assert not h.ok and not bool(hr.ok)
            if drv == "getrf_ooc":
                assert h.info == int(hr.info) == 10
            else:
                # the port's tile factor stops at the first failing minor
                # (11); the reference's XLA route NaN-fills the whole
                # failed tile and reports its first row (9)
                assert (h.info, int(hr.info)) == (11, 9)
                assert _first_failing_minor(bad) == 11
        lu = got if drv == "potrf_ooc" else got.LU
        assert np.isnan(lu).all() == (policy == "Nan")


def test_ooc_copy_stall_matches_the_reference_bit_for_bit():
    a = _gauss(34, 32, 32)
    base = st.getrf_ooc(a, nb=8, device="cpu")
    plan = dict(site="ooc_copy_stall", delay_s=0.002)
    with faults.inject(faults.FaultPlan(**plan)):
        stalled = st.getrf_ooc(a, nb=8, device="cpu")
    with ref_faults.inject(ref_faults.FaultPlan(**plan)):
        want = ref.getrf_ooc(a, nb=8)
    assert np.array_equal(stalled.LU, base.LU)
    assert np.array_equal(stalled.perm, np.asarray(want.perm))
