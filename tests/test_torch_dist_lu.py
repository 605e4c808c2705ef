"""The port's distributed LU and mesh Aasen against slate_tpu's mesh
drivers, in gloo worlds of CPU processes: getrf (PartialPiv, CALU, NoPiv),
getrf_rbt on the tiles and through the dense transform, getrs with B in
other row tiles than the factor, gesv (every method, Speculate),
gesv_nopiv and getri; dist_getrf at lookahead depths 0, 1 and 2 with and
without ABFT; a planted post_panel strike on a mesh gesv under Abft;
hetrf and hesv (the row-distributed Aasen) and an indefinite posv that
its fallback ladder ends solved.

Each grid of ``torch_dist_cases.GRIDS`` (1 x 1 with a process group, 2 x
2, 2 x 4, 4 x 2) is one world of p*q spawned ranks that runs everything
once (``torch_dist_cases.lu_body``); the parametrised tests assert one
case each.  The reference runs once a module, on the 2 x 2 grid of the
8-device virtual mesh of tests/conftest.py (LU's factors on any grid
agree to rounding, its pivots exactly): the factors, getrs, the Aasen
factors and a planted strike's counters (dist_getrf under the plan; ref:
tests/test_abft.py:275-292).  The solves are held to numpy's (the
reference's mesh gesv is the getrf and getrs held here).  The
reference's mesh hetrf needs n to be a multiple of the device count
(its row sharding), hence n = 24; the port's row blocks take any n.
Depths 1 and 2 are held bit for bit against depth 0 on one input a
comparison (the reference's tests/test_lookahead.py:149-180 draws two).

Tolerances: 1e-4 relative in f32 (held to the reference's f64 result of
the same inputs), 1e-12 in f64 and complex128; PartialPiv and CALU
permutations exactly.  On the CPU the panels take K3's and K4's plain
versions.  The reference's ``@annotate``d drivers need
``jax.core.trace_state_clean``, which the installed JAX no longer
exports; the reference fixture restores it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest

import jax

import slate_tpu as ref
from slate_tpu.parallel.dist_lu import dist_getrf as ref_dist_getrf
from slate_tpu.robust import faults as ref_faults

import torch_dist_cases as cases
from torch_dist_worlds import start_worlds

GRIDS = cases.GRIDS
GRID_IDS = [f"{p}x{q}" for p, q in GRIDS]


def ref_grid(p, q):
    return ref.Grid(p, q, devices=jax.devices()[:p * q])


@pytest.fixture(scope="module")
def pending_worlds(tmp_path_factory):
    """The worlds, started before the reference computes (they overlap)."""
    return start_worlds(GRIDS, cases.lu_body,
                        lambda p, q: str(tmp_path_factory.mktemp(
                            f"lu_{p}x{q}")))


@pytest.fixture(scope="module")
def worlds(pending_worlds, reference):
    return pending_worlds.result()


@pytest.fixture(scope="module")
def reference(pending_worlds):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean",
                   jax._src.core.trace_state_clean, raising=False)
        g = ref_grid(2, 2)
        M = cases.matrix_maker(ref, g)
        o = {ref.Option.Target: ref.Target.mesh}
        out = {}
        for name, dt, call in cases.LU_CASES:
            key = (name, cases.ref_dtype(dt))
            if key not in out:
                res = call(ref, M, cases.lu_inputs(cases.ref_dtype(dt)), o)
                res = res if isinstance(res, tuple) else (res,)
                out[key] = tuple(cases._np(v) for v in res)
        a, _ = cases.strike_system()
        S = ref.Matrix.from_numpy(a, cases.STRIKE_NB, cases.STRIKE_NB,
                                  g).storage
        with ref_faults.inject(ref_faults.FaultPlan("post_panel",
                                                    **cases.LU_STRIKE)):
            res = ref_dist_getrf(S.data, S.Nt, g, S.n, "partial", abft=True,
                                 la=0)
        out["strike"] = tuple(int(v) for v in res[4:])
        for dt in ("float64", "complex128"):
            H = M(cases.lu_inputs(dt)["h24"], "herm", ref.Uplo.Lower)
            out[f"hetrf_{dt}"] = cases._he_factors(ref.hetrf(H, o))
        return out


def _close(got, want, dt):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=cases.TOL[dt],
                               atol=cases.TOL[dt] * scale)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("case", cases.LU_CASES,
                         ids=[cases.case_id(c) for c in cases.LU_CASES])
def test_lu_matches_reference(worlds, reference, case, grid):
    """The factor (L\\U; for getrf_rbt the transformed NoPiv factor) within
    tolerance of the reference's mesh driver, pads zero, and every
    permutation equal to the reference's."""
    name, dt, _ = case
    got = worlds[grid][0]["cases"][cases.case_id(case)]
    want = reference[(name, cases.ref_dtype(dt))]
    _close(got[0], want[0], dt)
    if len(got) > 1:
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("case", cases.LU_SOLVES,
                         ids=[cases.case_id(c) for c in cases.LU_SOLVES])
def test_lu_solves(worlds, case, grid):
    """gesv (each method), gesv_nopiv, gesv under Speculate (the RBT rung
    accepted, on the tiles and through the dense transform) and getri
    against numpy's solve and inverse."""
    name, dt, _ = case
    got = worlds[grid][0]["cases"][cases.case_id(case)]
    _close(got[0], cases.lu_solve_want(name, dt), dt)
    if name.startswith("gesv_speculate"):
        assert got[1:] == ("RBTFactors", True)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_every_rank_holds_the_same_results(worlds, grid):
    base = worlds[grid][0]
    for rank in worlds[grid][1:]:
        for key, val in base["cases"].items():
            for x, y in zip(rank["cases"][key], val):
                np.testing.assert_array_equal(x, y, err_msg=key)
        for key in ("hetrf_float64", "hesv_float64", "posv_indefinite"):
            for x, y in zip(rank[key], base[key]):
                np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_local_tiles_are_the_reference_cyclic_slice(worlds, grid):
    """Each rank's block of the mesh getrf's factor is bit for bit the
    reference's cyclic slice of the factor, its pad entries zero (ref:
    tests/test_lu.py:81-95)."""
    p, q = grid
    lu = worlds[grid][0]["cases"]["getrf_partial-float64"][0]
    cyc = np.asarray(ref.TileStorage.from_dense(lu, 5, 5,
                                                ref_grid(p, q)).data)
    mtl, ntl = cyc.shape[0] // p, cyc.shape[1] // q
    for rank in worlds[grid]:
        r, c = rank["coords"]
        np.testing.assert_array_equal(
            rank["local_getrf"], cyc[r * mtl:(r + 1) * mtl,
                                     c * ntl:(c + 1) * ntl])
    canon = np.asarray(ref.TileStorage.from_dense(lu, 5, 5).data)
    assert np.all(canon[-1, :, 2:, :] == 0) and np.all(canon[:, -1,
                                                             :, 2:] == 0)


@pytest.mark.parametrize("abft", [False, True])
@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("method", cases.LA_METHODS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_getrf_lookahead_depths_bit_identical(worlds, grid, method, dt,
                                              abft):
    """dist_getrf's local factor, permutation, health and counters at
    depths 1 and 2 bit for bit those of depth 0, on every rank; a clean
    run detects nothing and the factor reproduces A[perm]."""
    for rank in worlds[grid]:
        base, *deeper = rank[f"la_{method}_{dt}_{abft}"]
        for run in deeper:
            for x, y in zip(base, run):
                np.testing.assert_array_equal(x, y)
        assert [int(v) for v in base[4:]] == [0, 0, -1]


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_planted_panel_strike_located_and_repaired(worlds, reference, grid):
    """A post_panel bitflip in the last tile row of the first panel of a
    mesh gesv under Abft: counters (1, 1) and site (n/nb - 1, 0) on every
    rank, the reference's dist_getrf's under the same plan, and the solve
    the clean one's."""
    det, cor, site = reference["strike"]
    assert (det, cor, site) == (1, 1, (cases.STRIKE_N // cases.STRIKE_NB
                                       - 1) * 65536)
    a, b = cases.strike_system()
    for rank in worlds[grid]:
        s = rank["strike"]
        assert s["clean"] == (0, 0, True)
        assert s["struck"] == (det, cor, site, True)
        np.testing.assert_allclose(s["x"], np.linalg.solve(a, b),
                                   atol=1e-10)
        np.testing.assert_allclose(s["x"], s["x_clean"], atol=1e-12)


@pytest.mark.parametrize("dt", ["float64", "complex128"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_hetrf_matches_reference(worlds, reference, grid, dt):
    """The row-distributed Aasen's L and T within tolerance of the
    reference's _hetrf_mesh factors, the same symmetric pivots."""
    L, T, piv = worlds[grid][0][f"hetrf_{dt}"]
    L_r, T_r, piv_r = reference[f"hetrf_{dt}"]
    np.testing.assert_array_equal(piv, piv_r)
    _close(L, L_r, dt)
    _close(T, T_r, dt)


@pytest.mark.parametrize("dt", ["float64", "complex128"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_hesv_solves(worlds, grid, dt):
    x = cases.lu_inputs(dt)
    _close(worlds[grid][0][f"hesv_{dt}"],
           np.linalg.solve(x["h24"], x["b24"]), dt)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_indefinite_posv_ends_solved_on_the_hesv_rung(worlds, grid):
    """posv of a Hermitian indefinite matrix on the mesh: Cholesky fails
    on every rank alike, the ladder's hesv rung (the mesh Aasen) solves
    it, healthy."""
    x = cases.lu_inputs("float64")
    kind, ok, X = worlds[grid][0]["posv_indefinite"]
    assert (kind, ok) == ("HEFactors", True)
    _close(X, np.linalg.solve(x["h24"], x["b24"]), "float64")
