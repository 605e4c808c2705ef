"""The port's distributed Cholesky layer against slate_tpu's mesh drivers,
in gloo worlds of CPU processes: potrf (Lower and Upper), posv (potrf and
two dist_trsm sweeps), trtri; dist_potrf at lookahead depths 0, 1 and 2
with and without ABFT; planted post_panel and post_collective strikes;
the health of an indefinite matrix on every rank; and the queue-1 item
12b and 12c drivers' results on a grid with a process group (ported
with those items).

Each grid of ``torch_dist_cases.GRIDS`` is one world of p*q spawned ranks
that runs everything once (``torch_dist_cases.chol_body``); the
parametrised tests assert one case each.  The reference runs once a
module on the 8-device virtual mesh of tests/conftest.py: the drivers on
its 2 x 4 grid, dist_potrf under the planted strikes on the 2 x 2 grid
the port's counters are held to (tests/test_lookahead.py:302-323).
Depths 1 and 2 are held bit for bit against depth 0, counters included.

Tolerances: 1e-4 relative in f32 (held to the reference's f64 result of
the same inputs), 1e-12 in f64 and complex128.  The reference's
``@annotate``d drivers need ``jax.core.trace_state_clean``, which the
installed JAX no longer exports; the reference fixture restores it on the
test side only.  On the CPU the diagonal tiles take K1's plain version.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest

import jax

import slate_tpu as ref
from slate_tpu.parallel.dist_chol import dist_potrf as ref_dist_potrf
from slate_tpu.robust import faults as ref_faults

import torch_dist_cases as cases
from torch_dist_worlds import start_worlds

GRIDS = cases.GRIDS
GRID_IDS = [f"{p}x{q}" for p, q in GRIDS]
CASE_IDS = [cases.case_id(c) for c in cases.CHOL_CASES]


def ref_grid(p, q):
    return ref.Grid(p, q, devices=jax.devices()[:p * q])


@pytest.fixture(scope="module")
def pending_worlds(tmp_path_factory):
    """The worlds, started before the reference computes (they overlap)."""
    return start_worlds(GRIDS, cases.chol_body,
                        lambda p, q: str(tmp_path_factory.mktemp(
                            f"chol_{p}x{q}")))


@pytest.fixture(scope="module")
def worlds(pending_worlds, reference):
    return pending_worlds.result()


@pytest.fixture(scope="module")
def reference(pending_worlds):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean",
                   jax._src.core.trace_state_clean, raising=False)
        g = ref_grid(2, 4)
        M = cases.matrix_maker(ref, g)
        o = {ref.Option.Target: ref.Target.mesh}
        out = {}
        for name, dt, call in cases.CHOL_CASES:
            key = (name, cases.ref_dtype(dt))
            if key not in out:
                out[key] = cases.dense(call(
                    ref, M, cases.inputs(cases.ref_dtype(dt)), o))
        g2 = ref_grid(2, 2)
        S = ref.HermitianMatrix.from_numpy(
            cases.chol_storage_array("float64"), cases.NB, ref.Uplo.Lower,
            g2).storage
        for site, kw in cases.CHOL_STRIKES.items():
            with ref_faults.inject(ref_faults.FaultPlan(site, **kw)):
                res = ref_dist_potrf(S.data, S.Nt, g2, S.n, abft=True, la=0)
            out[("strike", site)] = tuple(int(x) for x in res[3:])
        return out


def _close(got, want, dt):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=cases.TOL[dt],
                               atol=cases.TOL[dt] * scale)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("case", cases.CHOL_CASES, ids=CASE_IDS)
def test_cholesky_matches_reference(worlds, reference, case, grid):
    name, dt, _ = case
    got = worlds[grid][0]["cases"][cases.case_id(case)]
    _close(got, reference[(name, cases.ref_dtype(dt))], dt)
    for rank in worlds[grid][1:]:
        np.testing.assert_array_equal(rank["cases"][cases.case_id(case)],
                                      got)


@pytest.mark.parametrize("abft", [False, True])
@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_potrf_lookahead_depths_bit_identical(worlds, grid, dt, abft):
    """dist_potrf's local factor, health and counters at depths 1 and 2
    bit for bit those of depth 0, on every rank; a clean run detects
    nothing."""
    for rank in worlds[grid]:
        base, *deeper = rank[f"potrf_{dt}_{abft}"]
        for run in deeper:
            for x, y in zip(base, run):
                np.testing.assert_array_equal(x, y)
        assert [int(v) for v in base[3:]] == [0, 0, -1]


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("site", sorted(cases.CHOL_STRIKES))
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_potrf_strike_counters_match_reference(worlds, reference, grid,
                                               site, dt):
    """A planted strike under ABFT: every depth's counters and site the
    reference's (dist_potrf on its 2 x 2 mesh), every detection repaired,
    the repaired factor the clean one's (to the dtype's rounding)."""
    det, cor, where = reference[("strike", site)]
    assert det >= 1 and cor == det
    for rank in worlds[grid]:
        clean = rank[f"potrf_{dt}_True"][0][0]
        for run in rank[f"strike_{site}_{dt}"]:
            assert (int(run[3]), int(run[4]), int(run[5])) == (det, cor,
                                                               where)
            np.testing.assert_allclose(np.tril(run[0]), np.tril(clean),
                                       atol=1e-4 if dt == "float32"
                                       else 1e-10)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_indefinite_health_on_every_rank(worlds, grid):
    """The first leading minor that is not positive definite (the 10th)
    is reported on every rank under Info, and every rank raises
    SlateNotPositiveDefiniteError with it under Raise (the health is
    reduced before any rank decides)."""
    for rank in worlds[grid]:
        info, _, _ = rank["indefinite_info"]
        assert info == 10
        assert rank["indefinite_raise"] == 10


@pytest.mark.parametrize("driver", ["gesv", "getrf", "gels", "geqrf", "heev",
                                    "svd", "hetrf", "hesv", "stedc"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_item_12_drivers_solve_on_a_grid_with_a_group(worlds, grid, driver):
    """The queue-1 item-12b and item-12c drivers, which once refused a
    grid with a process group, take their mesh routes there and give the
    right answer on every rank (held here to numpy and scipy on the same
    inputs; against the reference's mesh drivers in
    tests/test_torch_dist_lu.py, test_torch_dist_qr.py and
    test_torch_dist_spectral.py): heev, svd and stedc numpy's eigenvalues
    and singular values, their vectors by residual."""
    import scipy.linalg
    x = cases.inputs("float64")
    a, h, b = x["spd"], x["herm"], x["rhs"]
    for rank in worlds[grid]:
        got = rank["refusals"][driver]
        if driver == "heev":
            w, z = got
            _close(w, np.linalg.eigvalsh(h), "float64")
            _close(h @ z, z * w[None, :], "float64")
        elif driver == "svd":
            s, u, v = got
            _close(s, np.linalg.svd(a, compute_uv=False), "float64")
            _close((u * s[None, :]) @ v.T, a, "float64")
        elif driver == "stedc":
            d, e = cases.stedc_refusal_input()
            t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
            w, z = got
            _close(w, np.linalg.eigvalsh(t), "float64")
            _close(t @ z, z * w[None, :], "float64")
        elif driver == "gesv":
            _close(got, np.linalg.solve(a, b), "float64")
        elif driver == "hesv":
            _close(got, np.linalg.solve(h, b), "float64")
        elif driver == "gels":
            _close(got, np.linalg.lstsq(a, b, rcond=None)[0], "float64")
        elif driver == "getrf":
            lu, perm = got
            _, piv = scipy.linalg.lu_factor(a)
            want = np.arange(cases.N)
            for i, pv in enumerate(piv):
                want[[i, pv]] = want[[pv, i]]
            np.testing.assert_array_equal(perm, want)
            _close(np.tril(lu, -1) @ np.triu(lu) + np.triu(lu), a[perm],
                   "float64")
        elif driver == "geqrf":
            _close(np.abs(np.triu(got)), np.abs(np.linalg.qr(a, "r")),
                   "float64")
        else:
            L, T, piv = got
            _close(L @ T @ L.conj().T, h[np.ix_(piv, piv)], "float64")
