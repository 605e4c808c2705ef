"""The port's distributed BLAS-3 layer against slate_tpu's mesh drivers,
in gloo worlds of CPU processes.

Each grid of ``torch_dist_cases.GRIDS`` (1 x 1 with a process group, 2 x
2, 2 x 4, 4 x 2) is one world of p*q spawned ranks that runs every case
once (``torch_dist_cases.blas3_world``); the parametrised tests then
assert one case each.  The reference runs once a module on the 8-device
virtual mesh of tests/conftest.py, its 2 x 4 grid for the drivers (their
results on any grid agree to rounding) and the grid of the test where
the bits or the counters depend on it: the local tiles are held bit for
bit against the reference's cyclic slice of each grid, and a planted
post_collective strike's counters and site against the reference's SUMMA
on the same 2 x 2 grid.  SUMMA's lookahead depths 1 and 2 are held bit
for bit against depth 0 (tests/test_lookahead.py:88-147 for the
reference).  The reference's checksum SUMMA does not trace under the
installed JAX (``torch_dist_cases.REF_CALL``), so a planted strike's
counters and site are held to their closed form on each grid (one
detection a rank whose local tile (1, 0) the strike hits, the site the
largest such global tile), and gemm under Abft to the reference's plain
SUMMA.

Tolerances: 1e-4 relative in f32 (an f32 case is held to the reference's
f64 result of the same inputs), 1e-12 in f64 and complex128.  The
reference's ``@annotate``d drivers need ``jax.core.trace_state_clean``,
which the installed JAX no longer exports; the reference fixture restores
it on the test side only.  A world that deadlocks fails its test within
the harness's deadline (tests/torch_dist_worlds.py).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest

import jax

import slate_tpu as ref

import torch_dist_cases as cases
from torch_dist_worlds import run_world, start_worlds

GRIDS = cases.GRIDS
GRID_IDS = [f"{p}x{q}" for p, q in GRIDS]
CASE_IDS = [cases.case_id(c) for c in cases.BLAS3_CASES]


def ref_grid(p, q):
    return ref.Grid(p, q, devices=jax.devices()[:p * q])


@pytest.fixture(scope="module")
def pending_worlds(tmp_path_factory):
    """The worlds, started before the reference computes (they overlap)."""
    return start_worlds(GRIDS, cases.blas3_world,
                        lambda p, q: str(tmp_path_factory.mktemp(
                            f"blas3_{p}x{q}")))


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
        for name, dt, call in cases.BLAS3_CASES:
            key = (name, cases.ref_dtype(dt))
            if key not in out:
                call = cases.REF_CALL.get(name, call)
                out[key] = cases.dense(call(ref, M,
                                            cases.inputs(cases.ref_dtype(dt)),
                                            o))
        return out


def _close(got, want, dt):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=cases.TOL[dt],
                               atol=cases.TOL[dt] * scale)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("case", cases.BLAS3_CASES, ids=CASE_IDS)
def test_blas3_matches_reference(worlds, reference, case, grid):
    name, dt, _ = case
    got = worlds[grid][0]["cases"][cases.case_id(case)]
    _close(got, reference[(name, cases.ref_dtype(dt))], dt)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_every_rank_holds_the_same_results(worlds, grid):
    ranks = worlds[grid]
    for r in ranks[1:]:
        for key, val in ranks[0]["cases"].items():
            np.testing.assert_array_equal(r["cases"][key], val, err_msg=key)


@pytest.mark.parametrize("dt", cases.LAYOUT_DTYPES)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_local_tiles_are_the_reference_cyclic_slice(worlds, grid, dt):
    """Each rank's block is bit for bit the reference's cyclic array's
    slice [r*mtl:(r+1)*mtl, c*ntl:(c+1)*ntl], pad tiles included."""
    p, q = grid
    a = cases.inputs(dt)["a"]
    cyc = np.asarray(ref.TileStorage.from_dense(a, cases.NB, cases.NB,
                                                ref_grid(p, q)).data)
    mtl, ntl = cyc.shape[0] // p, cyc.shape[1] // q
    for rank in worlds[grid]:
        r, c = rank["coords"]
        want = cyc[r * mtl:(r + 1) * mtl, c * ntl:(c + 1) * ntl]
        np.testing.assert_array_equal(rank[f"local_{dt}"], want)
        np.testing.assert_array_equal(rank[f"dense_{dt}"], a)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_collectives(worlds, grid):
    p, q = grid
    for rank in worlds[grid]:
        r, c = rank["coords"]
        assert rank["bcast_q"] == complex(10 * r + q - 1, -1)
        assert rank["bcast_p"] == complex(10 * (p - 1) + c, -1)
        assert rank["ring_q"] == complex(10 * r + q // 2, -1)
        assert rank["ring_p"] == complex(10 * (p // 2) + c, -1)
        assert rank["ring_pair"] == (complex(10 * r, -1),
                                     complex(10 * r + q - 1 + 100, -1))
        assert rank["reduce_p"] == sum(complex(10 * i + c, -1)
                                       for i in range(p))
        assert rank["reduce_grid_max"] == p * q - 1
        assert rank["allgather_q"] == [float(j) for j in range(q)]
        chunks = [sum(2.0 * q * 0 + i + j for j in range(q)) for i in
                  range(2 * q)]
        assert rank["reduce_scatter_q"] == chunks[2 * c:2 * c + 2]
        assert rank["pargmax_tie"] == [5.0, 7 - (p - 1)]
        assert rank["pargmax"] == [float(p - 1), 10 + p - 1]
        assert rank["shift_q"] == float((c - 1) % q)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_norms_reduce_local_tiles(worlds, grid):
    x = cases.inputs("float64")
    mats = {"ge": x["a"], "he": x["herm"],
            "tr": np.tril(x["tri"], -1) + np.eye(cases.N)}
    want = {}
    for kind, m in mats.items():
        want[f"{kind}_Max"] = np.abs(m).max()
        want[f"{kind}_One"] = np.linalg.norm(m, 1)
        want[f"{kind}_Inf"] = np.linalg.norm(m, np.inf)
        want[f"{kind}_Fro"] = np.linalg.norm(m)
    for rank in worlds[grid]:
        got = rank["norms"]
        for key, val in want.items():
            np.testing.assert_allclose(got[key], val, rtol=1e-13,
                                       err_msg=key)
        np.testing.assert_array_equal(got["col_norms"],
                                      np.abs(x["a"]).max(axis=0))


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_redistribute_point_to_point(worlds, grid):
    """Onto the transposed grid the tiles travel point to point and land
    bit for bit where from_numpy puts them; back, and re-tiled, the matrix
    is unchanged."""
    a = cases.inputs("float64")["a"]
    for rank in worlds[grid]:
        np.testing.assert_array_equal(rank["redistribute_local"],
                                      rank["redistribute_want"])
        np.testing.assert_array_equal(rank["redistribute_back"], a)
        np.testing.assert_array_equal(rank["redistribute_nb"], a)


@pytest.mark.parametrize("abft", [False, True])
@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_summa_lookahead_depths_bit_identical(worlds, grid, dt, abft):
    for rank in worlds[grid]:
        base, *deeper = rank[f"summa_{dt}_{abft}"]
        for run in deeper:
            for x, y in zip(base, run):
                np.testing.assert_array_equal(x, y)


def _strike_counters(p, q):
    """The closed form of the planted SUMMA strike: every rank strikes its
    local accumulator tile (1, 0) (global tile (r + p, c)) at the flat
    position of seed 3 (faults.py draws it so); a rank detects and repairs
    it when that element lies inside the 18 x 14 product (pad entries are
    zero, and a bitflip of a zero stays zero).  Returns (detected, corrected, site)."""
    pos = int(np.random.default_rng(3).choice(cases.NB * cases.NB, size=1,
                                              replace=False)[0])
    i0, j0 = divmod(pos, cases.NB)
    hits = [(r + p, c) for r in range(p) for c in range(q)
            if (r + p) * cases.NB + i0 < 18 and c * cases.NB + j0 < 14]
    site = max((i * 65536 + j for i, j in hits), default=-1)
    return len(hits), len(hits), site


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_summa_strike_detected_repaired_at_every_depth(worlds, grid, dt):
    """A post_collective bitflip in every rank's local tile (1, 0) under
    ABFT (the reference's test_lookahead.py:268): detected and repaired,
    the grid-summed counters and the site their closed form at every
    depth, and the repaired product the clean one."""
    want = _strike_counters(*grid)
    for rank in worlds[grid]:
        clean = rank[f"summa_{dt}_True"][0][0]
        for run in rank[f"summa_strike_{dt}"]:
            assert (int(run[1]), int(run[2]), int(run[3])) == want
            np.testing.assert_allclose(run[0], clean,
                                       atol=cases.TOL[dt] * 100)


def test_a_deadlocked_world_fails_instead_of_hanging(tmp_path):
    """A rank that never joins a collective leaves the others waiting: the
    harness kills the world at its deadline and raises, naming the ranks
    still running, so the test fails instead of hanging the suite."""
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] still running"):
        run_world(2, cases.deadlock_body, (), tmp_dir=str(tmp_path),
                  deadline_s=10.0)
