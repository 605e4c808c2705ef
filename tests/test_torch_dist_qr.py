"""The port's distributed QR (CAQR) against slate_tpu's mesh drivers, in
gloo worlds of CPU processes: geqrf's CAQR factors, unmqr from either
side with Q and Qᴴ (tests/test_qr.py:59-85), gelqf with unmlq, gels
(Householder QR, CholQR, square complex, minimum norm); dist_geqrf at
lookahead depths 0, 1 and 2; and from_scalapack / to_scalapack, pdgesv,
pdgels, pdsyev and pdgesvd over a p x q grid's ScaLAPACK locals.

Each grid of ``torch_dist_cases.GRIDS`` is one world of p*q spawned ranks
that runs everything once (``torch_dist_cases.qr_body``).  CAQR's factors
depend on the grid's row count p (its tree stacks the p grid rows' R
blocks), so geqrf, unmqr and gelqf are held against the reference on a
grid of the same p (1 x 2 for the one-rank world: the reference's 1 x 1
grid has no mesh, and q does not enter CAQR's arithmetic); gels is held
against the reference's 2 x 2 result.  The ScaLAPACK routines are held
to numpy's solve, least squares, eigenvalues and singular values, their
locals bit for bit to the grid's cyclic slices.  Depths 1 and 2 are held bit for bit against depth
0 on one input (the reference's tests/test_lookahead.py:183-200 draws two
matrices a comparison, so the frozen test fails; on one input the
reference's CAQR is bit-identical across depths in f64).

Tolerances: 1e-4 relative in f32 (held to the reference's f64 result of
the same inputs), 1e-12 in f64 and complex128.  At 4 x 4 tiles every
panel is narrower than the CholQR2 route's 8 columns, so both packages
factor panels by Householder reflections; on the CPU the port's local
panels take K5's plain version.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest

import jax

import slate_tpu as ref

import torch_dist_cases as cases
from torch_dist_worlds import start_worlds

GRIDS = cases.GRIDS
GRID_IDS = [f"{p}x{q}" for p, q in GRIDS]
# the reference grid of each p: CAQR's factors depend on p alone
REF_OF_P = {1: (1, 2), 2: (2, 2), 4: (4, 2)}


def ref_grid(p, q):
    return ref.Grid(p, q, devices=jax.devices()[:p * q])


@pytest.fixture(scope="module")
def pending_worlds(tmp_path_factory):
    """The worlds, started before the reference computes (they overlap)."""
    return start_worlds(GRIDS, cases.qr_body,
                        lambda p, q: str(tmp_path_factory.mktemp(
                            f"qr_{p}x{q}")))


@pytest.fixture(scope="module")
def worlds(pending_worlds, reference):
    return pending_worlds.result()


def _ref_grid_cases(g, o):
    """The reference's QR_GRID_CASES on grid ``g``, one geqrf shared."""
    M = cases.matrix_maker(ref, g)
    x = cases.qr_inputs("float64")
    F = ref.geqrf(M(x["a37"]), o)
    out = {"geqrf": tuple(cases._np(v) for v in
                          (F.QR, F.Tloc, F.Vtree, F.Ttree))}
    for side in ("l", "r"):
        C = M(x["cl" if side == "l" else "cr"])
        for op in ("n", "c"):
            out[f"unmqr_{side}{op}"] = (cases._np(ref.unmqr(side, op, F, C,
                                                            o)),)
    FL = ref.gelqf(M(x["w15"]), o)
    out["gelqf_unmlq"] = (cases._np(ref.unmlq("l", "c", FL, M(x["cl"]),
                                              o)),)
    return out


@pytest.fixture(scope="module")
def reference(pending_worlds):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean",
                   jax._src.core.trace_state_clean, raising=False)
        o = {ref.Option.Target: ref.Target.mesh}
        out = {p: _ref_grid_cases(ref_grid(*pq), o)
               for p, pq in REF_OF_P.items()}
        M = cases.matrix_maker(ref, ref_grid(2, 2))
        for name, dt, call in cases.QR_CASES:
            key = (name, cases.ref_dtype(dt))
            if key not in out:
                out[key] = cases._np(call(
                    ref, M, cases.qr_inputs(cases.ref_dtype(dt)), o))
        return out


def _close(got, want, dt):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=cases.TOL[dt],
                               atol=cases.TOL[dt] * scale)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("case", cases.QR_GRID_CASES,
                         ids=[cases.case_id(c) for c in cases.QR_GRID_CASES])
def test_caqr_matches_reference_on_its_grid(worlds, reference, case, grid):
    """geqrf's packed factors, Tloc, Vtree and Ttree, and the products of
    unmqr and unmlq, within tolerance of the reference's CAQR on a grid of
    the same p."""
    name, dt, _ = case
    got = worlds[grid][0]["cases"][cases.case_id(case)]
    want = reference[grid[0]][name]
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        _close(g_, w_, dt)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("case", cases.QR_CASES,
                         ids=[cases.case_id(c) for c in cases.QR_CASES])
def test_gels_matches_reference(worlds, reference, case, grid):
    name, dt, _ = case
    got = worlds[grid][0]["cases"][cases.case_id(case)][0]
    _close(got, reference[(name, cases.ref_dtype(dt))], dt)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_every_rank_holds_the_same_results(worlds, grid):
    base = worlds[grid][0]
    for rank in worlds[grid][1:]:
        for key, val in base["cases"].items():
            for x, y in zip(rank["cases"][key], val):
                np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_local_tiles_are_the_reference_cyclic_slice(worlds, grid):
    """Each rank's block of the CAQR factor is bit for bit the reference's
    cyclic slice of the factor, pad tiles included."""
    p, q = grid
    qr = worlds[grid][0]["cases"]["geqrf-float64"][0]
    cyc = np.asarray(ref.TileStorage.from_dense(qr, cases.NB, cases.NB,
                                                ref_grid(p, q)).data)
    mtl, ntl = cyc.shape[0] // p, cyc.shape[1] // q
    for rank in worlds[grid]:
        r, c = rank["coords"]
        np.testing.assert_array_equal(
            rank["local_geqrf"], cyc[r * mtl:(r + 1) * mtl,
                                     c * ntl:(c + 1) * ntl])


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_geqrf_lookahead_depths_bit_identical(worlds, grid, dt):
    """dist_geqrf's local factor, Tloc, Vtree and Ttree at depths 1 and 2
    bit for bit those of depth 0, on every rank."""
    for rank in worlds[grid]:
        base, *deeper = rank[f"la_qr_{dt}"]
        for run in deeper:
            for x, y in zip(base, run):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_from_scalapack_lands_on_the_grid(worlds, grid):
    """The locals of a p x q ScaLAPACK process grid: each rank keeps the
    tiles of its own coordinate, bit for bit, and to_scalapack gives the
    same locals back on every rank."""
    p, q = grid
    a = cases.scalapack_system()[0]
    nb = cases.SCALAPACK_NB
    cyc = np.asarray(ref.TileStorage.from_dense(a, nb, nb,
                                                ref_grid(p, q)).data)
    mtl, ntl = cyc.shape[0] // p, cyc.shape[1] // q
    for rank in worlds[grid]:
        r, c = rank["coords"]
        np.testing.assert_array_equal(
            rank["scalapack_local"], cyc[r * mtl:(r + 1) * mtl,
                                         c * ntl:(c + 1) * ntl])
        assert rank["scalapack_round_trip"]


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_pdgesv_and_pdgels_over_the_grid(worlds, grid):
    a, b, aq, bq = cases.scalapack_system()
    for rank in worlds[grid]:
        _close(rank["pdgesv"], np.linalg.solve(a, b), "float64")
        _close(rank["pdgels"], np.linalg.lstsq(aq, bq, rcond=None)[0],
               "float64")


@pytest.mark.parametrize("routine", ["pdsyev", "pdgesvd"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_spectral_pd_routines_on_a_grid_with_a_group(worlds, grid, routine):
    """pdsyev (the lower triangle of A read as Hermitian) and pdgesvd over
    the grid's ScaLAPACK locals, on every rank: numpy's eigenvalues and
    singular values, and the vectors they return in ScaLAPACK layout by
    their residual."""
    a = cases.scalapack_system()[0]
    for rank in worlds[grid]:
        if routine == "pdsyev":
            h = np.tril(a) + np.tril(a, -1).T
            w, z = rank["pdsyev"]
            _close(w, np.linalg.eigvalsh(h), "float64")
            _close(h @ z, z * w[None, :], "float64")
        else:
            s, u, vt = rank["pdgesvd"]
            _close(s, np.linalg.svd(a, compute_uv=False), "float64")
            _close((u * s[None, :]) @ vt, a, "float64")
