"""The port's distributed spectral reductions against slate_tpu's mesh
routes, in gloo worlds of CPU processes: dist_he2hb's and dist_ge2tb's
packings and T triangles, their lookahead depths 0, 1 and 2, heev (Auto,
DC, QR; a ragged complex matrix, the Trans view of a complex Hermitian,
an Upper-stored A, heev_vals), svd (tall ragged, wide, complex,
Bidiag, svd_vals), the API's eig, eig_vals, svd and svd_vals, stedc on
the grid, hegv (itypes 1-3, B stored Lower and Upper), pdsyev and pdgesvd over the grid's ScaLAPACK locals, and a
post_stage1 strike that heev's ladder escalates on every rank.

Each grid of ``torch_dist_cases.GRIDS`` is one world of p*q spawned ranks
that runs everything once (``torch_dist_cases.spectral_body``), started
before the reference computes.  The reference runs once a module on the
8-device virtual mesh of tests/conftest.py, on the grids its own tests
use (tests/test_heev.py:65, test_stedc.py:126): 2 x 2, and 2 x 4 for the
ragged complex he2hb and stedc.  Each reference call costs 5-25 s of
compiles, so the drivers that share a decomposition are held to one
reference call: DC, QR and heev_vals to Auto's heev, Bidiag and
svd_vals to Auto's svd; the ragged complex heev, the views and the
other svd shapes to numpy.  The reductions' packings and Ts are
deterministic and held directly; eigen- and singular vectors up to a
per-column phase (|diag(Z_ref^H Z)| = 1), and by their residual and
orthogonality.  Upper-stored B in hegv is held to scipy's eigh: the
reference takes an Upper factor as L, which is wrong there
(tests/test_torch_heev.py).

Tolerances: 1e-12 relative in f64 and complex128.  The reference's
``@annotate``d drivers need ``jax.core.trace_state_clean``, which the
installed JAX no longer exports; the reference fixture restores it on the
test side only.  No hand kernel runs here (hegv's dist_potrf takes K1's
plain version on the CPU).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import scipy.linalg

import jax

import slate_tpu as ref
from slate_tpu.parallel.dist_ge2tb import dist_ge2tb as ref_dist_ge2tb
from slate_tpu.parallel.dist_he2hb import dist_he2hb as ref_dist_he2hb

import torch_dist_cases as cases
from torch_dist_worlds import start_worlds

GRIDS = cases.GRIDS
GRID_IDS = [f"{p}x{q}" for p, q in GRIDS]
TOL = 1e-12
# the grids of the reference's own mesh tests
REF_GRID = {"h23": (2, 2), "h37": (2, 4), "g23": (2, 2), "g24": (2, 2),
            "stedc": (2, 4), "hegv": (2, 2)}
REF_CASES = [c for c in cases.SPEC_CASES if c[2]]
# the reference driver call a case is held to: the same decomposition
REF_OF = {"heev_auto_h23": "heev_auto_h23", "heev_dc_h23": "heev_auto_h23",
          "heev_qr_h23": "heev_auto_h23", "heev_vals_h23": "heev_auto_h23",
          "svd_auto_g23": "svd_auto_g23", "svd_bidiag_g23": "svd_auto_g23",
          "svd_vals_g23": "svd_auto_g23", "api_eig_h23": "heev_auto_h23",
          "api_svd_g23": "svd_auto_g23"}
REDUCTIONS = [("he2hb", "h23"), ("he2hb", "h37"), ("ge2tb", "g23"),
              ("ge2tb", "g24")]
RED_IDS = [f"{k}_{w}" for k, w in REDUCTIONS]


def ref_grid(p, q):
    return ref.Grid(p, q, devices=jax.devices()[:p * q])


@pytest.fixture(scope="module")
def pending_worlds(tmp_path_factory):
    """The worlds, started before the reference computes (they overlap)."""
    return start_worlds(GRIDS, cases.spectral_body,
                        lambda p, q: str(tmp_path_factory.mktemp(
                            f"spectral_{p}x{q}")))


@pytest.fixture(scope="module")
def worlds(pending_worlds, reference):
    return pending_worlds.result()


def _ref_reductions(x):
    out = {}
    for which in ("h23", "h37"):
        g = ref_grid(*REF_GRID[which])
        n, nb = x[which].shape[0], cases.SPEC_NB[which]
        S = ref.HermitianMatrix.from_numpy(x[which], nb, ref.Uplo.Lower,
                                           g).storage
        data, Ts = ref_dist_he2hb(S.data, S.Nt, g, n=n)
        out[("he2hb", which)] = (
            np.asarray(ref.TileStorage(data, n, n, nb, nb, g).to_dense()),
            np.asarray(Ts))
    for which in ("g23", "g24"):
        g = ref_grid(*REF_GRID[which])
        (m, n), nb = x[which].shape, cases.SPEC_NB[which]
        S = ref.Matrix.from_numpy(x[which], nb, nb, g).storage
        data, Tqs, Tls = ref_dist_ge2tb(S.data, S.Mt, S.Nt, m, n, g)
        out[("ge2tb", which)] = (
            np.asarray(ref.TileStorage(data, m, n, nb, nb, g).to_dense()),
            np.asarray(Tqs), np.asarray(Tls))
    return out


@pytest.fixture(scope="module")
def reference(pending_worlds):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean",
                   jax._src.core.trace_state_clean, raising=False)
        x = cases.spec_inputs()
        out = _ref_reductions(x)
        o = {ref.Option.Target: ref.Target.mesh}
        calls = dict((name, call) for name, call, _ in cases.SPEC_CASES)
        for name in sorted(set(REF_OF.values())):
            which = name.rsplit("_", 1)[1]
            M = cases.matrix_maker(ref, ref_grid(*REF_GRID[which]))
            out[name] = tuple(cases._np(v) for v in calls[name](ref, M, x,
                                                                o))
        out["stedc"] = tuple(np.asarray(v) for v in ref.stedc(
            x["d40"], x["e39"], ref_grid(*REF_GRID["stedc"])))
        M = cases.matrix_maker(ref, ref_grid(*REF_GRID["hegv"]))
        out["hegv_1"] = tuple(cases._np(v) for v in
                              cases._hegv_case(1)(ref, M, x, o))
        return out


def _close(got, want, tol=TOL):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _same_up_to_phase(got, want):
    """Columns of ``got`` equal those of ``want`` up to a unit factor
    each: |diag(want^H got)| = 1 for orthonormal columns."""
    d = np.abs(np.sum(want.conj() * got, axis=0))
    np.testing.assert_allclose(d, np.ones_like(d), atol=TOL)


def _orthonormal(z):
    k = z.shape[1]
    np.testing.assert_allclose(z.conj().T @ z, np.eye(k), atol=TOL * k)


@pytest.mark.parametrize("red", REDUCTIONS, ids=RED_IDS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_reduction_packing_and_ts_match_reference(worlds, reference, grid,
                                                  red):
    """The dense packing (band, R over V, the LQ rows merged) and the T
    triangles within 1e-12 of the reference's mesh reduction."""
    kind, which = red
    got = worlds[grid][0][f"{kind}_{which}"]
    want = reference[red]
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        _close(g_, w_)


@pytest.mark.parametrize("red", REDUCTIONS, ids=RED_IDS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_reduction_local_tiles_are_the_cyclic_slice(worlds, grid, red):
    """Each rank's tiles of the packing are bit for bit the reference's
    cyclic slice of the dense packing, pad tiles included."""
    p, q = grid
    kind, which = red
    dense = worlds[grid][0][f"{kind}_{which}"][0]
    nb = cases.SPEC_NB[which]
    cyc = np.asarray(ref.TileStorage.from_dense(dense, nb, nb,
                                                ref_grid(p, q)).data)
    mtl, ntl = cyc.shape[0] // p, cyc.shape[1] // q
    for rank in worlds[grid]:
        r, c = rank["coords"]
        np.testing.assert_array_equal(
            rank[f"{kind}_{which}"][-1],
            cyc[r * mtl:(r + 1) * mtl, c * ntl:(c + 1) * ntl])


@pytest.mark.parametrize("red", REDUCTIONS, ids=RED_IDS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_reduction_lookahead_depths_bit_identical(worlds, grid, red):
    """Depths 1 and 2 give depth 0's local tiles and Ts bit for bit, on
    every rank."""
    kind, which = red
    for rank in worlds[grid]:
        base, *deeper = rank[f"{kind}_depths_{which}"]
        for run in deeper:
            for x, y in zip(base, run):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", cases.SPEC_CASES,
                         ids=[c[0] for c in cases.SPEC_CASES])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_spectral_drivers_match_numpy(worlds, grid, case):
    """Values against numpy's; vectors by residual and orthogonality."""
    name = case[0]
    a = cases.spec_matrix(name)
    got = worlds[grid][0]["cases"][name]
    scale = float(np.abs(a).max())
    if name.startswith(("heev", "api_eig")):
        w = got[0]
        _close(w, np.linalg.eigvalsh(a, UPLO="L"))
        if len(got) > 1:
            z = got[1]
            assert np.abs(a @ z - z * w[None, :]).max() <= TOL * scale * 10
            _orthonormal(z)
        return
    s = got[0]
    _close(s, np.linalg.svd(a, compute_uv=False))
    if len(got) > 1:
        u, v = got[1], got[2]
        k = min(a.shape)
        assert u.shape == (a.shape[0], k) and v.shape == (a.shape[1], k)
        assert (np.abs(a - (u * s[None, :]) @ v.conj().T).max()
                <= TOL * scale * 10)
        _orthonormal(u)
        _orthonormal(v)


@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_spectral_drivers_match_reference(worlds, reference, grid, case):
    """Values within 1e-12 of the reference's mesh route; vectors equal to
    its up to a per-column phase."""
    name = case[0]
    got = worlds[grid][0]["cases"][name]
    want = reference[REF_OF[name]]
    _close(got[0], want[0])
    for g_, w_ in zip(got[1:], want[1:]):
        _same_up_to_phase(g_, w_)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_stedc_on_the_grid(worlds, reference, grid):
    """stedc with its merges row-distributed over the grid: the
    reference's values, its vectors up to sign, T's residual."""
    x = cases.spec_inputs()
    w, z = worlds[grid][0]["stedc"]
    wr, zr = reference["stedc"]
    _close(w, wr)
    _same_up_to_phase(z, zr)
    T = np.diag(x["d40"]) + np.diag(x["e39"], 1) + np.diag(x["e39"], -1)
    assert np.abs(T @ z - z * w[None, :]).max() <= TOL * 10
    _orthonormal(z)


def _hegv_residual(itype, a, b, w, X):
    if itype == 1:
        return a @ X - (b @ X) * w[None, :]
    if itype == 2:
        return a @ (b @ X) - X * w[None, :]
    return b @ (a @ X) - X * w[None, :]


@pytest.mark.parametrize("uplo", ["l", "u"])
@pytest.mark.parametrize("itype", [1, 2, 3])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_hegv_over_the_grid(worlds, reference, grid, itype, uplo):
    """hegv (dist_potrf, the mesh hegst and heev, the mesh back-transform):
    scipy's values and the residual of the itype's problem; itype 1 with
    B stored Lower also the reference's values and vectors (up to sign;
    each reference hegv costs ~20 s of compiles, so itypes 2 and 3, which
    differ from 1 only in hegst's trmm and the back-transform, are held
    to scipy and their residuals alone)."""
    x = cases.spec_inputs()
    a, b = x["h23"], x["b23"]
    w, X = worlds[grid][0][f"hegv_{itype}{uplo}"]
    _close(w, scipy.linalg.eigh(a, b, type=itype, eigvals_only=True))
    r = _hegv_residual(itype, a, b, w, X)
    scale = np.abs(a).max() * np.abs(b).max() * np.abs(X).max()
    assert np.abs(r).max() <= TOL * scale * 10
    if itype == 1 and uplo == "l":
        wr, Xr = reference["hegv_1"]
        _close(w, wr)
        sign = np.sign(np.sum(X * Xr, axis=0))
        _close(X, Xr * sign[None, :], tol=1e-10)


@pytest.mark.parametrize("routine", ["pdsyev", "pdgesvd"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_pd_spectral_routines_over_the_grid(worlds, grid, routine):
    """pdsyev and pdgesvd over the grid's ScaLAPACK locals: numpy's values,
    the vectors' residual, and their locals bit for bit the ScaLAPACK
    slices of the driver's own result on the grid."""
    x = cases.spec_inputs()
    for rank in worlds[grid]:
        if routine == "pdsyev":
            w, z, same = rank["pdsyev"]
            a = x["h23"]
            _close(w, np.linalg.eigvalsh(a))
            assert np.abs(a @ z - z * w[None, :]).max() <= TOL * 10 * \
                np.abs(a).max()
        else:
            s, u, vt, same = rank["pdgesvd"]
            a = x["g23"]
            _close(s, np.linalg.svd(a, compute_uv=False))
            assert np.abs(a - (u * s[None, :]) @ vt).max() <= TOL * 10 * \
                np.abs(a).max()
        assert same


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_every_rank_holds_the_same_results(worlds, grid):
    base = worlds[grid][0]
    for rank in worlds[grid][1:]:
        for key, val in base["cases"].items():
            for x, y in zip(rank["cases"][key], val):
                np.testing.assert_array_equal(x, y, err_msg=key)
        for key in ["stedc"] + [f"hegv_{t}{u}" for t, u in
                                cases.HEGV_CASES]:
            for x, y in zip(rank[key], base[key]):
                np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_heev_strike_escalates_on_every_rank(worlds, grid):
    """A transient NaN strike on the band (post_stage1) fails Auto's
    certificate; the health folded over the grid sends every rank to DC,
    which certifies: the same path and result on every rank."""
    a = cases.spec_inputs()["h23"]
    for rank in worlds[grid]:
        ok, path, w, z = rank["strike"]
        assert ok and path == "escalated:DC"
        _close(w, np.linalg.eigvalsh(a))
        assert np.abs(a @ z - z * w[None, :]).max() <= TOL * 10 * \
            np.abs(a).max()
