"""The port's speculative rungs (Option.Speculate, with Option.Precision =
bf16 below them) against slate_tpu's, on the CPU: gesv's certified RBT
rung, posv's bf16 rung and gels' certified CholQR2 and bf16 QR rungs.

The same numpy inputs, from a seed, go through both packages.  The
escalation path is held EXACT (the factor type, the refinement count the
accepted rung records, the health flags), solutions within 1e-5 relative
in f32 and 1e-12 in f64.  The cases mirror tests/test_rbt.py and the
precision rung of tests/test_precision.py.  The reference's drivers are
wrapped in ``@annotate``, which calls ``jax.core.trace_state_clean``; the
installed JAX no longer exports that name, so the ``ref_drivers`` fixture
restores it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest

import jax
import slate_tpu as ref
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch.robust import faults

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _opts(pkg, **kv):
    o = {pkg.Option.Speculate: "on", pkg.Option.ErrorPolicy: "info"}
    o.update({getattr(pkg.Option, k): v for k, v in kv.items()})
    return o


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= RTOL[dtype] * np.abs(want).max()


def _both(fn_port, fn_ref, plans=()):
    with faults.inject(*[faults.FaultPlan(**p) for p in plans]):
        got = fn_port()
    with ref_faults.inject(*[ref_faults.FaultPlan(**p) for p in plans]):
        want = fn_ref()
    return got, want


def _gesv(a, b, nb, plans=(), **kw):
    return _both(
        lambda: st.gesv(st.Matrix.from_numpy(a, nb, device="cpu"),
                        st.Matrix.from_numpy(b, nb, device="cpu"),
                        _opts(st, **kw)),
        lambda: ref.gesv(ref.Matrix.from_numpy(a, nb),
                         ref.Matrix.from_numpy(b, nb), _opts(ref, **kw)),
        plans)


def _wilkinson(n):
    a = np.tril(-np.ones((n, n)), -1) + np.eye(n)
    a[:, -1] = 1.0
    return a


def _same_path(F, Fr, h, hr):
    assert type(F).__name__ == type(Fr).__name__
    assert (h.ok, h.iters, h.converged) == (bool(hr.ok), int(hr.iters),
                                            bool(hr.converged))


# ------------------------------------------------------- gesv speculation

@pytest.mark.parametrize("kind", ["random", "symmetric_indefinite",
                                  "wilkinson", "zero_pivot"])
def test_gesv_speculate_matches_the_reference(ref_drivers, kind):
    """The certified RBT rung accepts or escalates as the reference's does
    and both solutions match the pivoted oracle."""
    rng = np.random.default_rng(1)
    n, nb = 24, 8
    if kind == "random":
        a = rng.standard_normal((n, n))
    elif kind == "symmetric_indefinite":
        s = rng.standard_normal((n, n))
        a = (s + s.T) / 2
    elif kind == "wilkinson":
        a = _wilkinson(n)
    else:
        a = rng.standard_normal((n, n)) + n * np.eye(n)
        a[0, 0] = 0.0
    b = rng.standard_normal((n, 3))
    (F, X, h), (Fr, Xr, hr) = _gesv(a, b, nb)
    _same_path(F, Fr, h, hr)
    assert h.ok
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)
    np.testing.assert_allclose(X.to_numpy(), np.linalg.solve(a, b),
                               rtol=1e-9, atol=1e-9)


def test_gesv_speculate_ragged_and_f32(ref_drivers):
    """n = 30 pads to the butterfly's 32 (the certificate read on the
    original system); f32 at n = 64, nb = 32 (K3's plain version on the
    padded NoPiv factor) stays f32 and matches the reference."""
    rng = np.random.default_rng(2)
    n = 30
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 2))
    (F, X, h), (Fr, Xr, hr) = _gesv(a, b, 8)
    _same_path(F, Fr, h, hr)
    assert isinstance(F, st.RBTFactors) and F.F.LU.m == 32 and h.ok
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)
    n = 64
    a = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 2)).astype(np.float32)
    (F, X, h), (Fr, Xr, hr) = _gesv(a, b, 32)
    _same_path(F, Fr, h, hr)
    assert X.dtype == st.Matrix.from_numpy(a, 32, device="cpu").dtype
    _close(X.to_numpy(), Xr.to_numpy(), np.float32)


def test_gesv_speculate_off_is_the_default_path(ref_drivers):
    """Speculate Auto (the default) leaves gesv on the pivoted path."""
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((16, 16)), rng.standard_normal((16, 2))
    F, _ = st.gesv(st.Matrix.from_numpy(a, 8, device="cpu"),
                   st.Matrix.from_numpy(b, 8, device="cpu"))
    assert isinstance(F, st.LUFactors)
    (F2, _, _), (Fr2, _, _) = _gesv(a, b, 8)
    assert isinstance(F2, st.RBTFactors)
    assert type(Fr2).__name__ == "RBTFactors"


@pytest.mark.parametrize("fallback,transient", [(True, False),
                                                (False, False),
                                                (True, True)])
def test_post_rbt_fault_escalates_or_is_reported(ref_drivers, fallback,
                                                 transient):
    """A post_rbt strike gives a finite but wrong fast solve: the residual
    certificate catches it; with the fallback solver on, gesv escalates to
    pivoted LU (a transient strike: the pivoted retry is clean); with it
    off the failure stays in the health, and Raise raises."""
    rng = np.random.default_rng(4)
    n, nb = 24, 8
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 2))
    plan = dict(site="post_rbt", kind="nan" if transient else "bitflip",
                transient=transient)
    (F, X, h), (Fr, Xr, hr) = _gesv(a, b, nb, [plan],
                                    UseFallbackSolver=fallback)
    _same_path(F, Fr, h, hr)
    if fallback:
        assert isinstance(F, st.LUFactors) and h.ok
        _close(X.to_numpy(), Xr.to_numpy(), np.float64)
    else:
        assert isinstance(F, st.RBTFactors) and not h.ok
        with faults.inject(faults.FaultPlan(**plan)):
            with pytest.raises(st.SlateSingularError):
                st.gesv(st.Matrix.from_numpy(a, nb, device="cpu"),
                        st.Matrix.from_numpy(b, nb, device="cpu"),
                        {st.Option.Speculate: "on",
                         st.Option.UseFallbackSolver: False})


def test_speculate_with_abft_retries_the_rbt_rung(ref_drivers):
    """Speculate and Abft together: an unrepaired double strike in the
    RBT rung's NoPiv panel retries the RBT rung itself (the strike spent),
    which then certifies; the reference takes the same path."""
    rng = np.random.default_rng(5)
    n, nb = 32, 8
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 2))
    plan = dict(site="post_panel", kind="bitflip", seed=5, count=2,
                transient=True, tile=(3, 0), nb=nb)
    (F, X, h), (Fr, Xr, hr) = _gesv(a, b, nb, [plan], Abft="on")
    _same_path(F, Fr, h, hr)
    assert isinstance(F, st.RBTFactors) and h.ok
    assert (h.abft_detected, h.abft_corrected) == (0, 0)
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)


# ----------------------------------------------------- posv's bf16 rung

def _spd(seed, n, cond=None):
    rng = np.random.default_rng(seed)
    if cond is None:
        g = rng.standard_normal((n, n))
        a = g @ g.T / n + np.eye(n)
    else:
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a = (q * np.logspace(0, -np.log10(cond), n)) @ q.T
        a = (a + a.T) / 2
    return a.astype(np.float32), rng.standard_normal((n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("cond", [None, 1e6])
def test_posv_bf16_rung(ref_drivers, cond):
    """Speculate + Precision bf16: an SPD matrix is accepted on the bf16
    rung (two refinement sweeps recorded, the certificate met); at
    cond ~1e6 the bf16-rounded factor cannot refine to the f32 tolerance
    and the rung escalates to the f32 Cholesky attempt (no refinement),
    as the reference's does."""
    a, b = _spd(6, 96, cond)
    (F, X, h), (Fr, Xr, hr) = _both(
        lambda: st.posv(st.HermitianMatrix.from_numpy(a, 32, device="cpu"),
                        st.Matrix.from_numpy(b, 32, device="cpu"),
                        _opts(st, Precision="bf16")),
        lambda: ref.posv(ref.HermitianMatrix.from_numpy(a, 32),
                         ref.Matrix.from_numpy(b, 32),
                         _opts(ref, Precision="bf16")))
    _same_path(F, Fr, h, hr)
    assert isinstance(F, st.TriangularMatrix) and h.ok
    assert h.iters == (2 if cond is None else 0)
    if cond is None:
        _close(X.to_numpy(), Xr.to_numpy(), np.float32)
    else:
        # the f32 Cholesky solve of a cond-1e6 system: both within the
        # f32 forward error cond * eps of the f64 solution
        x64 = np.linalg.solve(a.astype(np.float64), b)
        for x in (X.to_numpy(), Xr.to_numpy()):
            assert np.abs(x - x64).max() <= 1e6 * 1e-6 * np.abs(x64).max()


# --------------------------------------------------------- gels rungs

def _gels(a, b, nb, **kw):
    return _both(
        lambda: st.gels(st.Matrix.from_numpy(a, nb, device="cpu"),
                        st.Matrix.from_numpy(b, nb, device="cpu"),
                        _opts(st, **kw)),
        lambda: ref.gels(ref.Matrix.from_numpy(a, nb),
                         ref.Matrix.from_numpy(b, nb), _opts(ref, **kw)))


def test_gels_speculate_matches_the_reference(ref_drivers):
    """m = 20, n = 10 selects QR by default; Speculate forces the
    certified CholQR2 rung (one refinement sweep recorded), which is
    accepted and matches lstsq and the reference."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((20, 10)), rng.standard_normal((20, 2))
    (X, h), (Xr, hr) = _gels(a, b, 8)
    assert (h.ok, h.iters) == (bool(hr.ok), int(hr.iters)) == (True, 1)
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)
    np.testing.assert_allclose(X.to_numpy(),
                               np.linalg.lstsq(a, b, rcond=None)[0],
                               rtol=1e-10, atol=1e-10)


def test_gels_speculate_illconditioned_escalates(ref_drivers):
    """cond(A)^2 beyond f64: the CholQR2 certificate fails and the QR
    fallback answers (no refinement recorded), as in the reference."""
    rng = np.random.default_rng(8)
    m, n = 20, 10
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (u * np.logspace(0, -12, n)) @ v.T
    b = rng.standard_normal((m, 2))
    (X, h), (Xr, hr) = _gels(a, b, 8)
    assert (h.ok, h.iters) == (bool(hr.ok), int(hr.iters)) == (True, 0)
    xref = np.linalg.lstsq(a, b, rcond=None)[0]
    resid = np.linalg.norm(a.T @ (a @ X.to_numpy() - b))
    assert resid < 1e-6 + 10 * np.linalg.norm(a.T @ (a @ xref - b))


@pytest.mark.parametrize("cond", [None, 1e6])
def test_gels_bf16_rung(ref_drivers, cond):
    """Speculate + Precision bf16 on f32 least squares: the bf16 QR rung
    (two CSNE sweeps recorded) is accepted on a well-conditioned A; at
    cond 1e5 the conditioning folded into its growth escalates it to the
    certified CholQR2 rung or past it, as the reference does."""
    rng = np.random.default_rng(9)
    m, n = 96, 32
    if cond is None:
        a = rng.standard_normal((m, n))
    else:
        u, _ = np.linalg.qr(rng.standard_normal((m, n)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a = (u * np.logspace(0, -np.log10(cond), n)) @ v.T
    a = a.astype(np.float32)
    b = rng.standard_normal((m, 2)).astype(np.float32)
    (X, h), (Xr, hr) = _gels(a, b, 32, Precision="bf16")
    assert (h.ok, h.iters, h.converged) == (bool(hr.ok), int(hr.iters),
                                            bool(hr.converged))
    if cond is None:
        assert h.iters == 2 and h.ok
        _close(X.to_numpy(), Xr.to_numpy(), np.float32)
    else:
        assert h.iters != 2


def test_gels_default_unchanged(ref_drivers):
    """Without Speculate the default heuristic still routes tall-skinny to
    CholQR and near-square to QR, matching lstsq either way."""
    rng = np.random.default_rng(10)
    for m, n in [(40, 8), (20, 16)]:
        a, b = rng.standard_normal((m, n)), rng.standard_normal((m, 2))
        X = st.gels(st.Matrix.from_numpy(a, 8, device="cpu"),
                    st.Matrix.from_numpy(b, 8, device="cpu"))
        np.testing.assert_allclose(X.to_numpy(),
                                   np.linalg.lstsq(a, b, rcond=None)[0],
                                   rtol=1e-9, atol=1e-9)


# ------------------------------------ the auxiliary drivers the rungs call

@pytest.mark.parametrize("norm", ["One", "Inf", "Max", "Fro"])
def test_norm_and_add_match_the_reference(norm):
    """drivers/auxiliary.py norm (general, Hermitian, unit triangular, a
    transposed view) and add (general and a lower triangle), and the band
    kernels of ops/norms.py, against the reference's on the same tiles."""
    import jax.numpy as jnp
    from slate_tpu.drivers import auxiliary as ref_aux
    from slate_tpu.ops import norms as ref_norms
    from slate_tpu_torch.drivers import auxiliary as aux
    from slate_tpu_torch.ops import norms
    rng = np.random.default_rng(11)
    a = rng.standard_normal((37, 29))
    sq = a[:29, :29].copy()
    nt, rt = getattr(st.Norm, norm), getattr(ref.Norm, norm)
    pairs = [
        (st.Matrix.from_numpy(a, 8, device="cpu"), ref.Matrix.from_numpy(a, 8)),
        (st.HermitianMatrix.from_numpy(sq, 8, device="cpu"),
         ref.HermitianMatrix.from_numpy(sq, 8)),
        (st.TriangularMatrix.from_numpy(sq, 8, diag=st.Diag.Unit,
                                        device="cpu"),
         ref.TriangularMatrix.from_numpy(sq, 8, diag=ref.Diag.Unit)),
        (st.Matrix.from_numpy(a, 8, device="cpu").transpose(),
         ref.Matrix.from_numpy(a, 8).transpose()),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(aux.norm(nt, got)),
                                   float(ref_aux.norm(rt, want)),
                                   rtol=1e-13)
    tiles = st.Matrix.from_numpy(sq, 8, device="cpu").storage.canonical()
    rtiles = jnp.asarray(tiles.numpy())
    np.testing.assert_allclose(
        float(norms.gb_norm(nt, tiles, 29, 29, 8, 8, 3, 5)),
        float(ref_norms.gb_norm(rt, rtiles, 29, 29, 8, 8, 3, 5)), rtol=1e-13)
    np.testing.assert_allclose(
        float(norms.hb_norm(nt, tiles, 29, 8, 4, True)),
        float(ref_norms.hb_norm(rt, rtiles, 29, 8, 4, True)), rtol=1e-13)
    b = rng.standard_normal((37, 29))
    got = aux.add(2.0, st.Matrix.from_numpy(a, 8, device="cpu"), -1.0,
                  st.Matrix.from_numpy(b, 8, device="cpu"))
    np.testing.assert_allclose(got.to_numpy(), 2 * a - b, rtol=1e-14)
    lo = aux.add(2.0, st.TriangularMatrix.from_numpy(sq, 8, device="cpu"),
                 1.0, st.TriangularMatrix.from_numpy(sq.T.copy(), 8,
                                                     device="cpu"))
    want = ref_aux.add(2.0, ref.TriangularMatrix.from_numpy(sq, 8), 1.0,
                       ref.TriangularMatrix.from_numpy(sq.T.copy(), 8))
    np.testing.assert_allclose(lo.storage.canonical().numpy(),
                               np.asarray(want.storage.canonical()),
                               rtol=1e-14)
