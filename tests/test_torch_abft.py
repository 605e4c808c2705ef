"""The port's Huang-Abraham checksum rungs (slate_tpu_torch.robust.abft and
Option.Abft in the drivers) against slate_tpu's, on the CPU.

The same numpy inputs, from a seed, go through both packages; counts,
``abft_site``, the escalation path and the strike positions are held
EXACT, solutions within 1e-5 relative in f32 and complex64 and 1e-12 in
f64 and complex128 (both sides solve the same bytes, sums in another
order). The cases mirror tests/test_abft.py: the primitives' single and
double strikes, tile targeting and a miss, gesv (NoPiv, PartialPiv, CALU)
and posv with clean, single, double and transient double strikes, gemm and
trsm without a false detection, and batch_potrf's in-batch counts. gesv
and gemm/trsm are in test_torch_abft_gesv.py, the shared inputs in
torch_abft_common.py. The reference's drivers are wrapped in
``@annotate``, which calls ``jax.core.trace_state_clean``; the installed
JAX no longer exports that name, so the ``ref_drivers`` fixture restores
it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import slate_tpu as ref
from slate_tpu.internal import batched as ref_batched
from slate_tpu.robust import abft as ref_abft
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch.internal import batched as bk
from slate_tpu_torch.robust import abft, faults

from torch_abft_common import (
    _close, _counts, _hpd, _info, _pair_sum_check, _posv_pair, _spd_stack, N,
    NB, ref_drivers)


@pytest.mark.parametrize("payload", [np.nan, np.inf, 2.0 ** 80])
def test_sum_check_clean_and_single_strike(payload):
    """A clean block reads no event; one struck element is located at its
    tile, repaired to the checksum's value, with the reference's counts."""
    a = np.random.default_rng(1).standard_normal((12, 8))
    (x, ev), (_, evr) = _pair_sum_check(a, a.sum(1), a.sum(0))
    assert [int(v) for v in ev] == [int(v) for v in evr] == [0, 0, -1]
    assert torch.equal(x, torch.from_numpy(a))
    bad = a.copy()
    bad[5, 3] = payload
    (x, ev), (xr, evr) = _pair_sum_check(bad, a.sum(1), a.sum(0), nb=4)
    assert [int(v) for v in ev] == [int(v) for v in evr] == [
        1, 1, int(abft.site_code(1, 0))]
    np.testing.assert_allclose(x.numpy(), a, rtol=0, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=0,
                               atol=1e-12)


def test_sum_check_refuses_double_strike():
    """Two struck elements: detected, not corrected, the data left as it
    was (never silently mangled), as the reference refuses them."""
    a = np.random.default_rng(2).standard_normal((12, 8))
    bad = a.copy()
    bad[2, 1] = bad[7, 5] = np.nan
    (x, ev), (_, evr) = _pair_sum_check(bad, a.sum(1), a.sum(0))
    assert [int(v) for v in ev] == [int(v) for v in evr]
    assert (int(ev.detected), int(ev.corrected)) == (1, 0)
    assert np.isnan(x[2, 1].item()) and np.isnan(x[7, 5].item())


def test_tile_sum_check_locates_struck_tile():
    a = np.random.default_rng(3).standard_normal((3, 2, 4, 4))
    bad = a.copy()
    bad[2, 1, 0, 3] = 2.0 ** 90
    t4, ev, ti, tj = abft.tile_sum_check(
        torch.from_numpy(bad.copy()), torch.from_numpy(a.sum(3)),
        torch.from_numpy(a.sum(2)))
    _, evr, tir, tjr = ref_abft.tile_sum_check(
        jnp.asarray(bad), jnp.asarray(a.sum(3)), jnp.asarray(a.sum(2)))
    assert (int(ti), int(tj)) == (int(tir), int(tjr)) == (2, 1)
    assert [int(v) for v in ev] == [int(v) for v in evr]
    assert (int(ev.detected), int(ev.corrected)) == (1, 1)
    np.testing.assert_allclose(t4.numpy(), a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("payload", [np.nan, np.inf, 2.0 ** 80])
def test_left_product_check_payloads(payload):
    """nan, inf and bitflip payloads in X of L X = R: located at (4, 2)
    and rebuilt from R's checksums, as the reference does."""
    rng = np.random.default_rng(4)
    m, ncol = 8, 6
    lmat = np.tril(rng.standard_normal((m, m))) + m * np.eye(m)
    x = rng.standard_normal((m, ncol))
    r = lmat @ x
    bad = x.copy()
    bad[4, 2] = payload
    got = abft.left_product_check(
        torch.from_numpy(lmat), torch.from_numpy(bad),
        torch.from_numpy(r.sum(1)), torch.from_numpy(r.sum(0)), unit=False)
    want = ref_abft.left_product_check(
        jnp.asarray(lmat), jnp.asarray(bad), jnp.asarray(r.sum(1)),
        jnp.asarray(r.sum(0)), unit=False)
    assert [int(v) for v in got[1:]] == [int(v) for v in want[1:]] == [
        1, 1, 4, 2]
    np.testing.assert_allclose(got[0].numpy(), x, rtol=0, atol=1e-12)


@pytest.mark.parametrize("where", [(10, 3), (2, 5), (3, 3)])
def test_lu_panel_and_chol_tile_checks_match_the_reference(where):
    """A bitflip in L (below the diagonal), in U and on U's diagonal of a
    packed LU panel, and at the same places of a Cholesky tile: the same
    detection, correction and location as the reference's."""
    import scipy.linalg as sl
    rng = np.random.default_rng(5)
    M, w = 24, 8
    pan = rng.standard_normal((M, w))
    P, L, U = sl.lu(pan)
    perm = np.argmax(P, axis=0)
    lu = np.tril(L, -1)[:, :w] + np.vstack([U, np.zeros((M - w, w))])
    bad = lu.copy()
    bad[where] *= 2.0 ** 100
    got = abft.lu_panel_check(torch.from_numpy(pan), torch.from_numpy(bad),
                              torch.from_numpy(perm))
    want = ref_abft.lu_panel_check(jnp.asarray(pan), jnp.asarray(bad),
                                   jnp.asarray(perm))
    assert [int(v) for v in got[1:]] == [int(v) for v in want[1:]] == [
        1, 1, *where]
    np.testing.assert_allclose(got[0].numpy(), lu, rtol=0, atol=1e-12)
    i, j = where[0] % w, where[1]
    g = rng.standard_normal((w, w))
    h = g @ g.T + w * np.eye(w)
    lo = np.linalg.cholesky(h)
    badc = lo.copy()
    badc[max(i, j), min(i, j)] *= 2.0 ** 100
    gc = abft.chol_tile_check(torch.from_numpy(h), torch.from_numpy(badc))
    wc = ref_abft.chol_tile_check(jnp.asarray(h), jnp.asarray(badc))
    assert [bool(v) for v in gc[1:]] == [bool(v) for v in wc[1:]] == [
        True, True]
    np.testing.assert_allclose(gc[0].numpy(), lo, rtol=0, atol=1e-12)


def test_fault_tile_targeting_and_miss():
    """A tile-confined strike lands inside its tile on 2D, 3D and 4D
    arrays at the reference's element; an out-of-range tile is a miss."""
    cases = [((12, 16), dict(site="input", kind="nan", tile=(1, 2), nb=4)),
             ((2, 3, 4, 4), dict(site="input", kind="inf", tile=(0, 1))),
             ((3, 8, 4), dict(site="input", kind="nan", tile=(2, 0),
                              seed=9)),
             ((12, 16), dict(site="input", kind="nan", tile=(9, 0), nb=4))]
    for shape, kw in cases:
        got = faults.corrupt(torch.zeros(shape), faults.FaultPlan(**kw))
        want = np.asarray(ref_faults.corrupt(
            jnp.zeros(shape), ref_faults.FaultPlan(**kw)))
        np.testing.assert_array_equal(~torch.isfinite(got).numpy(),
                                      ~np.isfinite(want))
    y = faults.corrupt(torch.zeros(12, 16), faults.FaultPlan(**cases[0][1]))
    rows, cols = np.nonzero(np.isnan(y.numpy()))
    assert len(rows) == 1 and 4 <= rows[0] < 8 and 8 <= cols[0] < 12
    assert torch.isfinite(faults.corrupt(
        torch.zeros(12, 16), faults.FaultPlan(**cases[3][1]))).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex64,
                                   np.complex128])
def test_posv_abft_clean_zero_counters(ref_drivers, dtype):
    a, b = _hpd(20, dtype=dtype)
    if np.iscomplexobj(a):
        g = np.random.default_rng(21).standard_normal((N, N)) * 0.1
        a = a + 1j * (g - g.T)
    (_, X, h), (_, Xr, hr) = _posv_pair(a.astype(dtype), b)
    assert _counts(h) == _counts(hr) == (0, 0, -1) and h.ok
    _close(X.to_numpy(), Xr.to_numpy(), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["nan", "inf", "bitflip"])
def test_posv_transient_strike_corrected(ref_drivers, kind, dtype):
    """One transient strike in the first diagonal tile's factor (seed 7:
    element (30, 7)): repaired in place with the reference's counts and
    site; in f32 the port's panel step is K2's (its plain version here),
    in f64 the library's."""
    a, b = _hpd(22, dtype=dtype)
    plan = dict(site="post_panel", kind=kind, seed=7, transient=True)
    (_, X, h), (_, Xr, hr) = _posv_pair(a, b, [plan])
    assert _counts(h) == _counts(hr) == (1, 1, 0)
    assert h.ok
    _close(X.to_numpy(), Xr.to_numpy(), dtype)


def test_posv_transient_double_strike_retries_cholesky(ref_drivers):
    """posv's retry rung keeps the CHOLESKY factor (no hesv escalation,
    which the port does not carry): the factor stays triangular."""
    a, b = _hpd(24)
    # seed 0 strikes (27, 6) and (20, 12) of the first 32 x 32 tile
    plan = dict(site="post_panel", kind="bitflip", seed=0, count=2,
                transient=True)
    (F, X, h), (Fr, Xr, hr) = _posv_pair(a, b, [plan],
                                         UseFallbackSolver=True)
    assert h.ok and isinstance(F, st.TriangularMatrix)
    assert _counts(h) == _counts(hr) == (0, 0, -1)
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)
    with faults.inject(faults.FaultPlan(**plan)):
        _, _, h0 = st.posv(st.HermitianMatrix.from_numpy(a, NB, device="cpu"),
                           st.Matrix.from_numpy(b, NB, device="cpu"),
                           _info(st, UseFallbackSolver=False))
    assert not h0.ok and h0.abft_detected > h0.abft_corrected


def test_posv_input_and_solve_sites(ref_drivers):
    """The input and solve sites strike where the reference's do: a NaN in
    A's dense copy fails the factor, one in X the solution, alike."""
    a, b = _hpd(25)
    for site in ("input", "solve"):
        # seed 0 strikes (81, 63): below the diagonal, where both read A
        plan = dict(site=site, kind="nan", seed=0)
        (_, X, h), (_, Xr, hr) = _posv_pair(a, b, [plan],
                                            UseFallbackSolver=False)
        assert (h.ok, h.nonfinite) == (bool(hr.ok), bool(hr.nonfinite))
        np.testing.assert_array_equal(np.isnan(X.to_numpy()),
                                      np.isnan(Xr.to_numpy()))


@pytest.mark.parametrize("upper", [False, True])
def test_checked_trsm_repairs_a_struck_solution(upper, monkeypatch):
    """The checked block solve repairs one corrupted element of X (struck
    between the solve and its check, the spot a fault in the last block's
    product would leave), for the lower and the index-reversed upper
    case, as the reference's _checksum_repair does."""
    from slate_tpu.internal import trsm as ref_trsm
    from slate_tpu_torch.internal import trsm as it
    rng = np.random.default_rng(31)
    n = 96
    a = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    if upper:
        a = a.T.copy()
    b = rng.standard_normal((n, 4))
    kw = dict(lower=not upper, trans=False, conj=False, unit=False, nb=32)
    clean = it.trsm_left_blocked(torch.from_numpy(a), torch.from_numpy(b),
                                 **kw)
    real = it._checksum_repair

    def strike(a_op, x, bd, **k):
        x = x.clone()
        x[40, 1] *= 2.0 ** 100
        return real(a_op, x, bd, **k)
    monkeypatch.setattr(it, "_checksum_repair", strike)
    got = it.trsm_left_blocked(torch.from_numpy(a), torch.from_numpy(b),
                               check=True, **kw)
    np.testing.assert_allclose(got.numpy(), clean.numpy(), rtol=0,
                               atol=1e-12)
    want = ref_trsm.trsm_left_blocked(jnp.asarray(a), jnp.asarray(b),
                                      check=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("plan", [
    None,
    # seeds whose strikes land in problem 1's diagonal tile (row 30,
    # column 9), below it (row 54), and twice below it
    dict(site="post_panel", kind="bitflip", seed=1, transient=True,
         tile=(1, 0)),
    dict(site="post_panel", kind="nan", seed=0, transient=True,
         tile=(2, 0)),
    dict(site="post_panel", kind="bitflip", seed=0, count=2,
         transient=True, tile=(1, 0)),
])
def test_batch_potrf_abft_counts_match_the_reference(plan):
    """batch_potrf(abft=True) over sizes 64, 40, 64 and a filler slot: the
    per-problem counts and sites equal the reference's (its Pallas K6 in
    interpret mode) with no strike, a transient bitflip or NaN in one
    problem's first step (the strike lands on that problem only, its
    neighbours' factors bit-equal to the clean run's), and a double
    strike refused; without abft the counts are zero."""
    n, nb, sizes = 64, 32, [64, 40, 64, 0]
    a = _spd_stack(40, n, sizes)
    sz = torch.tensor(sizes, dtype=torch.int32)
    clean, c0 = bk.batch_potrf(torch.from_numpy(a), sz, nb=nb, bw=8)
    assert [c.tolist() for c in c0] == [[0] * 4, [0] * 4, [-1] * 4]
    plans = [] if plan is None else [plan]
    with faults.inject(*[faults.FaultPlan(**p) for p in plans]):
        fa, counts = bk.batch_potrf(torch.from_numpy(a), sz, nb=nb, bw=8,
                                    abft=True)
    with ref_faults.inject(*[ref_faults.FaultPlan(**p) for p in plans]):
        _, rc = ref_batched.batch_potrf(jnp.asarray(a),
                                        jnp.asarray(sizes, jnp.int32),
                                        nb=nb, bw=8, interpret=True,
                                        abft=True)
    for got, want in zip(counts, rc):
        assert got.tolist() == np.asarray(want).tolist()
    hit = None if plan is None else plan["tile"][0]
    for p in range(len(sizes)):
        if p != hit:
            assert torch.equal(fa[p], clean[p])
    if plan is not None and plan.get("count", 1) == 1:
        assert counts.detected[hit] == counts.corrected[hit] == 1
        np.testing.assert_allclose(torch.tril(fa[hit]).numpy(),
                                   torch.tril(clean[hit]).numpy(),
                                   rtol=0, atol=1e-5)


def test_abft_posv_reads_the_device_once_at_the_boundary(monkeypatch):
    """The checksum rungs never read a device value to the host, nor copy
    a host value to the device (on the card both wait for the device): an
    Abft posv at n = 256 makes exactly as many host reads (Tensor.item,
    __bool__, __int__, __float__, __index__, tolist) and host-to-tensor
    copies (torch.tensor, torch.as_tensor) as the same posv with Abft
    off, at 4 and at 8 panels alike."""
    import slate_tpu_torch.drivers.cholesky  # noqa: F401 (import first)
    reads = {"n": 0}

    def counted(real):
        def spy(*args, **kw):
            reads["n"] += 1
            return real(*args, **kw)
        return spy
    for name in ("item", "__bool__", "__int__", "__float__", "__index__",
                 "tolist"):
        monkeypatch.setattr(torch.Tensor, name,
                            counted(getattr(torch.Tensor, name)))
    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, counted(getattr(torch, name)))
    a, b = _hpd(50, n=256, dtype=np.float32)
    seen = {}
    for nb in (32, 64):
        for on in (False, True):
            A = st.HermitianMatrix.from_numpy(a, nb, device="cpu")
            B = st.Matrix.from_numpy(b, nb, device="cpu")
            o = {st.Option.ErrorPolicy: "info",
                 st.Option.Abft: "on" if on else "off"}
            reads["n"] = 0
            _, _, h = st.posv(A, B, o)
            seen[nb, on] = reads["n"]
            assert h.ok and h.abft_detected == 0
    assert seen[32, True] == seen[32, False]
    assert seen[64, True] == seen[64, False]


@pytest.mark.parametrize("plan", [
    None,
    # persistent (the reference's vmapped cores take no transient plan:
    # its host callback cannot sit under vmap-of-cond): problem 1 struck
    # in every step of the batch; nb sizes the tile on the 2D panels of
    # the safe rung that the reference traces beside it, where it misses
    dict(site="post_panel", kind="bitflip", seed=1, tile=(1, 0), nb=64),
])
def test_served_chol_solve_under_abft_matches_the_reference(ref_drivers,
                                                            plan):
    """make_batched("chol_solve") under Abft stays on the ragged route (K6
    with the in-batch rungs) in both packages: per-problem counts, sites,
    health and escalation flags equal the reference's on its Pallas route,
    clean and with problem 1 struck at every step; solve under Abft leaves
    the ragged route (the per-problem drivers carry the rungs)."""
    import contextlib
    from slate_tpu import serve as ref_serve
    from slate_tpu.tune import TilePlan as RefPlan
    from slate_tpu.tune import plan_override as ref_override
    from slate_tpu_torch.convert import health_from_jax
    from slate_tpu_torch.serve import batched as sb
    rng = np.random.default_rng(60)
    nb, sizes = 64, [64, 40, 17, 0]
    a = np.zeros((4, nb, nb), np.float32)
    b = rng.standard_normal((4, nb, 2)).astype(np.float32)
    for i, s in enumerate(sizes):
        a[i] = np.eye(nb)
        if s:
            g = rng.standard_normal((s, s))
            a[i, :s, :s] = g @ g.T / s + np.eye(s)
        b[i, s:] = 0
    sz = np.asarray(sizes, np.int32)
    on = {st.Option.Abft: st.Abft.On}
    plans = [] if plan is None else [plan]
    with faults.inject(*[faults.FaultPlan(**p) for p in plans]):
        x, h, esc = sb.make_batched("chol_solve", on)(
            torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(sz))
    with contextlib.ExitStack() as stack:
        stack.enter_context(ref_override("batch_potrf",
                                         RefPlan("pallas", 32, 8)))
        stack.enter_context(ref_faults.inject(
            *[ref_faults.FaultPlan(**p) for p in plans]))
        rx, rh, resc = jax.jit(ref_serve.make_batched(
            "chol_solve", {ref.Option.Abft: "on"}))(a, b, sz)
    rh = health_from_jax(rh)
    assert esc == np.asarray(resc).tolist()
    for i in range(4):
        assert (h[i].abft_detected, h[i].abft_corrected, h[i].abft_site,
                h[i].ok) == (rh[i].abft_detected, rh[i].abft_corrected,
                             rh[i].abft_site, rh[i].ok)
        _close(x[i].numpy(), np.asarray(rx[i]), np.float32)
    if plan is not None:
        assert h[1].abft_detected == h[1].abft_corrected >= 1
    assert sb._ragged_plan("solve", torch.from_numpy(a), on) is None
