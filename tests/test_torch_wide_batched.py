"""The serving route at the tuned plan's width against slate_tpu on the CPU:
``_ragged_plan`` takes nb = min(plan.nb, bucket) by the reference's rule,
the ragged batched drivers (internal/batched.py) at nb = 256 and 512 on
K6-K8's plain versions against the reference's Pallas kernels in
interpret mode, and ``make_batched`` at bucket 512 under a 256-wide plan
against the reference forced onto its Pallas plan at that width.

The port's CPU route asks each batch kernel's gate through its mirror
(``batched_width_ok``), so a width the card's kernel refuses goes per
problem on both devices; where the reference takes such a width on its
CPU interpret route, the port departs on purpose (ROADMAP.md, queue 3).
The reference's drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from slate_tpu import serve as ref_serve
from slate_tpu.internal import batched as ref_batched
from slate_tpu.serve import batched as ref_sb
from slate_tpu.tune import TilePlan as RefPlan
from slate_tpu.tune import plan_override as ref_override

import slate_tpu_torch as st
from slate_tpu_torch import serve
from slate_tpu_torch.convert import health_from_jax
from slate_tpu_torch.internal import batched as bk
from slate_tpu_torch.internal import chol_kernels as ck
from slate_tpu_torch.internal import lu_kernels as lk
from slate_tpu_torch.internal import qr_kernels as qk
from slate_tpu_torch.serve import batched as sb
from slate_tpu_torch.tune import plans

# f32 parity, as tests/test_torch_batched.py and test_torch_serve.py hold
# it: both sides factor the same bytes with the same algorithm, sums in
# another order (the reference inverts U by its nilpotent series, the
# plain versions by K0's doubling); on the well-conditioned stacks below
# the results agree to a few 1e-6 of their largest entry, held at 1e-4.
F32_RTOL = 1e-4
OPS = ("solve", "chol_solve", "least_squares_solve")
N = 512                       # the bucket of the driver and make_batched tests


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


@pytest.fixture
def empty_plans(tmp_path, monkeypatch):
    """The port's plan cache pointed at an empty file: the default plans."""
    monkeypatch.setenv("SLATE_TORCH_TUNE_CACHE", str(tmp_path / "p.json"))
    plans.reload()
    yield
    plans.reload()


@contextlib.contextmanager
def both_plans(op, nb, bw=8):
    """The op's batch kernel forced onto the hand kernel at (nb, bw) in the
    port and onto the Pallas kernel at the same width in the reference."""
    key = sb.RAGGED_OPS[op]
    with st.plan_override(key, st.TilePlan("cuda", bw, nb)), \
            ref_override(key, RefPlan("pallas", nb, bw)):
        yield


def routes(op, n):
    """(the port's, the reference's) routing of a bucket of edge n: (nb,
    bw) of the ragged route, or None for the per-problem one."""
    shape = (2, 2 * n, n) if op == "least_squares_solve" else (2, n, n)
    got = sb._ragged_plan(op, torch.zeros(shape), None)
    ref = ref_sb._ragged_plan(op, jnp.zeros(shape, jnp.float32), None)
    return (None if got is None else (got.nb, got.bw),
            None if ref is None else (int(ref.nb), int(ref.bw)))


def _close(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=F32_RTOL * max(np.abs(want[fin]).max(
                                   initial=0.0), 1.0))


# --------------------------------------------------------- the routing


ROUTE_CASES = [
    (op, nb, bw, n, want)
    for op in OPS
    for nb, bw, n, want in (
        (32, 8, 64, 32),          # the fault: the port took min(128, 64)
        (256, 8, 512, 256),
        (512, 8, 384, 384),       # min(plan.nb, bucket)
        (512, 8, 768, None),      # a tuned ladder's 768 rung: 768 % 512
    )
] + [(op, 256, 16, 512, 256) for op in ("solve", "chol_solve")]  # bw kept


@pytest.mark.parametrize("op,nb,bw,n,want", ROUTE_CASES)
def test_ragged_plan_takes_the_plans_width_as_the_reference(op, nb, bw, n,
                                                            want):
    with both_plans(op, nb, bw):
        got, ref = routes(op, n)
    assert got == ref == (None if want is None else (want, bw))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", [64, 128, 512])
def test_default_plan_keeps_min_128_and_the_bucket(empty_plans, op, n):
    """The untuned route does not move: the default plan's nb is 128, so
    the port takes min(128, bucket), as the reference does under a
    128-wide Pallas plan (its own default is the vmapped XLA cores)."""
    got = routes(op, n)[0]
    with ref_override(sb.RAGGED_OPS[op], RefPlan("pallas", 128, 8)):
        ref = routes(op, n)[1]
    assert got == ref == (min(128, n), 8)


@pytest.mark.parametrize("op,nb,bw,n", [
    ("chol_solve", 192, 8, 384),     # K6, K7: 32-column blocks up to 128,
    ("solve", 160, 8, 320),          # then 256, 384, 512 alone
    ("chol_solve", 16, 8, 32),
    ("solve", 384, 12, 768),         # K7 past 128: a slab inside 128
    ("least_squares_solve", 192, 8, 384),   # K8: w <= 128 or 256-512
    ("least_squares_solve", 256, 16, 512),  # K8: its slab sums, bw <= 8
])
def test_the_mirror_routes_what_the_card_refuses_per_problem(op, nb, bw, n):
    """A width the reference's rule takes but the card's kernel refuses
    goes per problem on the CPU too: the mirror answers as the kernel."""
    with both_plans(op, nb, bw):
        got, ref = routes(op, n)
    assert ref == (nb, bw) and got is None
    if op == "least_squares_solve":
        assert not qk.batched_width_ok(2 * n, nb, bw)
    else:
        mod = ck if op == "chol_solve" else lk
        assert not mod.batched_width_ok(nb, bw)


def test_batch_width_mirrors():
    """The mirrors' widths, as the kernels' gates state them (the card's
    test holds them equal to the kernels' answers at every width)."""
    widths = (32, 64, 96, 128, 256, 384, 512)
    assert [nb for nb in range(1, 600) if ck.batched_width_ok(nb, 8)] == \
        list(widths)
    assert [nb for nb in range(1, 600) if lk.batched_width_ok(nb, 8)] == \
        list(widths)
    assert ck.batched_width_ok(384, 12) and not lk.batched_width_ok(384, 12)
    assert lk.batched_width_ok(96, 12) and lk.batched_width_ok(256, 16)
    assert [w for w in range(1, 600) if qk.batched_width_ok(1024, w, 8)] \
        == list(range(1, 129)) + [256, 384, 512]
    assert not qk.batched_width_ok(300, 384, 8)
    assert not qk.batched_width_ok(1024, 128, 9)


# ------------------------------------- the ragged drivers at 256 and 512


SIZES = [N, 300, 0]            # a full problem, a ragged one, a filler slot


def _spd_stack(rng, sizes):
    """Identity-augmented SPD slots [B, N, N] (serve pad_square packing; a
    filler slot is the identity)."""
    a = np.zeros((len(sizes), N, N), np.float32)
    for i, s in enumerate(sizes):
        g = rng.standard_normal((s, s)).astype(np.float32)
        a[i, :s, :s] = g @ g.T / max(s, 1) + np.eye(s, dtype=np.float32)
        a[i, np.arange(s, N), np.arange(s, N)] = 1.0
    return a


def _dd_stack(rng, sizes):
    """Identity-augmented diagonally dominant slots (NoPiv-LU-safe)."""
    a = np.zeros((len(sizes), N, N), np.float32)
    for i, s in enumerate(sizes):
        g = rng.standard_normal((s, s)).astype(np.float32)
        a[i, :s, :s] = g / np.float32(np.sqrt(max(s, 1))) + 4 * np.eye(
            s, dtype=np.float32)
        a[i, np.arange(s, N), np.arange(s, N)] = 1.0
    return a


def _padding_exact(fa, a, sizes):
    for i, s in enumerate(sizes):
        np.testing.assert_array_equal(np.asarray(fa[i, s:]), a[i, s:])
        np.testing.assert_array_equal(np.asarray(fa[i, :, s:]), a[i, :, s:])


@pytest.mark.parametrize("nb", [256, 512])
def test_batch_potrf_and_getrf_at_the_wide_widths(nb):
    """batch_potrf and batch_getrf (K6's and K7's plain versions, nb-wide
    steps) against the reference on its Pallas kernels at the same nb;
    the padding region and the filler slot exactly the input; the
    healths field for field."""
    rng = np.random.default_rng(nb)
    sz = torch.tensor(SIZES, dtype=torch.int32)
    jsz = jnp.asarray(SIZES, jnp.int32)
    a = _spd_stack(rng, SIZES)
    fa, _ = bk.batch_potrf(torch.from_numpy(a), sz, nb=nb, bw=8)
    ref, _ = ref_batched.batch_potrf(jnp.asarray(a), jsz, nb=nb, bw=8,
                                     interpret=True)
    _close(torch.tril(fa), np.tril(np.asarray(ref)))
    _padding_exact(fa, a, SIZES)
    for h, w in zip(bk.batch_chol_health(fa), health_from_jax(
            ref_batched.batch_chol_health(ref))):
        assert (h.ok, h.info, h.min_pivot_index) == \
            (w.ok, w.info, w.min_pivot_index)
        np.testing.assert_allclose(h.min_pivot, w.min_pivot, rtol=1e-3)
    a = _dd_stack(rng, SIZES)
    fa = bk.batch_getrf(torch.from_numpy(a), sz, nb=nb, bw=8)
    ref = ref_batched.batch_getrf(jnp.asarray(a), jsz, nb=nb, bw=8,
                                  interpret=True)
    _close(fa, ref)
    _padding_exact(fa, a, SIZES)
    for h, w in zip(bk.batch_lu_health(torch.from_numpy(a), fa),
                    health_from_jax(ref_batched.batch_lu_health(
                        jnp.asarray(a), ref))):
        assert (h.ok, h.info, h.min_pivot_index) == \
            (w.ok, w.info, w.min_pivot_index)
        np.testing.assert_allclose(h.growth, w.growth, rtol=1e-3)


@pytest.mark.parametrize("nb", [256, 512])
def test_batch_geqrf_and_gels_at_the_wide_widths(nb):
    """batch_geqrf's packed factors and T stack (K8's plain version on
    nb-wide panels, K5's wide blocking) and batch_gels' x against the
    reference at the same nb, through the serving packing (a tall problem
    augmented with identity rows, a full one, a filler slot bit-equal to
    its input)."""
    rng = np.random.default_rng(nb + 1)
    mb = 2 * N
    a = np.zeros((3, mb, N), np.float32)
    b = np.zeros((3, mb, 2), np.float32)
    rows = []
    for i, (m, n) in enumerate([(mb, N), (600, 300), (0, 0)]):
        if m == 0:
            a[i, :N, :N] = np.eye(N, dtype=np.float32)
            rows.append(0)
            continue
        a[i, :m, :n] = rng.standard_normal((m, n))
        a[i, m:m + N - n, n:] = np.eye(N - n, dtype=np.float32)
        b[i, :m] = rng.standard_normal((m, 2))
        rows.append(m + N - n)
    rt, jr = torch.tensor(rows, dtype=torch.int32), jnp.asarray(rows,
                                                                jnp.int32)
    packed, ts = bk.batch_geqrf(torch.from_numpy(a), rt, nb=nb, bw=8)
    rp, rts = ref_batched.batch_geqrf(jnp.asarray(a), jr, nb=nb,
                                      interpret=True)
    assert ts.shape == rts.shape == (3, N // nb, nb, nb)
    _close(packed, rp)
    _close(ts, rts)
    np.testing.assert_array_equal(packed[2].numpy(), a[2])
    assert not ts[2].any()
    x, _ = bk.batch_gels(torch.from_numpy(a), torch.from_numpy(b), rt,
                         nb=nb, bw=8)
    rx, _ = ref_batched.batch_gels(jnp.asarray(a), jnp.asarray(b), jr,
                                   nb=nb, interpret=True)
    _close(x, rx)


# --------------------------------------------------- make_batched at 256


def _problem(rng, op, n, bad):
    """One request: solve A = G / sqrt(n) + 4 I (a zero leading pivot when
    ``bad``), chol_solve A = G G^T / n + I (when ``bad``, its leading
    entry negated: indefinite, its first pivot fails, and the LU rung it
    escalates to solves a system of cond ~ 5, so that both packages' f32
    LU solutions meet the tolerance), least squares a Gaussian [2n, n] (a
    zero column when ``bad``)."""
    g = rng.standard_normal((n, n)).astype(np.float32)
    if op == "solve":
        a = g / np.float32(np.sqrt(n)) + 4 * np.eye(n, dtype=np.float32)
        if bad:
            a[0, 0] = 0.0
    elif op == "chol_solve":
        a = g @ g.T / n + np.eye(n, dtype=np.float32)
        if bad:
            a[0, 0] = -a[0, 0]
    else:
        a = rng.standard_normal((2 * n, n)).astype(np.float32)
        if bad:
            a[:, 1] = 0.0
    b = rng.standard_normal((a.shape[0], 2)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("op", OPS)
def test_make_batched_at_the_tuned_width_matches_the_reference(ref_drivers,
                                                               op):
    """A bucket-512 batch (sizes 512, 300 with a planted failure, and a
    filler slot) on the port's ragged route under a 256-wide plan against
    the reference forced onto its Pallas plan at 256: x, the health field
    for field and the escalation flags (the planted failure escalates)."""
    rng = np.random.default_rng(20 + len(op))
    lsq = op == "least_squares_solve"
    mb = 2 * N if lsq else N
    a = np.zeros((3, mb, N), np.float32)
    b = np.zeros((3, mb, 2), np.float32)
    live = []
    for i, s in enumerate(SIZES):
        if not s:
            a[i, :N, :N] = np.eye(N, dtype=np.float32)
            live.append(0)
            continue
        ai, bi = _problem(rng, op, s, bad=i == 1)
        pad = serve.pad_tall if lsq else serve.pad_square
        a[i] = (pad(torch.from_numpy(ai), mb, N) if lsq
                else pad(torch.from_numpy(ai), N)).numpy()
        b[i] = serve.pad_rows(torch.from_numpy(bi), mb, 2).numpy()
        live.append(ai.shape[0] + N - s if lsq else s)
    sizes = np.asarray(live, np.int32)
    with both_plans(op, 256):
        assert routes(op, N) == ((256, 8), (256, 8))
        x, h, esc = sb.make_batched(op)(torch.from_numpy(a),
                                        torch.from_numpy(b),
                                        torch.from_numpy(sizes))
        rx, rh, resc = jax.jit(ref_serve.make_batched(op))(a, b, sizes)
    rh = health_from_jax(rh)
    assert esc == np.asarray(resc).tolist() == [False, True, False]
    for i in range(3):
        if not (lsq and i == 1):
            _close(x[i], rx[i])          # (the zero column's x is R^-1 junk)
        assert (h[i].ok, h[i].nonfinite, h[i].info, h[i].iters,
                h[i].converged) == (rh[i].ok, rh[i].nonfinite, rh[i].info,
                                    rh[i].iters, rh[i].converged)
        for g, w in ((h[i].min_pivot, rh[i].min_pivot),
                     (h[i].growth, rh[i].growth)):
            if np.isfinite(w):
                np.testing.assert_allclose(g, w, rtol=1e-3)
            else:
                assert not np.isfinite(g)
