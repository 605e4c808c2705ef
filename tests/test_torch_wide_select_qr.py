"""K4 and K5 at the reference's wide widths, against its Pallas kernels.

K4 (lu_select) takes chunks of nb = 256, 384 and 512 columns and K5
(qr_panel) panels of w = 256, 384 and 512 columns: the widths the
reference's gates give lu_select_pallas and qr_panel_pallas
(slate_tpu/internal/getrf.py:187-197, qr.py:164-171).  Past 128 columns
both kernels work by 128-column blocks, and so do their plain versions,
which the wrappers run on the CPU; here they are held against the
reference's Pallas kernels run as its own tests run them
(``interpret=True``) on the same numpy inputs, and the port's CALU gesv and
QR gels at nb = 256 against the reference's drivers forced onto those
kernels.  The CUDA kernels at these widths run only on the card
(tests/test_torch_cuda.py, the ``wide_select`` and ``wide_qr`` tests).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import slate_tpu as ref
from slate_tpu.internal import qr as rq
from slate_tpu.internal.pallas_lu import lu_select_pallas
from slate_tpu.internal.pallas_qr import qr_panel_pallas
from slate_tpu.tune import TilePlan as RefPlan
from slate_tpu.tune import plan_override as ref_override

import slate_tpu_torch as st
from slate_tpu_torch.internal import getrf as ig
from slate_tpu_torch.internal import lu_kernels as lk
from slate_tpu_torch.internal import qr as iq
from slate_tpu_torch.internal import qr_kernels as qk


def _gauss(seed, m, n):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


@pytest.mark.parametrize("w,nb,nrows", [
    (512, 256, None), (768, 384, None), (1024, 512, None), (1024, 256, 700)])
def test_wide_k4_plain_selects_the_pallas_kernels_rows(w, nb, nrows):
    """Exact indices: on tie-free Gaussian rows the block-wise plain
    version, lu_select_pallas and (all rows live) lax.linalg.lu's partial
    pivoting pick the same rows in the same order; with 700 live rows of
    1024 no dead row is chosen."""
    x = _gauss(w + nb + (nrows or 0), w, nb)
    got = lk.lu_select(torch.from_numpy(x)[None], nrows=nrows)[0].numpy()
    want = np.asarray(lu_select_pallas(
        jnp.asarray(x), None if nrows is None else jnp.int32(nrows), bw=8,
        interpret=True))
    np.testing.assert_array_equal(got, want)
    if nrows is None:
        _, _, perm = jax.lax.linalg.lu(jnp.asarray(x))
        np.testing.assert_array_equal(got, np.asarray(perm)[:nb])
    else:
        assert got.max() < nrows and len(set(got.tolist())) == nb


def test_wide_k4_batch_equals_each_chunk_alone():
    """One round of three 512-row chunks at nb = 256 with ragged live-row
    counts: each chunk's rows in the batch are those it gets alone."""
    x = torch.from_numpy(np.stack([_gauss(60 + g, 512, 256)
                                   for g in range(3)]))
    nrows = torch.tensor([512, 300, 400], dtype=torch.int32)
    got = lk.lu_select(x, nrows=nrows)
    for g in range(3):
        alone = lk.lu_select(x[g:g + 1], nrows=int(nrows[g]))[0]
        assert torch.equal(got[g], alone)
        assert int(got[g].max()) < int(nrows[g])


@pytest.mark.parametrize("m,w", [(1024, 256), (768, 384), (1024, 512),
                                 (1000, 256)])
def test_wide_k5_plain_matches_the_pallas_kernel(m, w):
    """The block-wise plain version against qr_panel_pallas (the reference's
    column loop over the whole panel) with test_pallas.py's tolerances
    (packed 1e-5, T rtol 1e-4 / atol 1e-5), and Q R = A through the
    compact WY (1e-4), at the three wide widths and a ragged mm (1000: no
    multiple of 128 or of a slab)."""
    a = _gauss(m + w, m, w)
    packed, T = (t.numpy() for t in qk.qr_panel(torch.from_numpy(a)))
    pp, pt = qr_panel_pallas(jnp.asarray(a), interpret=True)
    np.testing.assert_allclose(packed, np.asarray(pp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(T, np.asarray(pt), rtol=1e-4, atol=1e-5)
    V = np.asarray(rq.unit_lower(jnp.asarray(packed)))
    Q = np.eye(m, dtype=np.float32) - V @ T @ V.T
    R = np.concatenate([np.triu(packed[:w]), np.zeros((m - w, w),
                                                       np.float32)])
    np.testing.assert_allclose(Q @ R, a, rtol=1e-4, atol=1e-4)


def test_wide_gates_follow_the_kernels_widths():
    """On the CPU the tournament's gate mirrors K4's widths (nb up to 128,
    then 256, 384, 512; nothing between or past); K5's gate takes the wide
    panels within the 2^20-element cap on both devices, and refuses one
    past it (the card's refusals of w = 129 and 640 are the kernel's, in
    tests/test_torch_cuda.py)."""
    for nb in (256, 384, 512):
        assert ig._lu_select_ok(torch.zeros((2, 2 * nb, nb)), nb)
        assert lk.select_width_ok(nb, 8)
    for nb in (200, 640, 1024):
        assert not ig._lu_select_ok(torch.zeros((2, 2 * nb, nb)), nb)
    assert not lk.select_width_ok(384, 3)       # 128 % 3: a slab would
    assert lk.select_width_ok(96, 3)            # straddle two blocks
    for mm, w in ((4096, 256), (2048, 512), (2730, 384)):
        assert iq._qr_panel_ok(torch.zeros((mm, w)))
    assert not iq._qr_panel_ok(torch.zeros((4097, 256)))  # past 2^20
    assert not iq._qr_panel_ok(torch.zeros((2049, 512)))


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def test_calu_gesv_at_nb_256_matches_reference_pallas_route(ref_drivers,
                                                            monkeypatch):
    """The slice as a whole, LU: the port's CALU gesv at n = 768, nb = 256
    (K4's and K3's plain versions on every tournament round and panel, by
    the CPU gates that mirror the card's) against the reference's CALU
    gesv with its tournament forced onto lu_select_pallas at 256, on an
    orthogonal A.  The reference's clean factor stays on its XLA route:
    its Pallas panel at 256 forms U^-1 by a series that fails this pivoted
    U (SlateSingularError).  The permutation is exact; X within 1e-4 of
    max|X| (and of the f64 solution): both are CALU solves of the same
    bytes with the same pivots, sums in another order, cond(A) = 1."""
    n, nb = 768, 256
    q, _ = np.linalg.qr(np.random.default_rng(23).standard_normal((n, n)))
    a = q.astype(np.float32)
    b = _gauss(24, n, 4)
    rounds = []
    real_select = lk.lu_select
    monkeypatch.setattr(ig, "lu_select",
                        lambda x, *args, **kw: rounds.append(x.shape)
                        or real_select(x, *args, **kw))
    calu = {ref.Option.MethodLU: ref.MethodLU.CALU}
    with ref_override("lu_select", RefPlan("pallas", nb, 8)):
        fr, xr = ref.gesv(ref.Matrix.from_numpy(a, nb),
                          ref.Matrix.from_numpy(b, nb), calu)
    f, x = st.gesv(st.Matrix.from_numpy(a, nb, device="cpu"),
                   st.Matrix.from_numpy(b, nb, device="cpu"),
                   {st.Option.MethodLU: st.MethodLU.CALU})
    assert rounds and all(s[2] == nb for s in rounds)
    np.testing.assert_array_equal(f.perm.numpy(), np.asarray(fr.perm))
    want = np.asarray(xr.to_numpy())
    np.testing.assert_allclose(x.to_numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(x.to_numpy(), x64, rtol=0,
                               atol=1e-4 * np.abs(x64).max())


def test_gels_at_nb_256_matches_reference_pallas_route(ref_drivers,
                                                       monkeypatch):
    """The slice as a whole, QR: the port's gels at 1024 x 512, nb = 256,
    the QR route forced in both (K5's plain version on both panels, [1024,
    256] and [768, 256]) against the reference's forced onto
    qr_panel_pallas at 256, the same bytes.  Both are blocked Householder
    solves with sums in another order (cond(A) <= ~6): X within 1e-4 of
    max|X|, and of the f64 least-squares solution."""
    m, n, nb = 1024, 512, 256
    a, b = _gauss(25, m, n), _gauss(26, m, 3)
    panels = []
    real_panel = iq.qr_panel
    monkeypatch.setattr(iq, "qr_panel",
                        lambda p, bw: panels.append(tuple(p.shape))
                        or real_panel(p, bw))
    with ref_override("geqrf_panel", RefPlan("pallas", nb, 8)):
        xr = ref.gels(ref.Matrix.from_numpy(a, nb),
                      ref.Matrix.from_numpy(b, nb),
                      {ref.Option.MethodGels: ref.MethodGels.QR})
    x = st.gels(st.Matrix.from_numpy(a, nb, device="cpu"),
                st.Matrix.from_numpy(b, nb, device="cpu"),
                {st.Option.MethodGels: st.MethodGels.QR})
    assert panels == [(1024, 256), (768, 256)]
    want = np.asarray(xr.to_numpy())
    np.testing.assert_allclose(x.to_numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    x64 = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                          rcond=None)[0]
    np.testing.assert_allclose(x.to_numpy(), x64, rtol=0,
                               atol=1e-4 * np.abs(x64).max())
