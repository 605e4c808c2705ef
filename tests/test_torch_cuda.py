"""slate_tpu_torch's CUDA kernels on the card, held against their plain
PyTorch versions.

These tests need an NVIDIA GPU with nvcc (the kernels build for sm_90a at
first use) and skip without one.  The file imports neither JAX nor
slate_tpu, so that it runs on the machine with the card, where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import slate_tpu_torch as st
from slate_tpu_torch.internal import chol_kernels as ck
from slate_tpu_torch.internal import getrf as ig
from slate_tpu_torch.internal import lu_kernels as lk
from slate_tpu_torch.internal import qr as iq
from slate_tpu_torch.internal import qr_kernels as qk
from slate_tpu_torch.internal.getrf import panel_lu
from slate_tpu_torch.internal.tri_inv import TRI_INV, upper_tri_inv, \
    upper_tri_inv_plain

pytestmark = pytest.mark.cuda

# kernel vs plain version, both f32 on the card: the sums run in another
# order (and K0 is a back substitution, not the series), on inputs with
# cond <= ~5, so the outputs differ by a few n eps relative.
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc for "
                    "sm_90a and run only on the card")
    return torch.device("cuda")


def _spd(rng, n):
    g = rng.standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


def _panel(rng, m, nb, k, cuda):
    """left @ lead has O(1) entries (left ~ N(0,1) / K^(1/4)), so a skipped
    K slice or TF32 products land far above the tolerance; the top block of
    col - left @ lead is SPD with cond <= ~5."""
    base = rng.standard_normal((m, nb)).astype(np.float32)
    base[:nb] = base[:nb] @ base[:nb].T / nb + np.eye(nb)
    left = (rng.standard_normal((m, k)) / max(k, 1) ** 0.25).astype(np.float32)
    col = base + left @ left[:nb].T
    col, left = torch.from_numpy(col).to(cuda), torch.from_numpy(left).to(cuda)
    return col, left, left[:nb].T                 # lead: a transposed view


def test_kernels_match_plain_versions(cuda):
    rng = np.random.default_rng(8)
    u = torch.from_numpy(np.linalg.cholesky(_spd(rng, 128)).T.copy()).to(cuda)
    before = TRI_INV.launches
    torch.testing.assert_close(upper_tri_inv(u), upper_tri_inv_plain(u),
                               rtol=RTOL, atol=ATOL)
    assert TRI_INV.launches == before + 1
    a = torch.from_numpy(_spd(rng, 128)).to(cuda)
    torch.testing.assert_close(ck.chol_tile(a, 8), ck.chol_tile_plain(a, 8),
                               rtol=RTOL, atol=ATOL)
    for nb, k in ((128, 0), (128, 100), (64, 384), (32, 33)):
        col, left, lead = _panel(rng, 4 * nb, nb, k, cuda)
        launches = ck.CHOL_PANEL.launches, TRI_INV.launches
        for got, want in zip(ck.chol_panel_fused(col, left, lead, 8),
                             ck.chol_panel_plain(col, left, lead, 8)):
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        # K2's update, factor and solve launches, K0 between the last two
        assert (ck.CHOL_PANEL.launches, TRI_INV.launches) == \
            (launches[0] + 3, launches[1] + 1)
    with pytest.raises(ValueError, match="float32"):
        ck.chol_tile(a.double(), 8)
    with pytest.raises(ValueError, match="nb = 640"):
        col, left, lead = _panel(rng, 1280, 640, 8, cuda)
        ck.chol_panel_fused(col, left, lead, 8)


def test_posv_on_the_card_matches_the_cpu_route(cuda):
    rng = np.random.default_rng(9)
    n, nb = 512, 128
    a = _spd(rng, n) * n
    b = rng.standard_normal((n, 4)).astype(np.float32)
    before = ck.CHOL_PANEL.launches, TRI_INV.launches
    _, Xg = st.posv(st.SymmetricMatrix.from_numpy(a, nb),
                    st.Matrix.from_numpy(b, nb))
    assert ck.CHOL_PANEL.launches - before[0] == 3 * n // nb - 1
    assert TRI_INV.launches - before[1] == n // nb - 1
    _, Xc = st.posv(st.SymmetricMatrix.from_numpy(a, nb, device="cpu"),
                    st.Matrix.from_numpy(b, nb, device="cpu"))
    want = Xc.to_numpy()
    np.testing.assert_allclose(Xg.to_numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def _panel_apart(rng, m, nb, k, cuda):
    """As _panel, but lead drawn apart from left (a K-deep diagonal sum of
    squares would otherwise grow to ~sqrt(K), and one f32 order of it past
    the tolerance); lead is a transposed view, unit-stride along K, as on
    the posv path."""
    base = rng.standard_normal((m, nb)).astype(np.float32)
    base[:nb] = base[:nb] @ base[:nb].T / nb + np.eye(nb)
    scale = max(k, 1) ** -0.25
    left = (rng.standard_normal((m, k + 8)) * scale).astype(np.float32)
    lead = (rng.standard_normal((nb, k + 8)) * scale).astype(np.float32)
    left, lead = left[:, 8:], lead[:, 8:].T
    col = base + left @ lead
    return (torch.from_numpy(col).to(cuda), torch.from_numpy(left).to(cuda),
            torch.from_numpy(lead.T.copy()).to(cuda).T)


@pytest.mark.parametrize("m,k", [(1024, 19456), (128, 20352), (2048, 1000)])
def test_chol_panel_late_shapes_match_plain_and_repeat_bitwise(cuda, m, k):
    """K2 where row tiles are few and K is deep (the K loop split over a
    thread-block cluster), and at M = nb (the last panel: tile 0 alone):
    against the plain version, and two launches bit for bit."""
    rng = np.random.default_rng(m + k)
    col, left, lead = _panel_apart(rng, m, 128, k, cuda)
    plan = ck.panel_plan(col, left, lead)
    assert plan["left"] == plan["lead"] == "cp.async"
    if k > 10000:
        assert plan["split"] > 1
    launches = ck.CHOL_PANEL.launches, TRI_INV.launches
    got = ck.chol_panel_fused(col, left, lead, 8)
    below = int(m > 128)
    assert (ck.CHOL_PANEL.launches, TRI_INV.launches) == \
        (launches[0] + 2 + below, launches[1] + below)
    for g, w in zip(got, ck.chol_panel_plain(col, left, lead, 8)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    for g, h in zip(got, ck.chol_panel_fused(col, left, lead, 8)):
        assert torch.equal(g, h)


def test_upper_tri_inv_on_a_pivoted_u_to_f64_accuracy(cuda):
    """K0 on U = triu of a partially pivoted LU of a Gaussian: within 1e-5
    of the f64 inverse, relative to its largest entry."""
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32))
    u = torch.triu(torch.linalg.lu_factor(g)[0][:128]).to(cuda)
    want = torch.linalg.inv(u.double())
    got = upper_tri_inv(u).double()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    for n in (8, 40, 100):
        torch.testing.assert_close(upper_tri_inv(u[:n, :n]),
                                   upper_tri_inv_plain(u[:n, :n]),
                                   rtol=RTOL, atol=ATOL)


def _pivoted_panel(rng, m, nb, cuda):
    """A Gaussian panel in its partial-pivoting row order: the kind of
    panel the CALU final factor hands K3 (U with cond ~100)."""
    g = torch.from_numpy(rng.standard_normal((m, nb)).astype(np.float32))
    return g[panel_lu(g)[1]].to(cuda)


def test_lu_kernels_match_plain_versions(cuda):
    rng = np.random.default_rng(10)
    for m, nb in ((1024, 128), (512, 64), (128, 128)):
        x = _pivoted_panel(rng, m, nb, cuda)
        launches = lk.LU_PANEL.launches, TRI_INV.launches
        torch.testing.assert_close(lk.lu_panel_fused(x, 8),
                                   lk.lu_panel_plain(x, 8), rtol=RTOL,
                                   atol=ATOL)
        # K3's factor launch (U^-1 formed in it), and when there are rows
        # below, K3's launch for them; no K0 launch
        below = int(m > nb)
        assert (lk.LU_PANEL.launches, TRI_INV.launches) == \
            (launches[0] + 1 + below, launches[1])
    # the tie chunk: column 0's largest |v| in rows 3 and 300, which lie
    # in the two CTAs of a 512-row chunk's cluster; the lower row wins
    tie = rng.standard_normal((2, 512, 128)).astype(np.float32)
    tie[:, 3, 0], tie[:, 300, 0] = 10.0, -10.0
    for g, w, nrows, x in ((2, 256, None, None), (3, 1024, None, None),
                           (2, 512, 300, None), (4, 4096, None, None),
                           (2, 512, None, tie)):
        if x is None:
            x = rng.standard_normal((g, w, 128)).astype(np.float32)
        x = torch.from_numpy(x).to(cuda)
        before = lk.LU_SELECT.launches
        got = lk.lu_select(x, nrows=nrows)
        assert lk.LU_SELECT.launches == before + 1     # one launch a round
        assert torch.equal(got, lk.lu_select_plain(x, nrows))
        if nrows is None:
            assert torch.equal(got, panel_lu(x)[1][:, :128])
    assert bool((got[:, 0] == 3).all())               # the tie chunk
    # one cluster a chunk, its size from W alone (the smallest power of two
    # whose rows fit a CTA's shared memory): at every round-1 height of the
    # main path (ceil(w / 512) 128 rows up to 5120) and the reduction
    # rounds' 256, the size never shrinks as W grows, and a CTA's rows and
    # shared memory fit the card
    props = torch.cuda.get_device_properties(cuda)
    limit = props.shared_memory_per_block_optin
    sizes = []
    for w in range(256, 5121, 128):
        plan = lk.select_plan(cuda, w, 128, 8)
        c = plan["cluster"]
        assert c in (1, 2, 4, 8, 16) and plan["resident"] >= 1
        assert plan["rows"] == -(-w // c) and plan["smem_bytes"] <= limit
        sizes.append(c)
    assert sizes == sorted(sizes)
    assert [lk.select_plan(cuda, w, 128, 8)["cluster"]
            for w in (256, 512, 4096, 5120)] == [1, 2, 16, 16]
    # the gate asks the kernel: 5120-row chunks (round 1 of the tallest
    # panels at n = 20480) fit, 8192 rows do not, and a launch past the
    # limit raises and leaves no error behind for the next launch
    assert ig._lu_select_ok(torch.zeros((1, 5120, 128), device=cuda), 128)
    assert not ig._lu_select_ok(torch.zeros((1, 8192, 128), device=cuda),
                                128)
    with pytest.raises(RuntimeError, match="slate_lu_select"):
        lk.lu_select(torch.zeros((1, 8192, 128), device=cuda))
    x = torch.from_numpy(rng.standard_normal((1, 5120, 128)).astype(
        np.float32)).to(cuda)
    assert torch.equal(lk.lu_select(x), lk.lu_select_plain(x))


def _zero_pivot_tile(j, n=128):
    """A tile whose pivot j is exactly 0 in f32 (as in
    tests/test_torch_lu_kernels.py): A = L U with small integer entries, U's
    other pivots +-1 and U[j, j] = 0, plus integers under pivot j."""
    rng = np.random.default_rng(100 + j)
    lo = np.tril(rng.integers(-1, 2, (n, n)), -1) + np.eye(n)
    up = np.triu(rng.integers(-2, 3, (n, n)), 1) + np.diag(
        rng.choice([-1.0, 1.0], n))
    up[j, j] = 0
    a = lo @ up
    a[j + 1:, j] += rng.integers(-2, 3, n - j - 1)
    return a.astype(np.float32)


@pytest.mark.parametrize("nb", [32, 64, 96, 128])
def test_lu_panel_matches_plain_at_every_width_and_repeats(cuda, nb):
    """K3 (32-column blocks, U^-1 in the factor launch, the rows below on
    panel_gemm.cuh's product) against its plain version (the reference's
    bw slabs) at W = nb and ~1024, on a pivoted panel and on a strided view
    of it (plain-load staging), each bw dividing nb up to 8; two launches
    give the same bits."""
    rng = np.random.default_rng(30 + nb)
    for w in (nb, 1024 // nb * nb):
        x = _pivoted_panel(rng, w, nb, cuda)
        wide = torch.zeros((w, nb + 3), device=cuda)
        wide[:, 1:nb + 1] = x
        for panel in (x, wide[:, 1:nb + 1]):
            for bw in (1, 4, 8):
                got = lk.lu_panel_fused(panel, bw)
                torch.testing.assert_close(got, lk.lu_panel_plain(panel, bw),
                                           rtol=RTOL, atol=ATOL)
                assert torch.equal(got, lk.lu_panel_fused(panel, bw))
        assert lk.panel_plan(x)["strips"] == "cp.async"
        assert lk.panel_plan(wide[:, 1:nb + 1])["strips"] == "loads"


@pytest.mark.parametrize("j", [0, 5, 37])
def test_lu_panel_zero_pivot_health_matches_plain(cuda, j):
    """A planted exact-zero pivot: the kernel scales by 1 inside the
    pivot's bw slab and by 1 / 0 past it, as the plain version's slabs do,
    so the health read gives the same info and nonfinite; column j is
    finite in the slab and non-finite past it; the finite entries that both
    have agree."""
    from slate_tpu_torch.robust.health import from_pivots
    tile = _zero_pivot_tile(j)
    panel = torch.from_numpy(np.concatenate([
        tile, np.random.default_rng(j).standard_normal((128, 128)).astype(
            np.float32)])).to(cuda)
    for bw in (4, 8):
        got = lk.lu_panel_fused(panel, bw)
        want = lk.lu_panel_plain(panel, bw)
        hg = from_pivots(torch.diagonal(got[:128]))
        hw = from_pivots(torch.diagonal(want[:128]))
        assert (hg.info, hg.nonfinite) == (hw.info, hw.nonfinite) == \
            (j + 1, True)
        slab_end = j - j % bw + bw
        for lu in (got, want):
            assert bool(torch.isfinite(lu[j + 1:slab_end, j]).all())
            assert not bool(torch.isfinite(lu[slab_end:128, j]).any())
        both = torch.isfinite(got) & torch.isfinite(want)
        torch.testing.assert_close(got[both], want[both], rtol=RTOL,
                                   atol=ATOL)


def test_lu_panel_gate_asks_the_kernel(cuda):
    """K3's gate is the kernel's (slate_lu_panel_fits): nb in {32, 64, 96,
    128, 256, 384, 512} with bw dividing it (and 128 at the wide widths);
    past that the no-pivot route takes the library, and a launch raises."""
    for nb in (32, 64, 96, 128, 256, 384, 512):
        assert lk.panel_fits(cuda, nb, 8)
        assert ig._nopiv_fused_ok(torch.zeros((2 * nb, nb), device=cuda))
    assert not lk.panel_fits(cuda, 640, 8)
    assert not lk.panel_fits(cuda, 48, 8)
    assert not lk.panel_fits(cuda, 128, 48)
    assert not lk.panel_fits(cuda, 384, 192)       # a slab past one block
    assert not ig._nopiv_fused_ok(torch.zeros((1280, 640), device=cuda))
    with pytest.raises(ValueError, match="slate_lu_panel_fits"):
        lk.lu_panel_fused(torch.zeros((1280, 640), device=cuda), 8)


def test_calu_gesv_on_the_card_matches_the_cpu_route(cuda):
    rng = np.random.default_rng(11)
    n, nb = 512, 128
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = (q * np.sqrt(n)).astype(np.float32)
    b = rng.standard_normal((n, 4)).astype(np.float32)
    opts = {st.Option.MethodLU: st.MethodLU.CALU}
    before = lk.LU_SELECT.launches, lk.LU_PANEL.launches
    Fg, Xg = st.gesv(st.Matrix.from_numpy(a, nb),
                     st.Matrix.from_numpy(b, nb), opts)
    # panels of 4, 3 and 2 tiles: 2 + 2 + 1 tournament rounds and K3 twice
    # on each; the last single-tile panel takes the library's pivoted LU
    assert lk.LU_SELECT.launches - before[0] == 5
    assert lk.LU_PANEL.launches - before[1] == 6
    Fc, Xc = st.gesv(st.Matrix.from_numpy(a, nb, device="cpu"),
                     st.Matrix.from_numpy(b, nb, device="cpu"), opts)
    assert torch.equal(Fg.perm.cpu(), Fc.perm)
    want = Xc.to_numpy()
    np.testing.assert_allclose(Xg.to_numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_qr_panel_matches_its_plain_version(cuda):
    """K5 on the first and last panels of the smoke's gels (8192 and 4224
    rows), a ragged mm, a narrow panel, a zero column with alpha = -0.0
    (that column stays as it was; beta = -mu at alpha = -0.0), and the
    cluster's edges: mm = w, one row past it, an mm no cluster size
    divides, one slab; two launches give the same bits."""
    rng = np.random.default_rng(12)
    for m, w, bw in ((8192, 128, 8), (4224, 128, 8), (1000, 128, 5),
                     (512, 40, 8), (300, 48, 1), (128, 128, 8),
                     (129, 128, 8), (8191, 128, 8), (136, 8, 8)):
        a = rng.standard_normal((m, w)).astype(np.float32)
        if w == 48:
            a[:, 5] = 0.0
            a[0, 0] = -0.0
        x = torch.from_numpy(a).to(cuda)
        before = qk.QR_PANEL.launches
        got = qk.qr_panel(x, bw)
        assert qk.QR_PANEL.launches == before + 1       # one launch a panel
        for g, p in zip(got, qk.qr_panel_plain(x, bw)):
            torch.testing.assert_close(g, p, rtol=RTOL, atol=ATOL)
        assert all(torch.equal(g, h) for g, h in zip(got, qk.qr_panel(x, bw)))
        assert 1 <= qk.panel_cluster(cuda, m, w, bw) <= 16
        if w == 48:
            assert torch.equal(got[0][:, 5], x[:, 5])
            assert got[1][5, 5] == 0.0 and got[0][0, 0] < 0
    # strided input: a transposed view
    xt = torch.from_numpy(rng.standard_normal((64, 700)).astype(
        np.float32)).to(cuda).T
    for g, p in zip(qk.qr_panel(xt), qk.qr_panel_plain(xt)):
        torch.testing.assert_close(g, p, rtol=RTOL, atol=ATOL)


def test_qr_panel_gate_asks_the_kernel(cuda):
    """The gate takes every panel of the smoke's gels (w = 128, mm up to
    8192 = the 2^20-element cap) and narrow ones; past the cap, past 128
    columns or past the slab limit it does not, and a launch the kernel
    refuses raises and leaves no error behind."""
    assert iq._qr_panel_ok(torch.zeros((8192, 128), device=cuda))
    assert iq._qr_panel_ok(torch.zeros((4224, 128), device=cuda))
    assert iq._qr_panel_ok(torch.zeros((7, 1), device=cuda))
    assert not iq._qr_panel_ok(torch.zeros((8193, 128), device=cuda))
    assert not iq._qr_panel_ok(torch.zeros((512, 129), device=cuda))
    assert qk.panel_fits(cuda, 100000, 128, 8)     # mm: no shared memory
    assert not qk.panel_fits(cuda, 512, 128, 9)
    assert not qk.panel_fits(cuda, 100, 101, 8)   # mm < w
    with pytest.raises(RuntimeError, match="slate_qr_panel"):
        qk.qr_panel(torch.zeros((512, 129), device=cuda))
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (256, 128)).astype(np.float32)).to(cuda)
    for g, p in zip(qk.qr_panel(x), qk.qr_panel_plain(x)):
        torch.testing.assert_close(g, p, rtol=RTOL, atol=ATOL)


def test_gels_qr_route_on_the_card_matches_the_cpu_route(cuda):
    rng = np.random.default_rng(14)
    m, n, nb = 640, 256, 128
    a = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal((m, 4)).astype(np.float32)
    before = qk.QR_PANEL.launches
    Xg = st.gels(st.Matrix.from_numpy(a, nb), st.Matrix.from_numpy(b, nb))
    assert qk.QR_PANEL.launches - before == n // nb      # K5 on each panel
    Xc = st.gels(st.Matrix.from_numpy(a, nb, device="cpu"),
                 st.Matrix.from_numpy(b, nb, device="cpu"))
    want = Xc.to_numpy()
    np.testing.assert_allclose(Xg.to_numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


# ---- the serving slice: K6, K7 and K8 -----------------------------------

# bf16 storage: kernel and plain version sum in f32 in another order, then
# each store rounds to bf16's 8 significant bits, so the two may land one
# bf16 ulp apart: |kernel - plain| <= ATOL + 2^-7 |plain|
BF16_RTOL = 2.0 ** -7


def _bits(t):
    """The raw storage bits of a tensor, for bit-equality checks."""
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def _close_storage(got, want):
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else RTOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=ATOL)


def _batched_panel(rng, bsz, m, nb, k, chol, dtype, cuda):
    """Per problem: K = k nb columns of history with O(1) products and a
    top block of col - left @ lead that is SPD (Cholesky) or diagonally
    dominant (LU); strided views as batch_potrf/batch_getrf pass them."""
    kk = k * nb
    left = (rng.standard_normal((bsz, m, kk)) / max(kk, 1) ** 0.25)
    lead = (rng.standard_normal((bsz, kk, nb)) / max(kk, 1) ** 0.25)
    base = rng.standard_normal((bsz, m, nb))
    top = base[:, :nb]
    base[:, :nb] = (top @ top.transpose(0, 2, 1) / nb + np.eye(nb) if chol
                    else top + 2 * nb ** 0.5 * np.eye(nb))
    col = base + left @ lead
    t = [torch.from_numpy(x.astype(np.float32)).to(cuda).to(dtype)
         for x in (col, left, lead)]
    return t[0], t[1], t[2].mT.contiguous().mT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_panels_match_plain_versions(cuda, dtype):
    """K6 and K7 against their plain versions at k = 0 and k = 2, with a
    live, a partly dead and a wholly dead problem: live tiles within the
    tolerance, dead tiles bit-equal to col; each two launches when M == nb
    and three otherwise."""
    rng = np.random.default_rng(15)
    for kern, plain, chol in ((ck.chol_panel_batched,
                               ck.chol_panel_batched_plain, True),
                              (lk.lu_panel_batched,
                               lk.lu_panel_batched_plain, False)):
        counter = ck.CHOL_PANEL_BATCHED if chol else lk.LU_PANEL_BATCHED
        for nb, k, m in ((128, 0, 512), (64, 2, 256), (32, 0, 32)):
            col, left, lead = _batched_panel(rng, 3, m, nb, k, chol, dtype,
                                             cuda)
            tiles = torch.tensor([k + m // nb, k + 1, k], dtype=torch.int32,
                                 device=cuda)
            before = counter.launches
            got = kern(col, left, lead, tiles, k, 8)
            assert counter.launches == before + (2 if m == nb else 3)
            want = plain(col, left, lead, tiles, k, 8)
            live = ck.live_rows(tiles, k, m, nb)
            for g, w in zip(got, want):
                assert g.dtype == dtype
                _close_storage(g, w)
                # dead tiles: col's bits
                assert torch.equal(_bits(torch.where(live, col, g)),
                                   _bits(col))
    with pytest.raises(ValueError, match="past the kernel's limits"):
        col, left, lead = _batched_panel(rng, 1, 48, 48, 0, True, dtype,
                                         cuda)
        ck.chol_panel_batched(col, left, lead,
                              torch.ones(1, dtype=torch.int32, device=cuda),
                              0, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qr_panel_batched_matches_its_plain_version(cuda, dtype):
    """K8 against its plain version, one launch a call; rows = 0 slots
    (in the middle, first and last) keep their bits and get T = 0; mm = w
    and more clusters than the card holds at once (12 of 4096 rows); two
    launches give the same bits, and so does a problem run alone; the gate
    asks the kernel."""
    rng = np.random.default_rng(16)
    for bsz, mm, w, fillers in ((3, 1024, 128, (1,)), (3, 300, 64, (1,)),
                                (8, 128, 128, (0, 7)),
                                (12, 4096, 128, (0, 11))):
        a = torch.from_numpy(rng.standard_normal((bsz, mm, w)).astype(
            np.float32)).to(cuda).to(dtype)
        rows = torch.tensor([0 if b in fillers else mm - 7 * (b % 2)
                             for b in range(bsz)], dtype=torch.int32,
                            device=cuda)
        before = qk.QR_PANEL_BATCHED.launches
        got = qk.qr_panel_batched(a, rows)
        assert qk.QR_PANEL_BATCHED.launches == before + 1
        for g, p in zip(got, qk.qr_panel_batched_plain(a, rows)):
            _close_storage(g, p)
        again = qk.qr_panel_batched(a, rows)
        assert all(torch.equal(_bits(g), _bits(h))
                   for g, h in zip(got, again))
        for b in fillers:
            assert torch.equal(_bits(got[0][b]), _bits(a[b]))
            assert not got[1][b].any()
        # the cluster size depends on mm alone: a problem run alone, as a
        # served request's retry runs, gets the bits it got in the batch
        one = min(set(range(bsz)) - set(fillers))
        alone = qk.qr_panel_batched(a[one:one + 1], rows[one:one + 1])
        assert all(torch.equal(_bits(g[one]), _bits(h[0]))
                   for g, h in zip(got, alone))
        c, resident = qk.batched_panel_cluster(cuda, dtype, mm, w, 8)
        assert 1 <= c <= 16 and resident >= 1
        if (bsz, mm) == (12, 4096):
            assert bsz > resident                 # the clusters run in waves
    assert qk.batched_panel_fits(cuda, 4096, 128, 8)
    assert not qk.batched_panel_fits(cuda, 4096, 129, 8)
    assert not qk.batched_panel_fits(cuda, 4096, 128, 9)


@pytest.mark.parametrize("chol", [True, False], ids=["K6", "K7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chol_panel_batched_splits_repeat_and_ignore_the_batch(cuda, dtype,
                                                               chol):
    """K6, and K7 on the same update and solve launches, where the K loop
    is split over a cluster (K = 2048, nb = 128) and at nb = 96 (128-row
    tiles straddling nb-row tiles): against the plain version, dead tiles
    bit-equal, two launches bit for bit, and each problem alone bit-equal
    to its slot in the batch (the split is a function of K, nb and the
    card, never of the batch)."""
    rng = np.random.default_rng(18)
    kern, plain, plan_of = ((ck.chol_panel_batched,
                             ck.chol_panel_batched_plain,
                             ck.batched_panel_plan) if chol else
                            (lk.lu_panel_batched, lk.lu_panel_batched_plain,
                             lk.batched_panel_plan))
    for nb, k, m, tiles_b in ((128, 16, 512, (20, 18, 17, 16, 0)),
                              (96, 3, 480, (8, 5, 3, 6, 7))):
        bsz = len(tiles_b)
        col, left, lead = _batched_panel(rng, bsz, m, nb, k, chol, dtype,
                                         cuda)
        tiles = torch.tensor(tiles_b, dtype=torch.int32, device=cuda)
        plan = plan_of(col, left, lead)
        if k == 16:
            assert plan["split"] > 1
        got = kern(col, left, lead, tiles, k, 8)
        want = plain(col, left, lead, tiles, k, 8)
        live = ck.live_rows(tiles, k, m, nb)
        for g, w, h in zip(got, want, kern(col, left, lead, tiles, k, 8)):
            _close_storage(g, w)
            assert torch.equal(_bits(torch.where(live, col, g)), _bits(col))
            assert torch.equal(_bits(g), _bits(h))
        for b in range(bsz):
            one = kern(col[b:b + 1], left[b:b + 1], lead[b:b + 1],
                       tiles[b:b + 1], k, 8)
            for g, h in zip(got, one):
                assert torch.equal(_bits(g[b]), _bits(h[0]))


@pytest.mark.parametrize("n", [32, 64, 96, 128])
def test_chol_tile_matches_plain_and_its_first_bad_pivot(cuda, n):
    """K1 (its own 32-column blocking) against the plain version (the
    reference's bw slabs) at each bw, exact zeros above the diagonal; on an
    indefinite tile the first non-finite or non-positive diagonal entry is
    the plain version's, and every later one is non-finite."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(_spd(rng, n)).to(cuda)
    before = ck.CHOL_TILE.launches
    for bw in (8, 16, 32):
        got = ck.chol_tile(a, bw)
        torch.testing.assert_close(got, ck.chol_tile_plain(a, bw), rtol=RTOL,
                                   atol=ATOL)
        assert not bool(torch.triu(got, 1).any())
    assert ck.CHOL_TILE.launches == before + 3
    bad = n // 2 + 3
    a[bad, bad] -= 8.0      # the Schur complement's pivot at bad is ~ -7
    firsts = []
    for l in (ck.chol_tile(a, 8), ck.chol_tile_plain(a, 8)):
        d = torch.diagonal(l)
        poor = ~(torch.isfinite(d) & (d > 0))
        firsts.append(int(poor.nonzero()[0]))
        assert not bool(torch.isfinite(d[bad + 1:]).any())
    assert firsts == [bad, bad]


def test_served_stream_on_the_card_matches_the_cpu_route(cuda):
    """A small mixed stream through serve.Server on the card (the ragged
    route: K6, K7 and K8) and on the CPU (their plain versions)."""
    from slate_tpu_torch import serve
    rng = np.random.default_rng(17)
    reqs = []
    for n in (40, 100, 128):
        g = rng.standard_normal((n, n)).astype(np.float32)
        b = rng.standard_normal((n, 3)).astype(np.float32)
        reqs.append(("solve", g / np.float32(np.sqrt(n))
                     + 4 * np.eye(n, dtype=np.float32),
                     b))
        reqs.append(("chol_solve", g @ g.T / n + np.eye(n, dtype=np.float32),
                     b))
        reqs.append(("least_squares_solve",
                     rng.standard_normal((2 * n, n)).astype(np.float32),
                     rng.standard_normal((2 * n, 3)).astype(np.float32)))
    counters = (ck.CHOL_PANEL_BATCHED, lk.LU_PANEL_BATCHED,
                qk.QR_PANEL_BATCHED)
    before = [c.launches for c in counters]
    got = serve.Server(device=cuda, cache=serve.ExecutableCache()) \
        .serve_batch(reqs)
    assert all(c.launches > b for c, b in zip(counters, before))
    want = serve.Server(device="cpu", cache=serve.ExecutableCache()) \
        .serve_batch(reqs)
    for g, w in zip(got, want):
        assert g.health.ok and w.health.ok and not g.escalated
        np.testing.assert_allclose(g.x.cpu().numpy(), w.x.numpy(), rtol=0,
                                   atol=RTOL * np.abs(w.x.numpy()).max())


# ---------------------------------------- Option.Abft on the card routes

def _abft_info():
    return {st.Option.ErrorPolicy: st.ErrorPolicy.Info,
            st.Option.Abft: st.Abft.On}


def _strike(**kw):
    from slate_tpu_torch.robust import faults
    return faults.inject(faults.FaultPlan("post_panel", kind="bitflip",
                                          transient=True, **kw))


def test_abft_strike_corrected_on_the_k2_route(cuda):
    """posv on the card: a transient bitflip below the diagonal of the
    first diagonal factor that K2's factor launch returns is located at
    tile (0, 0) and repaired; the solve matches the clean one, and K2
    launched as often as without Abft."""
    rng = np.random.default_rng(30)
    n, nb = 512, 128
    a, b = _spd(rng, n), rng.standard_normal((n, 4)).astype(np.float32)
    A = st.SymmetricMatrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    before = ck.CHOL_PANEL.launches
    _, X0, h0 = st.posv(A, B, _abft_info())
    assert ck.CHOL_PANEL.launches - before == 3 * (n // nb) - 1
    assert (h0.abft_detected, h0.abft_corrected) == (0, 0)
    seed = next(s for s in range(64) if (lambda p: p // nb > p % nb)(
        int(np.random.default_rng(s).choice(nb * nb, 1)[0])))
    with _strike(seed=seed):
        _, X, h = st.posv(A, B, _abft_info())
    assert (h.abft_detected, h.abft_corrected, h.abft_site) == (1, 1, 0)
    assert h.ok
    torch.testing.assert_close(X.to_dense(), X0.to_dense(), rtol=1e-4,
                               atol=1e-4)


def test_abft_strike_corrected_on_the_k3_route(cuda):
    """gesv NoPiv on the card (K3 on every panel): a transient bitflip in
    the first panel's row tile 2 is located at tile (2, 0) and repaired."""
    rng = np.random.default_rng(31)
    n, nb = 512, 128
    a = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 4)).astype(np.float32)
    A, B = st.Matrix.from_numpy(a, nb), st.Matrix.from_numpy(b, nb)
    opts = {**_abft_info(), st.Option.MethodLU: st.MethodLU.NoPiv}
    before = lk.LU_PANEL.launches
    _, X0, _ = st.gesv(A, B, opts)
    assert lk.LU_PANEL.launches - before == 2 * (n // nb) - 1
    with _strike(seed=5, tile=(2, 0), nb=nb):
        _, X, h = st.gesv(A, B, opts)
    assert (h.abft_detected, h.abft_corrected, h.abft_site) == (
        1, 1, 2 * 65536)
    assert h.ok
    torch.testing.assert_close(X.to_dense(), X0.to_dense(), rtol=1e-4,
                               atol=1e-4)


def test_abft_strike_corrected_in_a_k6_batch(cuda):
    """batch_potrf(abft=True) on the card: a transient bitflip in problem
    1's first step (below its diagonal tile) is repaired; the other
    problems' factors are bit-equal to the clean run's and K6 ran three
    launches a step, the last step two."""
    from slate_tpu_torch.internal import batched as ib
    rng = np.random.default_rng(32)
    n, nb, sizes = 256, 128, [256, 200, 256]
    a = np.zeros((3, n, n), np.float32)
    for i, s in enumerate(sizes):
        a[i] = np.eye(n)
        a[i, :s, :s] = _spd(rng, s)
    at = torch.from_numpy(a).to(cuda)
    sz = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    before = ck.CHOL_PANEL_BATCHED.launches
    clean, c0 = ib.batch_potrf(at, sz, nb=nb, abft=True)
    assert ck.CHOL_PANEL_BATCHED.launches - before == 3 * (n // nb) - 1
    assert c0.detected.tolist() == [0, 0, 0]
    seed = next(s for s in range(64) if (lambda p: nb <= p // nb < 200)(
        int(np.random.default_rng(s).choice(n * nb, 1)[0])))
    with _strike(seed=seed, tile=(1, 0)):
        fa, counts = ib.batch_potrf(at, sz, nb=nb, abft=True)
    assert counts.detected.tolist() == counts.corrected.tolist() == [0, 1, 0]
    for p in (0, 2):
        assert torch.equal(fa[p], clean[p])
    torch.testing.assert_close(torch.tril(fa[1]), torch.tril(clean[1]),
                               rtol=1e-4, atol=1e-4)


# ------------------------------- CUDA graphs: warm buckets and posv's hold

def _bucket_batch(rng, op, nb, sizes):
    """Packed [len(sizes), mb, nb] stacks of well-conditioned problems of
    ``sizes`` (0 = filler), as serve.Server packs them."""
    from slate_tpu_torch import serve
    members = []
    for s in sizes:
        if not s:
            continue
        if op == "least_squares_solve":
            a = rng.standard_normal((2 * s, s)).astype(np.float32)
            b = rng.standard_normal((2 * s, 4)).astype(np.float32)
        else:
            g = rng.standard_normal((s, s)).astype(np.float32)
            a = (g @ g.T / s + np.eye(s, dtype=np.float32) if op ==
                 "chol_solve" else g / np.float32(np.sqrt(s))
                 + 4 * np.eye(s, dtype=np.float32))
            b = rng.standard_normal((s, 4)).astype(np.float32)
        members.append((len(members), serve.Request(
            op, torch.from_numpy(a), torch.from_numpy(b))))
    shape = (2 * nb, nb, 4) if op == "least_squares_solve" else (nb, 4)
    srv = serve.Server(device="cuda")
    return shape, srv._pack(op, "float32", shape, len(sizes), members)[:3]


@pytest.mark.parametrize("low", [False, True], ids=["f32", "bf16_rung"])
@pytest.mark.parametrize("op", ["solve", "chol_solve",
                                "least_squares_solve"])
def test_bucket_graph_replay_equals_the_eager_program(cuda, op, low):
    """One bucket captured as CUDA graphs (serve/cache.py) against
    make_batched run eagerly on the same packed batches: equal bits,
    health and flags on two batches through one capture, and each replay
    adds the capture's tally of K6/K7/K8 launches to ``replayed``."""
    from slate_tpu_torch.serve import batched as sb
    from slate_tpu_torch.serve import cache as sc
    opts = {st.Option.Precision: st.Precision.Bf16} if low else None
    rng = np.random.default_rng(60)
    nb = 256
    kernel = {"solve": lk.LU_PANEL_BATCHED,
              "chol_solve": ck.CHOL_PANEL_BATCHED,
              "least_squares_solve": qk.QR_PANEL_BATCHED}[op]
    shape, _ = _bucket_batch(rng, op, nb, [nb])
    exe = sc.BucketGraphs(op, shape, "float32", 4, opts, cuda)
    assert exe.route == "ragged"
    per_replay = exe.graphs["f32"].launches[kernel]
    assert per_replay == (nb // 128 if op == "least_squares_solve"
                          else 3 * (nb // 128) - 1)
    eager = sb.make_batched(op, opts)
    for sizes in ([256, 200, 17, 0], [130, 256, 64, 0]):
        _, (a, b, s) = _bucket_batch(rng, op, nb, sizes)
        before = kernel.replayed
        x, h, esc = exe(a, b, s)
        assert kernel.replayed - before >= per_replay
        wx, wh, wesc = eager(a, b, s)
        assert torch.equal(x.view(torch.int32), wx.view(torch.int32))
        assert h == wh and esc == wesc


def test_async_server_on_the_card_makes_no_captures_when_warm(cuda):
    """Server.start() on the card: a warm background pass settles every
    ticket from replays, with zero captures, bit-equal to the synchronous
    pass."""
    from slate_tpu_torch import serve
    rng = np.random.default_rng(61)
    reqs = []
    for n in (40, 100, 128, 200):
        g = rng.standard_normal((n, n)).astype(np.float32)
        b = rng.standard_normal((n, 3)).astype(np.float32)
        reqs.append(("solve", g / np.float32(np.sqrt(n))
                     + 4 * np.eye(n, dtype=np.float32), b))
        reqs.append(("chol_solve", g @ g.T / n + np.eye(n, dtype=np.float32),
                     b))
    srv = serve.Server(cache=serve.ExecutableCache(),
                       admission=serve.AdmissionConfig(
                           flush_occupancy=len(reqs),
                           max_batch_delay_ms=60_000.0))
    sync = srv.serve_batch(reqs)
    captures = srv.cache.stats()["captures"]
    assert captures > 0
    srv.start()
    try:
        tickets = [srv.submit(op, a, b) for op, a, b in reqs]
        got = [t.result(timeout=120.0) for t in tickets]
    finally:
        srv.shutdown()
    assert srv.cache.stats()["captures"] == captures
    for g, w in zip(got, sync):
        assert torch.equal(g.x.view(torch.int32), w.x.view(torch.int32))


def test_hold_local_workspace_posv_equals_eager_posv(cuda):
    """posv under Option.HoldLocalWorkspace (its Cholesky attempt replayed
    from one CUDA graph) against eager posv: equal bits of L and X, equal
    health, on two right-hand sides through one capture; a replay runs
    K2 3 n / nb - 1 and K0 n / nb - 1 times."""
    from slate_tpu_torch.drivers import cholesky as chol
    rng = np.random.default_rng(62)
    n, nb = 1024, 128
    a = _spd(rng, n) * n
    A = st.HermitianMatrix.from_numpy(a, nb, device=cuda)
    hold = {st.Option.HoldLocalWorkspace: True,
            st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    chol._HELD.clear()
    for _ in range(2):
        B = st.Matrix.from_numpy(
            rng.standard_normal((n, 8)).astype(np.float32), nb, device=cuda)
        k2, k0 = ck.CHOL_PANEL.replayed, TRI_INV.replayed
        L, X, h = st.posv(A, B, hold)
        assert ck.CHOL_PANEL.replayed - k2 == 3 * (n // nb) - 1
        assert TRI_INV.replayed - k0 == n // nb - 1
        wL, wX, wh = st.posv(A, B, info)
        assert torch.equal(X.to_dense().view(torch.int32),
                           wX.to_dense().view(torch.int32))
        assert torch.equal(L.to_dense().view(torch.int32),
                           wL.to_dense().view(torch.int32))
        assert h == wh and h.ok
    assert len(chol._HELD) == 1
    chol._HELD.clear()


def _counts():
    from slate_tpu_torch.internal.chol_kernels import CHOL_PANEL, \
        CHOL_PANEL_BATCHED
    from slate_tpu_torch.internal.lu_kernels import LU_PANEL, \
        LU_PANEL_BATCHED
    from slate_tpu_torch.internal.qr_kernels import QR_PANEL_BATCHED
    ks = {"K2": CHOL_PANEL, "K0": TRI_INV, "K3": LU_PANEL,
          "K6": CHOL_PANEL_BATCHED, "K7": LU_PANEL_BATCHED,
          "K8": QR_PANEL_BATCHED}
    return {name: k.launches + k.replayed for name, k in ks.items()}


@pytest.mark.parametrize("fn", ["posv_mixed", "posv_mixed_gmres",
                                "gesv_mixed"])
def test_mixed_precision_on_the_card_matches_the_cpu(cuda, fn):
    """An f64 system factored on the f32 kernels (K2 and K0 for posv, K3
    under Speculate for gesv) and refined in f64: the same iterations as
    the CPU route and X within 1e-10 of it."""
    rng = np.random.default_rng(21)
    n, nb = 512, 128
    g = rng.standard_normal((n, n))
    a = g @ g.T + n * np.eye(n)
    b = rng.standard_normal((n, 4))
    herm = fn.startswith("posv")
    opts = None if herm else {st.Option.Speculate: st.Speculate.On}
    cls = st.HermitianMatrix if herm else st.Matrix
    before = _counts()
    got = getattr(st, fn)(cls.from_numpy(a, nb),
                          st.Matrix.from_numpy(b, nb), opts)
    after = _counts()
    want = getattr(st, fn)(cls.from_numpy(a, nb, device="cpu"),
                           st.Matrix.from_numpy(b, nb, device="cpu"), opts)
    assert got.converged and got.iters == want.iters
    assert got.X.dtype == torch.float64
    x, xw = got.X.to_numpy(), want.X.to_numpy()
    assert np.abs(x - xw).max() <= 1e-10 * np.abs(xw).max()
    launched = {k for k in after if after[k] > before[k]}
    assert launched >= ({"K2", "K0"} if herm else {"K3"})


@pytest.mark.parametrize("verb", ["batch_solve", "batch_chol_solve",
                                  "batch_least_squares_solve"])
def test_batch_verbs_on_the_card(cuda, verb):
    """The API's batch verbs on a (4, 256, 256) stack reach K6-K8 and
    equal make_batched on the same stack bit for bit."""
    from slate_tpu_torch import api
    from slate_tpu_torch.serve import batched
    rng = np.random.default_rng(22)
    n = 256
    m = 2 * n if verb == "batch_least_squares_solve" else n
    a = rng.standard_normal((4, m, n)).astype(np.float32)
    if verb == "batch_solve":
        a += n * np.eye(n, dtype=np.float32)
    elif verb == "batch_chol_solve":
        a = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((4, m, 8)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    before = _counts()
    x, hs, esc = getattr(api, verb)(ta, tb)
    after = _counts()
    op = {"batch_solve": "solve", "batch_chol_solve": "chol_solve",
          "batch_least_squares_solve": "least_squares_solve"}[verb]
    kernel = {"solve": "K7", "chol_solve": "K6",
              "least_squares_solve": "K8"}[op]
    assert after[kernel] > before[kernel]
    sizes = torch.full((4,), m, dtype=torch.int32, device=cuda)
    x2, hs2, esc2 = batched.make_batched(op)(ta, tb, sizes)
    assert torch.equal(x, x2) and hs == hs2 and esc == esc2
    assert all(h.ok for h in hs)


@pytest.fixture
def empty_plans(tmp_path, monkeypatch):
    """The plan cache pointed at an empty file: the default plans."""
    from slate_tpu_torch.tune import plans
    path = tmp_path / "plans.json"
    monkeypatch.setenv("SLATE_TORCH_TUNE_CACHE", str(path))
    plans.reload()
    yield path
    plans.reload()


def test_tune_op_on_the_card_writes_a_valid_cache(cuda, empty_plans):
    """The tuner on the card: every candidate measured, the winner
    persisted under the card's kind, schema-valid, resolved exactly."""
    import json

    from slate_tpu_torch.tune import autotune, plans
    seen = []
    for op, n in (("potrf_tile", 128), ("getrf_panel", 1024),
                  ("batch_potrf", 512)):
        plan, gflops = autotune.tune_op(op, n, iters=2,
                                        report=lambda p, g: seen.append(g))
        assert gflops > 0
        assert plans.resolution(op, n)["source"] == "exact"
        assert plans.resolve_plan(op, n) == plan
    assert all(g > 0 for g in seen) and len(seen) >= 6
    obj = json.loads(empty_plans.read_text())
    plans.validate_cache(obj)
    (chip,) = obj["chips"]
    assert chip.startswith("nvidia-") and chip == plans.chip_kind()


def _launch_counts():
    from slate_tpu_torch.internal.chol_kernels import CHOL_PANEL, CHOL_TILE
    return {"K2": CHOL_PANEL.launches, "K0": TRI_INV.launches,
            "K1": CHOL_TILE.launches}


def test_obs_on_and_off_give_equal_launches_and_bits(cuda, empty_plans):
    """posv at n = 2048 with events, spans and timing on against all of
    them off: the same launches, the same bits; the event carries the
    device time and the default plans."""
    from slate_tpu_torch import obs
    rng = np.random.default_rng(63)
    n, nb = 2048, 128
    A = st.HermitianMatrix.from_numpy(_spd(rng, n) * n, nb, device=cuda)
    B = st.Matrix.from_numpy(rng.standard_normal((n, 16)).astype(np.float32),
                             nb, device=cuda)
    st.posv(A, B)                                      # builds, warms
    runs = []
    for on in (False, True, False):
        before = _launch_counts()
        if on:
            with obs.recording() as evs, obs.record_spans() as rec, \
                    obs.timing():
                _, X = st.posv(A, B)
        else:
            _, X = st.posv(A, B)
        torch.cuda.synchronize()
        after = _launch_counts()
        runs.append(({k: after[k] - before[k] for k in after},
                     X.to_dense().view(torch.int32).clone()))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    assert runs[0][0]["K2"] == 3 * (n // nb) - 1
    assert torch.equal(runs[0][1], runs[1][1])
    (e,) = evs
    assert e["op"] == "posv" and e["device_ms"] > 0 and e["mfu"] > 0
    assert e["plans"] and all(p["source"] == "default"
                              and p["kernel"] == "cuda" for p in e["plans"])
    assert rec.spans[-1]["name"] == "slate.posv"


def test_timing_never_syncs_inside_a_capture(cuda, empty_plans,
                                             monkeypatch):
    """obs.timing() around a HoldLocalWorkspace posv (its attempt captured
    and replayed) and around a cold and a warm served batch (bucket
    graphs): no boundary waits while a stream captures, the outermost
    eager boundary stamps device_ms, frames opened during a capture are
    flagged traced and carry none."""
    from slate_tpu_torch import obs, serve
    from slate_tpu_torch.drivers import cholesky as chol
    from slate_tpu_torch.util import trace
    waits = []
    real = trace._ready

    def spy(out):
        waits.append(torch.cuda.is_current_stream_capturing())
        return real(out)
    monkeypatch.setattr(trace, "_ready", spy)
    rng = np.random.default_rng(64)
    n, nb = 1024, 128
    A = st.HermitianMatrix.from_numpy(_spd(rng, n) * n, nb, device=cuda)
    B = st.Matrix.from_numpy(rng.standard_normal((n, 8)).astype(np.float32),
                             nb, device=cuda)
    hold = {st.Option.HoldLocalWorkspace: True}
    chol._HELD.clear()
    reqs = []
    for m in (40, 100, 200):
        g = rng.standard_normal((m, m)).astype(np.float32)
        reqs.append(("chol_solve", g @ g.T / m + np.eye(m, dtype=np.float32),
                     rng.standard_normal((m, 2)).astype(np.float32)))
    srv = serve.Server(cache=serve.ExecutableCache())
    with obs.recording() as evs, obs.timing():
        for _ in range(2):                       # capture, then replay
            _, X = st.posv(A, B, hold)
            srv.serve_batch(reqs)
    chol._HELD.clear()
    assert waits and not any(waits)
    posv = [e for e in evs if e.get("op") == "posv"]
    assert len(posv) == 2 and all(e["device_ms"] > 0 for e in posv)
    assert all(e["device_ms"] is None for e in evs
               if e.get("kind") == "event" and e["traced"])
    batches = [e for e in evs if e.get("kind") == "serve_batch"]
    assert batches and all(e["device_ms"] is not None for e in batches)


# ---- slice 14: the spectral drivers on the card -------------------------

# the smoke's f32 bound on eigen- and singular values (~4 n eps_f32 at n =
# 8192): cuSOLVER's f32 eigh and SVD, which the Auto routes call on the
# band, sit near 2e-4 of the largest value at n = 512, past 1e-4
SPEC_TOL = 2e-3

def _herm32(rng, n):
    g = rng.standard_normal((n, n))
    return ((g + g.T) / 2).astype(np.float32)


@pytest.mark.parametrize("route", ["Auto", "DC", "QR"])
def test_heev_on_the_card_matches_the_cpu_route(cuda, route):
    """heev at n = 512 in f32 on the card against the same call on the
    CPU and against the f64 eigenvalues: within SPEC_TOL of the largest,
    the certificate passed, residual and orthogonality at f32 grade."""
    rng = np.random.default_rng(140)
    n, nb = 512, 128
    a = _herm32(rng, n)
    opts = {st.Option.MethodEig: getattr(st.MethodEig, route),
            st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    wg, Zg, hg = st.heev(st.HermitianMatrix.from_numpy(a, nb), opts)
    wc, _, hc = st.heev(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                        opts)
    assert hg.ok and hc.ok and wg.device.type == "cuda"
    w64 = np.linalg.eigvalsh(a.astype(np.float64))
    for w in (wg.cpu().numpy(), wc.numpy()):
        np.testing.assert_allclose(w, w64, rtol=0,
                                   atol=SPEC_TOL * np.abs(w64).max())
    z, w = Zg.to_numpy().astype(np.float64), wg.cpu().numpy()
    assert np.abs(a @ z - z * w[None, :]).max() < 1e-3 * np.abs(w).max()
    assert np.abs(z.T @ z - np.eye(n)).max() < 1e-3


@pytest.mark.parametrize("route", ["Auto", "Bidiag"])
def test_svd_on_the_card_matches_the_cpu_route(cuda, route):
    rng = np.random.default_rng(141)
    m, n, nb = 640, 512, 128
    a = rng.standard_normal((m, n)).astype(np.float32)
    opts = {st.Option.MethodSvd: getattr(st.MethodSvd, route),
            st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    sg, Ug, Vg, hg = st.svd(st.Matrix.from_numpy(a, nb), opts)
    sc, _, _, hc = st.svd(st.Matrix.from_numpy(a, nb, device="cpu"), opts)
    assert hg.ok and hc.ok
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    for s in (sg.cpu().numpy(), sc.numpy()):
        np.testing.assert_allclose(s, s64, rtol=0, atol=SPEC_TOL * s64[0])
    u, v = Ug.to_numpy().astype(np.float64), Vg.to_numpy().astype(np.float64)
    s = sg.cpu().numpy()
    assert np.abs(u * s[None, :] @ v.T - a).max() < 1e-3 * s.max()


def test_hegv_on_the_card_launches_k2_and_k0_as_potrf(cuda):
    """hegv factors B with potrf: K2 3 n/nb - 1 and K0 n/nb - 1 launches;
    hegst's and the back-transform's solves are the library's."""
    rng = np.random.default_rng(142)
    n, nb = 512, 128
    a = _herm32(rng, n)
    b = _spd(rng, n) * n
    before = ck.CHOL_PANEL.launches, TRI_INV.launches
    wg, Xg = st.hegv(st.HermitianMatrix.from_numpy(a, nb),
                     st.HermitianMatrix.from_numpy(b, nb))
    assert ck.CHOL_PANEL.launches - before[0] == 3 * n // nb - 1
    assert TRI_INV.launches - before[1] == n // nb - 1
    wc, _ = st.hegv(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                    st.HermitianMatrix.from_numpy(b, nb, device="cpu"))
    np.testing.assert_allclose(wg.cpu().numpy(), wc.numpy(), rtol=0,
                               atol=SPEC_TOL * np.abs(wc.numpy()).max())
    x, w = Xg.to_numpy().astype(np.float64), wg.cpu().numpy()
    r = a @ x - b @ x * w[None, :]
    assert np.linalg.norm(r) / (np.linalg.norm(a) * np.linalg.norm(x)) < 1e-4


def test_tilemap_on_the_card_pins_and_round_trips(cuda):
    """Host block columns pinned; panel windows copied on the side stream;
    a fetched window equals the host bytes; a store lands at drain; a
    window across block columns and one inside a block column (copied
    synchronously) come back right too."""
    from slate_tpu_torch.core import storage
    rng = np.random.default_rng(160)
    a = rng.standard_normal((512, 384)).astype(np.float32)
    tm = st.TileMap(a, 128, 128, max_pending=2)
    assert all(c.is_pinned() for c in tm._cols) and tm.device.type == "cuda"
    storage.reset_traffic()
    expect = a.copy()
    for step in range(6):
        j = step % 3
        cols = slice(128 * j, 128 * j + 128)
        tm.prefetch(0, 512, cols.start, cols.stop)
        win = tm.fetch(0, 512, cols.start, cols.stop)
        assert win.is_cuda
        assert np.array_equal(win.cpu().numpy(), expect[:, cols])
        tm.store(0, 512, cols.start, cols.stop, win * 2)
        expect[:, cols] *= 2
    np.testing.assert_array_equal(tm.to_dense(), expect)
    assert storage.TRAFFIC["h2d"] == storage.TRAFFIC["d2h"] == 6 * 512 * 512
    for c0, c1 in ((64, 320), (10, 20)):
        win = tm.fetch(100, 300, c0, c1)
        assert np.array_equal(win.cpu().numpy(), expect[100:300, c0:c1])
        tm.store(100, 300, c0, c1, win + 1)
        expect[100:300, c0:c1] += 1
    np.testing.assert_array_equal(tm.to_dense(), expect)


def test_potrf_ooc_on_the_card_launches_k1_once_a_step(cuda, empty_plans,
                                                        tmp_path):
    """nb = 128 in f32: each panel step's diagonal tile is one K1 launch;
    the factor agrees with the CPU route, repeats bit for bit, and a kill
    and resume gives the same bits, for potrf_ooc and getrf_ooc."""
    from slate_tpu_torch.robust.checkpoint import (CheckpointManager,
                                                   SimulatedPreemption)
    rng = np.random.default_rng(161)
    n, nb = 640, 128
    spd = _spd(rng, n) * n
    before = ck.CHOL_TILE.launches
    L = st.potrf_ooc(spd, nb=nb)
    assert ck.CHOL_TILE.launches - before == n // nb
    Lc = st.potrf_ooc(spd, nb=nb, device="cpu")
    np.testing.assert_allclose(L, Lc, rtol=0, atol=1e-4 * np.abs(Lc).max())
    assert np.array_equal(L, st.potrf_ooc(spd, nb=nb))
    with pytest.raises(SimulatedPreemption):
        st.potrf_ooc(spd, nb=nb, checkpoint=CheckpointManager(
            tmp_path / "p", every=2, abort_after_step=2))
    assert np.array_equal(L, st.potrf_ooc(
        None, checkpoint=CheckpointManager(tmp_path / "p"), resume=True))
    a = rng.standard_normal((n, n)).astype(np.float32)
    F = st.getrf_ooc(a, nb=nb)
    with pytest.raises(SimulatedPreemption):
        st.getrf_ooc(a, nb=nb, checkpoint=CheckpointManager(
            tmp_path / "g", every=1, abort_after_step=3))
    R = st.getrf_ooc(None, checkpoint=CheckpointManager(tmp_path / "g"),
                     resume=True)
    assert np.array_equal(F.LU, R.LU) and np.array_equal(F.perm, R.perm)
    lu = F.LU.astype(np.float64)
    res = np.abs(a[F.perm] - (np.tril(lu, -1) + np.eye(n)) @ np.triu(lu))
    assert res.max() < 1e-4 * np.abs(a).max() * n ** 0.5


# ---- the wide widths: K1 past 128, K0, K2 and K3 at 256 .. 512 ----

def test_wide_gates_ask_the_kernels(cuda):
    """K1, K2 and K0 answer for their own widths on the card, and the CPU
    gates mirror them: K1 n % 32 == 0 up to 1024, K2 nb in {32, 64, 96,
    128, 256, 384, 512}, K0 up to 512."""
    from slate_tpu_torch.internal import potrf as ip
    from slate_tpu_torch.internal.kernels import fits
    for n in (32, 96, 128, 160, 256, 512, 1000, 1024, 1056, 2048, 48):
        assert ck.tile_fits_on(cuda, n) == ip.tile_fits(n)
    for nb in (32, 64, 96, 128, 192, 256, 384, 512, 640):
        assert ck.panel_fits(cuda, nb) == (nb in ck.PANEL_NB)
    for n in (1, 100, 128, 200, 512, 513):
        assert fits(TRI_INV, "slate_upper_tri_inv_fits", cuda, n) == \
            (n <= 512)
    with pytest.raises(ValueError, match="slate_chol_tile_fits"):
        ck.chol_tile(torch.eye(1056, device=cuda), 8)
    with pytest.raises(ValueError, match="slate_upper_tri_inv_fits"):
        upper_tri_inv(torch.eye(640, device=cuda))


@pytest.mark.parametrize("n", [160, 256, 512, 1024])
def test_wide_chol_tile_matches_plain_and_repeats_bitwise(cuda, n):
    """K1's wide route (one cluster, 128-column diagonal blocks in device
    memory; n = 160 pads to 256 with the identity) against the plain
    version, zeros above the diagonal, and two launches bit for bit."""
    a = torch.from_numpy(_spd(np.random.default_rng(n), n)).to(cuda)
    before = ck.CHOL_TILE.launches
    got = ck.chol_tile(a, 8)
    assert ck.CHOL_TILE.launches == before + 1
    torch.testing.assert_close(got, ck.chol_tile_plain(a, 8), rtol=RTOL,
                               atol=ATOL)
    assert bool((torch.triu(got, 1) == 0).all())
    assert torch.equal(got, ck.chol_tile(a, 8))


def test_wide_chol_tile_first_bad_pivot(cuda):
    """An indefinite 512 tile: the same first bad pivot in the kernel and
    the plain version (in the third diagonal block), every later diagonal
    entry non-finite."""
    a = torch.from_numpy(_spd(np.random.default_rng(11), 512)).to(cuda)
    a[300, 300] -= 8.0
    got, want = ck.chol_tile(a, 8), ck.chol_tile_plain(a, 8)

    def first_bad(l):
        d = torch.diagonal(l)
        return int((~(torch.isfinite(d) & (d > 0))).nonzero()[0])
    assert first_bad(got) == first_bad(want) == 300
    assert not bool(torch.isfinite(torch.diagonal(got)[301:]).any())


@pytest.mark.parametrize("nb,m,k,left_t", [
    (256, 1024, 0, False), (256, 1024, 700, False), (384, 768, 384, False),
    (512, 2048, 1024, False), (512, 512, 300, False),
    (256, 2048, 1000, False), (384, 1536, 700, False),
    (384, 384, 1000, False), (256, 2048, 1000, True),
    (512, 1024, 700, True), (256, 256, 8192, False), (512, 512, 6000, False)])
def test_wide_chol_panel_matches_plain_and_repeats_bitwise(cuda, nb, m, k,
                                                          left_t):
    """K2 at nb = 256 .. 512 (the update on the tensor cores as a 3xTF32
    product by 128 x 128 tiles, the wide factor, K0's wide route on U =
    L00^T, the solve by column tiles): K = 700, 300 and 1000 not a multiple
    of the 32-deep slice, M = nb the last panel, a transposed left (the
    producer's plain loads), a deep K on few tiles (the K loop split over
    a cluster, the partials summed through distributed shared memory):
    against the plain version, its launches, and two launches bit for
    bit."""
    col, left, lead = _panel_apart(np.random.default_rng(nb + m + k), m, nb,
                                   k, cuda)
    if left_t:
        left = left.T.contiguous().T
    plan = ck.panel_plan(col, left, lead)
    assert plan["route"] == "tf32x3"
    if k:
        assert plan["left"] == ("loads" if left_t else "tma")
        assert plan["lead"] == "tma"
    if k >= 6000:
        assert plan["split"] > 1
    launches = ck.CHOL_PANEL.launches, TRI_INV.launches
    got = ck.chol_panel_fused(col, left, lead, 8)
    below = int(m > nb)
    assert (ck.CHOL_PANEL.launches, TRI_INV.launches) == \
        (launches[0] + 2 + below, launches[1] + below)
    for g, w in zip(got, ck.chol_panel_plain(col, left, lead, 8)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    for g, h in zip(got, ck.chol_panel_fused(col, left, lead, 8)):
        assert torch.equal(g, h)


@pytest.mark.parametrize("n", [200, 256, 384, 512])
def test_wide_upper_tri_inv_matches_plain_and_f64(cuda, n):
    """K0 past 128 (the 128 x 128 diagonal blocks by the one-block
    doubling, joined by tiled products; n = 200 pads) on a pivoted LU's U
    (cond ~100): within 1e-5 of the f64 inverse relative to its largest
    entry, against the plain version, and bit for bit."""
    g = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (4 * n, n)).astype(np.float32)).to(cuda)
    u = torch.triu(torch.linalg.lu_factor(g)[0][:n]).contiguous()
    x64 = torch.linalg.inv(u.double())
    got = upper_tri_inv(u)
    assert float((got.double() - x64).abs().max() / x64.abs().max()) < 1e-5
    want = upper_tri_inv_plain(u)
    assert bool(((got - want).abs() <= ATOL + RTOL * want.abs().max()).all())
    assert torch.equal(got, upper_tri_inv(u))
    assert bool((torch.tril(got, -1) == 0).all())
    # a transposed view, as K2 passes fac[:nb].mT: the same values read
    # along the other stride, so the same bits
    assert torch.equal(upper_tri_inv(u.T.contiguous().mT), got)


@pytest.mark.parametrize("nb", [256, 512])
def test_wide_chol_panel_update_error_against_f64(cuda, nb):
    """The tensor-core update's max |upd - upd64| is at most twice that of
    torch.matmul in f32 on the same operands at [M, K] = [2048, 2048]
    (drawn as chip_smoke's chol_panel_operands draws them: lead apart
    from left, entries of left @ lead O(1)); one TF32 pass is far
    beyond it."""
    col, left, lead = _panel_apart(np.random.default_rng(nb), 2048, nb, 2048,
                                   cuda)
    upd, _ = ck.chol_panel_fused(col, left, lead, 8)
    ref = col.double() - left.double() @ lead.double()
    err = float((upd.double() - ref).abs().max())
    f32 = float(((col - left @ lead).double() - ref).abs().max())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = float(((col - left @ lead).double() - ref).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert err <= 2 * f32, (err, f32)
    assert tf32 > 10 * f32, (tf32, f32)


@pytest.mark.parametrize("n", [256, 384, 512])
def test_wide_upper_tri_inv_stamps_order_and_bits(cuda, n):
    """K0's wide route with its stamps (upper_tri_inv_stamps, which the
    launch count leaves out): the same bits as the wrapper's launch, eight
    CTAs, each CTA's stamps in order (start, copy-in, diagonal inverse, the
    half-levels, the store), the half-levels log2(n / 128) rounded up, two
    a level."""
    from slate_tpu_torch.internal.tri_inv import upper_tri_inv_stamps
    u = torch.linalg.cholesky(torch.from_numpy(
        _spd(np.random.default_rng(n + 2), n)).to(cuda)).mT.contiguous()
    before = TRI_INV.launches
    got, stamps, cluster = upper_tri_inv_stamps(u)
    assert TRI_INV.launches == before
    assert torch.equal(got, upper_tri_inv(u))
    assert cluster == 8 and tuple(stamps.shape) == (8, 8)
    halves = 2 * int(np.ceil(np.log2(n / 128)))
    for row in stamps.cpu().tolist():
        seq = row[:3 + halves] + row[-1:]
        assert 0 < seq[0] and seq == sorted(seq), row
        assert row[3 + halves:-1] == [0] * (4 - halves)


@pytest.mark.parametrize("nb,w", [(256, 256), (256, 4096), (384, 384),
                                  (384, 1536), (512, 512), (512, 2048)])
def test_wide_lu_panel_matches_plain_and_repeats_bitwise(cuda, nb, w):
    """K3 at nb = 256 .. 512 on a diagonally dominant panel (the top block
    by 128-column diagonal blocks on one cluster with a lookahead, then
    U^-1 by K0's wide route in the same call, the rows below by column
    tiles), W = nb alone: against the plain version, its launches, and two
    launches bit for bit."""
    rng = np.random.default_rng(nb + w)
    p = rng.standard_normal((w, nb)).astype(np.float32)
    p[:nb] += nb * np.eye(nb, dtype=np.float32)
    panel = torch.from_numpy(p).to(cuda)
    before = lk.LU_PANEL.launches
    got = lk.lu_panel_fused(panel, 8)
    assert lk.LU_PANEL.launches == before + 1 + int(w > nb)
    torch.testing.assert_close(got, lk.lu_panel_plain(panel, 8), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got, lk.lu_panel_fused(panel, 8))


def _bidiagonal_zero_pivot(j, n):
    """An n x n A = L U with pivot j exactly 0 in f32 at any width: L unit
    lower and U upper bidiagonal with entries in {-1, 0, 1} (U's other
    pivots +-1), so that every block's inverse and product is exact, plus
    integers under pivot j."""
    rng = np.random.default_rng(200 + j)
    lo = np.eye(n) + np.diag(rng.integers(-1, 2, n - 1), -1)
    up = np.diag(rng.choice([-1.0, 1.0], n)) + np.diag(
        rng.integers(-1, 2, n - 1), 1)
    up[j, j] = 0
    a = lo @ up
    a[j + 1:, j] += rng.integers(1, 3, n - j - 1)
    return a.astype(np.float32)


@pytest.mark.parametrize("nb,j", [(256, 37), (256, 200), (512, 300),
                                  (512, 450)])
def test_wide_lu_panel_zero_pivot_health_matches_plain(cuda, nb, j):
    """A planted exact-zero pivot in the wide factor's first, second, third
    or last diagonal block: the kernel applies the zero-pivot rule at slab
    width bw inside the block, as the plain version's slabs do, so the
    health read finds the same first bad pivot and non-finite entries; the
    entries that both hold finite agree."""
    from slate_tpu_torch.robust.health import from_pivots
    a = _bidiagonal_zero_pivot(j, nb)
    panel = torch.from_numpy(np.concatenate([a, np.random.default_rng(
        j).standard_normal((nb, nb)).astype(np.float32)])).to(cuda)
    for bw in (4, 8):
        got = lk.lu_panel_fused(panel, bw)
        want = lk.lu_panel_plain(panel, bw)
        hg = from_pivots(torch.diagonal(got[:nb]))
        hw = from_pivots(torch.diagonal(want[:nb]))
        assert (hg.info, hg.nonfinite) == (hw.info, hw.nonfinite), (hg, hw)
        assert hg.info == j + 1
        both = torch.isfinite(got) & torch.isfinite(want)
        torch.testing.assert_close(got[both], want[both], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("nb", [256, 384, 512])
def test_wide_lu_factor_bits_ignore_cluster_and_batch(cuda, nb):
    """wf_lu's bits do not depend on the cluster size or the batch: K7's
    factor launch on one problem (a cluster of 16) and on twelve (more than
    the card places clusters of 16: clusters of 8, as the library's choice
    shows) gives each problem the same bits, and those are K3's factored
    top block of the same tile; K7's U^-1 (K0's wide route a problem) is
    K0's launch on that block."""
    rng = np.random.default_rng(nb)
    bsz = 12
    assert lk.batched_factor_cluster(cuda, 1) == 16
    assert lk.batched_factor_cluster(cuda, bsz) == 8
    col, left, lead = _batched_panel(rng, bsz, 2 * nb, nb, 0, False,
                                     torch.float32, cuda)
    tiles = torch.full((bsz,), 2, dtype=torch.int32, device=cuda)
    _, fac = lk.lu_panel_batched(col, left, lead, tiles, 0, 8)
    for b in (0, 5, 11):
        _, one = lk.lu_panel_batched(col[b:b + 1], left[b:b + 1],
                                     lead[b:b + 1], tiles[b:b + 1], 0, 8)
        assert torch.equal(_bits(fac[b]), _bits(one[0]))
        top = lk.lu_panel_fused(col[b], 8)
        assert torch.equal(_bits(fac[b][:nb]), _bits(top[:nb]))
        x = col[b][nb:] @ upper_tri_inv(torch.triu(top[:nb]))
        torch.testing.assert_close(fac[b][nb:], x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nb,w", [(256, 256), (256, 2048), (512, 512),
                                  (512, 1024)])
def test_wide_lu_panel_stamps_order_and_bits(cuda, nb, w):
    """K3's wide factor launch with its stamps (lu_panel_stamps, which the
    launch count leaves out): the counted launch's factored block and, with
    rows below, U^-1 = K0's launch on it, bit for bit; each block's factor
    start, factor end and (but the last) inverse end in order; the steps'
    closing barriers in order; K0's stamps only when there are rows
    below."""
    rng = np.random.default_rng(nb + w + 1)
    p = rng.standard_normal((w, nb)).astype(np.float32)
    p[:nb] += nb * np.eye(nb, dtype=np.float32)
    panel = torch.from_numpy(p).to(cuda)
    before = lk.LU_PANEL.launches
    top, uinv, stamps, k0, cluster = lk.lu_panel_stamps(panel, 8)
    assert lk.LU_PANEL.launches == before
    want = lk.lu_panel_fused(panel, 8)
    assert torch.equal(top, want[:nb])
    assert cluster in (8, 16)
    nt = nb // 128
    st = stamps.cpu().tolist()
    start, end = st[nt][:2]
    assert 0 < start < end
    for j in range(nt):
        seq = st[j][17:19] + (st[j][19:20] if j + 1 < nt else [])
        assert start <= seq[0] and seq == sorted(seq) and seq[-1] <= end
    closes = [st[j][16] for j in range(nt - 1)]
    assert closes == sorted(closes) and all(closes)
    if w > nb:
        assert torch.equal(uinv, upper_tri_inv(torch.triu(want[:nb])))
        assert int(k0[k0 > 0].min()) >= end
    else:
        assert uinv is None and not bool(k0.any())


def _tied_round(rng, g, w, nb, cuda):
    """A Gaussian round whose every chunk holds its column 0's largest
    magnitude twice, in rows 5 and w / 2 with opposite signs (the lower row
    must win)."""
    x = rng.standard_normal((g, w, nb)).astype(np.float32)
    x[:, 5, 0], x[:, w // 2, 0] = 9.0, -9.0
    return torch.from_numpy(x).to(cuda)


@pytest.mark.parametrize("g,w,nb,nrows", [
    (4, 5120, 256, (5120, 5000, 4000, 300)), (2, 512, 256, (512, 100)),
    (2, 1024, 512, (700, 1024))])
def test_wide_select_dead_rows_and_ties(cuda, g, w, nb, nrows):
    """K4 at the wide widths on rounds with dead rows (a chunk whose live
    rows run out before nb pivots) and tied magnitudes: indices bit-equal
    to the plain version's (the lowest row on a tie, dead rows only once
    no live row is left), and the same bits twice."""
    x = _tied_round(np.random.default_rng(w + nb), g, w, nb, cuda)
    live = torch.tensor(nrows, dtype=torch.int32, device=cuda)
    got = lk.lu_select(x, nrows=live)
    assert torch.equal(got, lk.lu_select_plain(x, live))
    assert torch.equal(got, lk.lu_select(x, nrows=live))
    assert int(got[0, 0]) == 5


@pytest.mark.parametrize("g,w,nb", [(4, 5120, 256), (4, 5120, 512),
                                    (2, 512, 256), (2, 1024, 512)])
def test_wide_select_stamps_order_and_pivots(cuda, g, w, nb):
    """K4's wide launch with its stamps (lu_select_stamps, which the launch
    count leaves out): the counted launch's pivots; per block and CTA the
    stamps in order (start, load, chain, L11 and U, update; the last block
    has no U or update)."""
    x = torch.from_numpy(np.random.default_rng(g + w + nb).standard_normal(
        (g, w, nb)).astype(np.float32)).to(cuda)
    before = lk.LU_SELECT.launches
    piv, stamps, cluster = lk.lu_select_stamps(x)
    assert lk.LU_SELECT.launches == before
    assert torch.equal(piv, lk.lu_select(x))
    assert cluster == lk.select_plan(cuda, w, nb, 8)["cluster"]
    st = stamps.cpu().tolist()
    assert len(st) == nb // 128 and len(st[0]) == cluster
    for blk, rows in enumerate(st):
        for r in rows:
            seq = r if blk + 1 < len(st) else r[:3]
            assert 0 < seq[0] and seq == sorted(seq), (blk, r)


@pytest.mark.parametrize("nb", [256, 512])
def test_wide_posv_launches_k2_and_k0_every_panel(cuda, nb):
    """posv at nb = 256 and 512 on the card: K2 three launches a panel (two
    on the last) and K0 one, against the same solve on the CPU."""
    rng = np.random.default_rng(nb)
    n = 4 * nb
    a = _spd(rng, n) * n
    b = rng.standard_normal((n, 4)).astype(np.float32)
    before = ck.CHOL_PANEL.launches, TRI_INV.launches
    _, Xg = st.posv(st.SymmetricMatrix.from_numpy(a, nb),
                    st.Matrix.from_numpy(b, nb))
    assert ck.CHOL_PANEL.launches - before[0] == 3 * n // nb - 1
    assert TRI_INV.launches - before[1] == n // nb - 1
    _, Xc = st.posv(st.SymmetricMatrix.from_numpy(a, nb, device="cpu"),
                    st.Matrix.from_numpy(b, nb, device="cpu"))
    want = Xc.to_numpy()
    np.testing.assert_allclose(Xg.to_numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


# ---- the wide widths of K4 and K5: 256 .. 512 ----

def test_wide_select_gate_asks_the_kernel(cuda):
    """K4 answers for its own widths on the card, and the CPU gate mirrors
    them: nb up to 128, then 256, 384 and 512 (a chunk's rows of one
    128-column block in the cluster's shared memory, the chunk itself in a
    workspace), nothing between or past; a launch past them raises."""
    for nb in (64, 128, 200, 256, 384, 512, 640):
        assert lk.select_fits(cuda, 1024, nb, 8) == lk.select_width_ok(nb, 8)
    for w in (512, 1024, 5120, 5376):
        for nb in (256, 384, 512):
            assert ig._lu_select_ok(torch.zeros((1, w, nb), device=cuda), nb)
    wide = lk.select_plan(cuda, 5120, 512, 8)
    assert (wide["cluster"], wide["rows"], wide["block"], wide["chunk"]) == \
        (16, 320, 128, "workspace")
    narrow = lk.select_plan(cuda, 5120, 128, 8)
    assert narrow["chunk"] == "shared memory"
    assert narrow["smem_bytes"] < wide["smem_bytes"]
    with pytest.raises(RuntimeError, match="slate_lu_select"):
        lk.lu_select(torch.zeros((1, 1280, 640), device=cuda))


@pytest.mark.parametrize("g,w,nb,nrows", [
    (4, 5120, 256, None), (4, 5120, 512, None), (2, 512, 256, None),
    (2, 1024, 512, None), (2, 1024, 384, (1024, 700))])
def test_wide_select_matches_plain_and_repeats_bitwise(cuda, g, w, nb,
                                                       nrows):
    """K4 at the wide widths: one launch a round, indices equal to the plain
    version's and (all rows live) lu_factor's, the same bits twice."""
    rng = np.random.default_rng(w + nb)
    x = torch.from_numpy(rng.standard_normal((g, w, nb)).astype(
        np.float32)).to(cuda)
    live = None if nrows is None else torch.tensor(nrows, device=cuda)
    before = lk.LU_SELECT.launches
    got = lk.lu_select(x, nrows=live)
    assert lk.LU_SELECT.launches == before + 1
    assert torch.equal(got, lk.lu_select_plain(x, live))
    assert torch.equal(got, lk.lu_select(x, nrows=live))
    if nrows is None:
        assert torch.equal(got, panel_lu(x)[1][:, :nb])
    else:
        assert int(got[1].max()) < nrows[1]


def test_wide_qr_gate_asks_the_kernel(cuda):
    """K5 takes w up to 128 and 256, 384, 512 (by 128-column blocks, T in
    device memory), not 129 or 640; the 2^20-element cap stays the gate's
    on both devices; a launch past the kernel's widths raises."""
    for w, ok in ((128, True), (129, False), (200, False), (256, True),
                  (384, True), (512, True), (640, False)):
        assert qk.panel_fits(cuda, 2048, w, 8) == ok
    assert iq._qr_panel_ok(torch.zeros((4096, 256), device=cuda))
    assert iq._qr_panel_ok(torch.zeros((2048, 512), device=cuda))
    assert not iq._qr_panel_ok(torch.zeros((2049, 512), device=cuda))
    assert qk.panel_cluster(cuda, 4096, 256, 8) == 16
    with pytest.raises(RuntimeError, match="slate_qr_panel"):
        qk.qr_panel(torch.zeros((2048, 640), device=cuda))


@pytest.mark.parametrize("m,w", [(4096, 256), (2048, 512), (3000, 256),
                                 (1152, 384)])
def test_wide_qr_panel_matches_plain_and_repeats_bitwise(cuda, m, w):
    """K5 at the wide widths against its plain version (1e-4 + 1e-4
    |plain|), Q R = A through the compact WY, one launch, the same bits
    twice."""
    rng = np.random.default_rng(m + w)
    x = torch.from_numpy(rng.standard_normal((m, w)).astype(
        np.float32)).to(cuda)
    before = qk.QR_PANEL.launches
    got = qk.qr_panel(x)
    assert qk.QR_PANEL.launches == before + 1
    for g, p in zip(got, qk.qr_panel_plain(x)):
        torch.testing.assert_close(g, p, rtol=RTOL, atol=ATOL)
    assert all(torch.equal(g, h) for g, h in zip(got, qk.qr_panel(x)))
    packed, T = (t.double() for t in got)
    v = torch.tril(packed, -1)
    v[torch.arange(w), torch.arange(w)] = 1
    r = torch.zeros_like(packed)
    r[:w] = torch.triu(packed[:w])
    qr_ = r - v @ (T @ (v.T @ r))
    assert float((qr_ - x.double()).abs().max()) < 1e-4 * float(
        x.abs().max()) * m ** 0.5


# ---- the redesigned wide routes: K1's lookahead factor, K5's strips ----

@pytest.mark.parametrize("n", [256, 512, 1024])
def test_wide_chol_tile_stamps_order_and_bits(cuda, n):
    """K1's wide route with wf_chol's stamps (chol_tile_stamps, which the
    launch count leaves out): the same bits as the wrapper's launch (the
    stamps change no arithmetic), a cluster of 8 or 16 CTAs, and each
    step's stamps in order: the step's start before rank 0's chain end and
    every worker's end, and those before the step's closing barrier."""
    a = torch.from_numpy(_spd(np.random.default_rng(n + 1), n)).to(cuda)
    before = ck.CHOL_TILE.launches
    got, stamps, cluster = ck.chol_tile_stamps(a)
    assert ck.CHOL_TILE.launches == before
    assert torch.equal(got, ck.chol_tile(a, 8))
    assert cluster in (8, 16)
    s, nt = stamps.cpu().tolist(), n // 128
    assert 0 < s[nt][0] <= s[0][0] <= s[0][16]
    for j in range(1, nt):
        assert s[j - 1][16] <= s[j][0] <= s[j][16]
        assert s[j - 1][16] <= max(s[j][1:cluster]) <= s[j][16]


@pytest.mark.parametrize("mm,w,bw,zero", [
    (4096, 256, 8, None), (2048, 512, 8, None), (3000, 256, 8, None),
    (512, 512, 8, None), (512, 512, 1, None), (512, 512, 3, None),
    (2048, 512, 3, None), (3000, 256, 1, None), (1024, 256, 8, 130),
    (2048, 512, 8, 200)])
def test_wide_qr_panel_strips_edges(cuda, mm, w, bw, zero):
    """K5 past 128 (the block factors on a cluster, the T merges and the
    strip updates of the columns right of each block as launches of their
    own, one wrapper launch): mm = w, slabs of 1 and 3 columns that leave a
    ragged last slab, 3000 rows; packed and T within 1e-4 + 1e-4 |plain|,
    ||QR - A|| / max|A| < 1e-5 sqrt(mm), the same bits twice.  A zero
    column in the second block (mu = 0) gets tau = 0 and keeps its
    entries."""
    rng = np.random.default_rng(mm + w + bw)
    x_np = rng.standard_normal((mm, w)).astype(np.float32)
    if zero is not None:
        x_np[:, zero] = 0.0
    x = torch.from_numpy(x_np).to(cuda)
    before = qk.QR_PANEL.launches
    got = qk.qr_panel(x, bw)
    assert qk.QR_PANEL.launches == before + 1
    for g, p in zip(got, qk.qr_panel_plain(x, bw)):
        assert bool(((g - p).abs() <= ATOL + RTOL * p.abs()).all())
    assert all(torch.equal(g, h) for g, h in zip(got, qk.qr_panel(x, bw)))
    packed, T = (t.double() for t in got)
    v = torch.tril(packed, -1)
    v[torch.arange(w), torch.arange(w)] = 1
    r = torch.zeros_like(packed)
    r[:w] = torch.triu(packed[:w])
    qr_ = r - v @ (T @ (v.T @ r))
    assert float((qr_ - x.double()).abs().max()) < 1e-5 * float(
        x.abs().max()) * mm ** 0.5
    if zero is not None:
        assert float(got[1][zero, zero]) == 0.0
        assert torch.equal(got[0][zero + 1:, zero], x[zero + 1:, zero])


def test_wide_calu_and_gels_launch_the_kernels(cuda):
    """CALU gesv at nb = 256 sends every tournament round to K4 and every
    clean factor to K3; the QR gels at nb = 512 every panel to K5."""
    rng = np.random.default_rng(31)
    n, nb = 2048, 256
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = torch.from_numpy(q.astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((n, 4)).astype(
        np.float32)).to(cuda)
    k4, k3 = lk.LU_SELECT.launches, lk.LU_PANEL.launches
    _, X = st.gesv(st.Matrix.from_numpy(a, nb), st.Matrix.from_numpy(b, nb),
                   {st.Option.MethodLU: st.MethodLU.CALU})
    panels = n // nb - 1
    assert lk.LU_PANEL.launches - k3 == 2 * panels
    assert lk.LU_SELECT.launches - k4 >= panels
    x = X.to_dense()
    assert float((a @ x - b).abs().max()) < 1e-3 * float(b.abs().max())
    m, nq, nbq = 2048, 1024, 512
    aq = torch.from_numpy(rng.standard_normal((m, nq)).astype(
        np.float32)).to(cuda)
    bq = torch.from_numpy(rng.standard_normal((m, 3)).astype(
        np.float32)).to(cuda)
    k5 = qk.QR_PANEL.launches
    X = st.gels(st.Matrix.from_numpy(aq, nbq), st.Matrix.from_numpy(bq, nbq),
                {st.Option.MethodGels: st.MethodGels.QR})
    assert qk.QR_PANEL.launches - k5 == nq // nbq
    want = torch.linalg.lstsq(aq.double(), bq.double()).solution
    assert float((X.to_dense().double() - want).abs().max()) < \
        1e-4 * float(want.abs().max())


# ---- the serving kernels at the tuned plan's width: K6-K8 past 128 ----

@pytest.mark.parametrize("nb", [256, 384, 512])
@pytest.mark.parametrize("chol", [True, False], ids=["K6", "K7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_batched_panels_match_plain_and_repeat(cuda, dtype, chol, nb):
    """K6 and K7 at nb = 256, 384 and 512 against their plain versions: K
    = nb of history and M = 2 nb with a live, a partly dead and a wholly
    dead problem (three launches), then M = nb (two launches): live tiles
    within the tolerance, dead tiles bit-equal to col, two launches bit
    for bit, and each problem alone bit-equal to its slot in the batch."""
    rng = np.random.default_rng(nb + chol)
    kern, plain, counter = ((ck.chol_panel_batched,
                             ck.chol_panel_batched_plain,
                             ck.CHOL_PANEL_BATCHED) if chol else
                            (lk.lu_panel_batched, lk.lu_panel_batched_plain,
                             lk.LU_PANEL_BATCHED))
    for k, m, tiles_b in ((1, 2 * nb, (3, 2, 1)), (0, nb, (1, 0, 1))):
        col, left, lead = _batched_panel(rng, 3, m, nb, k, chol, dtype,
                                         cuda)
        tiles = torch.tensor(tiles_b, dtype=torch.int32, device=cuda)
        before = counter.launches
        got = kern(col, left, lead, tiles, k, 8)
        assert counter.launches == before + (2 if m == nb else 3)
        want = plain(col, left, lead, tiles, k, 8)
        live = ck.live_rows(tiles, k, m, nb)
        for g, w, h in zip(got, want, kern(col, left, lead, tiles, k, 8)):
            assert g.dtype == dtype
            _close_storage(g, w)
            assert torch.equal(_bits(torch.where(live, col, g)), _bits(col))
            assert torch.equal(_bits(g), _bits(h))
        for b in range(3):
            one = kern(col[b:b + 1], left[b:b + 1], lead[b:b + 1],
                       tiles[b:b + 1], k, 8)
            for g, h in zip(got, one):
                assert torch.equal(_bits(g[b]), _bits(h[0]))


@pytest.mark.parametrize("mm,w", [(512, 256), (768, 384), (1024, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_qr_panel_batched_matches_plain_and_repeats(cuda, dtype, mm,
                                                          w):
    """K8 at w = 256, 384 and 512 against its plain version (K5's wide
    blocking), one launch; a rows = 0 slot keeps its bits with T = 0; two
    launches and a problem run alone give the same bits."""
    rng = np.random.default_rng(mm + w)
    a = torch.from_numpy(rng.standard_normal((3, mm, w)).astype(
        np.float32)).to(cuda).to(dtype)
    rows = torch.tensor([mm, 0, mm - 7], dtype=torch.int32, device=cuda)
    before = qk.QR_PANEL_BATCHED.launches
    got = qk.qr_panel_batched(a, rows)
    assert qk.QR_PANEL_BATCHED.launches == before + 1
    for g, p in zip(got, qk.qr_panel_batched_plain(a, rows)):
        assert g.dtype == dtype
        _close_storage(g, p)
    assert all(torch.equal(_bits(g), _bits(h))
               for g, h in zip(got, qk.qr_panel_batched(a, rows)))
    assert torch.equal(_bits(got[0][1]), _bits(a[1]))
    assert not got[1][1].any()
    alone = qk.qr_panel_batched(a[2:], rows[2:])
    assert all(torch.equal(_bits(g[2]), _bits(h[0]))
               for g, h in zip(got, alone))


def test_wide_batched_gates_mirror_the_kernels_and_refuse(cuda):
    """The CPU mirrors of K6's, K7's and K8's gates equal the kernels'
    answers at every width from 1 to 512; past them the wrappers raise
    (they never take the plain version on the card)."""
    from slate_tpu_torch.internal.kernels import fits
    for nb in range(1, 513):
        for bw in (3, 8, 16, 256):
            assert fits(ck.CHOL_PANEL_BATCHED,
                        "slate_chol_panel_batched_fits", cuda, nb, bw) == \
                ck.batched_width_ok(nb, bw), (nb, bw)
            assert fits(lk.LU_PANEL_BATCHED,
                        "slate_lu_panel_batched_fits", cuda, nb, bw) == \
                lk.batched_width_ok(nb, bw), (nb, bw)
        for bw in (1, 8, 9):
            assert qk.batched_panel_fits(cuda, 1024, nb, bw) == \
                qk.batched_width_ok(1024, nb, bw), (nb, bw)
    assert not qk.batched_panel_fits(cuda, 300, 384, 8)
    assert not qk.batched_width_ok(300, 384, 8)
    rng = np.random.default_rng(33)
    for kern, chol, nb, bw in ((ck.chol_panel_batched, True, 192, 8),
                               (lk.lu_panel_batched, False, 384, 12)):
        col, left, lead = _batched_panel(rng, 1, nb, nb, 0, chol,
                                         torch.float32, cuda)
        with pytest.raises(ValueError, match="past the kernel's limits"):
            kern(col, left, lead, torch.ones(1, dtype=torch.int32,
                                             device=cuda), 0, bw)
    with pytest.raises(RuntimeError, match="slate_qr_panel_batched"):
        qk.qr_panel_batched(torch.zeros((1, 1024, 640), device=cuda),
                            torch.ones(1, dtype=torch.int32, device=cuda))


def test_ragged_plan_takes_the_plans_width_on_the_card(cuda):
    """On CUDA tensors the serving route takes nb = min(plan.nb, bucket)
    where the kernel's gate takes it: 512 for a 4096 bucket under the
    override, 128 under the default plan."""
    from slate_tpu_torch.serve import batched as sb
    a = torch.zeros((2, 4096, 4096), device=cuda)
    tall = torch.zeros((2, 4096, 2048), device=cuda)
    for op, key, x in (("solve", "batch_getrf", a),
                       ("chol_solve", "batch_potrf", a),
                       ("least_squares_solve", "batch_geqrf", tall)):
        assert sb._ragged_plan(op, x, None) == sb.RaggedPlan(128, 8)
        with st.plan_override(key, st.TilePlan("cuda", 8, 512)):
            assert sb._ragged_plan(op, x, None) == sb.RaggedPlan(512, 8)
        with st.plan_override(key, st.TilePlan("cuda", 8, 384)):
            assert sb._ragged_plan(op, x, None) is None      # 4096 % 384
