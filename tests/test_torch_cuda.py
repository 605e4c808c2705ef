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
    with pytest.raises(ValueError, match="nb = 256"):
        col, left, lead = _panel(rng, 512, 256, 8, cuda)
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
    128} with bw dividing it; past that the no-pivot route takes the
    library, and a launch raises."""
    for nb in (32, 64, 96, 128):
        assert lk.panel_fits(cuda, nb, 8)
        assert ig._nopiv_fused_ok(torch.zeros((2 * nb, nb), device=cuda))
    assert not lk.panel_fits(cuda, 256, 8)
    assert not lk.panel_fits(cuda, 48, 8)
    assert not lk.panel_fits(cuda, 128, 48)
    assert not ig._nopiv_fused_ok(torch.zeros((512, 256), device=cuda))
    with pytest.raises(ValueError, match="slate_lu_panel_fits"):
        lk.lu_panel_fused(torch.zeros((512, 256), device=cuda), 8)


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
