"""The serving slice's kernels K6-K8 (their plain versions), the ragged
batched drivers of internal/batched.py, the batched healths, the
certificates and the precision seam, against slate_tpu on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held against ``slate_tpu``'s Pallas kernels run as its own tests run them
(``interpret=True``), on the same numpy inputs, in f32 and in bf16
storage.  Contracts the reference states as exact stay exact: dead tiles
and filler slots are bit-equal to the input.  The CUDA kernels themselves
run only on the card (tests/test_torch_cuda.py).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from slate_tpu.internal import batched as ref_batched
from slate_tpu.internal.pallas_chol import chol_panel_batched as ref_chol
from slate_tpu.internal.pallas_lu import lu_panel_batched as ref_lu
from slate_tpu.internal.pallas_qr import qr_panel_batched as ref_qr
from slate_tpu.robust import certify as ref_certify
from slate_tpu.robust import precision as ref_precision

import slate_tpu_torch as st
from slate_tpu_torch.convert import health_from_jax
from slate_tpu_torch.internal import batched as bk
from slate_tpu_torch.internal import chol_kernels as ck
from slate_tpu_torch.internal import lu_kernels as lk
from slate_tpu_torch.internal import qr_kernels as qk
from slate_tpu_torch.robust import certify, precision
from slate_tpu_torch.tune import plans

# f32: the reference sums K in nb-wide chunks and inverts U by its
# nilpotent series, the plain versions in one product and by back
# substitution; on the well-conditioned stacks below (cond <= ~10) the
# factors agree to a few 1e-6 of their largest entry, held at 1e-4.
F32_RTOL = 1e-4
# bf16 storage: both sides form the same f32 values up to that order and
# round each store to bf16's 8 significant bits, so an entry may land one
# bf16 ulp (2^-7 relative) apart: |port - ref| <= 2^-7 |ref| + 1e-3 max|ref|
BF16_RTOL = 2.0 ** -7
BF16 = {"f32": (np.float32, torch.float32, jnp.float32),
        "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def _close(got, want, kind="f32"):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, dtype=np.float32)
    scale = max(np.abs(want[np.isfinite(want)]).max(initial=0.0), 1.0)
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_RTOL * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=1e-3 * scale)


def _bits(x):
    """Raw storage bits of a torch tensor or a jax/numpy array."""
    if isinstance(x, torch.Tensor):
        return (x.contiguous().view(torch.int16).numpy()
                if x.dtype == torch.bfloat16 else x.contiguous().numpy()
                .view(np.int32))
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x.view(np.int32)


def _pair(a, kind):
    """The same values in both packages' storage dtype (bf16 values are
    exact in f32, so the two round identically)."""
    _, tdt, jdt = BF16[kind]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _spd_stack(rng, n, sizes):
    """Identity-augmented SPD slots [B, n, n] (serve pad_square packing);
    size-0 slots stay zero."""
    a = np.zeros((len(sizes), n, n), np.float32)
    for i, s in enumerate(sizes):
        if s:
            g = rng.standard_normal((s, s)).astype(np.float32)
            a[i, :s, :s] = g @ g.T / s + np.eye(s, dtype=np.float32)
            idx = np.arange(s, n)
            a[i, idx, idx] = 1.0
    return a


def _dd_stack(rng, n, sizes):
    """Identity-augmented diagonally dominant slots (NoPiv-LU-safe)."""
    a = np.zeros((len(sizes), n, n), np.float32)
    for i, s in enumerate(sizes):
        if s:
            g = rng.standard_normal((s, s)).astype(np.float32)
            a[i, :s, :s] = g / np.float32(np.sqrt(s)) + 4 * np.eye(
                s, dtype=np.float32)
            idx = np.arange(s, n)
            a[i, idx, idx] = 1.0
    return a


# -------------------------------------------------- K6 and K7, plain


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("chol", [True, False], ids=["K6", "K7"])
def test_batched_panel_plain_matches_the_pallas_kernel(kind, chol):
    """Every panel step of a factorization of a mixed-size stack (sizes 64,
    40, 17 and a filler slot, nb = 32: live, partly dead and wholly dead
    tiles at k = 0 and k = 1), the plain K6/K7 against the reference's
    batched Pallas kernel in interpret mode; dead tiles bit-equal."""
    rng = np.random.default_rng(1 if chol else 2)
    n, nb = 64, 32
    sizes = [64, 40, 17, 0]
    a = (_spd_stack if chol else _dd_stack)(rng, n, sizes)
    fa_t, fa_j = _pair(a, kind)
    tiles_t = bk.tile_counts(torch.tensor(sizes, dtype=torch.int32), nb)
    tiles_j = jnp.asarray(np.asarray(tiles_t))
    for k in range(n // nb):
        k0, k1 = k * nb, (k + 1) * nb
        if chol:
            got = ck.chol_panel_batched(fa_t[:, k0:, k0:k1], fa_t[:, k0:, :k0],
                                        fa_t[:, k0:k1, :k0].mT, tiles_t, k, 8)
            want = ref_chol(fa_j[:, k0:, k0:k1], fa_j[:, k0:, :k0],
                            jnp.swapaxes(fa_j[:, k0:k1, :k0], 1, 2), tiles_j,
                            k=k, bw=8, interpret=True)
        else:
            got = lk.lu_panel_batched(fa_t[:, k0:, k0:k1], fa_t[:, k0:, :k0],
                                      fa_t[:, :k0, k0:k1], tiles_t, k, 8)
            want = ref_lu(fa_j[:, k0:, k0:k1], fa_j[:, k0:, :k0],
                          fa_j[:, :k0, k0:k1], tiles_j, k=k, bw=8,
                          interpret=True)
        live = ck.live_rows(tiles_t, k, n - k0, nb)
        for g, w in zip(got, want):
            assert g.dtype == fa_t.dtype and g.shape == w.shape
            _close(g, w, kind)
            dead = ~live.expand_as(g)
            np.testing.assert_array_equal(_bits(g)[dead.numpy()],
                                          _bits(w)[dead.numpy()])
        # carry the reference's factor on, so both see the same next panel
        fa_j = fa_j.at[:, k0:, k0:k1].set(want[1])
        fa_t = torch.from_numpy(np.array(fa_j.astype(jnp.float32))).to(
            fa_t.dtype)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_chol_panel_batched_plain_matches_the_pallas_kernel_deep(kind):
    """K6's plain version at k = 16 (K = 512 columns of history, nb = 32,
    M = 64) on a live problem, one whose second row tile is dead and a
    filler slot (tiles = 0), against the reference's batched Pallas kernel
    in interpret mode: live tiles within the tolerances above (the plain
    version forms U^-1 by K0's blocked doubling, the reference by its
    series; the top blocks have cond <= ~5), dead tiles and the filler
    slot bit-equal to col in both outputs.  lead is left's top rows, as
    batch_potrf passes it, so the top block of col - left @ lead stays
    symmetric in bf16 storage too: the plain version reads its lower
    triangle, the reference its upper."""
    rng = np.random.default_rng(5)
    bsz, m, nb, k = 3, 64, 32, 16
    kk = k * nb
    left = (0.05 * rng.standard_normal((bsz, m, kk))).astype(np.float32)
    base = rng.standard_normal((bsz, m, nb))
    top = base[:, :nb]
    base[:, :nb] = top @ top.transpose(0, 2, 1) / nb + np.eye(nb)
    col = base + left.astype(np.float64) @ left[:, :nb].transpose(0, 2, 1)
    (col_t, col_j), (left_t, left_j) = (_pair(x.astype(np.float32), kind)
                                        for x in (col, left))
    tiles = [k + 2, k + 1, 0]
    tiles_t = torch.tensor(tiles, dtype=torch.int32)
    got = ck.chol_panel_batched(col_t, left_t, left_t[:, :nb].mT, tiles_t, k,
                                8)
    want = ref_chol(col_j, left_j, jnp.swapaxes(left_j[:, :nb], 1, 2),
                    jnp.asarray(tiles, jnp.int32), k=k, bw=8,
                    interpret=True)
    live = ck.live_rows(tiles_t, k, m, nb).expand(bsz, m, nb)
    assert live[0].all() and live[1, :nb].all() and not live[1, nb:].any()
    for g, w in zip(got, want):
        assert g.dtype == col_t.dtype and g.shape == w.shape
        _close(g, w, kind)
        dead = (~live).numpy()
        np.testing.assert_array_equal(_bits(g)[dead], _bits(col_t)[dead])
        np.testing.assert_array_equal(_bits(w)[dead], _bits(col_t)[dead])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_lu_panel_batched_plain_matches_the_pallas_kernel_deep(kind):
    """K7's plain version (U^-1 by K0's blocked doubling, as its factor
    launch forms it) at k = 16 (K = 512 columns of history, nb = 32, M =
    64) on a live problem, one whose second row tile is dead and a filler
    slot, against the reference's batched Pallas kernel in interpret mode
    (its U^-1 by the nilpotent series): live tiles within the tolerances
    above (f32: 1e-4 of the largest entry; bf16: one bf16 ulp plus 1e-3 of
    it) on top blocks G / sqrt(nb) + 2 I, dead tiles and the filler slot
    bit-equal to col in both outputs."""
    rng = np.random.default_rng(7)
    bsz, m, nb, k = 3, 64, 32, 16
    kk = k * nb
    left = (0.05 * rng.standard_normal((bsz, m, kk))).astype(np.float32)
    lead = (0.05 * rng.standard_normal((bsz, kk, nb))).astype(np.float32)
    base = rng.standard_normal((bsz, m, nb))
    base[:, :nb] = base[:, :nb] / np.sqrt(nb) + 2 * np.eye(nb)
    col = base + left.astype(np.float64) @ lead
    (col_t, col_j), (left_t, left_j), (lead_t, lead_j) = (
        _pair(x.astype(np.float32), kind) for x in (col, left, lead))
    tiles = [k + 2, k + 1, 0]
    tiles_t = torch.tensor(tiles, dtype=torch.int32)
    got = lk.lu_panel_batched(col_t, left_t, lead_t, tiles_t, k, 8)
    want = ref_lu(col_j, left_j, lead_j, jnp.asarray(tiles, jnp.int32), k=k,
                  bw=8, interpret=True)
    live = ck.live_rows(tiles_t, k, m, nb).expand(bsz, m, nb)
    assert live[0].all() and live[1, :nb].all() and not live[1, nb:].any()
    for g, w in zip(got, want):
        assert g.dtype == col_t.dtype and g.shape == w.shape
        _close(g, w, kind)
        dead = (~live).numpy()
        np.testing.assert_array_equal(_bits(g)[dead], _bits(col_t)[dead])
        np.testing.assert_array_equal(_bits(w)[dead], _bits(col_t)[dead])


@pytest.mark.parametrize("chol", [True, False], ids=["K6", "K7"])
def test_batched_panel_plain_gives_a_problem_alone_its_bits(chol):
    """The plain K6/K7 step on each problem of a batch of 3 alone (as a
    served request's retry runs it) gives bit for bit that problem's slot
    in the batch, in both outputs: nothing of a step depends on the other
    problems in its batch."""
    rng = np.random.default_rng(8)
    bsz, m, nb, k = 3, 96, 32, 2
    kk = k * nb
    left = (0.2 * rng.standard_normal((bsz, m, kk))).astype(np.float32)
    col = rng.standard_normal((bsz, m, nb)).astype(np.float32)
    col[:, :nb] += 4 * np.eye(nb, dtype=np.float32)
    left_t, col_t = torch.from_numpy(left), torch.from_numpy(col)
    if chol:
        col_t[:, :nb] = col_t[:, :nb] @ col_t[:, :nb].mT / nb
        lead_t, step = left_t[:, :nb].mT, ck.chol_panel_batched
    else:
        lead_t = torch.from_numpy((0.2 * rng.standard_normal(
            (bsz, kk, nb))).astype(np.float32))
        step = lk.lu_panel_batched
    tiles = torch.tensor([k + 3, k + 1, k + 2], dtype=torch.int32)
    got = step(col_t, left_t, lead_t, tiles, k, 8)
    for b in range(bsz):
        one = step(col_t[b:b + 1], left_t[b:b + 1], lead_t[b:b + 1],
                   tiles[b:b + 1], k, 8)
        for g, h in zip(got, one):
            np.testing.assert_array_equal(_bits(g[b]), _bits(h[0]))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_qr_panel_batched_plain_matches_the_pallas_kernel(kind):
    """K8's plain version against qr_panel_batched in interpret mode: live
    problems factor the whole panel (T within the tolerance), a rows = 0
    filler slot is bit-equal to its input with T = 0."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 48, 16)).astype(np.float32)
    a[1] = 0.0
    a[1, :16] = np.eye(16, dtype=np.float32)      # a filler slot's packing
    rows = [48, 0, 30]
    at, aj = _pair(a, kind)
    got = qk.qr_panel_batched(at, torch.tensor(rows, dtype=torch.int32))
    want = ref_qr(aj, jnp.asarray(rows, jnp.int32), interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == at.dtype
        _close(g, w, kind)
    np.testing.assert_array_equal(_bits(got[0][1]), _bits(at[1]))
    assert not got[1][1].any()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_qr_panel_batched_plain_keeps_filler_slots_at_both_ends(kind):
    """Filler slots first and last, as the card's check of K8 places them,
    around a live problem whose rows below w are zero (a square panel in
    effect) and a Gaussian one: the live ones match qr_panel_batched in
    interpret mode, the fillers keep their bits with T = 0."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 40, 16)).astype(np.float32)
    a[1, 16:] = 0.0
    rows = [0, 16, 33, 0]
    at, aj = _pair(a, kind)
    got = qk.qr_panel_batched(at, torch.tensor(rows, dtype=torch.int32))
    want = ref_qr(aj, jnp.asarray(rows, jnp.int32), interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == at.dtype
        _close(g, w, kind)
    for b in (0, 3):
        np.testing.assert_array_equal(_bits(got[0][b]), _bits(at[b]))
        assert not got[1][b].any()


# ------------------------------------------- internal/batched.py drivers


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_batch_potrf_and_health_match_the_reference(kind):
    """batch_potrf over sizes 1, 40, 64 and a filler slot against the
    reference's on its Pallas kernels; the padding region of each factor
    bit-equal to the augmented input (exactly I, exactly 0), the filler
    slot untouched; batch_chol_health field for field, an indefinite
    problem read as not ok."""
    rng = np.random.default_rng(4)
    n, nb, sizes = 64, 32, [1, 40, 64, 0]
    a = _spd_stack(rng, n, sizes)
    a[1, 3, 3] = -50.0                              # indefinite: NaN in L
    at, aj = _pair(a, kind)
    sz = torch.tensor(sizes, dtype=torch.int32)
    fa, counts = bk.batch_potrf(at, sz, nb=nb, bw=8)
    assert counts.detected.tolist() == [0] * len(sizes)
    ref, _ = ref_batched.batch_potrf(aj, jnp.asarray(sizes, jnp.int32),
                                     nb=nb, bw=8, interpret=True)
    for b, s in enumerate(sizes):
        if b == 1:
            continue                                # NaN-poisoned factor
        _close(torch.tril(fa[b]), np.tril(np.asarray(ref[b], np.float32)),
               kind)
        np.testing.assert_array_equal(_bits(fa[b, s:]), _bits(at[b, s:]))
        np.testing.assert_array_equal(_bits(fa[b, :, s:]), _bits(at[b, :, s:]))
    h = bk.batch_chol_health(fa)
    want = health_from_jax(ref_batched.batch_chol_health(
        ref.astype(jnp.float32)))
    assert [x.ok for x in h] == [x.ok for x in want] == [True, False, True,
                                                         False]
    for x, w in zip(h, want):
        assert (x.info, x.min_pivot_index, x.nonfinite) == \
            (w.info, w.min_pivot_index, w.nonfinite)
        np.testing.assert_allclose(x.min_pivot, w.min_pivot, rtol=1e-2)


def test_batch_getrf_getrs_and_health_match_the_reference():
    """batch_getrf (packed L\\U, exact padding) and batch_getrs against the
    reference, and batch_lu_health field for field, a zero leading pivot
    read as not ok (its NaN row reaches the pivots first)."""
    rng = np.random.default_rng(5)
    n, nb, sizes = 64, 32, [1, 40, 64, 0]
    a = _dd_stack(rng, n, sizes)
    b = rng.standard_normal((4, n, 3)).astype(np.float32)
    sz = torch.tensor(sizes, dtype=torch.int32)
    fa = bk.batch_getrf(torch.from_numpy(a), sz, nb=nb, bw=8)
    ref = ref_batched.batch_getrf(jnp.asarray(a), jnp.asarray(sizes,
                                                              jnp.int32),
                                  nb=nb, bw=8, interpret=True)
    _close(fa, ref)
    for i, s in enumerate(sizes):
        np.testing.assert_array_equal(fa[i, s:].numpy(), a[i, s:])
        np.testing.assert_array_equal(fa[i, :, s:].numpy(), a[i, :, s:])
    _close(bk.batch_getrs(fa, torch.from_numpy(b)),
           ref_batched.batch_getrs(ref, jnp.asarray(b)))
    a[2, 0, 0] = 0.0                                 # NoPiv meets a zero pivot
    fa = bk.batch_getrf(torch.from_numpy(a), sz, nb=nb, bw=8)
    ref = ref_batched.batch_getrf(jnp.asarray(a), jnp.asarray(sizes,
                                                              jnp.int32),
                                  nb=nb, bw=8, interpret=True)
    h = bk.batch_lu_health(torch.from_numpy(a), fa)
    want = health_from_jax(ref_batched.batch_lu_health(jnp.asarray(a), ref))
    assert h[2].info == want[2].info > 0 and not h[2].ok
    for x, w in zip(h, want):
        assert (x.ok, x.info, x.min_pivot_index) == \
            (w.ok, w.info, w.min_pivot_index)
        if np.isfinite(w.growth):
            np.testing.assert_allclose(x.growth, w.growth, rtol=1e-3)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_batch_geqrf_and_gels_match_the_reference(kind):
    """batch_geqrf's packed factors and T stack and batch_gels' x through
    the serving packing (a tall problem augmented with identity rows, a
    full one, a filler slot), against the reference on its Pallas panel;
    the filler slot's packed panel bit-equal to its input."""
    rng = np.random.default_rng(6)
    mb, nbq, w = 48, 32, 16
    a = np.zeros((3, mb, nbq), np.float32)
    b = np.zeros((3, mb, 2), np.float32)
    rows = []
    for i, (m, nn) in enumerate([(20, 13), (mb, nbq), (0, 0)]):
        if m == 0:
            a[i, :nbq, :nbq] = np.eye(nbq, dtype=np.float32)
            rows.append(0)
            continue
        a[i, :m, :nn] = rng.standard_normal((m, nn))
        a[i, m:m + nbq - nn, nn:] = np.eye(nbq - nn, dtype=np.float32)
        b[i, :m] = rng.standard_normal((m, 2))
        rows.append(m + nbq - nn)
    at, aj = _pair(a, kind)
    rt = torch.tensor(rows, dtype=torch.int32)
    packed, ts = bk.batch_geqrf(at, rt, nb=w, bw=8)
    rp, rts = ref_batched.batch_geqrf(aj, jnp.asarray(rows, jnp.int32),
                                      nb=w, interpret=True)
    assert ts.shape == rts.shape == (3, nbq // w, w, w)
    _close(packed, rp, kind)
    _close(ts, rts, kind)
    np.testing.assert_array_equal(_bits(packed[2]), _bits(at[2]))
    x, _ = bk.batch_gels(at, torch.from_numpy(b), rt, nb=w, bw=8)
    rx, _ = ref_batched.batch_gels(aj, jnp.asarray(b),
                                   jnp.asarray(rows, jnp.int32), nb=w,
                                   interpret=True)
    assert x.dtype == torch.float32
    _close(x, rx, kind)


def test_tile_counts_and_unported_abft():
    sz = torch.tensor([0, 1, 32, 33, 64], dtype=torch.int32)
    got = bk.tile_counts(sz, 32)
    assert got.dtype == torch.int32 and got.tolist() == [0, 1, 1, 2, 2]
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_batched.tile_counts(jnp.asarray(sz.numpy()), 32)))
    # the in-batch checksum rungs are ported: an identity slot factors to
    # itself with zero counts (tests/test_torch_abft.py holds the strikes)
    fa, counts = bk.batch_potrf(torch.eye(32)[None], torch.tensor([32]),
                                nb=32, abft=True)
    assert torch.equal(fa[0], torch.eye(32))
    assert [c.tolist() for c in counts] == [[0], [0], [-1]]


# ------------------------------------------ certificates and precision


def test_certificates_match_the_reference():
    """certify_solve and certify_lstsq over a batch (a good solve, a
    perturbed one, a non-finite one) against the reference's, vmapped
    problem by problem: ratio, worst column, converged and finiteness."""
    import jax
    rng = np.random.default_rng(7)
    bsz, n, m, k = 3, 24, 40, 3
    a = rng.standard_normal((bsz, n, n)).astype(np.float32)
    a += 6 * np.eye(n, dtype=np.float32)
    x = np.linalg.solve(a, rng.standard_normal((bsz, n, k))).astype(
        np.float32)
    b = np.einsum("bij,bjk->bik", a, x).astype(np.float32)
    x[1, 2, 1] += 1e-2
    x[2, 0, 0] = np.nan
    r = b - np.einsum("bij,bjk->bik", a, x)
    anorm = np.sqrt((a * a).sum(axis=(1, 2)))
    got = certify.certify_solve(torch.from_numpy(anorm), torch.from_numpy(x),
                                torch.from_numpy(b), torch.from_numpy(r),
                                iters=2).to_list()
    want = health_from_jax(jax.vmap(
        lambda an, xi, bi, ri: ref_certify.certify_solve(an, xi, bi, ri,
                                                         iters=2))(
        anorm, x, b, r))
    assert [h.ok for h in got] == [h.ok for h in want] == [True, False,
                                                           False]
    for g, w in zip(got, want):
        assert (g.iters, g.nonfinite) == (w.iters, w.nonfinite) == \
            (2, g.nonfinite)
        if np.isfinite(w.growth):
            assert g.min_pivot_index == w.min_pivot_index
            np.testing.assert_allclose(g.growth, w.growth, rtol=1e-3)
    at = rng.standard_normal((bsz, m, n)).astype(np.float32)
    bt = rng.standard_normal((bsz, m, k)).astype(np.float32)
    xt = np.stack([np.linalg.lstsq(at[i], bt[i], rcond=None)[0]
                   for i in range(bsz)]).astype(np.float32)
    xt[1] *= 1.01
    rn = np.einsum("bji,bjk->bik", at, bt - np.einsum("bij,bjk->bik", at, xt))
    an = np.sqrt((at * at).sum(axis=(1, 2)))
    got = certify.certify_lstsq(torch.from_numpy(an), torch.from_numpy(xt),
                                torch.from_numpy(bt),
                                torch.from_numpy(rn)).to_list()
    want = health_from_jax(jax.vmap(ref_certify.certify_lstsq)(an, xt, bt,
                                                               rn))
    assert [h.ok for h in got] == [h.ok for h in want]
    for g, w in zip(got, want):
        assert g.min_pivot_index == w.min_pivot_index
        np.testing.assert_allclose(g.growth, w.growth, rtol=1e-3)
    assert certify.tolerance(torch.float32, 100) == \
        ref_certify.tolerance(np.float32, 100)
    assert certify.tolerance("bfloat16", 10) == pytest.approx(
        50 * 10 * 2.0 ** -7)


def test_precision_seam_matches_the_reference():
    for spelling in ("bf16", "bfloat16", "f32", "fp32", "float32", "f64",
                     np.float32, np.dtype("float64")):
        assert precision.normalize_dtype(spelling) == \
            ref_precision.normalize_dtype(spelling)
    assert precision.normalize_dtype(torch.bfloat16) == "bfloat16"
    assert precision.normalize_dtype(torch.zeros(1).dtype) == "float32"
    assert (precision.HIGH, precision.LOW) == (ref_precision.HIGH,
                                               ref_precision.LOW)
    with pytest.raises(st.SlateUnsupportedDtypeError) as e:
        precision.normalize_dtype(torch.float16,
                                  supported=("float32", "bfloat16"))
    assert e.value.dtype == "float16"
    with pytest.raises(st.SlateUnsupportedDtypeError):
        precision.normalize_dtype("not-a-dtype")
    x = torch.tensor([1.0, 1.0 + 2.0 ** -9, 3.0])
    assert precision.demote(x).dtype == torch.bfloat16
    assert precision.promote(precision.demote(x)).dtype == torch.float32
    np.testing.assert_array_equal(
        precision.round_through(x).numpy(),
        np.asarray(ref_precision.round_through(jnp.asarray(x.numpy()))))
    opts = {st.Option.Precision: st.Precision.Bf16}
    assert precision.resolve_precision(opts)
    assert not precision.resolve_precision(None)


def test_batch_plans_default_to_the_kernels(monkeypatch, tmp_path):
    """The batch ops' default plan is the hand kernel for f32 and bf16
    (K6-K8 take bf16 storage), the library for anything else; with an
    empty plan cache there is no tuned serving ladder."""
    cache = tmp_path / "plans.json"
    monkeypatch.setenv("SLATE_TORCH_TUNE_CACHE", str(cache))
    plans.save_cache({"version": plans.SCHEMA_VERSION, "chips": {}},
                     str(cache))
    for op in plans.BATCH_OPS:
        assert op in plans.OPS
        for dt in ("float32", "bfloat16"):
            assert plans.resolve_plan(op, 256, dt) == plans.CUDA_PLAN
        assert plans.resolve_plan(op, 256, "float64") == plans.LIBRARY_PLAN
        with plans.plan_override(op, plans.LIBRARY_PLAN):
            assert plans.resolve_plan(op, 256).kernel == "torch"
    assert plans.resolve_plan("potrf_panel", 256, "bfloat16") == \
        plans.LIBRARY_PLAN
    assert plans.serve_buckets("float32") is None
