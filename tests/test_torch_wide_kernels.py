"""K0-K3 at the reference's wide widths, against its Pallas kernels.

K1 (chol_tile) takes tiles up to 1024, K2 (chol_panel_fused) and K3
(lu_panel_fused) panels of 256, 384 and 512 columns, K0 (upper_tri_inv)
tiles up to 512: the widths the reference's gates give its Pallas kernels
(slate_tpu/internal/potrf.py:40-68, getrf.py:67-75).  On the CPU each
wrapper runs its kernel's plain version, held here against the reference's
Pallas kernel run as its own tests run it (``interpret=True``) on the same
numpy inputs, and the port's posv at nb = 256 against the reference's posv
on its Pallas panel.  The CUDA kernels at these widths run only on the card
(tests/test_torch_cuda.py, the ``wide`` tests).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import slate_tpu as ref
from slate_tpu.internal.pallas_chol import chol_panel_fused as ref_panel
from slate_tpu.internal.pallas_chol import chol_tile_pallas
from slate_tpu.internal.pallas_lu import lu_panel_fused as ref_lu_panel
from slate_tpu.tune import TilePlan as RefPlan
from slate_tpu.tune import plan_override as ref_override

import slate_tpu_torch as st
from slate_tpu_torch.internal import chol_kernels as ck
from slate_tpu_torch.internal import lu_kernels as lk
from slate_tpu_torch.internal import potrf as ip
from slate_tpu_torch.internal.tri_inv import TRI_INV, upper_tri_inv

# f32 tolerances as tests/test_torch_kernels.py states them: the plain
# versions repeat the reference's arithmetic, so the two sides differ only
# in the order of f32 sums, ~n eps relative on these inputs (cond <= ~5).
RTOL, ATOL = 2e-5, 2e-5


def _spd(rng, n):
    g = rng.standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


def _first_bad(l):
    d = np.diag(l)
    return int(np.flatnonzero(~(np.isfinite(d) & (d > 0)))[0])


@pytest.mark.parametrize("n", [256, 512, 1024, 160])
def test_wide_chol_tile_plain_matches_pallas(n):
    """K1's plain version at the wide tiles against chol_tile_pallas where
    the reference's gate takes the tile (n % 128 == 0), RTOL/ATOL 2e-5;
    n = 160 (past the reference's gate, inside the port's n % 32) against
    numpy's f64 factor of the same bytes."""
    a = _spd(np.random.default_rng(n), n)
    got = ck.chol_tile(torch.from_numpy(a), bw=8).numpy()
    assert np.all(np.triu(got, 1) == 0)
    if n % 128 == 0:
        want = np.asarray(chol_tile_pallas(jnp.asarray(a), bw=8,
                                           interpret=True))
    else:
        want = np.linalg.cholesky(a.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert ck.CHOL_TILE.launches == 0


def test_wide_chol_tile_first_bad_pivot_matches_pallas():
    """An indefinite 512 tile whose pivot at column 300 (the third 128
    block) is ~ -6: the first non-finite or non-positive diagonal entry is
    300 in both, every later one non-finite in both, and the columns before
    it agree within RTOL/ATOL 2e-5."""
    bad = 300
    a = _spd(np.random.default_rng(bad), 512)
    a[bad, bad] -= 8.0
    got = ck.chol_tile(torch.from_numpy(a), bw=8).numpy()
    want = np.asarray(chol_tile_pallas(jnp.asarray(a), bw=8, interpret=True))
    assert _first_bad(got) == _first_bad(want) == bad
    assert not np.isfinite(np.diag(got)[bad + 1:]).any()
    assert not np.isfinite(np.diag(want)[bad + 1:]).any()
    np.testing.assert_allclose(got[:bad, :bad], want[:bad, :bad], rtol=RTOL,
                               atol=ATOL)


def _spd_panel(rng, m, nb, k):
    """(col, left, lead) with an SPD top block in col - left @ lead (the
    construction of tests/test_pallas.py)."""
    base = rng.standard_normal((m, nb)).astype(np.float32)
    top = base[:nb] @ base[:nb].T / nb + nb * np.eye(nb, dtype=np.float32)
    target = np.concatenate([top, base[nb:]], axis=0)
    left = rng.standard_normal((m, k)).astype(np.float32) * 0.01
    lead = left[:nb].T.copy()
    return target + left @ lead, left, lead


@pytest.mark.parametrize("m,nb,k", [(768, 256, 0), (768, 256, 256),
                                    (768, 256, 200), (1024, 512, 512)])
def test_wide_chol_panel_plain_matches_pallas(m, nb, k):
    """K2's plain version at nb = 256 (K = 0, 256 and a ragged 200, which
    the Pallas version pads with zeros and the CUDA kernel masks) and at
    nb = 512, against chol_panel_fused in interpret mode."""
    col, left, lead = _spd_panel(np.random.default_rng(m + nb + k), m, nb, k)
    upd, fac = ck.chol_panel_fused(torch.from_numpy(col),
                                   torch.from_numpy(left),
                                   torch.from_numpy(lead), bw=8)
    rupd, rfac = ref_panel(jnp.asarray(col), jnp.asarray(left),
                           jnp.asarray(lead), bw=8, interpret=True)
    # upd entries are O(nb) on the diagonal: absolute error ~ nb eps
    np.testing.assert_allclose(upd.numpy(), np.asarray(rupd), rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_allclose(fac.numpy(), np.asarray(rfac), rtol=RTOL,
                               atol=ATOL)
    assert ck.CHOL_PANEL.launches == 0 and TRI_INV.launches == 0


def test_wide_lu_panel_plain_matches_pallas():
    """K3's plain version on a diagonally dominant 768 x 256 panel against
    lu_panel_fused in interpret mode, atol 1e-5 (the reference's series
    inverse is accurate on a U this close to diagonal)."""
    rng = np.random.default_rng(768)
    p = rng.standard_normal((768, 256)).astype(np.float32)
    p[:256] += 256 * np.eye(256, dtype=np.float32)
    got = lk.lu_panel_fused(torch.from_numpy(p), bw=8).numpy()
    want = np.asarray(ref_lu_panel(jnp.asarray(p), bw=8, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    assert lk.LU_PANEL.launches == 0


@pytest.mark.parametrize("n", [256, 512])
def test_wide_upper_tri_inv_plain_matches_f64(n):
    """K0's plain version (the blocked doubling) at 256 and 512 on the U of
    a partially pivoted LU of a Gaussian panel (cond ~100, where the
    reference's series is off by ~1e-2): within 1e-5 of the f64 inverse
    relative to its largest entry."""
    import scipy.linalg
    g = np.random.default_rng(n).standard_normal((4 * n, n))
    u = np.triu(scipy.linalg.lu(g)[2]).astype(np.float32)
    got = upper_tri_inv(torch.from_numpy(u)).numpy().astype(np.float64)
    x64 = np.linalg.inv(u.astype(np.float64))
    assert np.abs(got - x64).max() / np.abs(x64).max() < 1e-5
    assert np.all(np.tril(got, -1) == 0)


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def test_posv_at_nb_256_matches_reference_pallas_route(ref_drivers):
    """The slice as a whole: the port's posv at n = 768, nb = 256 (K2's
    plain version every panel, by the CPU gate that mirrors the card's)
    against the reference's posv forced onto its Pallas panel at 256, the
    same bytes.  Both are backward-stable Cholesky solves with sums in
    another order; cond(A) <= ~2, so the solutions differ by a few n eps
    of max|X| (n eps = 9.2e-5), held at 1e-4."""
    n, nb = 768, 256
    rng = np.random.default_rng(22)
    a0 = rng.standard_normal((n, n)) * 0.1
    a = (a0 @ a0.T + n * 0.01 * np.eye(n) + np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 4)).astype(np.float32)
    assert all(ip.potrf_panel_ok(torch.float32, n - k0, nb, nb)
               for k0 in range(0, n, nb))
    with ref_override("potrf_panel", RefPlan("pallas", nb, 8)):
        _, x_ref = ref.posv(ref.SymmetricMatrix.from_numpy(a, nb),
                            ref.Matrix.from_numpy(b, nb))
    _, x = st.posv(st.SymmetricMatrix.from_numpy(a, nb, device="cpu"),
                   st.Matrix.from_numpy(b, nb, device="cpu"))
    want = np.asarray(x_ref.to_numpy())
    np.testing.assert_allclose(x.to_numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert ck.CHOL_PANEL.launches == 0 and TRI_INV.launches == 0
