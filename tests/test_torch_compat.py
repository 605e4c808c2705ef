"""The port's compatibility layer against slate_tpu's, on the CPU: the
ScaLAPACK descriptors and the pure-numpy interchange pair (byte-equal to
the reference's on any p x q split), the 1 x 1 ``from_scalapack``/
``to_scalapack`` and ``pd*`` routines, the LAPACK-style shims (against
numpy/scipy and the reference's shims), ``native`` and ``util.debug``
against the reference's, the C program built with g++ against the port's
C host and run in a subprocess on the CPU, and the Fortran module.

Tolerances: 1e-12 relative (1e-10 for solves and decompositions, whose
conditioning enters) in f64.  The reference's drivers are wrapped in
``@annotate``, which calls ``jax.core.trace_state_clean``; the installed
JAX no longer exports that name, so a fixture restores it on the test
side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import scipy.linalg

import jax
import jax.numpy as jnp
import slate_tpu as ref
from slate_tpu import native as ref_native
from slate_tpu.compat import lapack as ref_lp
from slate_tpu.compat import scalapack as ref_sc
from slate_tpu.core import layout as ref_layout
from slate_tpu.util import debug as ref_debug

import slate_tpu_torch as st
from slate_tpu_torch import native
from slate_tpu_torch.compat import fortran
from slate_tpu_torch.compat import lapack as lp
from slate_tpu_torch.compat import scalapack as sc
from slate_tpu_torch.compat import scalapack_api as sapi
from slate_tpu_torch.util import debug

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _ref_drivers(tmp_path, monkeypatch):
    monkeypatch.setenv("SLATE_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


# ------------------------------------------------------------- ScaLAPACK


def test_numroc_reference_values():
    assert sc.numroc(10, 2, 0, 0, 2) == 6
    assert sc.numroc(10, 2, 1, 0, 2) == 4
    assert sc.numroc(9, 2, 0, 0, 2) == 5
    assert sc.numroc(9, 2, 1, 0, 2) == 4
    assert [sc.numroc(7, 3, r, 0, 3) for r in range(3)] == [3, 3, 1]
    for n in (1, 5, 16, 37):
        for nb in (1, 3, 8):
            for p in (1, 2, 3):
                got = [sc.numroc(n, nb, r, 0, p) for r in range(p)]
                assert sum(got) == n
                assert got == [ref_sc.numroc(n, nb, r, 0, p)
                               for r in range(p)]
                assert native.numroc(n, nb, 0, 0, p) == got[0]


@pytest.mark.parametrize("p", [1, 2, 3])
def test_descinit_layout(p):
    d = sc.descinit_pq(36, 28, 8, 4, p)
    assert d == ref_sc.descinit_pq(36, 28, 8, 4, p)
    assert d[0] == 1 and d[2:6] == (36, 28, 8, 4) and d[6:8] == (0, 0)
    assert d[8] == sc.numroc(36, 8, 0, 0, p)
    assert sc.descinit(36, 28, 8, 4) == sc.descinit_pq(36, 28, 8, 4, 1)
    with pytest.raises(st.SlateValueError):
        sc.descinit_pq(36, 28, 8, 4, p, rsrc=1)


@pytest.mark.parametrize("p,q", [(1, 1), (2, 2), (2, 1), (1, 3)])
@pytest.mark.parametrize("m,n,mb,nb", [(36, 28, 8, 4), (17, 13, 5, 3),
                                       (9, 9, 4, 4), (8, 8, 8, 8)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_scatter_gather_equal_bytes_to_the_reference(p, q, m, n, mb, nb,
                                                     dtype):
    a = np.random.default_rng(m * n + p).standard_normal((m, n)).astype(dtype)
    desc, locals_ = sc.scatter_locals(a, mb, nb, p, q)
    rdesc, rlocals = ref_sc.scatter_locals(a, mb, nb, p, q)
    assert desc == rdesc and sorted(locals_) == sorted(rlocals)
    for k, piece in locals_.items():
        assert piece.dtype == dtype and piece.flags["F_CONTIGUOUS"]
        assert piece.shape == (sc.numroc(m, mb, k[0], 0, p),
                               sc.numroc(n, nb, k[1], 0, q))
        assert piece.tobytes(order="A") == rlocals[k].tobytes(order="A")
    back = sc.gather_locals(desc, locals_, p, q)
    assert back.dtype == dtype
    assert back.tobytes() == a.tobytes()
    assert back.tobytes() == ref_sc.gather_locals(rdesc, rlocals, p,
                                                  q).tobytes()
    # shape, not stride, defines a piece; nested lists work too
    as_c = {k: np.ascontiguousarray(v) for k, v in locals_.items()}
    nested = [[locals_[(r, c)] for c in range(q)] for r in range(p)]
    np.testing.assert_array_equal(sc.gather_locals(desc, as_c, p, q), a)
    np.testing.assert_array_equal(sc.gather_locals(desc, nested, p, q), a)


@pytest.mark.parametrize("m,n,mb,nb", [(17, 13, 5, 3), (9, 9, 4, 4),
                                       (11, 7, 4, 2)])
def test_gather_lld_padded_ragged(m, n, mb, nb):
    """LLD-padded locals (what a single-descriptor ScaLAPACK program
    holds) gather like exact ones; a wrong shape is refused."""
    a = np.random.default_rng(m).standard_normal((m, n))
    desc, locals_ = sc.scatter_locals(a, mb, nb, 2, 2)
    lld = desc[8]
    assert any(piece.shape[0] < lld for piece in locals_.values())
    padded = {}
    for k, piece in locals_.items():
        buf = np.full((lld, piece.shape[1]), np.nan, piece.dtype, order="F")
        buf[:piece.shape[0]] = piece
        padded[k] = buf
    np.testing.assert_array_equal(sc.gather_locals(desc, padded, 2, 2), a)
    np.testing.assert_array_equal(ref_sc.gather_locals(desc, padded, 2, 2),
                                  a)
    padded[(0, 0)] = padded[(0, 0)][:, :-1]
    with pytest.raises(st.SlateValueError):
        sc.gather_locals(desc, padded, 2, 2)


@pytest.mark.parametrize("m,n,mb,nb", [(36, 28, 8, 4), (17, 13, 5, 3)])
def test_from_to_scalapack_round_trip_on_one_device(m, n, mb, nb):
    a = np.random.default_rng(n).standard_normal((m, n))
    desc, locals_ = sc.to_scalapack(st.Matrix.from_numpy(a, mb, nb, **CPU))
    rdesc, rlocals = ref_sc.to_scalapack(ref.Matrix.from_numpy(a, mb, nb))
    assert desc == rdesc
    assert locals_[(0, 0)].tobytes(order="A") == \
        rlocals[(0, 0)].tobytes(order="A")
    B = sc.from_scalapack(desc, locals_, **CPU)
    assert (B.mb, B.nb) == (mb, nb)
    np.testing.assert_array_equal(B.to_numpy(), a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.from_scalapack(desc, locals_)


def test_from_scalapack_onto_a_process_grid_raises():
    """The locals of a 2 x 2 process grid onto a 1 x 1 grid without a
    process group do not match it: SlateValueError, as the reference's
    ("local (0,0) shape (8, 8) != numroc (12,12) ..."); onto a 2 x 2 grid
    with a group they land (tests/test_torch_dist_qr.py)."""
    a = np.random.default_rng(0).standard_normal((12, 12))
    desc, locals_ = sc.scatter_locals(a, 4, 4, 2, 2)
    with pytest.raises(st.SlateValueError, match="numroc"):
        sc.from_scalapack(desc, locals_, **CPU)
    with pytest.raises(ref.SlateValueError, match="numroc"):
        ref_sc.from_scalapack(desc, locals_)
    with pytest.raises(st.SlateValueError, match="numroc"):
        sapi.pdgesv(12, 1, desc, locals_, desc, locals_, **CPU)


def _dist(a, nb):
    return sc.scatter_locals(a, nb, nb, 1, 1)


def _undist(out):
    return sc.gather_locals(out[0], out[1], 1, 1)


@pytest.mark.parametrize("ta,tb", [("n", "n"), ("t", "n"), ("n", "t")])
def test_pdgemm_matches_numpy_and_the_reference(ta, tb):
    rng = np.random.default_rng(3)
    m, k, n, nb = 24, 20, 16, 4
    a = rng.standard_normal((m, k) if ta == "n" else (k, m))
    b = rng.standard_normal((k, n) if tb == "n" else (n, k))
    c = rng.standard_normal((m, n))
    args = (ta, tb, m, n, k, 2.0, *_dist(a, nb), *_dist(b, nb), 0.5,
            *_dist(c, nb))
    got = _undist(sapi.pdgemm(*args, **CPU))
    opa = a if ta == "n" else a.T
    opb = b if tb == "n" else b.T
    _close(got, 2.0 * opa @ opb + 0.5 * c, 1e-12)
    from slate_tpu.compat.scalapack_api import pdgemm
    _close(got, _undist(pdgemm(*args, ref.Grid(1, 1))), 1e-12)


def test_pd_solvers_and_decompositions():
    rng = np.random.default_rng(4)
    n, nrhs, nb = 20, 3, 4
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, nrhs))
    x = _undist(sapi.pdgesv(n, nrhs, *_dist(a, nb), *_dist(b, nb), **CPU))
    _close(a @ x, b, 1e-10)
    s = a @ a.T + n * np.eye(n)
    for uplo in ("l", "u"):
        x2 = _undist(sapi.pdposv(uplo, n, nrhs, *_dist(s, nb),
                                 *_dist(b, nb), **CPU))
        _close(s @ x2, b, 1e-10)
        f = _undist(sapi.pdpotrf(uplo, n, *_dist(s, nb), **CPU))
        ff = f @ f.T if uplo == "l" else f.T @ f
        _close(ff, s, 1e-12)
        assert np.array_equal(f, np.tril(f) if uplo == "l" else np.triu(f))
    tall = rng.standard_normal((30, 8))
    bt = rng.standard_normal((30, 2))
    xl = _undist(sapi.pdgels(30, 8, 2, *_dist(tall, nb), *_dist(bt, nb),
                             **CPU))
    _close(xl, np.linalg.lstsq(tall, bt, rcond=None)[0], 1e-10)
    h = (a + a.T) / 2
    w, dz, lz = sapi.pdsyev("v", "l", n, *_dist(h, nb), **CPU)
    z = sc.gather_locals(dz, lz, 1, 1)
    _close(np.sort(w), np.linalg.eigvalsh(h), 1e-12)
    _close(h @ z, z * w[None, :], 1e-10)
    assert sapi.pdsyev("n", "l", n, *_dist(h, nb), **CPU)[1] is None
    sv, du, lu_, dvt, lvt = sapi.pdgesvd("v", n, n, *_dist(a, nb), **CPU)
    u, vt = sc.gather_locals(du, lu_, 1, 1), sc.gather_locals(dvt, lvt, 1, 1)
    _close(sv, np.linalg.svd(a, compute_uv=False), 1e-12)
    _close(u * sv[None, :] @ vt, a, 1e-10)
    assert sapi.pdgesvd("n", n, n, *_dist(a, nb), **CPU)[1] is None


# --------------------------------------------------------- LAPACK shims


def test_lapack_nb_heuristic_is_the_references():
    for n in (1, 8, 24, 100, 1000, 4096, 20480):
        assert lp._nb(n) == ref_lp._nb(n)
    assert lp._nb(4096) == 256
    assert lp._nb(100, {st.Option.BlockSize: 24}) == 24


def test_lapack_solvers_match_numpy_and_the_reference():
    rng = np.random.default_rng(5)
    n = 24
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 3))
    x, perm = lp.gesv(a, b, **CPU)
    _close(x, np.linalg.solve(a, b), 1e-12)
    xr, permr = ref_lp.gesv(a, b)
    assert np.array_equal(perm, np.asarray(permr))
    _close(x, xr, 1e-12)
    lu, perm = lp.getrf(a, **CPU)
    L = np.tril(lu, -1) + np.eye(n)
    _close(L @ np.triu(lu), a[perm], 1e-12)
    s = a @ a.T + n * np.eye(n)
    for uplo in ("L", "U"):
        _close(lp.posv(s, b, uplo, **CPU), np.linalg.solve(s, b), 1e-12)
        f = lp.potrf(s, uplo, **CPU)
        _close(f, ref_lp.potrf(s, uplo), 1e-12)
        _close(f, np.linalg.cholesky(s) if uplo == "L"
               else np.linalg.cholesky(s).T, 1e-12)
    tall = rng.standard_normal((40, 10))
    bt = rng.standard_normal((40, 2))
    _close(lp.gels(tall, bt, **CPU),
           np.linalg.lstsq(tall, bt, rcond=None)[0], 1e-10)
    QR = lp.geqrf(tall, **CPU)
    assert isinstance(QR, st.QRFactors)
    h = (a + a.T) / 2
    w, z = lp.heev(h, **CPU)
    _close(w, np.linalg.eigvalsh(h), 1e-12)
    _close(h @ z, z * w[None, :], 1e-10)
    u, sv, vh = lp.gesvd(a, **CPU)
    _close(sv, np.linalg.svd(a, compute_uv=False), 1e-12)
    _close(u * sv[None, :] @ vh, a, 1e-10)
    _close(lp.gesvd_vals(a, **CPU), sv, 1e-12)
    rc = lp.gecon(a, **CPU)
    assert rc == pytest.approx(float(ref_lp.gecon(a)), rel=1e-10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lp.gesv(a, b)


def test_lapack_blas3_shims_match_numpy():
    rng = np.random.default_rng(6)
    m, n, k = 12, 10, 8
    a, b = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    c = rng.standard_normal((m, n))
    _close(lp.gemm("n", "n", 2.0, a, b, 0.5, c, **CPU), 2 * a @ b + 0.5 * c,
           1e-12)
    _close(lp.gemm("t", "n", 1.0, a.T.copy(), b, **CPU), a @ b, 1e-12)
    ha = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    hh = ha + ha.conj().T
    bc = rng.standard_normal((m, n)) + 0j
    _close(lp.hemm("l", "l", 1.0, np.tril(hh), bc, **CPU), hh @ bc, 1e-12)
    sym = ha + ha.T
    _close(lp.symm("l", "u", 1.0, np.triu(sym), bc, **CPU), sym @ bc, 1e-12)
    ak = rng.standard_normal((m, k)) + 1j * rng.standard_normal((m, k))
    bk = rng.standard_normal((m, k)) + 1j * rng.standard_normal((m, k))
    _close(lp.herk("l", 1.0, ak, **CPU), ak @ ak.conj().T, 1e-12)
    _close(lp.syrk("u", 1.0, ak, **CPU), ak @ ak.T, 1e-12)
    _close(lp.her2k("l", 1.0, ak, bk, **CPU),
           ak @ bk.conj().T + bk @ ak.conj().T, 1e-12)
    _close(lp.syr2k("l", 1.0, ak, bk, **CPU), ak @ bk.T + bk @ ak.T, 1e-12)
    t = np.tril(rng.standard_normal((m, m))) + m * np.eye(m)
    bb = rng.standard_normal((m, n))
    _close(lp.trmm("l", "l", "n", "n", 1.0, t, bb, **CPU), t @ bb, 1e-12)
    _close(lp.trsm("l", "l", "t", "n", 1.0, t, bb, **CPU),
           np.linalg.solve(t.T, bb), 1e-12)
    _close(lp.trsm("l", "l", "n", "u", 1.0, t, bb, **CPU),
           scipy.linalg.solve_triangular(t, bb, lower=True,
                                         unit_diagonal=True), 1e-12)
    for shim, args in (("herk", ("l", 1.0, ak)), ("trmm", ("l", "l", "n",
                                                          "n", 1.0, t, bb)),
                       ("gemm", ("n", "n", 2.0, a, b, 0.5, c))):
        _close(getattr(lp, shim)(*args, **CPU),
               getattr(ref_lp, shim)(*args), 1e-12)


def test_lapack_norms_and_factor_shims():
    rng = np.random.default_rng(7)
    n = 12
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    assert lp.lange("1", a, **CPU) == pytest.approx(
        np.abs(a).sum(axis=0).max(), rel=1e-12)
    assert lp.lange("f", a, **CPU) == pytest.approx(np.linalg.norm(a),
                                                    rel=1e-12)
    assert lp.lange("m", a, **CPU) == np.abs(a).max()
    h = (a + a.T) / 2
    assert lp.lanhe("i", "l", h, **CPU) == pytest.approx(
        np.abs(h).sum(axis=1).max(), rel=1e-12)
    assert lp.lansy("1", "u", h, **CPU) == pytest.approx(
        np.abs(h).sum(axis=0).max(), rel=1e-12)
    t = np.tril(a)
    assert lp.lantr("m", "l", "n", t, **CPU) == np.abs(t).max()
    lu, perm = lp.getrf(a, **CPU)
    b = rng.standard_normal((n, 3))
    _close(lp.getrs(lu, perm, b, **CPU), np.linalg.solve(a, b), 1e-12)
    _close(lp.getrs(lu, perm, b, trans="t", **CPU),
           np.linalg.solve(a.T, b), 1e-12)
    _close(lp.getrs(lu, perm, b, trans="c", **CPU),
           np.linalg.solve(a.T, b), 1e-12)
    _close(lp.getri(lu, perm, **CPU), np.linalg.inv(a), 1e-12)
    s = a @ a.T + n * np.eye(n)
    _close(lp.potri(lp.potrf(s, **CPU), **CPU), np.linalg.inv(s), 1e-12)
    x, its = lp.gesv_mixed(s, b, **CPU)
    _close(s @ x, b, 1e-10)
    assert its >= 1


# --------------------------------------------------------- native, debug


@pytest.mark.parametrize("m,n,mb,nb,p,q", [(10, 7, 4, 4, 1, 1),
                                           (17, 13, 5, 3, 2, 2),
                                           (37, 5, 3, 2, 3, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_pack_equals_the_reference(m, n, mb, nb, p, q, dtype):
    """The port's numpy packer gives the reference's bytes: its tile
    layout ops always, its native library where it is built."""
    a = np.random.default_rng(m).standard_normal((m, n)).astype(dtype)
    packed = native.pack_tiles(a, mb, nb, p, q)
    want = np.asarray(ref_layout.canonical_to_cyclic(
        ref_layout.tile_dense(jnp.asarray(a), mb, nb), p, q))
    assert packed.shape == want.shape and packed.tobytes() == want.tobytes()
    if ref_native.available():
        assert packed.tobytes() == ref_native.pack_tiles(
            a, mb, nb, p, q).tobytes()
        assert native.unpack_tiles(packed, m, n, p, q).tobytes() == \
            ref_native.unpack_tiles(packed, m, n, p, q).tobytes()
    assert native.unpack_tiles(packed, m, n, p, q).tobytes() == a.tobytes()
    assert not native.available() and native.version() is None
    assert native.supports(dtype) and native.pack_tiles(a[0], 2, 2, 1,
                                                        1) is None


def test_debug_tiles_map_matches_the_reference():
    a = np.random.default_rng(42).standard_normal((10, 7))
    A = st.Matrix.from_numpy(a, 4, 4, **CPU)
    s = debug.tiles_map(A)
    assert s == ref_debug.tiles_map(ref.Matrix.from_numpy(a, 4, 4))
    assert "tiles_map 10x7" in s and "r0:" in s
    assert debug.tiles_map(A, max_tiles=2).endswith("...")
    assert debug.check_pad_invariant(A)
    bad = st.Matrix(type(A.storage)(A.storage.data + 1.0, 10, 7, 4, 4,
                                    A.grid))
    assert not debug.check_pad_invariant(bad)
    rep = debug.memory_report(A)
    assert "MB total" in rep and "cpu" in rep and "HBM" not in rep


# ------------------------------------------------------- C API, Fortran


C_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include <math.h>
#include "slate_tpu_torch_capi.h"

static double resid(const double* a, const double* x, const double* b,
                    int64_t m, int64_t n, int64_t nrhs) {
  double err = 0.0;
  for (int64_t i = 0; i < m; i++)
    for (int64_t j = 0; j < nrhs; j++) {
      double r = -b[i * nrhs + j];
      for (int64_t k = 0; k < n; k++) r += a[i * n + k] * x[k * nrhs + j];
      if (fabs(r) > err) err = fabs(r);
    }
  return err;
}

int main(void) {
  const int64_t n = 24, nrhs = 3, nb = 8;
  double *a = (double*)malloc(n * n * sizeof(double));
  double *b = (double*)malloc(n * nrhs * sizeof(double));
  double *x = (double*)malloc(n * nrhs * sizeof(double));
  double *spd = (double*)malloc(n * n * sizeof(double));
  double *w = (double*)malloc(n * sizeof(double));
  unsigned s = 12345;
  for (int64_t i = 0; i < n * n; i++) {
    s = s * 1103515245u + 12345u;
    a[i] = ((double)(s >> 8) / (1u << 24)) - 0.5;
  }
  for (int64_t i = 0; i < n; i++) a[i * n + i] += (double)n;
  for (int64_t i = 0; i < n * nrhs; i++) {
    s = s * 1103515245u + 12345u;
    b[i] = ((double)(s >> 8) / (1u << 24)) - 0.5;
  }
  if (slate_tpu_torch_init() != 0) { printf("FAIL init\n"); return 1; }
  if (slate_tpu_torch_dgesv(n, nrhs, a, n, b, nrhs, x, nrhs, nb) != 0) {
    printf("FAIL dgesv rc\n"); return 1;
  }
  double err = resid(a, x, b, n, n, nrhs);
  if (err > 1e-10) { printf("FAIL gesv resid %g\n", err); return 1; }
  for (int64_t i = 0; i < n; i++)
    for (int64_t j = 0; j < n; j++) {
      double v = (i == j) ? (double)n : 0.0;
      for (int64_t k = 0; k < n; k++) v += a[i * n + k] * a[j * n + k];
      spd[i * n + j] = v;
    }
  if (slate_tpu_torch_dposv(n, nrhs, spd, n, b, nrhs, x, nrhs, nb) != 0) {
    printf("FAIL dposv rc\n"); return 1;
  }
  err = resid(spd, x, b, n, n, nrhs);
  if (err > 1e-9) { printf("FAIL posv resid %g\n", err); return 1; }
  if (slate_tpu_torch_dgels(n, n, nrhs, a, n, b, nrhs, x, nrhs, nb) != 0) {
    printf("FAIL dgels rc\n"); return 1;
  }
  err = resid(a, x, b, n, n, nrhs);
  if (err > 1e-10) { printf("FAIL gels resid %g\n", err); return 1; }
  if (slate_tpu_torch_dsyev(n, spd, n, w, nb) != 0) {
    printf("FAIL dsyev rc\n"); return 1;
  }
  for (int64_t i = 1; i < n; i++)
    if (w[i] < w[i - 1]) { printf("FAIL dsyev order\n"); return 1; }
  if (slate_tpu_torch_dgesvd(n, n, a, n, w, nb) != 0) {
    printf("FAIL dgesvd rc\n"); return 1;
  }
  for (int64_t i = 1; i < n; i++)
    if (w[i] > w[i - 1]) { printf("FAIL dgesvd order\n"); return 1; }
  /* a bad pointer contract is reported as rc 1, not a crash */
  if (slate_tpu_torch_dgesv(n, nrhs, a, n, b, nrhs, x, nrhs, 0) == 0) {
    printf("FAIL nb=0 accepted\n"); return 1;
  }
  printf("CAPI_OK\n");
  slate_tpu_torch_finalize();
  return 0;
}
"""


def _embed_flags():
    cfg = shutil.which("python3-config")
    if shutil.which("g++") is None or cfg is None:
        pytest.skip("no g++ or python3-config: the C host cannot be built")
    inc = subprocess.run([cfg, "--includes"], capture_output=True,
                         text=True).stdout.split()
    r = subprocess.run([cfg, "--ldflags", "--embed"], capture_output=True,
                       text=True)
    if r.returncode != 0:
        r = subprocess.run([cfg, "--ldflags"], capture_output=True,
                           text=True)
    return inc, r.stdout.split()


def test_c_program_solves_through_the_ports_capi(tmp_path):
    inc, ld = _embed_flags()
    src = ROOT / "slate_tpu_torch" / "native"
    lib = tmp_path / "libslate_tpu_torch_capi.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", *inc,
                        str(src / "slate_tpu_torch_capi.cc"), "-o", str(lib),
                        *ld], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    (tmp_path / "main.c").write_text(C_MAIN)
    exe = tmp_path / "capi_test"
    r = subprocess.run(["g++", str(tmp_path / "main.c"), "-o", str(exe),
                        f"-I{src}", str(lib), f"-Wl,-rpath,{tmp_path}", *ld],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ, SLATE_TORCH_CAPI_DEVICE="cpu",
               PYTHONPATH=f"{ROOT}:{os.environ.get('PYTHONPATH', '')}")
    r = subprocess.run([str(exe)], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, f"stdout={r.stdout} stderr={r.stderr[-2000:]}"
    assert "CAPI_OK" in r.stdout


def test_capi_pointer_contract_in_process():
    """The entry points the C host calls, with ctypes pointers into numpy
    buffers (row-major, a row stride wider than the payload)."""
    from slate_tpu_torch.compat import capi
    rng = np.random.default_rng(8)
    n, nrhs, ld = 16, 2, 20
    a = np.zeros((n, ld))
    a[:, :n] = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, nrhs))
    x = np.full((n, ld), 7.0)
    os.environ["SLATE_TORCH_CAPI_DEVICE"] = "cpu"
    try:
        assert capi.dgesv(n, nrhs, a.ctypes.data, ld, b.ctypes.data, nrhs,
                          x.ctypes.data, ld, 8) == 0
        _close(x[:, :nrhs], np.linalg.solve(a[:, :n], b), 1e-12)
        assert (x[:, nrhs:] == 7.0).all()
        s = a[:, :n] @ a[:, :n].T
        sp = np.ascontiguousarray(s)
        assert capi.dposv(n, nrhs, sp.ctypes.data, n, b.ctypes.data, nrhs,
                          x.ctypes.data, ld, 8) == 0
        _close(x[:, :nrhs], np.linalg.solve(s, b), 1e-10)
        w = np.zeros(n)
        assert capi.dsyev(n, sp.ctypes.data, n, w.ctypes.data, 8) == 0
        _close(w, np.linalg.eigvalsh(s), 1e-12)
    finally:
        del os.environ["SLATE_TORCH_CAPI_DEVICE"]
    # without the knob the device is CUDA, which this machine lacks
    assert capi.dgesv(n, nrhs, a.ctypes.data, ld, b.ctypes.data, nrhs,
                      x.ctypes.data, ld, 8) == 1


def test_fortran_module_is_the_generators_output():
    committed = (ROOT / "slate_tpu_torch" / "native" /
                 "slate_tpu_torch.f90").read_text()
    assert committed == fortran.emit()
    header = (ROOT / "slate_tpu_torch" / "native" /
              "slate_tpu_torch_capi.h").read_text()
    for name, args, _ in fortran.ROUTINES:
        assert f"int {name}(" in header
        sig = header.split(f"int {name}(")[1].split(");")[0]
        assert [a.split()[-1].lstrip("*") for a in sig.split(",")] == \
            [a[0] for a in args]


def test_fortran_module_compiles(tmp_path):
    fc = shutil.which("gfortran") or shutil.which("flang")
    if fc is None:
        pytest.skip("no Fortran compiler (gfortran or flang) on this "
                    "machine: the module's text is held by the generator "
                    "test instead")
    r = subprocess.run([fc, "-c", str(ROOT / "slate_tpu_torch" / "native" /
                                      "slate_tpu_torch.f90"),
                        "-o", str(tmp_path / "m.o"), "-J", str(tmp_path)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
