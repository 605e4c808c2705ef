"""Shared inputs and checks of the port's simplified-API tests
(tests/test_torch_api*.py): the matrices, the verb cases, the spy on the
driver modules and the comparisons. ``ref_drivers`` restores
``jax.core.trace_state_clean``, which the reference's ``@annotate``d
drivers call and the installed JAX no longer exports, on the test side
only. Each test file imports it, as an autouse fixture.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref
from slate_tpu import api as ref_api

import slate_tpu_torch as st
from slate_tpu_torch import api


RTOL = 1e-12


MODULES = ("_band", "_blas3", "_chol", "_hetrf", "_lu", "_qr")


NB = 8


@pytest.fixture(autouse=True)
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _spy(monkeypatch, api_mod, calls):
    """Record every call the API makes into its driver modules."""
    for name in MODULES:
        mod = getattr(api_mod, name)
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != mod.__name__ or fname.startswith("_"):
                continue

            def wrapped(*a, __fn=fn, __key=(name, fname), **k):
                calls.append(__key)
                return __fn(*a, **k)
            monkeypatch.setattr(mod, fname, wrapped)


def _rand(seed, m, n):
    return np.random.default_rng(seed).standard_normal((m, n))


def _spd(seed, n):
    g = _rand(seed, n, n)
    return g @ g.T + n * np.eye(n)


def _indef(seed, n):
    a = _rand(seed, n, n)
    a = (a + a.T) / 2
    return a - np.mean(np.linalg.eigvalsh(a)) * np.eye(n)


def _band(a, kl, ku):
    return np.tril(np.triu(a, -kl), ku)


def _make(pkg, kind, a):
    """One matrix of ``kind`` in ``pkg`` over the numpy array ``a``."""
    dev = {} if pkg is ref else {"device": "cpu"}
    if kind == "general":
        return pkg.Matrix.from_numpy(a, NB, **dev)
    if kind in ("hermitian", "symmetric"):
        cls = pkg.HermitianMatrix if kind == "hermitian" \
            else pkg.SymmetricMatrix
        return cls.from_numpy(a, NB, pkg.Uplo.Lower, **dev)
    if kind == "triangular":
        return pkg.TriangularMatrix.from_numpy(a, NB, pkg.Uplo.Lower,
                                               **dev)
    if kind == "band":
        return pkg.BandMatrix.from_numpy(a, 3, 2, NB, **dev)
    if kind == "hband":
        return pkg.HermitianBandMatrix.from_numpy(a, 3, NB, **dev)
    if kind == "tband":
        return pkg.TriangularBandMatrix.from_numpy(a, 3, NB, pkg.Uplo.Lower,
                                                   **dev)
    raise ValueError(kind)


N = 40


A_GEN = _rand(1, N, N) + N * np.eye(N)


A_SPD = _spd(2, N)


A_TRI = np.tril(_rand(3, N, N)) + N * np.eye(N)


A_BAND = _band(_rand(4, N, N), 3, 2) + 10 * np.eye(N)


A_HB = _band(A_SPD, 3, 3) + 10 * np.eye(N)


A_TB = _band(A_TRI, 3, 0)


B = _rand(5, N, 3)


BT = _rand(6, 3, N)


C_SQ = _rand(7, N, N)


A_TALL = _rand(8, 2 * N, N)


B_TALL = _rand(9, 2 * N, 3)


MATS = {"general": A_GEN, "hermitian": A_SPD, "symmetric": A_SPD,
        "triangular": A_TRI, "band": A_BAND, "hband": A_HB,
        "tband": A_TB}


def _m(kind):
    return lambda pkg: _make(pkg, kind, MATS[kind])


def _g(a):
    return lambda pkg: _make(pkg, "general", a)


# (case id, verb, argument makers): each maker maps a package to one
# argument; plain values pass through
CASES = [
    ("multiply-general", "multiply", [1.5, _m("general"), _g(B), 0.0, None]),
    ("multiply-hermitian-left", "multiply", [1.5, _m("hermitian"), _g(B)]),
    ("multiply-hermitian-right", "multiply", [1.5, _g(BT), _m("hermitian")]),
    ("multiply-symmetric-left", "multiply", [1.5, _m("symmetric"), _g(B)]),
    ("multiply-symmetric-right", "multiply", [1.5, _g(BT), _m("symmetric")]),
    ("multiply-band", "multiply", [1.5, _m("band"), _g(B), 0.5, _g(B)]),
    ("multiply-hband-left", "multiply", [1.5, _m("hband"), _g(B)]),
    ("multiply-hband-right", "multiply", [1.5, _g(BT), _m("hband")]),
    ("triangular_multiply-left", "triangular_multiply",
     [2.0, _m("triangular"), _g(B)]),
    ("triangular_multiply-right", "triangular_multiply",
     [2.0, _g(BT), _m("triangular")]),
    ("triangular_solve-left", "triangular_solve",
     [2.0, _m("triangular"), _g(B)]),
    ("triangular_solve-right", "triangular_solve",
     [2.0, _g(BT), _m("triangular")]),
    ("triangular_solve-tband-left", "triangular_solve",
     [2.0, _m("tband"), _g(B)]),
    ("triangular_solve-tband-right", "triangular_solve",
     [2.0, _g(BT), _m("tband")]),
    ("rank_k_update-hermitian", "rank_k_update",
     [0.5, _g(B), 2.0, _m("hermitian")]),
    ("rank_k_update-symmetric", "rank_k_update",
     [0.5, _g(B), 2.0, _m("symmetric")]),
    ("rank_2k_update-hermitian", "rank_2k_update",
     [0.5, _g(B), _g(B[::-1].copy()), 2.0, _m("hermitian")]),
    ("rank_2k_update-symmetric", "rank_2k_update",
     [0.5, _g(B), _g(B[::-1].copy()), 2.0, _m("symmetric")]),
    ("lu_solve-general", "lu_solve", [_m("general"), _g(B)]),
    ("lu_solve-band", "lu_solve", [_m("band"), _g(B)]),
    ("band_lu_solve", "band_lu_solve", [_m("band"), _g(B)]),
    ("lu_solve_nopiv", "lu_solve_nopiv", [_m("general"), _g(B)]),
    ("lu_factor-general", "lu_factor", [_m("general")]),
    ("lu_factor-band", "lu_factor", [_m("band")]),
    ("lu_factor_nopiv", "lu_factor_nopiv", [_m("general")]),
    ("lu_inverse_using_factor_out_of_place",
     "lu_inverse_using_factor_out_of_place", [_m("general")]),
    ("chol_solve-hermitian", "chol_solve", [_m("hermitian"), _g(B)]),
    ("chol_solve-hband", "chol_solve", [_m("hband"), _g(B)]),
    ("band_chol_solve", "band_chol_solve", [_m("hband"), _g(B)]),
    ("chol_factor-hermitian", "chol_factor", [_m("hermitian")]),
    ("chol_factor-hband", "chol_factor", [_m("hband")]),
    ("indefinite_solve", "indefinite_solve",
     [lambda p: _make(p, "hermitian", _indef(10, N)), _g(B)]),
    ("indefinite_factor", "indefinite_factor",
     [lambda p: _make(p, "hermitian", _indef(10, N))]),
    ("least_squares_solve", "least_squares_solve",
     [_g(A_TALL), _g(B_TALL)]),
]


# the auxiliary verbs are the auxiliary drivers themselves
AUX_CASES = [
    ("norm-band", "norm", [lambda p: p.Norm.One, _m("band")]),
    ("norm-hermitian", "norm", [lambda p: p.Norm.Fro, _m("hermitian")]),
    ("add", "add", [2.0, _m("general"), -1.0, _g(C_SQ)]),
    ("copy", "copy", [_m("general"), _g(C_SQ)]),
    ("scale", "scale", [3.0, 4.0, _m("triangular")]),
]


# verbs that take a factor: (case id, factor verb and args, verb, the
# verb's arguments with FACTOR where the factor goes)
FACTOR = object()


FACTOR_CASES = [
    ("lu_solve_using_factor-lu", ("lu_factor", [_m("general")]),
     "lu_solve_using_factor", [FACTOR, _g(B)]),
    ("lu_solve_using_factor-band", ("lu_factor", [_m("band")]),
     "lu_solve_using_factor", [FACTOR, _g(B)]),
    ("lu_solve_using_factor_nopiv", ("lu_factor_nopiv", [_m("general")]),
     "lu_solve_using_factor_nopiv", [FACTOR, _g(B)]),
    ("lu_inverse_using_factor", ("lu_factor", [_m("general")]),
     "lu_inverse_using_factor", [FACTOR]),
    ("chol_solve_using_factor-chol", ("chol_factor", [_m("hermitian")]),
     "chol_solve_using_factor", [FACTOR, _g(B)]),
    ("chol_solve_using_factor-band", ("chol_factor", [_m("hband")]),
     "chol_solve_using_factor", [FACTOR, _g(B)]),
    ("chol_inverse_using_factor", ("chol_factor", [_m("hermitian")]),
     "chol_inverse_using_factor", [FACTOR]),
    ("indefinite_solve_using_factor",
     ("indefinite_factor", [lambda p: _make(p, "hermitian",
                                            _indef(10, N))]),
     "indefinite_solve_using_factor", [FACTOR, _g(B)]),
    ("qr_multiply_by_q", ("qr_factor", [_g(A_TALL)]), "qr_multiply_by_q",
     [lambda p: p.Side.Left, lambda p: p.Op.ConjTrans, FACTOR,
      _g(B_TALL)]),
    ("lq_multiply_by_q", ("lq_factor", [_g(A_TALL.T.copy())]),
     "lq_multiply_by_q",
     [lambda p: p.Side.Right, lambda p: p.Op.NoTrans, FACTOR,
      _g(_rand(12, 3, 2 * N))]),
]


# QR verbs: the reference's default QR plan (XLA's CholQR2 reconstruction)
# may flip the sign of a row of R against the port's Householder panel,
# so their results are compared up to signs (|.| elementwise)
UP_TO_SIGNS = {"qr_multiply_by_q", "lq_multiply_by_q"}


def _args(makers, pkg, factor=None):
    return [factor if b is FACTOR else b(pkg) if callable(b) else b
            for b in makers]


def _dense(x):
    """A comparable numpy array of a verb's result."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        leaves = [getattr(x, f) for f in x._fields]
        return [_dense(v) for v in leaves if not isinstance(v, int)]
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _agree(got, want, signs=False):
    g, w = _dense(got), _dense(want)
    if signs:
        g, w = np.abs(g), np.abs(w)
    if isinstance(w, list):
        assert len(g) == len(w)
        for gi, wi in zip(g, w):
            _agree_arrays(gi, wi)
    else:
        _agree_arrays(g, w)


def _agree_arrays(g, w):
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape
    if np.issubdtype(w.dtype, np.integer):
        assert np.array_equal(g, w)
    else:
        assert np.abs(g - w).max() <= RTOL * max(np.abs(w).max(), 1.0)


def _call_both(monkeypatch, verb, makers, prefix=None):
    calls_r, calls_p = [], []
    _spy(monkeypatch, ref_api, calls_r)
    _spy(monkeypatch, api, calls_p)
    f_r = f_p = None
    if prefix is not None:
        fverb, fargs = prefix
        f_r = getattr(ref_api, fverb)(*_args(fargs, ref))
        f_p = getattr(api, fverb)(*_args(fargs, st))
        del calls_r[:], calls_p[:]
    want = getattr(ref_api, verb)(*_args(makers, ref, f_r))
    got = getattr(api, verb)(*_args(makers, st, f_p))
    return got, want, calls_p, calls_r


SPECTRAL_CASES = [("eig", "hermitian", "_heev", "heev"),
                  ("eig", "symmetric", "_heev", "heev"),
                  ("eig_vals", "hermitian", "_heev", "heev_vals"),
                  ("svd", "general", "_svd", "svd"),
                  ("svd_vals", "general", "_svd", "svd_vals")]


def _stack(seed, b, n, k, op):
    rng = np.random.default_rng(seed)
    m = 2 * n if op == "least_squares_solve" else n
    a = rng.standard_normal((b, m, n)).astype(np.float32)
    if op == "solve":
        a = a + n * np.eye(n, dtype=np.float32)
    elif op == "chol_solve":
        a = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    x = rng.standard_normal((b, m, k)).astype(np.float32)
    return a, x
