"""The port's simplified API against slate_tpu's, on the CPU: every verb
of ``api.__all__``, on each matrix structure it dispatches on.

Each case calls one verb in both packages on the same numpy inputs, with
every driver module the API dispatches to wrapped so that the calls it
makes are recorded: the port must reach the same driver (module and
function) as the reference, and its result must agree, within 1e-12
relative in f64.  The batch verbs are bit-equal to the port's own
``make_batched`` on the same stack and agree with the reference's within
1e-4 (f32), with the same escalation flags.  The spectral verbs reach
heev and svd as the reference's do (values within 1e-9 relative; their
mesh target raises, citing queue 1, item 12).  The reference's drivers
are wrapped in ``@annotate``, which calls ``jax.core.trace_state_clean``;
the installed JAX no longer exports that name, so the ``ref_drivers``
fixture restores it on the test side only.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref
from slate_tpu import api as ref_api
from slate_tpu.serve import batched as ref_batched

import slate_tpu_torch as st
from slate_tpu_torch import api
from slate_tpu_torch.serve import batched

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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_verb_reaches_the_same_driver(monkeypatch, case):
    _, verb, makers = case
    got, want, calls_p, calls_r = _call_both(monkeypatch, verb, makers)
    assert calls_p and calls_p[0] == calls_r[0]
    _agree(got, want)


@pytest.mark.parametrize("case", FACTOR_CASES,
                         ids=[c[0] for c in FACTOR_CASES])
def test_factor_verb_reaches_the_same_driver(monkeypatch, case):
    _, prefix, verb, makers = case
    got, want, calls_p, calls_r = _call_both(monkeypatch, verb, makers,
                                             prefix)
    assert calls_p and calls_p[0] == calls_r[0]
    _agree(got, want, signs=verb in UP_TO_SIGNS)


@pytest.mark.parametrize("verb", ["qr_factor", "lq_factor"])
def test_qr_factor_verbs_reach_the_same_driver(monkeypatch, verb):
    """qr_factor/lq_factor: the same driver; R (up to signs, see above)
    agrees."""
    a = A_TALL if verb == "qr_factor" else A_TALL.T.copy()
    got, want, calls_p, calls_r = _call_both(monkeypatch, verb, [_g(a)])
    assert calls_p and calls_p[0] == calls_r[0]
    fr = want.F if verb == "lq_factor" else want
    fp = got.F if verb == "lq_factor" else got
    k = min(a.shape)
    rr = np.triu(np.asarray(fr.QR.to_numpy())[:k, :k])
    rp = np.triu(fp.QR.to_numpy()[:k, :k])
    _agree_arrays(np.abs(rp), np.abs(rr))


@pytest.mark.parametrize("case", AUX_CASES, ids=[c[0] for c in AUX_CASES])
def test_aux_verbs_are_the_aux_drivers(case):
    _, verb, makers = case
    from slate_tpu.drivers import auxiliary as ref_aux
    from slate_tpu_torch.drivers import auxiliary as port_aux
    assert getattr(api, verb) is getattr(port_aux, verb)
    assert getattr(ref_api, verb) is getattr(ref_aux, verb)
    _agree(getattr(api, verb)(*_args(makers, st)),
           getattr(ref_api, verb)(*_args(makers, ref)))


def test_api_all_is_the_reference_all():
    assert api.__all__ == ref_api.__all__
    assert all(callable(getattr(api, name)) for name in api.__all__)


@pytest.mark.parametrize("verb", ["eig", "eig_vals", "svd", "svd_vals"])
def test_spectral_verbs_take_the_single_route_without_a_group(verb):
    """Target.mesh on a grid without a process group takes the single
    route, as the reference's verbs do where the grid has no mesh, so it
    gives the single route's bits (held against the reference below; the
    mesh routes on grids with a group in
    tests/test_torch_dist_spectral.py)."""
    A = (st.HermitianMatrix.from_numpy(A_SPD, NB, device="cpu")
         if verb.startswith("eig") else
         st.Matrix.from_numpy(A_GEN, NB, device="cpu"))
    got = getattr(api, verb)(A, {st.Option.Target: st.Target.mesh})
    want = getattr(api, verb)(A)
    got, want = (got if isinstance(got, tuple) else (got,),
                 want if isinstance(want, tuple) else (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = (x.to_dense() if hasattr(x, "to_dense") else x
                for x in (g, w))
        assert torch.equal(g, w)


SPECTRAL_CASES = [("eig", "hermitian", "_heev", "heev"),
                  ("eig", "symmetric", "_heev", "heev"),
                  ("eig_vals", "hermitian", "_heev", "heev_vals"),
                  ("svd", "general", "_svd", "svd"),
                  ("svd_vals", "general", "_svd", "svd_vals")]


@pytest.mark.parametrize("case", SPECTRAL_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in SPECTRAL_CASES])
def test_spectral_verbs_reach_the_reference_driver(monkeypatch, case):
    verb, kind, mod, driver = case
    calls_p, calls_r = [], []
    for api_mod, calls in ((api, calls_p), (ref_api, calls_r)):
        m = getattr(api_mod, mod)
        fn = getattr(m, driver)

        def wrapped(*a, __fn=fn, __calls=calls, **k):
            __calls.append(driver)
            return __fn(*a, **k)
        monkeypatch.setattr(m, driver, wrapped)
    got = getattr(api, verb)(_m(kind)(st))
    want = getattr(ref_api, verb)(_m(kind)(ref))
    assert calls_p == calls_r == [driver]
    vals = got if verb.endswith("_vals") else got[0]
    wvals = want if verb.endswith("_vals") else want[0]
    assert np.abs(np.sort(vals.numpy()) - np.sort(np.asarray(wvals))).max() \
        <= RTOL * np.abs(np.asarray(wvals)).max() * 1e3


def test_operand_errors_match():
    with pytest.raises(st.SlateValueError):
        api.triangular_multiply(1.0, st.Matrix.from_numpy(
            A_GEN, NB, device="cpu"), st.Matrix.from_numpy(B, NB,
                                                           device="cpu"))
    with pytest.raises(st.SlateValueError):
        api.rank_k_update(1.0, st.Matrix.from_numpy(B, NB, device="cpu"),
                          1.0, st.Matrix.from_numpy(A_GEN, NB,
                                                    device="cpu"))


# ------------------------------------------------------------- batch verbs

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


@pytest.mark.parametrize("verb,op", [
    ("batch_solve", "solve"), ("batch_chol_solve", "chol_solve"),
    ("batch_least_squares_solve", "least_squares_solve")])
def test_batch_verbs(verb, op):
    """Bit-equal to make_batched on the same stack (every size full), and
    the reference's batch verb's results within 1e-4 (f32) with the same
    escalation flags."""
    a, b = _stack(11, 3, 32, 2, op)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    x, hs, esc = getattr(api, verb)(ta, tb)
    sizes = torch.full((3,), a.shape[1], dtype=torch.int32)
    x2, hs2, esc2 = batched.make_batched(op)(ta, tb, sizes)
    assert torch.equal(x, x2) and hs == hs2 and esc == esc2
    xr, hr, escr = getattr(ref_api, verb)(a, b)
    assert list(np.asarray(escr)) == esc
    xr = np.asarray(xr)
    assert np.abs(x.numpy() - xr).max() <= 1e-4 * np.abs(xr).max()
    assert all(h.ok for h in hs)


def test_batch_full_sizes():
    a = torch.zeros((4, 6, 3))
    s = api._full_sizes(a, 6)
    r = ref_api._full_sizes(np.zeros((4, 6, 3)), 6)
    assert s.dtype == torch.int32 and s.tolist() == np.asarray(r).tolist()
    assert ref_batched.make_batched and batched.make_batched
