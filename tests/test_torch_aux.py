"""The port's auxiliary layer against slate_tpu's, on the CPU: the
test-matrix generator, the matrix views, the elementwise tile kernels, the
auxiliary drivers, the inverses (trtri, trtrm, potri), the condition
estimators and printing.

The same numpy inputs, from a seed, go through both packages.
Tolerances: the generator bit-equal for every kind in f32, f64, c64 and
c128; copy, set, transpose and redistribute bit-equal (and the other
elementwise kernels, which do the same IEEE operations); f64 inverses
within 1e-12 relative, f32 and c64 within 1e-5; condition estimates
within 1e-10 with the same iteration count; ``format_matrix`` strings
equal.  The reference's drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import io
import contextlib

import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref
from slate_tpu.drivers import condest as ref_condest
from slate_tpu.ops import elementwise as ref_ew

import slate_tpu_torch as st
from slate_tpu_torch.drivers import condest as port_condest
from slate_tpu_torch.ops import elementwise as ew
from slate_tpu_torch.util import generator as gen

RTOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-12,
        np.complex128: 1e-12}
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _rand(seed, m, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dtype)


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= RTOL[dtype] * np.abs(want).max()


def _bits(got, want):
    got = np.ascontiguousarray(np.asarray(got))
    want = np.ascontiguousarray(np.asarray(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# ------------------------------------------------------------- generator

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", gen.KINDS)
def test_generate_matrix_bit_equal(kind, dtype):
    """Every kind in every dtype: the same seed gives the same bits."""
    want = ref.generate_matrix(kind, 37, 29, 8, seed=11, dtype=dtype,
                               cond=1e4)
    got = st.generate_matrix(kind, 37, 29, 8, seed=11, dtype=dtype,
                             cond=1e4, device="cpu")
    _bits(got.to_numpy(), want.to_numpy())
    assert (got.m, got.n, got.mb) == (want.m, want.n, want.mb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["poev", "heev", "randn"])
def test_generate_hermitian_bit_equal(kind, dtype):
    want = ref.generate_hermitian(kind, 33, 8, seed=5, dtype=dtype)
    got = st.generate_hermitian(kind, 33, 8, seed=5, dtype=dtype,
                                device="cpu")
    assert type(got).__name__ == type(want).__name__ == "HermitianMatrix"
    _bits(got.to_numpy(), want.to_numpy())


def test_generator_takes_torch_dtypes():
    got = st.generate_matrix("randn", 9, 7, 4, seed=3, dtype=torch.float32,
                             device="cpu")
    want = ref.generate_matrix("randn", 9, 7, 4, seed=3, dtype=np.float32)
    _bits(got.to_numpy(), want.to_numpy())


# ------------------------------------------------------------- matrix views

def test_matrix_views_match_the_reference():
    """sub, T/H, tile_mb/tile_nb/tile_rank, emptyLike and the structure
    conversions: the same shapes and the same dense views."""
    a = _rand(1, 50, 37, np.complex128)
    R = ref.Matrix.from_numpy(a, 16, 8)
    P = st.Matrix.from_numpy(a, 16, 8, device="cpu")
    for r, p in ((R, P), (R.T, P.T), (R.H, P.H)):
        assert (r.m, r.n, r.mt, r.nt) == (p.m, p.n, p.mt, p.nt)
        assert [r.tile_mb(i) for i in range(r.mt)] == \
            [p.tile_mb(i) for i in range(p.mt)]
        assert [r.tile_nb(j) for j in range(r.nt)] == \
            [p.tile_nb(j) for j in range(p.nt)]
        assert r.tile_rank(1, 2) == p.tile_rank(1, 2) == 0
        _bits(p.to_numpy(), r.to_numpy())
        rs, ps = r.sub(1, 2, 0, 1), p.sub(1, 2, 0, 1)
        assert type(ps) is st.Matrix and (rs.m, rs.n) == (ps.m, ps.n)
        _bits(ps.to_numpy(), rs.to_numpy())
    e = P.T.emptyLike(torch.float32)
    assert e.dtype == torch.float32 and (e.m, e.n) == (P.n, P.m)
    assert not e.to_numpy().any()
    sq = _rand(2, 24, 24, np.float64)
    Rs, Ps = ref.Matrix.from_numpy(sq, 8), st.Matrix.from_numpy(
        sq, 8, device="cpu")
    for name, args in (("triangular", ("Upper", "Unit")),
                       ("symmetric", ("Lower",)), ("hermitian", ("Upper",)),
                       ("trapezoid", ("Lower",))):
        rv = getattr(Rs, name)(*[_enum(ref, x) for x in args])
        pv = getattr(Ps, name)(*[_enum(st, x) for x in args])
        assert type(rv).__name__ == type(pv).__name__
        _bits(pv.to_numpy(), rv.to_numpy())
    with pytest.raises(st.SlateValueError):
        st.Matrix.from_numpy(a, 8, device="cpu").triangular(st.Uplo.Lower)


def _enum(pkg, name):
    return getattr(pkg.Uplo, name, None) or getattr(pkg.Diag, name)


@pytest.mark.parametrize("cls,kw", [
    ("BandMatrix", dict(kl=3, ku=2)),
    ("TriangularBandMatrix", dict(kd=3, uplo="Upper", diag="Unit")),
    ("HermitianBandMatrix", dict(kd=4, uplo="Lower")),
])
def test_band_classes_expand_as_the_reference(cls, kw):
    a = _rand(3, 30, 30, np.complex128)
    a = a + a.conj().T

    def make(pkg, device):
        k = {key: (getattr(pkg.Uplo, v) if key == "uplo" else
                   getattr(pkg.Diag, v) if key == "diag" else v)
             for key, v in kw.items()}
        C = getattr(pkg, cls)
        if cls == "BandMatrix":
            M = C.from_numpy(a, k["kl"], k["ku"], 8, **device)
        else:
            M = C.from_numpy(a, k.pop("kd"), 8, **k, **device)
        return M
    R, P = make(ref, {}), make(st, {"device": "cpu"})
    assert (R.kl, R.ku) == (P.kl, P.ku)
    for r, p in ((R, P), (R.T, P.T)):
        _bits(p.to_numpy(), r.to_numpy())
        assert type(p).__name__ == type(r).__name__


# ------------------------------------------------------------- elementwise

def _tiles(seed, m, n, mb, nb, dtype):
    a = _rand(seed, m, n, dtype)
    return (np.asarray(ref.Matrix.from_numpy(a, mb, nb).storage.canonical()),
            st.Matrix.from_numpy(a, mb, nb, device="cpu").storage.canonical())


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_elementwise_kernels_bit_equal(dtype):
    m, n, mb, nb = 21, 17, 8, 4
    ar, ap = _tiles(4, m, n, mb, nb, dtype)
    br, bp = _tiles(5, m, n, mb, nb, dtype)
    r = np.random.default_rng(6).standard_normal(m).astype(dtype)
    c = np.random.default_rng(7).standard_normal(n).astype(dtype)
    cases = [
        (ref_ew.geadd(2.5, ar, -0.5, br), ew.geadd(2.5, ap, -0.5, bp)),
        (ref_ew.gecopy(ar), ew.gecopy(ap)),
        (ref_ew.gescale(3.0, 7.0, ar), ew.gescale(3.0, 7.0, ap)),
        (ref_ew.gescale_row_col(r, c, ar, m, n, mb, nb),
         ew.gescale_row_col(torch.from_numpy(r), torch.from_numpy(c), ap, m,
                            n, mb, nb)),
        (ref_ew.geset(0.5, 2.0, ar, m, n, mb, nb),
         ew.geset(0.5, 2.0, ap, m, n, mb, nb)),
        (ref_ew.transpose_tiles(ar, conj=True),
         ew.transpose_tiles(ap, conj=True).resolve_conj()),
        (ref_ew.transpose_tiles(ar), ew.transpose_tiles(ap)),
    ]
    for lower in (True, False):
        cases += [
            (ref_ew.tzadd(2.5, ar, -0.5, br, m, n, mb, nb, lower),
             ew.tzadd(2.5, ap, -0.5, bp, m, n, mb, nb, lower)),
            (ref_ew.tzcopy(ar, br, m, n, mb, nb, lower),
             ew.tzcopy(ap, bp, m, n, mb, nb, lower)),
            (ref_ew.tzscale(3.0, 7.0, ar, m, n, mb, nb, lower),
             ew.tzscale(3.0, 7.0, ap, m, n, mb, nb, lower)),
            (ref_ew.tzset(0.5, 2.0, ar, m, n, mb, nb, lower),
             ew.tzset(0.5, 2.0, ap, m, n, mb, nb, lower)),
        ]
    for want, got in cases:
        _bits(got.contiguous().numpy(), np.asarray(want))
    mr, mc = ew.valid_masks(m, n, mb, nb)
    wr, wc = ref_ew.valid_masks(m, n, mb, nb)
    assert np.array_equal(mr.numpy(), np.asarray(wr))
    assert np.array_equal(mc.numpy(), np.asarray(wc))
    assert np.array_equal(ew.tri_mask(m, n, mb, nb, True, strict=True),
                          np.asarray(ref_ew.tri_mask(m, n, mb, nb, True,
                                                     strict=True)))


# ------------------------------------------------------------- aux drivers

def _pair(kind, a, nb):
    if kind == "general":
        return ref.Matrix.from_numpy(a, nb), st.Matrix.from_numpy(
            a, nb, device="cpu")
    if kind == "transposed":
        return (ref.Matrix.from_numpy(a, nb).T,
                st.Matrix.from_numpy(a, nb, device="cpu").T)
    cls = {"triangular": "TriangularMatrix",
           "hermitian": "HermitianMatrix"}[kind]
    return (getattr(ref, cls).from_numpy(a, nb, ref.Uplo.Upper),
            getattr(st, cls).from_numpy(a, nb, st.Uplo.Upper,
                                        device="cpu"))


@pytest.mark.parametrize("kind", ["general", "transposed", "triangular",
                                  "hermitian"])
def test_aux_drivers_bit_equal(kind):
    """copy (with dtype conversion), scale, set, add and col_norms on each
    structure, through the tile route or the dense route as each package
    dispatches it: the same bits in the same class."""
    a = _rand(8, 24, 24)
    b = _rand(9, 24, 24)
    Ra, Pa = _pair(kind, a, 8)
    Rb, Pb = _pair(kind, b, 8)
    pairs = [
        (ref.copy(Ra, Rb), st.copy(Pa, Pb)),
        (ref.scale(2.0, 3.0, Ra), st.scale(2.0, 3.0, Pa)),
        (ref.set(0.25, -1.0, Ra), st.set(0.25, -1.0, Pa)),
        (ref.add(1.5, Ra, -2.0, Rb), st.add(1.5, Pa, -2.0, Pb)),
    ]
    for want, got in pairs:
        assert type(got).__name__ == type(want).__name__
        _bits(got.to_numpy(), want.to_numpy())
    _bits(st.col_norms(Pa).numpy(), np.asarray(ref.col_norms(Ra)))
    # a converting copy into an f32 matrix of the same structure
    R32, P32 = _pair(kind, b.astype(np.float32), 8)
    want, got = ref.copy(Ra, R32), st.copy(Pa, P32)
    assert got.dtype == torch.float32
    _bits(got.to_numpy(), want.to_numpy())


def test_scale_row_col_and_redistribute():
    a = _rand(10, 30, 20)
    r = np.random.default_rng(11).standard_normal(30)
    c = np.random.default_rng(12).standard_normal(20)
    R = ref.Matrix.from_numpy(a, 8)
    P = st.Matrix.from_numpy(a, 8, device="cpu")
    _bits(st.scale_row_col(r, c, P).to_numpy(),
          ref.scale_row_col(r, c, R).to_numpy())
    _bits(st.scale_row_col(c, r, P.T).to_numpy(),
          ref.scale_row_col(c, r, R.T).to_numpy())
    for mb, nb in ((8, 8), (5, 7), (16, 4)):
        want, got = ref.redistribute(R, mb, nb), st.redistribute(P, mb, nb)
        assert (got.mb, got.nb) == (want.mb, want.nb) == (mb, nb)
        _bits(got.storage.data.numpy(), np.asarray(want.storage.data))
    H = st.HermitianMatrix.from_numpy(a[:20, :20], 8, device="cpu")
    Hr = ref.HermitianMatrix.from_numpy(a[:20, :20], 8)
    _bits(st.redistribute(H, 4).to_numpy(), ref.redistribute(Hr, 4)
          .to_numpy())


@pytest.mark.parametrize("norm", ["One", "Inf", "Max", "Fro"])
def test_band_norms_dispatch_as_the_reference(norm):
    a = _rand(13, 40, 40)
    a = a + a.T
    for cls, args in (("BandMatrix", (3, 5)), ("HermitianBandMatrix", (4,))):
        want = ref.norm(getattr(ref.Norm, norm),
                        getattr(ref, cls).from_numpy(a, *args, 8))
        got = st.norm(getattr(st.Norm, norm),
                      getattr(st, cls).from_numpy(a, *args, 8, device="cpu"))
        assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


# ------------------------------------------------------------- inverses

def _tri(seed, n, dtype, lower=True):
    a = _rand(seed, n, n, dtype)
    t = np.tril(a) if lower else np.triu(a)
    return t + n * np.eye(n, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo,diag", [("Lower", "NonUnit"),
                                       ("Upper", "NonUnit"),
                                       ("Lower", "Unit")])
def test_trtri_trtrm(ref_drivers, dtype, uplo, diag):
    n, nb = 40, 8
    t = _tri(14, n, dtype, uplo == "Lower")
    R = ref.TriangularMatrix.from_numpy(t, nb, getattr(ref.Uplo, uplo),
                                        getattr(ref.Diag, diag))
    P = st.TriangularMatrix.from_numpy(t, nb, getattr(st.Uplo, uplo),
                                       getattr(st.Diag, diag), device="cpu")
    want, got = ref.trtri(R), st.trtri(P)
    assert (got.uplo.value, got.diag.value) == (want.uplo.value,
                                                want.diag.value)
    _close(got.to_numpy(), want.to_numpy(), dtype)
    _close(st.trtrm(got).to_numpy(), ref.trtrm(want).to_numpy(), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_potri(ref_drivers, dtype):
    a = _rand(15, 48, 48, dtype)
    a = a @ a.conj().T + 48 * np.eye(48)
    a = a.astype(dtype)
    L_ref = ref.potrf(ref.HermitianMatrix.from_numpy(a, 16))
    L = st.potrf(st.HermitianMatrix.from_numpy(a, 16, device="cpu"))
    want, got = ref.potri(L_ref), st.potri(L)
    assert type(got).__name__ == type(want).__name__ == "HermitianMatrix"
    _close(got.to_numpy(), want.to_numpy(), dtype)
    _close(got.to_numpy(), np.linalg.inv(a.astype(np.complex128)),
           np.float32 if dtype in (np.float32, np.complex64) else dtype)


@pytest.mark.parametrize("policy", ["Raise", "Nan", "Info"])
def test_trtri_and_potri_zero_diagonal_info(ref_drivers, policy):
    """A zero diagonal entry at index 17: info = 18 (the first zero pivot,
    1-based) under every ErrorPolicy, as the reference reports it."""
    t = _tri(16, 40, np.float64)
    t[17, 17] = 0.0
    R = ref.TriangularMatrix.from_numpy(t, 8)
    P = st.TriangularMatrix.from_numpy(t, 8, device="cpu")
    o_r = {ref.Option.ErrorPolicy: getattr(ref.ErrorPolicy, policy)}
    o_p = {st.Option.ErrorPolicy: getattr(st.ErrorPolicy, policy)}
    if policy == "Raise":
        with pytest.raises(ref.SlateSingularError) as er:
            ref.trtri(R, o_r)
        with pytest.raises(st.SlateSingularError) as ep:
            st.trtri(P, o_p)
        assert ep.value.info == er.value.info == 18
        with pytest.raises(st.SlateSingularError) as ep:
            st.potri(P, o_p)
        assert ep.value.info == 18
    elif policy == "Nan":
        assert np.isnan(st.trtri(P, o_p).storage.data.numpy()).all()
        assert np.isnan(np.asarray(ref.trtri(R, o_r).storage.data)).all()
    else:
        _, hr = ref.trtri(R, o_r)
        _, hp = st.trtri(P, o_p)
        assert hp.info == int(hr.info) == 18 and not hp.ok
        _, hp2 = st.potri(P, o_p)
        _, hr2 = ref.potri(R, o_r)
        assert hp2.info == int(hr2.info) == 18


# ------------------------------------------------------------- condest

def _count_calls(fn, box):
    def wrapped(x):
        box[0] += 1
        return fn(x)
    return wrapped


@pytest.mark.parametrize("seed", [17, 18, 19])
@pytest.mark.parametrize("n", [1, 9, 40])
def test_norm1est_same_iterations(seed, n):
    """Hager/Higham on the same matrix: the same estimate (1e-10) and the
    same number of loop iterations (the reference's while_loop run
    eagerly under disable_jit, its applier calls counted)."""
    a = _rand(seed, n, n) + 2 * np.eye(n)
    ainv = np.linalg.inv(a)
    calls = [0]
    ai, aih = jax.numpy.asarray(ainv), jax.numpy.asarray(ainv.T)
    with jax.disable_jit():
        est_r, bad_r = ref_condest._norm1est_flag(
            _count_calls(lambda x: ai @ x, calls), lambda x: aih @ x, n,
            np.float64)
    ti, tih = torch.from_numpy(ainv), torch.from_numpy(ainv.T.copy())
    est, bad, iters = port_condest._norm1est_flag(
        lambda x: ti @ x, lambda x: tih @ x, n, torch.float64,
        torch.device("cpu"))
    assert iters == calls[0] - 1           # the last call: the safeguard
    assert bad == bool(bad_r) is False
    assert abs(est - float(est_r)) <= 1e-10 * abs(float(est_r))
    assert st.norm1est(lambda x: ti @ x, lambda x: tih @ x, n,
                       torch.float64, device="cpu") == est


@pytest.mark.parametrize("norm", ["One", "Inf"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gecondest_trcondest(ref_drivers, norm, dtype):
    a = _rand(20, 32, 32, dtype) + 4 * np.eye(32)
    Fr = ref.getrf(ref.Matrix.from_numpy(a, 8))
    Fp = st.getrf(st.Matrix.from_numpy(a, 8, device="cpu"))
    anorm = np.abs(a).sum(axis=0 if norm == "One" else 1).max()
    want = float(ref.gecondest(Fr, anorm, norm=getattr(ref.Norm, norm)))
    got = st.gecondest(Fp, anorm, norm=getattr(st.Norm, norm))
    assert abs(got - want) <= 1e-10 * want
    exact = 1.0 / (anorm * np.abs(np.linalg.inv(a)).sum(
        axis=0 if norm == "One" else 1).max())
    assert 0.3 * exact <= got <= 3.0 * exact
    t = _tri(21, 32, dtype, lower=False)
    want = float(ref.trcondest(ref.TriangularMatrix.from_numpy(
        t, 8, ref.Uplo.Upper), norm=getattr(ref.Norm, norm)))
    got = st.trcondest(st.TriangularMatrix.from_numpy(
        t, 8, st.Uplo.Upper, device="cpu"), norm=getattr(st.Norm, norm))
    assert abs(got - want) <= 1e-10 * want


def test_condest_singular_factor_gives_zero_not_nan(ref_drivers):
    t = _tri(22, 24, np.float64)
    t[5, 5] = 0.0
    o = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    rcond, h = st.trcondest(st.TriangularMatrix.from_numpy(t, 8,
                                                           device="cpu"), o)
    rr, hr = ref.trcondest(ref.TriangularMatrix.from_numpy(t, 8),
                           {ref.Option.ErrorPolicy: ref.ErrorPolicy.Info})
    assert rcond == float(rr) == 0.0
    assert h.nonfinite == bool(hr.nonfinite) is True


# ------------------------------------------------------------- printing

@pytest.mark.parametrize("verbose", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("what", ["general", "hermitian", "band", "hband",
                                  "complex"])
def test_format_matrix_equal_strings(verbose, what):
    a = _rand(23, 12, 12, np.complex64 if what == "complex" else np.float64)
    if what == "hermitian":
        R = ref.HermitianMatrix.from_numpy(a, 4)
        P = st.HermitianMatrix.from_numpy(a, 4, device="cpu")
    elif what == "band":
        R = ref.BandMatrix.from_numpy(a, 2, 1, 4)
        P = st.BandMatrix.from_numpy(a, 2, 1, 4, device="cpu")
    elif what == "hband":
        R = ref.HermitianBandMatrix.from_numpy(a, 2, 4)
        P = st.HermitianBandMatrix.from_numpy(a, 2, 4, device="cpu")
    else:
        R = ref.Matrix.from_numpy(a, 4, 3)
        P = st.Matrix.from_numpy(a, 4, 3, device="cpu")
    for edge in (2, 16):
        o_r = {ref.Option.PrintVerbose: verbose,
               ref.Option.PrintEdgeItems: edge}
        o_p = {st.Option.PrintVerbose: verbose,
               st.Option.PrintEdgeItems: edge}
        assert st.format_matrix("A", P, o_p) == ref.format_matrix("A", R,
                                                                   o_r)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st.print_matrix("A", P, {st.Option.PrintVerbose: verbose})
    assert buf.getvalue() == ("" if verbose == 0 else ref.format_matrix(
        "A", R, {ref.Option.PrintVerbose: verbose}) + "\n")
