"""slate_tpu_torch core layer against slate_tpu: layout, storage, matrix
classes, options and the package's rules (no JAX import, CUDA by default).

Layout, storage and the matrix views move bytes without arithmetic, so
they must match the reference bit for bit.  Everything runs on the CPU
(``device="cpu"``); inputs come from numpy with fixed seeds.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import ast
import pathlib

import numpy as np
import pytest
import torch

import slate_tpu as ref
from slate_tpu.core import layout as ref_layout

import slate_tpu_torch as st
from slate_tpu_torch.convert import matrix_from_jax, storage_from_jax
from slate_tpu_torch.core import layout
from slate_tpu_torch.drivers.blas3 import as_root_general
from slate_tpu_torch.examples.run_all import EXAMPLES

PKG = pathlib.Path(st.__file__).resolve().parent
SHAPES = [(64, 64, 32, 32), (100, 70, 32, 16), (7, 130, 8, 64)]


def _np(t):
    return t.resolve_conj().cpu().numpy()


@pytest.mark.parametrize("m,n,mb,nb", SHAPES)
def test_layout_tile_untile_bit_identical(m, n, mb, nb):
    a = np.random.default_rng(1).standard_normal((m, n)).astype(np.float32)
    ref_tiles = np.asarray(ref_layout.tile_dense(a, mb, nb))
    tiles = layout.tile_dense(torch.from_numpy(a), mb, nb)
    np.testing.assert_array_equal(_np(tiles), ref_tiles)
    np.testing.assert_array_equal(_np(layout.untile_dense(tiles, m, n)), a)


@pytest.mark.parametrize("Mt,p", [(5, 1), (5, 2), (8, 3)])
def test_layout_cyclic_maps_match_reference(Mt, p):
    for got, want in zip(layout.cyclic_row_maps(Mt, p),
                         ref_layout.cyclic_row_maps(Mt, p)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    tiles = np.arange(Mt * 3 * 4, dtype=np.float32).reshape(Mt, 3, 2, 2)
    cyc = layout.canonical_to_cyclic(torch.from_numpy(tiles), p, 2)
    np.testing.assert_array_equal(
        _np(cyc), np.asarray(ref_layout.canonical_to_cyclic(tiles, p, 2)))
    back = layout.cyclic_to_canonical(cyc, Mt, 3, p, 2)
    np.testing.assert_array_equal(_np(back), tiles)


@pytest.mark.parametrize("m,n,mb,nb", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_storage_from_jax_is_byte_identical(m, n, mb, nb, dtype):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((m, n)).astype(dtype)
    if np.iscomplexobj(a):
        a = a + 1j * rng.standard_normal((m, n)).astype(np.float32)
    rst = ref.TileStorage.from_dense(a, mb, nb)
    data = np.asarray(rst.data)
    mine = st.TileStorage.from_dense(torch.from_numpy(a), mb, nb)
    np.testing.assert_array_equal(_np(mine.data), data)
    conv = storage_from_jax(data, m, n, mb, nb, device="cpu")
    np.testing.assert_array_equal(_np(conv.data), data)
    np.testing.assert_array_equal(_np(conv.to_dense()), a)
    assert (conv.Mt, conv.Nt) == (rst.Mt, rst.Nt)
    for i in range(conv.Mt):
        assert conv.tile_mb(i) == rst.tile_mb(i)
    np.testing.assert_array_equal(_np(conv.tile(conv.Mt - 1, 0)),
                                  np.asarray(rst.tile(rst.Mt - 1, 0)))


def _ref_and_port(kind, a, nb, uplo):
    if kind == "general":
        R = ref.Matrix.from_numpy(a, nb)
        P = st.Matrix.from_numpy(a, nb, device="cpu")
    else:
        cls = {"symmetric": "SymmetricMatrix", "hermitian": "HermitianMatrix",
               "triangular": "TriangularMatrix"}[kind]
        R = getattr(ref, cls).from_numpy(a, nb, getattr(ref.Uplo, uplo))
        P = getattr(st, cls).from_numpy(a, nb, getattr(st.Uplo, uplo),
                                        device="cpu")
    return R, P


@pytest.mark.parametrize("kind,uplo", [
    ("general", "Lower"), ("symmetric", "Lower"), ("symmetric", "Upper"),
    ("hermitian", "Lower"), ("hermitian", "Upper"), ("triangular", "Upper")])
def test_matrix_views_match_reference_bit_for_bit(kind, uplo):
    rng = np.random.default_rng(3)
    n, nb = 70, 32
    a = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    R, P = _ref_and_port(kind, a, nb, uplo)
    np.testing.assert_array_equal(_np(P.storage.data),
                                  np.asarray(R.storage.data))
    for r, p in [(R, P), (R.conj_transpose(), P.conj_transpose()),
                 (R.transpose(), P.transpose())]:
        np.testing.assert_array_equal(_np(p.to_dense()),
                                      np.asarray(r.to_dense()))
        np.testing.assert_array_equal(p.to_numpy(), r.to_numpy())
        assert (p.m, p.n, p.mb, p.nb, p.mt, p.nt) == \
            (r.m, r.n, r.mb, r.nb, r.mt, r.nt)
        assert p.op.value == r.op.value
        if kind != "general":
            assert p._uplo_logical().value == r._uplo_logical().value
        conv = matrix_from_jax(r, device="cpu")
        assert type(conv) is type(p)
        np.testing.assert_array_equal(_np(conv.to_dense()),
                                      np.asarray(r.to_dense()))


def test_as_root_general():
    a = np.random.default_rng(4).standard_normal((64, 64)).astype(np.float32)
    S = st.SymmetricMatrix.from_numpy(a, 32, st.Uplo.Lower, device="cpu")
    G = as_root_general(S)
    assert type(G) is st.Matrix and G.is_root_view()
    np.testing.assert_array_equal(G.to_numpy(), S.to_numpy())
    assert as_root_general(G) is G
    T = as_root_general(st.Matrix.from_numpy(a, 32, device="cpu").transpose(),
                        mb=16, nb=64)
    assert (T.mb, T.nb, T.op) == (16, 64, st.Op.NoTrans)
    np.testing.assert_array_equal(T.to_numpy(), a.T)


def test_options_coerce_and_unported_targets_raise():
    from slate_tpu_torch.options import get_option, resolve_target
    o = {st.Option.Target: "single", st.Option.ErrorPolicy: "info"}
    assert get_option(o, st.Option.Target) is st.Target.single
    assert get_option(o, st.Option.ErrorPolicy) is st.ErrorPolicy.Info
    assert get_option(None, st.Option.UseFallbackSolver) is True
    assert get_option(None, st.Option.Tolerance, default=None) is None
    A = st.Matrix.from_numpy(np.eye(4, dtype=np.float32), 2, device="cpu")
    assert resolve_target(None, A) is st.Target.single
    # Target.mesh resolves as the reference's does; a driver takes its
    # mesh route only where the grid also carries a process group
    assert resolve_target({st.Option.Target: st.Target.mesh},
                          A) is st.Target.mesh
    # a grid larger than the ranks it has raises, as grid.py:65-66 does
    with pytest.raises(st.SlateError, match="need 4 ranks, have 1"):
        st.Grid(2, 2)
    assert st.Grid(1, 1).size == 1 and st.Grid(1, 1).group is None


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """device=None means CUDA: with no card, an entry point raises rather
    than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.eye(64, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.SymmetricMatrix.from_numpy(a, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.Matrix.from_numpy(a, 32, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        storage_from_jax(np.zeros((1, 1, 4, 4), np.float32), 4, 4, 4, 4)
    assert st.Matrix.from_numpy(a, 32, device="cpu").device.type == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "slate_tpu", "tools")


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of slate_tpu_torch, chip_smoke.py and the card-only test
    file are scanned with ast: no import of jax, of slate_tpu (or anything
    under slate_tpu.) or of the reference's tools/ (its lint and tester);
    slate_tpu_torch itself is allowed."""
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py",
                                         PKG.parent / "tests" /
                                         "test_torch_cuda.py"]
    assert len(files) > 15
    names = {str(f.relative_to(PKG.parent)) for f in files}
    assert {"slate_tpu_torch/drivers/heev.py",
            "slate_tpu_torch/drivers/stedc.py",
            "slate_tpu_torch/drivers/svd.py",
            "slate_tpu_torch/compat/capi.py",
            "slate_tpu_torch/compat/lapack.py",
            "slate_tpu_torch/compat/scalapack.py",
            "slate_tpu_torch/compat/scalapack_api.py",
            "slate_tpu_torch/compat/fortran.py",
            "slate_tpu_torch/robust/checkpoint.py",
            "slate_tpu_torch/util/debug.py",
            "slate_tpu_torch/native.py",
            "slate_tpu_torch/tester.py",
            "slate_tpu_torch/lint/cli.py",
            "slate_tpu_torch/lint/rules/concurrency.py",
            "slate_tpu_torch/examples/_common.py",
            "slate_tpu_torch/examples/run_all.py",
            *(f"slate_tpu_torch/examples/{name}.py"
              for name in EXAMPLES)} <= names
    bad = [(f.name, mod) for f in files for mod in _imports(f)
           if _forbidden(mod)]
    assert bad == []
    # the C host embeds the port's entry points, not the reference's
    host = (PKG / "native" / "slate_tpu_torch_capi.cc").read_text()
    assert '"slate_tpu_torch.compat.capi"' in host
    assert '"slate_tpu.' not in host
    assert not _forbidden("slate_tpu_torch.core")
    assert _forbidden("slate_tpu.core") and _forbidden("jax.numpy")
    assert _forbidden("tools.slate_lint") and not _forbidden("toolsx")
    # every CPU test file of the port caps its compute threads
    # (tests/torch_threads.py); the card-only file runs alone and does not
    cpu_tests = [f for f in sorted((PKG.parent / "tests").glob(
        "test_torch_*.py")) if f.name != "test_torch_cuda.py"]
    assert len(cpu_tests) > 40
    assert [f.name for f in cpu_tests
            if "torch_threads" not in set(_imports(f))] == []
