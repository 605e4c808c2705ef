"""slate_tpu_torch.tester against tools/tester.py, the reference's tester.

Each port runner draws its inputs from the port's generator, which must
give the reference generator's bits for the same seed; each runner passes
at n = 48, nb = 8 on the serial route (types d and z, and s where the
runner reaches a hand kernel on the card), and its result agrees with the
reference driver's, run by the reference's own runner on the same input.
The reference compiles a driver per tile count, and a solution does not
depend on the tiling, so its runners run with one 48-wide tile (pbsv,
whose bandwidth comes from nb, at nb = 8).  The command line gives the
reference's rows for the same parameter file, exits 1 on a FAILED or
ERROR row, raises without a GPU unless asked for the CPU, and runs on
grids in a gloo world of four processes.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import contextlib
import importlib.util
import io
import pathlib

import jax
import numpy as np
import pytest
import torch

import slate_tpu as ref
import slate_tpu_torch as st
from slate_tpu_torch import tester

import torch_dist_cases as cases
from torch_dist_worlds import run_world

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, NB = 48, 8
REF_NB = 48                     # one tile: the reference's drivers compile
TOL = {"s": 1e-4, "d": 1e-12, "z": 1e-12}
# the s rows: the routines whose f32 route reaches K0-K5 on the card
SINGLE = ("posv", "gesv_tntpiv", "geqrf")
CASES = [(r, t) for r in tester.RUNNERS for t in ("d", "z")] + [
    (r, "s") for r in SINGLE]


def _load_ref_tester():
    spec = importlib.util.spec_from_file_location(
        "ref_tester", ROOT / "tools" / "tester.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RT = _load_ref_tester()


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().cpu().numpy()
    return np.asarray(x)


class Recorder:
    """Stands in for the reference tester's ``st``: records what the named
    drivers return."""

    def __init__(self, names):
        self.names = names
        self.out = {}

    def __getattr__(self, name):
        attr = getattr(ref, name)
        if name not in self.names:
            return attr

        def call(*args, **kw):
            self.out[name] = attr(*args, **kw)
            return self.out[name]
        return call


# the reference driver each runner's result comes from, and how to read it
def _last(res):
    return (res[-1] if isinstance(res, tuple) else res).to_numpy()


READ = {
    "gemm": ("gemm", lambda r, n: r.to_numpy()),
    "posv": ("posv", lambda r, n: _last(r)),
    "gesv": ("gesv", lambda r, n: _last(r)),
    "gesv_tntpiv": ("gesv", lambda r, n: _last(r)),
    "hesv": ("hesv", lambda r, n: _last(r)),
    "trsm": ("trsm", lambda r, n: r.to_numpy()),
    "herk": ("herk", lambda r, n: r.general().to_numpy()),
    "geqrf": ("geqrf", lambda r, n: np.triu(r.QR.to_numpy()[:n, :n])),
    "pbsv": ("pbsv", lambda r, n: _last(r)),
    "getri": ("getriOOP", lambda r, n: r.to_numpy()),
    "norm": ("norm", lambda r, n: float(r)),
    "gels": ("gels", lambda r, n: r.to_numpy()[:n]),
    "heev": ("heev", lambda r, n: np.sort(np.asarray(r[0]))),
    "svd": ("svd_vals", lambda r, n: np.sort(np.asarray(r))[::-1]),
}


def _port_run(routine, dtype):
    r = tester.Run(None, torch.device("cpu"))
    return tester.RUNNERS[routine](N, NB, dtype, r)


@pytest.mark.parametrize("routine,t", CASES)
def test_runner_inputs_are_the_reference_generators_bits(routine, t,
                                                         monkeypatch):
    """Every matrix a port runner draws is, bit for bit, what
    slate_tpu.util.generator gives for the same kind, shape and seed."""
    dtype = tester.DTYPES[t]
    drawn = []

    def spy(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            drawn.append((name, args, kw, out.to_numpy()))
            return out
        monkeypatch.setattr(tester, name, call)
    spy("generate_matrix", tester.generate_matrix)
    spy("generate_hermitian", tester.generate_hermitian)
    _port_run(routine, dtype)
    if routine == "pbsv":
        # the band system comes from numpy: the reference's own draws
        kd = max(2, NB // 2)
        rng = np.random.default_rng(3)
        a = np.zeros((N, N), dtype)
        for d in range(kd + 1):
            a += np.diag(rng.standard_normal(N - d).astype(dtype) * 0.1, -d)
        a = a + a.conj().T + (2 * kd + 4) * np.eye(N, dtype=dtype)
        got_a, got_b = tester.pbsv_system(N, kd, dtype)
        np.testing.assert_array_equal(got_a, a)
        np.testing.assert_array_equal(
            got_b, rng.standard_normal((N, 4)).astype(dtype))
        return
    assert drawn
    for name, args, kw, got in drawn:
        kw = {k: v for k, v in kw.items() if k not in ("grid", "device")}
        want = getattr(ref, name)(*args, **kw).to_numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("routine,t", CASES)
def test_runner_passes_and_agrees_with_the_reference(routine, t,
                                                     ref_drivers,
                                                     monkeypatch):
    """The port runner passes; its result agrees with the reference
    driver's on the same input, 1e-12 in d and z and 1e-4 in s (relative
    to its largest entry; R of geqrf by magnitude, its rows' signs being
    the route's choice)."""
    dtype = tester.DTYPES[t]
    err, ok, out = _port_run(routine, dtype)
    assert ok, (routine, t, err)
    name, read = READ[routine]
    rec = Recorder({name})
    monkeypatch.setattr(RT, "st", rec)
    runners = {**RT.RUNNERS, **RT._late_runners()}
    ref_err, ref_ok = runners[routine](
        N, NB if routine == "pbsv" else REF_NB, None, dtype)
    assert ref_ok, (routine, t, ref_err)
    want, got = read(rec.out[name], N), _np(out)
    if routine == "geqrf":
        want, got = np.abs(want), np.abs(got)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() / scale < TOL[t], (routine, t)


def _rows(text):
    """(routine, type, n, nb, grid, status) of each table row printed."""
    rows = []
    for line in text.splitlines():
        f = line.split()
        if len(f) >= 9 and f[1] in tester.DTYPES and f[2].isdigit():
            rows.append((f[0], f[1], int(f[2]), int(f[3]), f[4],
                         " ".join(f[8:])))
    return rows


def _reference_sweep(monkeypatch, argv):
    """The rows the reference tester sweeps for ``argv``, its runners
    stubbed to pass (its sweep order and parameter handling, not its
    drivers)."""
    stub = {name: (lambda n, nb, grid, dtype: (0.0, True))
            for name in RT.RUNNERS}
    monkeypatch.setattr(RT, "RUNNERS", stub)
    monkeypatch.setattr(RT, "_late_runners", lambda: {})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert RT.main(argv) == 0
    return _rows(buf.getvalue())


def test_quick_params_give_the_reference_rows(monkeypatch):
    """@quick.txt (the port's copy of tools/params/quick.txt) sweeps the
    reference's rows; in a world of one process the 1x1 rows pass and the
    2x2 rows are skips that name the ranks they need."""
    want = _reference_sweep(
        monkeypatch, ["@" + str(ROOT / "tools" / "params" / "quick.txt")])
    assert (ROOT / "slate_tpu_torch" / "params" / "quick.txt").read_text() \
        == (ROOT / "tools" / "params" / "quick.txt").read_text()
    buf, rows = io.StringIO(), []
    with contextlib.redirect_stdout(buf):
        rc = tester.main(["@quick.txt", "--device", "cpu"], rows)
    assert rc == 0
    got = _rows(buf.getvalue())
    assert [g[:5] for g in got] == [w[:5] for w in want]
    for g in got:
        assert g[5] == ("pass" if g[4] == "1x1"
                        else "skip (needs 4 ranks, world has 1)"), g
    assert buf.getvalue().rstrip().endswith("0 failure(s), 7 skip(s)")
    assert [r["status"] for r in rows] == [g[5] for g in got]


@pytest.mark.parametrize("ref_mode", [False, True])
def test_every_runner_passes_in_d_and_z_on_the_cpu(ref_mode):
    argv = ["all", "--device", "cpu", "--dims", "48", "--nb", "8",
            "--type", "d,z", "--grids", "1x1"] + (["--ref"] if ref_mode
                                                   else [])
    buf, rows = io.StringIO(), []
    with contextlib.redirect_stdout(buf):
        assert tester.main(argv, rows) == 0
    assert len(rows) == 2 * len(tester.RUNNERS)
    assert all(r["status"] == "pass" for r in rows)
    assert all(r["seconds"] > 0 and r["gflops"] > 0 for r in rows)


def test_a_failing_or_raising_runner_exits_1(monkeypatch):
    def fails(n, nb, dtype, r):
        return 1.0, False, None

    def raises(n, nb, dtype, r):
        raise ValueError("planted")
    monkeypatch.setitem(tester.RUNNERS, "gemm", fails)
    monkeypatch.setitem(tester.RUNNERS, "norm", raises)
    for routine, status in (("gemm", "FAILED"),
                            ("norm", "ERROR ValueError: planted")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tester.main([routine, "--device", "cpu", "--dims", "16",
                              "--nb", "8", "--grids", "1x1"])
        assert rc == 1
        assert _rows(buf.getvalue())[0][5] == status
        assert "1 failure(s)" in buf.getvalue()


def test_the_default_device_is_the_card():
    """Without --device the tester runs on CUDA: with no GPU it raises
    before running anything, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tester.main(["gemm", "--dims", "8", "--grids", "1x1"])


def test_tester_on_grids_in_a_gloo_world_of_4(tmp_path, monkeypatch):
    """Four gloo ranks: 1x1 is the serial route on each rank, 2x2 the
    mesh, 2x4 a skip row; @quick.txt gives the reference's rows, every
    one passing, as the reference's own sweep does."""
    want_quick = _reference_sweep(
        monkeypatch, ["@" + str(ROOT / "tools" / "params" / "quick.txt")])
    argvs = [["gemm", "posv", "gesv", "--grids", "1x1,2x2,2x4", "--dims",
              "48", "--nb", "8", "--device", "cpu"],
             ["@quick.txt", "--device", "cpu"]]
    ranks = run_world(4, cases.tester_body, (argvs,), tmp_dir=str(tmp_path))
    for rank, res in enumerate(ranks):
        assert [rc for rc, _, _ in res] == [0, 0], rank
        assert all(r["status"] in ("pass", "skip (needs 8 ranks, world "
                                   "has 4)") for _, rows, _ in res
                   for r in rows), rank
        if rank:
            assert all(text == "" for _, _, text in res)
    (_, _, grids), (_, _, quick) = ranks[0]
    got = _rows(grids)
    assert [(g[0], g[4], g[5]) for g in got] == [
        (r, spec, status) for r in ("gemm", "posv", "gesv")
        for spec, status in (("1x1", "pass"), ("2x2", "pass"),
                             ("2x4", "skip (needs 8 ranks, world has 4)"))]
    assert grids.rstrip().endswith("0 failure(s), 3 skip(s)")
    assert _rows(quick) == [w[:5] + ("pass",) for w in want_quick]
