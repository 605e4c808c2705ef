"""Parameter-sweep tester: SLATE's testsweeper/tester on the port (port of
tools/tester.py; ref: test/test.cc:43-80 routine sections,
test/test_gemm.cc:50-270 params and residual checks, test/run_tests.py
sweep driver).

Sweeps {routine, type, n, nb, grid}, holds each result against a residual
identity (or, with ``--ref``, against scipy), and prints a
time/gflops/error table with pass or FAILED a row, then ``N failure(s)``;
it exits 1 on any FAILED or ERROR row.

    python -m slate_tpu_torch.tester gemm posv gesv --dims 64,128 --nb 16
    python -m slate_tpu_torch.tester all --quick --device cpu
    python -m slate_tpu_torch.tester @quick.txt --device cpu
    torchrun --nproc-per-node 4 -m slate_tpu_torch.tester gemm posv \\
        --grids 1x1,2x2 --device cpu

``--device`` is ``cuda`` unless given, and raises without a GPU;
``--device cpu`` runs the kernels' plain versions.  ``@file`` arguments are
parameter files, one flag or value a line, read from the working
directory or else from this package's ``params/`` (quick.txt,
eig_svd.txt).

Grids.  Under torchrun (or in a process that has initialised a
``torch.distributed`` group: gloo on CPUs, NCCL on cards) every rank runs
the sweep and rank 0 prints the table.  A ``pxq`` spec with p*q <= the
world's size is ``Grid(p, q)`` over the world (ranks past p*q sit the row
out), ``1x1`` is the serial route, and a larger spec prints a skip row.

Where the port departs from the reference's tester:
- the time column brackets the driver calls alone, each between two
  device syncs (the reference times the whole runner, input generation
  and its residual included); gflops are ``_gflop``'s counts over that
  time, real-arithmetic counts with complex rows not scaled, as the
  reference counts them;
- heev and svd hold d and z to the reference's 1e-10, s and c to the
  ``--ref`` runners' single-precision bound 1e-4 (no f32 solve meets
  1e-10, the reference's included);
- norm holds d and z to the reference's absolute 1e-8, s and c to 1e-5 of
  the norm: two f32 sums of n terms in different orders differ by more
  than 1e-8 (the reference's own s and c rows fail at n = 4096);
- the residual identities are computed with torch on the result's device,
  in the reference's formulas; the oracles of heev, svd and the ``--ref``
  runners (numpy's and scipy's LAPACK) run on the host, as there.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .core.grid import Grid, join_world, world
from .core.matrix import HermitianBandMatrix, Matrix
from .core.storage import resolve_device
from .options import MethodLU, Option
from .types import Norm, Uplo
from .util.generator import generate_hermitian, generate_matrix
import slate_tpu_torch as st

DTYPES = {"s": np.float32, "d": np.float64,
          "c": np.complex64, "z": np.complex128}
_TCODE = {np.float32: "s", np.float64: "d",
          np.complex64: "c", np.complex128: "z"}
PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "params")


def _gflop(routine, n, nb=16):
    kd = max(2, nb // 2)                     # run_pbsv's bandwidth choice
    return {"gemm": 2 * n ** 3, "posv": n ** 3 / 3 + 2 * n ** 2,
            "gesv": 2 * n ** 3 / 3 + 2 * n ** 2,
            "gesv_tntpiv": 2 * n ** 3 / 3 + 2 * n ** 2,
            "hesv": n ** 3 / 3 + 2 * n ** 2,
            "trsm": 2 * n ** 2 * 6, "herk": n ** 2 * (n // 2 + 1),
            "pbsv": n * kd * (kd + 2) + 4 * n * kd * 4,
            "getri": 2 * n ** 3,
            "norm": n ** 2, "geqrf": 10 * n ** 3 / 3,  # runner is 2n x n
            "gels": 4 * n ** 3 / 3,
            "heev": 4 * n ** 3 / 3, "svd": 4 * n ** 3 / 3}.get(routine,
                                                               n ** 3) / 1e9


class Run:
    """One row's context: its grid (None: the serial route), the device of
    the serial route's data, and the seconds its driver calls took."""

    def __init__(self, grid: Grid | None, device: torch.device):
        self.grid = grid
        self.place = device if grid is None else None
        self.sync = device.type == "cuda"
        self.seconds = 0.0

    def call(self, fn, *args):
        """``fn(*args)``, timed between two device syncs."""
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if self.sync:
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return out

    def matrix(self, kind, m, n, nb, seed, dtype, cond=None) -> Matrix:
        return generate_matrix(kind, m, n, nb, seed=seed, dtype=dtype,
                               cond=cond, grid=self.grid, device=self.place)

    def hermitian(self, kind, n, nb, seed, dtype, cond):
        return generate_hermitian(kind, n, nb, seed=seed, dtype=dtype,
                                  cond=cond, grid=self.grid,
                                  device=self.place)

    def from_array(self, a, nb) -> Matrix:
        return Matrix.from_numpy(a, nb, nb, self.grid, device=self.place)


def _single(dtype) -> bool:
    return np.dtype(dtype) in (np.float32, np.complex64)


def _fro(x: torch.Tensor) -> float:
    """Frobenius norm of a matrix, 2-norm of a vector (np.linalg.norm)."""
    return float(torch.linalg.norm(x))


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve_error(a, x, b, n) -> float:
    return _fro(a @ x - b) / (_fro(a) * _fro(x) * n)


# ---- per-routine runners: return (error, ok, result) ----

def run_gemm(n, nb, dtype, r):
    A = r.matrix("randn", n, n, nb, 1, dtype)
    B = r.matrix("randn", n, n, nb, 2, dtype)
    C = r.call(st.gemm, 1.0, A, B)
    ref = A.to_dense() @ B.to_dense()
    c = C.to_dense()
    err = _fro(c - ref) / (_fro(ref) + 1)
    return err, err < (1e-5 if _single(dtype) else 1e-13), c


def run_posv(n, nb, dtype, r):
    A = r.hermitian("poev", n, nb, 1, dtype, cond=100.0)
    B = r.matrix("randn", n, 8, nb, 2, dtype)
    _, X = r.call(st.posv, A, B)
    x = X.to_dense()
    err = _solve_error(A.to_dense(), x, B.to_dense(), n)
    return err, err < (1e-4 if _single(dtype) else 1e-14), x


def run_gesv(n, nb, dtype, r):
    A = r.matrix("rand_dominant", n, n, nb, 1, dtype)
    B = r.matrix("randn", n, 8, nb, 2, dtype)
    _, X = r.call(st.gesv, A, B)
    x = X.to_dense()
    err = _solve_error(A.to_dense(), x, B.to_dense(), n)
    return err, err < (1e-4 if _single(dtype) else 1e-14), x


def run_norm(n, nb, dtype, r):
    A = r.matrix("randn", n, n, nb, 1, dtype)
    got = float(r.call(st.norm, Norm.One, A))
    want = float(A.to_dense().abs().sum(dim=0).max())
    err = abs(got - want)
    return err, err < (1e-5 * want if _single(dtype) else 1e-8), got


def run_gesv_tntpiv(n, nb, dtype, r):
    A = r.matrix("rand_dominant", n, n, nb, 1, dtype)
    B = r.matrix("randn", n, 8, nb, 2, dtype)
    _, X = r.call(st.gesv, A, B, {Option.MethodLU: MethodLU.CALU})
    x = X.to_dense()
    err = _solve_error(A.to_dense(), x, B.to_dense(), n)
    return err, err < (1e-4 if _single(dtype) else 1e-14), x


def run_hesv(n, nb, dtype, r):
    A = r.hermitian("heev", n, nb, 1, dtype, cond=50.0)
    B = r.matrix("randn", n, 4, nb, 2, dtype)
    _, X = r.call(st.hesv, A, B)
    x = X.to_dense()
    err = _solve_error(A.to_dense(), x, B.to_dense(), n)
    return err, err < (1e-3 if _single(dtype) else 1e-11), x


def run_trsm(n, nb, dtype, r):
    A = r.matrix("randn", n, n, nb, 1, dtype)
    a = A.to_dense()
    T = r.from_array(torch.tril(a) + n * _eye(n, a), nb).triangular(
        Uplo.Lower)
    B = r.matrix("randn", n, 6, nb, 2, dtype)
    X = r.call(st.trsm, "l", 1.0, T, B)
    t, x = T.to_dense(), X.to_dense()
    err = _fro(t @ x - B.to_dense()) / (_fro(t) * _fro(x) + 1)
    return err, err < (1e-5 if _single(dtype) else 1e-14), x


def run_herk(n, nb, dtype, r):
    A = r.matrix("randn", n, n // 2 + 1, nb, 1, dtype)
    C0 = r.hermitian("poev", n, nb, 2, dtype, cond=10.0)
    C = r.call(st.herk, 1.0, A, 0.5, C0)
    a = A.to_dense()
    ref = a @ a.conj().T + 0.5 * C0.to_dense()
    c = C.general().to_dense()
    err = _fro(c - ref) / (_fro(ref) + 1)
    return err, err < (1e-5 if _single(dtype) else 1e-13), c


def run_geqrf(n, nb, dtype, r):
    A = r.matrix("randn", 2 * n, n, nb, 1, dtype)
    F = r.call(st.geqrf, A)
    Q = st.qr_multiply(F).to_dense()
    R = torch.triu(F.QR.to_dense()[:n, :n])
    a = A.to_dense()
    err = _fro(Q @ R - a) / (_fro(a) + 1)
    err = max(err, _fro(Q.conj().T @ Q - _eye(n, Q)) / n)
    return err, err < (1e-5 if _single(dtype) else 1e-13), R


def pbsv_system(n, kd, dtype):
    """run_pbsv's band matrix and right-hand sides, the reference's draws
    (a diagonal set in place where the reference adds np.diag to zeros:
    the same bits, without n x n temporaries a diagonal)."""
    rng = np.random.default_rng(3)
    a = np.zeros((n, n), dtype)
    for d in range(kd + 1):
        v = rng.standard_normal(n - d).astype(dtype) * 0.1
        a[np.arange(d, n), np.arange(n - d)] = v
    a = a + a.conj().T + (2 * kd + 4) * np.eye(n, dtype=dtype)
    return a, rng.standard_normal((n, 4)).astype(dtype)


def run_pbsv(n, nb, dtype, r):
    if r.grid is not None:
        return None                          # packed band is single-device
    kd = max(2, nb // 2)
    a, b = pbsv_system(n, kd, dtype)
    A = HermitianBandMatrix.from_numpy(a, kd, nb, device=r.place)
    B = r.from_array(b, nb)
    _, X = r.call(st.pbsv, A, B)
    x = X.to_dense()
    err = _solve_error(torch.from_numpy(a).to(x.device), x,
                       torch.from_numpy(b).to(x.device), n)
    return err, err < (1e-5 if _single(dtype) else 1e-14), x


def run_getri(n, nb, dtype, r):
    A = r.matrix("rand_dominant", n, n, nb, 1, dtype)
    X = r.call(st.getriOOP, A)
    a, x = A.to_dense(), X.to_dense()
    err = _fro(a @ x - _eye(n, a)) / n
    return err, err < (1e-4 if _single(dtype) else 1e-12), x


def run_gels(n, nb, dtype, r):
    A = r.matrix("randn", 2 * n, n, nb, 1, dtype)
    B = r.matrix("randn", 2 * n, 4, nb, 2, dtype)
    X = r.call(st.gels, A, B)
    a, b, x = A.to_dense(), B.to_dense(), X.to_dense()[:n]
    # normal-equations residual: A^H (A x - b) ~ 0
    err = _fro(a.conj().T @ (a @ x - b)) / (_fro(a) ** 2 * _fro(x) + 1e-300)
    return err, err < (1e-4 if _single(dtype) else 1e-12), x


def _values_error(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.abs(want).max() + 1e-300))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def run_heev(n, nb, dtype, r):
    A = r.hermitian("heev", n, nb, 1, dtype, cond=100.0)
    lam, _ = r.call(st.heev, A)
    lam = np.sort(_host(lam))
    err = _values_error(lam, np.linalg.eigvalsh(A.to_numpy()))
    return err, err < (1e-4 if _single(dtype) else 1e-10), lam


def run_svd(n, nb, dtype, r):
    A = r.matrix("svd", n, n, nb, 1, dtype, cond=100.0)
    s = np.sort(_host(r.call(st.svd_vals, A)))[::-1]
    err = _values_error(s, np.linalg.svd(A.to_numpy(), compute_uv=False))
    return err, err < (1e-4 if _single(dtype) else 1e-10), s


RUNNERS = {"gemm": run_gemm, "posv": run_posv, "gesv": run_gesv,
           "gesv_tntpiv": run_gesv_tntpiv, "hesv": run_hesv,
           "trsm": run_trsm, "herk": run_herk, "geqrf": run_geqrf,
           "pbsv": run_pbsv, "getri": run_getri, "norm": run_norm,
           "gels": run_gels, "heev": run_heev, "svd": run_svd}


# ---- scipy reference-library cross-checks (the testsweeper --ref mode:
# compare RESULTS against the reference library, not just residual
# identities; ref: test/run_tests.py --ref) ----

def ref_gesv(n, nb, dtype, r):
    import scipy.linalg
    A = r.matrix("rand_dominant", n, n, nb, 1, dtype)
    B = r.matrix("randn", n, 8, nb, 2, dtype)
    _, X = r.call(st.gesv, A, B)
    x = X.to_numpy()
    xr = scipy.linalg.solve(A.to_numpy(), B.to_numpy())
    err = float(np.linalg.norm(x - xr) / (np.linalg.norm(xr) + 1))
    return err, err < (1e-3 if _single(dtype) else 1e-11), x


def ref_heev(n, nb, dtype, r):
    import scipy.linalg
    A = r.hermitian("heev", n, nb, 1, dtype, cond=100.0)
    lam, _ = r.call(st.heev, A)
    lam = np.sort(_host(lam))
    err = _values_error(lam, scipy.linalg.eigh(A.to_numpy(),
                                               eigvals_only=True))
    return err, err < (1e-4 if _single(dtype) else 1e-11), lam


def ref_svd(n, nb, dtype, r):
    import scipy.linalg
    A = r.matrix("svd", n, n, nb, 1, dtype, cond=100.0)
    s = np.sort(_host(r.call(st.svd_vals, A)))[::-1]
    err = _values_error(s, scipy.linalg.svdvals(A.to_numpy()))
    return err, err < (1e-4 if _single(dtype) else 1e-11), s


def ref_gels(n, nb, dtype, r):
    import scipy.linalg
    A = r.matrix("randn", 2 * n, n, nb, 1, dtype)
    B = r.matrix("randn", 2 * n, 4, nb, 2, dtype)
    x = r.call(st.gels, A, B).to_numpy()[:n]
    xr = scipy.linalg.lstsq(A.to_numpy(), B.to_numpy())[0]
    err = float(np.linalg.norm(x - xr) / (np.linalg.norm(xr) + 1))
    return err, err < (1e-3 if _single(dtype) else 1e-9), x


REF_RUNNERS = {"gesv": ref_gesv, "heev": ref_heev, "svd": ref_svd,
               "gels": ref_gels}


# ---- the sweep ----

def _params(argv: list[str]) -> list[str]:
    """``@name`` arguments not found from the working directory name this
    package's parameter files."""
    out = []
    for a in argv:
        if (a.startswith("@") and not os.path.exists(a[1:])
                and os.path.exists(os.path.join(PARAMS, a[1:]))):
            a = "@" + os.path.join(PARAMS, a[1:])
        out.append(a)
    return out


def _parser() -> argparse.ArgumentParser:
    # @file arguments are testsweeper-style per-routine parameter files
    # (one flag/argument per line; see params/*.txt)
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.tester",
                                 fromfile_prefix_chars="@")
    ap.add_argument("routines", nargs="+")
    ap.add_argument("--dims", default="64,128")
    ap.add_argument("--nb", default="16")
    ap.add_argument("--grids", default="1x1,2x2")
    ap.add_argument("--type", default="d", help="s,d,c,z")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ref", action="store_true",
                    help="cross-check RESULTS against scipy (the "
                         "reference-library comparison mode) where a "
                         "ref runner exists")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu "
                         "(the kernels' plain versions)")
    return ap


def _grids(specs, size: int, device: torch.device) -> dict:
    """Each spec's grid, built on every rank in the specs' order (a grid's
    subgroups are collective): None for 1x1 (the serial route), a Grid
    over the world where p*q <= its size, else the ranks it would need."""
    out = {}
    for spec in specs:
        p, q = (int(x) for x in spec.split("x"))
        if p * q == 1:
            out[spec] = None
        elif p * q > size:
            out[spec] = p * q
        else:
            out[spec] = Grid(p, q, device="cpu" if device.type == "cpu"
                             else None)
    return out


def _row(routine, dtype, n, nb, spec, rest: str) -> str:
    return (f"{routine:8} {_TCODE[dtype]:4} {n:6} {nb:4} {spec:>5} "
            f"{rest}")


def sweep(args, device: torch.device, size: int, echo=print,
          after_row=None) -> list[dict]:
    """Run every row of the parsed arguments; returns the rows (routine,
    type, n, nb, grid, seconds, gflops, error, status, and wall_s: the
    whole runner, inputs and residual included) and, on rank 0,
    prints the table as it goes; ``after_row(row)`` is called once each
    row that ran a runner has finished."""
    runners = dict(RUNNERS)
    if args.ref:
        runners.update(REF_RUNNERS)
    routines = list(runners) if args.routines == ["all"] else args.routines
    dims = [int(x) for x in args.dims.split(",")]
    nbs = [int(x) for x in args.nb.split(",")]
    specs = args.grids.split(",")
    dtypes = [DTYPES[t] for t in args.type.split(",")]
    if args.quick:
        dims, nbs, specs = dims[:1], nbs[:1], specs[:2]
    grids = _grids(specs, size, device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    hdr = (f"{'routine':8} {'type':4} {'n':>6} {'nb':>4} {'grid':>5} "
           f"{'time(s)':>9} {'gflops':>9} {'error':>10}  status")
    echo(hdr)
    echo("-" * len(hdr))
    rows = []
    for routine in routines:
        fn = runners[routine]
        for dtype in dtypes:
            for n in dims:
                for nb in nbs:
                    for spec in specs:
                        row = {"routine": routine, "type": _TCODE[dtype],
                               "n": n, "nb": nb, "grid": spec,
                               "seconds": None, "gflops": None,
                               "error": None}
                        rows.append(row)
                        grid = grids[spec]
                        blank = f"{'-':>9} {'-':>9} {'-':>10}  "
                        if isinstance(grid, int):
                            row["status"] = (f"skip (needs {grid} ranks, "
                                             f"world has {size})")
                            echo(_row(routine, dtype, n, nb, spec,
                                      blank + row["status"]))
                            continue
                        if grid is not None and not grid.member:
                            row["status"] = "skip (rank outside the grid)"
                            continue
                        r = Run(grid, device)
                        t0 = time.perf_counter()
                        try:
                            res = fn(n, nb, dtype, r)
                        except Exception as e:  # noqa: BLE001
                            row["status"] = (f"ERROR {type(e).__name__}: "
                                             f"{e}")
                            echo(_row(routine, dtype, n, nb, spec,
                                      blank + row["status"]))
                            continue
                        finally:
                            # the whole runner, as the reference times it
                            row["wall_s"] = time.perf_counter() - t0
                            if after_row is not None:
                                after_row(row)
                        if res is None:      # config not applicable
                            row["status"] = "skip"
                            echo(_row(routine, dtype, n, nb, spec,
                                      blank + "skip"))
                            continue
                        err, ok, _ = res
                        dt = r.seconds
                        gf = _gflop(routine, n, nb) / dt if dt > 0 else 0.0
                        row.update(seconds=dt, gflops=gf, error=float(err),
                                   status="pass" if ok else "FAILED")
                        echo(_row(routine, dtype, n, nb, spec,
                                  f"{dt:9.3f} {gf:9.2f} {err:10.2e}  "
                                  f"{row['status']}"))
    return rows


def failures(rows) -> int:
    return sum(r["status"] == "FAILED" or r["status"].startswith("ERROR")
               for r in rows)


def main(argv=None, rows: list | None = None, after_row=None) -> int:
    """The command line; appends each row to ``rows`` when given, and
    passes each row that ran to ``after_row`` (see :func:`sweep`)."""
    args = _parser().parse_args(_params(
        sys.argv[1:] if argv is None else list(argv)))
    device = resolve_device(args.device)
    joined = join_world(device)
    size, rank = world()
    echo = ((lambda s: print(s, flush=True)) if rank == 0
            else (lambda s: None))
    try:
        got = sweep(args, device, size, echo, after_row)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()
    if rows is not None:
        rows.extend(got)
    bad = failures(got)
    skips = sum(r["status"].startswith("skip") for r in got)
    echo(f"\n{bad} failure(s), {skips} skip(s)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
