"""Run every example in-process (port of examples/run_all.py; ref:
examples/run_tests.py run in CI, .github/workflows/test.sh:46-61).

    python -m slate_tpu_torch.examples.run_all [names ...] [--device cpu]
    torchrun --nproc-per-node 4 -m slate_tpu_torch.examples.run_all \\
        --device cpu

Every rank runs each example (one process a rank, in the world torchrun
announces or the one already initialised) and rank 0 prints; the names,
e.g. ex01_matrix, pick examples (all of them when none is given).  Exits
nonzero, naming them, when any example fails."""

import argparse
import importlib
import time

from ._common import say, session

EXAMPLES = [
    "ex01_matrix",
    "ex02_conversion",
    "ex03_submatrix",
    "ex04_norm",
    "ex05_blas",
    "ex06_linear_system_lu",
    "ex07_linear_system_cholesky",
    "ex08_linear_system_indefinite",
    "ex09_least_squares",
    "ex10_svd",
    "ex11_hermitian_eig",
    "ex12_generalized_hermitian_eig",
    "ex13_non_uniform_block_size",
    "ex14_scalapack_gemm",
]


def run(names, device) -> list:
    """Run the named examples on ``device``; returns those that failed."""
    t0 = time.time()
    failed = []
    for name in names:
        t = time.time()
        try:
            importlib.import_module(f"{__package__}.{name}").main(device)
            say(f"== {name} ok ({time.time() - t:.1f}s)")
        except SystemExit as e:
            failed.append(name)
            say(f"== {name} FAILED: {e}")
        except Exception as e:  # noqa: BLE001
            failed.append(name)
            say(f"== {name} ERROR: {type(e).__name__}: {e}")
    say(f"\n{len(names) - len(failed)}/{len(names)} examples passed "
        f"in {time.time() - t0:.1f}s")
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "slate_tpu_torch.examples.run_all")
    ap.add_argument("names", nargs="*", metavar="name")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(EXAMPLES))
    if unknown:
        ap.error(f"no such example: {', '.join(unknown)}")
    with session(["--device", args.device]) as device:
        failed = run(args.names or EXAMPLES, device)
    if failed:
        raise SystemExit(f"failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
