#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (slate_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n 20480] [--nb 128] [--nrhs 128]
                          [--trace]

Phases, each of which fails the run (nonzero exit) when it goes wrong:
  1. print the card's name and power limit (nvidia-smi), then build every
     kernel from slate_tpu_torch/csrc (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes, element by element with the tolerance stated
     beside each check, and time kernel, plain version and library call;
  3. the main path at full width: ``slate_tpu_torch.posv`` on an SPD
     matrix built as in examples/ex07 (A = G G^T + n I, G Gaussian from
     --seed), n = 20480, nb = 128, 128 right-hand sides, f32: the scaled
     residual and the error against an f64 solve, each under a bound that
     the same solve with its products in TF32 is shown to exceed; K2
     launched 2 n/nb - 1 times and K0 n/nb - 1 times; wall time and
     GFLOP/s; then a small posv held against the same solve on the CPU;
  4. the tile route: posv at n = 2048 with the fused panel's plan set to
     the library, so that potrf_tile runs K1 (n/nb launches);
  5. print the launch counts, the card line, the kernels line, and last
     the result line.
With --trace it also breaks one warm posv of phase 3 down by phase (host
clock) and by kernel (torch.profiler), with the device's idle share.

It imports nothing of JAX or slate_tpu, and exits nonzero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12    # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM, HBM3
EPS32 = torch.finfo(torch.float32).eps
# kernel vs plain version, element by element: |kernel - plain| <= ATOL +
# RTOL |plain|.  Both are f32 on inputs with cond <= ~5 and O(1) entries;
# only the order of the sums differs (K0: back substitution vs the series).
RTOL = ATOL = 1e-4
# posv at n = 20480 (ex07's A, cond <= 5): the scaled residual
# ||AX-B||_F / (||A||_F ||X||_F n eps_f32), with AX-B formed in f64, and
# the forward error max|X - X_f64| / max|X_f64|.  Both bounds sit well
# above what f32 products give and below what TF32 products give; every
# run checks the second half on a TF32 solve (PERF.md has the numbers).
RESIDUAL_BOUND = 1e-4
FORWARD_BOUND = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time for the work on the card: the larger of flops over the
    f32 peak and bytes over the memory rate, in ms, and which one it is."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def spd(n: int, gen: torch.Generator) -> torch.Tensor:
    """SPD with eigenvalues in [1, ~5]: G G^T / n + I."""
    g = torch.randn(n, n, generator=gen, device="cuda")
    return g @ g.T / n + torch.eye(n, device="cuda")


def within_tol(got, want) -> bool:
    """|got - want| <= ATOL + RTOL |want| for every element of every
    output."""
    return all(bool(((g - w).abs() <= ATOL + RTOL * w.abs()).all())
               for g, w in zip(got, want))


def tf32(fn):
    """``fn()`` with PyTorch's f32 matmuls in TF32: the control that the
    tolerances must reject."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def check(name, shape, got, want, reason, kernel_ms, plain_ms, library_ms,
          flops, nbytes, control=None) -> dict:
    """Hold each kernel output against the plain version's, element by
    element; raise on any miss, and, when ``control`` (the plain version
    with TF32 products) is given, if the control does not miss."""
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    b_ms, b_by = bound(flops, nbytes)
    row = {"check": name, "shape": shape, "max_abs_err": max(errs),
           "max_abs_err_by_output": errs, "rtol": RTOL, "atol": ATOL,
           "tol_reason": reason, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    if control is not None:
        row["tf32_control_max_abs_err"] = max(
            float((c - w).abs().max()) for c, w in zip(control, want))
    emit(row)
    if not within_tol(got, want):
        raise AssertionError(f"{name} {shape}: kernel and plain version "
                             f"differ beyond the tolerance (max {errs})")
    if control is not None and within_tol(control, want):
        raise AssertionError(f"{name} {shape}: the tolerance does not "
                             f"catch TF32 products")
    return row


def check_kernels(gen) -> dict:
    from slate_tpu_torch.internal.chol_kernels import (
        chol_panel_fused, chol_panel_plain, chol_tile, chol_tile_plain)
    from slate_tpu_torch.internal.tri_inv import (upper_tri_inv,
                                                  upper_tri_inv_plain)
    rows = {}
    for n in (32, 128):
        u = torch.linalg.cholesky(spd(n, gen)).mT.contiguous()
        eye = torch.eye(n, device="cuda")
        rows["upper_tri_inv"] = check(
            "upper_tri_inv", {"n": n}, [upper_tri_inv(u)],
            [upper_tri_inv_plain(u)],
            "back substitution vs the nilpotent series on U with cond <= ~3",
            time_ms(lambda: upper_tri_inv(u), 50),
            time_ms(lambda: upper_tri_inv_plain(u), 20),
            time_ms(lambda: torch.linalg.solve_triangular(u, eye, upper=True),
                    50),
            n ** 3 / 3, 4 * (n * (n + 1) // 2 + n * n))
    for n in (64, 128):
        a = spd(n, gen)
        rows["chol_tile"] = check(
            "chol_tile", {"n": n, "bw": 8}, [chol_tile(a, 8)],
            [chol_tile_plain(a, 8)],
            "the same column loop; only the order of the trailing sums "
            "differs, on A with cond <= ~5",
            time_ms(lambda: chol_tile(a, 8), 50),
            time_ms(lambda: chol_tile_plain(a, 8), 5),
            time_ms(lambda: torch.linalg.cholesky(a), 50),
            n ** 3 / 3, 4 * (n * (n + 1) // 2 + n * n))
    nb = 128
    # (M, K, transposed-left): the first and the middle panel of the main
    # path, with its strides (left a row-major view with a leading
    # dimension, lead a transposed one), then a ragged K with the other
    # stride pattern.  left and lead ~ N(0,1) / K^(1/4) make every entry of
    # left @ lead and its partial sums O(1), so a skipped K slice or TF32
    # products (checked: the control) land far above the tolerance.  lead
    # is drawn apart from left: on the main path it is a view of left's
    # first rows, and a diagonal entry there sums K squares up to
    # ~sqrt(K); one sequential f32 chain over that sum may be off by
    # ~sqrt(K) eps 100 ~ 6e-4 at K = 10240, beyond the tolerance though no
    # less exact than f32 allows.  The posv phase covers that aliasing.
    for m, k, left_t in ((20480, 0, False), (10240, 10240, False),
                         (1024, 1000, True)):
        base = torch.randn(m, nb, generator=gen, device="cuda")
        top = base[:nb] @ base[:nb].T / nb + torch.eye(nb, device="cuda")
        target = torch.cat([top, base[nb:]])
        scale = max(k, 1) ** -0.25
        left = (torch.randn(m, k + 8, generator=gen, device="cuda")
                * scale)[:, 8:]
        lead = (torch.randn(nb, k + 8, generator=gen, device="cuda")
                * scale)[:, 8:].T
        if left_t:
            left = left.T.contiguous().T
            lead = lead.contiguous()
        col = target + left @ lead
        got = chol_panel_fused(col, left, lead, 8)
        want = chol_panel_plain(col, left, lead, 8)

        def library():
            upd = col - left @ lead
            l00 = torch.linalg.cholesky(upd[:nb])
            return torch.linalg.solve_triangular(l00.mT, upd[nb:],
                                                 upper=True, left=False)

        row = check(
            "chol_panel_fused", {"M": m, "nb": nb, "K": k, "bw": 8,
                                 "left_transposed": left_t},
            list(got), list(want),
            "upd: K-long f32 sums with O(1) partial sums in another order; "
            "fac: as upper_tri_inv and chol_tile on a top block with "
            "cond <= ~5",
            time_ms(lambda: chol_panel_fused(col, left, lead, 8), 10),
            time_ms(lambda: chol_panel_plain(col, left, lead, 8), 3),
            time_ms(library, 10),
            2 * m * k * nb + nb ** 3 / 3 + (m - nb) * nb * nb,
            4 * (m * nb + m * k + k * nb + 2 * m * nb),
            control=(tf32(lambda: chol_panel_plain(col, left, lead, 8))
                     if k else None))
        if (m, k) == (10240, 10240):
            rows["chol_panel_fused"] = row
    return rows


def accuracy(a, x, b, x64) -> tuple[float, float]:
    """(scaled residual ||AX-B||_F / (||A||_F ||X||_F n eps_f32), with the
    residual formed in f64 so that its own rounding does not count, and
    forward error max|X - X_f64| / max|X_f64|)."""
    x = x.double()
    r = a.double() @ x - b.double()
    res = float(torch.linalg.norm(r) / (torch.linalg.norm(a.double())
                                        * torch.linalg.norm(x)
                                        * a.shape[0] * EPS32))
    fwd = float((x - x64).abs().max() / x64.abs().max())
    return res, fwd


def solve_f64(a, b) -> torch.Tensor:
    """The reference solution: the same system solved in f64."""
    l64 = torch.linalg.cholesky(a.double())
    return torch.cholesky_solve(b.double(), l64)


def run_posv(st, a, b, nb):
    """posv on device matrices; returns (X dense, wall seconds)."""
    A = st.SymmetricMatrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, X = st.posv(A, B)
    x = X.to_dense()
    torch.cuda.synchronize()
    return x, time.perf_counter() - t0


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _busy_seconds(events) -> float:
    """Length of the union of the kernels' device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-6


def trace_posv(st, a, b, nb) -> None:
    """Where one warm posv's time goes: host-clock phases, then the device
    time by kernel and the device's idle share under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from slate_tpu_torch.drivers.cholesky import _potrf_dense_blocked
    A = st.SymmetricMatrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    st.posv(A, B)                                    # warm-up
    full, t_dense = _timed(A.to_dense)
    lfac, t_factor = _timed(lambda: _potrf_dense_blocked(full, nb))
    L, t_tile = _timed(lambda: st.TriangularMatrix._from_view(
        st.Matrix(st.TileStorage.from_dense(lfac, nb, nb)), st.Uplo.Lower))
    del full, lfac
    Y, t_fwd = _timed(lambda: st.trsm("l", 1.0, L, B))
    _, t_bwd = _timed(lambda: st.trsm("l", 1.0, L.conj_transpose(), Y))
    _, t_posv = _timed(lambda: st.posv(A, B))
    emit({"phase": "trace_host_clock_s", "posv": t_posv, "to_dense": t_dense,
          "factor": t_factor, "tile_factor": t_tile, "trsm_forward": t_fwd,
          "trsm_backward": t_bwd})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(lambda: st.posv(A, B))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    busy = _busy_seconds(kernels) if kernels else None
    emit({"phase": "trace_profile", "wall_s": wall,
          "device_busy_s": busy if busy is not None else "not measured",
          "device_idle_share": (1 - busy / wall) if busy else "not measured",
          "kernel_ms": {k: v * 1e-3 for k, v in top}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=20480)
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--nrhs", type=int, default=128)
    ap.add_argument("--trace", action="store_true",
                    help="also break one warm posv down by phase and kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import slate_tpu_torch as st
    from slate_tpu_torch.internal.chol_kernels import CHOL_PANEL, CHOL_TILE
    from slate_tpu_torch.internal.kernels import build_all
    from slate_tpu_torch.internal.tri_inv import TRI_INV
    kernels = {"upper_tri_inv": TRI_INV, "chol_tile": CHOL_TILE,
               "chol_panel_fused": CHOL_PANEL}

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build_all(kernels.values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    for name, k in kernels.items():
        log = k.library_path().with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        emit({"phase": "ptxas", "kernel": name,
              "lines": [ln.strip() for ln in lines
                        if "registers" in ln or "spill" in ln]})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = check_kernels(gen)

    # ---- main path: posv at full width ----
    n, nb, nrhs = args.n, args.nb, args.nrhs
    g = torch.randn(n, n, generator=gen, device="cuda")
    a = g @ g.T
    del g
    a.diagonal().add_(n)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    for k in kernels.values():
        k.launches = 0
    x, wall = run_posv(st, a, b, nb)
    main_launches = {name: k.launches for name, k in kernels.items()}
    _, wall_repeat = run_posv(st, a, b, nb)
    x64 = solve_f64(a, b)
    res, fwd = accuracy(a, x, b, x64)
    flops = n ** 3 / 3 + 2 * n * n * nrhs
    emit({"phase": "posv", "n": n, "nb": nb, "nrhs": nrhs, "dtype": "float32",
          "wall_s": wall, "wall_s_repeat": wall_repeat,
          "gflops": flops / wall / 1e9,
          "gflops_repeat": flops / wall_repeat / 1e9,
          "scaled_residual": res, "residual_bound": RESIDUAL_BOUND,
          "forward_error_vs_f64": fwd, "forward_bound": FORWARD_BOUND,
          "launches": main_launches, "card": card})
    # the bounds have teeth: the same solve with its products in TF32
    # (the library route, whose update and panel solve are cuBLAS matmuls)
    with st.plan_override("potrf_panel", st.LIBRARY_PLAN):
        x_tf, _ = tf32(lambda: run_posv(st, a, b, nb))
    res_tf, fwd_tf = accuracy(a, x_tf, b, x64)
    emit({"phase": "posv_tf32_control", "n": n, "scaled_residual": res_tf,
          "forward_error_vs_f64": fwd_tf})
    if not (torch.isfinite(x).all() and x.shape == (n, nrhs)):
        raise AssertionError("posv: non-finite or misshapen solution")
    if not (res < RESIDUAL_BOUND and fwd < FORWARD_BOUND):
        raise AssertionError(f"posv: scaled residual {res} (bound "
                             f"{RESIDUAL_BOUND}), forward error {fwd} "
                             f"(bound {FORWARD_BOUND})")
    if not (res_tf > RESIDUAL_BOUND and fwd_tf > FORWARD_BOUND):
        raise AssertionError("the accuracy bounds do not catch TF32 "
                             f"products: residual {res_tf}, forward {fwd_tf}")
    want = {"chol_panel_fused": 2 * (n // nb) - 1,
            "upper_tri_inv": n // nb - 1, "chol_tile": 0}
    if main_launches != want:
        raise AssertionError(f"posv launches {main_launches} != {want}")
    del x, x64, x_tf
    if args.trace:
        trace_posv(st, a, b, nb)
    del a, b

    # ---- a small solve held against the same solve on the CPU ----
    ns = 384
    a_s = spd(ns, gen) * ns
    b_s = torch.randn(ns, 4, generator=gen, device="cuda")
    x_gpu, _ = run_posv(st, a_s, b_s, nb)
    _, X_cpu = st.posv(st.SymmetricMatrix.from_numpy(a_s.cpu(), nb,
                                                     device="cpu"),
                       st.Matrix.from_numpy(b_s.cpu(), nb, device="cpu"))
    diff = float((x_gpu.cpu() - X_cpu.to_dense()).abs().max()
                 / X_cpu.to_dense().abs().max())
    emit({"phase": "posv_vs_cpu", "n": ns, "rel_max_diff": diff,
          "tol": 1e-4})
    if not diff <= 1e-4:
        raise AssertionError(f"posv on the card vs the CPU: {diff} > 1e-4")

    # ---- the tile route: potrf_tile through K1 ----
    nt = 2048
    a_t = spd(nt, gen) * nt
    b_t = torch.randn(nt, nrhs, generator=gen, device="cuda")
    for k in kernels.values():
        k.launches = 0
    with st.plan_override("potrf_panel", st.LIBRARY_PLAN):
        x_t, wall_t = run_posv(st, a_t, b_t, nb)
    tile_launches = {name: k.launches for name, k in kernels.items()}
    res_t, fwd_t = accuracy(a_t, x_t, b_t, solve_f64(a_t, b_t))
    emit({"phase": "posv_tile_route", "n": nt, "nb": nb, "wall_s": wall_t,
          "scaled_residual": res_t, "forward_error_vs_f64": fwd_t,
          "launches": tile_launches})
    want_t = {"chol_panel_fused": 0, "upper_tri_inv": 0, "chol_tile": nt // nb}
    if (tile_launches != want_t or not res_t < RESIDUAL_BOUND
            or not fwd_t < FORWARD_BOUND):
        raise AssertionError(f"tile route: launches {tile_launches} (want "
                             f"{want_t}), residual {res_t}, forward {fwd_t}")

    # ---- the record ----
    emit({"launch_counts": {**main_launches,
                            "chol_tile": tile_launches["chol_tile"]}})
    replaces = {
        "upper_tri_inv": ("slate_tpu_torch/csrc/tri_inv.cu",
                          "slate_tpu/internal/pallas_tri.py:28"),
        "chol_tile": ("slate_tpu_torch/csrc/chol_tile.cu",
                      "slate_tpu/internal/pallas_chol.py:320"),
        "chol_panel_fused": ("slate_tpu_torch/csrc/chol_panel.cu",
                             "slate_tpu/internal/pallas_chol.py:180"),
    }
    line = []
    for name, (source, ref) in replaces.items():
        r = rows[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": ref,
                     "launches": (tile_launches[name] if name == "chol_tile"
                                  else main_launches[name]),
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    print(card, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
