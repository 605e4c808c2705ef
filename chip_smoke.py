#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (slate_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n 20480] [--nb 128] [--nrhs 128]
                          [--trace]

Phases, each of which fails the run (nonzero exit) when it goes wrong:
  1. print the card's name and power limit (nvidia-smi), then build every
     kernel from slate_tpu_torch/csrc (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes, with the tolerance stated beside each check (K4:
     equal indices), and time kernel, plain version and library call (the
     Cholesky factor of K1, K2 and K6's compositions by cholesky_ex, which
     does not sync the host, cholesky's time beside it); K4 (lu_select) at
     round-1 chunks of 4096 and 5120 rows, a 256-row reduction round, a
     chunk with dead rows and a 512-row chunk whose largest |v| in column 0
     lies in rows 3 and 300 (the two CTAs of its cluster; row 3 wins), each
     with a lu_select_plan line (the thread-block cluster a chunk takes, a
     CTA's rows and shared memory, the clusters resident, and the
     one-block kernel's time beside the new one); K3 (lu_panel_fused) on
     CALU-permuted panels at W = 20480, 10240, 1024 and 128, each launched
     twice and compared bit for bit, with a lu_panel_plan line (its factor
     launch's and its strips launch's device time apart, the strips'
     staging, the slab-loop kernel's time beside the new one), and on tiles
     with a planted exact-zero pivot at j = 0, 5 and 37, bw = 4 and 8 (the
     health read's info and nonfinite equal to the plain version's); K1
     (chol_tile) at n = 32, 64, 96 and 128, and on an indefinite tile (the
     first bad pivot the plain version's, every later one non-finite); K5
     (qr_panel) at [8192, 128] and [4224, 128] (the first and last panels
     of the gels below), [1000, 128], [512, 40], a [512, 48] panel with
     a zero column and alpha = -0.0, and the thread-block cluster's edges
     [128, 128], [129, 128] and [8191, 128], also against torch.geqrf's
     panel and build_t of its taus, and each shape timed on
     householder_panel_blocked (the CholQR2 route of panels past K5's
     2^20-element cap); every K5 and K8 row also names the cluster size
     its launch took and repeats the launch, bit for bit; each K8 row
     names the waves its clusters ran in and runs one problem alone,
     bit-equal to its place in the batch; K2 (chol_panel_fused) also at
     the posv path's late panels [M, K] = [1024, 19456] (few row tiles,
     deep K: the K loop split over a thread-block cluster) and [128,
     20352] (the last panel), every K2 shape launched twice and compared
     bit for bit, with the split and staging its update launch took
     (cp.async on the main path's strides, plain loads on a transposed
     left) and its own launches' device time (update, factor, solve;
     torch.profiler) apart from K0's; K0 also on U = triu of a partially
     pivoted LU of a Gaussian panel, within 1e-5 of the f64 inverse;
  3. the Cholesky path at full width: ``slate_tpu_torch.posv`` on an SPD
     matrix built as in examples/ex07 (A = G G^T + n I, G Gaussian from
     --seed), n = 20480, nb = 128, 128 right-hand sides, f32: the scaled
     residual and the error against an f64 solve, each under a bound that
     the same solve with its products in TF32 is shown to exceed; K2
     launched 3 n/nb - 1 times (update, factor and solve a panel, the
     last panel no solve) and K0 n/nb - 1 times; wall time and GFLOP/s;
     then a small posv held against the same solve on the CPU; then
     posv_hold, the same posv under Option.HoldLocalWorkspace (its
     Cholesky attempt captured as one CUDA graph and replayed): cold
     (capture) and warm walls beside eager posv's, X and the health
     bit-equal, K2 and K0 launches per replay as eager (torch.profiler's
     count beside);
  4. the tile route: posv at n = 2048 with the fused panel's plan set to
     the library, so that potrf_tile runs K1 (n/nb launches);
  5. the LU path at full width: ``slate_tpu_torch.gesv`` with MethodLU.CALU
     on A = Q of the QR of a Gaussian (cond 1, a real pivot choice in every
     column), the same n, nb and right-hand sides: residual and forward
     error under bounds that its TF32 control exceeds, and K4 and K3
     launched as often as the tournament's control flow gives for these
     shapes (K3 forms U^-1 itself: no K0 launch); then the NoPiv route (K3 only) on a diagonally dominant
     matrix, the library route (gesv's default method, PartialPiv, with
     the fallback ladder off: no hand kernel), and a small CALU gesv held
     against the CPU;
  6. the QR path at full width: ``slate_tpu_torch.gels`` with default
     options at m = 8192, n = 4096 (m < 3n: Householder QR), 128
     right-hand sides, nb = 128, f32, A Gaussian and B = A X0 + a residual
     orthogonal to range(A): the scaled normal-equations residual and the
     error against an f64 lstsq, each under a bound that the same solve
     with TF32 products exceeds; K5 launched once a panel (32), K0-K4
     never; wall time and GFLOP/s (every count and bound from the flop
     model, slate_tpu_torch/obs/flops.py: gels' nominal count);
  7. BASELINE.md config 4 cut to f32 and one card, gels at 200000 x 1024
     (a ragged last tile row): the default route, CholQR, launches K2 and
     K0 as potrf at n = 1024 does (23 and 7); MethodGels.QR forced takes
     no hand kernel (every panel is past K5's cap); accuracy (bounds that
     a TF32 solve exceeds) and walls of both; then small QR checks against the CPU (gels with m < n, cholqr,
     unmqr in all four (side, op) pairs, qr_multiply's ||Q^T Q - I||);
  8. the serving path: K6 (chol_panel_batched) and K7 (lu_panel_batched)
     at B = 8, M = 4096, nb = 128, k = 0 and 16 (each launched twice bit
     for bit, each problem alone bit-equal to its slot in the batch, and a
     chol_panel_batched_plan or lu_panel_batched_plan line: split, waves
     and each of its three launches' device time), and K8 (qr_panel_batched)
     at [8, 4096, 128] and [8, 1024, 128] and, with filler slots first
     and last, [8, 128, 128] and [12, 4096, 128] (more clusters than the
     card holds at once), each in f32 and bf16 storage, against their
     plain versions (bf16: ATOL + 2^-7 |plain|) with dead tiles and
     filler slots bit-equal to the input; then a seeded
     120-request mixed stream through ``slate_tpu_torch.serve.Server``
     (solve and chol_solve at n = 96 .. 4000, least squares at m = 2n,
     16 right-hand sides, five planted failures) on the ragged route cold
     and warm (K6, K7, K8 and the safe rungs' K5 launched as replayed from
     the batches the server ran; the planted requests escalated, the
     zero-column one quarantined; every healthy result under a residual
     bound that the same stream with TF32 products exceeds), on the
     per-problem route (agreeing with the ragged one), with the bf16 rung
     (K6-K8 on bf16 storage; escalated results bit-equal to the f32
     stream's), and a small stream held against the CPU route;
  9. the serving survival layer on the same stream: serve_graph (the
     stream through the captured cache cold and warm, in turns with the
     same stream through eager callables; every group's replay against
     eager make_batched, bit for bit; captures, capture time, reserved
     memory; K6-K8 launches as each capture's tally times its replays,
     and torch.profiler's count and idle share), serve_loop
     (Server.start() with 4 submitter threads, twice, no capture, no
     ticket lost), serve_pool_drill (two members on the card: a killed,
     a lying and a wedged member fail over bit-equal, quarantine, canary
     readmission), serve_watchdog (a stalled capture fails its tickets
     with reason watchdog) and serve_retune (the fitted ladder, its
     routes, a cache-hit first flush);
 10. robustness on those paths (its own generators, --seed + 8 and
     --seed + 9): abft_posv (posv at n = 20480 with Option.Abft, clean
     beside Abft off as warm wall and device busy, the largest checksum
     residual over its threshold, a transient bitflip in K2's first
     diagonal factor located at tile (0, 0) and repaired, a double strike
     refused and then solved by the retry_same rung); abft_gesv (CALU at
     n = 20480 the same way, K4 and K3 under lu_panel_check, the strike in
     the first panel's row tile 120; the double strike refused, CALU
     having no rung below it; NoPiv at n = 8192 clean, with a strike at
     tile (40, 0), and with a double strike that retry_same saves);
     speculate_gesv (the certified RBT rung, K3 at the padded width, on
     the orthogonal A and on a diagonally dominant A, each beside CALU's
     wall, and a post_rbt bitflip that escalates to CALU);
     speculate_posv_bf16 (the bf16 rung at n = 20480 beside f32 posv's
     wall, and a cond 1e6 SPD at n = 4096 that escalates to f32);
     speculate_gels (the certified CholQR2 rung at config 4, the bf16 QR
     rung, K5 on the rounded operand, at 8192 x 4096, each beside its
     default route); abft_serving (the 120-request stream under Abft,
     chol_solve on K6 with the in-batch rungs and the rest per problem,
     beside the plain stream; one transient strike in a batch of the
     stream's chol_solve requests at n = 1900, repaired, its neighbours'
     bits untouched).  Every count, GFLOP/s and bound above comes from
     the flop model (slate_tpu_torch/obs/flops.py);
 11. print the launch counts, the card line, the kernels line, and last
     the result line.  A kernel's launch count adds its wrapper's eager
     launches and those its CUDA graphs' replays ran.
With --trace it also breaks one warm posv, one warm CALU gesv, one warm
QR gels and one warm serving stream down by phase (host clock) and by
kernel (torch.profiler), with the device's idle share, and the gesv's K4
device time into its round-1 launches and its reduction rounds', K3's
into its factor and strips launches, and the stream's K6 and K7 device
time into their update, factor and solve launches, and the kernel
breakdown of one Abft posv and one Abft CALU gesv.

The Cholesky and LU phases draw their matrices from one generator seeded
with --seed, the QR phases (K5's check included) from their own, seeded
with --seed + 1, the serving phases from a third, --seed + 2, and the
K5/K8 cluster edge shapes from a fourth, --seed + 3, K2's late panels
and K0's pivoted U from a fifth, --seed + 4, and K1's tiles at n = 32 and
96 and its indefinite tile from a sixth, --seed + 5, and K4's tie chunk
from a seventh, --seed + 6, and K3's panels at W = 10240 and 128 and its
zero-pivot tiles from an eighth, --seed + 7, the robustness phases' square
matrices from a ninth, --seed + 8, and their least-squares problems from a
tenth, --seed + 9, so that adding to one slice moves no other's matrices;
the survival phases and posv_hold draw nothing of their own (they reuse
the stream and posv's matrix).
It imports nothing of JAX or slate_tpu, and exits nonzero without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
EPS32 = torch.finfo(torch.float32).eps
# kernel vs plain version, element by element: |kernel - plain| <= ATOL +
# RTOL |plain|.  Both are f32 with the same steps; only the order of the
# sums differs, on inputs with O(1) entries (cond <= ~5 for K0-K2; K3's
# pivoted top tile has cond ~100 and |L| <= ~3).  K4 is held to equal
# indices instead.
RTOL = ATOL = 1e-4
# posv at n = 20480 (ex07's A, cond <= 5): the scaled residual
# ||AX-B||_F / (||A||_F ||X||_F n eps_f32), with AX-B formed in f64, and
# the forward error max|X - X_f64| / max|X_f64|.  Both bounds sit well
# above what f32 products give and below what TF32 products give; every
# run checks the second half on a TF32 solve (PERF.md has the numbers).
RESIDUAL_BOUND = 1e-4
FORWARD_BOUND = 1e-4
# gesv at n = 20480 (A orthogonal): the same two measures.  Pivoted LU of
# an orthogonal matrix grows its pivots by a few hundred, so f32 lands
# near 1e-3 and 5e-4 (as LAPACK's sgesv does on such matrices), TF32 near
# 0.8 and 0.4; the bounds sit ~10x above the first and ~80x below the
# second, and every run checks both halves (PERF.md has the numbers).
GESV_RESIDUAL_BOUND = 1e-2
GESV_FORWARD_BOUND = 5e-3
# gels at 8192 x 4096 (A Gaussian, cond ~6, a residual orthogonal to
# range(A)): the scaled normal-equations residual ||A^T (B - AX)||_F /
# (||A||_F (||A||_F ||X||_F + ||B||_F) n eps_f32), formed in f64, and the
# forward error against an f64 least-squares solve.  f32 gives ~3e-7 and
# ~1e-6, TF32 ~3e-4 and ~1e-3; the bounds sit ~30x from each, and every
# run checks both halves (PERF.md has the numbers).
GELS_SHAPE = (8192, 4096)       # m < 3n: Householder QR, 32 K5 panels
GELS_RESIDUAL_BOUND = 1e-5
GELS_FORWARD_BOUND = 3e-5
# config 4 (200000 x 1024, cond ~1.2): CholQR's semi-normal equations give
# ~2e-5 and ~4e-6, the QR route ~3e-6 and ~7e-7, TF32 ~5e-3 and ~1e-3 on
# either route; the bounds sit 10-25x from each.
CFG4_SHAPE = (200000, 1024)     # BASELINE.md config 4, the last tile ragged
CFG4_RESIDUAL_BOUND = 2e-4
CFG4_FORWARD_BOUND = 1e-4
# kernels on bf16 storage vs their plain versions: both form the same f32
# values up to the order of their sums, then each store rounds to bf16's 8
# significant bits, so they may land one bf16 ulp (2^-7 relative) apart:
# |kernel - plain| <= ATOL + BF16_RTOL |plain|
BF16_RTOL = 2.0 ** -7
# the serving stream (its own generator, --seed + 2): 40 requests an op,
# 16 right-hand sides; solve and chol_solve at these n (buckets 128 to
# 4096), least squares at m = 2n (the largest bucket (4096, 2048))
SERVE_SOLVE_NS = (96, 200, 450, 900, 1900, 4000)
SERVE_LSQ_NS = (96, 200, 450, 900, 1900)
SERVE_PER_OP = 40
SERVE_NRHS = 16
# the worst healthy result's scaled residual (solve, chol_solve) and
# scaled normal-equations residual (least squares), as serve_residual
# forms them in f64; PERF.md has the f32 and TF32 values they sit between
SERVE_RESIDUAL_BOUND = 0.1
SERVE_LSQ_BOUND = 1e-2
# the per-problem route against the ragged route, max |x_pp - x_ragged| /
# max |x_ragged| per healthy request: both are backward-stable f32 solves
# of problems with cond <= ~10 (CholQR's semi-normal equations square it)
SERVE_ROUTE_TOL = 1e-3
# K5's and K8's times with one block a panel, before a panel's rows were
# split over a thread-block cluster, at the shapes they were measured at on
# an H100 80GB HBM3 at 700 W (PERF.md, the K5 and K8 rows), so that each
# cluster line shows the old time beside the new (key pr5_ms); the kernels
# line carries only what the run measured
ONE_BLOCK_MS = {("qr_panel", 8192, 128, "float32"): 21.59,
                ("qr_panel_batched", 8, 4096, "float32"): 11.03,
                ("qr_panel_batched", 8, 4096, "bfloat16"): 11.40,
                ("qr_panel_batched", 8, 1024, "float32"): 3.036}
# K4's times with one block a chunk (its design before the cluster split),
# keyed (G, W, nrows, tie chunk), as this script measured that kernel on an
# H100 80GB HBM3 at 700 W (PERF.md, the K4 row), so that each
# lu_select_plan line shows the old time beside the new (key pr8_ms); the
# kernels line carries only what the run measured
ONE_BLOCK_SELECT_MS = {(4, 4096, None, False): 2.568,
                       (4, 5120, None, False): 3.187,
                       (2, 256, None, False): 0.2931,
                       (2, 512, 300, False): 0.3475}

# K3's times before its redesign (the PR 9 tree: the slab loop on one block
# of 256 threads, K0's launch between K3's two, the rows below in 32-row
# strips), keyed by W at nb = 128, bw = 8, as this script measured that
# tree on an H100 80GB HBM3 at 700 W (PERF.md, the K3 row; W = 10240 and
# 128 were not measured), so that each lu_panel_plan line shows the old
# time beside the new (key pr9_ms); the kernels line carries only what the
# run measured
SLAB_LOOP_K3_MS = {20480: 0.3021, 1024: 0.2805}


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


def device_ms(fn, reps: int = 5, per_launch: bool = False) -> dict:
    """Mean device time per call of ``fn()`` of each kernel it launches,
    by name, under torch.profiler (after one warm-up call); with
    ``per_launch``, the mean over the launches the profiler recorded, for
    kernels that ``fn`` launches once a call (a trace that drops a record
    then still gives each launch's time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total: dict[str, float] = {}
    count: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
            count[e.name] = count.get(e.name, 0) + 1
    return {name: 1e-3 * t / (count[name] if per_launch else reps)
            for name, t in total.items()}


def step_launch_times(name: str, tag: str, fn, reps: int = 5) -> dict:
    """K6's or K7's launches (update, factor, solve; the kernels named
    ``{name}_{launch}``) per call of its wrapper ``fn``: device ms by
    launch, from torch.profiler, under the keys ``{tag}_own_ms`` and
    ``{tag}_launch_ms``."""
    by_name = device_ms(fn, reps, per_launch=True)
    parts = {part: sum(v for k, v in by_name.items()
                       if f"{name}_{part}" in k)
             for part in ("update", "factor", "solve")}
    return {f"{tag}_own_ms": sum(parts.values()), f"{tag}_launch_ms": parts}


def k2_launch_times(fn, reps: int = 5) -> dict:
    """K2's own launches (update, factor, solve) and K0's, per call of a
    chol_panel_fused ``fn``: device ms by launch, from torch.profiler."""
    by_name = device_ms(fn, reps, per_launch=True)

    def pick(tag):
        return sum(v for k, v in by_name.items() if tag in k)
    parts = {"update": pick("chol_panel_update_kernel"),
             "factor": pick("chol_panel_factor_kernel"),
             "solve": pick("chol_panel_solve_kernel")}
    return {"k2_own_ms": sum(parts.values()), "k2_launch_ms": parts,
            "k0_ms": pick("upper_tri_inv_kernel")}


def k3_launch_times(fn, reps: int = 5) -> dict:
    """K3's own launches (the factor with U^-1, the rows below) per call
    of a lu_panel_fused ``fn``: device ms by launch, from torch.profiler."""
    by_name = device_ms(fn, reps, per_launch=True)
    parts = {part: sum(v for k, v in by_name.items()
                       if f"lu_panel_{part}_kernel" in k)
             for part in ("factor", "below")}
    return {"k3_own_ms": sum(parts.values()), "k3_launch_ms": parts}


def card_rates() -> tuple[float, float]:
    """(f32 peak FLOP/s, memory rate B/s) of the card, from the flop
    model's table (slate_tpu_torch/obs/flops.py), which holds the H100
    alone: another card is measured against the H100's rates."""
    from slate_tpu_torch.obs import flops as fl
    peak, bw = fl.peak("float32"), fl.chip_bandwidth()[0]
    if peak is None or bw is None:
        peak = dict(fl.PEAK_TABLE)["h100"]["float32"]
        bw = dict(fl.BANDWIDTH_TABLE)["h100"]
    return peak, bw


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time for the work on the card: the larger of flops over the
    f32 peak and bytes over the memory rate (card_rates), in ms, and which
    one it is."""
    peak, bw = card_rates()
    t_ops, t_bytes = flops / peak, nbytes / bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def op_flops(op: str, *shapes) -> float:
    """The flop model's count (slate_tpu_torch.obs.flops.op_flops) for one
    call of ``op`` on argument ``shapes``."""
    from slate_tpu_torch.obs import flops as fl
    return fl.op_flops(op, list(shapes))


def panel_flops(m: int, k: int, nb: int, factor: str) -> float:
    """A left-looking panel step of m rows after k factored columns, from
    the flop model: the update (gemm m x k x nb), the diagonal tile's
    factor (``factor``: "potrf" or "getrf", nb x nb) and the solve of the
    m - nb rows below it (trsm against the nb x nb tile)."""
    return (op_flops("gemm", (m, k), (k, nb)) + op_flops(factor, (nb, nb))
            + op_flops("trsm", (nb, nb), (nb, m - nb)))


def spd(n: int, gen: torch.Generator) -> torch.Tensor:
    """SPD with eigenvalues in [1, ~5]: G G^T / n + I."""
    g = torch.randn(n, n, generator=gen, device="cuda")
    return g @ g.T / n + torch.eye(n, device="cuda")


def within_tol(got, want, rtol: float = RTOL) -> bool:
    """|got - want| <= ATOL + rtol |want| for every element of every
    output (compared in f32, so bf16 outputs too)."""
    return all(bool(((g.float() - w.float()).abs()
                     <= ATOL + rtol * w.float().abs()).all())
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
          flops, nbytes, control=None, witness=None,
          rtol: float = RTOL) -> dict:
    """Hold each kernel output against the plain version's, element by
    element, within ATOL + rtol |plain|; raise on any miss, and, when
    ``control`` (the plain version with TF32 products) is given, if the
    control does not miss.  A ``witness`` (the library call's outputs) is
    held against the kernel's with the same tolerance."""
    errs = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)]
    b_ms, b_by = bound(flops, nbytes)
    row = {"check": name, "shape": shape, "max_abs_err": max(errs),
           "max_abs_err_by_output": errs, "rtol": rtol, "atol": ATOL,
           "tol_reason": reason, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    if control is not None:
        row["tf32_control_max_abs_err"] = max(
            float((c - w).abs().max()) for c, w in zip(control, want))
    if witness is not None:
        row["library_vs_kernel_max_abs_err"] = max(
            float((v - g).abs().max()) for v, g in zip(witness, got))
    emit(row)
    if not within_tol(got, want, rtol):
        raise AssertionError(f"{name} {shape}: kernel and plain version "
                             f"differ beyond the tolerance (max {errs})")
    if witness is not None and not within_tol(witness, got, rtol):
        raise AssertionError(f"{name} {shape}: the library call and the "
                             f"kernel differ beyond the tolerance")
    if control is not None and within_tol(control, want, rtol):
        raise AssertionError(f"{name} {shape}: the tolerance does not "
                             f"catch TF32 products")
    return row


def check_kernels(gen, k1_gen) -> dict:
    """K0 at n = 32 and 128; K1 at n = 32, 64, 96 and 128 and on an
    indefinite tile; K2 at the main path's panels.  K1's tiles at n = 64
    and 128 draw from ``gen`` as they always did, the others from
    ``k1_gen`` (--seed + 5), so that the later phases keep their
    matrices."""
    from slate_tpu_torch.internal.chol_kernels import (chol_tile,
                                                       chol_tile_plain)
    from slate_tpu_torch.internal.tri_inv import (upper_tri_inv,
                                                  upper_tri_inv_plain)
    rows = {}
    for n in (32, 128):
        u = torch.linalg.cholesky(spd(n, gen)).mT.contiguous()
        eye = torch.eye(n, device="cuda")
        rows["upper_tri_inv"] = check(
            "upper_tri_inv", {"n": n}, [upper_tri_inv(u)],
            [upper_tri_inv_plain(u)],
            "blocked doubling in both, sums in another order, on U with "
            "cond <= ~3",
            time_ms(lambda: upper_tri_inv(u), 50),
            time_ms(lambda: upper_tri_inv_plain(u), 20),
            time_ms(lambda: torch.linalg.solve_triangular(u, eye, upper=True),
                    50),
            op_flops("trtri", (n, n)), 4 * (n * (n + 1) // 2 + n * n))
    for n in (32, 64, 96, 128):
        a = spd(n, gen if n in (64, 128) else k1_gen)
        rows["chol_tile"] = check(
            "chol_tile", {"n": n, "bw": 8}, [chol_tile(a, 8)],
            [chol_tile_plain(a, 8)],
            "the kernel's 32-column blocks against the reference's bw = 8 "
            "slabs: the same factor, f32 sums in another order, on A with "
            "cond <= ~5",
            time_ms(lambda: chol_tile(a, 8), 50),
            time_ms(lambda: chol_tile_plain(a, 8), 5),
            time_ms(lambda: torch.linalg.cholesky_ex(a), 50),
            op_flops("potrf", (n, n)), 4 * (n * (n + 1) // 2 + n * n))
        # the old yardstick: cholesky syncs the host on its info check
        rows["chol_tile"]["library_cholesky_ms"] = time_ms(
            lambda: torch.linalg.cholesky(a), 50)
        emit({"phase": "chol_tile_library", "n": n,
              "kernel_ms": rows["chol_tile"]["kernel_ms"],
              "cholesky_ex_ms": rows["chol_tile"]["library_ms"],
              "cholesky_ms": rows["chol_tile"]["library_cholesky_ms"]})
    check_first_bad_pivot(k1_gen)
    # (M, K, transposed-left): the first and the middle panel of the main
    # path, with its strides (left a row-major view with a leading
    # dimension, lead a transposed one), then a ragged K with the other
    # stride pattern.
    for m, k, left_t in ((20480, 0, False), (10240, 10240, False),
                         (1024, 1000, True)):
        row = check_chol_panel(gen, m, k, left_t)
        if (m, k) == (10240, 10240):
            rows["chol_panel_fused"] = row
    return rows


def first_bad(l: torch.Tensor) -> int:
    """The first diagonal entry of a factor that is non-finite or not
    positive (the health read's info), or -1."""
    d = torch.diagonal(l)
    bad = (~(torch.isfinite(d) & (d > 0))).nonzero()
    return int(bad[0]) if len(bad) else -1


def check_first_bad_pivot(gen, n: int = 128, at: int = 67) -> None:
    """K1 on an indefinite tile whose pivot at column ``at`` is ~ -3 or
    below: the first bad diagonal entry is ``at`` in the kernel and in the
    plain version, and every later one is non-finite."""
    from slate_tpu_torch.internal.chol_kernels import (chol_tile,
                                                       chol_tile_plain)
    a = spd(n, gen)
    a[at, at] -= 8.0
    got, want = chol_tile(a, 8), chol_tile_plain(a, 8)
    firsts = [first_bad(got), first_bad(want)]
    poisoned = not bool(torch.isfinite(torch.diagonal(got)[at + 1:]).any())
    emit({"phase": "chol_tile_indefinite", "n": n, "planted": at,
          "first_bad_kernel": firsts[0], "first_bad_plain": firsts[1],
          "later_diagonal_non_finite": poisoned})
    if firsts != [at, at] or not poisoned:
        raise AssertionError(f"chol_tile on an indefinite tile: first bad "
                             f"pivot {firsts} (planted {at}), later "
                             f"non-finite {poisoned}")


def chol_panel_operands(gen, m: int, k: int, left_t: bool, nb: int = 128):
    """(col, left, lead) of one K2 panel.  left and lead ~ N(0,1) / K^(1/4)
    make every entry of left @ lead and its partial sums O(1), so a skipped
    K slice or TF32 products (checked: the control) land far above the
    tolerance.  lead is drawn apart from left: on the main path it is a
    view of left's first rows, and a diagonal entry there sums K squares up
    to ~sqrt(K); one sequential f32 chain over that sum may be off by
    ~sqrt(K) eps 100 ~ 6e-4 at K = 10240, beyond the tolerance though no
    less exact than f32 allows.  The posv phase covers that aliasing."""
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
    return target + left @ lead, left, lead


def check_chol_panel(gen, m: int, k: int, left_t: bool,
                     nb: int = 128) -> dict:
    """K2 at [M, K] against its plain version (and its TF32 control when
    K > 0), launched twice and compared bit for bit; the row's kernel_ms is
    K2's own launches' device time, K0's apart."""
    from slate_tpu_torch.internal.chol_kernels import (
        chol_panel_fused, chol_panel_plain, panel_plan)
    col, left, lead = chol_panel_operands(gen, m, k, left_t, nb)
    got = chol_panel_fused(col, left, lead, 8)
    repeatable = all(torch.equal(g, h) for g, h in
                     zip(got, chol_panel_fused(col, left, lead, 8)))
    want = chol_panel_plain(col, left, lead, 8)

    def library(cholesky=lambda t: torch.linalg.cholesky_ex(t)[0]):
        upd = col - left @ lead
        l00 = cholesky(upd[:nb])
        return torch.linalg.solve_triangular(l00.mT, upd[nb:],
                                             upper=True, left=False)

    times = k2_launch_times(lambda: chol_panel_fused(col, left, lead, 8))
    plan = panel_plan(col, left, lead)
    fast = "loads" if left_t else "cp.async"
    if k and not plan["left"] == plan["lead"] == fast:
        raise AssertionError(f"chol_panel_fused [{m}, {k}]: staging {plan} "
                             f"on left_transposed = {left_t}")
    row = check(
        "chol_panel_fused", {"M": m, "nb": nb, "K": k, "bw": 8,
                             "left_transposed": left_t},
        list(got), list(want),
        "upd: K-long f32 sums with O(1) partial sums in another order; "
        "fac: as upper_tri_inv and chol_tile on a top block with "
        "cond <= ~5",
        times["k2_own_ms"],
        time_ms(lambda: chol_panel_plain(col, left, lead, 8), 3),
        time_ms(library, 10),
        panel_flops(m, k, nb, "potrf"),
        4 * (m * nb + m * k + k * nb + 2 * m * nb),
        control=(tf32(lambda: chol_panel_plain(col, left, lead, 8))
                 if k else None))
    row.update(times, plan=plan, bitwise_repeatable=repeatable,
               wrapper_ms=time_ms(lambda: chol_panel_fused(col, left, lead,
                                                           8), 10),
               library_device_ms=sum(device_ms(library).values()),
               library_cholesky_ms=time_ms(
                   lambda: library(torch.linalg.cholesky), 10))
    emit({"phase": "chol_panel_plan", "M": m, "K": k, **plan,
          "bitwise_repeatable": repeatable, **times,
          "wrapper_ms": row["wrapper_ms"], "library_ms": row["library_ms"],
          "library_cholesky_ms": row["library_cholesky_ms"],
          "library_device_ms": row["library_device_ms"]})
    if not repeatable:
        raise AssertionError(f"chol_panel_fused [{m}, {k}]: two launches on "
                             f"the same input differ")
    return row


def check_k2_k0_edges(gen) -> None:
    """K2 at the posv path's late panels: few row tiles and a deep K (the
    K loop split over a cluster), and the last panel (M = nb); K0 on the U
    of a partially pivoted LU of a Gaussian panel (cond ~100), within 1e-5
    of the f64 inverse relative to its largest entry, and against its
    plain version.  Draws from ``gen`` alone (--seed + 4)."""
    from slate_tpu_torch.internal.tri_inv import (upper_tri_inv,
                                                  upper_tri_inv_plain)
    for m, k in ((1024, 19456), (128, 20352)):
        check_chol_panel(gen, m, k, False)
    g = torch.randn(4096, 128, generator=gen, device="cuda")
    u = torch.triu(torch.linalg.lu_factor(g)[0][:128]).contiguous()
    x64 = torch.linalg.inv(u.double())
    got = upper_tri_inv(u)
    rel = float((got.double() - x64).abs().max() / x64.abs().max())
    emit({"phase": "upper_tri_inv_pivoted_u", "n": 128,
          "rel_err_vs_f64": rel, "tol": 1e-5,
          "cond": float(torch.linalg.cond(u.double()))})
    if not rel < 1e-5:
        raise AssertionError(f"upper_tri_inv on a pivoted U: {rel} from the "
                             f"f64 inverse (tolerance 1e-5)")
    check("upper_tri_inv", {"n": 128, "pivoted_u": True}, [got],
          [upper_tri_inv_plain(u)],
          "blocked doubling in both, sums in another order; pivoted U "
          "(cond ~100), so RTOL is taken relative to |U^-1|",
          time_ms(lambda: upper_tri_inv(u), 50),
          time_ms(lambda: upper_tri_inv_plain(u), 20),
          time_ms(lambda: torch.linalg.solve_triangular(
              u, torch.eye(128, device="cuda"), upper=True), 50),
          op_flops("trtri", (128, 128)), 4 * (128 * 129 // 2 + 128 * 128))


def check_lu_kernels(gen, tie_gen, k3_gen) -> dict:
    """K3 on CALU-permuted Gaussian panels at W = 20480 (the main path's
    first panel), 10240, 1024 and 128, also held against the library's
    unpivoted LU, each launched twice and compared bit for bit, with an
    ``lu_panel_plan`` line (its factor and strips launches' device time,
    the strips' staging, the redesign's predecessor's time), then on tiles
    with a planted exact-zero pivot (the health read's info and nonfinite
    equal to the plain version's); K4 on main-path round-1 batches (4096
    and 5120 rows), a tree round, a chunk with dead rows, and (from
    ``tie_gen``) a 512-row chunk whose column 0 has its largest |v| in rows
    3 and 300, in the two CTAs of its cluster; each K4 shape also prints a
    ``lu_select_plan`` line (the cluster, a CTA's rows and shared memory,
    the clusters resident, the time beside the one-block kernel's).  K3's
    panels at W = 20480 and 1024 draw from ``gen`` as they always did, the
    others and the zero-pivot tiles from ``k3_gen`` (--seed + 7)."""
    from slate_tpu_torch.internal.getrf import panel_lu, tournament_perm
    from slate_tpu_torch.internal.lu_kernels import (
        lu_panel_fused, lu_panel_plain, lu_select, lu_select_plain,
        panel_plan, select_plan)
    rows = {}
    nb = 128
    for w in (20480, 10240, 1024, 128):
        # the main path's block rows for a panel of w rows (mpt = 4); the
        # single tile (W = nb) is the one the tournament puts on top of a
        # 4096-row panel
        h = w if w > nb else 4096
        g = torch.randn(h, nb, generator=gen if w in (20480, 1024)
                        else k3_gen, device="cuda")
        x = g[tournament_perm(g, max(nb, -(-h // (4 * nb)) * nb))][:w]

        def library():
            return torch.linalg.lu_factor_ex(x, pivot=False)[0]
        got = lu_panel_fused(x, 8)
        repeatable = bool(torch.equal(got, lu_panel_fused(x, 8)))
        times = k3_launch_times(lambda: lu_panel_fused(x, 8))
        row = check(
            "lu_panel_fused", {"W": w, "nb": nb, "bw": 8},
            [got], [lu_panel_plain(x, 8)],
            "the kernel's 32-column blocks against the reference's bw = 8 "
            "slabs, U^-1 by K0's doubling in both, f32 sums in another "
            "order; pivoted top tile (cond ~100), |L| <= ~3; the library's "
            "unpivoted LU solves for L where both multiply by U^-1",
            time_ms(lambda: lu_panel_fused(x, 8), 10),
            time_ms(lambda: lu_panel_plain(x, 8), 3),
            time_ms(library, 10),
            # W nb^2 - nb^3/3: the tile's LU, then L21 = A21 U^-1
            panel_flops(w, 0, nb, "getrf"),
            4 * 2 * w * nb,
            control=[tf32(lambda: lu_panel_plain(x, 8))] if w > nb else None,
            witness=[library()])
        plan = panel_plan(x)
        row.update(times, plan=plan, bitwise_repeatable=repeatable)
        emit({"phase": "lu_panel_plan", "W": w, "nb": nb, **plan, **times,
              "bitwise_repeatable": repeatable,
              "kernel_ms": row["kernel_ms"],
              "pr9_ms": SLAB_LOOP_K3_MS.get(w)})
        if not repeatable:
            raise AssertionError(f"lu_panel_fused [{w}, {nb}]: two launches "
                                 f"on the same input differ")
        if w == 20480:
            rows["lu_panel_fused"] = row
    check_lu_zero_pivots(k3_gen)
    tie = torch.randn(2, 512, nb, generator=tie_gen, device="cuda")
    tie[:, 3, 0], tie[:, 300, 0] = 10.0, -10.0
    for g, w, nrows, x in ((4, 4096, None, None), (4, 5120, None, None),
                           (2, 256, None, None), (2, 512, 300, None),
                           (2, 512, None, tie)):
        if x is None:
            x = torch.randn(g, w, nb, generator=gen, device="cuda")
        got = lu_select(x, nrows=nrows)
        plain = lu_select_plain(x, nrows)
        library = (None if nrows is not None else
                   panel_lu(x)[1][:, :nb])
        equal = bool(torch.equal(got, plain)) and (
            library is None or bool(torch.equal(got, library))) and (
            x is not tie or bool((got[:, 0] == 3).all()))
        # per chunk: the partial-pivot LU's W nb^2 - nb^3/3 flops (the
        # tile's LU and the solve below it); the chunk and its live-row
        # count read, nb indices written
        b_ms, b_by = bound(g * panel_flops(w, 0, nb, "getrf"),
                           g * (4 * w * nb + 4 + 8 * nb))
        shape = {"G": g, "W": w, "nb": nb, "bw": 8, "nrows": nrows,
                 "tie_rows": [3, 300] if x is tie else None}
        plan = select_plan(x.device, w, nb, 8)
        row = {"check": "lu_select", "shape": shape,
               "max_abs_err": float((got - plain).abs().max()),
               "indices_equal_plain_and_lu_factor": equal,
               "tol_reason": "pivot rows: equal indices, to the plain "
                             "version's and (all rows live) to lu_factor's",
               "kernel_ms": time_ms(lambda: lu_select(x, nrows=nrows), 10),
               "plain_ms": time_ms(lambda: lu_select_plain(x, nrows), 2),
               "library_ms": (time_ms(lambda: torch.linalg.lu_factor_ex(x),
                                      5) if nrows is None else None),
               "bound_ms": b_ms, "bound_by": b_by, "cluster": plan["cluster"]}
        emit(row)
        emit({"phase": "lu_select_plan", "shape": shape, **plan,
              "kernel_ms": row["kernel_ms"],
              "pr8_ms": ONE_BLOCK_SELECT_MS.get((g, w, nrows, x is tie))})
        if not equal:
            raise AssertionError(f"lu_select {row['shape']}: pivot rows "
                                 f"differ from the plain version's or "
                                 f"lu_factor's, or the tie went to a row "
                                 f"other than 3")
        if w == 4096:
            rows["lu_select"] = row
    return rows


def zero_pivot_tile(gen, j: int, n: int = 128) -> torch.Tensor:
    """A tile whose pivot j is exactly 0 in f32: A = L U with small integer
    entries (L unit lower, U's other pivots +-1, U[j, j] = 0), plus
    integers under pivot j, so that every multiplier before column j is an
    exact integer, pivot j is 0 and the entries under it are not."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int64).double()
    lo = torch.tril(ints(-1, 2, (n, n)), -1) + torch.eye(
        n, device="cuda", dtype=torch.float64)
    up = torch.triu(ints(-2, 3, (n, n)), 1) + torch.diag(
        2 * ints(0, 2, (n,)) - 1)
    up[j, j] = 0
    a = lo @ up
    a[j + 1:, j] += ints(-2, 3, (n - j - 1,))
    return a.float()


def check_lu_zero_pivots(gen) -> None:
    """K3 on panels whose top tile has an exact-zero pivot at j = 0, 5
    (inside the first bw slab) and 37 (a later 32-column block), rows below
    Gaussian, at bw = 4 and 8: the kernel scales by 1 inside the pivot's
    slab and by 1 / 0 past it, as the plain version's slabs divide, so the
    health read of the tile's diagonal (robust/health.py from_pivots) gives
    the same info and nonfinite on both."""
    from slate_tpu_torch.internal.lu_kernels import (lu_panel_fused,
                                                     lu_panel_plain)
    from slate_tpu_torch.robust.health import from_pivots
    nb = 128
    for j in (0, 5, 37):
        panel = torch.cat([zero_pivot_tile(gen, j, nb),
                           torch.randn(nb, nb, generator=gen,
                                       device="cuda")])
        for bw in (4, 8):
            got, want = lu_panel_fused(panel, bw), lu_panel_plain(panel, bw)
            hg = from_pivots(torch.diagonal(got[:nb]))
            hw = from_pivots(torch.diagonal(want[:nb]))
            slab_end = j - j % bw + bw
            both = torch.isfinite(got) & torch.isfinite(want)
            emit({"phase": "lu_panel_zero_pivot", "W": 2 * nb, "nb": nb,
                  "bw": bw, "planted": j, "info_kernel": hg.info,
                  "info_plain": hw.info, "nonfinite_kernel": hg.nonfinite,
                  "nonfinite_plain": hw.nonfinite,
                  "slab_column_finite": bool(
                      torch.isfinite(got[j + 1:slab_end, j]).all()),
                  "past_slab_column_non_finite": not bool(
                      torch.isfinite(got[slab_end:nb, j]).any()),
                  "finite_in_both_max_abs_err": float(
                      (got[both] - want[both]).abs().max())})
            if (hg.info, hg.nonfinite) != (hw.info, hw.nonfinite):
                raise AssertionError(
                    f"lu_panel_fused, zero pivot at {j}, bw = {bw}: info "
                    f"and nonfinite {hg.info, hg.nonfinite} != the plain "
                    f"version's {hw.info, hw.nonfinite}")


def check_qr_kernels(gen, edge_gen) -> dict:
    """K5 against its plain version on the first and last panels of the
    main gels (8192 and 4224 rows), an mm that is no multiple of 8, a
    narrow panel, a panel with an exactly-zero column and alpha = -0.0
    in column 0, and the cluster's edges (mm = w, one row past it, an mm
    that no cluster size divides); torch.geqrf's packed panel and build_t
    of its taus held against K5's on the Gaussian panels; two launches
    compared bit for bit; each shape also timed on
    householder_panel_blocked, the CholQR2 route that panels past K5's
    cap take.  The edge shapes draw from ``edge_gen``, so that the later
    draws from ``gen`` stay as they were."""
    from slate_tpu_torch.internal.qr import build_t, householder_panel_blocked
    from slate_tpu_torch.internal.qr_kernels import (panel_cluster, qr_panel,
                                                     qr_panel_plain)
    rows = {}
    for mm, w, special in ((8192, 128, False), (4224, 128, False),
                           (1000, 128, False), (512, 40, False),
                           (512, 48, True), (128, 128, None),
                           (129, 128, None), (8191, 128, None)):
        x = torch.randn(mm, w, generator=gen if special is not None
                        else edge_gen, device="cuda")
        if special:
            x[:, 5] = 0.0
            x[0, 0] = -0.0
        got = qr_panel(x)
        repeatable = all(torch.equal(g, h) for g, h in zip(got, qr_panel(x)))

        def library():
            return torch.geqrf(x)
        witness = None
        if not special and mm > w:
            # LAPACK's sign of beta is the reference's on these inputs;
            # at alpha = -0.0 a library may take copysign's. At mm = w the
            # last column has no tail: LAPACK's larfg leaves it with tau =
            # 0, the reference's reflects it (beta = -alpha, tau = 2), so
            # there the library is no witness
            packed_l, tau_l = library()
            witness = [packed_l, build_t(packed_l, tau_l)]
        row = check(
            "qr_panel", {"mm": mm, "w": w, "bw": 8,
                         "zero_column_and_alpha_-0": bool(special)},
            list(got), list(qr_panel_plain(x)),
            "the same slab loop in both, sums over mm rows in another "
            "order; Gaussian panel, |R| <= ~sqrt(mm), |V| <= 1, T ~ 1",
            time_ms(lambda: qr_panel(x), 10),
            time_ms(lambda: qr_panel_plain(x), 2),
            time_ms(library, 10),
            op_flops("geqrf", (mm, w)), 4 * (2 * mm * w + w * w),
            control=tf32(lambda: list(qr_panel_plain(x))),
            witness=witness)
        row.update(cluster=panel_cluster(x.device, mm, w, 8),
                   bitwise_repeatable=repeatable,
                   pr5_ms=ONE_BLOCK_MS.get(("qr_panel", mm, w, "float32")))
        emit({"phase": "cluster", "check": "qr_panel", "mm": mm, "w": w,
              "cluster": row["cluster"], "bitwise_repeatable": repeatable,
              "kernel_ms": row["kernel_ms"], "pr5_ms": row["pr5_ms"]})
        if not repeatable:
            raise AssertionError(f"qr_panel [{mm}, {w}]: two launches on "
                                 f"the same input differ")
        row["cholqr2_route_ms"] = time_ms(
            lambda: householder_panel_blocked(x), 5)
        emit({"phase": "qr_panel_routes", "mm": mm, "w": w,
              "k5_ms": row["kernel_ms"],
              "householder_panel_blocked_ms": row["cholqr2_route_ms"]})
        if special:
            if not (torch.equal(got[0][:, 5], x[:, 5])
                    and float(got[1][5, 5]) == 0.0
                    and float(got[0][0, 0]) < 0):
                raise AssertionError("qr_panel: the zero column was not "
                                     "left as it was, or beta at alpha = "
                                     "-0.0 is not -mu")
        if (mm, w) == (8192, 128):
            rows["qr_panel"] = row
    return rows


def lstsq_problem(m: int, n: int, nrhs: int, gen: torch.Generator):
    """A Gaussian [m, n] and B = A X0 + a residual orthogonal to range(A)
    (projected out in f64), so that the least-squares solution is X0 and
    the residual is real; returns (A, B, X_f64) with X_f64 the f64
    least-squares solution of the f32 (A, B)."""
    a = torch.randn(m, n, generator=gen, device="cuda")
    x0 = torch.randn(n, nrhs, generator=gen, device="cuda")
    r = torch.randn(m, nrhs, generator=gen, device="cuda").double()
    a64 = a.double()
    r -= a64 @ torch.linalg.lstsq(a64, r).solution
    b = (a @ x0 + r.float()).contiguous()
    x64 = torch.linalg.lstsq(a64, b.double()).solution
    return a, b, x64


def lstsq_accuracy(a, x, b, x64) -> tuple[float, float]:
    """(the scaled normal-equations residual ||A^T (B - A X)||_F /
    (||A||_F (||A||_F ||X||_F + ||B||_F) n eps_f32), formed in f64, and
    the forward error max|X - X_f64| / max|X_f64|)."""
    a64, x = a.double(), x.double()
    ne = a64.T @ (b.double() - a64 @ x)
    na = torch.linalg.norm(a64)
    res = float(torch.linalg.norm(ne) / (
        na * (na * torch.linalg.norm(x) + torch.linalg.norm(b.double()))
        * a.shape[1] * EPS32))
    fwd = float((x - x64).abs().max() / x64.abs().max())
    return res, fwd


def run_gels(st, a, b, nb, opts=None):
    """gels on device matrices; returns (X dense, wall seconds)."""
    A = st.Matrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X = st.gels(A, B, opts)
    x = X.to_dense()
    torch.cuda.synchronize()
    return x, time.perf_counter() - t0


def trace_gels(st, a, b, nb) -> None:
    """Where one warm QR-route gels' time goes: the K5 panels, the larfb
    trailing updates (apply_q_left), unmqr on B and the triangular solve,
    each timed on the host clock with the device synchronised around it
    (a phase inside another counts to the outer one), then the device time
    by kernel under torch.profiler."""
    from slate_tpu_torch.drivers import qr as dq
    run_gels(st, a, b, nb)                           # warm-up
    spent: dict[str, float] = {}
    patched = [(dq, "geqrf_panel", "k5_panel"),
               (dq, "apply_q_left", "trailing_update"),
               (dq, "unmqr", "unmqr_on_b"),
               (dq, "_solve_r", "triangular_solve")]
    saved = [getattr(mod, name) for mod, name, _ in patched]
    depth = [0]

    def timed(fn, phase):
        def run(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            depth[0] += 1
            try:
                out, dt = _timed(lambda: fn(*args, **kw))
            finally:
                depth[0] -= 1
            spent[phase] = spent.get(phase, 0.0) + dt
            return out
        return run

    try:
        for (mod, name, phase), fn in zip(patched, saved):
            setattr(mod, name, timed(fn, phase))
        _, wall = run_gels(st, a, b, nb)
    finally:
        for (mod, name, _), fn in zip(patched, saved):
            setattr(mod, name, fn)
    _, wall_plain = run_gels(st, a, b, nb)
    emit({"phase": "trace_host_clock_s", "of": "gels QR",
          "gels_with_phase_syncs": wall, "gels": wall_plain,
          "outside_phases": wall - sum(spent.values()), **spent})
    A = st.Matrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    profile_device("gels QR", lambda: st.gels(A, B))
    # K5 on the first panel by slab width: the column passes read the slab
    # once a column (cost ~ bw), the wide passes the panel once a slab
    # (cost ~ 1 / bw)
    from slate_tpu_torch.internal.qr_kernels import qr_panel
    first = a[:, :nb]
    emit({"phase": "trace_qr_panel_by_slab_width", "mm": a.shape[0],
          "w": nb, "ms": {bw: time_ms(lambda: qr_panel(first, bw), 5)
                          for bw in (1, 2, 4, 8)}})


def check_qr_small(st, gen, nb) -> None:
    """Small QR checks against the same calls on the CPU: gels with m < n
    (the LQ minimum-norm branch), cholqr, unmqr in all four (side, op)
    pairs on the card's factors, and qr_multiply's ||Q^T Q - I||."""
    def cpu(t):
        return st.Matrix.from_numpy(t.cpu(), nb, device="cpu")

    def close(name, got, want, tol=1e-4):
        diff = float((got.cpu() - want).abs().max() / want.abs().max())
        emit({"phase": "qr_vs_cpu", "check": name, "rel_max_diff": diff,
              "tol": tol})
        if not diff <= tol:
            raise AssertionError(f"{name} on the card vs the CPU: {diff} > "
                                 f"{tol}")

    a = torch.randn(384, 1024, generator=gen, device="cuda")
    b = torch.randn(384, 4, generator=gen, device="cuda")
    close("gels_min_norm", st.gels(st.Matrix.from_numpy(a, nb),
                                   st.Matrix.from_numpy(b, nb)).to_dense(),
          st.gels(cpu(a), cpu(b)).to_dense())
    a = torch.randn(1024, 256, generator=gen, device="cuda")
    Q, R = st.cholqr(st.Matrix.from_numpy(a, nb))
    Qc, Rc = st.cholqr(cpu(a))
    close("cholqr_Q", Q.to_dense(), Qc.to_dense())
    close("cholqr_R", R.to_dense(), Rc.to_dense())
    F = st.geqrf(st.Matrix.from_numpy(a, nb))
    Fc = st.QRFactors(cpu(F.QR.to_dense()), F.T.cpu())
    for side, op in (("l", "n"), ("l", "t"), ("r", "n"), ("r", "t")):
        c = torch.randn(*((1024, 8) if side == "l" else (8, 1024)),
                        generator=gen, device="cuda")
        close(f"unmqr_{side}{op}",
              st.unmqr(side, op, F, st.Matrix.from_numpy(c, nb)).to_dense(),
              st.unmqr(side, op, Fc, cpu(c)).to_dense())
    q = st.qr_multiply(F).to_dense().double()
    orth = float((q.T @ q - torch.eye(256, device="cuda",
                                      dtype=torch.float64)).abs().max())
    emit({"phase": "qr_multiply_orthogonality", "m": 1024, "n": 256,
          "max_abs_QtQ_minus_I": orth, "tol": 1e-5})
    if not orth <= 1e-5:
        raise AssertionError(f"qr_multiply: ||Q^T Q - I|| = {orth}")


def orthogonal(n: int, gen: torch.Generator) -> torch.Tensor:
    """Q of the QR of a Gaussian: cond 1, a real pivot choice in every
    column."""
    return torch.linalg.qr(torch.randn(n, n, generator=gen,
                                       device="cuda"))[0]


def expected_calu_launches(n: int, nb: int, fits, mpt: int = 4,
                           depth: int = 2) -> dict:
    """K4 and K3 launches of getrf_tntpiv on an n x n matrix, replayed from
    the tournament's control flow (internal/getrf.py) on the shapes: a
    panel of W > nb rows splits into blocks of br rows; round 1 (when br >
    nb) and each reduction round of ``depth`` candidate sets are one K4
    launch if ``fits(block height)``, else lu_factor; K3 then launches
    twice (its factor, U^-1 formed inside, and the rows below); a panel of
    nb rows takes lu_factor alone."""
    k4 = k3 = 0
    for k0 in range(0, n, nb):
        w = n - k0
        if w <= nb:
            continue
        br = max(nb, -(-w // (mpt * nb)) * nb)
        blocks = -(-w // br)
        rounds = [br] if br > nb else []
        while blocks > 1:
            rounds.append(depth * nb)
            blocks = -(-blocks // depth)
        k4 += sum(fits(h) for h in rounds)
        k3 += 2
    return {"lu_select": k4, "lu_panel_fused": k3}


def run_gesv(st, a, b, nb, opts=None):
    """gesv on device matrices; returns (factors, X dense, wall seconds)."""
    A = st.Matrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    F, X = st.gesv(A, B, opts)[:2]
    x = X.to_dense()
    torch.cuda.synchronize()
    return F, x, time.perf_counter() - t0


def growth(F, a) -> float:
    """The ladder's pivot growth max|LU| / max|A| (robust/recovery.py
    escalates past 1/sqrt(eps), 2896 in f32)."""
    return float(F.LU.to_dense().abs().max() / a.abs().max())


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
    from slate_tpu_torch.drivers.cholesky import _potrf_dense_blocked
    A = st.SymmetricMatrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    st.posv(A, B)                                    # warm-up
    full, t_dense = _timed(A.to_dense)
    (lfac, _), t_factor = _timed(lambda: _potrf_dense_blocked(full, nb))
    L, t_tile = _timed(lambda: st.TriangularMatrix._from_view(
        st.Matrix(st.TileStorage.from_dense(lfac, nb, nb)), st.Uplo.Lower))
    del full, lfac
    Y, t_fwd = _timed(lambda: st.trsm("l", 1.0, L, B))
    _, t_bwd = _timed(lambda: st.trsm("l", 1.0, L.conj_transpose(), Y))
    _, t_posv = _timed(lambda: st.posv(A, B))
    emit({"phase": "trace_host_clock_s", "posv": t_posv, "to_dense": t_dense,
          "factor": t_factor, "tile_factor": t_tile, "trsm_forward": t_fwd,
          "trsm_backward": t_bwd})
    profile_device("posv", lambda: st.posv(A, B))


def profile_device(label, fn) -> list:
    """Device time by kernel and the device's idle share of one ``fn()``
    under torch.profiler; returns the kernels' device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(fn)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    busy = _busy_seconds(kernels) if kernels else None
    emit({"phase": "trace_profile", "of": label, "wall_s": wall,
          "device_busy_s": busy if busy is not None else "not measured",
          "device_idle_share": (1 - busy / wall) if busy else "not measured",
          "kernel_ms": {k: v * 1e-3 for k, v in top}})
    return kernels


def kernel_split(label, kernels, names) -> None:
    """Print the device time and the launches, under torch.profiler, of
    each kernel whose name holds one of ``names``, from the device events
    of one traced ``label`` run."""
    split = {}
    for name in names:
        mine = [e for e in kernels if name in e.name]
        split[name] = {"ms": 1e-3 * sum(e.time_range.elapsed_us()
                                        for e in mine),
                       "launches": len(mine)}
    emit({"phase": "trace_kernel_split", "of": label, **split})


def trace_gesv(st, a, b, nb, opts) -> None:
    """Where one warm CALU gesv's time goes: each phase of the blocked
    factor timed on the host clock with the device synchronised around it
    (tournament, K3 panel, U12 solve, trailing matmul, row moves), then
    the device time by kernel under torch.profiler, K4's split into its
    round-1 launches and its reduction rounds' (each launch classed as the
    tournament makes it, matched in order to K4's device events), and K3's
    into its factor and its strips launches."""
    from slate_tpu_torch.drivers import lu as dl
    from slate_tpu_torch.internal import getrf as ig
    run_gesv(st, a, b, nb, opts)                     # warm-up
    spent: dict[str, float] = {}
    patched = [(ig, "tournament_perm", "tournament"),
               (ig, "panel_lu_nopiv", "k3_panel"),
               (dl, "_solve_u12", "u12_solve"),
               (dl, "_update_trailing", "trailing_matmul"),
               (dl, "_apply_row_perm", "row_moves")]
    saved = [getattr(mod, name) for mod, name, _ in patched]

    def timed(fn, phase):
        def run(*args, **kw):
            out, dt = _timed(lambda: fn(*args, **kw))
            spent[phase] = spent.get(phase, 0.0) + dt
            return out
        return run

    try:
        for (mod, name, phase), fn in zip(patched, saved):
            setattr(mod, name, timed(fn, phase))
        _, _, wall = run_gesv(st, a, b, nb, opts)
    finally:
        for (mod, name, _), fn in zip(patched, saved):
            setattr(mod, name, fn)
    _, _, wall_plain = run_gesv(st, a, b, nb, opts)
    emit({"phase": "trace_host_clock_s", "of": "gesv CALU",
          "gesv_with_phase_syncs": wall, "gesv": wall_plain,
          "outside_phases": wall - sum(spent.values()), **spent})
    A = st.Matrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    rounds: list[str] = []
    state = {"round1": False}
    tournament, keep_best, select = (ig.tournament_perm, ig._keep_best,
                                     ig.lu_select)

    def tournament_spy(panel, block_rows, *args, **kw):
        state["round1"] = block_rows > panel.shape[1]
        return tournament(panel, block_rows, *args, **kw)

    def keep_best_spy(*args, **kw):
        try:
            return keep_best(*args, **kw)
        finally:
            state["round1"] = False          # every later round reduces

    def select_spy(*args, **kw):
        rounds.append("round1" if state["round1"] else "reduction")
        return select(*args, **kw)
    try:
        ig.tournament_perm, ig._keep_best, ig.lu_select = (
            tournament_spy, keep_best_spy, select_spy)
        kernels = profile_device("gesv CALU", lambda: st.gesv(A, B, opts))
    finally:
        ig.tournament_perm, ig._keep_best, ig.lu_select = (
            tournament, keep_best, select)
    k4 = sorted((e for e in kernels if "lu_select" in e.name),
                key=lambda e: e.time_range.start)
    split = {"launches": len(rounds), "device_events": len(k4)}
    if len(k4) == len(rounds):
        for kind in ("round1", "reduction"):
            split[f"{kind}_launches"] = rounds.count(kind)
            split[f"{kind}_ms"] = 1e-3 * sum(
                e.time_range.elapsed_us()
                for e, r in zip(k4, rounds) if r == kind)
    else:
        split["split"] = "not measured: the profile lost K4 events"
    emit({"phase": "trace_k4_rounds", "of": "gesv CALU", **split})
    kernel_split("gesv CALU", kernels,
                 ("lu_panel_factor_kernel", "lu_panel_below_kernel",
                  "upper_tri_inv_kernel"))


# ---- the serving slice: K6, K7, K8 and serve.Server -----------------------

SERVE_B, SERVE_M, SERVE_NB = 8, 4096, 128   # K6/K7 checks: a full bucket
SERVE_TILES = {0: (32, 32, 20, 9, 1, 32, 0, 16),      # live, partly dead,
               16: (48, 48, 30, 9, 17, 0, 40, 48)}    # and wholly dead


def serve_panel_inputs(gen, chol: bool, k: int, dtype):
    """A batch of K6/K7 operands at a serving shape: B = 8 problems of
    M = 4096 rows, nb = 128, K = k nb columns of history with O(1)
    products (left, lead ~ N(0,1) / K^(1/4), drawn apart), strided as
    batch_potrf and batch_getrf pass them (lead a transposed view for
    Cholesky); the top block of col - left @ lead SPD with cond <= ~5
    (Cholesky) or G / sqrt(nb) + 2 I (LU).  bf16: the same values rounded."""
    b, m, nb, kk = SERVE_B, SERVE_M, SERVE_NB, k * SERVE_NB
    scale = max(kk, 1) ** -0.25
    left = (torch.randn(b, m, kk + 8, generator=gen, device="cuda")
            * scale)[:, :, 8:]
    if chol:
        lead = (torch.randn(b, nb, kk + 8, generator=gen, device="cuda")
                * scale)[:, :, 8:].mT
    else:
        lead = (torch.randn(b, kk, nb + 8, generator=gen, device="cuda")
                * scale)[:, :, 8:]
    base = torch.randn(b, m, nb, generator=gen, device="cuda")
    top = base[:, :nb]
    eye = torch.eye(nb, device="cuda")
    base[:, :nb] = (top @ top.mT / nb + eye if chol
                    else top / nb ** 0.5 + 2 * eye)
    col = base + left @ lead
    return col.to(dtype), left.to(dtype), lead.to(dtype)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw storage bits (NaN-proof bit equality)."""
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def check_serve_kernels(gen, edge_gen) -> dict:
    """K6 and K7 at B = 8, M = 4096, nb = 128, k = 0 and k = 16, K8 at
    [8, 4096, 128] and [8, 1024, 128] with a rows = 0 slot, each in f32
    and bf16: kernel vs plain version (f32: ATOL + RTOL |plain|; bf16:
    ATOL + 2^-7 |plain|, one bf16 ulp at the store), dead tiles and filler
    slots bit-equal to the input, and the bound counted on live tiles.
    Every K6 and K7 check also repeats the launch bit for bit, runs each
    problem alone against its bits in the batch, and prints its plan
    (split, waves, each of its three launches' device time); K6's library
    composition factors with ``cholesky_ex`` (no host sync),
    ``cholesky``'s time beside it."""
    from slate_tpu_torch.internal import chol_kernels as ck
    from slate_tpu_torch.internal import lu_kernels as lk
    from slate_tpu_torch.internal import qr_kernels as qk
    rows = {}
    nb = SERVE_NB
    for name, chol, kern, plain, plan_of in (
            ("chol_panel_batched", True, ck.chol_panel_batched,
             ck.chol_panel_batched_plain, ck.batched_panel_plan),
            ("lu_panel_batched", False, lk.lu_panel_batched,
             lk.lu_panel_batched_plain, lk.batched_panel_plan)):
        tag = "k6" if chol else "k7"
        for k in (0, 16):
            tiles = torch.tensor(SERVE_TILES[k], dtype=torch.int32,
                                 device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                col, left, lead = serve_panel_inputs(gen, chol, k, dtype)
                got = kern(col, left, lead, tiles, k, 8)
                want = plain(col, left, lead, tiles, k, 8)
                live = ck.live_rows(tiles, k, SERVE_M, nb)
                dead_equal = all(torch.equal(bits(torch.where(live, col, g)),
                                             bits(col)) for g in got)
                f32 = dtype == torch.float32

                def library(cholesky=lambda t:
                            torch.linalg.cholesky_ex(t)[0]):
                    upd = col - left @ lead
                    if not chol:
                        return torch.linalg.lu_factor_ex(upd, pivot=False)[0]
                    l00 = cholesky(upd[:, :nb])
                    return torch.linalg.solve_triangular(
                        l00.mT, upd[:, nb:], upper=True, left=False)
                # live work only: per problem with tile 0 live, its live
                # rows' update, the tile factor and the solve below it
                kk, esz = k * nb, col.element_size()
                live_m = [max(0, min(SERVE_M, (t - k) * nb))
                          for t in SERVE_TILES[k]]
                flops = sum(panel_flops(mb, kk, nb,
                                        "potrf" if chol else "getrf")
                            for mb in live_m if mb)
                nbytes = esz * (3 * SERVE_B * SERVE_M * nb + sum(live_m) * kk
                                + sum(1 for mb in live_m if mb) * kk * nb)
                wrapper_ms = time_ms(lambda: kern(col, left, lead, tiles, k,
                                                  8), 10)
                # the row's time: its own launches' device time
                times = step_launch_times(
                    name, tag, lambda: kern(col, left, lead, tiles, k, 8))
                row = check(
                    name, {"B": SERVE_B, "M": SERVE_M, "nb": nb, "K": kk,
                           "bw": 8, "dtype": str(dtype)[6:],
                           "tiles": list(SERVE_TILES[k])},
                    list(got), list(want),
                    "f32: K-long f32 sums with O(1) partial sums in another "
                    "order, tile factors on blocks with cond <= ~5; bf16: "
                    "the same f32 values, then each store rounds to bf16, "
                    "so one bf16 ulp (2^-7 relative) apart at most",
                    times[f"{tag}_own_ms"],
                    time_ms(lambda: plain(col, left, lead, tiles, k, 8), 1,
                            warmup=1),
                    time_ms(library, 10) if f32 else None, flops, nbytes,
                    control=(list(tf32(lambda: plain(col, left, lead,
                                                     tiles, k, 8)))
                             if f32 and k else None),
                    rtol=RTOL if f32 else BF16_RTOL)
                row["dead_tiles_bit_equal"] = dead_equal
                emit({"phase": "dead_tiles", "check": name, "k": k,
                      "dtype": str(dtype)[6:], "bit_equal": dead_equal})
                if not dead_equal:
                    raise AssertionError(f"{name} k={k} {dtype}: a dead "
                                         f"tile is not col's bits")
                check_step_plan(name, kern, plan_of, row, times, wrapper_ms,
                                got, col, left, lead, tiles, k,
                                library if f32 else None, chol)
                if f32 and k:
                    rows[name] = row
    # (B, mm, rows): the main path's largest panel and a smaller one with a
    # filler slot inside; mm = w, and 12 clusters of 16 CTAs, more than the
    # card holds at once, with filler slots first and last
    k8_cases = ((SERVE_B, 4096, (4096, 3996, 0, 4096, 4096, 4089, 4096,
                                 4096)),
                (SERVE_B, 1024, (1024, 924, 0, 1024, 1024, 1017, 1024,
                                 1024)),
                (SERVE_B, 128, (0, 128, 128, 121, 128, 128, 128, 0)),
                (12, 4096, (0,) + (4096,) * 10 + (0,)))
    for case, (bsz, mm, rows_b) in enumerate(k8_cases):
        for dtype in (torch.float32, torch.bfloat16):
            w = 128
            a = torch.randn(bsz, mm, w, generator=gen if case < 2
                            else edge_gen, device="cuda").to(dtype)
            rws = torch.tensor(rows_b, dtype=torch.int32, device="cuda")
            got = qk.qr_panel_batched(a, rws)
            repeatable = all(torch.equal(bits(g), bits(h)) for g, h in
                             zip(got, qk.qr_panel_batched(a, rws)))
            want = qk.qr_panel_batched_plain(a, rws)
            fillers = [b for b, r in enumerate(rows_b) if r == 0]
            filler_equal = all(torch.equal(bits(got[0][b]), bits(a[b]))
                               and not bool(got[1][b].any())
                               for b in fillers)
            # the first live problem alone, as the serving path retries it:
            # the cluster size depends on mm only, so its bits do not change
            one = rows_b.index(max(rows_b))
            alone = qk.qr_panel_batched(a[one:one + 1], rws[one:one + 1])
            batch_invariant = all(torch.equal(bits(g[one]), bits(h[0]))
                                  for g, h in zip(got, alone))
            cluster, resident = qk.batched_panel_cluster(a.device, dtype, mm,
                                                         w, 8)
            f32 = dtype == torch.float32
            live = sum(1 for r in rows_b if r)
            row = check(
                "qr_panel_batched", {"B": bsz, "mm": mm, "w": w, "bw": 8,
                                     "dtype": str(dtype)[6:],
                                     "rows": list(rows_b)},
                list(got), list(want),
                "K5's slab loop in both, sums over mm rows in another "
                "order; Gaussian panels, |R| <= ~sqrt(mm), |V| <= 1; bf16: "
                "each store rounds, one bf16 ulp apart at most",
                time_ms(lambda: qk.qr_panel_batched(a, rws), 5),
                time_ms(lambda: qk.qr_panel_batched_plain(a, rws), 1,
                        warmup=1),
                time_ms(lambda: torch.geqrf(a), 5) if f32 else None,
                live * op_flops("geqrf", (mm, w)),
                a.element_size() * bsz * (2 * mm * w + w * w),
                rtol=RTOL if f32 else BF16_RTOL)
            row.update(filler_slot_bit_equal=filler_equal,
                       cluster=cluster,
                       waves=-(-bsz // resident),
                       bitwise_repeatable=repeatable,
                       batch_invariant=batch_invariant,
                       pr5_ms=ONE_BLOCK_MS.get(("qr_panel_batched", bsz, mm,
                                          str(dtype)[6:])))
            emit({"phase": "filler_slot", "check": "qr_panel_batched",
                  "B": bsz, "mm": mm, "dtype": str(dtype)[6:],
                  "fillers": fillers, "bit_equal_and_T_zero": filler_equal})
            emit({"phase": "cluster", "check": "qr_panel_batched", "B": bsz,
                  "mm": mm, "dtype": str(dtype)[6:],
                  "cluster": row["cluster"], "waves": row["waves"],
                  "clusters_resident": resident,
                  "bitwise_repeatable": repeatable,
                  "batch_invariant": batch_invariant,
                  "kernel_ms": row["kernel_ms"], "pr5_ms": row["pr5_ms"]})
            if not filler_equal:
                raise AssertionError("qr_panel_batched: a rows = 0 slot is "
                                     "not a's bits with T = 0")
            if not repeatable:
                raise AssertionError(f"qr_panel_batched [{bsz}, {mm}, {w}] "
                                     f"{dtype}: two launches on the same "
                                     f"input differ")
            if not batch_invariant:
                raise AssertionError(f"qr_panel_batched [{bsz}, {mm}, {w}] "
                                     f"{dtype}: problem {one} alone differs "
                                     f"from its bits in the batch")
            if f32 and (bsz, mm) == (SERVE_B, 4096):
                rows["qr_panel_batched"] = row
    return rows


def check_step_plan(name, kern, plan_of, row, times, wrapper_ms, got, col,
                    left, lead, tiles, k, library, chol) -> None:
    """K6's or K7's ``{name}_plan`` line: the split and the waves its update
    launch took, the device time of each of its launches, two launches
    bit for bit, and each problem alone bit-equal to its slot in the batch
    (the split is a function of K, nb and the card, never of the batch);
    the library composition's device time and, for K6, its time with
    ``cholesky`` beside the one with ``cholesky_ex`` (``library`` None on
    bf16)."""
    plan = plan_of(col, left, lead)
    again = kern(col, left, lead, tiles, k, 8)
    repeatable = all(torch.equal(bits(g), bits(h))
                     for g, h in zip(got, again))
    alone = [kern(col[b:b + 1], left[b:b + 1], lead[b:b + 1],
                  tiles[b:b + 1], k, 8) for b in range(col.shape[0])]
    invariant = all(torch.equal(bits(g[b]), bits(one[i][0]))
                    for b, one in enumerate(alone)
                    for i, g in enumerate(got))
    extra = {}
    if library is not None:
        if chol:
            extra["library_cholesky_ms"] = time_ms(
                lambda: library(torch.linalg.cholesky), 10)
        extra["library_device_ms"] = sum(device_ms(library).values())
    row.update(times, plan=plan, wrapper_ms=wrapper_ms,
               bitwise_repeatable=repeatable, batch_invariant=invariant,
               **extra)
    emit({"phase": f"{name}_plan", "B": col.shape[0],
          "M": col.shape[1], "K": left.shape[2], "dtype": str(col.dtype)[6:],
          **plan, **times, "wrapper_ms": wrapper_ms,
          "library_ms": row["library_ms"], **extra,
          "bitwise_repeatable": repeatable, "batch_invariant": invariant})
    if not repeatable:
        raise AssertionError(f"{name} k={k} {col.dtype}: two launches on "
                             f"the same input differ")
    if not invariant:
        raise AssertionError(f"{name} k={k} {col.dtype}: a problem alone "
                             f"differs from its bits in the batch")


def serve_requests(gen, nrhs: int = SERVE_NRHS):
    """The mixed stream: 40 requests per op in a seeded order, solve and
    chol_solve at n in SERVE_SOLVE_NS, least squares at m = 2n with n in
    SERVE_LSQ_NS, 16 right-hand sides, all on the card.  solve takes
    A = G / sqrt(n) + 4 I, chol_solve ex07's A = G G^T / n + I, least
    squares a Gaussian.  Planted: two solves with a zero leading pivot
    (NoPiv fails, PartialPiv serves them), two chol_solves on symmetric
    indefinite matrices (they escalate to LU), one least-squares request
    with an exactly zero column (it exhausts the ladder).  Returns (the
    requests, {index: what was planted})."""
    reqs, planted = [], []
    for op, ns in (("solve", SERVE_SOLVE_NS), ("chol_solve", SERVE_SOLVE_NS),
                   ("least_squares_solve", SERVE_LSQ_NS)):
        for i in range(SERVE_PER_OP):
            n = ns[i % len(ns)]
            m = 2 * n if op == "least_squares_solve" else n
            g = torch.randn(m, n, generator=gen, device="cuda")
            b = torch.randn(m, nrhs, generator=gen, device="cuda")
            if op == "solve":
                a = g / n ** 0.5 + 4 * torch.eye(n, device="cuda")
                if i < 2:
                    a[0, 0] = 0.0
                    planted.append("zero_leading_pivot")
                else:
                    planted.append(None)
            elif op == "chol_solve":
                a = g @ g.T / n + torch.eye(n, device="cuda")
                if i in (2, 3):
                    a -= 3 * torch.eye(n, device="cuda")
                    planted.append("indefinite")
                else:
                    planted.append(None)
            else:
                a = g
                if i == 4:
                    a[:, 1] = 0.0
                    planted.append("zero_column")
                else:
                    planted.append(None)
            reqs.append((op, a.contiguous(), b))
    order = torch.randperm(len(reqs), generator=gen, device="cuda").tolist()
    return [reqs[i] for i in order], {j: planted[i] for j, i in
                                      enumerate(order) if planted[i]}


def serve_residual(op, a, x, b) -> float:
    """solve and chol_solve: ||A x - b||_F / (||A||_F ||x||_F n eps_f32);
    least squares: ||A^T (b - A x)||_F / (||A||_F (||A||_F ||x||_F +
    ||b||_F) n eps_f32); formed in f64."""
    a64, x64 = a.double(), x.double()
    if op == "least_squares_solve":
        na = torch.linalg.norm(a64)
        ne = a64.T @ (b.double() - a64 @ x64)
        return float(torch.linalg.norm(ne) / (
            na * (na * torch.linalg.norm(x64) + torch.linalg.norm(b.double()))
            * a.shape[1] * EPS32))
    r = a64 @ x64 - b.double()
    return float(torch.linalg.norm(r) / (torch.linalg.norm(a64)
                                         * torch.linalg.norm(x64)
                                         * a.shape[0] * EPS32))


def serve_accuracy(reqs, results) -> dict:
    """The worst residual of the healthy results, per op."""
    worst = {}
    for (op, a, b), res in zip(reqs, results):
        if res.health.ok:
            worst[op] = max(worst.get(op, 0.0),
                            serve_residual(op, a, res.x, b))
    return worst


def expected_serve_launches(records, warmups: bool = True) -> dict:
    """K6, K7 and K8 launches of the ragged route, replayed from the batches
    the server ran: a chol_solve (solve) batch of bucket n runs one K6 (K7)
    step a block column, with nb = min(128, n): 3 n / nb - 1 launches
    (update, factor, solve; the last step no solve) each; a
    least-squares batch of bucket (mb, n, kb) one K8 launch a panel, n / w
    with w = min(128, n).  On the card every batch replays its bucket's
    CUDA graph, and a batch that missed the cache first ran that device
    part once more, as the capture's warm-up pass (counted with
    ``warmups``).  Each escalated least-squares problem's safe rung,
    Householder QR of its (mb, n) bucket in tiles of min(n, 128),
    launches K5 once a panel, eagerly; the LU safe rungs run no hand
    kernel."""
    want = {"chol_panel_batched": 0, "lu_panel_batched": 0,
            "qr_panel_batched": 0, "qr_panel": 0}
    for r in records:
        n = r["bucket"][1] if r["op"] == "least_squares_solve" \
            else r["bucket"][0]
        nb = min(128, n)
        runs = 1 + (warmups and not r["cache_hit"])
        if r["op"] == "least_squares_solve":
            want["qr_panel_batched"] += runs * (n // nb)
            want["qr_panel"] += r["escalated"] * (n // nb)
        elif r["op"] == "chol_solve":
            want["chol_panel_batched"] += runs * (3 * (n // nb) - 1)
        else:
            want["lu_panel_batched"] += runs * (3 * (n // nb) - 1)
    return want


def run_stream(st, reqs, opts=None, device=None):
    """One stream through a fresh serve.Server; returns (server, results,
    wall seconds)."""
    srv = st.serve.Server(opts, device=device,
                          cache=st.serve.ExecutableCache())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.serve_batch(reqs)
    torch.cuda.synchronize()
    return srv, res, time.perf_counter() - t0


def group_table(records) -> list:
    return [{"op": r["op"], "bucket": r["bucket"], "batch": r["batch"],
             "problems": r["problems"],
             "padding_waste": round(r["padding_waste"], 4),
             "escalated": r["escalated"], "retry": r["retry"],
             "quarantine": r["quarantine"], "wall_s": r["wall_s"]}
            for r in records]


def trace_serve(st, reqs) -> None:
    """Where one warm serving stream's time goes: pack, the device parts'
    graph replays (copy-in, replay, copy-out: the ragged factor, solves,
    refinement and health of every batch), the health read, the safe
    rungs and unpack, each timed on the host clock with the device
    synchronised around it and counted exclusively (a phase inside
    another is taken out of the outer one), then the device time by kernel
    under torch.profiler, K6's and K7's by launch (update, factor,
    solve)."""
    from slate_tpu_torch.internal import graphs as ig
    from slate_tpu_torch.robust import health as rh
    from slate_tpu_torch.serve import batched as sbm
    from slate_tpu_torch.serve import server as ssv
    srv = st.serve.Server(cache=st.serve.ExecutableCache())
    srv.serve_batch(reqs)                            # warm-up
    spent: dict[str, float] = {}
    stack: list[float] = []

    def timed(fn, phase):
        def run(*args, **kw):
            torch.cuda.synchronize()
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                dt = time.perf_counter() - t0
                inner = stack.pop()
                spent[phase] = spent.get(phase, 0.0) + dt - inner
                if stack:
                    stack[-1] += dt
            return out
        return run

    patched = [(ssv.Server, "_pack", "pack"),
               (ssv.Server, "_unpack", "unpack"),
               (ig.Captured, "__call__", "graph_replay"),
               (rh.BatchHealth, "to_list", "health_read")]
    saved = [getattr(obj, name) for obj, name, _ in patched]
    safe = dict(sbm.SAFE_RUNGS)
    try:
        for (obj, name, phase), fn in zip(patched, saved):
            setattr(obj, name, timed(fn, phase))
        for op, fn in safe.items():
            sbm.SAFE_RUNGS[op] = timed(fn, "safe_rung")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.serve_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for (obj, name, _), fn in zip(patched, saved):
            setattr(obj, name, fn)
        sbm.SAFE_RUNGS.update(safe)
    _, _, wall_plain = run_stream(st, reqs)
    emit({"phase": "trace_host_clock_s", "of": "serve stream warm",
          "stream_with_phase_syncs": wall, "stream_cold_fresh_server":
          wall_plain, "outside_phases": wall - sum(spent.values()),
          **spent})
    kernels = profile_device("serve stream warm",
                             lambda: srv.serve_batch(reqs))
    kernel_split("serve stream warm", kernels,
                 [f"{k}_panel_batched_{part}" for k in ("lu", "chol")
                  for part in ("update", "factor", "solve")])


def check_serving(st, gen, kernels, reset, counts) -> dict:
    """The serving slice's paths on the card: the mixed stream through
    serve.Server at full width on the ragged route (cold, then warm), on
    the per-problem route, with the bf16 rung, with TF32 products (the
    control the residual bounds must catch), and a small stream held
    against the CPU route.  Every phase runs and prints before the checks
    decide; any miss fails the run.  Returns the launch counts of each
    path and the stream."""
    from slate_tpu_torch.internal import batched as ib
    failures = []
    reqs, planted = serve_requests(gen)
    per_op = {op: sum(1 for r in reqs if r[0] == op)
              for op in ("solve", "chol_solve", "least_squares_solve")}
    emit({"phase": "serve_stream", "requests": len(reqs), "per_op": per_op,
          "nrhs": SERVE_NRHS, "planted": {str(k): v for k, v in
                                          planted.items()}})
    # ---- the ragged route (the default): cold, then warm ----
    reset()
    srv, res, wall_cold = run_stream(st, reqs)
    launches = counts()
    records = list(srv.batch_records)
    want = {**{name: 0 for name in kernels},
            **expected_serve_launches(records)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_warm = srv.serve_batch(reqs)                   # the same server, warm
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0
    warm_records = srv.batch_records[-len(records):]
    acc = serve_accuracy(reqs, res)
    emit({"phase": "serve_groups", "route": "ragged",
          "groups": group_table(records)})
    emit({"phase": "serve_ragged", "wall_s_cold": wall_cold,
          "wall_s_warm": wall_warm,
          "problems_per_s_warm": len(reqs) / wall_warm,
          "problems_per_s_cold": len(reqs) / wall_cold,
          "warm_group_wall_s": [r["wall_s"] for r in warm_records],
          "launches": launches, "launches_predicted": want,
          "quarantined": srv.health_info()["quarantined"],
          "worst_residual": acc,
          "residual_bounds": {"solve": SERVE_RESIDUAL_BOUND,
                              "chol_solve": SERVE_RESIDUAL_BOUND,
                              "least_squares_solve": SERVE_LSQ_BOUND}})
    if launches != want:
        failures.append(f"serving launches {launches} != {want}")
    for i, what in planted.items():
        h, esc = res[i].health, res[i].escalated
        good = (esc and h.ok) if what != "zero_column" else \
            (esc and not h.ok)
        emit({"phase": "serve_planted", "request": i, "planted": what,
              "escalated": esc, "health_ok": h.ok, "info": h.info,
              "as_expected": good})
        if not good:
            failures.append(f"planted request {i} ({what}): escalated "
                            f"{esc}, health ok {h.ok}")
    if srv.health_info()["quarantined"] != 2:          # cold and warm runs
        failures.append("the zero-column request was not quarantined "
                        "once per stream")
    unhealthy = [i for i, r in enumerate(res) if not r.health.ok]
    if unhealthy != [i for i, w in planted.items() if w == "zero_column"]:
        failures.append(f"unhealthy results {unhealthy}")
    same = all(torch.equal(bits(a.x), bits(b.x))
               for a, b in zip(res, res_warm))
    emit({"phase": "serve_cold_vs_warm", "bit_equal": same})
    if not same:
        failures.append("the warm stream's results differ from the "
                        "cold stream's")
    # ---- the TF32 control: the same stream with TF32 products ----
    _, res_tf, _ = tf32(lambda: run_stream(st, reqs))
    acc_tf = serve_accuracy(reqs, res_tf)
    emit({"phase": "serve_tf32_control", "worst_residual": acc_tf})
    bounds = {"solve": SERVE_RESIDUAL_BOUND,
              "chol_solve": SERVE_RESIDUAL_BOUND,
              "least_squares_solve": SERVE_LSQ_BOUND}
    for op, bnd in bounds.items():
        if not acc[op] < bnd:
            failures.append(f"serve {op}: worst healthy residual "
                            f"{acc[op]} (bound {bnd})")
        if not acc_tf[op] > bnd:
            failures.append(f"serve {op}: the bound {bnd} does not catch "
                            f"TF32 products ({acc_tf[op]})")
    # ---- the per-problem route: the single-problem drivers ----
    reset()
    with contextlib.ExitStack() as stack:
        for op in ("batch_potrf", "batch_getrf", "batch_geqrf"):
            stack.enter_context(st.plan_override(op, st.LIBRARY_PLAN))
        _, res_pp, wall_pp = run_stream(st, reqs)
    pp_launches = counts()
    worst_diff = 0.0
    for (op, _, _), a, b in zip(reqs, res, res_pp):
        if a.health.ok:
            worst_diff = max(worst_diff, float(
                (a.x - b.x).abs().max() / a.x.abs().max()))
    emit({"phase": "serve_per_problem_route", "wall_s": wall_pp,
          "problems_per_s": len(reqs) / wall_pp,
          "ragged_problems_per_s_warm": len(reqs) / wall_warm,
          "launches": pp_launches, "worst_healthy_acc": serve_accuracy(
              reqs, res_pp),
          "max_rel_diff_vs_ragged": worst_diff, "tol": SERVE_ROUTE_TOL})
    if any(pp_launches[k] for k in ("chol_panel_batched", "lu_panel_batched",
                                    "qr_panel_batched")):
        failures.append("the per-problem route launched a batched "
                        "kernel")
    if not worst_diff <= SERVE_ROUTE_TOL:
        failures.append(f"per-problem vs ragged route: {worst_diff}")
    # ---- the bf16 rung: K6-K8 on bf16 storage ----
    seen = {}

    def spy(fn, name):
        def run(a, *rest, **kw):
            seen[(name, str(a.dtype))] = seen.get((name, str(a.dtype)),
                                                  0) + 1
            return fn(a, *rest, **kw)
        return run
    names = ("chol_panel_batched", "lu_panel_batched", "qr_panel_batched")
    saved = [getattr(ib, n) for n in names]
    reset()
    try:
        for n, fn in zip(names, saved):
            setattr(ib, n, spy(fn, n))
        srv16, res16, wall16 = run_stream(
            st, reqs, {st.Option.Precision: st.Precision.Bf16})
    finally:
        for n, fn in zip(names, saved):
            setattr(ib, n, fn)
    bf16_launches = counts()
    esc16 = [r.escalated for r in res16]
    mismatch = [i for i, (r, e) in enumerate(zip(res16, esc16))
                if e and not (torch.equal(bits(r.x), bits(res[i].x))
                              and r.health == res[i].health)]
    emit({"phase": "serve_bf16_rung", "wall_s": wall16,
          "problems_per_s": len(reqs) / wall16,
          "accept_rate": 1 - sum(esc16) / len(esc16),
          "escalated": sum(esc16), "launches": bf16_launches,
          "panel_calls_by_storage": {f"{k[0]}:{k[1]}": v
                                     for k, v in seen.items()},
          "escalated_not_bit_equal_to_f32": mismatch,
          "worst_healthy_residual": serve_accuracy(reqs, res16)})
    if mismatch:
        failures.append(f"bf16 rung: escalated problems {mismatch} "
                        f"differ from the f32 stream")
    if not all(seen.get((n, "torch.bfloat16")) for n in names):
        failures.append(f"bf16 rung: a batched kernel never ran on "
                        f"bf16 storage ({seen})")
    # ---- a small stream held against the CPU route ----
    small = serve_requests_small(gen)
    _, got, _ = run_stream(st, small)
    _, want_cpu, _ = run_stream(st, [(op, a.cpu(), b.cpu())
                                     for op, a, b in small], device="cpu")
    diff = max(float((g.x.cpu() - w.x).abs().max() / w.x.abs().max())
               for g, w in zip(got, want_cpu))
    emit({"phase": "serve_vs_cpu", "requests": len(small),
          "rel_max_diff": diff, "tol": 1e-4})
    if not (diff <= 1e-4 and all(g.health.ok for g in got)):
        failures.append(f"serving on the card vs the CPU: {diff}")
    if failures:
        raise AssertionError("serving: " + "; ".join(failures))
    return {"serve_ragged": launches, "serve_per_problem": pp_launches,
            "serve_bf16": bf16_launches}, reqs


def serve_requests_small(gen):
    """Nine small requests (n = 40, 100, 128 per op) for the CPU check."""
    reqs = []
    for n in (40, 100, 128):
        g = torch.randn(n, n, generator=gen, device="cuda")
        b = torch.randn(n, 3, generator=gen, device="cuda")
        reqs.append(("solve", g / n ** 0.5 + 4 * torch.eye(n, device="cuda"),
                     b))
        reqs.append(("chol_solve", g @ g.T / n + torch.eye(n, device="cuda"),
                     b))
        reqs.append(("least_squares_solve",
                     torch.randn(2 * n, n, generator=gen, device="cuda"),
                     torch.randn(2 * n, 3, generator=gen, device="cuda")))
    return reqs


# ------------------------------------------- serving survival phases

# the warm ragged stream's wall before its buckets were captured as CUDA
# graphs, as PERF.md records it (H100 80GB HBM3 at 700 W)
EAGER_STREAM_WARM_S = 0.456
# the async loop's flush watermarks
LOOP_OCCUPANCY, LOOP_DELAY_MS = 8, 5.0


def _ev_ms(fn, reps: int = 3):
    """``fn()``'s mean time over ``reps`` calls between two CUDA events,
    after one call that is not timed; returns (ms, the last output)."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _join_serve_threads(timeout_s: float = 60.0) -> list:
    """Wait for every slate-serve-* thread (a wedged flush or a dispatch
    that outlived its deadline) to end; returns the names still alive."""
    import threading
    deadline = time.perf_counter() + timeout_s
    for t in threading.enumerate():
        if t.name.startswith("slate-serve-"):
            t.join(max(deadline - time.perf_counter(), 0.0))
    return [t.name for t in threading.enumerate()
            if t.name.startswith("slate-serve-")]


def _graph_replays(cache) -> dict:
    """Per kernel name, the launches a cache's graphs ran: each capture's
    tally times that graph's replays."""
    out: dict = {}
    for _, exe in cache.entries():
        for g in getattr(exe, "graphs", {}).values():
            for k, n in g.launches.items():
                out[k.name] = out.get(k.name, 0) + n * g.replays
    return out


def check_serve_graph(st, reqs, kernels, reset, counts, failures):
    """serve_graph: the 120-request stream through the captured cache, cold
    and warm; every group's captured callable against eager make_batched
    on the same packed batch (bits, or the op that differs under the
    serving bounds), each group's eager and replay time by CUDA events,
    the captures, capture time and reserved memory, the warm wall in turns
    with the same stream through eager callables (and PERF.md's eager
    figure beside),
    K6/K7/K8 launches as each capture's tally times its replays against
    the batches' prediction, and the same count from torch.profiler over
    one warm stream, with its device idle share beside the eager
    stream's."""
    from slate_tpu_torch.serve import batched as sbm
    from slate_tpu_torch.serve import server as ssv
    srv = st.serve.Server(cache=st.serve.ExecutableCache())
    reset()
    _, wall_cold = _timed(lambda: srv.serve_batch(reqs))
    n_cold = len(srv.batch_records)
    warm_walls = []
    packed = []
    real_pack = ssv.Server._pack

    def spy(self, op, dtype, shape, batch, members):
        out = real_pack(self, op, dtype, shape, batch, members)
        packed.append((op, dtype, shape, batch, *out[:3]))
        return out
    for i in range(2):
        if i == 1:
            ssv.Server._pack = spy
        try:
            _, wall = _timed(lambda: srv.serve_batch(reqs))
        finally:
            ssv.Server._pack = real_pack
        warm_walls.append(wall)
    records = srv.batch_records
    launches = counts()
    replayed = {name: k.replayed for name, k in kernels.items()}
    tally = _graph_replays(srv.cache)
    want_replayed = expected_serve_launches(records, warmups=False)
    want_total = {**{name: 0 for name in kernels},
                  **expected_serve_launches(records)}
    stats = srv.cache.stats()
    groups, differ = [], []
    for op, dtype, shape, batch, a, b, s in packed:
        fn, hit = srv.cache.get_or_compile(op, shape, dtype, batch,
                                           srv.opts, srv.device)
        eager = sbm.make_batched(op, srv.opts)
        eager_ms, (xe, he, ee) = _ev_ms(lambda: eager(a, b, s))
        call_ms, (xg, hg, eg) = _ev_ms(lambda: fn(a, b, s))
        replay_ms = sum(_ev_ms(lambda g=g: g(a, b, s))[0]
                        for g in fn.graphs.values())
        same = (torch.equal(bits(xg), bits(xe)) and hg == he and eg == ee)
        row = {"op": op, "bucket": list(shape), "batch": batch,
               "route": fn.route, "graphs": sorted(fn.graphs),
               "cache_hit": hit, "bit_equal": same,
               "eager_ms": eager_ms, "callable_ms": call_ms,
               "replay_ms": replay_ms}
        if not same:
            worst = max(serve_residual(op, a[i], xg[i], b[i])
                        for i in range(batch) if hg[i].ok)
            row["worst_residual_replay"] = worst
            bound = (SERVE_LSQ_BOUND if op == "least_squares_solve"
                     else SERVE_RESIDUAL_BOUND)
            differ.append(op)
            if not worst < bound:
                failures.append(f"serve_graph: {op} {shape} b{batch} "
                                f"differs from eager past its bound")
        groups.append(row)
    # the same stream through eager callables (make_batched on the card,
    # the callables before this slice), in turns with the graphs (eager,
    # graphs, graphs, eager, twice) from an emptied allocator cache; then
    # each one profiled
    eager_cache = st.serve.ExecutableCache()
    eager_cache._compile = lambda op, shape, dtype, batch, opts, device: (
        sbm.make_batched(op, opts), 0)
    eager_srv = st.serve.Server(cache=eager_cache)
    eager_srv.serve_batch(reqs)
    torch.cuda.empty_cache()
    turns = {"eager": [], "graphs": []}
    for which in ("eager", "graphs", "graphs", "eager") * 2:
        server = eager_srv if which == "eager" else srv
        turns[which].append(_timed(lambda: server.serve_batch(reqs))[1])
    profile_device("serve stream warm (eager)",
                   lambda: eager_srv.serve_batch(reqs))
    kernels_prof = profile_device("serve stream warm (graphs)",
                                  lambda: srv.serve_batch(reqs))
    one_stream = srv.batch_records[-n_cold:]
    prof = {name: sum(1 for e in kernels_prof if name in e.name)
            for name in ("chol_panel_batched_", "lu_panel_batched_",
                         "qr_panel_batched_")}
    want_one = expected_serve_launches(one_stream, warmups=False)
    emit({"phase": "serve_graph", "requests": len(reqs),
          "wall_s_cold": wall_cold, "wall_s_warm": warm_walls,
          "problems_per_s_warm": len(reqs) / min(warm_walls),
          "wall_s_warm_turns": turns,
          "wall_s_warm_median": {k: sorted(v)[len(v) // 2]
                                 for k, v in turns.items()},
          "problems_per_s_warm_turns": {
              k: [len(reqs) / w for w in v] for k, v in turns.items()},
          "recorded_wall_s_warm_eager": EAGER_STREAM_WARM_S,
          "captures": stats["captures"], "compile_ms": stats["compile_ms"],
          "entries": stats["entries"],
          "memory_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
          "launches_total": launches, "launches_predicted": want_total,
          "replayed": replayed, "tally_x_replays": tally,
          "replayed_predicted": want_replayed,
          "profiler_launches_one_warm_stream": prof,
          "predicted_one_warm_stream": want_one,
          "groups_differing": differ})
    emit({"phase": "serve_graph_groups", "groups": groups})
    if launches != want_total:
        failures.append(f"serve_graph launches {launches} != {want_total}")
    for name in ("chol_panel_batched", "lu_panel_batched",
                 "qr_panel_batched"):
        if not (replayed[name] == tally.get(name, 0)
                == want_replayed[name]):
            failures.append(f"serve_graph: {name} replayed "
                            f"{replayed[name]}, tally x replays "
                            f"{tally.get(name, 0)}, predicted "
                            f"{want_replayed[name]}")
    if not all(r["route"] == "ragged" and r["cache_hit"] for r in groups):
        failures.append("serve_graph: a stream group left the ragged route "
                        "or missed the cache when warm")
    return srv


def check_serve_loop(st, reqs, failures):
    """serve_loop: Server.start() with 4 submitter threads sending the
    stream (flush occupancy 8, 5 ms batch delay), twice.  The loop's
    flushes group 1 to 8 requests of a bucket (no bucket of the stream
    holds more), so each bucket's graphs at batch 1, 2, 4 and 8 are
    captured first; both async passes then capture nothing.  Every ticket
    settles through result(timeout), within the stream's bounds; the count
    bit-equal to the synchronous stream, the governor's p50 and p99, the
    problems/s and health_info() are reported, and shutdown() leaves no
    serving thread."""
    import threading
    srv = st.serve.Server(cache=st.serve.ExecutableCache(),
                          admission=st.serve.AdmissionConfig(
                              max_queue=1024,
                              flush_occupancy=LOOP_OCCUPANCY,
                              max_batch_delay_ms=LOOP_DELAY_MS))
    sync = srv.serve_batch(reqs)
    keys = {(r["op"], tuple(r["bucket"]), r["dtype"])
            for r in srv.batch_records}
    t0 = time.perf_counter()
    for op, shape, dtype in sorted(keys):
        for batch in (1, 2, 4, 8):
            srv.cache.get_or_compile(op, shape, dtype, batch, srv.opts,
                                     srv.device)
    warm_s = time.perf_counter() - t0
    srv.start()
    passes = []
    try:
        for _ in range(2):
            captures0 = srv.cache.stats()["captures"]
            tickets = [None] * len(reqs)

            def submit(wid):
                for i in range(wid, len(reqs), 4):
                    tickets[i] = srv.submit(*reqs[i])
            t0 = time.perf_counter()
            threads = [threading.Thread(target=submit, args=(w,))
                       for w in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120.0)
            got = [t.result(timeout=120.0) for t in tickets]
            wall = time.perf_counter() - t0
            acc = serve_accuracy(reqs, got)
            passes.append({
                "wall_s": wall, "problems_per_s": len(reqs) / wall,
                "captures": srv.cache.stats()["captures"] - captures0,
                "settled": sum(t.done() for t in tickets),
                "bit_equal_to_sync": sum(
                    torch.equal(bits(g.x), bits(w.x))
                    for g, w in zip(got, sync)),
                "not_bit_equal": [
                    (reqs[i][0], tuple(reqs[i][1].shape))
                    for i, (g, w) in enumerate(zip(got, sync))
                    if not torch.equal(bits(g.x), bits(w.x))],
                "worst_residual": acc,
                "latency_p50_ms": srv.queue.governor.estimate_wait_ms(),
                "latency_p99_ms": srv.queue.governor.p99_ms()})
            if not (acc["solve"] < SERVE_RESIDUAL_BOUND
                    and acc["chol_solve"] < SERVE_RESIDUAL_BOUND
                    and acc["least_squares_solve"] < SERVE_LSQ_BOUND):
                failures.append(f"serve_loop residuals {acc}")
            if passes[-1]["settled"] != len(reqs):
                failures.append("serve_loop: a ticket was lost")
    finally:
        srv.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("slate-serve-")]
    emit({"phase": "serve_loop", "requests": len(reqs), "submitters": 4,
          "flush_occupancy": LOOP_OCCUPANCY,
          "max_batch_delay_ms": LOOP_DELAY_MS,
          "batch_ladder_captures_s": warm_s, "passes": passes,
          "health_info": srv.health_info(), "threads_left": left})
    if any(p["captures"] for p in passes):
        failures.append("serve_loop: a warm async pass captured a graph")
    if left:
        failures.append(f"serve_loop: threads left after shutdown {left}")


def check_serve_pool_drill(st, faults, reqs, failures):
    """serve_pool_drill: two pool members on cuda:0 sharing one cache.
    serve_device_fail on member 0 with kind nan (the device lies: caught
    by the non-finite check), then raising at dispatch: the same packed
    batch fails over to member 1, bit-equal to the no-fault run; member 0
    is quarantined and readmitted by probe(0), whose canary solve runs
    through the cache.  serve_device_slow past a 1 s dispatch deadline
    fails over the same way.  Every serve_device record is printed."""
    from slate_tpu_torch.obs import events
    sub = [r for r in reqs if r[0] == "solve" and r[1].shape[0] == 450]
    cache = st.serve.ExecutableCache()

    def pool_server(timeout_s=None):
        pool = st.serve.DevicePool(
            ["cuda:0", "cuda:0"], st.serve.PoolConfig(
                strike_limit=1, canary_interval_s=30.0,
                dispatch_timeout_s=timeout_s))
        return st.serve.Server(cache=cache, pool=pool)
    base = pool_server().serve_batch(sub)
    cases = (("nan", faults.FaultPlan("serve_device_fail", kind="nan",
                                      transient=True, device=0), None,
              "nonfinite"),
             ("exception", faults.FaultPlan("serve_device_fail", kind="inf",
                                            transient=True, device=0), None,
              "exception"),
             ("deadline", faults.FaultPlan("serve_device_slow",
                                           transient=True, device=0,
                                           delay_s=1.5), 1.0, "deadline"))
    for name, plan, timeout_s, reason in cases:
        srv = pool_server(timeout_s)
        with events.recording() as recs:
            with faults.inject(plan):
                t0 = time.perf_counter()
                got = srv.serve_batch(sub)
                wall = time.perf_counter() - t0
            quarantined = srv.pool.healthy_count() == 1
            readmitted = srv.pool.probe(0)
        left = _join_serve_threads()
        same = all(torch.equal(bits(g.x), bits(w.x))
                   for g, w in zip(got, base))
        dev = [{k: v for k, v in e.items() if k not in ("schema", "ts")}
               for e in recs if e["kind"] == "serve_device"]
        batch = [e for e in recs if e["kind"] == "serve_batch"]
        emit({"phase": "serve_pool_drill", "case": name,
              "problems": len(sub), "wall_s": wall,
              "bit_equal_to_no_fault": same, "served_by":
              [e["device_id"] for e in batch],
              "failovers": [e["failovers"] for e in batch],
              "pool": srv.pool.stats(), "serve_device_events": dev,
              "threads_left": left})
        fo = [e for e in dev if e["event"] == "failover"]
        if not (same and quarantined and readmitted and len(got) == len(sub)
                and fo and fo[0]["device_id"] == 0
                and fo[0]["reason"] == reason
                and any(e["event"] == "readmit" for e in dev)
                and all(e["device_id"] == 1 for e in batch) and not left):
            failures.append(f"serve_pool_drill {name}: bit-equal {same}, "
                            f"quarantined {quarantined}, readmitted "
                            f"{readmitted}, events {dev}, left {left}")


def check_serve_watchdog(st, faults, reqs, failures):
    """serve_watchdog: a 3 s serve_compile_stall on a cold bucket with
    watchdog_timeout_s = 1: every pending ticket fails with
    SlateServeTimeoutError reason watchdog, wedged() is set, submit raises
    and shutdown() returns; the stalled flush thread is waited out."""
    from slate_tpu_torch.exceptions import SlateServeTimeoutError
    sub = [r for r in reqs if r[0] == "chol_solve"][:4]
    srv = st.serve.Server(cache=st.serve.ExecutableCache(),
                          admission=st.serve.AdmissionConfig(
                              flush_occupancy=len(sub),
                              max_batch_delay_ms=1.0,
                              watchdog_timeout_s=1.0))
    srv.start()
    reasons, refused = [], None
    t0 = time.perf_counter()
    with faults.inject(faults.FaultPlan("serve_compile_stall",
                                        transient=True, delay_s=3.0)):
        tickets = [srv.submit(*r) for r in sub]
        for t in tickets:
            try:
                t.result(timeout=30.0)
                reasons.append("served")
            except SlateServeTimeoutError as e:
                reasons.append(e.reason)
        failed_after = time.perf_counter() - t0
        wedged = srv.wedged() is not None
        try:
            srv.submit(*sub[0])
        except SlateServeTimeoutError as e:
            refused = e.reason
        t1 = time.perf_counter()
        srv.shutdown()
        shutdown_s = time.perf_counter() - t1
    left = _join_serve_threads()
    emit({"phase": "serve_watchdog", "stall_s": 3.0,
          "watchdog_timeout_s": 1.0, "ticket_errors": reasons,
          "failed_after_s": failed_after, "wedged": wedged,
          "submit_refused": refused, "shutdown_s": shutdown_s,
          "threads_left_after_stall": left})
    if not (reasons == ["watchdog"] * len(sub) and wedged
            and refused == "wedged" and not left):
        failures.append(f"serve_watchdog: tickets {reasons}, wedged "
                        f"{wedged}, submit {refused}, left {left}")


def check_serve_retune(st, reqs, failures):
    """serve_retune: retune_now("float32") on the stream's sizes: the old
    and new rungs, both wastes, the route each fitted bucket takes (a rung
    that nb = 128 does not divide goes to the per-problem route), and the
    first flush after the swap, a group of the hottest fitted bucket,
    served from the graphs captured before the swap."""
    from slate_tpu_torch.serve import bucket as sbk
    srv = st.serve.Server(cache=st.serve.ExecutableCache(),
                          admission=st.serve.AdmissionConfig(
                              retune_interval_s=1e9, retune_min_samples=16,
                              retune_margin=0.02))
    srv.serve_batch(reqs)
    n_before = srv.cache.stats()["entries"]
    t0 = time.perf_counter()
    info = srv.retune_now("float32")
    retune_s = time.perf_counter() - t0
    if info is None:
        failures.append("serve_retune: no swap on the stream's sizes")
        return
    warmed = [k for k, _ in srv.cache.entries()[n_before:]]
    routes = {f"{k[0]} {'x'.join(map(str, k[1]))} b{k[4]}": exe.route
              for k, exe in srv.cache.entries()[n_before:]}
    lad = srv.ladder("float32")
    # the first flush after the swap: one group of the first warmed
    # bucket, as many of the stream's requests as bucket there (5 to 8
    # of them make the warmed batch of 8)
    op, (nbk, _) = warmed[0][0], warmed[0][1]
    group = [r for r in reqs if r[0] == op
             and lad.bucket_for(r[1].shape[0]) == nbk]
    if sbk.next_pow2(len(group)) != warmed[0][4]:
        failures.append(f"serve_retune: {len(group)} requests of the "
                        f"warmed bucket {warmed[0]}")
        return
    res = srv.serve_batch(group)
    first = srv.batch_records[-1]
    emit({"phase": "serve_retune", **info, "retune_s": retune_s,
          "routes_of_warmed_buckets": routes,
          "first_flush": {"op": first["op"], "bucket": first["bucket"],
                          "batch": first["batch"],
                          "cache_hit": first["cache_hit"],
                          "captures": first["captures"],
                          "route": routes.get(
                              f"{first['op']} "
                              f"{'x'.join(map(str, first['bucket']))} "
                              f"b{first['batch']}")},
          "first_flush_healthy": all(r.health.ok for r in res)})
    if not (first["cache_hit"] and first["captures"] == 0
            and all(r.health.ok for r in res)):
        failures.append(f"serve_retune: the first flush after the swap "
                        f"was not a healthy cache hit ({first})")


def check_posv_hold(st, a, b, nb, reset, counts, failures):
    """posv_hold: posv on the main path's matrix with
    Option.HoldLocalWorkspace (its Cholesky attempt captured as one CUDA
    graph): the cold wall (the capture) and the warm replay wall beside
    eager posv in the same run, X and the health bit-equal to eager's,
    K2 and K0 launches per replay (3 n / nb - 1 and n / nb - 1, as eager)
    and torch.profiler's count of them, with the device idle share of a
    warm replay and of eager posv."""
    from slate_tpu_torch.drivers import cholesky as chol
    n = a.shape[0]
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    hold = {**info, st.Option.HoldLocalWorkspace: True}
    A = st.SymmetricMatrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    _, Xe, he = st.posv(A, B, info)
    eager = [_timed(lambda: st.posv(A, B, info))[1] for _ in range(2)]
    chol._HELD.clear()
    (_, Xh, hh), cold = _timed(lambda: st.posv(A, B, hold))
    reset()
    (_, Xh2, hh2), warm1 = _timed(lambda: st.posv(A, B, hold))
    per_replay = counts()
    warm = [warm1] + [_timed(lambda: st.posv(A, B, hold))[1]
                      for _ in range(2)]
    same = (torch.equal(bits(Xh.to_dense()), bits(Xe.to_dense()))
            and torch.equal(bits(Xh2.to_dense()), bits(Xe.to_dense()))
            and hh == he and hh2 == he)
    k_hold = profile_device("posv hold warm", lambda: st.posv(A, B, hold))
    k_eager = profile_device("posv eager", lambda: st.posv(A, B, info))
    prof = {"chol_panel_fused": sum(1 for e in k_hold
                                    if "chol_panel_" in e.name
                                    and "batched" not in e.name),
            "upper_tri_inv": sum(1 for e in k_hold
                                 if "upper_tri_inv" in e.name)}
    want = {"chol_panel_fused": 3 * (n // nb) - 1,
            "upper_tri_inv": n // nb - 1}
    emit({"phase": "posv_hold", "n": n, "nb": nb,
          "wall_s_cold_capture": cold, "wall_s_warm_replay": warm,
          "wall_s_eager": eager, "bit_equal_to_eager": same,
          "health": health_row(hh), "launches_per_replay": per_replay,
          "launches_predicted": want, "profiler_launches": prof,
          "memory_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30})
    chol._HELD.clear()
    if not (same and all(per_replay[k] == v for k, v in want.items())):
        failures.append(f"posv_hold: bit-equal {same}, launches "
                        f"{per_replay}, profiler {prof} (want {want})")


def check_survival(st, reqs, kernels, reset, counts):
    """The serving survival slice's phases on the card; any miss fails the
    run after every phase printed."""
    from slate_tpu_torch.robust import faults
    failures = []
    srv = check_serve_graph(st, reqs, kernels, reset, counts, failures)
    del srv
    check_serve_loop(st, reqs, failures)
    check_serve_pool_drill(st, faults, reqs, failures)
    check_serve_watchdog(st, faults, reqs, failures)
    check_serve_retune(st, reqs, failures)
    if failures:
        raise AssertionError("serving survival: " + "; ".join(failures))


# ---------------------------------------------------- robustness phases

# NoPiv under Abft, and the bf16 rung's ill-conditioned case, at these n
ABFT_NOPIV_N = 8192
BF16_ILL_N, BF16_ILL_COND = 4096, 1e6
# the served chol_solve batch struck in abft_serving: the stream's
# chol_solve requests of this n (none of them planted), one bucket
ABFT_SERVE_N = 1900


def timed_solve(st, op, a, b, nb, opts=None):
    """One ``op`` ("posv", "gesv" or "gels") on device matrices under
    ``opts`` with ErrorPolicy.Info; returns (factor or None, X dense,
    HealthInfo, wall seconds), the matrices built before the clock."""
    A = (st.SymmetricMatrix.from_numpy(a, nb) if op == "posv"
         else st.Matrix.from_numpy(a, nb))
    B = st.Matrix.from_numpy(b, nb)
    o = {**(opts or {}), st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = getattr(st, op)(A, B, o)
    x = out[-2].to_dense()
    torch.cuda.synchronize()
    return (out[0] if len(out) == 3 else None), x, out[-1], \
        time.perf_counter() - t0


def device_busy(fn) -> float | str:
    """Device busy seconds of one ``fn()`` under torch.profiler: the union
    of its kernels' device intervals."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _timed(fn)
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return _busy_seconds(ks) if ks else "not measured"


def abft_margin(fn):
    """``fn()`` with every checksum comparison of robust/abft.py recording
    its largest |residual| / threshold on the device; returns (fn's
    result, that ratio over the whole call, read once): how far a clean
    run's rounding sits below the detection threshold."""
    from slate_tpu_torch.robust import abft
    real, seen = abft._bad, []

    def spy(d, t):
        seen.append((d.abs() / t[:, None]).amax())
        return real(d, t)
    abft._bad = spy
    try:
        out = fn()
    finally:
        abft._bad = real
    return out, (float(torch.stack(seen).max()) if seen else None)


def strike_seed(rows: int, cols: int, where, count: int = 1) -> int:
    """The first seed whose strike positions, drawn as robust/faults.py
    draws them in a [rows, cols] block, all satisfy ``where(row, col)``:
    so that a strike lands on a live element of the part of the factor it
    is meant for (a bitflip scales its element, and a zero stays zero)."""
    import numpy as np
    seed = 0
    while True:
        p = np.random.default_rng(seed).choice(rows * cols, size=count,
                                               replace=False)
        if all(where(int(x) // cols, int(x) % cols) for x in p):
            return seed
        seed += 1


def below_diagonal(r: int, c: int) -> bool:
    return r > c


def health_row(h) -> dict:
    return {"ok": h.ok, "info": h.info, "nonfinite": h.nonfinite,
            "growth": h.growth, "iters": h.iters, "converged": h.converged,
            "abft_detected": h.abft_detected,
            "abft_corrected": h.abft_corrected,
            "abft_site": ([h.abft_site >> 16, h.abft_site & 0xFFFF]
                          if h.abft_site >= 0 else None)}


def solve_ratio(a, x, b) -> float:
    """The residual certificate's ratio ||B - AX||_F / (||A||_F ||X||_F +
    ||B||_F), formed in f64 (robust/certify.py certify_solve)."""
    a64, x64, b64 = a.double(), x.double(), b.double()
    return float(torch.linalg.norm(b64 - a64 @ x64) / (
        torch.linalg.norm(a64) * torch.linalg.norm(x64)
        + torch.linalg.norm(b64)))


def check_abft_posv(st, faults, a, b, x64, nb, reset, counts, failures):
    """abft_posv: posv at full width with Option.Abft, clean beside the
    same call with Abft off (warm wall, device busy), one transient
    bitflip planted in the first diagonal tile's factor from K2 (located,
    repaired), and a transient double strike (refused, then the retry_same
    rung's clean solve).  Returns the Abft call's launches and the wall of
    the Abft-off call."""
    n = a.shape[0]
    abft = {st.Option.Abft: st.Abft.On}
    _, x_off, h_off, wall_off = timed_solve(st, "posv", a, b, nb)
    reset()
    _, x_on, h_on, wall_on = timed_solve(st, "posv", a, b, nb, abft)
    launches = counts()
    busy_off = device_busy(lambda: timed_solve(st, "posv", a, b, nb))
    busy_on = device_busy(lambda: timed_solve(st, "posv", a, b, nb, abft))
    (_, _, h_m, _), margin = abft_margin(
        lambda: timed_solve(st, "posv", a, b, nb, abft))
    res, fwd = accuracy(a, x_on, b, x64)
    want = {"chol_panel_fused": 3 * (n // nb) - 1,
            "upper_tri_inv": n // nb - 1}
    emit({"phase": "abft_posv", "case": "clean", "n": n, "nb": nb,
          "nrhs": b.shape[1], "wall_s_abft_off": wall_off,
          "wall_s_abft_on": wall_on,
          "wall_overhead": wall_on / wall_off - 1,
          "device_busy_s_abft_off": busy_off,
          "device_busy_s_abft_on": busy_on,
          "abft_detected": h_on.abft_detected,
          "abft_corrected": h_on.abft_corrected,
          "max_residual_over_threshold": margin,
          "scaled_residual": res, "residual_bound": RESIDUAL_BOUND,
          "forward_error_vs_f64": fwd, "forward_bound": FORWARD_BOUND,
          "health": health_row(h_on), "launches": launches})
    if not (res < RESIDUAL_BOUND and fwd < FORWARD_BOUND
            and torch.isfinite(x_on).all()):
        failures.append(f"abft_posv clean: residual {res}, forward {fwd}")
    if any(launches[k] != v for k, v in want.items()):
        failures.append(f"abft_posv launches {launches} (want {want})")
    seed = strike_seed(nb, nb, below_diagonal)
    plan = faults.FaultPlan("post_panel", kind="bitflip", seed=seed,
                            transient=True)
    with faults.inject(plan):
        _, x1, h1, wall1 = timed_solve(st, "posv", a, b, nb, abft)
    res1, fwd1 = accuracy(a, x1, b, x64)
    emit({"phase": "abft_posv", "case": "single_strike", "seed": seed,
          "planted_tile": [0, 0], "wall_s": wall1,
          "scaled_residual": res1, "forward_error_vs_f64": fwd1,
          "health": health_row(h1)})
    if not ((h1.abft_detected, h1.abft_corrected, h1.abft_site) == (1, 1, 0)
            and h1.ok and res1 < RESIDUAL_BOUND and fwd1 < FORWARD_BOUND):
        failures.append(f"abft_posv single strike: {health_row(h1)}, "
                        f"residual {res1}, forward {fwd1}")
    seed2 = strike_seed(nb, nb, below_diagonal, count=2)
    plan2 = faults.FaultPlan("post_panel", kind="bitflip", seed=seed2,
                             count=2, transient=True)
    with faults.inject(plan2):
        _, _, h0, _ = timed_solve(st, "posv", a, b, nb, {
            **abft, st.Option.UseFallbackSolver: False})
    with faults.inject(plan2):
        F2, x2, h2, wall2 = timed_solve(st, "posv", a, b, nb, abft)
    res2, fwd2 = accuracy(a, x2, b, x64)
    emit({"phase": "abft_posv", "case": "double_strike", "seed": seed2,
          "first_attempt": health_row(h0), "after_retry_same": health_row(h2),
          "wall_s_with_retry": wall2, "scaled_residual": res2,
          "forward_error_vs_f64": fwd2})
    if not (h0.abft_detected > h0.abft_corrected and not h0.ok and h2.ok
            and isinstance(F2, st.TriangularMatrix)
            and res2 < RESIDUAL_BOUND and fwd2 < FORWARD_BOUND):
        failures.append(f"abft_posv double strike: first {health_row(h0)}"
                        f", retried {health_row(h2)}")
    return launches, wall_off


def check_abft_gesv(st, faults, a, b, x64, nb, reset, counts, gen, nrhs,
                    failures):
    """abft_gesv: CALU gesv at full width with Option.Abft (K4 and K3
    under lu_panel_check), clean beside Abft off; a transient bitflip
    planted in U of the first panel (tile (0, 0), above the diagonal:
    located, repaired); a double strike there (refused: CALU has no rung
    below it, as in the reference); a bitflip in L of the first panel's
    row tile 120, printed as measured: on this A, whose U entries sit
    under 50 n eps of the struck value, the panel rung's threshold (the
    reference's, scaled by the struck factor's finite magnitude) lets it
    through, and the check is only that the health then reads the failure;
    then NoPiv at ABFT_NOPIV_N (K3) clean, with a single strike, and with
    a transient double strike that the retry_same rung saves.  Returns the
    Abft CALU call's launches and the Abft-off wall."""
    from slate_tpu_torch.internal.getrf import _lu_select_ok
    n = a.shape[0]
    calu = {st.Option.MethodLU: st.MethodLU.CALU}
    abft = {**calu, st.Option.Abft: st.Abft.On}
    _, _, _, wall_off = timed_solve(st, "gesv", a, b, nb, calu)
    reset()
    _, x_on, h_on, wall_on = timed_solve(st, "gesv", a, b, nb, abft)
    launches = counts()
    busy_off = device_busy(lambda: timed_solve(st, "gesv", a, b, nb, calu))
    busy_on = device_busy(lambda: timed_solve(st, "gesv", a, b, nb, abft))
    (_, _, _, _), margin = abft_margin(
        lambda: timed_solve(st, "gesv", a, b, nb, abft))
    res, fwd = accuracy(a, x_on, b, x64)
    want = expected_calu_launches(n, nb, lambda h: _lu_select_ok(
        torch.empty((1, h, nb), device="cuda"), nb))
    emit({"phase": "abft_gesv", "case": "clean", "method": "CALU", "n": n,
          "nb": nb, "wall_s_abft_off": wall_off, "wall_s_abft_on": wall_on,
          "wall_overhead": wall_on / wall_off - 1,
          "device_busy_s_abft_off": busy_off,
          "device_busy_s_abft_on": busy_on,
          "abft_detected": h_on.abft_detected,
          "abft_corrected": h_on.abft_corrected,
          "max_residual_over_threshold": margin,
          "scaled_residual": res, "residual_bound": GESV_RESIDUAL_BOUND,
          "forward_error_vs_f64": fwd, "forward_bound": GESV_FORWARD_BOUND,
          "health": health_row(h_on), "launches": launches})
    if not (res < GESV_RESIDUAL_BOUND and fwd < GESV_FORWARD_BOUND
            and torch.isfinite(x_on).all()):
        failures.append(f"abft_gesv clean: residual {res}, forward {fwd}")
    if any(launches[k] != v for k, v in want.items()):
        failures.append(f"abft_gesv launches {launches} (want {want})")
    def upper(r, c):
        return r < c
    for case, tile, count, where in (
            ("single_strike_u", (0, 0), 1, upper),
            ("double_strike_u", (0, 0), 2, upper),
            ("single_strike_l_finding", (120, 0), 1, lambda r, c: True)):
        seed = strike_seed(nb, nb, where, count)
        plan = faults.FaultPlan("post_panel", kind="bitflip", seed=seed,
                                count=count, transient=True, tile=tile,
                                nb=nb)
        opts = abft if count == 1 else {**abft,
                                        st.Option.UseFallbackSolver: False}
        with faults.inject(plan):
            _, x1, h1, wall1 = timed_solve(st, "gesv", a, b, nb, opts)
        res1, fwd1 = accuracy(a, x1, b, x64)
        emit({"phase": "abft_gesv", "case": case, "method": "CALU",
              "planted_tile": list(tile), "seed": seed, "wall_s": wall1,
              "scaled_residual": res1, "forward_error_vs_f64": fwd1,
              "health": health_row(h1)})
        good = res1 < GESV_RESIDUAL_BOUND and fwd1 < GESV_FORWARD_BOUND
        if case == "single_strike_u" and not (
                (h1.abft_detected, h1.abft_corrected) == (1, 1)
                and h1.abft_site == tile[0] * 65536 + tile[1] and h1.ok
                and good):
            failures.append(f"abft_gesv single strike: {health_row(h1)}")
        if case == "double_strike_u" and not (
                h1.abft_detected > h1.abft_corrected and not h1.ok):
            failures.append(f"abft_gesv double strike: {health_row(h1)}")
        if case == "single_strike_l_finding" and h1.ok and not good:
            failures.append(f"abft_gesv: a struck solve reads healthy "
                            f"({health_row(h1)}, residual {res1})")
    # ---- NoPiv (K3 alone) at ABFT_NOPIV_N ----
    nn = ABFT_NOPIV_N
    a_n = torch.randn(nn, nn, generator=gen, device="cuda")
    a_n.diagonal().add_(nn)                  # strictly diagonally dominant
    b_n = torch.randn(nn, nrhs, generator=gen, device="cuda")
    x64_n = torch.linalg.solve(a_n.double(), b_n.double())
    nopiv = {st.Option.MethodLU: st.MethodLU.NoPiv, st.Option.Abft: st.Abft.On}
    tile_n = (40, 0)
    nopiv_launches = None
    for case, plans in (
            ("clean", ()),
            ("single_strike", (faults.FaultPlan(
                "post_panel", kind="bitflip", seed=5, transient=True,
                tile=tile_n, nb=nb),)),
            ("double_strike_retry_same", (faults.FaultPlan(
                "post_panel", kind="bitflip", seed=5, count=2,
                transient=True, tile=tile_n, nb=nb),))):
        reset()
        with faults.inject(*plans):
            F, x1, h1, wall1 = timed_solve(st, "gesv", a_n, b_n, nb, nopiv)
        got = counts()
        nopiv_launches = nopiv_launches or got
        res1, fwd1 = accuracy(a_n, x1, b_n, x64_n)
        emit({"phase": "abft_gesv", "case": case, "method": "NoPiv",
              "n": nn, "planted_tile": list(tile_n) if plans else None,
              "wall_s": wall1, "scaled_residual": res1,
              "forward_error_vs_f64": fwd1, "health": health_row(h1),
              "launches": got})
        want_counts = {"clean": (0, 0, -1),
                       "single_strike": (1, 1, tile_n[0] * 65536),
                       "double_strike_retry_same": (0, 0, -1)}[case]
        if not ((h1.abft_detected, h1.abft_corrected, h1.abft_site)
                == want_counts and h1.ok and isinstance(F, st.LUFactors)
                and res1 < GESV_RESIDUAL_BOUND
                and fwd1 < GESV_FORWARD_BOUND):
            failures.append(f"abft_gesv NoPiv {case}: {health_row(h1)}, "
                            f"residual {res1}, forward {fwd1}")
    if nopiv_launches.get("lu_panel_fused") != 2 * (nn // nb) - 1:
        failures.append(f"abft_gesv NoPiv launches {nopiv_launches}")
    return launches, wall_off, nopiv_launches


def check_speculate_gesv(st, faults, a, b, x64, nb, reset, counts,
                         calu_wall, gen, failures):
    """speculate_gesv: Option.Speculate at full width: the RBT rung
    (getrf_rbt: K3 at the padded width, two refinement sweeps, the
    residual certificate on the original system), accepted or escalated
    to CALU, on the orthogonal A and on a diagonally dominant A (the
    NoPiv route's kind of matrix), each beside CALU's wall on the same
    matrix; then a persistent post_rbt bitflip on the dominant A, which
    the certificate catches and the pivoted chain (CALU) answers."""
    from slate_tpu_torch.internal import rbt
    from slate_tpu_torch.robust import certify
    n = a.shape[0]
    nt = rbt.padded_size(n)
    calu = {st.Option.MethodLU: st.MethodLU.CALU}
    spec = {**calu, st.Option.Speculate: st.Speculate.On}
    out = {}
    a_d = torch.randn(n, n, generator=gen, device="cuda")
    a_d.diagonal().add_(n)                   # strictly diagonally dominant
    x64_d = torch.linalg.solve(a_d.double(), b.double())
    for case, am, xm, wall_calu in (("rbt_orthogonal", a, x64, calu_wall),
                                    ("rbt_dominant", a_d, x64_d, None)):
        if wall_calu is None:
            _, _, _, wall_calu = timed_solve(st, "gesv", am, b, nb, calu)
        timed_solve(st, "gesv", am, b, nb, spec)
        reset()
        F, x, h, wall = timed_solve(st, "gesv", am, b, nb, spec)
        launches = counts()
        res, fwd = accuracy(am, x, b, xm)
        accepted = isinstance(F, st.RBTFactors)
        emit({"phase": "speculate_gesv", "case": case, "n": n, "padded": nt,
              "accepted": accepted,
              "certificate_ratio": solve_ratio(am, x, b),
              "certificate_tolerance": certify.tolerance(torch.float32, n),
              "wall_s": wall, "calu_wall_s": wall_calu,
              "scaled_residual": res, "residual_bound": GESV_RESIDUAL_BOUND,
              "forward_error_vs_f64": fwd,
              "forward_bound": GESV_FORWARD_BOUND,
              "health": health_row(h), "launches": launches})
        if not (h.ok and res < GESV_RESIDUAL_BOUND
                and fwd < GESV_FORWARD_BOUND):
            failures.append(f"speculate_gesv {case}: {health_row(h)}, "
                            f"residual {res}, forward {fwd}")
        if accepted and launches.get("lu_panel_fused") != 2 * (nt // nb) - 1:
            failures.append(f"speculate_gesv {case} launches {launches}")
        out[case] = launches
    # a post_rbt strike on the dominant A: a NaN fails the NoPiv factor
    # and escalates to the pivoted chain; a bitflip is printed as
    # measured: two refinement sweeps bring its residual under the
    # certificate's 50 n eps (0.12 at this n) while the forward error
    # stays large, and the reference's certificate accepts it
    a, x64 = a_d, x64_d
    for kind in ("nan", "bitflip"):
        with faults.inject(faults.FaultPlan("post_rbt", kind=kind)):
            F1, x1, h1, wall1 = timed_solve(st, "gesv", a, b, nb, spec)
        res1, fwd1 = accuracy(a, x1, b, x64)
        emit({"phase": "speculate_gesv",
              "case": "post_rbt_" + ("strike" if kind == "nan"
                                     else "bitflip_finding"),
              "kind": kind, "escalated": isinstance(F1, st.LUFactors),
              "wall_s": wall1, "certificate_ratio": solve_ratio(a, x1, b),
              "scaled_residual": res1, "forward_error_vs_f64": fwd1,
              "health": health_row(h1)})
        if kind == "nan" and not (
                isinstance(F1, st.LUFactors) and h1.ok
                and res1 < GESV_RESIDUAL_BOUND and fwd1 < GESV_FORWARD_BOUND):
            failures.append(f"speculate_gesv post_rbt: {health_row(h1)}")
    return out


def check_speculate_posv_bf16(st, a, b, x64, nb, gen, posv_wall, failures):
    """speculate_posv_bf16: Speculate + Precision bf16 on posv at full
    width (the f32 kernels on the bf16-rounded operand, two refinement
    sweeps in the original system, the residual certificate), beside the
    f32 posv's wall; then an SPD matrix with cond ~BF16_ILL_COND, which
    the rung cannot certify and escalates to the f32 Cholesky attempt."""
    from slate_tpu_torch.robust import certify
    n = a.shape[0]
    low = {st.Option.Speculate: st.Speculate.On,
           st.Option.Precision: st.Precision.Bf16}
    timed_solve(st, "posv", a, b, nb, low)
    _, x, h, wall = timed_solve(st, "posv", a, b, nb, low)
    res, fwd = accuracy(a, x, b, x64)
    accepted = h.iters == 2
    emit({"phase": "speculate_posv_bf16", "case": "spd", "n": n,
          "accepted": accepted, "accept_rate": float(accepted),
          "ir_sweeps": h.iters, "wall_s": wall, "f32_posv_wall_s": posv_wall,
          "certificate_ratio": solve_ratio(a, x, b),
          "certificate_tolerance": certify.tolerance(torch.float32, n),
          "scaled_residual": res, "forward_error_vs_f64": fwd,
          "health": health_row(h)})
    if not (h.ok and torch.isfinite(x).all()) or (
            not accepted and not (res < RESIDUAL_BOUND
                                  and fwd < FORWARD_BOUND)):
        failures.append(f"speculate_posv_bf16: {health_row(h)}")
    ni = BF16_ILL_N
    q = torch.linalg.qr(torch.randn(ni, ni, generator=gen,
                                    device="cuda"))[0]
    ev = torch.logspace(0, -torch.log10(torch.tensor(BF16_ILL_COND)).item(),
                        ni, device="cuda")
    ai = (q * ev) @ q.T
    ai = (ai + ai.T) / 2
    bi = torch.randn(ni, b.shape[1], generator=gen, device="cuda")
    _, xi, hi, walli = timed_solve(st, "posv", ai, bi, nb, low)
    xi64 = torch.linalg.solve(ai.double(), bi.double())
    fwdi = float((xi.double() - xi64).abs().max() / xi64.abs().max())
    emit({"phase": "speculate_posv_bf16", "case": "ill_conditioned",
          "n": ni, "cond": BF16_ILL_COND, "escalated": hi.iters == 0,
          "wall_s": walli, "forward_error_vs_f64": fwdi,
          "health": health_row(hi)})
    if not (hi.ok and hi.iters == 0 and torch.isfinite(xi).all()):
        failures.append(f"speculate_posv_bf16 ill-conditioned: "
                        f"{health_row(hi)}")


def check_speculate_gels(st, qr_gen, nb, nrhs, reset, counts, failures):
    """speculate_gels: Speculate on config 4 (200000 x 1024: the certified
    CholQR2 rung, one refinement sweep) beside the default CholQR route,
    and Speculate + Precision bf16 at GELS_SHAPE (the bf16 QR rung: K5 on
    the bf16-rounded operand, two CSNE sweeps) beside the default QR
    route; each accepted or escalated, with gels' accuracy measures."""
    out = {}
    for label, shape, opts, bounds in (
            ("cholqr2_config4", CFG4_SHAPE,
             {st.Option.Speculate: st.Speculate.On},
             (CFG4_RESIDUAL_BOUND, CFG4_FORWARD_BOUND)),
            ("qr_bf16", GELS_SHAPE,
             {st.Option.Speculate: st.Speculate.On,
              st.Option.Precision: st.Precision.Bf16},
             (GELS_RESIDUAL_BOUND, GELS_FORWARD_BOUND))):
        m, n = shape
        a, b, x64 = lstsq_problem(m, n, nrhs, qr_gen)
        _, _, _, wall_plain = timed_solve(st, "gels", a, b, nb)
        timed_solve(st, "gels", a, b, nb, opts)
        reset()
        _, x, h, wall = timed_solve(st, "gels", a, b, nb, opts)
        launches = counts()
        res, fwd = lstsq_accuracy(a, x, b, x64)
        first = 1 if label == "cholqr2_config4" else 2
        accepted = h.iters == first
        emit({"phase": "speculate_gels", "case": label, "m": m, "n": n,
              "accepted": accepted, "refinement_sweeps": h.iters,
              "wall_s": wall, "default_route_wall_s": wall_plain,
              "scaled_ne_residual": res, "residual_bound": bounds[0],
              "forward_error_vs_f64": fwd, "forward_bound": bounds[1],
              "health": health_row(h), "launches": launches})
        # an accepted bf16 rung answers to its certificate (robust/
        # certify.py), not to the f32 bounds; anything else to both
        held = label == "qr_bf16" and accepted
        if not (h.ok and torch.isfinite(x).all()) or (
                not held and not (res < bounds[0] and fwd < bounds[1])):
            failures.append(f"speculate_gels {label}: {health_row(h)}, "
                            f"residual {res}, forward {fwd}")
        if held and launches.get("qr_panel") != -(-n // nb):
            failures.append(f"speculate_gels qr_bf16 launches {launches}")
        out[label] = launches
        del a, b, x64, x
    return out


def check_abft_serving(st, faults, reqs, reset, counts, failures):
    """abft_serving: the 120-request stream under Option.Abft beside the
    plain stream (chol_solve on K6 with the in-batch rungs, the other ops
    per problem, as the reference routes them), every problem's counts;
    then the stream's chol_solve requests of n = ABFT_SERVE_N as one
    batch, clean and with one transient strike in problem 0's first
    step: that problem is repaired, its neighbours' bits untouched."""
    abft = {st.Option.Abft: st.Abft.On}
    srv, res, _ = run_stream(st, reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.serve_batch(reqs)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    reset()
    srv_a, res_a, wall_cold = run_stream(st, reqs, abft)
    launches = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv_a.serve_batch(reqs)
    torch.cuda.synchronize()
    wall_abft = time.perf_counter() - t0
    acc = serve_accuracy(reqs, res_a)
    detected = sum(r.health.abft_detected for r in res_a)
    emit({"phase": "abft_serving", "case": "stream", "requests": len(reqs),
          "wall_s_warm_plain": wall_plain, "wall_s_warm_abft": wall_abft,
          "wall_s_cold_abft": wall_cold,
          "problems_per_s_plain": len(reqs) / wall_plain,
          "problems_per_s_abft": len(reqs) / wall_abft,
          "abft_detected_total": detected,
          "abft_detected_problems": [i for i, r in enumerate(res_a)
                                     if r.health.abft_detected],
          "worst_residual": acc, "launches": launches})
    if [r.health.ok for r in res_a] != [r.health.ok for r in res]:
        failures.append("abft_serving: the Abft stream's healthy set "
                        "differs from the plain stream's")
    if not (acc["solve"] < SERVE_RESIDUAL_BOUND
            and acc["chol_solve"] < SERVE_RESIDUAL_BOUND
            and acc["least_squares_solve"] < SERVE_LSQ_BOUND):
        failures.append(f"abft_serving residuals {acc}")
    if launches["chol_panel_batched"] == 0 or launches["lu_panel_batched"] \
            or launches["qr_panel_batched"]:
        failures.append(f"abft_serving routes: launches {launches}")
    sub = [r for r in reqs if r[0] == "chol_solve"
           and r[1].shape[0] == ABFT_SERVE_N]
    srv_s = st.serve.Server(abft, cache=st.serve.ExecutableCache())
    clean = srv_s.serve_batch(sub)
    bucket = srv_s.batch_records[-1]["bucket"][0]
    nb = min(128, bucket)
    seed = strike_seed(bucket, nb,
                       lambda r, c: c < r < ABFT_SERVE_N)
    with faults.inject(faults.FaultPlan("post_panel", kind="bitflip",
                                        seed=seed, transient=True,
                                        tile=(0, 0))):
        hit = srv_s.serve_batch(sub)
    struck = [i for i, r in enumerate(hit) if r.health.abft_detected]
    untouched = all(torch.equal(bits(h.x), bits(c.x))
                    for i, (h, c) in enumerate(zip(hit, clean))
                    if i not in struck)
    diff = max((float((hit[i].x - clean[i].x).abs().max()
                      / clean[i].x.abs().max()) for i in struck),
               default=None)
    emit({"phase": "abft_serving", "case": "chol_solve_batch_strike",
          "n": ABFT_SERVE_N, "bucket": bucket, "problems": len(sub),
          "seed": seed, "struck": struck,
          "health": [health_row(r.health) for r in hit],
          "neighbours_bit_equal": untouched,
          "struck_rel_diff_vs_clean": diff})
    if not (len(struck) == 1 and hit[struck[0]].health.abft_corrected == 1
            and hit[struck[0]].health.ok and untouched
            and diff is not None and diff <= 1e-4):
        failures.append(f"abft_serving strike: struck {struck}, "
                        f"neighbours bit-equal {untouched}, diff {diff}")
    return launches


def check_robustness(st, gen, qr_gen, serve_reqs, nb, nrhs, n, reset,
                     counts, trace: bool) -> dict:
    """The robustness phases (Option.Abft, the fault sites and
    Option.Speculate) on the main paths at full width; every phase prints
    before the checks decide, and any miss fails the run.  Returns the
    launch counts of the paths they drive."""
    from slate_tpu_torch.robust import faults
    failures = []
    g = torch.randn(n, n, generator=gen, device="cuda")
    a = g @ g.T
    del g
    a.diagonal().add_(n)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    x64 = solve_f64(a, b)
    out = {}
    out["abft_posv"], posv_wall = check_abft_posv(
        st, faults, a, b, x64, nb, reset, counts, failures)
    if trace:
        profile_device("posv abft", lambda: timed_solve(
            st, "posv", a, b, nb, {st.Option.Abft: st.Abft.On}))
    check_speculate_posv_bf16(st, a, b, x64, nb, gen, posv_wall, failures)
    del a, b, x64
    a = orthogonal(n, gen)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    x64 = torch.linalg.solve(a.double(), b.double())
    out["abft_gesv_calu"], calu_wall, out["abft_gesv_nopiv"] = \
        check_abft_gesv(st, faults, a, b, x64, nb, reset, counts, gen, nrhs,
                        failures)
    if trace:
        profile_device("gesv CALU abft", lambda: timed_solve(
            st, "gesv", a, b, nb, {st.Option.MethodLU: st.MethodLU.CALU,
                                   st.Option.Abft: st.Abft.On}))
    out.update({f"speculate_gesv_{k}": v for k, v in check_speculate_gesv(
        st, faults, a, b, x64, nb, reset, counts, calu_wall, gen,
        failures).items()})
    del a, b, x64
    out.update({f"speculate_gels_{k}": v for k, v in check_speculate_gels(
        st, qr_gen, nb, nrhs, reset, counts, failures).items()})
    out["abft_serving"] = check_abft_serving(st, faults, serve_reqs, reset,
                                             counts, failures)
    if failures:
        raise AssertionError("robustness: " + "; ".join(failures))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=20480)
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--nrhs", type=int, default=128)
    ap.add_argument("--trace", action="store_true",
                    help="also break one warm posv, one warm CALU gesv, "
                         "one warm QR gels and one warm serving stream down "
                         "by phase and kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import slate_tpu_torch as st
    from slate_tpu_torch.internal.chol_kernels import (CHOL_PANEL,
                                                       CHOL_PANEL_BATCHED,
                                                       CHOL_TILE)
    from slate_tpu_torch.internal.getrf import _lu_select_ok
    from slate_tpu_torch.internal.kernels import build_all
    from slate_tpu_torch.internal.lu_kernels import (LU_PANEL,
                                                     LU_PANEL_BATCHED,
                                                     LU_SELECT)
    from slate_tpu_torch.internal.qr_kernels import QR_PANEL, QR_PANEL_BATCHED
    from slate_tpu_torch.internal.tri_inv import TRI_INV
    kernels = {"upper_tri_inv": TRI_INV, "chol_tile": CHOL_TILE,
               "chol_panel_fused": CHOL_PANEL, "lu_panel_fused": LU_PANEL,
               "lu_select": LU_SELECT, "qr_panel": QR_PANEL,
               "chol_panel_batched": CHOL_PANEL_BATCHED,
               "lu_panel_batched": LU_PANEL_BATCHED,
               "qr_panel_batched": QR_PANEL_BATCHED}

    # a kernel's launches are its wrapper's eager ones and those its CUDA
    # graphs' replays ran (the capture's tally once a replay)
    def reset():
        for k in kernels.values():
            k.launches = k.replayed = 0

    def counts():
        return {name: k.launches + k.replayed for name, k in kernels.items()}

    card = card_line()
    print(card, flush=True)
    t_start = t0 = time.perf_counter()
    build_all(kernels.values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    for name, k in kernels.items():
        log = k.library_path().with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        emit({"phase": "ptxas", "kernel": name,
              "lines": [ln.strip() for ln in lines
                        if "registers" in ln or "spill" in ln]})

    # the Cholesky and LU phases draw from one stream, the QR phases from
    # their own (seeded from --seed too), so that no QR draw moves an
    # earlier phase's matrices, nor an earlier phase's draw a QR one's
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    qr_gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    serve_gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    # K1's tiles at n = 32 and 96 and its indefinite tile: a sixth
    rows = check_kernels(gen, torch.Generator(device="cuda").manual_seed(
        args.seed + 5))
    # K4's tie chunk: a seventh generator; K3's panels at W = 10240 and
    # 128 and its zero-pivot tiles: an eighth
    rows.update(check_lu_kernels(
        gen, torch.Generator(device="cuda").manual_seed(args.seed + 6),
        torch.Generator(device="cuda").manual_seed(args.seed + 7)))
    # the cluster edges of K5 and K8 draw from a generator of their own, so that the QR and serving phases keep their matrices
    edge_gen = torch.Generator(device="cuda").manual_seed(args.seed + 3)
    rows.update(check_qr_kernels(qr_gen, edge_gen))
    rows.update(check_serve_kernels(serve_gen, edge_gen))
    # K2's late panels and K0's pivoted U: a fifth generator
    check_k2_k0_edges(torch.Generator(device="cuda").manual_seed(
        args.seed + 4))

    # ---- main path: posv at full width ----
    n, nb, nrhs = args.n, args.nb, args.nrhs
    g = torch.randn(n, n, generator=gen, device="cuda")
    a = g @ g.T
    del g
    a.diagonal().add_(n)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    reset()
    x, wall = run_posv(st, a, b, nb)
    main_launches = counts()
    _, wall_repeat = run_posv(st, a, b, nb)
    x64 = solve_f64(a, b)
    res, fwd = accuracy(a, x, b, x64)
    flops = op_flops("posv", (n, n), (n, nrhs))
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
    # K2: update, factor and solve a panel, no solve on the last
    want = {**{name: 0 for name in kernels},
            "chol_panel_fused": 3 * (n // nb) - 1,
            "upper_tri_inv": n // nb - 1}
    if main_launches != want:
        raise AssertionError(f"posv launches {main_launches} != {want}")
    del x, x64, x_tf
    if args.trace:
        trace_posv(st, a, b, nb)
    # ---- posv with Option.HoldLocalWorkspace: the attempt as one graph ----
    hold_failures = []
    check_posv_hold(st, a, b, nb, reset, counts, hold_failures)
    if hold_failures:
        raise AssertionError("; ".join(hold_failures))
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
    reset()
    with st.plan_override("potrf_panel", st.LIBRARY_PLAN):
        x_t, wall_t = run_posv(st, a_t, b_t, nb)
    tile_launches = counts()
    res_t, fwd_t = accuracy(a_t, x_t, b_t, solve_f64(a_t, b_t))
    emit({"phase": "posv_tile_route", "n": nt, "nb": nb, "wall_s": wall_t,
          "scaled_residual": res_t, "forward_error_vs_f64": fwd_t,
          "launches": tile_launches})
    want_t = {**{name: 0 for name in kernels}, "chol_tile": nt // nb}
    if (tile_launches != want_t or not res_t < RESIDUAL_BOUND
            or not fwd_t < FORWARD_BOUND):
        raise AssertionError(f"tile route: launches {tile_launches} (want "
                             f"{want_t}), residual {res_t}, forward {fwd_t}")

    del a_t, b_t, x_t

    # ---- the LU path at full width: gesv with CALU ----
    calu = {st.Option.MethodLU: st.MethodLU.CALU}
    a = orthogonal(n, gen)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    reset()
    F, x, wall = run_gesv(st, a, b, nb, calu)
    calu_launches = counts()
    perm, calu_growth = F.perm, growth(F, a)
    del F
    _, _, wall_repeat = run_gesv(st, a, b, nb, calu)
    x64 = torch.linalg.solve(a.double(), b.double())
    res, fwd = accuracy(a, x, b, x64)
    flops = op_flops("gesv", (n, n), (n, nrhs))
    emit({"phase": "gesv_calu", "n": n, "nb": nb, "nrhs": nrhs,
          "dtype": "float32", "wall_s": wall, "wall_s_repeat": wall_repeat,
          "gflops": flops / wall / 1e9,
          "gflops_repeat": flops / wall_repeat / 1e9,
          "scaled_residual": res, "residual_bound": GESV_RESIDUAL_BOUND,
          "forward_error_vs_f64": fwd, "forward_bound": GESV_FORWARD_BOUND,
          "pivot_growth": calu_growth, "launches": calu_launches,
          "card": card})
    _, x_tf, _ = tf32(lambda: run_gesv(st, a, b, nb, calu))
    res_tf, fwd_tf = accuracy(a, x_tf, b, x64)
    emit({"phase": "gesv_calu_tf32_control", "n": n,
          "scaled_residual": res_tf, "forward_error_vs_f64": fwd_tf})
    if not (torch.isfinite(x).all() and x.shape == (n, nrhs)
            and torch.equal(torch.sort(perm).values,
                            torch.arange(n, device="cuda"))):
        raise AssertionError("gesv: non-finite or misshapen solution, or "
                             "perm is not a permutation")
    if not (res < GESV_RESIDUAL_BOUND and fwd < GESV_FORWARD_BOUND):
        raise AssertionError(f"gesv: scaled residual {res} (bound "
                             f"{GESV_RESIDUAL_BOUND}), forward error {fwd} "
                             f"(bound {GESV_FORWARD_BOUND})")
    if not (res_tf > GESV_RESIDUAL_BOUND and fwd_tf > GESV_FORWARD_BOUND):
        raise AssertionError("the gesv accuracy bounds do not catch TF32 "
                             f"products: residual {res_tf}, forward {fwd_tf}")
    # every round at this size fits K4's slab (5120-row chunks at most)
    want = {**{name: 0 for name in kernels},
            **expected_calu_launches(n, nb, lambda h: _lu_select_ok(
                torch.empty((1, h, nb), device="cuda"), nb))}
    if calu_launches != want:
        raise AssertionError(f"gesv CALU launches {calu_launches} != {want}")
    del x, x_tf
    if args.trace:
        trace_gesv(st, a, b, nb, calu)

    # ---- the library route: gesv's default method, PartialPiv ----
    # alone: the pivot growth of an orthogonal matrix this size lies near
    # the ladder's limit, past which the default gesv would go on to CALU
    pp = {st.Option.MethodLU: st.MethodLU.PartialPiv,
          st.Option.UseFallbackSolver: False,
          st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    reset()
    F, x, wall_pp = run_gesv(st, a, b, nb, pp)
    pp_launches = counts()
    pp_growth = growth(F, a)
    del F
    _, _, wall_pp_repeat = run_gesv(st, a, b, nb, pp)
    res_pp, fwd_pp = accuracy(a, x, b, x64)
    emit({"phase": "gesv_partialpiv_library_route", "n": n,
          "wall_s": wall_pp, "wall_s_repeat": wall_pp_repeat,
          "gflops_repeat": flops / wall_pp_repeat / 1e9,
          "scaled_residual": res_pp, "forward_error_vs_f64": fwd_pp,
          "pivot_growth": pp_growth, "launches": pp_launches})
    if (any(pp_launches.values()) or not res_pp < GESV_RESIDUAL_BOUND
            or not fwd_pp < GESV_FORWARD_BOUND):
        raise AssertionError(f"PartialPiv gesv: launches {pp_launches} "
                             f"(want none), residual {res_pp}, forward "
                             f"{fwd_pp}")
    del a, b, x, x64

    # ---- the NoPiv route: K3 on every panel ----
    nn = 8192
    a_n = torch.randn(nn, nn, generator=gen, device="cuda")
    a_n.diagonal().add_(nn)                  # strictly diagonally dominant
    b_n = torch.randn(nn, nrhs, generator=gen, device="cuda")
    reset()
    _, x_n, wall_n = run_gesv(st, a_n, b_n, nb,
                              {st.Option.MethodLU: st.MethodLU.NoPiv})
    nopiv_launches = counts()
    res_n, fwd_n = accuracy(a_n, x_n, b_n,
                            torch.linalg.solve(a_n.double(), b_n.double()))
    emit({"phase": "gesv_nopiv_route", "n": nn, "nb": nb, "wall_s": wall_n,
          "scaled_residual": res_n, "forward_error_vs_f64": fwd_n,
          "launches": nopiv_launches})
    want_n = {**{name: 0 for name in kernels},
              "lu_panel_fused": 2 * (nn // nb) - 1}
    if (nopiv_launches != want_n or not res_n < GESV_RESIDUAL_BOUND
            or not fwd_n < GESV_FORWARD_BOUND):
        raise AssertionError(f"NoPiv route: launches {nopiv_launches} (want "
                             f"{want_n}), residual {res_n}, forward {fwd_n}")
    del a_n, b_n, x_n

    # ---- a small CALU solve held against the same solve on the CPU ----
    a_s = orthogonal(ns, gen)
    b_s = torch.randn(ns, 4, generator=gen, device="cuda")
    F_g, x_g, _ = run_gesv(st, a_s, b_s, nb, calu)
    F_c, X_c = st.gesv(st.Matrix.from_numpy(a_s.cpu(), nb, device="cpu"),
                       st.Matrix.from_numpy(b_s.cpu(), nb, device="cpu"),
                       calu)
    x_c = X_c.to_dense()
    diff = float((x_g.cpu() - x_c).abs().max() / x_c.abs().max())
    same_perm = bool(torch.equal(F_g.perm.cpu(), F_c.perm))
    emit({"phase": "gesv_calu_vs_cpu", "n": ns, "rel_max_diff": diff,
          "tol": 1e-4, "perm_equal": same_perm})
    if not (diff <= 1e-4 and same_perm):
        raise AssertionError(f"CALU gesv on the card vs the CPU: {diff} > "
                             f"1e-4 or perm differs ({same_perm})")

    del a_s, b_s, x_g, F_g, F_c, X_c, x_c

    # ---- the QR path at full width: gels, Householder QR with K5 ----
    mq, nq = GELS_SHAPE
    a, b, x64 = lstsq_problem(mq, nq, nrhs, qr_gen)
    reset()
    x, wall = run_gels(st, a, b, nb)
    qr_launches = counts()
    _, wall_repeat = run_gels(st, a, b, nb)
    res, fwd = lstsq_accuracy(a, x, b, x64)
    flops = op_flops("gels", (mq, nq), (mq, nrhs))
    emit({"phase": "gels_qr", "m": mq, "n": nq, "nb": nb, "nrhs": nrhs,
          "dtype": "float32", "wall_s": wall, "wall_s_repeat": wall_repeat,
          "gflops": flops / wall / 1e9,
          "gflops_repeat": flops / wall_repeat / 1e9,
          "scaled_ne_residual": res, "residual_bound": GELS_RESIDUAL_BOUND,
          "forward_error_vs_f64": fwd, "forward_bound": GELS_FORWARD_BOUND,
          "launches": qr_launches, "card": card})
    x_tf, _ = tf32(lambda: run_gels(st, a, b, nb))
    res_tf, fwd_tf = lstsq_accuracy(a, x_tf, b, x64)
    emit({"phase": "gels_qr_tf32_control", "m": mq, "n": nq,
          "scaled_ne_residual": res_tf, "forward_error_vs_f64": fwd_tf})
    if not (torch.isfinite(x).all() and x.shape == (nq, nrhs)):
        raise AssertionError("gels: non-finite or misshapen solution")
    if not (res < GELS_RESIDUAL_BOUND and fwd < GELS_FORWARD_BOUND):
        raise AssertionError(f"gels: scaled residual {res} (bound "
                             f"{GELS_RESIDUAL_BOUND}), forward error {fwd} "
                             f"(bound {GELS_FORWARD_BOUND})")
    if not (res_tf > GELS_RESIDUAL_BOUND and fwd_tf > GELS_FORWARD_BOUND):
        raise AssertionError("the gels accuracy bounds do not catch TF32 "
                             f"products: residual {res_tf}, forward {fwd_tf}")
    # one K5 launch a panel, every panel inside the gate at nb = 128
    want = {**{name: 0 for name in kernels}, "qr_panel": -(-nq // nb)}
    if qr_launches != want:
        raise AssertionError(f"gels QR launches {qr_launches} != {want}")
    del x, x_tf
    if args.trace:
        trace_gels(st, a, b, nb)
    del a, b, x64

    # ---- BASELINE config 4, cut to f32 and one card: 200000 x 1024 ----
    m4, n4 = CFG4_SHAPE
    a, b, x64 = lstsq_problem(m4, n4, nrhs, qr_gen)
    cfg4 = {}
    for route, opts, want4 in (
            ("cholqr_default", None,
             {"chol_panel_fused": 3 * (n4 // nb) - 1,
              "upper_tri_inv": n4 // nb - 1}),
            ("qr_forced", {st.Option.MethodGels: st.MethodGels.QR}, {})):
        reset()
        x, wall = run_gels(st, a, b, nb, opts)
        launches = counts()
        _, wall_repeat = run_gels(st, a, b, nb, opts)
        res, fwd = lstsq_accuracy(a, x, b, x64)
        x_tf, _ = tf32(lambda: run_gels(st, a, b, nb, opts))
        res_tf, fwd_tf = lstsq_accuracy(a, x_tf, b, x64)
        cfg4[route] = launches
        emit({"phase": f"gels_config4_{route}", "m": m4, "n": n4, "nb": nb,
              "nrhs": nrhs, "wall_s": wall, "wall_s_repeat": wall_repeat,
              "gflops_repeat": op_flops("gels", (m4, n4), (m4, nrhs))
              / wall_repeat / 1e9,
              "scaled_ne_residual": res, "residual_bound": CFG4_RESIDUAL_BOUND,
              "forward_error_vs_f64": fwd, "forward_bound": CFG4_FORWARD_BOUND,
              "tf32_scaled_ne_residual": res_tf,
              "tf32_forward_error_vs_f64": fwd_tf, "launches": launches})
        want4 = {**{name: 0 for name in kernels}, **want4}
        if (launches != want4 or not res < CFG4_RESIDUAL_BOUND
                or not fwd < CFG4_FORWARD_BOUND):
            raise AssertionError(f"config 4 {route}: launches {launches} "
                                 f"(want {want4}), residual {res}, forward "
                                 f"{fwd}")
        if not (res_tf > CFG4_RESIDUAL_BOUND and fwd_tf > CFG4_FORWARD_BOUND):
            raise AssertionError(f"config 4 {route}: the bounds do not catch "
                                 f"TF32 products: residual {res_tf}, "
                                 f"forward {fwd_tf}")
        del x, x_tf
    del a, b, x64

    # ---- small QR checks held against the CPU ----
    check_qr_small(st, qr_gen, nb)

    # ---- the serving path: serve.Server over K6, K7 and K8 ----
    serve_launches, serve_reqs = check_serving(st, serve_gen, kernels,
                                               reset, counts)
    if args.trace:
        trace_serve(st, serve_reqs)
    # ---- the survival layer: graphs, the loop, the pool, the watchdog ----
    check_survival(st, serve_reqs, kernels, reset, counts)

    # ---- robustness: Abft, the fault sites and Speculate (--seed + 8) ----
    robust_launches = check_robustness(
        st, torch.Generator(device="cuda").manual_seed(args.seed + 8),
        torch.Generator(device="cuda").manual_seed(args.seed + 9),
        serve_reqs, nb, nrhs, n, reset, counts, args.trace)
    del serve_reqs

    # ---- the record ----
    emit({"launch_counts": {"posv": main_launches,
                            "posv_tile_route": tile_launches,
                            "gesv_calu": calu_launches,
                            "gesv_nopiv_route": nopiv_launches,
                            "gesv_partialpiv_library_route": pp_launches,
                            "gels_qr": qr_launches,
                            "gels_config4_cholqr_default":
                                cfg4["cholqr_default"],
                            "gels_config4_qr_forced": cfg4["qr_forced"],
                            **serve_launches, **robust_launches}})
    replaces = {
        "upper_tri_inv": ("slate_tpu_torch/csrc/tri_inv.cu",
                          "slate_tpu/internal/pallas_tri.py:28", "posv",
                          main_launches),
        "chol_tile": ("slate_tpu_torch/csrc/chol_tile.cu",
                      "slate_tpu/internal/pallas_chol.py:320",
                      "posv_tile_route", tile_launches),
        "chol_panel_fused": ("slate_tpu_torch/csrc/chol_panel.cu",
                             "slate_tpu/internal/pallas_chol.py:180", "posv",
                             main_launches),
        "lu_panel_fused": ("slate_tpu_torch/csrc/lu_panel.cu",
                           "slate_tpu/internal/pallas_lu.py:217",
                           "gesv_calu", calu_launches),
        "lu_select": ("slate_tpu_torch/csrc/lu_select.cu",
                      "slate_tpu/internal/pallas_lu.py:346", "gesv_calu",
                      calu_launches),
        "qr_panel": ("slate_tpu_torch/csrc/qr_panel.cu",
                     "slate_tpu/internal/pallas_qr.py:129", "gels_qr",
                     qr_launches),
        "chol_panel_batched": ("slate_tpu_torch/csrc/chol_panel_batched.cu",
                               "slate_tpu/internal/pallas_chol.py:286",
                               "serve_ragged", serve_launches["serve_ragged"]),
        "lu_panel_batched": ("slate_tpu_torch/csrc/lu_panel_batched.cu",
                             "slate_tpu/internal/pallas_lu.py:308",
                             "serve_ragged", serve_launches["serve_ragged"]),
        "qr_panel_batched": ("slate_tpu_torch/csrc/qr_panel_batched.cu",
                             "slate_tpu/internal/pallas_qr.py:154",
                             "serve_ragged", serve_launches["serve_ragged"]),
    }
    line = []
    for name, (source, ref, path, launches) in replaces.items():
        r = rows[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": ref, "launches": launches[name],
                     "path": path,
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"],
                     **{k: r[k] for k in ("cluster", "bitwise_repeatable",
                                          "batch_invariant", "plan",
                                          "k2_launch_ms", "k3_launch_ms",
                                          "k6_launch_ms", "k7_launch_ms",
                                          "k0_ms", "wrapper_ms",
                                          "library_cholesky_ms",
                                          "library_device_ms")
                        if k in r}})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
