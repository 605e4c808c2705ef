"""Autotuner: measure candidate (kernel, bw, nb) plans, persist the winners
(port of slate_tpu/tune/autotune.py).

One measurement builds the reference's problem for the op at size n (its
shapes, its flop count, its library route) on the device it is given,
from an explicit ``torch.Generator``, runs the candidate once to warm it
up (kernel builds, library set-up), then takes the best of ``iters``
timed runs: CUDA events on the card, the host clock on the CPU.  The
library routes are ``cholesky_ex`` (no host sync), ``lu_factor_ex(pivot
=False)`` on the card (the library branch of ``getrf.panel_lu_nopiv`` on
the CPU, which has no unpivoted LU), the pivoted ``lu_factor_ex`` for the
pivot selection, ``householder_panel_blocked`` and the batched library
calls.  A "cuda" candidate appears only where the kernel's own gate
accepts the shape; on CPU tensors every kernel wrapper runs its plain
version, which takes any shape, so tuning there only exercises the
machinery.  Winners go to the plan cache through plans.record_plan, and
the dispatch seams read them back through resolve_plan.  Re-tune a card
with ``python -m slate_tpu_torch.tune``.

Every entry point takes ``device``: None means CUDA, which raises without
a GPU; tests pass ``"cpu"``.

The serving ladder's fitter (``serve_ladder_from_sizes``, ``ladder_waste``)
also feeds the live server's online retune (serve/server.py
``retune_now``): rungs minimize the total padded area (the sum over
requests of rung^2) by dynamic programming over the distinct tile-rounded
sizes.
"""

from __future__ import annotations

import collections
import time

import torch

from .plans import (BATCH_OPS, LIBRARY_PLAN, OPS, SERVE_BUCKET_OP, TilePlan,
                    chip_kind, record_plan)

CANDIDATE_NB = (128, 256, 512)
CANDIDATE_BW = (8, 16)
_SEED = 0
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _device(device) -> torch.device:
    """The device to tune on: CUDA unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("slate_tpu_torch.tune: no CUDA device; pass "
                               "device='cpu' to tune on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _kernel_fits(op: str, n: int, nb: int, bw: int,
                 device: torch.device) -> bool:
    """Does the op's hand kernel take the reference's problem at (n, nb,
    bw) on ``device``?  On the CPU the plain versions take any shape; on
    the card the kernel answers (K1 tiles up to 1024, K2, K3, K4 and K5
    panels and K6, K7 and K8 batch panels up to 512: the reference's own
    candidates)."""
    if device.type == "cpu":
        return True
    from ..internal import chol_kernels, lu_kernels, qr_kernels
    from ..internal.kernels import fits
    from ..internal.qr import QR_PANEL_MAX_ELEMS
    if op == "potrf_tile":
        return chol_kernels.tile_fits_on(device, n)
    if op == "potrf_panel":
        return chol_kernels.panel_fits(device, nb)
    if op == "getrf_panel":
        return lu_kernels.panel_fits(device, nb, bw)
    if op == "lu_select":
        return lu_kernels.select_fits(device, n, nb, bw)
    if op == "geqrf_panel":
        return (n * nb <= QR_PANEL_MAX_ELEMS
                and qr_kernels.panel_fits(device, n, nb, bw))
    if op == "batch_geqrf":
        return qr_kernels.batched_panel_fits(device, n, nb, bw)
    kern = (chol_kernels.CHOL_PANEL_BATCHED if op == "batch_potrf"
            else lu_kernels.LU_PANEL_BATCHED)
    return fits(kern, f"slate_{kern.name}_fits", device, nb, bw)


def candidates(op: str, n: int, dtype: str = "float32",
               device=None) -> list[TilePlan]:
    """The search space for one (op, n, dtype): always the library route,
    plus every (nb, bw) pair of the reference's rule that the op's kernel
    takes on ``device``.  The batch ops take bf16 storage too (f32
    accumulation inside K6-K8), so they sweep kernel candidates for bf16;
    every other kernel is f32 only."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (known: {OPS})")
    dev = _device(device)
    plans = [TilePlan("torch", 8, min(n, 512))]
    batch = op in BATCH_OPS
    if dtype != "float32" and not (batch and dtype == "bfloat16"):
        return plans
    if op in ("potrf_tile", "lu_select"):
        nbs = [n] if n % 128 == 0 and 128 <= n <= 1024 else []
    else:
        nbs = [nb for nb in CANDIDATE_NB if nb <= n and n % nb == 0]
    for nb in nbs:
        # the QR kernels' slab width is not a tuning knob
        bws = ((8,) if op in ("geqrf_panel", "batch_geqrf")
               else tuple(bw for bw in CANDIDATE_BW if nb % bw == 0))
        plans.extend(TilePlan("cuda", bw, nb) for bw in bws
                     if _kernel_fits(op, n, nb, bw, dev))
    return plans


def _spd(g: torch.Tensor) -> torch.Tensor:
    s = g.shape[0]
    return g @ g.T + s * torch.eye(s, dtype=g.dtype, device=g.device)


def _problem(op: str, plan: TilePlan, n: int, dtype: str = "float32",
             device=None):
    """Returns (thunk, flops): a zero-argument runner of the candidate on
    the reference's problem for (op, n), built on ``device``, and the
    nominal flop count it performs.  ``dtype`` reaches the batch ops
    only (the single-problem kernels are f32 only, see candidates());
    their library routes compute in f32 as the serving route does."""
    from ..internal import batched, getrf, qr, trsm
    from ..internal.chol_kernels import chol_panel_fused, chol_tile
    from ..internal.lu_kernels import lu_panel_fused, lu_select
    from ..internal.qr_kernels import qr_panel
    from .plans import plan_override

    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(_SEED)
    f32 = torch.float32

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=f32)

    nb = min(plan.nb, n)
    cuda = plan.kernel == "cuda"

    if op == "potrf_tile":
        a = _spd(randn(n, n))
        if cuda:
            return (lambda: chol_tile(a, bw=plan.bw)), n ** 3 / 3
        return (lambda: torch.linalg.cholesky_ex(a)[0]), n ** 3 / 3

    if op == "potrf_panel":
        # the reference's panel: A = G G^T + n I's first block column, the
        # left factor its diagonal block's Cholesky factor tiled down the
        # rows (the update's K = nb); only that block column is formed
        g = randn(n, n)
        col = g @ g[:nb].T
        col[:nb] += n * torch.eye(nb, dtype=f32, device=dev)
        del g
        llead = torch.linalg.cholesky_ex(col[:nb])[0]
        left = llead.repeat(n // nb, 1)
        lead = llead.T.contiguous()
        flops = 2 * n * nb * nb + nb ** 3 / 3 + (n - nb) * nb ** 2
        if cuda:
            return (lambda: chol_panel_fused(col, left, lead, bw=plan.bw)), \
                flops

        def library():
            upd = col - left @ lead
            lkk = torch.linalg.cholesky_ex(upd[:nb])[0]
            return upd, torch.cat([lkk, upd[nb:] @ trsm.tri_inv_lower(lkk).T])
        return library, flops

    if op == "getrf_panel":
        p = randn(n, nb)
        p[:nb] += nb * torch.eye(nb, dtype=f32, device=dev)
        if cuda:
            return (lambda: lu_panel_fused(p, bw=plan.bw)), n * nb ** 2
        if dev.type == "cuda":
            return (lambda: torch.linalg.lu_factor_ex(p, pivot=False)[0]), \
                n * nb ** 2

        def library_cpu():
            with plan_override("getrf_panel", LIBRARY_PLAN):
                return getrf.panel_lu_nopiv(p)[0]
        return library_cpu, n * nb ** 2

    if op == "lu_select":
        chunk = randn(n, nb)[None]
        if cuda:
            return (lambda: lu_select(chunk, bw=plan.bw)), n * nb ** 2
        return (lambda: getrf.panel_lu(chunk)[1][:, :nb]), n * nb ** 2

    if op == "geqrf_panel":
        panel = randn(n, nb)
        if cuda:
            return (lambda: qr_panel(panel, bw=plan.bw)), 2 * n * nb ** 2
        return (lambda: qr.householder_panel_blocked(panel)), 2 * n * nb ** 2

    if op in BATCH_OPS:
        # a representative ragged bucket: B identity-augmented slots whose
        # live sizes sweep the bucket (serve/server.py's packing), flops
        # counted over LIVE work only, so that both routes report
        # waste-adjusted throughput against the same denominator
        bsz = 8
        sizes = [max(1, ((i + 1) * n) // bsz) for i in range(bsz)]
        a = torch.zeros((bsz, n, n), dtype=f32, device=dev)
        for i, s in enumerate(sizes):
            g = randn(s, s)
            if op == "batch_potrf":
                a[i, :s, :s] = _spd(g)
            elif op == "batch_getrf":
                a[i, :s, :s] = g + s * torch.eye(s, dtype=f32, device=dev)
            else:
                a[i, :s, :s] = g
            idx = torch.arange(s, n, device=dev)
            a[i, idx, idx] = 1.0                 # identity augmentation
        live = torch.tensor(sizes, dtype=torch.float64)
        if op == "batch_geqrf":
            # problem-granular raggedness: live slots factor the whole
            # bucket panel, slot 0 is a zero filler the kernel passes
            sizes = [0] + [n] * (bsz - 1)
            a[0] = 0.0
            flops = 2 * n ** 3 / 3 * (bsz - 1)
        elif op == "batch_potrf":
            flops = float((live ** 3).sum()) / 3
        else:
            flops = 2 * float((live ** 3).sum()) / 3
        aj = a.to(_DTYPES[dtype])
        del a
        sj = torch.tensor(sizes, dtype=torch.int32, device=dev)
        if op == "batch_potrf":
            if cuda:
                def run():
                    return batched.batch_potrf(aj, sj, nb=nb, bw=plan.bw)[0]
            else:
                def run():
                    return torch.linalg.cholesky_ex(aj.float())[0].to(
                        aj.dtype)
        elif op == "batch_getrf":
            if cuda:
                def run():
                    return batched.batch_getrf(aj, sj, nb=nb, bw=plan.bw)
            else:
                def run():
                    return torch.linalg.lu_factor_ex(aj.float())[0].to(
                        aj.dtype)
        else:
            if cuda:
                def run():
                    return batched.batch_geqrf(aj, sj, nb=nb, bw=plan.bw)[0]
            else:
                def run():
                    return torch.linalg.qr(aj.float(), mode="r")[1].to(
                        aj.dtype)
        return run, flops

    raise ValueError(f"unknown op {op!r}")


def measure(op: str, plan: TilePlan, n: int, iters: int = 3,
            dtype: str = "float32", device=None) -> float:
    """GFLOP/s of one candidate: best of ``iters`` timed runs, the warm-up
    run excluded; CUDA events on the card, the host clock on the CPU."""
    dev = _device(device)
    thunk, flops = _problem(op, plan, n, dtype, dev)
    best = float("inf")
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        thunk()                                  # builds, library set-up
        stream.synchronize()
        for _ in range(max(1, iters)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            thunk()
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
    else:
        thunk()
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            thunk()
            best = min(best, time.perf_counter() - t0)
    return flops / best / 1e9


def sweep(op: str, n: int, dtype: str = "float32", iters: int = 3,
          device=None):
    """Yield (plan, gflops) for every candidate of (op, n, dtype)."""
    for plan in candidates(op, n, dtype, device):
        yield plan, measure(op, plan, n, iters=iters, dtype=dtype,
                            device=device)


def tune_op(op: str, n: int, dtype: str = "float32", iters: int = 3,
            persist: bool = True, device=None,
            report=None) -> tuple[TilePlan, float]:
    """Measure all candidates, persist the winner under the device's chip
    kind, return it.  ``report(plan, gflops)``, when given, sees every
    candidate as it is measured."""
    best_plan, best_gf = None, -1.0
    for plan, gf in sweep(op, n, dtype, iters=iters, device=device):
        if report is not None:
            report(plan, gf)
        if gf > best_gf:
            best_plan, best_gf = plan, gf
    if persist:
        record_plan(op, n, dtype, best_plan, gflops=best_gf,
                    chip=chip_kind(_device(device)))
    return best_plan, best_gf


def tune_all(ns=(256, 512, 1024), ops=OPS, dtype: str = "float32",
             iters: int = 3, persist: bool = True, device=None,
             report=None):
    """Tune every (op, n) pair; returns {(op, n): (plan, gflops)}.
    ``report(op, n, plan, gflops)`` sees every candidate."""
    out = {}
    for op in ops:
        for n in ns:
            cb = None if report is None else (
                lambda p, g, op=op, n=n: report(op, n, p, g))
            out[(op, n)] = tune_op(op, n, dtype, iters=iters,
                                   persist=persist, device=device,
                                   report=cb)
    return out


# -------------------------------------------------- serve_bucket ladder
#
# Not a kernel sweep: the ``serve_bucket`` pseudo-op records the bucket
# LADDER for this card from a recorded request-size histogram, one cache
# entry a rung, which serve.bucket.default_ladder picks up through
# tune.serve_buckets.


def serve_ladder_from_sizes(sizes, max_rungs: int = 8,
                            base: int = 32) -> tuple:
    """Padded-area-optimal bucket ladder (<= ``max_rungs`` rungs) for a
    request-size sample.  Sizes round up to ``base`` multiples (the tile
    edge: finer rungs cannot change the packed shapes); each rung is one
    of the distinct rounded sizes and the top rung covers the largest, so
    every recorded request buckets without doubling."""
    pad = [max(base, -(-int(s) // base) * base) for s in sizes if int(s) > 0]
    if not pad:
        raise ValueError("serve_ladder_from_sizes: no positive sizes")
    hist = collections.Counter(pad)
    edges = sorted(hist)
    ne = len(edges)
    if ne <= max_rungs:
        return tuple(edges)
    # cost[lo][hi]: every request in edges[lo..hi] served at edges[hi]
    cost = [[0.0] * ne for _ in range(ne)]
    for lo in range(ne):
        cnt = 0
        for hi in range(lo, ne):
            cnt += hist[edges[hi]]
            cost[lo][hi] = cnt * edges[hi] ** 2
    inf = float("inf")
    dp = [[inf] * ne for _ in range(max_rungs + 1)]
    cut = [[-1] * ne for _ in range(max_rungs + 1)]
    for hi in range(ne):
        dp[1][hi] = cost[0][hi]
    for r in range(2, max_rungs + 1):
        for hi in range(r - 1, ne):
            for mid in range(r - 2, hi):
                c = dp[r - 1][mid] + cost[mid + 1][hi]
                if c < dp[r][hi]:
                    dp[r][hi] = c
                    cut[r][hi] = mid
    best_r = min(range(1, max_rungs + 1), key=lambda r: dp[r][ne - 1])
    rungs, r, hi = [], best_r, ne - 1
    while r > 1:
        rungs.append(edges[hi])
        hi = cut[r][hi]
        r -= 1
    rungs.append(edges[hi])
    return tuple(sorted(rungs))


def ladder_waste(sizes, ladder) -> float:
    """Padding waste (1 - live/padded area) of serving ``sizes`` square
    problems on ``ladder`` (a serve.bucket.BucketLadder)."""
    live = padded = 0
    for s in sizes:
        s = int(s)
        if s <= 0:
            continue
        b = ladder.bucket_for(s)
        live += s * s
        padded += b * b
    return 1.0 - live / padded if padded else 0.0


def tune_serve_buckets(sizes, dtype: str = "float32", max_rungs: int = 8,
                       persist: bool = True, device=None):
    """Fit a bucket ladder to a request-size histogram and persist it as
    ``serve_bucket`` plan-cache entries (one a rung) under the device's
    chip kind.  Returns ``(rungs, waste_geometric, waste_tuned)``, the
    padding waste of the geometric default beside the fitted ladder's."""
    from ..serve import bucket as _bucket

    rungs = serve_ladder_from_sizes(sizes, max_rungs=max_rungs)
    w_geo = ladder_waste(sizes, _bucket.geometric_ladder())
    w_tuned = ladder_waste(sizes, _bucket.BucketLadder(rungs, "tuned"))
    if persist:
        chip = chip_kind(None if device is None else torch.device(device))
        for r in rungs:
            record_plan(SERVE_BUCKET_OP, int(r), dtype, LIBRARY_PLAN,
                        chip=chip)
    return rungs, w_geo, w_tuned
