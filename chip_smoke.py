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
 11. slice 12 (its own generators, --seed + 10 to + 13): posv_mixed and
     posv_mixed_gmres on config 2 in its own dtype (A = G G^T + n I in
     f64, n = 20480, 128 right-hand sides): the f32 factor on K2 and K0
     (launched as f32 posv: 479, 159), f64 refinement, iterations, the
     stop flag's host reads, the reference's stop test as a ratio (<= 1)
     and the forward error against the library's f64 Cholesky solve,
     timed beside; potri and trcondest on the f64 factor (rcond beside
     1 / torch.linalg.cond(L, 1)); gesv_mixed and gesv_mixed_gmres on
     config 3 in f64 (the orthogonal A) with MethodLU.CALU, which the
     reference's gesv_mixed does not read (partial pivoting, no hand
     kernel), and gesv_mixed under Speculate (the RBT NoPiv factor, K3
     2 n/nb - 1 launches); gecondest on the f64 LU; band in f64 at n =
     20480: pbsv (kd = 256) and gbsv (kl = ku = 128) against dense
     solves, tbsm, gbmm and hbmm against dense torch; hesv in f64 at n =
     8192 (residual, certify_ldlt's ratio) and an f32 posv on an
     indefinite A at n = 4096 whose ladder takes potrf -> hesv; the API's
     batch verbs on (8, 1920, 1920) stacks (1900 is not a multiple of the
     128 panel, so both packages would route it per problem; least
     squares (8, 3840, 1920)), bit-equal to make_batched with K6/K7/K8
     launched, and least_squares_solve with MethodGels.QR at 8192 x 4096
     (K5, 32 launches);
 12. slice 13 (its own generator, --seed + 14): tune, tune_all on the
     card into a fresh plan-cache file (potrf_tile and lu_select at 128
     and 512; potrf_panel, getrf_panel and geqrf_panel at 1024, 8192 and
     20480; the batch ops at buckets 512 and 4096 in f32 and bf16), every
     candidate's GFLOP/s and each winner printed, the file schema-valid;
     obs_overhead, the host cost of an @annotate'd call (obs off and on)
     and of a resolve_plan; obs_default, posv (n = 20480), CALU gesv and
     QR gels (8192 x 4096) and the 120-request stream (warm) under
     obs.recording(), record_spans() and obs.timing() with the empty
     cache: one event per outermost call with device_ms, mfu and its
     default "cuda" plans, launches equal to and X bit-equal with the same
     call with obs off, the span tree's ms per driver, a Chrome trace each
     in chiprun_out/, and the obs-off walls in turns with the same calls
     with every driver unannotated; obs_tuned, posv and CALU gesv with the
     tuned cache: every plan they resolve (source and distance), launches
     equal to what those plans imply, walls beside obs_default's; obs_cli,
     ``python -m slate_tpu_torch.obs`` over the recorded JSONL, compare of
     the obs-off walls against themselves and slo against a budgets file,
     each exiting 0.  Every phase before tune runs with the port's plan
     cache pointed at an empty file, whatever cache the machine holds;
 13. slice 14 (its own generator, --seed + 15): the spectral drivers,
     BASELINE.md config 5 cut to one card: heev at n = 4096 (8192
     before slice 23, 6144 before slice 24) in f32 and in f64 on the generator's heev matrix (A = Q diag(lambda) Q^T, lambda =
     linspace(-1, 1, n) * sigma reversed, cond 1e3, formed in f64 on the
     card), cold and warm, heev_vals, the phase split (he2hb, stage2,
     backtransform, certify; synced), the recorded spans, the
     certificate's ratio against its tolerance and max|w - lambda| /
     max|lambda| against its bound, beside the library's own eigh on A;
     svd at 4096 x 4096 f32 on the generator's svd matrix the same way;
     hegv (itype 1, B = G G^T + n I): K2 95 and K0 31 launches, as
     expected_posv_launches(4096, 128) gives; the parity routes at n =
     512 (MethodEig DC and QR, MethodSvd Bidiag) against the Auto
     route's values, with the chase's steps and its launches a step
     (torch.profiler on a 512 x 512 chase); stedc at n = 4096 on a random
     and a glued Wilkinson tridiagonal (certificate, wall, peak memory);
     the spectral fault drills (a transient post_backtransform strike on
     heev escalated Auto -> DC, a persistent post_secular strike walking
     DC -> QR, post_stage1 on svd escalated Auto -> Bidiag, each path read
     from the call's obs event; post_secular on stedc detected, and
     raising under ErrorPolicy.Raise).  No hand kernel runs on the heev
     and svd paths (the reference's reach no Pallas kernel): their
     launches must all be 0;
 14. slice 15 (its own generator, --seed + 16): durable jobs and
     compatibility.  potrf_ooc at n = 16384, f32, nb = 128 on A = G G^T +
     n I from a host array (the TileMap: pinned host block columns, each
     panel window one contiguous range, copies on a side stream): the factor
     against the in-core potrf's, ||A - L L^T||_F / ||A||_F beside the
     in-core factor's, K1 launched once a panel step (128), the H2D and
     D2H bytes equal to the loop's (~23 GB in), cold and warm walls
     beside in-core posv's, the factor bit-equal across runs, and under
     torch.profiler the kernels' and the copies' device busy time, their
     overlap and the device's idle share; getrf_ooc at n = 12288, f32, at
     the default width (256) on the orthogonal A: ||A[perm] - L U|| /
     ||A||, the solve through getrs on its factors beside the in-core
     partial-pivot gesv's, no hand kernel, the traffic, walls and idle
     share; the kill-and-resume drill at n = 4096 for both drivers (an
     uninterrupted run, a run killed after the checkpoint of a middle
     step at cadence 4, the resume, a full run with checkpoints on: every
     factor and permutation bit-equal), the refusals (a ckpt_torn_write
     plan: torn; a ckpt_stale_read plan: stale; a flipped payload byte:
     corrupt) and the checkpoint events' bytes and wall ms; the shims:
     compat.lapack gesv, posv and gels at n = 4096 in f64 (gels on 8192 x
     4096) and the C API's dgesv and dposv through ctypes pointers into
     numpy buffers, their backward errors and the hand kernels each
     launched (none), and an f32 posv through the shim, whose tile size
     (256 at this n) lies past K1's and K2's gates;
 15. slice 16 (its own generator, --seed + 17): the distributed layer in
     a one-rank NCCL world (init_process_group("nccl", store=FileStore,
     rank=0, world_size=1)), Grid(1, 1, group=WORLD) on cuda:0, every call
     with Target.mesh: dist_posv at n = 20480, f32, nb = 128, 128
     right-hand sides (dist_potrf, K1 on each diagonal tile: 160
     launches, then dist_trsm twice), posv's bounds, cold and warm beside
     the single route's posv; dist_gemm (SUMMA, 20480^3), dist_gemmA (a
     128-column C), dist_herk (n = 20480, k = 2048), dist_trsm and
     dist_trmm (the dist_posv factor against 20480 x 128), each against
     the library's product or solve within 1e-4 of its largest entry, no
     hand kernel launched; dist_lookahead, SUMMA and dist_potrf at n =
     8192 at depths 0, 1 and 2 bit for bit; dist_strike, a transient
     bitflip planted in the first diagonal factor of a mesh posv under
     Option.Abft (n = 8192), located at tile (0, 0) and repaired; the
     mesh posv by span and by kernel (trace_spans, trace_profile); the
     process group destroyed, then gloo_2x2, four CPU processes (this
     script with --gloo-child, no card visible) on a 2 x 2 grid over gloo
     running posv and SUMMA gemm in f64 at n = 256 against torch's own
     solve and product: a check of comm/ under this machine's torch, no
     card result (its line says "device": "cpu");
 16. slice 17 (its own generator, --seed + 18): distributed LU, CAQR and
     the mesh Aasen in a second one-rank NCCL world, every call with
     Target.mesh: dist_gesv, CALU at n = 20480 with 128 right-hand sides
     (dist_getrf: K4's tournament and K3 on every panel, 470 and 318
     launches), gesv's bounds, beside the single route's CALU gesv;
     dist_gesv_nopiv and dist_rbt (gesv under Speculate: the butterflies
     on the tiles, then K3) at n = 8192, 127 K3 launches each;
     dist_gels at 8192 x 4096 through CAQR (K5 on each of the 32 local
     panels) and through CholQR (K1 on each of dist_potrf's 32 diagonal
     tiles), gels' bounds; dist_hesv (the row-distributed Aasen) at n =
     4096 beside the single route's; dist_lu_lookahead, dist_getrf
     (CALU, 8192) and dist_geqrf (8192 x 4096) at depths 0, 1 and 2 bit
     for bit; dist_gesv_strike, a transient bitflip planted in the first
     panel of a mesh gesv under Option.Abft (n = 8192), located at its
     tile and repaired; the process group destroyed; the gloo_2x2
     children also run a CALU gesv, a QR gels, from_scalapack and pdgesv
     (the gloo_2x2_slice17 line, "device": "cpu");
 17. slice 18 (its own generator, --seed + 19): the distributed spectral
     reductions in a third one-rank NCCL world, every call with
     Target.mesh, each beside the single route's wall on the same input:
     dist_heev, heev at n = 8192, f32, nb = 128 on slice 14's kind of heev
     matrix (dist_he2hb, the band gathered, stage 2 replicated,
     dist_unmtr_he2hb), cold and warm, the certificate under 50 n eps, the
     eigenvalues within 2e-3 of the exact spectrum, its spans, no hand
     kernel; dist_heev_vals; dist_hegv (itype 1, 8192: dist_potrf's K1
     on each of the 64 diagonal tiles); dist_svd at 6144 x 6144 under
     slice 14's svd bounds; dist_heev_dc, MethodEig.DC at 512 (the chase
     runs a step after another; stedc's merges row-distributed);
     dist_stedc at 4096 against the single route's; pdsyev and pdgesvd at
     2048 in f64 against numpy; dist_spectral_lookahead, dist_he2hb and
     dist_ge2tb at 4096 at depths 0, 1 and 2 bit for bit;
     dist_heev_strike, a transient NaN strike on the band at 512 that
     the ladder escalates Auto -> DC and certifies; the gloo_2x2 children
     also run heev, svd, hegv, stedc, pdsyev and pdgesvd in f64 (the
     gloo_2x2_slice18 line, "device": "cpu");
 18. slice 19: the tester and the examples.  ``python -m
     slate_tpu_torch.tester``'s command lines in this process on the
     serial route: every routine in s and d at n = 3072 and in c and z at
     1024 (4096 and 2048 before slice 21, 1536 before slice 23), nb =
     128, the --ref runners
     (gesv, heev, svd, gels) in all four types at 1536 (2048 before),
     and posv in s at n = 4000 (its ragged last panel
     factors on K1); every table row printed, a JSON line a command with
     each row's driver time, whole-runner wall, error, status and the
     kernels it launched: posv's K2 and K0, gesv_tntpiv's K4 and K3,
     geqrf's and gels' K5 and the n = 4000 posv's K1 as their gates route
     them, none on a d, c or z row; any FAILED or ERROR row fails; then
     ex01-ex14 (run_all) in a fourth one-rank NCCL world (the gloo
     children run them in their 2 x 2 world: gloo_2x2_slice19);
 19. slice 21 (its own generator, --seed + 20), the wide widths: right
     after K2's late panels, K1 at n = 256, 512 and 1024 and on an
     indefinite 512 tile (the same first bad pivot, 300, as the plain
     version), K2 at [M, K] = [10240, 10240] at nb = 256 and 512 and at
     [2048, 1000] with a transposed left (a ragged K, plain-load
     staging; since slice 25 the update on the tensor cores as a 3xTF32
     product, its chol_panel_plan line with its route and its error
     against the f64 product, at most twice torch.matmul's in f32), K0
     at n = 256 and 512 on a Cholesky U (since slice 25 with a
     tri_inv_split line: copy-in, diagonal inverses, each half-level of
     the joins, store) and on a pivoted
     LU's U (within 1e-5 of f64), K3 at W = 20480 and W = nb at nb = 256
     and 512 on diagonally dominant panels, each against its plain
     version, timed beside its bound and library call, launched twice
     bit for bit; after the main posv, posv_nb256 and posv_nb512 on its
     matrix (K2 239 and 119, K0 79 and 39 launches, its accuracy bounds,
     warm wall and device busy time beside nb = 128's); after the NoPiv
     route, gesv_nopiv_nb256 on its matrix (K3 63 launches) and
     potrf_ooc_default_width (n = 8192 at ooc_panel_width's 256: K1 32
     launches, walls beside in-core posv's); slice 15's shims phase now
     holds the f32 LAPACK posv at 4096 (nb 256) to K2 47 and K0 15
     launches;
 20. slice 22 (--seed + 21): K4 and K5 at nb = 256-512 after slice 21's
     kernel rows, CALU gesv and the QR gels at nb = 256 and 512 after
     their nb = 128 runs, the tester's s rows at 256;
 21. slice 23 (its own generator, --seed + 22), the serving kernels at
     the tuned plan's width: right after the serving kernels' rows
     (serve_wide_kernels), K6 and K7 at B = 8, M = 4096, K = 2048, nb =
     256 and 512 with live, partly dead and dead tiles, K8 at [8, 4096,
     256] and [8, 2048, 512] with a rows = 0 slot, in f32 and bf16, each
     against its plain version, launched twice bit for bit, one problem
     alone bit-equal to its slot, timed beside its bound and library
     composition; after the serving stream, the same 120 requests under
     plan_override for the three batch ops at TilePlan("cuda", 8, 256)
     and 512 (stream_nb256, stream_nb512: K6-K8 launches as
     expected_serve_launches predicts at nb = min(plan.nb, bucket), the
     residual bounds, warm wall and device busy beside the default
     nb = 128's in the same run), then tuned_batch_picks (the tuner's
     batch candidates at bucket 1024, nb 128, 256 and 512, swept into a
     temporary cache, and the nb each op picks);
 22. print the launch counts, the card line, the kernels line (K0-K8
     with a "wide" list of their wide rows), and last the result line.
     A kernel's launch count adds its wrapper's eager launches and those
     its CUDA graphs' replays ran.
With --trace it also breaks one warm posv, one warm CALU gesv, one warm
QR gels and one warm serving stream down by phase (host clock) and by
kernel (torch.profiler), with the device's idle share, and the gesv's K4
device time into its round-1 launches and its reduction rounds', K3's
into its factor and strips launches, and the stream's K6 and K7 device
time into their update, factor and solve launches, and the kernel
breakdown of one Abft posv and one Abft CALU gesv, and one warm heev and
one warm svd at n = 8192 by span and by kernel (device activity alone),
with the idle share, and the mesh CALU gesv and the mesh heev by span
and by kernel (the heev's device activity alone).
Each profiled run has its own time limit (TRACE_PROFILE_LIMIT_S) and so
has the spectral trace (TRACE_SPECTRAL_LIMIT_S): past it the run exits
nonzero, naming the phase.

The Cholesky and LU phases draw their matrices from one generator seeded
with --seed, the QR phases (K5's check included) from their own, seeded
with --seed + 1, the serving phases from a third, --seed + 2, and the
K5/K8 cluster edge shapes from a fourth, --seed + 3, K2's late panels
and K0's pivoted U from a fifth, --seed + 4, and K1's tiles at n = 32 and
96 and its indefinite tile from a sixth, --seed + 5, and K4's tie chunk
from a seventh, --seed + 6, and K3's panels at W = 10240 and 128 and its
zero-pivot tiles from an eighth, --seed + 7, the robustness phases' square
matrices from a ninth, --seed + 8, and their least-squares problems from a
tenth, --seed + 9, slice 12's from --seed + 10 to + 13, slice 13's
from --seed + 14, slice 14's from --seed + 15, slice 15's from
--seed + 16, slice 16's from --seed + 17, slice 17's from --seed + 18,
slice 18's from --seed + 19, slice 21's from --seed + 20, slice 22's
from --seed + 21 and slice 23's from --seed + 22, so that
adding to one slice moves no other's matrices (slice 19 draws from no
generator of this script: the tester's runners and the examples draw
from their own fixed seeds, the reference's);
the survival phases and posv_hold draw nothing of their own (they reuse
the stream and posv's matrix).
It imports nothing of JAX or slate_tpu, and exits nonzero without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
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


def step_launch_times(name: str, tag: str, fn, reps: int = 5,
                      factor_tags: tuple = ()) -> dict:
    """K6's or K7's launches (update, factor, solve; the kernels named
    ``{name}_{launch}``, and in the factor's also any kernel named by one
    of ``factor_tags``) per call of its wrapper ``fn``: device ms by
    launch, from torch.profiler, under the keys ``{tag}_own_ms`` and
    ``{tag}_launch_ms``."""
    by_name = device_ms(fn, reps, per_launch=True)
    tags = {part: (f"{name}_{part}",) + (factor_tags if part == "factor"
                                         else ())
            for part in ("update", "factor", "solve")}
    parts = {part: sum(v for k, v in by_name.items()
                       if any(t in k for t in tags[part]))
             for part in tags}
    return {f"{tag}_own_ms": sum(parts.values()), f"{tag}_launch_ms": parts}


def k2_launch_times(fn, reps: int = 5) -> dict:
    """K2's own launches (update, factor, solve) and K0's, per call of a
    chol_panel_fused ``fn``: device ms by launch, from torch.profiler."""
    by_name = device_ms(fn, reps, per_launch=True)

    def pick(tag):
        return sum(v for k, v in by_name.items() if tag in k)
    # the wide widths' update is chol_panel_update_tc_kernel, their factor
    # and K0 launches the *_wide_kernel ones, their solve wide_factor.cuh's
    # wf_solve_kernel
    parts = {"update": (pick("chol_panel_update_kernel")
                        + pick("chol_panel_update_tc_kernel")),
             "factor": pick("chol_panel_factor"),
             "solve": (pick("chol_panel_solve_kernel")
                       + pick("wf_solve_kernel"))}
    return {"k2_own_ms": sum(parts.values()), "k2_launch_ms": parts,
            "k0_ms": pick("upper_tri_inv")}


def k3_launch_times(fn, reps: int = 5) -> dict:
    """K3's own launches (the factor with U^-1, the rows below) per call
    of a lu_panel_fused ``fn``: device ms by launch, from torch.profiler."""
    by_name = device_ms(fn, reps, per_launch=True)
    # at nb = 256 .. 512: lu_panel_factor_wide_kernel with its second
    # launch, U^-1 by K0's upper_tri_inv_wide_kernel, and wf_solve_kernel
    tags = {"factor": ("lu_panel_factor", "upper_tri_inv_wide"),
            "below": ("lu_panel_below_kernel", "wf_solve_kernel")}
    parts = {part: sum(v for k, v in by_name.items()
                       if any(t in k for t in tags[part]))
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


def tf32x3_bound(split_flops: float, flops: float,
                 nbytes: float) -> tuple[float, str]:
    """Least time for work of which ``split_flops`` (an f32 product's 2 m n
    k) run on the tensor cores as a 3xTF32 split product, three TF32
    passes at the card's TF32 rate (obs/flops.py split_product_seconds;
    the H100's where the table lacks the card), and the rest of ``flops``
    on the CUDA cores, against the bytes over the memory rate: in ms, and
    which one it is."""
    from slate_tpu_torch.obs import flops as fl
    peak, bw = card_rates()
    t_split = fl.split_product_seconds(split_flops)
    if t_split is None:
        t_split = fl.split_product_seconds(split_flops, kind="h100")
    t_ops = t_split + (flops - split_flops) / peak
    t_bytes = nbytes / bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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
    K2's own launches' device time, K0's apart.  Past nb = 128 the update
    runs on the tensor cores as a 3xTF32 product: its max |upd - upd64|
    against the f64 product must be at most twice that of torch.matmul in
    f32 on the same operands, and the row states its bound both ways (the
    CUDA cores' f32 bound and the split product's on the tensor cores)."""
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
    wide = nb > 128
    fast = "loads" if left_t else ("tma" if wide else "cp.async")
    if k and not plan["left"] == plan["lead"] == fast:
        raise AssertionError(f"chol_panel_fused [{m}, {k}]: staging {plan} "
                             f"on left_transposed = {left_t}")
    if plan["route"] != ("tf32x3" if wide else "fp32"):
        raise AssertionError(f"chol_panel_fused nb = {nb}: route {plan}")
    flops = panel_flops(m, k, nb, "potrf")
    nbytes = 4 * (m * nb + m * k + k * nb + 2 * m * nb)
    row = check(
        "chol_panel_fused", {"M": m, "nb": nb, "K": k, "bw": 8,
                             "left_transposed": left_t},
        list(got), list(want),
        "upd: K-long f32 sums with O(1) partial sums in another order (past "
        "nb = 128 a 3xTF32 product, held to f64 below); fac: as "
        "upper_tri_inv and chol_tile on a top block with cond <= ~5",
        times["k2_own_ms"],
        time_ms(lambda: chol_panel_plain(col, left, lead, 8), 3),
        time_ms(library, 10), flops, nbytes,
        control=(tf32(lambda: chol_panel_plain(col, left, lead, 8))
                 if k else None))
    accuracy = {}
    if wide:
        # the update against the f64 product, beside torch.matmul in f32
        ref = col.double() - left.double() @ lead.double()
        accuracy = {
            "f64_err": float((got[0].double() - ref).abs().max()),
            "matmul_f32_f64_err": float(
                ((col - left @ lead).double() - ref).abs().max())}
        del ref
        split_flops = op_flops("gemm", (m, k), (k, nb))
        tc_ms, tc_by = tf32x3_bound(split_flops, flops, nbytes)
        row.update(bound_fp32_ms=row["bound_ms"],
                   bound_fp32_by=row["bound_by"], bound_tf32x3_ms=tc_ms,
                   bound_tf32x3_by=tc_by, bound_ms=tc_ms, bound_by=tc_by,
                   bound_against="tf32x3")
    row.update(times, plan=plan, bitwise_repeatable=repeatable, **accuracy,
               wrapper_ms=time_ms(lambda: chol_panel_fused(col, left, lead,
                                                           8), 10),
               library_device_ms=sum(device_ms(library).values()),
               library_cholesky_ms=time_ms(
                   lambda: library(torch.linalg.cholesky), 10))
    emit({"phase": "chol_panel_plan", "M": m, "K": k, "nb": nb, **plan,
          **accuracy, "bitwise_repeatable": repeatable, **times,
          "wrapper_ms": row["wrapper_ms"], "library_ms": row["library_ms"],
          "library_cholesky_ms": row["library_cholesky_ms"],
          "library_device_ms": row["library_device_ms"]})
    if not repeatable:
        raise AssertionError(f"chol_panel_fused [{m}, {k}]: two launches on "
                             f"the same input differ")
    if accuracy and not (accuracy["f64_err"]
                         <= 2 * accuracy["matmul_f32_f64_err"]):
        raise AssertionError(f"chol_panel_fused [{m}, {k}], nb = {nb}: the "
                             f"3xTF32 update is {accuracy['f64_err']} from "
                             f"f64, more than twice torch.matmul's "
                             f"{accuracy['matmul_f32_f64_err']}")
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
                           depth: int = 2, k3_fits=lambda w: True) -> dict:
    """K4 and K3 launches of getrf_tntpiv on an n x n matrix, replayed from
    the tournament's control flow (internal/getrf.py) on the shapes: a
    panel of W > nb rows splits into blocks of br rows; round 1 (when br >
    nb) and each reduction round of ``depth`` candidate sets are one K4
    launch if ``fits(block height)``, else lu_factor; K3 then launches
    twice (its factor, U^-1 formed inside, and the rows below) if
    ``k3_fits(W)``; a panel of nb rows takes lu_factor alone."""
    k4 = k3 = 0
    for k0 in range(0, n, nb):
        w = n - k0
        if w <= nb:
            continue
        k4 += sum(fits(h) for h in calu_rounds(w, nb, mpt, depth))
        k3 += 2 * bool(k3_fits(w))
    return {"lu_select": k4, "lu_panel_fused": k3}


def calu_rounds(w: int, nb: int, mpt: int = 4, depth: int = 2,
                height: int | None = None) -> list:
    """The block heights of a W-row panel's tournament rounds: round 1 at
    br rows (when br > nb), then a round of ``depth`` candidate sets
    (depth * nb rows) until one set is left.  br is sized from
    ``height`` when given (the mesh route's reference panel height)."""
    br = max(nb, -(-(height or w) // (mpt * nb)) * nb)
    blocks = -(-w // br)
    rounds = [br] if br > nb else []
    while blocks > 1:
        rounds.append(depth * nb)
        blocks = -(-blocks // depth)
    return rounds


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


# --trace: each profiled run has its own time limit, and so has the
# spectral trace as a whole; past it the run fails, naming the phase
TRACE_PROFILE_LIMIT_S = 300
TRACE_SPECTRAL_LIMIT_S = 600
TRACE_GRACE_S = 60


@contextlib.contextmanager
def phase_limit(name: str, seconds: float):
    """Fail the run when the block passes ``seconds``: a TimeoutError
    naming the phase (SIGALRM; an enclosing limit keeps running and
    fires with its own name), and, should the block sit in code that
    does not return to the interpreter, a line naming it and exit code 3
    ``TRACE_GRACE_S`` later."""
    import signal
    import threading
    t0 = time.monotonic()
    outer = signal.getitimer(signal.ITIMER_REAL)[0]
    old = signal.getsignal(signal.SIGALRM)

    def on_alarm(signum, frame):
        if time.monotonic() - t0 >= seconds or not callable(old):
            raise TimeoutError(f"phase {name} passed its limit of "
                               f"{seconds} s")
        old(signum, frame)

    done = threading.Event()

    def hard_stop():
        if not done.wait(seconds + TRACE_GRACE_S):
            print(json.dumps({"phase": "timeout", "of": name,
                              "limit_s": seconds}), flush=True)
            os._exit(3)

    signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL,
                     min(seconds, outer) if outer else seconds)
    threading.Thread(target=hard_stop, daemon=True,
                     name="smoke-phase-limit").start()
    try:
        yield
    finally:
        done.set()
        left = outer - (time.monotonic() - t0) if outer else 0.0
        signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3) if outer
                         else 0.0)
        signal.signal(signal.SIGALRM, old)


def profile_device(label, fn, cpu: bool = True) -> list:
    """Device time by kernel and the device's idle share of one ``fn()``
    under torch.profiler (``cpu=False``: the device activity alone, for
    runs of very many host operations); returns the kernels' device
    events.  The profiled run and the reading of its events have
    TRACE_PROFILE_LIMIT_S."""
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    with phase_limit(f"trace_profile {label}", TRACE_PROFILE_LIMIT_S):
        with profile(activities=acts) as prof:
            _, wall = _timed(fn)
        # the drivers' spans show on the device timeline as user
        # annotations (named "slate.*"): they are not kernels
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("slate.")]
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


def serve_panel_inputs(gen, chol: bool, k: int, dtype, nb: int = SERVE_NB):
    """A batch of K6/K7 operands at a serving shape: B = 8 problems of
    M = 4096 rows, width nb (128 unless given), K = k nb columns of history
    with O(1) products (left, lead ~ N(0,1) / K^(1/4), drawn apart),
    strided as batch_potrf and batch_getrf pass them (lead a transposed
    view for Cholesky); the top block of col - left @ lead SPD with cond <=
    ~5 (Cholesky) or G / sqrt(nb) + 2 I (LU).  bf16: the same values
    rounded."""
    b, m, kk = SERVE_B, SERVE_M, k * nb
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


def expected_serve_launches(records, warmups: bool = True,
                            plan_nb: int = 128) -> dict:
    """K6, K7 and K8 launches of the ragged route, replayed from the batches
    the server ran under a batch plan of width ``plan_nb`` (the default
    plan's 128 unless given): a chol_solve (solve) batch of bucket n runs
    one K6 (K7) step a block column, with nb = min(plan_nb, n): 3 n / nb -
    1 launches (update, factor, solve; the last step no solve) each; a
    least-squares batch of bucket (mb, n, kb) one K8 launch a panel, n / w
    with w = min(plan_nb, n).  On the card every batch replays its bucket's
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
        nb = min(plan_nb, n)
        runs = 1 + (warmups and not r["cache_hit"])
        if r["op"] == "least_squares_solve":
            want["qr_panel_batched"] += runs * (n // nb)
            # the safe rung's Householder QR tiles by min(n, 128) whatever
            # the batch plan
            want["qr_panel"] += r["escalated"] * (n // min(128, n))
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
    # the captures start from an emptied allocator cache: a capture that
    # meets a device full of cached blocks runs out of memory and is
    # retried (internal/graphs.py), one more warm-up pass than counted
    torch.cuda.empty_cache()
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


# ---------------------------------------------------------------- slice 12
#
# The mixed-precision solvers (BASELINE.md configs 2 and 3 in f64), the
# band and Aasen solvers, the auxiliary drivers and the simplified API.
# Each phase prints its line before its checks decide; any miss fails the
# run.  Generators --seed + 10 (mixed, aux), + 11 (band), + 12 (hesv) and
# + 13 (the API's stacks and least squares).

EPS64 = torch.finfo(torch.float64).eps
MIXED_FORWARD_BOUND = 1e-10      # vs the library's f64 solve, itself only
#                                  good to ~n eps64 (4.5e-12 at n = 20480)
BAND_RESIDUAL_BOUND = 1e-14      # ||AX - B||_max / (||A||_inf ||X||_max)
HESV_N = 8192
HESV_RESIDUAL_BOUND = 1e-12      # Aasen is backward stable; cond(A) ~ 1e4
INDEF_POSV_N = 4096
API_BATCH = (8, 1920, 16)        # 1900 is not a multiple of the 128 panel:
API_LSQ_M = 3840                 # both packages route it per problem
BAND_KD, BAND_KL = 256, 128


def _mixed_stop_ratio(a, x, b) -> float:
    """The reference's stop test as a ratio: max over columns of
    ||r_j||_max / (||x_j||_max ||A||_inf eps64 sqrt(n)); converged <= 1."""
    r = b - a @ x
    anorm = a.abs().sum(dim=1).max()
    ratio = r.abs().amax(dim=0) / (x.abs().amax(dim=0) * anorm * EPS64
                                   * a.shape[0] ** 0.5)
    return float(ratio.max())


def _run_mixed(st, fn, a_mat, b_mat, opts, reset, counts):
    from slate_tpu_torch.drivers import mixed
    reset()
    mixed.STOP_READS = 0
    res, wall = _timed(lambda: getattr(st, fn)(a_mat, b_mat, opts))
    return res, wall, counts(), mixed.STOP_READS


def check_mixed(st, gen, n, nb, nrhs, reset, counts, failures) -> dict:
    """posv_mixed / posv_mixed_gmres on config 2 (A = G G^T + n I in f64)
    and gesv_mixed / gesv_mixed_gmres on config 3 (the orthogonal A in
    f64), f32 factors on the kernels, f64 refinement."""
    out = {}
    g = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    a = g @ g.T
    del g
    a.diagonal().add_(n)
    b = torch.randn(n, nrhs, generator=gen, device="cuda",
                    dtype=torch.float64)
    x64, lib_s = _timed(lambda: torch.cholesky_solve(
        b, torch.linalg.cholesky(a)))
    A = st.HermitianMatrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    want_k = {"chol_panel_fused": 3 * (n // nb) - 1,
              "upper_tri_inv": n // nb - 1}
    for fn in ("posv_mixed", "posv_mixed_gmres"):
        res, wall, launches, reads = _run_mixed(st, fn, A, B, None, reset,
                                                counts)
        _, wall_repeat = _timed(lambda: getattr(st, fn)(A, B))
        x = res.X.to_dense()
        ratio = _mixed_stop_ratio(a, x, b)
        fwd = float((x - x64).abs().max() / x64.abs().max())
        out[fn] = launches
        emit({"phase": fn, "n": n, "nb": nb, "nrhs": nrhs, "dtype":
              "float64", "factor_dtype": "float32", "wall_s": wall,
              "wall_s_repeat": wall_repeat, "iters": res.iters,
              "converged": res.converged,
              "fallback": res.health.iters != res.iters, "stop_reads": reads,
              "stop_test_ratio": ratio,
              "forward_error_vs_f64_cholesky": fwd,
              "forward_bound": MIXED_FORWARD_BOUND,
              "library_f64_cholesky_solve_s": lib_s,
              "launches": launches})
        if not (res.converged and ratio <= 1.0
                and fwd < MIXED_FORWARD_BOUND):
            failures.append(f"{fn}: converged {res.converged}, stop ratio "
                            f"{ratio}, forward {fwd}")
        if {k: launches[k] for k in want_k} != want_k or any(
                v for k, v in launches.items() if k not in want_k):
            failures.append(f"{fn}: launches {launches}, want {want_k}")
    # potri and trcondest on posv's factor (f64, library route)
    L = st.potrf(A)
    Ainv, potri_s = _timed(lambda: st.potri(L))
    eye_err = float((a @ Ainv.to_dense() - torch.eye(
        n, dtype=a.dtype, device="cuda")).abs().max())
    rc, trc_s = _timed(lambda: st.trcondest(L))
    ld = L.to_dense()
    trc_lib = 1.0 / float(torch.linalg.cond(ld, 1))
    emit({"phase": "aux_potri_trcondest", "n": n, "potri_s": potri_s,
          "max_abs_A_Ainv_minus_I": eye_err, "trcondest_rcond": rc,
          "trcondest_s": trc_s, "rcond_torch_cond1": trc_lib})
    if not (eye_err < 1e-10 and 0.1 * trc_lib <= rc <= 10 * trc_lib):
        failures.append(f"potri/trcondest: |A Ainv - I| {eye_err}, rcond "
                        f"{rc} vs {trc_lib}")
    del A, B, L, Ainv, ld, a, b, x64

    qa = orthogonal(n, gen).double()
    b = torch.randn(n, nrhs, generator=gen, device="cuda",
                    dtype=torch.float64)
    x64, lib_s = _timed(lambda: torch.linalg.solve(qa, b))
    A = st.Matrix.from_numpy(qa, nb)
    B = st.Matrix.from_numpy(b, nb)
    calu = {st.Option.MethodLU: st.MethodLU.CALU}
    spec = {st.Option.Speculate: st.Speculate.On}
    from slate_tpu_torch.internal import rbt
    nt = rbt.padded_size(n)         # getrf_rbt's padded width
    for fn, tag, opts, want_k in (
            ("gesv_mixed", "gesv_mixed", calu, {}),
            ("gesv_mixed", "gesv_mixed_speculate", spec,
             {"lu_panel_fused": 2 * (nt // nb) - 1}),
            ("gesv_mixed_gmres", "gesv_mixed_gmres", calu, {})):
        res, wall, launches, reads = _run_mixed(st, fn, A, B, opts, reset,
                                                counts)
        _, wall_repeat = _timed(lambda: getattr(st, fn)(A, B, opts))
        x = res.X.to_dense()
        ratio = _mixed_stop_ratio(qa, x, b)
        fwd = float((x - x64).abs().max() / x64.abs().max())
        out[tag] = launches
        emit({"phase": tag, "n": n, "nb": nb, "nrhs": nrhs, "dtype":
              "float64", "factor_dtype": "float32",
              "options": {k.name: v.name for k, v in opts.items()},
              "wall_s": wall, "wall_s_repeat": wall_repeat,
              "iters": res.iters, "converged": res.converged,
              "fallback": res.health.iters != res.iters,
              "stop_reads": reads, "stop_test_ratio": ratio,
              "growth": res.health.growth,
              "forward_error_vs_f64_solve": fwd,
              "forward_bound": MIXED_FORWARD_BOUND,
              "library_f64_solve_s": lib_s, "launches": launches})
        if not (res.converged and ratio <= 1.0
                and fwd < MIXED_FORWARD_BOUND):
            failures.append(f"{tag}: converged {res.converged}, stop ratio "
                            f"{ratio}, forward {fwd}")
        if any(launches[k] != want_k.get(k, 0) for k in launches):
            failures.append(f"{tag}: launches {launches}, want {want_k}")
    # gecondest on the f64 LU factors (library route)
    F = st.getrf(A)
    anorm = float(qa.abs().sum(dim=0).max())
    rc, gec_s = _timed(lambda: st.gecondest(F, anorm))
    ge_lib, cond_s = _timed(lambda: 1.0 / float(torch.linalg.cond(qa, 1)))
    emit({"phase": "aux_gecondest", "n": n, "gecondest_rcond": rc,
          "gecondest_s": gec_s, "rcond_torch_cond1": ge_lib,
          "torch_cond1_s": cond_s})
    if not 0.1 * ge_lib <= rc <= 10 * ge_lib:
        failures.append(f"gecondest: rcond {rc} vs {ge_lib}")
    return out


def _band_dense(gen, n, kl, ku, shift):
    """A dense f64 band matrix with a diagonal shift (cond ~ 2-10)."""
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    a = torch.triu(torch.tril(a, ku), -kl)
    a.diagonal().add_(shift)
    return a


def _scaled_residual(a, x, b) -> float:
    return float((a @ x - b).abs().max()
                 / (a.abs().sum(dim=1).max() * x.abs().max()))


def check_band(st, gen, n, nb, nrhs, failures) -> None:
    """pbsv (kd = 256) and gbsv (kl = ku = 128) in f64 at n = 20480, and
    tbsm, gbmm and hbmm at the same sizes against dense torch."""
    kd, kl = BAND_KD, BAND_KL
    h = _band_dense(gen, n, kd, 0, 0.0)
    h = h + h.T
    h.diagonal().add_(2.0 * (2 * kd + 1))
    b = torch.randn(n, nrhs, generator=gen, device="cuda",
                    dtype=torch.float64)
    H = st.HermitianBandMatrix.from_numpy(h, kd, nb)
    B = st.Matrix.from_numpy(b, nb)
    (F, X), wall = _timed(lambda: st.pbsv(H, B))
    _, wall_repeat = _timed(lambda: st.pbsv(H, B))
    res = _scaled_residual(h, X.to_dense(), b)
    x64, dense_s = _timed(lambda: torch.cholesky_solve(
        b, torch.linalg.cholesky(h)))
    fwd = float((X.to_dense() - x64).abs().max() / x64.abs().max())
    emit({"phase": "band_pbsv", "n": n, "kd": kd, "nb": nb, "w": F.w,
          "wall_s": wall, "wall_s_repeat": wall_repeat, "residual": res,
          "residual_bound": BAND_RESIDUAL_BOUND,
          "forward_error_vs_dense_f64": fwd,
          "dense_cholesky_solve_s": dense_s})
    if not (res < BAND_RESIDUAL_BOUND and fwd < 1e-12):
        failures.append(f"pbsv: residual {res}, forward {fwd}")
    hb_out, hb_s = _timed(lambda: st.hbmm(st.Side.Left, 1.0, H, B))
    hd_out, hd_s = _timed(lambda: h @ b)
    hb_err = float((hb_out.to_dense() - hd_out).abs().max()
                   / hd_out.abs().max())
    del H, F, X, x64, hb_out, hd_out
    tl = torch.tril(h)
    T = st.TriangularBandMatrix.from_numpy(tl, kd, nb)
    tx, tb_s = _timed(lambda: st.tbsm(st.Side.Left, 1.0, T, B))
    tx_d, td_s = _timed(lambda: torch.linalg.solve_triangular(
        tl, b, upper=False))
    tb_err = float((tx.to_dense() - tx_d).abs().max() / tx_d.abs().max())
    del T, tx, tx_d, tl, h
    g = _band_dense(gen, n, kl, kl, 3.0 * (2 * kl + 1))
    G = st.BandMatrix.from_numpy(g, kl, kl, nb)
    (F, X), wall = _timed(lambda: st.gbsv(G, B))
    _, wall_repeat = _timed(lambda: st.gbsv(G, B))
    res = _scaled_residual(g, X.to_dense(), b)
    x64, dense_s = _timed(lambda: torch.linalg.solve(g, b))
    fwd = float((X.to_dense() - x64).abs().max() / x64.abs().max())
    emit({"phase": "band_gbsv", "n": n, "kl": kl, "ku": kl, "nb": nb,
          "w": F.w, "wall_s": wall, "wall_s_repeat": wall_repeat,
          "residual": res, "residual_bound": BAND_RESIDUAL_BOUND,
          "forward_error_vs_dense_f64": fwd, "dense_solve_s": dense_s})
    if not (res < BAND_RESIDUAL_BOUND and fwd < 1e-12):
        failures.append(f"gbsv: residual {res}, forward {fwd}")
    gb_out, gb_s = _timed(lambda: st.gbmm(1.0, G, B))
    gd_out, gd_s = _timed(lambda: g @ b)
    gb_err = float((gb_out.to_dense() - gd_out).abs().max()
                   / gd_out.abs().max())
    emit({"phase": "band_products", "n": n, "nrhs": nrhs,
          "tbsm": {"kd": kd, "s": tb_s, "dense_trsm_s": td_s,
                   "rel_max_diff": tb_err},
          "gbmm": {"kl": kl, "ku": kl, "s": gb_s, "dense_matmul_s": gd_s,
                   "rel_max_diff": gb_err},
          "hbmm": {"kd": kd, "s": hb_s, "dense_matmul_s": hd_s,
                   "rel_max_diff": hb_err}, "tol": 1e-12})
    if not max(tb_err, gb_err, hb_err) < 1e-12:
        failures.append(f"band products: tbsm {tb_err}, gbmm {gb_err}, "
                        f"hbmm {hb_err}")


def check_hesv(st, gen, nb, reset, counts, failures) -> dict:
    """hesv (blocked Aasen) in f64 on a symmetric indefinite A, and one f32
    posv on an indefinite A whose ladder goes potrf -> hesv."""
    n = HESV_N
    g = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    a = (g + g.T) / 2
    del g
    b = torch.randn(n, 4, generator=gen, device="cuda", dtype=torch.float64)
    A = st.SymmetricMatrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    (F, X, h), wall = _timed(lambda: st.hesv(A, B, info))
    _, wall_repeat = _timed(lambda: st.hesv(A, B, info))
    res = _scaled_residual(a, X.to_dense(), b)
    x64, lib_s = _timed(lambda: torch.linalg.solve(a, b))
    fwd = float((X.to_dense() - x64).abs().max() / x64.abs().max())
    from slate_tpu_torch.robust import certify
    cert = certify.certify_ldlt(a, F.L, F.T_dense(), F.piv)
    emit({"phase": "hesv", "n": n, "nb": nb, "dtype": "float64",
          "wall_s": wall, "wall_s_repeat": wall_repeat,
          "factor": type(F).__name__, "ok": h.ok,
          "residual": res, "residual_bound": HESV_RESIDUAL_BOUND,
          "certify_ldlt_ratio": cert.growth,
          "certify_tolerance": certify.tolerance(torch.float64, n),
          "forward_error_vs_f64_solve": fwd, "library_solve_s": lib_s})
    if not (type(F).__name__ == "HEFactors" and h.ok
            and res < HESV_RESIDUAL_BOUND):
        failures.append(f"hesv: factor {type(F).__name__}, ok {h.ok}, "
                        f"residual {res}")
    del A, B, F, X, a, b, x64
    n = INDEF_POSV_N
    g = torch.randn(n, n, generator=gen, device="cuda")
    a = (g + g.T) / 2
    del g
    b = torch.randn(n, 4, generator=gen, device="cuda")
    A = st.SymmetricMatrix.from_numpy(a, nb)
    B = st.Matrix.from_numpy(b, nb)
    reset()
    (F, X, h), wall = _timed(lambda: st.posv(A, B, info))
    launches = counts()
    rungs = {"TriangularMatrix": ["potrf"],
             "HEFactors": ["potrf", "hesv"],
             "LUFactors": ["potrf", "hesv", "gesv"]}[type(F).__name__]
    x = X.to_dense().double()
    res = float((a.double() @ x - b.double()).abs().max()
                / (a.double().abs().sum(dim=1).max() * x.abs().max()))
    emit({"phase": "posv_indefinite_ladder", "n": n, "dtype": "float32",
          "wall_s": wall, "rungs": rungs, "ok": h.ok, "residual": res,
          "launches": launches})
    if not (rungs == ["potrf", "hesv"] and h.ok and res < 1e-5):
        failures.append(f"indefinite posv: rungs {rungs}, ok {h.ok}, "
                        f"residual {res}")
    return launches


def check_api(st, gen, nb, nrhs, reset, counts, failures) -> dict:
    """The API's batch verbs on (8, 1920, 1920) stacks with 16 right-hand
    sides ((8, 3840, 1920) for least squares): bit-equal to make_batched,
    K6/K7/K8 launched; least_squares_solve at 8192 x 4096 with
    MethodGels.QR: K5, 32 launches."""
    from slate_tpu_torch import api
    from slate_tpu_torch.serve import batched
    bsz, n, k = API_BATCH
    out = {}
    for verb, op, kernel in (
            ("batch_solve", "solve", "lu_panel_batched"),
            ("batch_chol_solve", "chol_solve", "chol_panel_batched"),
            ("batch_least_squares_solve", "least_squares_solve",
             "qr_panel_batched")):
        m = API_LSQ_M if op == "least_squares_solve" else n
        a = torch.randn(bsz, m, n, generator=gen, device="cuda")
        if op == "solve":
            a.diagonal(dim1=1, dim2=2).add_(n ** 0.5)
        elif op == "chol_solve":
            a = a @ a.transpose(1, 2) / n
            a.diagonal(dim1=1, dim2=2).add_(1.0)
        b = torch.randn(bsz, m, k, generator=gen, device="cuda")
        reset()
        (x, hs, esc), wall = _timed(lambda: getattr(api, verb)(a, b))
        launches = counts()
        sizes = torch.full((bsz,), m, dtype=torch.int32, device="cuda")
        x2, hs2, esc2 = batched.make_batched(op)(a, b, sizes)
        same = bool(torch.equal(x, x2)) and hs == hs2 and esc == esc2
        out[f"api_{verb}"] = launches
        emit({"phase": f"api_{verb}", "shape": [bsz, m, n], "nrhs": k,
              "wall_s": wall, "bit_equal_make_batched": same,
              "ok": all(h.ok for h in hs), "escalated": sum(esc),
              "launches": launches})
        if not (same and launches[kernel] > 0 and all(h.ok for h in hs)):
            failures.append(f"api.{verb}: bit-equal {same}, {kernel} "
                            f"{launches[kernel]}")
    mq, nq = GELS_SHAPE
    a, b, x64 = lstsq_problem(mq, nq, nrhs, gen)
    A, B = st.Matrix.from_numpy(a, nb), st.Matrix.from_numpy(b, nb)
    reset()
    X, wall = _timed(lambda: api.least_squares_solve(
        A, B, {st.Option.MethodGels: st.MethodGels.QR}))
    launches = counts()
    res, fwd = lstsq_accuracy(a, X.to_dense(), b, x64)
    out["api_least_squares_solve"] = launches
    emit({"phase": "api_least_squares_solve", "m": mq, "n": nq,
          "wall_s": wall, "scaled_ne_residual": res,
          "forward_error_vs_f64": fwd, "launches": launches})
    want = {name: 0 for name in launches}
    want["qr_panel"] = -(-nq // nb)
    if not (launches == want and res < GELS_RESIDUAL_BOUND
            and fwd < GELS_FORWARD_BOUND):
        failures.append(f"api.least_squares_solve: launches {launches}, "
                        f"residual {res}, forward {fwd}")
    return out


def check_slice12(st, seed, n, nb, nrhs, reset, counts) -> dict:
    """The slice-12 phases; returns the launch counts of their paths."""
    failures = []
    torch.cuda.empty_cache()
    out = check_mixed(st, torch.Generator(device="cuda").manual_seed(
        seed + 10), n, nb, nrhs, reset, counts, failures)
    torch.cuda.empty_cache()
    check_band(st, torch.Generator(device="cuda").manual_seed(seed + 11),
               n, nb, nrhs, failures)
    torch.cuda.empty_cache()
    out["posv_indefinite_ladder"] = check_hesv(
        st, torch.Generator(device="cuda").manual_seed(seed + 12), nb,
        reset, counts, failures)
    torch.cuda.empty_cache()
    out.update(check_api(st, torch.Generator(device="cuda").manual_seed(
        seed + 13), nb, nrhs, reset, counts, failures))
    if failures:
        raise AssertionError("slice 12: " + "; ".join(failures))
    return out


# ---- slice 13: the plan cache, its tuner, driver telemetry ----------------

# the tuner's grid: the sizes the main paths resolve (the tile ops at the
# reference rule's 128 and 512; the panels at the posv/gesv/gels widths;
# the batch ops at the stream's buckets 512 and 4096, f32 and bf16)
TUNE_GRID = ((("potrf_tile", "lu_select"), (128, 512), ("float32",)),
             (("potrf_panel", "getrf_panel", "geqrf_panel"),
              (1024, 8192, 20480), ("float32",)),
             (("batch_potrf", "batch_getrf", "batch_geqrf"), (512, 4096),
              ("float32", "bfloat16")))
# warm walls of the same paths before drivers carried @annotate, as
# PERF.md section 5 records them (H100 80GB HBM3, 700 W), printed beside
# this run's
PARENT_WALL_S = {"posv": 0.1564, "gesv_calu": 0.6865, "gels_qr": 0.0527,
                 "serve_stream": 0.4835}
OBS_WALL_REPS = 4


def set_plan_cache(path: str) -> None:
    """Point the port's plan cache at ``path`` and drop what was read."""
    from slate_tpu_torch.tune import plans
    os.environ["SLATE_TORCH_TUNE_CACHE"] = path
    plans.reload()


def check_tune(cache_path: str) -> dict:
    """tune: tune_all on the card into a fresh cache file over TUNE_GRID,
    every candidate's GFLOP/s and each winner printed; the file must pass
    validate_cache and hold every (op, n, dtype) of the grid under this
    card's kind.  Returns {(op, n, dtype): winner plan}."""
    from slate_tpu_torch.tune import autotune, plans
    set_plan_cache(cache_path)
    t0 = time.perf_counter()
    winners = {}
    for ops, ns, dtypes in TUNE_GRID:
        for dt in dtypes:
            def report(op, n, plan, gf, dt=dt):
                emit({"phase": "tune_candidate", "op": op, "n": n,
                      "dtype": dt, "kernel": plan.kernel, "bw": plan.bw,
                      "nb": plan.nb, "gflops": gf})
            for (op, n), (plan, gf) in autotune.tune_all(
                    ns=ns, ops=ops, dtype=dt, iters=3,
                    report=report).items():
                winners[(op, n, dt)] = plan
                emit({"phase": "tune_winner", "op": op, "n": n, "dtype": dt,
                      "kernel": plan.kernel, "bw": plan.bw, "nb": plan.nb,
                      "gflops": gf})
    seconds = time.perf_counter() - t0
    obj = plans.load_cache(cache_path)
    plans.validate_cache(obj)
    chip = plans.chip_kind()
    have = {(op, *plans._parse_key(k)) for op, ents in
            obj["chips"].get(chip, {}).items() for k in ents}
    emit({"phase": "tune", "seconds": seconds, "chip": chip,
          "entries": len(have), "ops": sorted({k[0] for k in have})})
    if have != set(winners) or len({k[0] for k in have}) != 8:
        raise AssertionError(f"tune: the cache holds {sorted(have)}, the "
                             f"grid {sorted(winners)}")
    return winners


@contextlib.contextmanager
def unannotated(st):
    """Every @annotate'd driver of the port swapped for its bare function
    in every module that binds it (all the wrappers share one code
    object): the drivers as they ran before this slice, for the walls."""
    code = st.posv.__code__
    swapped = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("slate_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if getattr(val, "__code__", None) is code:
                swapped.append((mod, attr, val))
                setattr(mod, attr, val.__wrapped__)
    try:
        yield len(swapped)
    finally:
        for mod, attr, val in swapped:
            setattr(mod, attr, val)


@contextlib.contextmanager
def outer_boundaries():
    """Counts the outermost driver boundaries this thread opens (the calls
    that must each emit one event)."""
    from slate_tpu_torch.obs import events
    real = events.boundary_enter
    count = [0]

    def spy(op, args=()):
        if getattr(events._TLS, "depth", 0) == 0:
            count[0] += 1
        return real(op, args)
    events.boundary_enter = spy
    try:
        yield count
    finally:
        events.boundary_enter = real


def span_totals(spans) -> dict:
    """Host ms the span tree gives each driver name (nested calls counted
    under their own names)."""
    out: dict[str, float] = {}
    for sp in spans:
        out[sp["name"]] = round(out.get(sp["name"], 0.0) + sp["dur_ms"], 3)
    return out


def expected_posv_launches(n: int, nb: int) -> dict:
    """K2, K0 and K1 launches of posv on an n x n f32 matrix as the
    resolved plans route its panels (the seams' own gates): a fused panel
    of m rows is K2's update, factor and, when m > nb, its solve with one
    K0; a library panel factors its diagonal tile through potrf_tile (K1
    under the "cuda" tile plan) and solves below with torch."""
    from slate_tpu_torch.internal.potrf import _tile_plan_ok, potrf_panel_ok
    want = {"chol_panel_fused": 0, "upper_tri_inv": 0, "chol_tile": 0}
    for k0 in range(0, n, nb):
        m = n - k0
        if potrf_panel_ok(torch.float32, m, nb, nb):
            want["chol_panel_fused"] += 3 if m > nb else 2
            want["upper_tri_inv"] += m > nb
        elif _tile_plan_ok(torch.float32, nb):
            want["chol_tile"] += 1
    return want


def calu_plan_launches(n: int, nb: int) -> dict:
    """K4 and K3 launches of CALU gesv as the resolved plans route its
    tournament rounds and panels (the seams' own gates)."""
    from slate_tpu_torch.internal.getrf import _lu_select_ok, _nopiv_fused_ok
    return expected_calu_launches(
        n, nb, lambda h: _lu_select_ok(
            torch.empty((1, h, nb), device="cuda"), nb),
        k3_fits=lambda w: _nopiv_fused_ok(
            torch.empty((w, nb), device="cuda")))


def resolved_plans(n: int, nb: int) -> dict:
    """Every plan the posv and CALU gesv paths at n resolve, per size:
    [n, kernel, bw, source, dist] rows."""
    from slate_tpu_torch.tune import plans

    def rows(op, sizes):
        return [[m, *(plans.resolution(op, m)[k] for k in
                      ("kernel", "bw", "source", "dist"))]
                for m in sorted(set(sizes), reverse=True)]
    widths = [n - k0 for k0 in range(0, n, nb)]
    return {"potrf_panel": rows("potrf_panel", widths),
            "potrf_tile": rows("potrf_tile", [nb]),
            "getrf_panel": rows("getrf_panel", [w for w in widths if w > nb]),
            "lu_select": rows("lu_select", [h for w in widths if w > nb
                                            for h in calu_rounds(w, nb)])}


def obs_paths(st, gen, n, nb, nrhs):
    """The obs phases' matrices (their own generator) and a runner a path:
    each returns (X dense, wall seconds)."""
    g = torch.randn(n, n, generator=gen, device="cuda")
    a_p = g @ g.T
    del g
    a_p.diagonal().add_(n)
    b_p = torch.randn(n, nrhs, generator=gen, device="cuda")
    a_g = orthogonal(n, gen)
    b_g = torch.randn(n, nrhs, generator=gen, device="cuda")
    mq, nq = GELS_SHAPE
    a_q, b_q, x64_q = lstsq_problem(mq, nq, nrhs, gen)
    calu = {st.Option.MethodLU: st.MethodLU.CALU}
    runs = {"posv": lambda: run_posv(st, a_p, b_p, nb),
            "gesv_calu": lambda: run_gesv(st, a_g, b_g, nb, calu)[1:],
            "gels_qr": lambda: run_gels(st, a_q, b_q, nb)}
    checks = {"posv": lambda x: accuracy(a_p, x, b_p, solve_f64(a_p, b_p)),
              "gesv_calu": lambda x: accuracy(a_g, x, b_g, torch.linalg.solve(
                  a_g.double(), b_g.double())),
              "gels_qr": lambda x: lstsq_accuracy(a_q, x, b_q, x64_q)}
    bounds = {"posv": (RESIDUAL_BOUND, FORWARD_BOUND),
              "gesv_calu": (GESV_RESIDUAL_BOUND, GESV_FORWARD_BOUND),
              "gels_qr": (GELS_RESIDUAL_BOUND, GELS_FORWARD_BOUND)}
    return runs, checks, bounds


EXPECTED_PATH = {"posv": ("posv", "direct:cholesky"),
                 "gesv_calu": ("gesv", "direct:CALU"),
                 "gels_qr": ("gels", "direct:qr")}


def median(xs) -> float:
    xs = sorted(xs)
    return 0.5 * (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2])


def walls(st, run) -> dict:
    """Warm walls of ``run`` with obs off, in turns with the same run with
    every driver unannotated (ABBA order, so neither side always runs
    first): the lists and their medians."""
    off, bare = [], []
    for i in range(OBS_WALL_REPS):
        for annotated in ((True, False) if i % 2 == 0 else (False, True)):
            if annotated:
                off.append(run()[1])
            else:
                with unannotated(st):
                    bare.append(run()[1])
    return {"wall_s_obs_off": off, "wall_s_unannotated": bare,
            "median_obs_off": median(off),
            "median_unannotated": median(bare)}


def check_obs_overhead(st) -> dict:
    """The instrumentation's own host cost on this machine: a call of an
    @annotate'd no-op driver against the bare no-op, with obs off and with
    events, spans and timing on, and a resolve_plan memo hit, in µs a
    call (best of 5 runs of 20000 calls)."""
    from slate_tpu_torch import obs
    from slate_tpu_torch.tune import plans
    from slate_tpu_torch.util.trace import annotate

    def bare():
        return None
    wrapped = annotate("slate.noop")(bare)

    def per_call(fn, reps=20000):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best / reps * 1e6
    out = {"bare_us": per_call(bare), "annotate_obs_off_us": per_call(wrapped)}
    with obs.recording(), obs.record_spans(), obs.timing():
        out["annotate_obs_on_us"] = per_call(wrapped)
    plans.resolve_plan("potrf_panel", 20480)
    out["resolve_plan_us"] = per_call(
        lambda: plans.resolve_plan("potrf_panel", 20480))
    emit({"phase": "obs_overhead", **out})
    return out


def check_obs_driver(st, name, run, check, bound_pair, reset, counts,
                     kernels, want, failures, out_dir):
    """One driver under obs.recording(), record_spans() and obs.timing():
    exactly one event, its fields, its default plans, the launches and
    bits of the same call with obs off, the span tree's times."""
    from slate_tpu_torch import obs
    x_warm, _ = run()                                  # warm, obs off
    del x_warm
    w = walls(st, run)
    reset()
    x_off, _ = run()
    off = counts()
    reset()
    with outer_boundaries() as outer, obs.recording() as evs, \
            obs.record_spans() as rec, obs.timing():
        x_on, wall_on = run()
    on = counts()
    res, fwd = check(x_on)
    events = [e for e in evs if e["kind"] == "event"]
    op, path = EXPECTED_PATH[name]
    ev = events[0] if events else {}
    rec.export_chrome_trace(os.path.join(out_dir, f"obs_{name}.json"))
    emit({"phase": f"obs_default_{name}", **w, "wall_s_obs_on": wall_on,
          "parent_wall_s": PARENT_WALL_S[name],
          "events": len(events), "outer_calls": outer[0],
          "event": {k: ev.get(k) for k in (
              "op", "shapes", "dtype", "path", "escalations", "policy",
              "speculate", "abft", "status", "device_ms", "mfu",
              "achieved_gbps", "dur_ms", "plans", "health")},
          "span_ms": span_totals(rec.spans), "launches_obs_off": off,
          "launches_obs_on": on, "scaled_residual": res,
          "forward_error": fwd})
    want = {**{k: 0 for k in kernels}, **want}
    bits = bool(torch.equal(x_on.view(torch.int32), x_off.view(torch.int32)))
    plans_ok = bool(ev.get("plans")) and all(
        p["source"] == "default" and p["kernel"] == "cuda"
        for p in ev.get("plans", []))
    if not (len(events) == outer[0] == 1 and ev.get("op") == op
            and ev.get("path") == path and ev.get("status") == "ok"
            and (ev.get("health") or {}).get("ok")
            and (ev.get("device_ms") or 0) > 0 and ev.get("mfu")
            and plans_ok):
        failures.append(f"obs_default {name}: events {len(events)} for "
                        f"{outer[0]} outermost calls, event {ev}")
    if not (on == off == want and bits):
        failures.append(f"obs_default {name}: launches on {on}, off {off}, "
                        f"want {want}; bits equal {bits}")
    if not (res < bound_pair[0] and fwd < bound_pair[1]):
        failures.append(f"obs_default {name}: residual {res}, forward {fwd}")
    return w["median_obs_off"], evs, rec


def check_obs_stream(st, reqs, reset, counts, failures, out_dir):
    """The 120-request stream under obs: a server warmed obs off, then its
    warm pass with events, spans and timing on against one with them off:
    one serve_batch record a batch, one event per outermost driver call
    (the escalations' safe rungs), the same launches, bit-equal results."""
    from slate_tpu_torch import obs
    srv, _, _ = run_stream(st, reqs)                 # cold: the captures

    def warm():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = srv.serve_batch(reqs)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    warm()
    w = walls(st, warm)
    reset()
    res_off, _ = warm()
    off = counts()
    nrec = len(srv.batch_records)
    reset()
    with outer_boundaries() as outer, obs.recording() as evs, \
            obs.record_spans() as rec, obs.timing():
        res_on, wall_on = warm()
    on = counts()
    batches = len(srv.batch_records) - nrec
    events = [e for e in evs if e["kind"] == "event"]
    records = [e for e in evs if e["kind"] == "serve_batch"]
    bits = all(torch.equal(a.x.view(torch.int32), b.x.view(torch.int32))
               for a, b in zip(res_on, res_off))
    rec.export_chrome_trace(os.path.join(out_dir, "obs_serve_stream.json"))
    emit({"phase": "obs_default_serve_stream", **w, "wall_s_obs_on": wall_on,
          "parent_wall_s": PARENT_WALL_S["serve_stream"],
          "serve_batch_records": len(records), "batches": batches,
          "events": len(events), "outer_calls": outer[0],
          "event_ops": sorted({e["op"] for e in events}),
          "batch_device_ms": [r.get("device_ms") for r in records],
          "span_ms": span_totals(rec.spans), "launches_obs_off": off,
          "launches_obs_on": on, "bits_equal": bits})
    if not (len(records) == batches and len(events) == outer[0]
            and on == off and bits
            and all(r.get("device_ms") is not None for r in records)):
        failures.append(f"obs_default stream: {len(records)} records for "
                        f"{batches} batches, {len(events)} events for "
                        f"{outer[0]} outermost calls, launches {on} vs "
                        f"{off}, bits equal {bits}")
    return w["median_obs_off"], evs, rec


def check_obs_tuned(st, runs, checks, bounds, n, nb, default_walls,
                    reset, counts, kernels, failures):
    """obs_tuned: posv and CALU gesv with the tuned cache: the plans each
    path resolves (exact or nearest, with their distance), launches equal
    to what those plans imply, accuracy, and each wall beside
    obs_default's."""
    from slate_tpu_torch import obs
    from slate_tpu_torch.tune import plans
    emit({"phase": "obs_tuned_plans", **resolved_plans(n, nb)})
    # what the card's tuner picks where K4 and K5 now take 256 .. 512
    picks = {}
    for op, ms in (("lu_select", (128, 512)),
                   ("geqrf_panel", (1024, 8192, 20480))):
        for m in ms:
            plan = plans.resolve_plan(op, m, "float32")
            picks[f"{op}@{m}"] = {"kernel": plan.kernel, "nb": plan.nb,
                                  "bw": plan.bw}
    emit({"phase": "obs_tuned_wide_picks", "picks": picks})
    want = {"posv": expected_posv_launches(n, nb),
            "gesv_calu": calu_plan_launches(n, nb)}
    for name in ("posv", "gesv_calu"):
        runs[name]()                                    # warm
        tuned = [runs[name]()[1] for _ in range(OBS_WALL_REPS)]
        reset()
        with obs.recording() as evs:
            x, _ = runs[name]()
        got = counts()
        res, fwd = checks[name](x)
        ev = next((e for e in evs if e["kind"] == "event"), {})
        full = {**{k: 0 for k in kernels}, **want[name]}
        emit({"phase": f"obs_tuned_{name}", "wall_s_tuned": tuned,
              "median_tuned": median(tuned),
              "median_default": default_walls[name],
              "event_plans": ev.get("plans"), "launches": got,
              "launches_predicted": full, "scaled_residual": res,
              "forward_error": fwd})
        sources = {p["source"] for p in ev.get("plans", [])}
        if not (got == full and sources and sources <= {"exact", "nearest"}
                and res < bounds[name][0] and fwd < bounds[name][1]):
            failures.append(f"obs_tuned {name}: launches {got} (plans imply "
                            f"{full}), sources {sources}, residual {res}, "
                            f"forward {fwd}")


def check_obs_cli(out_dir, records, spans_rec, default_walls, card,
                  failures):
    """obs_cli: the metrics CLI over the recorded JSONL (the per-op,
    plan-usage and serving tables), compare of a bench file of the obs-off
    walls against itself, and slo against a budgets file: each exits 0."""
    events_path = os.path.join(out_dir, "obs_events.jsonl")
    with open(events_path, "w", encoding="utf-8") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    spans_path = os.path.join(out_dir, "obs_spans.jsonl")
    spans_rec.export_jsonl(spans_path)
    bench_path = os.path.join(out_dir, "obs_walls.jsonl")
    with open(bench_path, "w", encoding="utf-8") as fh:
        for name, wall in default_walls.items():
            fh.write(json.dumps({"schema": "slate-bench-v1",
                                 "metric": f"{name}_wall_ms",
                                 "value": wall * 1e3, "unit": "ms",
                                 "chip": card}) + "\n")
    budgets_path = os.path.join(out_dir, "obs_budgets.json")
    with open(budgets_path, "w", encoding="utf-8") as fh:
        json.dump({"*": {"problems": 1, "latency_p99_ms": 600000.0}}, fh)
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    cli = [sys.executable, "-m", "slate_tpu_torch.obs"]
    for tag, args, must in (
            ("metrics", [events_path, spans_path],
             ("per-op events", "plan usage", "serving")),
            ("compare", ["--compare", bench_path, bench_path],
             ("0 regressed",)),
            ("slo", ["--slo", budgets_path, events_path],
             ("budget check(s) passed",))):
        out = subprocess.run(cli + args, capture_output=True, text=True,
                             timeout=300, cwd=ROOT, env=env)
        emit({"phase": f"obs_cli_{tag}", "rc": out.returncode,
              "stdout": out.stdout.splitlines()[:40],
              "stderr": out.stderr.splitlines()[-5:]})
        if out.returncode != 0 or not all(m in out.stdout for m in must):
            failures.append(f"obs_cli {tag}: rc {out.returncode}")


def check_slice13(st, seed, n, nb, nrhs, serve_reqs, reset, counts,
                  kernels, card, shield_path) -> dict:
    """The slice-13 phases (tune, obs_default, obs_tuned, obs_cli); their
    matrices draw from --seed + 14.  Returns the launch counts of their
    paths."""
    failures = []
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()
    tuned_path = os.path.join(os.path.dirname(shield_path), "tuned.json")
    check_tune(tuned_path)
    shutil.copy(tuned_path, os.path.join(out_dir, "tuned_plans.json"))
    set_plan_cache(shield_path)
    torch.cuda.empty_cache()
    runs, checks, bounds = obs_paths(
        st, torch.Generator(device="cuda").manual_seed(seed + 14), n, nb,
        nrhs)
    main_want = {"posv": {"chol_panel_fused": 3 * (n // nb) - 1,
                          "upper_tri_inv": n // nb - 1},
                 "gesv_calu": calu_plan_launches(n, nb),
                 "gels_qr": {"qr_panel": -(-GELS_SHAPE[1] // nb)}}
    check_obs_overhead(st)
    default_walls, records = {}, []
    spans = st.obs.SpanRecorder()       # every phase's spans, for the CLI
    for name in ("posv", "gesv_calu", "gels_qr"):
        default_walls[name], evs, rec = check_obs_driver(
            st, name, runs[name], checks[name], bounds[name], reset, counts,
            kernels, main_want[name], failures, out_dir)
        records += evs
        spans.spans += rec.spans
    default_walls["serve_stream"], evs, rec = check_obs_stream(
        st, serve_reqs, reset, counts, failures, out_dir)
    records += evs
    spans.spans += rec.spans
    set_plan_cache(tuned_path)
    check_obs_tuned(st, runs, checks, bounds, n, nb, default_walls, reset,
                    counts, kernels, failures)
    set_plan_cache(shield_path)
    check_obs_cli(out_dir, records, spans, default_walls, card, failures)
    if failures:
        raise AssertionError("slice 13: " + "; ".join(failures))
    return {"obs_default_" + k: v for k, v in main_want.items()}



# ---- slice 14: the spectral drivers ---------------------------------------

# BASELINE.md config 5 ("dheev two-stage + dgesvd n=30k") cut to one card
# and to the smoke's time: n = 4096 in f32 (and one heev in f64; 8192
# before slice 23, 6144 before slice 24, whose phases took the
# difference; the mesh routes of slice 18 keep DIST_SPEC_N)
SPEC_N = 4096
# the chase routes (MethodEig DC and QR, MethodSvd Bidiag) and the fault
# drills: a chase runs its steps one after another, ~37 launches a step
# for hb2st and ~66 for tb2bd, and n = 1024 takes 4600 steps against
# n = 512's 1276, so n is cut to 512 to keep the smoke inside its time
SPEC_PARITY_N = 512
STEDC_N = 4096
# max|w - lambda| / max|lambda| (and max|s - sigma| / sigma_0): about
# 4 n eps_f32 at n = 6144-8192 for f32 (eigenvalues move by at most the
# backward error's norm, O(n eps ||A||) for the library's routines; the
# library's own dense call on the same A is printed beside, as
# `library_rel_err`); the f64 routes at rounding level
SPEC_BOUND = {torch.float32: 2e-3, torch.float64: 1e-10}
# ||A X - B X diag(w)||_F / (||A||_F ||X||_F), B = G G^T + n I (cond ~5)
HEGV_BOUND = 1e-4
# a parity route's values against the Auto route's, relative to max|w|
PARITY_BOUND = 2e-3


def spectral_matrix(kind: str, n: int, gen, dtype):
    """The generator's heev or svd matrix (util/generator.py:61-73) built
    on the card: sigma_i = 1e3^(-i/(n-1)), Q from the QR of a seeded
    Gaussian; heev: A = Q diag(lambda) Q^T with lambda = linspace(-1, 1,
    n) * sigma reversed, svd: A = U diag(sigma) V^T.  Formed in f64,
    rounded to ``dtype``.  Returns (A, the exact spectrum ascending, or
    the singular values descending)."""
    f64 = torch.float64
    sigma = 1e3 ** (-torch.arange(n, dtype=f64, device="cuda") / (n - 1))
    q1, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, device="cuda",
                                        dtype=f64))
    if kind == "heev":
        lam = torch.linspace(-1.0, 1.0, n, dtype=f64, device="cuda") \
            * sigma.flip(0)
        a = (q1 * lam) @ q1.T
        a = (a + a.T) / 2
        return a.to(dtype), torch.sort(lam).values
    q2, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, device="cuda",
                                        dtype=f64))
    return ((q1 * sigma) @ q2.T).to(dtype), sigma


def heev_split(st, a, nb, opts=None) -> dict:
    """heev's phases one after another, each synced (host clock): the
    spans' work (he2hb with the band gather, stage2, backtransform,
    certify) as heev_info runs it."""
    from slate_tpu_torch.drivers import heev as H
    from slate_tpu_torch.robust import certify
    n = a.shape[0]
    ad = st.HermitianMatrix.from_numpy(a, nb).to_dense()
    stacks, t1 = _timed(lambda: H._he2hb_scan(ad, nb))
    band, t1b = _timed(lambda: H._band_from_stacks(stacks[2], stacks[3], n,
                                                   nb))
    (w, Z2, _), t2 = _timed(lambda: H._stage2_eig(band, nb, True, opts))

    def back():
        zp = torch.zeros((stacks[2].shape[0] * nb, n), dtype=Z2.dtype,
                         device="cuda")
        zp[:n] = Z2
        return H._unmtr_he2hb_stack(stacks[0], stacks[1], nb, zp)[:n]
    Z, t3 = _timed(back)
    cert, t4 = _timed(lambda: certify.certify_eig(ad, w, Z).to_list()[0])
    return {"he2hb": t1 + t1b, "stage2": t2, "backtransform": t3,
            "certify": t4, "certificate_ratio": cert.growth}


def svd_split(st, a, nb, opts=None) -> dict:
    """svd's phases one after another, each synced (host clock)."""
    from slate_tpu_torch.drivers import svd as S
    from slate_tpu_torch.robust import certify
    m, n = a.shape
    stacks, t1 = _timed(lambda: S._ge2tb_scan(a, nb))
    band, t1b = _timed(lambda: S._band_upper_from_stacks(stacks[4],
                                                         stacks[5], n, nb))
    (s, Un, Vn, _), t2 = _timed(lambda: S._stage2_svd(band, nb, True, opts))

    def back():
        Mp, Np = stacks[0].shape[1], -(-n // nb) * nb
        up = torch.zeros((Mp, n), dtype=a.dtype, device="cuda")
        up[:n] = Un
        vp = torch.zeros((Np, n), dtype=a.dtype, device="cuda")
        vp[:n] = Vn
        return (S._unmbr_ge2tb_u(stacks[0], stacks[1], nb, up)[:m],
                S._unmbr_ge2tb_v(stacks[2], stacks[3], nb, vp)[:n])
    (U, V), t3 = _timed(back)
    cert, t4 = _timed(lambda: certify.certify_svd(a, s, U, V).to_list()[0])
    return {"ge2tb": t1 + t1b, "stage2": t2, "backtransform": t3,
            "certify": t4, "certificate_ratio": cert.growth}


def span_ms(st, fn) -> dict:
    """The recorded spans of one ``fn()`` (host clock, not synced inside:
    a span's kernels may still run when it closes), ms by name."""
    with st.obs.record_spans() as rec:
        _timed(fn)
    return span_totals(rec.spans)


def check_heev_full(st, gen, dtype, nb, reset, counts, failures):
    """heev at n = SPEC_N on the generator's heev matrix: cold and warm
    with vectors, heev_vals, the synced phase split, the certificate's
    ratio against its tolerance and the eigenvalues against the exact
    spectrum, beside the library's dense eigensolver on the same A.
    Returns (A, the launch counts of the cold call)."""
    from slate_tpu_torch.robust import certify
    n = SPEC_N
    a, lam = spectral_matrix("heev", n, gen, dtype)
    A = st.HermitianMatrix.from_numpy(a, nb)
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    reset()
    (w, Z, h), cold = _timed(lambda: st.heev(A, info))
    launches = counts()
    (w, Z, h), warm = _timed(lambda: st.heev(A, info))
    (wv, hv), t_vals = _timed(lambda: st.heev_vals(A, info))
    scale = float(lam.abs().max())
    err = float((w.double() - lam).abs().max()) / scale
    err_vals = float((wv.double() - lam).abs().max()) / scale
    wl, t_lib = _timed(lambda: torch.linalg.eigh(a))
    lib_err = float((wl[0].double() - lam).abs().max()) / scale
    cert = certify.certify_eig(a, w, Z.to_dense()).to_list()[0]
    tol = certify.tolerance(dtype, n)
    split = heev_split(st, a, nb)
    name = f"heev_{str(dtype)[6:]}"
    emit({"phase": name, "n": n, "nb": nb, "dtype": str(dtype)[6:],
          "wall_s_cold": cold, "wall_s": warm, "heev_vals_s": t_vals,
          "library_eigh_s": t_lib, "phase_s": split,
          "spans_ms": span_ms(st, lambda: st.heev(A)),
          "certificate_ratio": cert.growth, "certify_tolerance": tol,
          "rel_err": err, "rel_err_vals": err_vals,
          "library_rel_err": lib_err, "bound": SPEC_BOUND[dtype],
          "ok": h.ok and hv.ok, "launches": launches})
    if not (h.ok and hv.ok and cert.converged and cert.growth <= tol
            and err <= SPEC_BOUND[dtype] and err_vals <= SPEC_BOUND[dtype]
            and Z.m == n and torch.isfinite(Z.to_dense()).all()):
        failures.append(f"{name}: ok {h.ok}/{hv.ok}, certificate "
                        f"{cert.growth} (tol {tol}), rel err {err}/"
                        f"{err_vals} (bound {SPEC_BOUND[dtype]})")
    if any(launches.values()):
        failures.append(f"{name}: launched {launches}, want none")
    return a, launches


def check_svd_full(st, gen, nb, reset, counts, failures) -> dict:
    from slate_tpu_torch.robust import certify
    n = SPEC_N
    a, sigma = spectral_matrix("svd", n, gen, torch.float32)
    A = st.Matrix.from_numpy(a, nb)
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    reset()
    (s, U, V, h), cold = _timed(lambda: st.svd(A, info))
    launches = counts()
    (s, U, V, h), warm = _timed(lambda: st.svd(A, info))
    (sv, hv), t_vals = _timed(lambda: st.svd_vals(A, info))
    err = float((s.double() - sigma).abs().max() / sigma[0])
    err_vals = float((sv.double() - sigma).abs().max() / sigma[0])
    sl, t_lib = _timed(lambda: torch.linalg.svd(a))
    lib_err = float((sl[1].double() - sigma).abs().max() / sigma[0])
    cert = certify.certify_svd(a, s, U.to_dense(), V.to_dense()).to_list()[0]
    tol = certify.tolerance(torch.float32, n)
    emit({"phase": "svd_float32", "m": n, "n": n, "nb": nb,
          "wall_s_cold": cold, "wall_s": warm, "svd_vals_s": t_vals,
          "library_svd_s": t_lib, "phase_s": svd_split(st, a, nb),
          "certificate_ratio": cert.growth, "certify_tolerance": tol,
          "rel_err": err, "rel_err_vals": err_vals,
          "library_rel_err": lib_err, "bound": SPEC_BOUND[torch.float32],
          "ok": h.ok and hv.ok, "launches": launches})
    if not (h.ok and hv.ok and cert.converged and cert.growth <= tol
            and err <= SPEC_BOUND[torch.float32]
            and err_vals <= SPEC_BOUND[torch.float32]):
        failures.append(f"svd: ok {h.ok}/{hv.ok}, certificate {cert.growth} "
                        f"(tol {tol}), rel err {err}/{err_vals}")
    if any(launches.values()):
        failures.append(f"svd: launched {launches}, want none")
    return launches


def check_hegv(st, a, gen, nb, reset, counts, failures) -> dict:
    """hegv itype 1 on the heev matrix and B = G G^T + n I (posv's SPD):
    potrf launches K2 and K0 as posv does; hegst's solves are library."""
    n = a.shape[0]
    g = torch.randn(n, n, generator=gen, device="cuda")
    b = g @ g.T
    del g
    b.diagonal().add_(n)
    A = st.HermitianMatrix.from_numpy(a, nb)
    B = st.HermitianMatrix.from_numpy(b, nb)
    reset()
    (w, X), wall = _timed(lambda: st.hegv(A, B))
    launches = counts()
    _, wall_warm = _timed(lambda: st.hegv(A, B))
    x = X.to_dense()
    r = a @ x - (b @ x) * w[None, :]
    ratio = float(torch.linalg.norm(r) / (torch.linalg.norm(a)
                                          * torch.linalg.norm(x)))
    want = {**{k: 0 for k in launches}, **expected_posv_launches(n, nb)}
    emit({"phase": "hegv", "itype": 1, "n": n, "nb": nb,
          "wall_s_cold": wall, "wall_s": wall_warm, "residual_ratio": ratio,
          "bound": HEGV_BOUND, "launches": launches,
          "expected_posv_launches": want})
    if launches != want or not ratio <= HEGV_BOUND:
        failures.append(f"hegv: launches {launches} (want {want}), "
                        f"residual {ratio}")
    return launches


def chase_launches(st, route: str, nb: int, gen) -> dict:
    """Kernel launches a chase step takes, counted by torch.profiler on a
    chase of a 512 x 512 band (the same step at any n: a step touches a
    kd-wide window and, with vectors, kd columns of Q)."""
    from torch.profiler import ProfilerActivity, profile
    from slate_tpu_torch.drivers import heev as H
    from slate_tpu_torch.drivers import svd as S
    n = 512
    g = torch.randn(n, n, generator=gen, device="cuda")
    if route == "hb2st":
        band = torch.tril(torch.triu(g + g.T, -nb), nb)
        fn = lambda: H._hb2st(band, nb, True)           # noqa: E731
    else:
        band = torch.triu(torch.tril(g, nb))
        fn = lambda: S._tb2bd(band, nb, True)           # noqa: E731
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    k = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    steps = H._chase_steps(n, nb)
    return {"profiled_n": n, "profiled_steps": steps, "kernels": k,
            "kernels_per_step": k / steps}


def check_parity_routes(st, gen, nb, failures) -> dict:
    """heev with MethodEig DC and QR and svd with MethodSvd Bidiag at n =
    SPEC_PARITY_N, each against the Auto route's values."""
    from slate_tpu_torch.drivers import heev as H
    n = SPEC_PARITY_N
    a, _ = spectral_matrix("heev", n, gen, torch.float32)
    A = st.HermitianMatrix.from_numpy(a, nb)
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info,
            st.Option.UseFallbackSolver: False}
    w0 = st.heev(A, info)[0]
    scale = float(w0.abs().max())
    steps = H._chase_steps(n, nb)
    per = {r: chase_launches(st, r, nb, gen) for r in ("hb2st", "tb2bd")}
    for route in ("DC", "QR"):
        o = {**info, st.Option.MethodEig: getattr(st.MethodEig, route)}
        (w, Z, h), wall = _timed(lambda: st.heev(A, o))
        diff = float((w - w0).abs().max()) / scale
        emit({"phase": f"heev_parity_{route}", "n": n, "nb": nb,
              "wall_s": wall, "chase_steps": steps,
              "chase_launches_per_step": per["hb2st"],
              "chase_launches_est": round(per["hb2st"]["kernels_per_step"]
                                          * steps),
              "rel_diff_vs_auto": diff, "bound": PARITY_BOUND,
              "ok": h.ok})
        if not (h.ok and diff <= PARITY_BOUND):
            failures.append(f"heev {route}: ok {h.ok}, vs Auto {diff}")
    g = spectral_matrix("svd", n, gen, torch.float32)[0]
    G = st.Matrix.from_numpy(g, nb)
    s0 = st.svd(G, {**info})[0]
    o = {**info, st.Option.MethodSvd: st.MethodSvd.Bidiag}
    (s, U, V, h), wall = _timed(lambda: st.svd(G, o))
    diff = float((s - s0).abs().max() / s0[0])
    emit({"phase": "svd_parity_Bidiag", "n": n, "nb": nb, "wall_s": wall,
          "chase_steps": steps, "chase_launches_per_step": per["tb2bd"],
          "chase_launches_est": round(per["tb2bd"]["kernels_per_step"]
                                      * steps),
          "rel_diff_vs_auto": diff, "bound": PARITY_BOUND,
          "ok": h.ok})
    if not (h.ok and diff <= PARITY_BOUND):
        failures.append(f"svd Bidiag: ok {h.ok}, vs Auto {diff}")
    return per


def glued_wilkinson(n: int):
    """Glued W21+ blocks (couplings 1e-8 between blocks), n // 21 of them:
    the classic divide and conquer deflation stress."""
    k = n // 21
    w21 = torch.arange(-10, 11, dtype=torch.float32, device="cuda").abs()
    d = w21.repeat(k)
    e = torch.ones(21 * k - 1, device="cuda")
    e[20::21] = 1e-8
    return d, e


def check_stedc(st, gen, failures) -> None:
    """stedc at n = STEDC_N on a seeded random tridiagonal and on glued
    Wilkinson matrices: the certificate, the wall, the peak device memory
    of the call (its top merge holds the peak)."""
    from slate_tpu_torch.drivers import stedc as D
    from slate_tpu_torch.robust import certify
    cases = {"random": (torch.randn(STEDC_N, generator=gen, device="cuda"),
                        torch.randn(STEDC_N - 1, generator=gen,
                                    device="cuda")),
             "glued_wilkinson": glued_wilkinson(STEDC_N)}
    for name, (d, e) in cases.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ((w, Z), h), wall = _timed(lambda: D.stedc_info(d, e))
        peak = torch.cuda.max_memory_allocated() - base
        T = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
        cert = certify.certify_eig(T, w, Z).to_list()[0]
        w64 = torch.linalg.eigvalsh(T.double())
        err = float((w.double() - w64).abs().max() / w64.abs().max())
        n = d.shape[0]
        tol = certify.tolerance(torch.float32, n)
        emit({"phase": f"stedc_{name}", "n": n, "wall_s": wall,
              "certificate_ratio": cert.growth, "certify_tolerance": tol,
              "rel_err_vs_f64_eigvalsh": err,
              "peak_mib": peak / 2 ** 20, "ok": h.ok})
        if not (h.ok and cert.converged and err <= SPEC_BOUND[torch.float32]):
            failures.append(f"stedc {name}: ok {h.ok}, certificate "
                            f"{cert.growth}, rel err {err}")


def check_spectral_faults(st, gen, nb, failures) -> None:
    """The spectral fault drills of robust/faults.py: each escalates (or
    raises) as the ladders say, the path noted in the call's event."""
    from slate_tpu_torch.robust import faults
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}

    def drill(name, plan, call, want_path):
        with faults.inject(plan), st.obs.recording() as evs:
            out, wall = _timed(call)
        h = out[-1]
        ev = evs[-1]
        emit({"phase": f"fault_{name}", "site": plan.site,
              "transient": plan.transient, "kind": plan.kind,
              "path": ev.get("path"), "escalations": ev.get("escalations"),
              "ok": h.ok, "wall_s": wall})
        if not (h.ok and ev.get("path") == want_path):
            failures.append(f"fault {name}: ok {h.ok}, path "
                            f"{ev.get('path')} (want {want_path})")

    a, _ = spectral_matrix("heev", SPEC_PARITY_N, gen, torch.float32)
    A = st.HermitianMatrix.from_numpy(a, nb)
    drill("heev_transient_backtransform",
          faults.FaultPlan(site="post_backtransform", kind="bitflip",
                           seed=5, count=1, transient=True),
          lambda: st.heev(A, info), "escalated:DC")
    drill("heev_persistent_secular_dc_to_qr",
          faults.FaultPlan(site="post_secular", kind="nan", seed=7,
                           count=8),
          lambda: st.heev(A, {**info, st.Option.MethodEig:
                              st.MethodEig.DC}), "escalated:QR")
    g, _ = spectral_matrix("svd", SPEC_PARITY_N, gen, torch.float32)
    G = st.Matrix.from_numpy(g, nb)
    drill("svd_transient_stage1",
          faults.FaultPlan(site="post_stage1", kind="nan", seed=17,
                           count=4, transient=True),
          lambda: st.svd(G, info), "escalated:Bidiag")
    d = torch.randn(SPEC_PARITY_N, generator=gen, device="cuda")
    e = torch.randn(SPEC_PARITY_N - 1, generator=gen, device="cuda")
    plan = faults.FaultPlan(site="post_secular", kind="nan", seed=2,
                            count=8)
    with faults.inject(plan):
        *_, h = st.stedc(d, e, opts=info)
    raised = False
    with faults.inject(plan):
        try:
            st.stedc(d, e)
        except st.SlateNotConvergedError:
            raised = True
    emit({"phase": "fault_stedc_secular", "n": SPEC_PARITY_N, "detected":
          not h.ok, "raised_under_raise_policy": raised})
    if h.ok or not raised:
        failures.append(f"stedc post_secular: detected {not h.ok}, raised "
                        f"{raised}")


def trace_spectral(st, heev_a, gen, nb) -> None:
    """One warm heev and one warm svd at SPEC_N by span (host clock) and
    by device operation (torch.profiler), with the device's idle share."""
    A = st.HermitianMatrix.from_numpy(heev_a, nb)
    st.heev(A)
    emit({"phase": "trace_spans", "of": "heev",
          "spans_ms": span_ms(st, lambda: st.heev(A))})
    profile_device("heev", lambda: st.heev(A), cpu=False)
    g, _ = spectral_matrix("svd", SPEC_N, gen, torch.float32)
    G = st.Matrix.from_numpy(g, nb)
    st.svd(G)
    emit({"phase": "trace_spans", "of": "svd",
          "spans_ms": span_ms(st, lambda: st.svd(G))})
    profile_device("svd", lambda: st.svd(G), cpu=False)


def check_slice14(st, seed, nb, reset, counts, trace) -> dict:
    """The slice-14 phases (the spectral drivers); their matrices draw
    from --seed + 15.  Returns the launch counts of their paths."""
    failures = []
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    out = {}
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    a32, out["heev_float32"] = check_heev_full(st, gen, torch.float32, nb,
                                               reset, counts, failures)
    emit({"phase": "seconds", "of": "heev_float32",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    _, out["heev_float64"] = check_heev_full(st, gen, torch.float64, nb,
                                             reset, counts, failures)
    emit({"phase": "seconds", "of": "heev_float64",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out["svd_float32"] = check_svd_full(st, gen, nb, reset, counts,
                                        failures)
    emit({"phase": "seconds", "of": "svd_float32",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    out["hegv"] = check_hegv(st, a32, gen, nb, reset, counts, failures)
    emit({"phase": "seconds", "of": "hegv",
          "seconds": time.perf_counter() - t0})
    if trace:
        with phase_limit("trace_spectral", TRACE_SPECTRAL_LIMIT_S):
            trace_spectral(st, a32, gen, nb)
    del a32
    torch.cuda.empty_cache()
    for name, fn in (("parity_routes",
                      lambda: check_parity_routes(st, gen, nb, failures)),
                     ("stedc", lambda: check_stedc(st, gen, failures)),
                     ("spectral_faults",
                      lambda: check_spectral_faults(st, gen, nb, failures))):
        t0 = time.perf_counter()
        fn()
        emit({"phase": "seconds", "of": name,
              "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError("slice 14: " + "; ".join(failures))
    return out


# ---- slice 15: durable jobs and compatibility (--seed + 16) ----
OOC_N = 16384             # potrf_ooc (cut from the main path's 20480 to
#                           keep the smoke's margin)
GETRF_OOC_N = 12288       # getrf_ooc, no hand kernel (16384 before slice 24)
OOC_NB = 128              # potrf_ooc's panel: K1 takes its f32 diagonal tile
DRILL_N = 4096            # the kill-and-resume drill (32 and 16 steps)
DRILL_EVERY = 4           # the killed run's cadence
SHIM_N = 4096             # the LAPACK shims and the C entry points, f64
SHIM_NRHS = 16
EPS64 = 2.0 ** -52


def ooc_traffic(op: str, m: int, n: int, nb: int, itemsize: int) -> tuple:
    """(H2D, D2H) bytes of the reference's out-of-core loops: potrf_ooc
    brings in each step's panel and every earlier block column below the
    diagonal and writes the panel back; getrf_ooc brings in and writes
    back the panel and every trailing block column below the diagonal."""
    h2d = d2h = 0
    if op == "potrf_ooc":
        for si, k0 in enumerate(range(0, n, nb)):
            w = min(k0 + nb, n) - k0
            h2d += (n - k0) * (w + si * nb)
            d2h += (n - k0) * w
    else:
        for k0 in range(0, min(m, n), nb):
            h2d += (m - k0) * (n - k0)
            d2h += (m - k0) * (n - k0)
    return h2d * itemsize, d2h * itemsize


def ooc_profile(fn) -> tuple:
    """One ``fn()`` under torch.profiler: (its result, the kernels' and the
    copies' device busy time apart, their union against the wall (the
    device's idle share) and their overlap, kernels + copies - union: how
    much of the copying ran while the update did)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, wall = _timed(fn)
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.name.startswith("slate.")]
    copies = [e for e in ev if e.name.startswith("Memcpy")]
    kernels = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
    if not ev:
        return out, {"profiled_wall_s": wall,
                     "device_idle_share": "not measured"}
    kb = _busy_seconds(kernels) if kernels else 0.0
    cb = _busy_seconds(copies) if copies else 0.0
    ub = _busy_seconds(ev)
    return out, {"profiled_wall_s": wall, "kernel_busy_s": kb,
                 "copy_busy_s": cb, "device_busy_s": ub,
                 "device_idle_share": 1 - ub / wall,
                 "copy_compute_overlap_s": kb + cb - ub,
                 "kernel_events": len(kernels), "copy_events": len(copies)}


def rel_factor_residual(a, lhs) -> float:
    """||A - lhs||_F / ||A||_F in f64 on the card."""
    a64 = a.double()
    return float(torch.linalg.norm(a64 - lhs) / torch.linalg.norm(a64))


def check_potrf_ooc(st, gen, nrhs, reset, counts, kernels, card,
                    failures) -> dict:
    """potrf_ooc at n = OOC_N, f32, nb = 128, on the posv matrix (A = G
    G^T + n I): the factor against the in-core potrf's, its residual, K1
    once a step, the TileMap's traffic, walls beside in-core posv's and
    the device's idle share."""
    from slate_tpu_torch.core import storage
    n, nb = OOC_N, OOC_NB
    g = torch.randn(n, n, generator=gen, device="cuda")
    a = g @ g.T
    del g
    a.diagonal().add_(n)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    a_h = a.cpu().numpy()
    l_in = st.potrf(st.HermitianMatrix.from_numpy(a, nb)).to_dense()
    _, posv_cold = run_posv(st, a, b, nb)
    _, posv_warm = run_posv(st, a, b, nb)
    del b
    reset()
    storage.reset_traffic()
    lfac, wall = _timed(lambda: st.potrf_ooc(a_h, nb=nb))
    launches = counts()
    traffic = dict(storage.TRAFFIC)
    lfac2, wall_warm = _timed(lambda: st.potrf_ooc(a_h, nb=nb))
    repeat = bool(np.array_equal(lfac, lfac2))
    del lfac2
    _, prof = ooc_profile(lambda: st.potrf_ooc(a_h, nb=nb))
    lt = torch.from_numpy(lfac).cuda()
    agree = float((lt - l_in).abs().max() / l_in.abs().max())
    l64 = lt.double()
    res = rel_factor_residual(a, l64 @ l64.T)
    del l64
    li64 = l_in.double()
    res_in = rel_factor_residual(a, li64 @ li64.T)
    del li64, lt, l_in, a
    h2d, d2h = ooc_traffic("potrf_ooc", n, n, nb, 4)
    want = {**{name: 0 for name in kernels}, "chol_tile": -(-n // nb)}
    bound = n * EPS32
    emit({"phase": "potrf_ooc", "n": n, "nb": nb, "dtype": "float32",
          "rel_max_diff_vs_incore_potrf": agree, "tol": RTOL,
          "factor_residual": res, "incore_factor_residual": res_in,
          "residual_bound": bound, "launches": launches,
          "h2d_bytes": traffic["h2d"], "h2d_bytes_expected": h2d,
          "d2h_bytes": traffic["d2h"], "d2h_bytes_expected": d2h,
          "wall_s": wall, "wall_s_warm": wall_warm,
          "h2d_gbps_warm": traffic["h2d"] / wall_warm / 1e9,
          "incore_posv_wall_s": posv_cold, "incore_posv_wall_s_warm":
          posv_warm, "bitwise_repeatable": repeat, **prof, "card": card})
    if not (np.isfinite(lfac).all() and lfac.shape == (n, n)):
        failures.append("potrf_ooc: non-finite or misshapen factor")
    if not (agree <= RTOL and res < bound and repeat):
        failures.append(f"potrf_ooc: diff {agree} (tol {RTOL}), residual "
                        f"{res} (bound {bound}), repeatable {repeat}")
    if launches != want or (traffic["h2d"], traffic["d2h"]) != (h2d, d2h):
        failures.append(f"potrf_ooc: launches {launches} (want {want}), "
                        f"traffic {traffic} (want {h2d}, {d2h})")
    return launches


def check_getrf_ooc(st, gen, nb, nrhs, reset, counts, kernels, card,
                    failures) -> dict:
    """getrf_ooc at n = GETRF_OOC_N, f32, at the default width on the gesv
    matrix (A = Q of a Gaussian): the residual of A[perm] = L U, the solve
    through getrs on its factors beside the in-core partial-pivot gesv,
    the traffic, the walls and the idle share."""
    from slate_tpu_torch.core import storage
    from slate_tpu_torch.tune.plans import ooc_panel_width
    n = GETRF_OOC_N
    width = ooc_panel_width(n, "float32")
    a = orthogonal(n, gen)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    a_h = a.cpu().numpy()
    pp = {st.Option.MethodLU: st.MethodLU.PartialPiv,
          st.Option.UseFallbackSolver: False,
          st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    _, x_in, gesv_wall = run_gesv(st, a, b, nb, pp)
    reset()
    storage.reset_traffic()
    F, wall = _timed(lambda: st.getrf_ooc(a_h))
    launches = counts()
    traffic = dict(storage.TRAFFIC)
    # the second run, under the profiler, also checks the bits repeat
    F2, prof = ooc_profile(lambda: st.getrf_ooc(a_h))
    repeat = bool(np.array_equal(F.LU, F2.LU)
                  and np.array_equal(F.perm, F2.perm))
    del F2
    lu = torch.from_numpy(F.LU).cuda()
    perm = torch.from_numpy(F.perm).cuda()
    lu64 = lu.double()
    lower = torch.tril(lu64, -1)
    lower.diagonal().fill_(1)
    res = rel_factor_residual(a[perm], lower @ torch.triu(lu64))
    del lu64, lower
    Fo = st.LUFactors(st.Matrix.from_numpy(lu, nb), perm)
    x = st.getrs(Fo, st.Matrix.from_numpy(b, nb)).to_dense()
    x64 = torch.linalg.solve(a.double(), b.double())
    res_x, fwd_x = accuracy(a, x, b, x64)
    res_in, fwd_in = accuracy(a, x_in, b, x64)
    is_perm = bool(np.array_equal(np.sort(F.perm), np.arange(n)))
    del lu, x, x64, x_in, a, b, Fo
    h2d, d2h = ooc_traffic("getrf_ooc", n, n, width, 4)
    bound = n * EPS32
    emit({"phase": "getrf_ooc", "n": n, "nb": width, "dtype": "float32",
          "factor_residual": res, "residual_bound": bound,
          "solve_scaled_residual": res_x, "solve_forward_error_vs_f64":
          fwd_x, "incore_gesv_scaled_residual": res_in,
          "incore_gesv_forward_error_vs_f64": fwd_in,
          "residual_bound_solve": GESV_RESIDUAL_BOUND, "launches": launches,
          "h2d_bytes": traffic["h2d"], "h2d_bytes_expected": h2d,
          "d2h_bytes": traffic["d2h"], "d2h_bytes_expected": d2h,
          "wall_s": wall,
          "copy_gbps": (traffic["h2d"] + traffic["d2h"]) / wall / 1e9,
          "incore_gesv_wall_s": gesv_wall,
          "bitwise_repeatable": repeat, **prof, "card": card})
    if not (np.isfinite(F.LU).all() and is_perm and repeat):
        failures.append(f"getrf_ooc: non-finite factor, perm a "
                        f"permutation {is_perm}, repeatable {repeat}")
    if not (res < bound and res_x < GESV_RESIDUAL_BOUND
            and fwd_x < GESV_FORWARD_BOUND):
        failures.append(f"getrf_ooc: residual {res} (bound {bound}), solve "
                        f"{res_x} / {fwd_x}")
    want = {name: 0 for name in kernels}
    if launches != want or (traffic["h2d"], traffic["d2h"]) != (h2d, d2h):
        failures.append(f"getrf_ooc: launches {launches} (want none), "
                        f"traffic {traffic} (want {h2d}, {d2h})")
    return launches


def check_ooc_drill(st, gen, faults, failures) -> None:
    """The kill-and-resume drill at n = DRILL_N, f32, for both drivers in a
    temporary directory: an uninterrupted run, a run killed right after
    the checkpoint of a step in the middle, the resume, and a full run
    with checkpoints on, every result bit-equal to the first; then the
    refusals (torn, stale, corrupt) and the checkpoint events' bytes and
    wall times."""
    from slate_tpu_torch.exceptions import SlateCheckpointError
    from slate_tpu_torch.robust.checkpoint import (PAYLOAD_NAME,
                                                   CheckpointManager,
                                                   SimulatedPreemption,
                                                   ooc_fingerprint)
    nd = DRILL_N
    g = torch.randn(nd, nd, generator=gen, device="cuda")
    spd_h = (g @ g.T + nd * torch.eye(nd, device="cuda")).cpu().numpy()
    del g
    gen_h = orthogonal(nd, gen).cpu().numpy()

    def same(x, y):
        if isinstance(x, tuple):
            return all(np.array_equal(u, v) for u, v in zip(x, y))
        return bool(np.array_equal(x, y))

    def refused(call):
        try:
            call()
        except SlateCheckpointError as e:
            return e.reason
        return "accepted"

    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-") as tmp, \
            st.obs.recording() as recs:
        for op, x, nbd in (("potrf_ooc", spd_h, OOC_NB),
                           ("getrf_ooc", gen_h, 256)):
            fn = getattr(st, op)
            d = os.path.join(tmp, op)
            steps = -(-nd // nbd)
            kill = steps // 2 // DRILL_EVERY * DRILL_EVERY   # a middle save
            base, t_base = _timed(lambda: fn(x, nb=nbd))
            t0 = time.perf_counter()
            try:
                fn(x, nb=nbd, checkpoint=CheckpointManager(
                    d, every=DRILL_EVERY, abort_after_step=kill))
                failures.append(f"{op} drill: no simulated preemption")
            except SimulatedPreemption:
                pass
            t_kill = time.perf_counter() - t0
            # the resume saves nothing more (a cadence of the step count)
            res, t_res = _timed(lambda: fn(None, checkpoint=CheckpointManager(
                d, every=steps), resume=True))
            on_every = steps // 2
            on, t_on = _timed(lambda: fn(x, nb=nbd, checkpoint=(
                CheckpointManager(d + "_on", every=on_every))))
            emit({"phase": "ooc_drill", "op": op, "n": nd, "nb": nbd,
                  "steps": steps, "every": DRILL_EVERY, "killed_after": kill,
                  "resumed_bit_identical": same(res, base),
                  "checkpoints_on_bit_identical": same(on, base),
                  "on_every": on_every, "wall_s_uninterrupted": t_base,
                  "wall_s_killed_run": t_kill, "wall_s_resume": t_res,
                  "wall_s_checkpoints_on": t_on})
            if not (same(res, base) and same(on, base)):
                failures.append(f"{op} drill: resumed or checkpointed run "
                                f"not bit-identical")
        # the refusals, on getrf_ooc's geometry
        d_torn = os.path.join(tmp, "torn")
        with faults.inject(faults.FaultPlan(site="ckpt_torn_write")):
            try:
                st.getrf_ooc(gen_h, nb=256, checkpoint=CheckpointManager(
                    d_torn, every=DRILL_EVERY, abort_after_step=0))
            except SimulatedPreemption:
                pass
        torn = refused(lambda: st.getrf_ooc(
            None, checkpoint=CheckpointManager(d_torn), resume=True))
        d_stale = os.path.join(tmp, "stale")
        cm = CheckpointManager(d_stale)
        fp = ooc_fingerprint("getrf_ooc", nd, nd, 256, "float32")
        cm.save("getrf_ooc", 0, gen_h, 256, 256, fp)
        with faults.inject(faults.FaultPlan(site="ckpt_stale_read")):
            cm.save("getrf_ooc", 1, gen_h, 256, 256, fp)
        stale = refused(lambda: st.getrf_ooc(
            None, checkpoint=CheckpointManager(d_stale), resume=True))
        path = os.path.join(tmp, "getrf_ooc", PAYLOAD_NAME)
        with open(path, "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            last = fh.read(1)
            fh.seek(-1, os.SEEK_END)
            fh.write(bytes([last[0] ^ 0xFF]))
        corrupt = refused(lambda: st.getrf_ooc(
            None, checkpoint=CheckpointManager(os.path.join(tmp,
                                                            "getrf_ooc")),
            resume=True))
    got = {"torn": torn, "stale": stale, "corrupt": corrupt}
    events = {}
    for e in recs:
        if e.get("kind") in ("checkpoint_save", "checkpoint_restore"):
            row = events.setdefault(f"{e['op']}/{e['kind']}", {
                "count": 0, "bytes": [], "wall_ms": [], "verify": {}})
            row["count"] += 1
            row["bytes"].append(e["bytes"])
            row["wall_ms"].append(e["wall_ms"])
            row["verify"][e["verify"]] = row["verify"].get(e["verify"], 0) + 1
    for row in events.values():
        w = row.pop("wall_ms")
        row["bytes"] = sorted(set(row["bytes"]))
        row["wall_ms_min"], row["wall_ms_median"], row["wall_ms_max"] = (
            min(w), median(w), max(w))
    emit({"phase": "ooc_refusals", "reasons": got,
          "checkpoint_events": events})
    if got != {"torn": "torn", "stale": "stale", "corrupt": "corrupt"}:
        failures.append(f"checkpoint refusals {got}")


def check_shims(st, gen, reset, counts, failures) -> None:
    """The LAPACK shims gesv, posv and gels at n = 4096 in f64 (gels on
    2n x n), and the C API's dgesv and dposv called through ctypes
    pointers into numpy buffers as the C host calls them, on the card:
    the backward errors, the hand kernels each launched (none on the f64
    rows: every kernel is f32), and an f32 posv through the shim, whose
    tile size (256 at this n) K2 and K0 take since slice 21: every panel
    launches them, as wide_posv_launches counts."""
    from slate_tpu_torch.compat import capi, lapack
    ns, k = SHIM_N, SHIM_NRHS
    g = torch.randn(ns, ns, generator=gen, device="cuda", dtype=torch.float64)
    a = g + ns ** 0.5 * torch.eye(ns, device="cuda", dtype=torch.float64)
    s = g @ g.T + ns * torch.eye(ns, device="cuda", dtype=torch.float64)
    tall = torch.randn(2 * ns, ns, generator=gen, device="cuda",
                       dtype=torch.float64)
    b = torch.randn(2 * ns, k, generator=gen, device="cuda",
                    dtype=torch.float64)
    a_h, s_h, t_h, b_h = (np.ascontiguousarray(x.cpu().numpy())
                          for x in (a, s, tall, b))
    bs_h = np.ascontiguousarray(b_h[:ns])

    def backward(m, x, rhs):
        m, x, rhs = (torch.as_tensor(np.asarray(v), device="cuda",
                                     dtype=torch.float64)
                     for v in (m, x, rhs))
        return float(torch.linalg.norm(m @ x - rhs)
                     / (torch.linalg.norm(m) * torch.linalg.norm(x)))

    def ne_residual(m, x, rhs):
        m, x, rhs = (torch.as_tensor(np.asarray(v), device="cuda")
                     for v in (m, x, rhs))
        return float(torch.linalg.norm(m.T @ (m @ x - rhs))
                     / (torch.linalg.norm(m) ** 2 * torch.linalg.norm(x)))

    def c_call(fn, m_h):
        x = np.zeros((ns, k))
        rc = fn(ns, k, m_h.ctypes.data, ns, bs_h.ctypes.data, k,
                x.ctypes.data, k, lapack._nb(ns))
        return rc, x

    os.environ.pop("SLATE_TORCH_CAPI_DEVICE", None)   # CUDA, as a C caller
    rows = {}
    for name, call, check in (
            ("lapack_gesv", lambda: lapack.gesv(a_h, bs_h)[0],
             lambda x: backward(a_h, x, bs_h)),
            ("lapack_posv", lambda: lapack.posv(s_h, bs_h),
             lambda x: backward(s_h, x, bs_h)),
            ("lapack_gels", lambda: lapack.gels(t_h, b_h),
             lambda x: ne_residual(t_h, x, b_h)),
            ("capi_dgesv", lambda: c_call(capi.dgesv, a_h),
             lambda x: backward(a_h, x, bs_h)),
            ("capi_dposv", lambda: c_call(capi.dposv, s_h),
             lambda x: backward(s_h, x, bs_h)),
            ("lapack_posv_float32", lambda: lapack.posv(
                s_h.astype(np.float32), bs_h.astype(np.float32)),
             lambda x: backward(s_h, x.astype(np.float64), bs_h))):
        reset()
        out, wall = _timed(call)
        launches = {kk: v for kk, v in counts().items() if v}
        rc = 0
        if name.startswith("capi"):
            rc, out = out
        err = check(out)
        f32 = name.endswith("float32")
        bound = ns * (EPS32 if f32 else EPS64)
        want = wide_posv_launches(ns, lapack._nb(ns)) if f32 else {}
        rows[name] = {"rc": rc, "backward_error": err, "bound": bound,
                      "wall_s": wall, "hand_kernels_launched": launches,
                      "nb": lapack._nb(ns)}
        if rc != 0 or not err < bound or launches != want:
            failures.append(f"{name}: rc {rc}, backward error {err} (bound "
                            f"{bound}), launches {launches} (want {want})")
    emit({"phase": "shims", "n": ns, "nrhs": k, "gels_m": 2 * ns,
          "dtype": "float64", "rows": rows})


def check_slice15(st, seed, nb, nrhs, reset, counts, kernels,
                  card) -> dict:
    """The slice-15 phases (durable jobs and compatibility); their
    matrices draw from --seed + 16.  Returns the launch counts of their
    paths."""
    from slate_tpu_torch.robust import faults
    failures = []
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    out = {}
    for name, fn in (
            ("potrf_ooc", lambda: check_potrf_ooc(
                st, gen, nrhs, reset, counts, kernels, card, failures)),
            ("getrf_ooc", lambda: check_getrf_ooc(
                st, gen, nb, nrhs, reset, counts, kernels, card, failures)),
            ("ooc_drill", lambda: check_ooc_drill(st, gen, faults,
                                                  failures)),
            ("shims", lambda: check_shims(st, gen, reset, counts,
                                          failures))):
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        launches = fn()
        if launches is not None:
            out[name] = launches
        emit({"phase": "seconds", "of": name,
              "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError("slice 15: " + "; ".join(failures))
    return out


# slice 16: the distributed layer at world size 1 on the card.  The mesh
# products are held against the library's single product of the same
# operands, max|got - want| / max|want|: both are f32 with TF32 off and
# differ in the order of their sums only (SUMMA adds n/nb rank-nb
# updates, herk sums tile pairs)
DIST_REL_TOL = 1e-4
DIST_BITS_N = 8192              # the lookahead bit-identity and the strike
DIST_HERK_K = 2048
GLOO_N = 256                    # the 2 x 2 gloo world of CPU processes
GLOO_NB = 32
GLOO_TIMEOUT_S = 180


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def dist_matrix(st, g, a, nb, kind="general"):
    """``a`` (a tensor on the card) as a matrix on the grid ``g``."""
    if kind == "hermitian":
        return st.HermitianMatrix.from_numpy(a, nb, st.Uplo.Lower, grid=g)
    return st.Matrix.from_numpy(a, nb, grid=g)


def check_dist_posv(st, g, gen, n, nb, nrhs, reset, counts, failures):
    """dist_posv: posv on the one-rank mesh (dist_potrf, K1 on each
    diagonal tile, then dist_trsm twice), cold and warm, beside the
    single route's posv on the same system, then by span and by kernel
    (torch.profiler: device busy and idle share); returns the launches
    and the factor (for the trsm and trmm phases)."""
    gg = torch.randn(n, n, generator=gen, device="cuda")
    a = gg @ gg.T
    del gg
    a.diagonal().add_(n)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    mesh = {st.Option.Target: st.Target.mesh}

    def run():
        A = dist_matrix(st, g, a, nb, "hermitian")
        B = dist_matrix(st, g, b, nb)
        (L, X), wall = _timed(lambda: st.posv(A, B, mesh))
        return L, X.to_dense(), wall

    reset()
    L, x, wall_cold = run()
    launches = counts()
    _, x_warm, wall = run()
    _, wall_single_cold = run_posv(st, a, b, nb)
    x_single, wall_single = run_posv(st, a, b, nb)
    x64 = solve_f64(a, b)
    res, fwd = accuracy(a, x, b, x64)
    res_s, fwd_s = accuracy(a, x_single, b, x64)
    row = {"phase": "dist_posv", "n": n, "nb": nb, "nrhs": nrhs,
           "grid": [g.p, g.q], "backend": "nccl", "dtype": "float32",
           "wall_s_cold": wall_cold, "wall_s": wall,
           "gflops": op_flops("posv", (n, n), (n, nrhs)) / wall / 1e9,
           "single_route_wall_s": wall_single,
           "single_route_wall_s_cold": wall_single_cold,
           "scaled_residual": res, "residual_bound": RESIDUAL_BOUND,
           "forward_error_vs_f64": fwd, "forward_bound": FORWARD_BOUND,
           "single_route_scaled_residual": res_s,
           "single_route_forward_error_vs_f64": fwd_s,
           "warm_bit_equal": bool(torch.equal(x, x_warm)),
           "launches": launches}
    emit(row)
    # the mesh posv by span (host ms) and by kernel (device ms, idle):
    # its host cost is what this layer adds at one rank
    emit({"phase": "trace_spans", "of": "dist_posv",
          "span_ms": span_ms(st, run)})
    profile_device("dist_posv", run)
    want = {**{k: 0 for k in launches}, "chol_tile": -(-n // nb)}
    if launches != want:
        failures.append(f"dist_posv launches {launches} (want {want})")
    if not (torch.isfinite(x).all() and x.shape == (n, nrhs)
            and res < RESIDUAL_BOUND and fwd < FORWARD_BOUND):
        failures.append(f"dist_posv: residual {res}, forward {fwd}")
    return launches, L


def check_dist_blas3(st, g, gen, n, nb, nrhs, L, reset, counts, failures):
    """dist_gemm (SUMMA, n x n x n), dist_gemmA (a 128-column C), dist_herk
    (n, k = 2048) and dist_trsm / dist_trmm (the dist_posv factor against
    n x 128) on the one-rank mesh, each against the library's product or
    solve of the same operands; no hand kernel runs on these paths."""
    mesh = {st.Option.Target: st.Target.mesh}
    out = {}

    def phase(name, call, want, flops, extra=None):
        reset()
        got, wall_cold = _timed(call)
        launches = counts()
        got, wall = _timed(call)
        err = rel_err(got, want)
        emit({"phase": name, **(extra or {}), "wall_s_cold": wall_cold,
              "wall_s": wall, "gflops": flops / wall / 1e9,
              "max_rel_err": err, "tol": DIST_REL_TOL,
              "launches": launches})
        if err > DIST_REL_TOL or not torch.isfinite(got).all():
            failures.append(f"{name}: max rel err {err}")
        if any(launches.values()):
            failures.append(f"{name} launches {launches} (want none)")
        out[name] = launches

    a = torch.randn(n, n, generator=gen, device="cuda")
    bm = torch.randn(n, n, generator=gen, device="cuda")
    A, Bm = dist_matrix(st, g, a, nb), dist_matrix(st, g, bm, nb)
    phase("dist_gemm", lambda: st.gemm(1.0, A, Bm, opts=mesh).to_dense(),
          a @ bm, 2.0 * n ** 3, {"m": n, "n": n, "k": n, "nb": nb,
                                 "method": "SUMMA"})
    del Bm, bm
    bs = torch.randn(n, nrhs, generator=gen, device="cuda")
    Bs = dist_matrix(st, g, bs, nb)
    ga = {**mesh, st.Option.MethodGemm: st.MethodGemm.gemmA}
    phase("dist_gemmA", lambda: st.gemm(1.0, A, Bs, opts=ga).to_dense(),
          a @ bs, 2.0 * n * n * nrhs, {"m": n, "n": nrhs, "k": n,
                                       "nb": nb, "method": "gemmA"})
    del A, a
    ak = torch.randn(n, DIST_HERK_K, generator=gen, device="cuda")
    Ak = dist_matrix(st, g, ak, nb)
    C0 = st.HermitianMatrix.from_numpy(
        torch.zeros(n, n, device="cuda"), nb, st.Uplo.Lower, grid=g)
    phase("dist_herk",
          lambda: torch.tril(st.herk(1.0, Ak, 0.0, C0, mesh).storage
                             .to_dense()),
          torch.tril(ak @ ak.T), 1.0 * n * n * DIST_HERK_K,
          {"n": n, "k": DIST_HERK_K, "nb": nb})
    del Ak, ak, C0
    ld = L.to_dense()
    phase("dist_trsm", lambda: st.trsm("l", 1.0, L, Bs, mesh).to_dense(),
          torch.linalg.solve_triangular(ld, bs, upper=False),
          1.0 * n * n * nrhs, {"m": n, "n": nrhs, "nb": nb,
                               "side": "left"})
    phase("dist_trmm", lambda: st.trmm("l", 1.0, L, Bs, mesh).to_dense(),
          ld @ bs, 1.0 * n * n * nrhs, {"m": n, "n": nrhs, "nb": nb,
                                        "side": "left"})
    return out


def check_dist_bits(st, g, gen, nb, reset, counts, failures):
    """dist_lookahead: SUMMA and dist_potrf at n = 8192 at lookahead depths
    0, 1 and 2, every output bit for bit (torch.equal), health included;
    then dist_strike: one transient bitflip planted below the diagonal of
    the first diagonal tile's factor (K1's) of a mesh posv under
    Option.Abft, located at tile (0, 0) and repaired."""
    from slate_tpu_torch.parallel.dist_chol import dist_potrf
    from slate_tpu_torch.parallel.summa import summa_gemm_data
    from slate_tpu_torch.robust import faults
    n = DIST_BITS_N
    a = torch.randn(n, n, generator=gen, device="cuda")
    bm = torch.randn(n, n, generator=gen, device="cuda")
    A, Bm = dist_matrix(st, g, a, nb), dist_matrix(st, g, bm, nb)
    C = dist_matrix(st, g, torch.zeros(n, n, device="cuda"), nb)
    summa, walls = [], []
    for la in (0, 1, 2):
        d, w = _timed(lambda: summa_gemm_data(
            A.storage.data, Bm.storage.data, C.storage.data, 1.0, 0.0,
            A.storage.Nt, g, la=la))
        summa.append(d)
        walls.append(w)
    del A, Bm, C, bm
    spd_a = a @ a.T
    del a
    spd_a.diagonal().add_(n)
    H = dist_matrix(st, g, spd_a, nb, "hermitian")
    chol, cwalls = [], []
    for la in (0, 1, 2):
        reset()
        o, w = _timed(lambda: dist_potrf(H.storage.data, H.storage.Nt, g,
                                         n=n, la=la))
        chol.append((o, counts()))
        cwalls.append(w)
    same_summa = all(torch.equal(summa[0], s) for s in summa[1:])
    same_chol = all(all(torch.equal(x, y) for x, y in zip(chol[0][0], c[0]))
                    for c in chol[1:])
    emit({"phase": "dist_lookahead", "n": n, "nb": nb,
          "summa_wall_s_by_depth": walls, "potrf_wall_s_by_depth": cwalls,
          "summa_bit_equal": same_summa, "potrf_bit_equal": same_chol,
          "potrf_launches_by_depth": [c[1]["chol_tile"] for c in chol]})
    if not (same_summa and same_chol):
        failures.append(f"dist_lookahead: SUMMA equal {same_summa}, "
                        f"dist_potrf equal {same_chol}")
    del summa, chol
    b = torch.randn(n, 16, generator=gen, device="cuda")
    seed = strike_seed(nb, nb, below_diagonal)
    plan = faults.FaultPlan("post_panel", kind="bitflip", seed=seed,
                            transient=True)
    # no fallback rung: the repair must happen in the attempt itself (the
    # ladder's hesv and gesv rungs have no mesh route yet)
    abft = {st.Option.Target: st.Target.mesh, st.Option.Abft: st.Abft.On,
            st.Option.ErrorPolicy: st.ErrorPolicy.Info,
            st.Option.UseFallbackSolver: False}
    B = dist_matrix(st, g, b, nb)
    x64 = solve_f64(spd_a, b)
    (_, X0, h0), wall0 = _timed(lambda: st.posv(H, B, abft))
    with faults.inject(plan):
        (_, X, h), wall = _timed(lambda: st.posv(H, B, abft))
    res, fwd = accuracy(spd_a, X.to_dense(), b, x64)
    res0, fwd0 = accuracy(spd_a, X0.to_dense(), b, x64)
    emit({"phase": "dist_strike", "n": n, "nb": nb, "seed": seed,
          "planted_tile": [0, 0], "wall_s": wall, "scaled_residual": res,
          "forward_error_vs_f64": fwd, "health": health_row(h),
          "clean_wall_s": wall0, "clean_scaled_residual": res0,
          "clean_forward_error_vs_f64": fwd0,
          "clean_health": health_row(h0)})
    if not ((h.abft_detected, h.abft_corrected, h.abft_site) == (1, 1, 0)
            and h.ok and h0.ok and h0.abft_detected == 0
            and res < RESIDUAL_BOUND and fwd < FORWARD_BOUND):
        failures.append(f"dist_strike: {health_row(h)} (clean "
                        f"{health_row(h0)}), residual {res}, forward {fwd}")


def gloo_slice17(st, g, gg, b) -> dict:
    """The slice-17 checks of one gloo rank: a CALU gesv on ``gg``, a QR
    gels on its first GLOO_N / 2 columns, and ``gg`` through
    from_scalapack (the grid's ScaLAPACK locals) and pdgesv, each against
    torch's own solve; the relative errors and walls."""
    from slate_tpu_torch.compat import scalapack as sc
    from slate_tpu_torch.compat import scalapack_api as sapi
    mesh = {st.Option.Target: st.Target.mesh}
    out = {}
    t0 = time.perf_counter()
    _, X = st.gesv(st.Matrix.from_numpy(gg, GLOO_NB, grid=g),
                   st.Matrix.from_numpy(b, GLOO_NB, grid=g),
                   {**mesh, st.Option.MethodLU: st.MethodLU.CALU})
    out["calu_gesv_rel_err"] = rel_err(X.to_dense(),
                                       torch.linalg.solve(gg, b))
    out["calu_gesv_wall_s"] = time.perf_counter() - t0
    aq = gg[:, :GLOO_N // 2]
    t0 = time.perf_counter()
    X = st.gels(st.Matrix.from_numpy(aq, GLOO_NB, grid=g),
                st.Matrix.from_numpy(b, GLOO_NB, grid=g),
                {**mesh, st.Option.MethodGels: st.MethodGels.QR})
    out["qr_gels_rel_err"] = rel_err(X.to_dense(),
                                     torch.linalg.lstsq(aq, b).solution)
    out["qr_gels_wall_s"] = time.perf_counter() - t0
    da, la_ = sc.scatter_locals(gg.numpy(), GLOO_NB, GLOO_NB, g.p, g.q)
    db, lb = sc.scatter_locals(b.numpy(), GLOO_NB, GLOO_NB, g.p, g.q)
    A = sc.from_scalapack(da, la_, g)
    out["from_scalapack_exact"] = bool(torch.equal(A.to_dense(), gg))
    dx, lx = sapi.pdgesv(GLOO_N, b.shape[1], da, la_, db, lb, g)
    out["pdgesv_rel_err"] = rel_err(
        torch.from_numpy(sc.gather_locals(dx, lx, g.p, g.q)),
        torch.linalg.solve(gg, b))
    return out


def gloo_slice18(st, g, gg, a) -> dict:
    """The slice-18 checks of one gloo rank, f64 at GLOO_N: heev on the
    symmetric part of ``gg``, svd of ``gg``, hegv of that pair with B =
    ``a`` (SPD), stedc on a seeded tridiagonal over the grid, pdsyev and
    pdgesvd over the grid's ScaLAPACK locals, each against torch's own
    eigensolver or SVD on the whole matrix; the relative errors and
    walls."""
    from slate_tpu_torch.compat import scalapack as sc
    from slate_tpu_torch.compat import scalapack_api as sapi
    mesh = {st.Option.Target: st.Target.mesh}
    h = (gg + gg.T) / 2
    wh = torch.linalg.eigvalsh(h)
    sv = torch.linalg.svdvals(gg)
    out = {}
    t0 = time.perf_counter()
    H = st.HermitianMatrix.from_numpy(h, GLOO_NB, st.Uplo.Lower, grid=g)
    w, Z = st.heev(H, mesh)
    z = Z.to_dense()
    out["heev_rel_err"] = rel_err(w, wh)
    out["heev_residual"] = rel_err(h @ z, z * w[None, :])
    out["heev_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s, U, V = st.svd(st.Matrix.from_numpy(gg, GLOO_NB, grid=g), mesh)
    out["svd_rel_err"] = rel_err(s, sv)
    out["svd_residual"] = rel_err((U.to_dense() * s[None, :])
                                  @ V.to_dense().T, gg)
    out["svd_wall_s"] = time.perf_counter() - t0
    L = torch.linalg.cholesky(a)
    c = torch.linalg.solve_triangular(
        L, torch.linalg.solve_triangular(L, h, upper=False).T, upper=False)
    w, X = st.hegv(H, st.HermitianMatrix.from_numpy(a, GLOO_NB,
                                                     st.Uplo.Lower, grid=g),
                   mesh)
    out["hegv_rel_err"] = rel_err(w, torch.linalg.eigvalsh((c + c.T) / 2))
    x = X.to_dense()
    out["hegv_residual"] = rel_err(h @ x, (a @ x) * w[None, :])
    gen = torch.Generator().manual_seed(18)
    d = torch.randn(GLOO_N, generator=gen, dtype=torch.float64)
    e = torch.randn(GLOO_N - 1, generator=gen, dtype=torch.float64)
    w, _ = st.stedc(d, e, grid=g)
    out["stedc_rel_err"] = rel_err(w, torch.linalg.eigvalsh(
        torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)))
    dh, lh = sc.scatter_locals(h.numpy(), GLOO_NB, GLOO_NB, g.p, g.q)
    w = sapi.pdsyev("n", "l", GLOO_N, dh, lh, g)[0]
    out["pdsyev_rel_err"] = rel_err(torch.from_numpy(w), wh)
    dg, lg = sc.scatter_locals(gg.numpy(), GLOO_NB, GLOO_NB, g.p, g.q)
    s = sapi.pdgesvd("n", GLOO_N, GLOO_N, dg, lg, g)[0]
    out["pdgesvd_rel_err"] = rel_err(torch.from_numpy(s), sv)
    return out


def gloo_slice19() -> dict:
    """The slice-19 check of one gloo rank: ex01-ex14 (run_all) on the
    CPU in the 2 x 2 world, every example's grid 2 x 2; the failed ones
    and the wall."""
    import contextlib
    import io
    from slate_tpu_torch.examples import run_all
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        failed = run_all.run(run_all.EXAMPLES, torch.device("cpu"))
    return {"examples": len(run_all.EXAMPLES), "failed": failed,
            "wall_s": time.perf_counter() - t0}


def gloo_child(rank: int, work: str) -> int:
    """One rank of the 2 x 2 gloo world (CPU processes): posv and SUMMA
    gemm on the grid, in f64 at n = GLOO_N, against torch's own solve and
    product on the whole matrix; writes its result to ``work``."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    import slate_tpu_torch as st
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "rendezvous"),
        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=60))
    try:
        g = st.Grid(2, 2, device="cpu")
        gen = torch.Generator().manual_seed(17)
        n = GLOO_N
        gg = torch.randn(n, n, generator=gen, dtype=torch.float64)
        a = gg @ gg.T + n * torch.eye(n, dtype=torch.float64)
        b = torch.randn(n, 8, generator=gen, dtype=torch.float64)
        mesh = {st.Option.Target: st.Target.mesh}
        A = st.HermitianMatrix.from_numpy(a, GLOO_NB, st.Uplo.Lower, grid=g)
        B = st.Matrix.from_numpy(b, GLOO_NB, grid=g)
        t0 = time.perf_counter()
        _, X = st.posv(A, B, mesh)
        x = X.to_dense()
        wall = time.perf_counter() - t0
        C = st.gemm(1.0, st.Matrix.from_numpy(gg, GLOO_NB, grid=g),
                    st.Matrix.from_numpy(a, GLOO_NB, grid=g), opts=mesh)
        out = {"rank": rank, "coords": list(g.coords),
               "posv_rel_err": rel_err(x, torch.linalg.solve(a, b)),
               "gemm_rel_err": rel_err(C.to_dense(), gg @ a),
               "posv_wall_s": wall, "slice17": gloo_slice17(st, g, gg, b),
               "slice18": gloo_slice18(st, g, gg, a),
               "slice19": gloo_slice19()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh)
    return 0


def check_gloo_world(failures) -> None:
    """gloo_2x2: four CPU processes (this script with --gloo-child, no
    card visible to them) form a 2 x 2 grid over gloo and check comm/ and
    the mesh drivers under this machine's torch.  It stands for no card
    result: its line says "device": "cpu"."""
    with tempfile.TemporaryDirectory(prefix="smoke-gloo-") as work:
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
               "OMP_NUM_THREADS": "1"}
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gloo-child",
             str(r), work], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(4)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=GLOO_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                logs.append(b"timed out")
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        ranks = []
        for r in range(4):
            path = os.path.join(work, f"rank{r}.json")
            if os.path.exists(path):
                with open(path, encoding="utf-8") as fh:
                    ranks.append(json.load(fh))
        row = {"phase": "gloo_2x2", "device": "cpu", "n": GLOO_N,
               "nb": GLOO_NB, "dtype": "float64",
               "wall_s": time.perf_counter() - t0, "ranks": ranks}
        emit(row)
        emit({"phase": "gloo_2x2_slice17", "device": "cpu", "n": GLOO_N,
              "nb": GLOO_NB, "dtype": "float64",
              "ranks": [x.get("slice17") for x in ranks]})
        emit({"phase": "gloo_2x2_slice18", "device": "cpu", "n": GLOO_N,
              "nb": GLOO_NB, "dtype": "float64",
              "ranks": [x.get("slice18") for x in ranks]})
        emit({"phase": "gloo_2x2_slice19", "device": "cpu",
              "ranks": [x.get("slice19") for x in ranks]})
        s17 = [x["slice17"] for x in ranks]
        s18 = [x["slice18"] for x in ranks]
        ok = (len(ranks) == 4
              and all(x["posv_rel_err"] < 1e-12 and x["gemm_rel_err"] < 1e-12
                      for x in ranks)
              and all(y["calu_gesv_rel_err"] < 1e-10
                      and y["qr_gels_rel_err"] < 1e-10
                      and y["from_scalapack_exact"]
                      and y["pdgesv_rel_err"] < 1e-10 for y in s17)
              and all(v < 1e-10 for y in s18 for k, v in y.items()
                      if not k.endswith("wall_s"))
              and all(x["slice19"]["failed"] == [] for x in ranks))
        if not ok:
            failures.append("gloo_2x2: " + " | ".join(
                log.decode(errors="replace")[-2000:] for log in logs))


def check_slice16(st, seed, n, nb, nrhs, reset, counts) -> dict:
    """The slice-16 phases (the distributed layer): a one-rank NCCL world,
    Grid(1, 1, group=WORLD) on cuda:0, the mesh routes at full width, the
    lookahead bit-identity and a planted strike; the process group is
    destroyed before the gloo world runs.  Matrices draw from --seed +
    17.  Returns the launch counts of the paths."""
    import torch.distributed as dist
    failures = []
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="smoke-nccl-") as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            g = st.Grid(1, 1, group=dist.group.WORLD)
            emit({"phase": "seconds", "of": "nccl_init",
                  "seconds": time.perf_counter() - t0,
                  "grid": repr(g), "device": str(g.device)})
            for name, fn in (
                    ("dist_posv", lambda: check_dist_posv(
                        st, g, gen, n, nb, nrhs, reset, counts, failures)),
                    ("dist_blas3", lambda: check_dist_blas3(
                        st, g, gen, n, nb, nrhs, out.pop("_L"), reset,
                        counts, failures)),
                    ("dist_lookahead", lambda: check_dist_bits(
                        st, g, gen, nb, reset, counts, failures))):
                t0 = time.perf_counter()
                torch.cuda.empty_cache()
                res = fn()
                if name == "dist_posv":
                    out["dist_posv"], out["_L"] = res
                elif res:
                    out.update(res)
                emit({"phase": "seconds", "of": name,
                      "seconds": time.perf_counter() - t0})
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_gloo_world(failures)
    emit({"phase": "seconds", "of": "gloo_2x2",
          "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError("slice 16: " + "; ".join(failures))
    return out


# ---- slice 17: distributed LU, CAQR and the mesh Aasen (--seed + 18) ----
DIST_LU_N = 8192                # NoPiv, RBT, the depths and the strike
DIST_HESV_N = 4096              # the mesh Aasen beside the single route's
DIST_HESV_BOUND = 1e-4          # f32 Aasen, max-norm backward error
DIST_HESV_TOL = 1e-3            # the mesh solve against the single route's


def sum_launches(name: str, *runs) -> dict:
    """{name: the launches of ``name`` summed over the runs' counts}."""
    return {name: sum(r[name] for r in runs)}


def dist_calu_launches(n: int, nb: int, fits) -> dict:
    """K4 and K3 launches of the mesh getrf_tntpiv (dist_getrf) on an n x
    n matrix at Option.Lookahead 1: as :func:`expected_calu_launches`, but
    each panel's row blocks are sized from the reference's superblocked
    panel height (parallel/dist_lu.py), while the tournament runs on the
    live rows."""
    from slate_tpu_torch.parallel.dist_lu import superblock
    Nt = -(-n // nb)
    sb = superblock(Nt)
    k4 = k3 = 0
    for k in range(Nt - 1):
        height = n - (k // sb) * sb * nb
        k4 += sum(fits(h) for h in calu_rounds(n - k * nb, nb,
                                                height=height))
        k3 += 2
    return {"lu_select": k4, "lu_panel_fused": k3}


def dist_solve_phase(name, st, run, single_wall, want, a, b, x64, bounds,
                     reset, counts, failures, extra=None):
    """One mesh solve, cold (its launches counted) and warm, beside the
    single route's warm wall, held to the single route's bounds and to the
    launches ``want``; returns the launches and the solution."""
    reset()
    x, wall_cold = _timed(run)
    launches = counts()
    x_warm, wall = _timed(run)
    res, fwd = accuracy(a, x, b, x64) if bounds[2] == "solve" else \
        lstsq_accuracy(a, x, b, x64)
    emit({"phase": name, **(extra or {}), "grid": [1, 1], "backend": "nccl",
          "dtype": "float32", "wall_s_cold": wall_cold, "wall_s": wall,
          "single_route_wall_s": single_wall,
          "scaled_residual": res, "residual_bound": bounds[0],
          "forward_error_vs_f64": fwd, "forward_bound": bounds[1],
          "warm_bit_equal": bool(torch.equal(x, x_warm)),
          "launches": launches})
    if not (torch.isfinite(x).all() and res < bounds[0] and fwd < bounds[1]):
        failures.append(f"{name}: residual {res}, forward {fwd}")
    if launches != want:
        failures.append(f"{name} launches {launches} (want {want})")
    return launches, x


def check_dist_lu(st, g, gen, n, nb, nrhs, reset, counts, kernels, trace,
                  failures) -> dict:
    """dist_gesv (CALU at n, K4 and K3 on every panel), dist_gesv_nopiv
    and dist_rbt (gesv under Speculate: dist_rbt_two_sided, then K3) at
    DIST_LU_N, each beside the single route's wall; returns the launches."""
    from slate_tpu_torch.internal.getrf import _lu_select_ok
    mesh = {st.Option.Target: st.Target.mesh}
    zero = {name: 0 for name in kernels}
    out = {}
    calu = {st.Option.MethodLU: st.MethodLU.CALU}
    a = orthogonal(n, gen)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    _, _, wall_single = run_gesv(st, a, b, nb, calu)
    _, _, wall_single = run_gesv(st, a, b, nb, calu)
    x64 = torch.linalg.solve(a.double(), b.double())
    fits = lambda h: _lu_select_ok(torch.empty((1, h, nb), device="cuda"),
                                   nb)

    def run_calu():
        A, B = dist_matrix(st, g, a, nb), dist_matrix(st, g, b, nb)
        return st.gesv(A, B, {**mesh, **calu})[1].to_dense()

    out["dist_gesv"], _ = dist_solve_phase(
        "dist_gesv", st, run_calu, wall_single,
        {**zero, **dist_calu_launches(n, nb, fits)}, a, b, x64,
        (GESV_RESIDUAL_BOUND, GESV_FORWARD_BOUND, "solve"), reset, counts,
        failures, {"n": n, "nb": nb, "nrhs": nrhs, "method": "CALU"})
    if trace:
        emit({"phase": "trace_spans", "of": "dist_gesv",
              "span_ms": span_ms(st, run_calu)})
        profile_device("dist_gesv", run_calu)
    del a, b, x64
    nn = DIST_LU_N
    a = torch.randn(nn, nn, generator=gen, device="cuda")
    a.diagonal().add_(nn)                    # strictly diagonally dominant
    b = torch.randn(nn, nrhs, generator=gen, device="cuda")
    x64 = torch.linalg.solve(a.double(), b.double())
    nopiv = {st.Option.MethodLU: st.MethodLU.NoPiv}
    _, _, wall_single = run_gesv(st, a, b, nb, nopiv)
    out["dist_gesv_nopiv"], _ = dist_solve_phase(
        "dist_gesv_nopiv", st,
        lambda: st.gesv_nopiv(dist_matrix(st, g, a, nb),
                              dist_matrix(st, g, b, nb), mesh)[1].to_dense(),
        wall_single, {**zero, "lu_panel_fused": 2 * (nn // nb) - 1}, a, b,
        x64, (GESV_RESIDUAL_BOUND, GESV_FORWARD_BOUND, "solve"), reset,
        counts, failures, {"n": nn, "nb": nb, "nrhs": nrhs})
    spec = {st.Option.Speculate: st.Speculate.On,
            st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    _, _, wall_single = run_gesv(st, a, b, nb, spec)
    kinds = []

    def run_rbt():
        F, X, h = st.gesv(dist_matrix(st, g, a, nb),
                          dist_matrix(st, g, b, nb), {**mesh, **spec})
        kinds.append((type(F).__name__, h.ok))
        return X.to_dense()

    out["dist_rbt"], _ = dist_solve_phase(
        "dist_rbt", st, run_rbt, wall_single,
        {**zero, "lu_panel_fused": 2 * (nn // nb) - 1}, a, b, x64,
        (GESV_RESIDUAL_BOUND, GESV_FORWARD_BOUND, "solve"), reset, counts,
        failures, {"n": nn, "nb": nb, "nrhs": nrhs})
    if any(k != ("RBTFactors", True) for k in kinds):
        failures.append(f"dist_rbt: the RBT rung not accepted: {kinds}")
    return out


def check_dist_qr(st, g, gen, nb, nrhs, reset, counts, kernels,
                  failures) -> dict:
    """dist_gels at GELS_SHAPE: MethodGels.QR (CAQR, K5 on every local
    panel: one rank's slab is the whole 8192-row column, inside K5's
    gate) and the default CholQR (the mesh herk, dist_potrf with K1 on
    each diagonal tile, the mesh trsm), beside the single route's."""
    mq, nq = GELS_SHAPE
    a, b, x64 = lstsq_problem(mq, nq, nrhs, gen)
    mesh = {st.Option.Target: st.Target.mesh}
    zero = {name: 0 for name in kernels}
    out = {}
    for name, opts, want, bounds in (
            ("dist_gels", {st.Option.MethodGels: st.MethodGels.QR},
             {"qr_panel": -(-nq // nb)},
             (GELS_RESIDUAL_BOUND, GELS_FORWARD_BOUND, "lstsq")),
            ("dist_gels_cholqr", {st.Option.MethodGels: st.MethodGels.CholQR},
             {"chol_tile": -(-nq // nb)},
             (CFG4_RESIDUAL_BOUND, CFG4_FORWARD_BOUND, "lstsq"))):
        _, wall_single = run_gels(st, a, b, nb, opts)
        _, wall_single = run_gels(st, a, b, nb, opts)
        out[name], _ = dist_solve_phase(
            name, st, lambda: st.gels(
                dist_matrix(st, g, a, nb), dist_matrix(st, g, b, nb),
                {**mesh, **(opts or {})}).to_dense(),
            wall_single, {**zero, **want}, a, b, x64, bounds, reset, counts,
            failures, {"m": mq, "n": nq, "nb": nb, "nrhs": nrhs})
    return out


def check_dist_hesv(st, g, gen, nb, reset, counts, failures) -> dict:
    """dist_hesv: the mesh Aasen (A and L in row blocks, one rank here) on
    a symmetric indefinite f32 A at DIST_HESV_N, beside the single
    route's hesv on the same system; no hand kernel."""
    n = DIST_HESV_N
    gg = torch.randn(n, n, generator=gen, device="cuda")
    a = (gg + gg.T) / 2
    del gg
    b = torch.randn(n, 4, generator=gen, device="cuda")
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    A, B = (st.SymmetricMatrix.from_numpy(a, nb),
            st.Matrix.from_numpy(b, nb))
    (_, Xs, hs), _ = _timed(lambda: st.hesv(A, B, info))
    (_, Xs, hs), wall_single = _timed(lambda: st.hesv(A, B, info))
    Am = st.SymmetricMatrix.from_numpy(a, nb, grid=g)
    Bm = dist_matrix(st, g, b, nb)
    mesh = {**info, st.Option.Target: st.Target.mesh}
    reset()
    (F, X, h), wall_cold = _timed(lambda: st.hesv(Am, Bm, mesh))
    launches = counts()
    (F, X, h), wall = _timed(lambda: st.hesv(Am, Bm, mesh))
    x, xs = X.to_dense(), Xs.to_dense()
    res = _scaled_residual(a.double(), x.double(), b.double())
    diff = float((x - xs).abs().max() / xs.abs().max())
    emit({"phase": "dist_hesv", "n": n, "nb": nb, "dtype": "float32",
          "grid": [1, 1], "backend": "nccl", "wall_s_cold": wall_cold,
          "wall_s": wall, "single_route_wall_s": wall_single,
          "factor": type(F).__name__, "ok": h.ok, "single_ok": hs.ok,
          "residual": res, "residual_bound": DIST_HESV_BOUND,
          "rel_diff_vs_single": diff, "tol": DIST_HESV_TOL,
          "bit_equal_to_single": bool(torch.equal(x, xs)),
          "launches": launches})
    if not (type(F).__name__ == "HEFactors" and h.ok
            and res < DIST_HESV_BOUND and diff <= DIST_HESV_TOL):
        failures.append(f"dist_hesv: factor {type(F).__name__}, ok {h.ok}, "
                        f"residual {res}, vs single {diff}")
    if any(launches.values()):
        failures.append(f"dist_hesv launches {launches} (want none)")
    return launches


def check_dist_lu_bits(st, g, gen, nb, reset, counts, failures) -> None:
    """dist_lu_lookahead: dist_getrf (CALU) at DIST_LU_N and dist_geqrf at
    GELS_SHAPE at depths 0, 1 and 2, every output bit for bit; then
    dist_gesv_strike: one transient bitflip planted in the first panel of
    a mesh gesv under Option.Abft, located and repaired."""
    from slate_tpu_torch.parallel.dist_lu import dist_getrf
    from slate_tpu_torch.parallel.dist_qr import dist_geqrf_data
    from slate_tpu_torch.robust import faults
    n = DIST_LU_N
    a = orthogonal(n, gen)
    S = dist_matrix(st, g, a, nb).storage
    lu, walls = [], []
    for la in (0, 1, 2):
        o, w = _timed(lambda: dist_getrf(S.data, S.Nt, g, n, "tntpiv",
                                         la=la))
        lu.append(o)
        walls.append(w)
    mq, nq = GELS_SHAPE
    aq = torch.randn(mq, nq, generator=gen, device="cuda")
    Q = dist_matrix(st, g, aq, nb).storage
    qr, qwalls = [], []
    for la in (0, 1, 2):
        o, w = _timed(lambda: dist_geqrf_data(Q.data, Q.Nt, Q.Mt, mq, nq, g,
                                              la=la))
        qr.append(o)
        qwalls.append(w)
    same_lu = all(all(torch.equal(x, y) for x, y in zip(lu[0], o))
                  for o in lu[1:])
    same_qr = all(all(torch.equal(x, y) for x, y in zip(qr[0], o))
                  for o in qr[1:])
    emit({"phase": "dist_lu_lookahead", "n": n, "qr_shape": [mq, nq],
          "nb": nb, "getrf_wall_s_by_depth": walls,
          "geqrf_wall_s_by_depth": qwalls, "getrf_bit_equal": same_lu,
          "geqrf_bit_equal": same_qr})
    if not (same_lu and same_qr):
        failures.append(f"dist_lu_lookahead: dist_getrf equal {same_lu}, "
                        f"dist_geqrf equal {same_qr}")
    del lu, qr, S, Q, aq
    b = torch.randn(n, 16, generator=gen, device="cuda")
    x64 = torch.linalg.solve(a.double(), b.double())
    seed = strike_seed(n, nb, lambda r, c: True)
    row = int(np.random.default_rng(seed).choice(n * nb, size=1,
                                                 replace=False)[0]) // nb
    plan = faults.FaultPlan("post_panel", kind="bitflip", seed=seed,
                            transient=True)
    abft = {st.Option.Target: st.Target.mesh, st.Option.Abft: st.Abft.On,
            st.Option.ErrorPolicy: st.ErrorPolicy.Info,
            st.Option.UseFallbackSolver: False}
    A, B = dist_matrix(st, g, a, nb), dist_matrix(st, g, b, nb)
    (_, X0, h0), wall0 = _timed(lambda: st.gesv(A, B, abft))
    with faults.inject(plan):
        (_, X, h), wall = _timed(lambda: st.gesv(A, B, abft))
    res, fwd = accuracy(a, X.to_dense(), b, x64)
    res0, fwd0 = accuracy(a, X0.to_dense(), b, x64)
    want_site = (row // nb) * 65536
    emit({"phase": "dist_gesv_strike", "n": n, "nb": nb, "seed": seed,
          "planted_tile": [row // nb, 0], "wall_s": wall,
          "scaled_residual": res, "forward_error_vs_f64": fwd,
          "health": health_row(h), "clean_wall_s": wall0,
          "clean_scaled_residual": res0, "clean_forward_error_vs_f64": fwd0,
          "clean_health": health_row(h0)})
    if not ((h.abft_detected, h.abft_corrected, h.abft_site)
            == (1, 1, want_site) and h.ok and h0.ok
            and h0.abft_detected == 0 and res < GESV_RESIDUAL_BOUND
            and fwd < GESV_FORWARD_BOUND):
        failures.append(f"dist_gesv_strike: {health_row(h)} (clean "
                        f"{health_row(h0)}), residual {res}, forward {fwd}")


def check_slice17(st, seed, n, nb, nrhs, reset, counts, kernels,
                  trace) -> dict:
    """The slice-17 phases (distributed LU, CAQR and the mesh Aasen) in a
    one-rank NCCL world, Grid(1, 1, group=WORLD) on cuda:0, as slice 16
    sets one up; the group is destroyed before the gloo world's slice-17
    checks run.  Matrices draw from --seed + 18.  Returns the launch
    counts of the paths."""
    import torch.distributed as dist
    failures = []
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="smoke-nccl17-") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            g = st.Grid(1, 1, group=dist.group.WORLD)
            for name, fn in (
                    ("dist_lu", lambda: check_dist_lu(
                        st, g, gen, n, nb, nrhs, reset, counts, kernels,
                        trace, failures)),
                    ("dist_qr", lambda: check_dist_qr(
                        st, g, gen, nb, nrhs, reset, counts, kernels,
                        failures)),
                    ("dist_hesv", lambda: {"dist_hesv": check_dist_hesv(
                        st, g, gen, nb, reset, counts, failures)}),
                    ("dist_lu_lookahead", lambda: check_dist_lu_bits(
                        st, g, gen, nb, reset, counts, failures))):
                t0 = time.perf_counter()
                torch.cuda.empty_cache()
                out.update(fn() or {})
                emit({"phase": "seconds", "of": name,
                      "seconds": time.perf_counter() - t0})
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("slice 17: " + "; ".join(failures))
    return out


# ---- slice 18: the distributed spectral reductions (--seed + 19) ----
# heev's DC route and the strike walk the hb2st chase, a step after
# another (slice 14's SPEC_PARITY_N): at n = 8192 the chase alone would
# take ~260k steps, so those two run at 512; everything else at
# DIST_SPEC_N, slice 14's size before slice 23 cut it
DIST_SPEC_N = 8192
DIST_SVD_N = 6144               # dist_svd, no hand kernel (8192 before
#                                 slice 24)
DIST_STEDC_N = 4096
DIST_STEDC_TOL = 1e-3           # the mesh stedc against the single route's
DIST_PD_N = 2048                # pdsyev and pdgesvd, f64
DIST_PD_BOUND = 1e-10           # their values against numpy's, f64
DIST_SPEC_BITS_N = 4096         # dist_he2hb and dist_ge2tb at depths 0-2
MESH_HEEV_SPANS = ("slate.heev/he2hb", "slate.heev/stage2",
                   "slate.heev/backtransform", "slate.he2hb/panel",
                   "slate.he2hb/hemm", "slate.he2hb/her2k")


def mesh_opts(st, **kw) -> dict:
    """Target.mesh and ErrorPolicy.Info, with ``kw`` as options."""
    o = {st.Option.Target: st.Target.mesh,
         st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    for k, v in kw.items():
        o[st.Option[k]] = v
    return o


def check_dist_heev(st, g, gen, nb, reset, counts, failures):
    """dist_heev and dist_heev_vals: heev on the one-rank mesh at DIST_SPEC_N,
    f32, on the generator's heev matrix, cold (launches counted: none)
    and warm (spans recorded), beside the single route's heev on the same
    A; the certificate against its tolerance, the eigenvalues against the
    exact spectrum.  Returns (launches, A, the mesh A)."""
    from slate_tpu_torch.robust import certify
    n = DIST_SPEC_N
    a, lam = spectral_matrix("heev", n, gen, torch.float32)
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    A1 = st.HermitianMatrix.from_numpy(a, nb)
    (w1, _, h1), wall_single = _timed(lambda: st.heev(A1, info))
    Am = st.HermitianMatrix.from_numpy(a, nb, grid=g)
    mesh = mesh_opts(st)
    reset()
    (w, Z, h), cold = _timed(lambda: st.heev(Am, mesh))
    launches = counts()
    with st.obs.record_spans() as rec:
        (w, Z, h), warm = _timed(lambda: st.heev(Am, mesh))
    spans = span_totals(rec.spans)
    (wv, hv), t_vals = _timed(lambda: st.heev_vals(Am, mesh))
    scale = float(lam.abs().max())
    err = float((w.double() - lam).abs().max()) / scale
    err_vals = float((wv.double() - lam).abs().max()) / scale
    err_single = float((w1.double() - lam).abs().max()) / scale
    zd = Z.to_dense()
    cert = certify.certify_eig(a, w, zd).to_list()[0]
    tol = certify.tolerance(torch.float32, n)
    missing = [k for k in MESH_HEEV_SPANS if k not in spans]
    emit({"phase": "dist_heev", "n": n, "nb": nb, "dtype": "float32",
          "grid": [g.p, g.q], "backend": "nccl", "method": "Auto",
          "wall_s_cold": cold, "wall_s": warm,
          "single_route_wall_s": wall_single,
          "spans_ms": {k: v for k, v in spans.items()
                       if k.startswith(("slate.heev", "slate.he2hb"))},
          "certificate_ratio": cert.growth, "certify_tolerance": tol,
          "rel_err": err, "single_route_rel_err": err_single,
          "bound": SPEC_BOUND[torch.float32], "ok": h.ok,
          "single_ok": h1.ok, "launches": launches})
    emit({"phase": "dist_heev_vals", "n": n, "nb": nb, "wall_s": t_vals,
          "rel_err": err_vals, "ok": hv.ok})
    if not (h.ok and hv.ok and cert.converged and cert.growth <= tol
            and err <= SPEC_BOUND[torch.float32]
            and err_vals <= SPEC_BOUND[torch.float32]
            and tuple(zd.shape) == (n, n) and torch.isfinite(zd).all()):
        failures.append(f"dist_heev: ok {h.ok}/{hv.ok}, certificate "
                        f"{cert.growth} (tol {tol}), rel err {err}/"
                        f"{err_vals}")
    if missing:
        failures.append(f"dist_heev: spans {missing} not recorded")
    if any(launches.values()):
        failures.append(f"dist_heev launched {launches}, want none")
    return launches, a, Am


def check_dist_heev_dc(st, g, gen, nb, failures) -> None:
    """dist_heev_dc: heev with MethodEig.DC on the mesh at SPEC_PARITY_N
    (the hb2st chase, then stedc with its merges row-distributed), beside
    the single route's DC on the same A; the fallback ladder off."""
    from slate_tpu_torch.drivers.heev import _chase_steps
    from slate_tpu_torch.robust import certify
    n = SPEC_PARITY_N
    a, lam = spectral_matrix("heev", n, gen, torch.float32)
    o = {st.Option.ErrorPolicy: st.ErrorPolicy.Info,
         st.Option.MethodEig: st.MethodEig.DC,
         st.Option.UseFallbackSolver: False}
    (w1, _, h1), wall_single = _timed(lambda: st.heev(
        st.HermitianMatrix.from_numpy(a, nb), o))
    Am = st.HermitianMatrix.from_numpy(a, nb, grid=g)
    mesh = {**o, st.Option.Target: st.Target.mesh}
    (w, Z, h), cold = _timed(lambda: st.heev(Am, mesh))
    (w, Z, h), warm = _timed(lambda: st.heev(Am, mesh))
    scale = float(lam.abs().max())
    err = float((w.double() - lam).abs().max()) / scale
    diff = float((w - w1).abs().max()) / scale
    cert = certify.certify_eig(a, w, Z.to_dense()).to_list()[0]
    tol = certify.tolerance(torch.float32, n)
    emit({"phase": "dist_heev_dc", "n": n, "nb": nb, "method": "DC",
          "wall_s_cold": cold, "wall_s": warm,
          "single_route_wall_s": wall_single,
          "chase_steps": _chase_steps(n, nb),
          "certificate_ratio": cert.growth, "certify_tolerance": tol,
          "rel_err": err, "rel_diff_vs_single": diff, "ok": h.ok,
          "single_ok": h1.ok})
    if not (h.ok and cert.converged and cert.growth <= tol
            and err <= SPEC_BOUND[torch.float32] and diff <= PARITY_BOUND):
        failures.append(f"dist_heev_dc: ok {h.ok}, certificate "
                        f"{cert.growth}, rel err {err}, vs single {diff}")


def check_dist_svd(st, g, gen, nb, reset, counts, failures) -> dict:
    """dist_svd: svd on the one-rank mesh at DIST_SVD_N squared, f32, on the
    generator's svd matrix, cold and warm beside the single route's; the
    certificate and the singular values against the exact ones; no hand
    kernel."""
    from slate_tpu_torch.robust import certify
    n = DIST_SVD_N
    a, sigma = spectral_matrix("svd", n, gen, torch.float32)
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    (s1, _, _, h1), wall_single = _timed(lambda: st.svd(
        st.Matrix.from_numpy(a, nb), info))
    Am = st.Matrix.from_numpy(a, nb, grid=g)
    mesh = mesh_opts(st)
    reset()
    (s, U, V, h), cold = _timed(lambda: st.svd(Am, mesh))
    launches = counts()
    with st.obs.record_spans() as rec:
        (s, U, V, h), warm = _timed(lambda: st.svd(Am, mesh))
    spans = span_totals(rec.spans)
    err = float((s.double() - sigma).abs().max() / sigma[0])
    err_single = float((s1.double() - sigma).abs().max() / sigma[0])
    cert = certify.certify_svd(a, s, U.to_dense(), V.to_dense()).to_list()[0]
    tol = certify.tolerance(torch.float32, n)
    emit({"phase": "dist_svd", "m": n, "n": n, "nb": nb,
          "dtype": "float32", "grid": [g.p, g.q], "backend": "nccl",
          "wall_s_cold": cold, "wall_s": warm,
          "single_route_wall_s": wall_single,
          "spans_ms": {k: v for k, v in spans.items()
                       if k.startswith(("slate.svd", "slate.ge2tb"))},
          "certificate_ratio": cert.growth, "certify_tolerance": tol,
          "rel_err": err, "single_route_rel_err": err_single,
          "bound": SPEC_BOUND[torch.float32], "ok": h.ok,
          "single_ok": h1.ok, "launches": launches})
    if not (h.ok and cert.converged and cert.growth <= tol
            and err <= SPEC_BOUND[torch.float32]):
        failures.append(f"dist_svd: ok {h.ok}, certificate {cert.growth} "
                        f"(tol {tol}), rel err {err}")
    if any(launches.values()):
        failures.append(f"dist_svd launched {launches}, want none")
    return launches


def check_dist_hegv(st, g, a, gen, nb, reset, counts, failures) -> dict:
    """dist_hegv: hegv itype 1 on the mesh (dist_potrf of B, K1 on each
    diagonal tile: DIST_SPEC_N / nb launches; the mesh trsm; the mesh heev),
    cold and warm beside the single route's hegv on the same pair."""
    n = a.shape[0]
    gg = torch.randn(n, n, generator=gen, device="cuda")
    b = gg @ gg.T
    del gg
    b.diagonal().add_(n)
    (w1, X1), wall_single = _timed(lambda: st.hegv(
        st.HermitianMatrix.from_numpy(a, nb),
        st.HermitianMatrix.from_numpy(b, nb)))
    del X1
    Am = st.HermitianMatrix.from_numpy(a, nb, grid=g)
    Bm = st.HermitianMatrix.from_numpy(b, nb, grid=g)
    mesh = {st.Option.Target: st.Target.mesh}
    reset()
    (w, X), cold = _timed(lambda: st.hegv(Am, Bm, mesh))
    launches = counts()
    (w, X), warm = _timed(lambda: st.hegv(Am, Bm, mesh))
    x = X.to_dense()
    r = a @ x - (b @ x) * w[None, :]
    ratio = float(torch.linalg.norm(r) / (torch.linalg.norm(a)
                                          * torch.linalg.norm(x)))
    diff = float((w - w1).abs().max() / w1.abs().max())
    want = {**{k: 0 for k in launches}, "chol_tile": -(-n // nb)}
    emit({"phase": "dist_hegv", "itype": 1, "n": n, "nb": nb,
          "grid": [g.p, g.q], "backend": "nccl", "wall_s_cold": cold,
          "wall_s": warm, "single_route_wall_s": wall_single,
          "residual_ratio": ratio, "bound": HEGV_BOUND,
          "rel_diff_vs_single": diff, "launches": launches,
          "expected_launches": want})
    if launches != want or not ratio <= HEGV_BOUND or not diff <= 1e-4:
        failures.append(f"dist_hegv: launches {launches} (want {want}), "
                        f"residual {ratio}, vs single {diff}")
    return launches


def check_dist_stedc(st, g, gen, failures) -> None:
    """dist_stedc: stedc at DIST_STEDC_N with its merge products
    row-distributed over the grid (one rank: each merge's all-gather a
    copy), beside the single route's on the same tridiagonal."""
    from slate_tpu_torch.drivers import stedc as D
    n = DIST_STEDC_N
    d = torch.randn(n, generator=gen, device="cuda")
    e = torch.randn(n - 1, generator=gen, device="cuda")
    ((w1, Z1), h1), wall_single = _timed(lambda: D.stedc_info(d, e))
    ((w, Z), h), cold = _timed(lambda: D.stedc_info(d, e, g))
    ((w, Z), h), warm = _timed(lambda: D.stedc_info(d, e, g))
    diff = float((w - w1).abs().max() / w1.abs().max())
    vec = float((1 - (Z1 * Z).sum(dim=0).abs()).abs().max())
    emit({"phase": "dist_stedc", "n": n, "grid": [g.p, g.q],
          "wall_s_cold": cold, "wall_s": warm,
          "single_route_wall_s": wall_single, "rel_diff_vs_single": diff,
          "vectors_phase_defect_vs_single": vec, "tol": DIST_STEDC_TOL,
          "ok": h.ok, "single_ok": h1.ok})
    if not (h.ok and diff <= DIST_STEDC_TOL):
        failures.append(f"dist_stedc: ok {h.ok}, vs single {diff}")


def check_dist_pd(st, g, gen, nb, failures) -> None:
    """pdsyev and pdgesvd at DIST_PD_N in f64 over the grid's ScaLAPACK
    locals (one process: one local each), against numpy's values."""
    from slate_tpu_torch.compat import scalapack as sc
    from slate_tpu_torch.compat import scalapack_api as sapi
    n = DIST_PD_N
    ga = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    a = ga.cpu().numpy()
    h = (a + a.T) / 2
    dh, lh = sc.scatter_locals(h, nb, nb, g.p, g.q)
    (w, dz, lz), t_syev = _timed(lambda: sapi.pdsyev("v", "l", n, dh, lh,
                                                     g))
    z = sc.gather_locals(dz, lz, g.p, g.q)
    wn = np.linalg.eigvalsh(h)
    err_w = float(np.abs(w - wn).max() / np.abs(wn).max())
    res_z = float(np.abs(h @ z - z * w[None, :]).max() / np.abs(h).max())
    da, la_ = sc.scatter_locals(a, nb, nb, g.p, g.q)
    (s, du, lu, dvt, lvt), t_svd = _timed(lambda: sapi.pdgesvd(
        "v", n, n, da, la_, g))
    u, vt = sc.gather_locals(du, lu, g.p, g.q), sc.gather_locals(
        dvt, lvt, g.p, g.q)
    sn = np.linalg.svd(a, compute_uv=False)
    err_s = float(np.abs(s - sn).max() / sn[0])
    res_u = float(np.abs(a - (u * s[None, :]) @ vt).max() / np.abs(a).max())
    emit({"phase": "dist_pd_spectral", "n": n, "nb": nb, "dtype": "float64",
          "pdsyev_wall_s": t_syev, "pdsyev_rel_err": err_w,
          "pdsyev_residual": res_z, "pdgesvd_wall_s": t_svd,
          "pdgesvd_rel_err": err_s, "pdgesvd_residual": res_u,
          "bound": DIST_PD_BOUND})
    if not all(x <= DIST_PD_BOUND for x in (err_w, res_z, err_s, res_u)):
        failures.append(f"pdsyev/pdgesvd: {err_w}, {res_z}, {err_s}, "
                        f"{res_u}")


def check_dist_spectral_bits(st, g, gen, nb, failures) -> None:
    """dist_spectral_lookahead: dist_he2hb and dist_ge2tb at
    DIST_SPEC_BITS_N at depths 0, 1 and 2, every output bit for bit."""
    from slate_tpu_torch.parallel.dist_ge2tb import dist_ge2tb
    from slate_tpu_torch.parallel.dist_he2hb import dist_he2hb
    n = DIST_SPEC_BITS_N
    a = torch.randn(n, n, generator=gen, device="cuda")
    H = st.HermitianMatrix.from_numpy((a + a.T) / 2, nb, grid=g).storage
    G = dist_matrix(st, g, a, nb).storage
    he, ge, hw, gw = [], [], [], []
    for la in (0, 1, 2):
        o, t = _timed(lambda: dist_he2hb(H.data, H.Nt, g, n=n, la=la))
        he.append(o)
        hw.append(t)
        o, t = _timed(lambda: dist_ge2tb(G.data, G.Mt, G.Nt, n, n, g,
                                         la=la))
        ge.append(o)
        gw.append(t)
    same_he = all(all(torch.equal(x, y) for x, y in zip(he[0], o))
                  for o in he[1:])
    same_ge = all(all(torch.equal(x, y) for x, y in zip(ge[0], o))
                  for o in ge[1:])
    emit({"phase": "dist_spectral_lookahead", "n": n, "nb": nb,
          "he2hb_wall_s_by_depth": hw, "ge2tb_wall_s_by_depth": gw,
          "he2hb_bit_equal": same_he, "ge2tb_bit_equal": same_ge})
    if not (same_he and same_ge):
        failures.append(f"dist_spectral_lookahead: dist_he2hb equal "
                        f"{same_he}, dist_ge2tb equal {same_ge}")


def check_dist_heev_strike(st, g, gen, nb, failures) -> None:
    """dist_heev_strike: a transient NaN strike on the gathered band
    (post_stage1) of a mesh heev at SPEC_PARITY_N: Auto's certificate
    fails, the ladder escalates to DC, which certifies; the path read
    from the call's obs event."""
    from slate_tpu_torch.robust import certify, faults
    n = SPEC_PARITY_N
    a, lam = spectral_matrix("heev", n, gen, torch.float32)
    Am = st.HermitianMatrix.from_numpy(a, nb, grid=g)
    plan = faults.FaultPlan(site="post_stage1", kind="nan", seed=17,
                            count=4, transient=True)
    with faults.inject(plan), st.obs.recording() as evs:
        (w, Z, h), wall = _timed(lambda: st.heev(Am, mesh_opts(st)))
    ev = evs[-1]
    cert = certify.certify_eig(a, w, Z.to_dense()).to_list()[0]
    err = float((w.double() - lam).abs().max() / lam.abs().max())
    emit({"phase": "dist_heev_strike", "n": n, "nb": nb,
          "site": plan.site, "kind": plan.kind, "transient": True,
          "path": ev.get("path"), "escalations": ev.get("escalations"),
          "ok": h.ok, "certificate_ratio": cert.growth, "rel_err": err,
          "wall_s": wall})
    if not (h.ok and ev.get("path") == "escalated:DC" and cert.converged
            and err <= SPEC_BOUND[torch.float32]):
        failures.append(f"dist_heev_strike: ok {h.ok}, path "
                        f"{ev.get('path')}, certificate {cert.growth}, "
                        f"rel err {err}")


def check_slice18(st, seed, nb, reset, counts, trace) -> dict:
    """The slice-18 phases (the distributed spectral reductions) in a
    third one-rank NCCL world, Grid(1, 1, group=WORLD) on cuda:0, every
    call with Target.mesh; matrices draw from --seed + 19.  Returns the
    launch counts of the paths."""
    import torch.distributed as dist
    failures = []
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    out = {}
    t_slice = time.perf_counter()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="smoke-nccl18-") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            g = st.Grid(1, 1, group=dist.group.WORLD)
            t0 = time.perf_counter()
            out["dist_heev"], a, Am = check_dist_heev(st, g, gen, nb, reset,
                                                      counts, failures)
            emit({"phase": "seconds", "of": "dist_heev",
                  "seconds": time.perf_counter() - t0})
            if trace:
                with phase_limit("trace_dist_spectral",
                                 TRACE_SPECTRAL_LIMIT_S):
                    emit({"phase": "trace_spans", "of": "dist_heev",
                          "spans_ms": span_ms(st, lambda: st.heev(
                              Am, mesh_opts(st)))})
                    profile_device("dist_heev", lambda: st.heev(
                        Am, mesh_opts(st)), cpu=False)
            del Am
            t0 = time.perf_counter()
            out["dist_hegv"] = check_dist_hegv(st, g, a, gen, nb, reset,
                                               counts, failures)
            del a
            emit({"phase": "seconds", "of": "dist_hegv",
                  "seconds": time.perf_counter() - t0})
            for name, fn in (
                    ("dist_svd", lambda: {"dist_svd": check_dist_svd(
                        st, g, gen, nb, reset, counts, failures)}),
                    ("dist_heev_dc", lambda: check_dist_heev_dc(
                        st, g, gen, nb, failures)),
                    ("dist_stedc", lambda: check_dist_stedc(
                        st, g, gen, failures)),
                    ("dist_pd_spectral", lambda: check_dist_pd(
                        st, g, gen, nb, failures)),
                    ("dist_spectral_lookahead",
                     lambda: check_dist_spectral_bits(st, g, gen, nb,
                                                      failures)),
                    ("dist_heev_strike", lambda: check_dist_heev_strike(
                        st, g, gen, nb, failures))):
                t0 = time.perf_counter()
                torch.cuda.empty_cache()
                out.update(fn() or {})
                emit({"phase": "seconds", "of": name,
                      "seconds": time.perf_counter() - t0})
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit({"phase": "seconds", "of": "slice18",
          "seconds": time.perf_counter() - t_slice})
    if failures:
        raise AssertionError("slice 18: " + "; ".join(failures))
    return out


# ---- slice 19: the tester and the examples ----
# the tester's command lines on the serial route (1x1): every routine in
# s and d at 4096, in c and z at 2048, the --ref runners in all four types
# at 2048, and posv at n = 4000, whose last 32-column panel factors on K1
# (at n = 4096 every posv panel is K2's fused step, K1's loop inside its
# factor launch)
# the tester's sizes: s and d at TESTER_N, c, z and --ref at
# TESTER_SMALL_N (4096 and 2048 before slice 21, cut to keep the smoke
# inside its limit on a slow host: the tester's time is mostly the
# reference's host-side generators, ~n^3); c and z at TESTER_CZ_N (1536
# before slice 23, whose phases took the difference; c and z rows launch
# no hand kernel)
TESTER_N = 3072
TESTER_SMALL_N = 1536
TESTER_CZ_N = 1024
TESTER_RUNS = (
    ("tester_sd", ["all", "--type", "s,d", "--dims", str(TESTER_N),
                   "--nb", "128"]),
    ("tester_cz", ["all", "--type", "c,z", "--dims", str(TESTER_CZ_N),
                   "--nb", "128"]),
    ("tester_ref", ["--ref", "gesv", "heev", "svd", "gels", "--type",
                    "s,d,c,z", "--dims", str(TESTER_SMALL_N), "--nb",
                    "128"]),
    ("tester_k1", ["posv", "--type", "s", "--dims", "4000", "--nb", "128"]),
    # slice 22: K4 and K5 at the tuned width 256
    ("tester_nb256", ["gesv_tntpiv", "geqrf", "gels", "--type", "s",
                      "--dims", str(TESTER_N), "--nb", "256"]),
)


def tester_launches(kernels, fits) -> dict:
    """The hand kernels each tester row must launch, by (routine, type,
    n, nb): none on an f64 or complex row; posv, gesv_tntpiv, geqrf and
    gels in s as their seams route them at nb = 128 and (gesv_tntpiv,
    geqrf, gels) 256 (posv by expected_posv_launches, the CALU tournament
    by expected_calu_launches with ``fits(h, nb)``, one K5 a panel of the
    2n x n geqrf and gels within the 2^20-element cap)."""
    zero = {name: 0 for name in kernels}
    want = {}
    for n in (TESTER_N, 4000):
        want[("posv", "s", n, 128)] = {**zero,
                                       **expected_posv_launches(n, 128)}
    for nb in (128, 256):
        want[("gesv_tntpiv", "s", TESTER_N, nb)] = {
            **zero, **expected_calu_launches(TESTER_N, nb,
                                             lambda h: fits(h, nb))}
        for routine in ("geqrf", "gels"):
            want[(routine, "s", TESTER_N, nb)] = {
                **zero, "qr_panel": gels_k5_panels(2 * TESTER_N, TESTER_N,
                                                   nb)}
    return want


def check_tester(st, kernels, reset, counts, failures) -> dict:
    """The tester's runs (TESTER_RUNS) on the card: every table row on a
    line of its own (the tester prints them), a JSON line a run with each
    row's time, gflops, error, status and the kernels it launched; a
    FAILED or ERROR row, a nonzero exit or a row that launches other
    kernels than tester_launches says fails.  Returns the launches summed
    over the rows, by kernel."""
    from slate_tpu_torch import tester
    from slate_tpu_torch.internal.getrf import _lu_select_ok
    want = tester_launches(kernels, lambda h, nb: _lu_select_ok(
        torch.empty((1, h, nb), device="cuda"), nb))
    zero = {name: 0 for name in kernels}
    total = dict(zero)

    def tally(row):
        torch.cuda.synchronize()
        row["launches"] = counts()
        reset()

    for name, argv in TESTER_RUNS:
        rows = []
        t0 = time.perf_counter()
        reset()
        rc = tester.main(argv + ["--grids", "1x1"], rows, tally)
        wall = time.perf_counter() - t0
        emit({"phase": name, "argv": argv, "rc": rc, "wall_s": wall,
              "rows": rows})
        if rc != 0 or tester.failures(rows):
            failures.append(f"{name}: rc {rc}, rows " + "; ".join(
                f"{r['routine']} {r['type']} {r['status']}" for r in rows
                if r["status"] != "pass"))
        for r in rows:
            got = r.get("launches", {})
            key = (r["routine"], r["type"], r["n"], r["nb"])
            # the other s rows (gesv's library LU, hesv, ...) launch what
            # their gates give: counted, not asserted
            expect = want.get(key, None if key[1] == "s" else zero)
            if name == "tester_nb256" and not (got.get("qr_panel") or
                                               got.get("lu_select")):
                failures.append(f"{name} {key}: no K4 or K5 launch")
            if expect is not None and got != expect:
                failures.append(f"{name} {key}: launches {got} != "
                                f"{expect}")
            for k, v in got.items():
                total[k] += v
    missing = sorted({"upper_tri_inv", "chol_tile", "chol_panel_fused",
                      "lu_panel_fused", "lu_select", "qr_panel"}
                     - {k for k, v in total.items() if v})
    if missing:
        failures.append(f"tester: kernels not launched {missing}")
    return total


def check_examples_nccl(failures) -> None:
    """ex01-ex14 (run_all) in a fourth one-rank NCCL world: Grid(1, 1,
    group=WORLD) on cuda:0 where an example takes a grid."""
    import torch.distributed as dist
    from slate_tpu_torch.examples import run_all
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="smoke-nccl19-") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            t0 = time.perf_counter()
            failed = run_all.run(run_all.EXAMPLES, torch.device("cuda", 0))
            emit({"phase": "examples_nccl", "world": 1,
                  "examples": len(run_all.EXAMPLES), "failed": failed,
                  "wall_s": time.perf_counter() - t0})
        finally:
            dist.destroy_process_group()
    if failed:
        failures.append(f"examples_nccl: {failed}")


def check_slice19(st, kernels, reset, counts) -> dict:
    """The slice-19 phases: the tester (check_tester), then the examples
    in a one-rank NCCL world; the gloo children ran them in their 2 x 2
    world (gloo_2x2_slice19).  The tester's runners draw their inputs
    from their own seeds (the reference tester's), the examples from
    theirs.  Returns the tester's launches by kernel."""
    failures = []
    t_slice = time.perf_counter()
    out = check_tester(st, kernels, reset, counts, failures)
    emit({"phase": "seconds", "of": "tester",
          "seconds": time.perf_counter() - t_slice})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_examples_nccl(failures)
    emit({"phase": "seconds", "of": "examples_nccl",
          "seconds": time.perf_counter() - t0})
    emit({"phase": "seconds", "of": "slice19",
          "seconds": time.perf_counter() - t_slice})
    if failures:
        raise AssertionError("slice 19: " + "; ".join(failures))
    return out


# slice 21: K0-K3 at the reference's wide widths.  K1 takes tiles up to
# 1024, K0, K2 and K3 panels of 256, 384 and 512 columns (one
# thread-block cluster factors the diagonal block in device memory by
# 128-column blocks: csrc/wide_factor.cuh).  These phases draw from
# --seed + 20, apart from the posv and NoPiv runs at the wide widths,
# which reuse the main path's matrices.
WIDE_NBS = (256, 512)           # posv's panels and K2's, K0's and K3's checks
WIDE_TILE_NS = (256, 512, 1024)  # K1's tiles
WIDE_NOPIV_NB = 256
WIDE_OOC_N = 8192               # potrf_ooc at its default width (256)


def wide_posv_launches(n: int, nb: int) -> dict:
    """K2 and K0 launches of an f32 posv at n on nb-wide panels that K2
    takes: three K2 launches a panel with rows below, two on the last, one
    K0 a panel with rows below."""
    panels = -(-n // nb)
    return {"chol_panel_fused": 3 * panels - 1,
            "upper_tri_inv": panels - 1}


def chol_tile_split(a: torch.Tensor) -> dict:
    """K1's wide route on ``a`` split by wf_chol's globaltimer stamps
    (chol_kernels.chol_tile_stamps; the last of three stamped launches,
    which the launch counts leave out): the first diagonal block's factor
    and inverse, which no product hides; then per step the products (the
    step's start to the last worker's end) and the exposed diagonal chain
    (the last worker's end to the step's closing barrier: the lookahead's
    solve, update, factor and inverse outlasting the products, and the
    barrier).  Emits a ``chol_tile_split`` line and returns it."""
    from slate_tpu_torch.internal.chol_kernels import chol_tile_stamps
    n = a.shape[0]
    for _ in range(3):
        _, stamps, cluster = chol_tile_stamps(a)
    st = stamps.cpu().tolist()
    nt = -(-n // 128)
    start = st[nt][0]
    first = 1e-3 * (st[0][16] - start)
    steps = []
    for s in range(1, nt):
        begin, end = st[s - 1][16], st[s][16]
        work = max(st[s][1:cluster])
        steps.append({"products_us": 1e-3 * (work - begin),
                      "exposed_chain_us": 1e-3 * (end - work),
                      "chain_us": 1e-3 * (st[s][0] - begin)})
    line = {"phase": "chol_tile_split", "n": n, "cluster": cluster,
            "total_us": 1e-3 * (st[nt - 1][16] - start),
            "first_factor_us": first,
            "exposed_chain_us": first + sum(x["exposed_chain_us"]
                                            for x in steps),
            "products_us": sum(x["products_us"] for x in steps),
            "steps": steps}
    emit(line)
    return line


def tri_inv_split(u: torch.Tensor) -> dict:
    """K0's wide route on ``u`` split by its globaltimer stamps
    (tri_inv.upper_tri_inv_stamps, the last of three stamped launches,
    which the launch counts leave out): the diagonal blocks' copy-in and
    their inverses, each half-level of the joins (T = U12 X22, then X12 =
    -X11 T) and the store, each phase to the slowest CTA's end.  Emits a
    ``tri_inv_split`` line and returns it."""
    from slate_tpu_torch.internal.tri_inv import (upper_tri_inv,
                                                  upper_tri_inv_stamps)
    for _ in range(3):
        x, stamps, cluster = upper_tri_inv_stamps(u)
    st = stamps.cpu().tolist()
    n = u.shape[0]
    halves = 2 * max(1, (-(-n // 128) - 1).bit_length())
    start = min(r[0] for r in st)
    ends = [max(r[p] for r in st) for p in range(3 + halves)]
    ends.append(max(r[-1] for r in st))
    us = [1e-3 * (b - a) for a, b in zip([start] + ends[1:-1], ends[1:])]
    line = {"phase": "tri_inv_split", "n": n, "cluster": cluster,
            "total_us": 1e-3 * (ends[-1] - start),
            "copy_in_us": us[0], "diagonal_inverse_us": us[1],
            "half_levels_us": us[2:-1], "store_us": us[-1],
            "bit_equal_to_unstamped": bool(torch.equal(x,
                                                       upper_tri_inv(u)))}
    emit(line)
    if not line["bit_equal_to_unstamped"]:
        raise AssertionError(f"upper_tri_inv_stamps at {n}: not the "
                             f"unstamped launch's bits")
    return line


def lu_panel_split(x: torch.Tensor, bw: int = 8) -> dict:
    """K3's wide factor launch on the panel ``x`` split by its globaltimer
    stamps (lu_kernels.lu_panel_stamps, the last of three stamped launches,
    which the launch counts leave out): the diagonal chain, each 128-column
    block's factor and its two triangular inverses; per step the products
    (the step's start to the last CTA's end of its tiles) and the chain
    left exposed past them (to the step's closing barrier); and U^-1 of
    the whole nb x nb U.  Emits a ``lu_panel_split`` line, the factored
    block and U^-1 checked bit-equal to the counted launch's, and returns
    it."""
    from slate_tpu_torch.internal.lu_kernels import (lu_panel_fused,
                                                     lu_panel_stamps)
    from slate_tpu_torch.internal.tri_inv import upper_tri_inv
    w, nb = x.shape
    for _ in range(3):
        top, uinv, stamps, k0_stamps, cluster = lu_panel_stamps(x, bw)
    st = stamps.cpu().tolist()
    k0 = [v for r in k0_stamps.cpu().tolist() for v in r if v]
    nt = nb // 128
    start, fac_end = st[nt][:2]
    # U^-1: K0's launch after the factor's (none when W == nb)
    u0, u1 = (min(k0), max(k0)) if k0 else (0, 0)
    us = lambda a, b: 1e-3 * (b - a) if a and b else 0.0  # noqa: E731
    blocks, steps = [], []
    # a step's products follow block j's factor and its inverses; the
    # lookahead's quarters of block j + 1 arrive in rank 0 within step j
    begin = st[0][19]
    for j in range(nt):
        row = st[j]
        blocks.append({"factor_us": us(row[17], row[18]),
                       "inverses_us": us(row[18], row[19]),
                       "lookahead_us": (us(begin, st[j + 1][0])
                                          if j + 1 < nt else 0.0),
                       "lt_copied_us": us(row[18], row[1])})
        if not row[16]:
            continue
        work = max([v for v in row[2:16] if v] or [begin])
        steps.append({"products_us": us(begin, work),
                      "exposed_us": us(work, row[16])})
        begin = row[16]
    want = lu_panel_fused(x, bw)
    same = bool(torch.equal(top, want[:nb])) and (
        uinv is None or bool(torch.equal(uinv, upper_tri_inv(
            torch.triu(want[:nb])))))
    line = {"phase": "lu_panel_split", "W": w, "nb": nb, "cluster": cluster,
            "total_us": us(start, u1 or fac_end),
            "factor_launch_us": us(start, fac_end),
            "diagonal_chain_us": sum(b["factor_us"] + b["inverses_us"]
                                     for b in blocks),
            "exposed_us": us(start, st[0][19]) + sum(s["exposed_us"]
                                                     for s in steps),
            "products_us": sum(s["products_us"] for s in steps),
            "u_inverse_us": us(u0, u1), "blocks": blocks, "steps": steps,
            "bit_equal_to_unstamped": same}
    emit(line)
    if not same:
        raise AssertionError(f"lu_panel_stamps at [{w}, {nb}]: not the "
                             f"unstamped launch's bits")
    return line


def lu_select_split(x: torch.Tensor, live=None, bw: int = 8) -> dict:
    """K4's wide launch on the round ``x`` split by chunk 0's globaltimer
    stamps (lu_kernels.lu_select_stamps, the last of three stamped
    launches, which the launch counts leave out): per 128-column block the
    load of its columns, the column chain, L11 and U, and the update of
    the columns right of it, each to the slowest CTA's end.  Emits a
    ``lu_select_split`` line (the pivots checked equal to the counted
    launch's) and returns it."""
    from slate_tpu_torch.internal.lu_kernels import (lu_select,
                                                     lu_select_stamps)
    for _ in range(3):
        piv, stamps, cluster = lu_select_stamps(x, live, bw)
    st = stamps.cpu().tolist()
    blocks = []
    for blk in st:
        ends = [max(r[p] for r in blk) for p in range(5)]
        begin = min(r[0] for r in blk)
        prev, parts = begin, []
        for e in ends[1:]:
            parts.append(1e-3 * (e - prev) if e else 0.0)
            prev = e or prev
        blocks.append(dict(zip(("load_us", "chain_us", "l11_u_us",
                                "update_us"), parts)))
    first = min(r[0] for r in st[0])
    last = max(v for blk in st for r in blk for v in r)
    same = bool(torch.equal(piv, lu_select(x, nrows=live)))
    line = {"phase": "lu_select_split", "G": x.shape[0], "W": x.shape[1],
            "nb": x.shape[2], "cluster": cluster,
            "total_us": 1e-3 * (last - first),
            **{k: sum(b[k] for b in blocks) for k in blocks[0]},
            "blocks": blocks, "pivots_equal_unstamped": same}
    emit(line)
    if not same:
        raise AssertionError(f"lu_select_stamps {tuple(x.shape)}: not the "
                             f"unstamped launch's pivots")
    return line


def qr_panel_split(x: torch.Tensor, bw: int = 8) -> dict:
    """K5's wide route on ``x`` split by its device launches (torch.profiler
    by kernel name, a mean over three calls): the block factors
    (qr_wide_factor_kernel), the T merges (qr_merge_*), the strip updates
    (qr_strip_kernel) and the panel's copy-in.  Emits a ``qr_panel_split``
    line and returns it."""
    from slate_tpu_torch.internal.qr_kernels import qr_panel
    by_name = device_ms(lambda: qr_panel(x, bw), reps=3)

    def pick(tag):
        return sum(v for k, v in by_name.items() if tag in k)
    line = {"phase": "qr_panel_split", "mm": x.shape[0], "w": x.shape[1],
            "factor_ms": pick("qr_wide_factor_kernel"),
            "merge_ms": pick("qr_merge_"),
            "strips_ms": pick("qr_strip_kernel"),
            "copy_ms": pick("qr_wide_copy_kernel")}
    emit(line)
    return line


def check_wide_kernels(gen) -> dict:
    """K1 at n = 256, 512 and 1024 (each with a ``chol_tile_split`` line: the
    exposed diagonal chain against the products) and on an indefinite 512
    tile (the same first bad pivot as the plain version); K2 at [M, K] =
    [10240, 10240] at nb = 256 and 512 and at a ragged K = 1000 with a
    transposed left (the update a 3xTF32 product, within twice
    torch.matmul's f32 error of the f64 product); K0 at n = 256 and 512 on
    a Cholesky U (each with a ``tri_inv_split`` line), and on a partially
    pivoted LU's U within 1e-5 of the f64 inverse; K3 at W = 20480 and W =
    nb at nb = 256 and 512 (each with a ``lu_panel_split`` line: the
    diagonal chain, the products and U^-1). Each against its plain version,
    timed beside its bound and the library call, launched twice and
    compared bit for bit.  Returns {kernel name: [rows]}."""
    from slate_tpu_torch.internal.chol_kernels import (chol_tile,
                                                       chol_tile_plain)
    from slate_tpu_torch.internal.lu_kernels import (lu_panel_fused,
                                                     lu_panel_plain)
    from slate_tpu_torch.internal.tri_inv import (upper_tri_inv,
                                                  upper_tri_inv_plain)
    rows = {"chol_tile": [], "chol_panel_fused": [], "upper_tri_inv": [],
            "lu_panel_fused": []}

    def repeat(name, shape, got, again):
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        if not same:
            raise AssertionError(f"{name} {shape}: two launches on the "
                                 f"same input differ")
        return same

    for n in WIDE_TILE_NS:
        a = spd(n, gen)
        got = chol_tile(a, 8)
        row = check(
            "chol_tile", {"n": n, "bw": 8}, [got], [chol_tile_plain(a, 8)],
            "the kernel's 128-column diagonal blocks (32-column blocks "
            "inside) against the reference's bw = 8 slabs: the same factor, "
            "f32 sums in another order, on A with cond <= ~5",
            time_ms(lambda: chol_tile(a, 8), 20),
            time_ms(lambda: chol_tile_plain(a, 8), 2),
            time_ms(lambda: torch.linalg.cholesky_ex(a), 20),
            op_flops("potrf", (n, n)), 4 * (n * (n + 1) // 2 + n * n))
        row["bitwise_repeatable"] = repeat("chol_tile", n, [got],
                                           [chol_tile(a, 8)])
        split = chol_tile_split(a)
        row["split_us"] = {k: split[k] for k in ("first_factor_us",
                                                 "exposed_chain_us",
                                                 "products_us")}
        rows["chol_tile"].append(row)
    check_first_bad_pivot(gen, n=512, at=300)
    for m, k, left_t, nb in ((10240, 10240, False, 256),
                             (10240, 10240, False, 512),
                             (2048, 1000, True, 256)):
        rows["chol_panel_fused"].append(check_chol_panel(gen, m, k, left_t,
                                                         nb))
    for n in WIDE_NBS:
        u = torch.linalg.cholesky(spd(n, gen)).mT.contiguous()
        eye = torch.eye(n, device="cuda")
        got = upper_tri_inv(u)
        row = check(
            "upper_tri_inv", {"n": n}, [got], [upper_tri_inv_plain(u)],
            "blocked doubling in both (128 x 128 diagonal blocks, a "
            "1024-thread CTA each, joined by 32-row strips over the "
            "cluster in the kernel), sums in another order, on U with "
            "cond <= ~3",
            time_ms(lambda: upper_tri_inv(u), 20),
            time_ms(lambda: upper_tri_inv_plain(u), 3),
            time_ms(lambda: torch.linalg.solve_triangular(u, eye, upper=True),
                    20),
            op_flops("trtri", (n, n)), 4 * (n * (n + 1) // 2 + n * n))
        row["bitwise_repeatable"] = repeat("upper_tri_inv", n, [got],
                                           [upper_tri_inv(u)])
        split = tri_inv_split(u)
        row["split_us"] = {k: split[k] for k in (
            "copy_in_us", "diagonal_inverse_us", "half_levels_us",
            "store_us")}
        g = torch.randn(4 * n, n, generator=gen, device="cuda")
        up = torch.triu(torch.linalg.lu_factor(g)[0][:n]).contiguous()
        x64 = torch.linalg.inv(up.double())
        xp = upper_tri_inv(up)
        rel = float((xp.double() - x64).abs().max() / x64.abs().max())
        rel_plain = float((xp - upper_tri_inv_plain(up)).abs().max()
                          / x64.abs().max())
        repeat("upper_tri_inv", (n, "pivoted"), [xp], [upper_tri_inv(up)])
        emit({"phase": "upper_tri_inv_pivoted_u", "n": n,
              "rel_err_vs_f64": rel, "tol": 1e-5,
              "rel_diff_vs_plain": rel_plain,
              "cond": float(torch.linalg.cond(up.double()))})
        row["pivoted_u_rel_err_vs_f64"] = rel
        if not rel < 1e-5:
            raise AssertionError(f"upper_tri_inv on a pivoted U at {n}: "
                                 f"{rel} from the f64 inverse (tolerance "
                                 f"1e-5)")
        rows["upper_tri_inv"].append(row)
    for nb in WIDE_NBS:
        for w in (20480, nb):
            # diagonally dominant top block: the no-pivot factor is stable
            # at any width, so kernel and plain differ by sum order alone
            x = torch.randn(w, nb, generator=gen, device="cuda")
            x[:nb] += nb * torch.eye(nb, device="cuda")

            def library():
                return torch.linalg.lu_factor_ex(x, pivot=False)[0]
            got = lu_panel_fused(x, 8)
            times = k3_launch_times(lambda: lu_panel_fused(x, 8))
            row = check(
                "lu_panel_fused", {"W": w, "nb": nb, "bw": 8}, [got],
                [lu_panel_plain(x, 8)],
                "128-column diagonal blocks (32-column blocks inside) on "
                "one cluster against the reference's bw = 8 slabs, U^-1 by "
                "blocked doubling in both, f32 sums in another order, on a "
                "diagonally dominant panel (|L| ~ 1 / nb); the library's "
                "unpivoted LU as a witness",
                time_ms(lambda: lu_panel_fused(x, 8), 10),
                time_ms(lambda: lu_panel_plain(x, 8), 2),
                time_ms(library, 10),
                panel_flops(w, 0, nb, "getrf"), 4 * 2 * w * nb,
                witness=[library()])
            row.update(times, bitwise_repeatable=repeat(
                "lu_panel_fused", (w, nb), [got], [lu_panel_fused(x, 8)]))
            split = lu_panel_split(x)
            row["split_us"] = {k: split[k] for k in (
                "diagonal_chain_us", "exposed_us", "products_us",
                "u_inverse_us")}
            emit({"phase": "lu_panel_plan", "W": w, "nb": nb, **times,
                  "bitwise_repeatable": True, "kernel_ms": row["kernel_ms"]})
            rows["lu_panel_fused"].append(row)
    return rows


def check_wide_posv(st, a, b, x64, nb, kernels, reset, counts,
                    card) -> dict:
    """posv on the main path's matrix at nb = 256 and 512 beside the nb =
    128 route of the same run: K2 and K0 on every panel
    (wide_posv_launches), PERF.md's accuracy bounds, cold and warm walls
    and the device's busy time of a warm run (torch.profiler)."""
    n = a.shape[0]
    base_warm = min(run_posv(st, a, b, nb)[1] for _ in range(2))
    base_busy = device_busy(lambda: run_posv(st, a, b, nb))
    out = {}
    for wnb in WIDE_NBS:
        reset()
        x, cold = run_posv(st, a, b, wnb)
        launches = counts()
        warm = min(run_posv(st, a, b, wnb)[1] for _ in range(2))
        busy = device_busy(lambda: run_posv(st, a, b, wnb))
        res, fwd = accuracy(a, x, b, x64)
        want = {**{name: 0 for name in kernels},
                **wide_posv_launches(n, wnb)}
        emit({"phase": f"posv_nb{wnb}", "n": n, "nb": wnb,
              "nrhs": b.shape[1], "wall_s": cold, "wall_s_warm": warm,
              "device_busy_s": busy, "nb128_wall_s_warm": base_warm,
              "nb128_device_busy_s": base_busy,
              "scaled_residual": res, "residual_bound": RESIDUAL_BOUND,
              "forward_error_vs_f64": fwd, "forward_bound": FORWARD_BOUND,
              "launches": launches, "want": want, "card": card})
        if not (torch.isfinite(x).all() and launches == want
                and res < RESIDUAL_BOUND and fwd < FORWARD_BOUND):
            raise AssertionError(f"posv at nb = {wnb}: launches {launches} "
                                 f"(want {want}), residual {res}, forward "
                                 f"{fwd}")
        out[f"posv_nb{wnb}"] = launches
    return out


def check_wide_nopiv(st, a, b, kernels, reset, counts, card) -> dict:
    """NoPiv gesv on the NoPiv phase's matrix at nb = 256: K3 on every
    panel (two launches a panel with rows below, one on the last), under
    that phase's bounds."""
    n, nb = a.shape[0], WIDE_NOPIV_NB
    opts = {st.Option.MethodLU: st.MethodLU.NoPiv}
    reset()
    _, x, wall = run_gesv(st, a, b, nb, opts)
    launches = counts()
    _, _, warm = run_gesv(st, a, b, nb, opts)
    res, fwd = accuracy(a, x, b, torch.linalg.solve(a.double(), b.double()))
    want = {**{name: 0 for name in kernels},
            "lu_panel_fused": 2 * (n // nb) - 1}
    emit({"phase": f"gesv_nopiv_nb{nb}", "n": n, "nb": nb, "wall_s": wall,
          "wall_s_warm": warm, "scaled_residual": res,
          "forward_error_vs_f64": fwd, "launches": launches, "card": card})
    if (launches != want or not res < GESV_RESIDUAL_BOUND
            or not fwd < GESV_FORWARD_BOUND):
        raise AssertionError(f"NoPiv at nb = {nb}: launches {launches} "
                             f"(want {want}), residual {res}, forward {fwd}")
    return {f"gesv_nopiv_nb{nb}": launches}


def check_wide_ooc(st, gen, nrhs, kernels, reset, counts, card) -> dict:
    """potrf_ooc at WIDE_OOC_N, f32, at its default width (256, from
    ooc_panel_width on the empty plan cache): K1 once a step at 256, the
    factor against the in-core potrf's, its residual, the walls beside
    in-core posv's at nb = 128 and 256."""
    from slate_tpu_torch.tune.plans import ooc_panel_width
    n = WIDE_OOC_N
    nb = ooc_panel_width(n)
    g = torch.randn(n, n, generator=gen, device="cuda")
    a = g @ g.T
    del g
    a.diagonal().add_(n)
    b = torch.randn(n, nrhs, generator=gen, device="cuda")
    a_h = a.cpu().numpy()
    l_in = st.potrf(st.HermitianMatrix.from_numpy(a, nb)).to_dense()
    posv = {f"incore_posv_nb{w}_wall_s_warm":
            min(run_posv(st, a, b, w)[1] for _ in range(3))
            for w in (128, nb)}
    reset()
    lfac, wall = _timed(lambda: st.potrf_ooc(a_h))
    launches = counts()
    lfac2, warm = _timed(lambda: st.potrf_ooc(a_h))
    repeat = bool(np.array_equal(lfac, lfac2))
    lt = torch.from_numpy(lfac).cuda()
    agree = float((lt - l_in).abs().max() / l_in.abs().max())
    l64 = lt.double()
    res = rel_factor_residual(a, l64 @ l64.T)
    del l64, lt, l_in, lfac2
    want = {**{name: 0 for name in kernels}, "chol_tile": -(-n // nb)}
    bound = n * EPS32
    emit({"phase": "potrf_ooc_default_width", "n": n, "nb": nb,
          "dtype": "float32", "rel_max_diff_vs_incore_potrf": agree,
          "tol": RTOL, "factor_residual": res, "residual_bound": bound,
          "launches": launches, "wall_s": wall, "wall_s_warm": warm,
          **posv, "bitwise_repeatable": repeat, "card": card})
    if not (nb == 256 and np.isfinite(lfac).all() and launches == want
            and agree <= RTOL and res < bound and repeat):
        raise AssertionError(f"potrf_ooc at its default width {nb}: "
                             f"launches {launches} (want {want}), diff "
                             f"{agree}, residual {res}, repeatable {repeat}")
    return {"potrf_ooc_default_width": launches}



# slice 22: K4 and K5 at the reference's wide widths.  K4 takes chunks of
# nb = 256, 384 and 512 columns (the chunk's working copy in a workspace,
# walked by 128-column blocks), K5 panels of w = 256, 384 and 512 (by
# 128-column blocks, T in device memory).  These phases draw from --seed +
# 21, apart from the CALU runs at the wide widths, which reuse the main
# CALU phase's matrix.
WIDE_SELECT_SHAPES = ((4, 5120, 256, None), (4, 5120, 512, None),
                      (2, 512, 256, None), (2, 1024, 512, None),
                      (2, 1024, 384, (1024, 700)))
WIDE_QR_SHAPES = ((4096, 256), (2048, 512), (3000, 256))
WIDE_CALU_NBS = (256, 512)
WIDE_GELS = ((4096, 2048, 256), (2048, 1024, 512))   # (m, n, nb)


def gels_k5_panels(m: int, n: int, nb: int) -> int:
    """K5 launches of a QR gels of an m x n matrix on nb-wide panels: one a
    panel within the 2^20-element cap (internal/qr.py)."""
    from slate_tpu_torch.internal.qr import QR_PANEL_MAX_ELEMS
    return sum((m - k0) * min(nb, n - k0) <= QR_PANEL_MAX_ELEMS
               for k0 in range(0, n, nb))


def check_wide_select_qr(gen) -> dict:
    """K4 at WIDE_SELECT_SHAPES (the main path's 5120-row round-1 chunks at
    nb = 256 and 512, reduction rounds, a chunk with 700 live rows of
    1024) with indices equal to the plain version's and (all rows live)
    lu_factor's, a ``lu_select_plan`` line each and, all rows live, a
    ``lu_select_split`` line (per 128-column block the load, the column
    chain, L11 and U, the update); K5 at WIDE_QR_SHAPES
    against its plain version (packed and T within 1e-4 + 1e-4 |plain|,
    ||QR - A|| checked; a ``qr_panel_split`` line each: block factors, T
    merges, strips).  Each launched twice and compared bit for bit,
    timed beside its bound and the library call (batched lu_factor_ex,
    torch.geqrf).  Returns {kernel name: [rows]}."""
    from slate_tpu_torch.internal.getrf import panel_lu
    from slate_tpu_torch.internal.lu_kernels import (lu_select,
                                                     lu_select_plain,
                                                     select_plan)
    from slate_tpu_torch.internal.qr_kernels import (panel_cluster, qr_panel,
                                                     qr_panel_plain)
    rows = {"lu_select": [], "qr_panel": []}
    for g, w, nb, nrows in WIDE_SELECT_SHAPES:
        x = torch.randn(g, w, nb, generator=gen, device="cuda")
        live = (None if nrows is None else
                torch.tensor(nrows, dtype=torch.int32, device="cuda"))
        got = lu_select(x, nrows=live)
        repeatable = bool(torch.equal(got, lu_select(x, nrows=live)))
        plain = lu_select_plain(x, live)
        library = None if nrows is not None else panel_lu(x)[1][:, :nb]
        equal = bool(torch.equal(got, plain)) and (
            library is None or bool(torch.equal(got, library)))
        if nrows is not None:
            equal = equal and all(int(got[i].max()) < nrows[i]
                                  for i in range(g))
        b_ms, b_by = bound(g * panel_flops(w, 0, nb, "getrf"),
                           g * (4 * w * nb + 4 + 8 * nb))
        shape = {"G": g, "W": w, "nb": nb, "bw": 8,
                 "nrows": list(nrows) if nrows else None}
        plan = select_plan(x.device, w, nb, 8)
        row = {"check": "lu_select", "shape": shape,
               "max_abs_err": float((got - plain).abs().max()),
               "indices_equal_plain_and_lu_factor": equal,
               "bitwise_repeatable": repeatable,
               "tol_reason": "pivot rows: equal indices, to the plain "
                             "version's and (all rows live) to lu_factor's",
               "kernel_ms": time_ms(lambda: lu_select(x, nrows=live), 10),
               "plain_ms": time_ms(lambda: lu_select_plain(x, live), 2),
               "library_ms": time_ms(lambda: torch.linalg.lu_factor_ex(x),
                                     5),
               "bound_ms": b_ms, "bound_by": b_by, "cluster": plan["cluster"]}
        if nrows is None:
            split = lu_select_split(x)
            row["split_us"] = {k: split[k] for k in (
                "load_us", "chain_us", "l11_u_us", "update_us")}
        emit(row)
        emit({"phase": "lu_select_plan", "shape": shape, **plan,
              "kernel_ms": row["kernel_ms"]})
        if not (equal and repeatable):
            raise AssertionError(f"lu_select {shape}: pivot rows differ from "
                                 f"the plain version's or lu_factor's, or "
                                 f"two launches differ")
        rows["lu_select"].append(row)
    for mm, w in WIDE_QR_SHAPES:
        x = torch.randn(mm, w, generator=gen, device="cuda")
        got = qr_panel(x)
        repeatable = all(torch.equal(a, b) for a, b in zip(got, qr_panel(x)))
        packed, t = (v.double() for v in got)
        v = torch.tril(packed, -1)
        v[torch.arange(w), torch.arange(w)] = 1
        r = torch.zeros_like(packed)
        r[:w] = torch.triu(packed[:w])
        qr_err = float((r - v @ (t @ (v.T @ r)) - x.double()).abs().max()
                       / x.abs().max())
        row = check(
            "qr_panel", {"mm": mm, "w": w, "bw": 8}, list(got),
            list(qr_panel_plain(x)),
            "128-column blocks of the same slab loop in both, each block's "
            "slabs applied in turn to the columns right of it; sums over "
            "mm rows in another order; Gaussian panel, |R| <= ~sqrt(mm), "
            "|V| <= 1, T ~ 1",
            time_ms(lambda: qr_panel(x), 10),
            time_ms(lambda: qr_panel_plain(x), 2),
            time_ms(lambda: torch.geqrf(x), 10),
            op_flops("geqrf", (mm, w)), 4 * (2 * mm * w + w * w))
        split = qr_panel_split(x)
        row.update(cluster=panel_cluster(x.device, mm, w, 8),
                   bitwise_repeatable=repeatable, qr_minus_a_rel=qr_err,
                   split_ms={k: split[k] for k in ("factor_ms", "merge_ms",
                                                   "strips_ms", "copy_ms")})
        emit({"phase": "cluster", "check": "qr_panel", "mm": mm, "w": w,
              "cluster": row["cluster"], "bitwise_repeatable": repeatable,
              "qr_minus_a_rel": qr_err, "kernel_ms": row["kernel_ms"]})
        if not (repeatable and qr_err < 1e-5 * mm ** 0.5):
            raise AssertionError(f"qr_panel [{mm}, {w}]: two launches differ "
                                 f"({repeatable}) or ||QR - A|| / max|A| = "
                                 f"{qr_err}")
        rows["qr_panel"].append(row)
    return rows


def check_wide_calu(st, a, b, x64, nb, kernels, reset, counts,
                    card) -> dict:
    """CALU gesv on the main CALU phase's matrix at nb = 256 and 512
    beside the nb = 128 route of the same run: K4 on every tournament
    round and K3 on every clean factor (expected_calu_launches with the
    wide gate), PERF.md's CALU bounds, cold and warm walls and the
    device's busy time of a warm run (torch.profiler)."""
    from slate_tpu_torch.internal.getrf import _lu_select_ok
    n = a.shape[0]
    calu = {st.Option.MethodLU: st.MethodLU.CALU}
    base_warm = min(run_gesv(st, a, b, nb, calu)[2] for _ in range(2))
    base_busy = device_busy(lambda: run_gesv(st, a, b, nb, calu))
    out = {}
    for wnb in WIDE_CALU_NBS:
        reset()
        _, x, cold = run_gesv(st, a, b, wnb, calu)
        launches = counts()
        warm = min(run_gesv(st, a, b, wnb, calu)[2] for _ in range(2))
        busy = device_busy(lambda: run_gesv(st, a, b, wnb, calu))
        res, fwd = accuracy(a, x, b, x64)
        want = {**{name: 0 for name in kernels},
                **expected_calu_launches(n, wnb, lambda h: _lu_select_ok(
                    torch.empty((1, h, wnb), device="cuda"), wnb))}
        emit({"phase": f"gesv_calu_nb{wnb}", "n": n, "nb": wnb,
              "nrhs": b.shape[1], "wall_s": cold, "wall_s_warm": warm,
              "device_busy_s": busy, "nb128_wall_s_warm": base_warm,
              "nb128_device_busy_s": base_busy,
              "scaled_residual": res, "residual_bound": GESV_RESIDUAL_BOUND,
              "forward_error_vs_f64": fwd,
              "forward_bound": GESV_FORWARD_BOUND, "launches": launches,
              "want": want, "card": card})
        if not (torch.isfinite(x).all() and launches == want
                and res < GESV_RESIDUAL_BOUND and fwd < GESV_FORWARD_BOUND):
            raise AssertionError(f"CALU gesv at nb = {wnb}: launches "
                                 f"{launches} (want {want}), residual {res}, "
                                 f"forward {fwd}")
        out[f"gesv_calu_nb{wnb}"] = launches
    return out


def check_wide_gels(st, gen, nb, nrhs, kernels, reset, counts,
                    card) -> dict:
    """QR gels (MethodGels.QR) at WIDE_GELS: K5 on every panel within the
    2^20-element cap (all of them at these shapes), PERF.md's gels QR
    bounds, the warm wall beside the nb = 128 route at the same shape.
    The line also says what config 4 (GELS_SHAPE and CFG4_SHAPE) launches
    at the wide widths: no K5, its panels past the cap in both packages."""
    qr = {st.Option.MethodGels: st.MethodGels.QR}
    out = {}
    for m, n, wnb in WIDE_GELS:
        a, b, x64 = lstsq_problem(m, n, nrhs, gen)
        base_warm = min(run_gels(st, a, b, nb, qr)[1] for _ in range(2))
        reset()
        x, cold = run_gels(st, a, b, wnb, qr)
        launches = counts()
        warm = min(run_gels(st, a, b, wnb, qr)[1] for _ in range(2))
        res, fwd = lstsq_accuracy(a, x, b, x64)
        want = {**{name: 0 for name in kernels},
                "qr_panel": gels_k5_panels(m, n, wnb)}
        config4 = {f"{mc}x{nc}_nb{w}": gels_k5_panels(mc, nc, w)
                   for mc, nc in (GELS_SHAPE, CFG4_SHAPE)
                   for w in WIDE_CALU_NBS}
        emit({"phase": f"gels_qr_nb{wnb}", "m": m, "n": n, "nb": wnb,
              "nrhs": nrhs, "wall_s": cold, "wall_s_warm": warm,
              "nb128_wall_s_warm": base_warm,
              "scaled_ne_residual": res, "residual_bound": GELS_RESIDUAL_BOUND,
              "forward_error_vs_f64": fwd, "forward_bound": GELS_FORWARD_BOUND,
              "launches": launches, "want": want,
              "config4_k5_panels": config4,
              "config4_note": "config 4 at nb = 256 and 512 reaches no K5 in "
                              "either package: every panel is past the "
                              "2^20-element cap, so householder_panel_blocked "
                              "takes it",
              "card": card})
        if not (torch.isfinite(x).all() and launches == want
                and want["qr_panel"] == -(-n // wnb)
                and not any(config4.values())
                and res < GELS_RESIDUAL_BOUND and fwd < GELS_FORWARD_BOUND):
            raise AssertionError(f"gels QR at {m} x {n}, nb = {wnb}: launches "
                                 f"{launches} (want {want}), residual {res}, "
                                 f"forward {fwd}, config 4 {config4}")
        out[f"gels_qr_nb{wnb}"] = launches
        del a, b, x64, x
    return out


# ---- slice 23: the serving kernels at the tuned plan's width -------------
# (--seed + 22)  K6 and K7 at nb = 256 and 512 on the serving check's
# shape (B = 8, M = 4096) with K = 2048 columns of history, K8 at the
# widest panels of the 4096 and 2048 buckets; then the 120-request stream
# under a 256- and a 512-wide batch plan, and the tuner's batch picks.
SERVE_WIDE_NBS = (256, 512)
SERVE_WIDE_K = 2048
SERVE_WIDE_QR = ((4096, 256), (2048, 512))     # K8's [8, mm, w]
SERVE_WIDE_PICKS_N = 1024


def serve_wide_tiles(nb: int) -> tuple[int, tuple]:
    """(k, tiles) of a K6/K7 check at width nb: k = K / nb and per problem
    its live tile count, in nb-row tiles: wholly live, live to half the
    panel, tile 0 alone, all but the last, wholly dead (k itself), a few
    tiles."""
    k, t = SERVE_WIDE_K // nb, SERVE_M // nb
    return k, (k + t, k + t, k + t // 2, k + 1, k + t - 1, k, k + t, k + 3)


def timed_once(fn):
    """(fn()'s result, its device ms by CUDA events): one call, for the
    plain versions, whose result is also the comparison's."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_serve_wide_kernels(gen) -> dict:
    """K6 and K7 at B = 8, M = 4096, K = 2048 and nb = 256, 512 (ragged
    tiles: serve_wide_tiles), K8 at SERVE_WIDE_QR with a rows = 0 slot,
    each in f32 and bf16 against its plain version (f32: ATOL + RTOL
    |plain|; bf16: ATOL + 2^-7 |plain|), dead tiles and the filler slot
    bit-equal to the input, two launches bit for bit, and one problem alone
    bit-equal to its slot in the batch; each timed (K6's and K7's own
    launches' device time, torch.profiler) beside its bound on live tiles
    and, in f32, its library composition (matmul + batched cholesky_ex +
    solve_triangular for K6, matmul + batched lu_factor_ex(pivot=False)
    for K7, batched torch.geqrf for K8).  Returns {kernel: [rows]}."""
    from slate_tpu_torch.internal import chol_kernels as ck
    from slate_tpu_torch.internal import lu_kernels as lk
    from slate_tpu_torch.internal import qr_kernels as qk
    rows = {"chol_panel_batched": [], "lu_panel_batched": [],
            "qr_panel_batched": []}
    for name, chol, kern, plain in (
            ("chol_panel_batched", True, ck.chol_panel_batched,
             ck.chol_panel_batched_plain),
            ("lu_panel_batched", False, lk.lu_panel_batched,
             lk.lu_panel_batched_plain)):
        tag = "k6" if chol else "k7"
        for nb in SERVE_WIDE_NBS:
            k, tiles_b = serve_wide_tiles(nb)
            tiles = torch.tensor(tiles_b, dtype=torch.int32, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                col, left, lead = serve_panel_inputs(gen, chol, k, dtype, nb)

                def run(col=col, left=left, lead=lead, tiles=tiles, k=k):
                    return kern(col, left, lead, tiles, k, 8)
                got = run()
                repeatable = all(torch.equal(bits(g), bits(h))
                                 for g, h in zip(got, run()))
                one = 2                             # live to half the panel
                alone = kern(col[one:one + 1], left[one:one + 1],
                             lead[one:one + 1], tiles[one:one + 1], k, 8)
                invariant = all(torch.equal(bits(g[one]), bits(h[0]))
                                for g, h in zip(got, alone))
                want, plain_ms = timed_once(
                    lambda: plain(col, left, lead, tiles, k, 8))
                live = ck.live_rows(tiles, k, SERVE_M, nb)
                dead_equal = all(torch.equal(bits(torch.where(live, col, g)),
                                             bits(col)) for g in got)
                f32 = dtype == torch.float32

                def library(col=col, left=left, lead=lead, nb=nb):
                    upd = col - left @ lead
                    if not chol:
                        return torch.linalg.lu_factor_ex(upd, pivot=False)[0]
                    l00 = torch.linalg.cholesky_ex(upd[:, :nb])[0]
                    return torch.linalg.solve_triangular(
                        l00.mT, upd[:, nb:], upper=True, left=False)
                kk, esz = k * nb, col.element_size()
                live_m = [max(0, min(SERVE_M, (t - k) * nb)) for t in tiles_b]
                flops = sum(panel_flops(mb, kk, nb,
                                        "potrf" if chol else "getrf")
                            for mb in live_m if mb)
                nbytes = esz * (3 * SERVE_B * SERVE_M * nb + sum(live_m) * kk
                                + sum(1 for mb in live_m if mb) * kk * nb)
                # K7's factor launch forms U^-1 in a second kernel, K0's
                # upper_tri_inv_wide_kernel
                times = step_launch_times(
                    name, tag, run, reps=3,
                    factor_tags=() if chol else ("upper_tri_inv_wide",))
                row = check(
                    name, {"B": SERVE_B, "M": SERVE_M, "nb": nb, "K": kk,
                           "bw": 8, "dtype": str(dtype)[6:],
                           "tiles": list(tiles_b)},
                    list(got), list(want),
                    "f32: K-long f32 sums with O(1) partial sums in another "
                    "order, the tile factored by 128-column blocks (the "
                    "plain version by bw-column slabs) with cond <= ~5; "
                    "bf16: the same f32 values, then each store rounds to "
                    "bf16, so one bf16 ulp (2^-7 relative) apart at most",
                    times[f"{tag}_own_ms"], plain_ms,
                    time_ms(library, 5) if f32 else None, flops, nbytes,
                    rtol=RTOL if f32 else BF16_RTOL)
                row.update(times, bitwise_repeatable=repeatable,
                           batch_invariant=invariant,
                           dead_tiles_bit_equal=dead_equal,
                           plan=(ck if chol else lk).batched_panel_plan(
                               col, left, lead))
                emit({"phase": "serve_wide_kernels", "check": name,
                      "nb": nb, "dtype": str(dtype)[6:],
                      "bitwise_repeatable": repeatable,
                      "batch_invariant": invariant,
                      "dead_tiles_bit_equal": dead_equal, **times,
                      "plan": row["plan"]})
                if not (repeatable and invariant and dead_equal):
                    raise AssertionError(
                        f"{name} nb={nb} {dtype}: repeatable {repeatable}, "
                        f"batch-invariant {invariant}, dead tiles "
                        f"{dead_equal}")
                rows[name].append(row)
    for mm, w in SERVE_WIDE_QR:
        rows_b = (mm, mm - 100, 0, mm, mm, mm - 7, mm, mm)
        rws = torch.tensor(rows_b, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(SERVE_B, mm, w, generator=gen,
                            device="cuda").to(dtype)
            got = qk.qr_panel_batched(a, rws)
            repeatable = all(torch.equal(bits(g), bits(h)) for g, h in
                             zip(got, qk.qr_panel_batched(a, rws)))
            alone = qk.qr_panel_batched(a[:1], rws[:1])
            invariant = all(torch.equal(bits(g[0]), bits(h[0]))
                            for g, h in zip(got, alone))
            filler_equal = (torch.equal(bits(got[0][2]), bits(a[2]))
                            and not bool(got[1][2].any()))
            want, plain_ms = timed_once(
                lambda: qk.qr_panel_batched_plain(a, rws))
            f32 = dtype == torch.float32
            live = sum(1 for r in rows_b if r)
            cluster, resident = qk.batched_panel_cluster(a.device, dtype, mm,
                                                         w, 8)
            row = check(
                "qr_panel_batched", {"B": SERVE_B, "mm": mm, "w": w, "bw": 8,
                                     "dtype": str(dtype)[6:],
                                     "rows": list(rows_b)},
                list(got), list(want),
                "128-column blocks of K5's slab loop in both, each block's "
                "slabs applied in turn to the columns right of it; sums "
                "over mm rows in another order; Gaussian panels, |R| <= "
                "~sqrt(mm), |V| <= 1; bf16: each store rounds, one bf16 ulp "
                "apart at most",
                time_ms(lambda: qk.qr_panel_batched(a, rws), 3), plain_ms,
                time_ms(lambda: torch.geqrf(a), 3) if f32 else None,
                live * op_flops("geqrf", (mm, w)),
                a.element_size() * SERVE_B * (2 * mm * w + w * w),
                rtol=RTOL if f32 else BF16_RTOL)
            row.update(cluster=cluster, waves=-(-SERVE_B // resident),
                       bitwise_repeatable=repeatable,
                       batch_invariant=invariant,
                       filler_slot_bit_equal=filler_equal)
            emit({"phase": "serve_wide_kernels", "check": "qr_panel_batched",
                  "mm": mm, "w": w, "dtype": str(dtype)[6:],
                  "cluster": cluster, "waves": row["waves"],
                  "bitwise_repeatable": repeatable,
                  "batch_invariant": invariant,
                  "filler_slot_bit_equal": filler_equal})
            if not (repeatable and invariant and filler_equal):
                raise AssertionError(
                    f"qr_panel_batched [{SERVE_B}, {mm}, {w}] {dtype}: "
                    f"repeatable {repeatable}, batch-invariant {invariant}, "
                    f"filler slot {filler_equal}")
            rows["qr_panel_batched"].append(row)
    return rows


BATCH_PLAN_OPS = ("batch_potrf", "batch_getrf", "batch_geqrf")


def serve_stream_at(st, reqs, nb, reset, counts):
    """The stream through a fresh Server with the three batch ops' plans at
    TilePlan("cuda", 8, nb) (the default plan at nb = 128): cold (the
    captures), then warm twice and once under torch.profiler.  Returns
    (launches of the cold run, its batch records, the cold results, cold
    wall, best warm wall, warm device busy seconds).  The allocator's
    cache goes back to the device first: a capture that runs out of
    memory beside blocks an earlier phase left cached drops them and
    captures again (internal/graphs.py), one more warm-up pass than
    expected_serve_launches counts."""
    torch.cuda.empty_cache()
    with contextlib.ExitStack() as stack:
        if nb != 128:
            for op in BATCH_PLAN_OPS:
                stack.enter_context(st.plan_override(
                    op, st.TilePlan("cuda", 8, nb)))
        reset()
        srv, res, cold = run_stream(st, reqs)
        launches = counts()
        records = list(srv.batch_records)

        def warm():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.serve_batch(reqs)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        best = min(warm() for _ in range(2))
        busy = device_busy(lambda: srv.serve_batch(reqs))
    return launches, records, res, cold, best, busy


def check_serve_wide_streams(st, reqs, kernels, reset, counts, card) -> dict:
    """stream_nb256, stream_nb512: the 120-request stream under the batch
    ops' plans at nb = 256 and 512 beside the default nb = 128 in the same
    run: K6, K7 and K8 launches as expected_serve_launches predicts at nb
    = min(plan.nb, bucket), every healthy result within the stream's
    residual bounds and the same problems unhealthy as at 128 (the zero
    column), the warm wall and device busy time.  Returns {phase:
    launches}."""
    bounds = {"solve": SERVE_RESIDUAL_BOUND,
              "chol_solve": SERVE_RESIDUAL_BOUND,
              "least_squares_solve": SERVE_LSQ_BOUND}
    _, _, res128, _, warm128, busy128 = serve_stream_at(st, reqs, 128, reset,
                                                        counts)
    bad128 = [i for i, r in enumerate(res128) if not r.health.ok]
    out, failures = {}, []
    for nb in SERVE_WIDE_NBS:
        launches, records, res, cold, warm, busy = serve_stream_at(
            st, reqs, nb, reset, counts)
        want = {**{name: 0 for name in kernels},
                **expected_serve_launches(records, plan_nb=nb)}
        acc = serve_accuracy(reqs, res)
        bad = [i for i, r in enumerate(res) if not r.health.ok]
        emit({"phase": f"stream_nb{nb}", "requests": len(reqs),
              "wall_s_cold": cold, "wall_s_warm": warm,
              "device_busy_s": busy, "nb128_wall_s_warm": warm128,
              "nb128_device_busy_s": busy128,
              "problems_per_s_warm": len(reqs) / warm,
              "launches": launches, "launches_predicted": want,
              "batch_nbs": sorted({min(nb, r["bucket"][1] if r["op"] ==
                                       "least_squares_solve"
                                       else r["bucket"][0])
                                   for r in records}),
              "worst_residual": acc, "residual_bounds": bounds,
              "unhealthy": bad, "nb128_unhealthy": bad128, "card": card})
        if launches != want:
            failures.append(f"stream_nb{nb}: launches {launches} != {want}")
        for op, bnd in bounds.items():
            if not acc.get(op, 0.0) < bnd:
                failures.append(f"stream_nb{nb} {op}: worst healthy "
                                f"residual {acc.get(op)} (bound {bnd})")
        if bad != bad128:
            failures.append(f"stream_nb{nb}: unhealthy {bad}, at 128 "
                            f"{bad128}")
        out[f"stream_nb{nb}"] = launches
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def check_tuned_batch_picks(card) -> None:
    """tuned_batch_picks: on the card the tuner's candidates for the three
    batch ops at bucket 1024 hold nb 128, 256 and 512 (the kernels' gates
    take them now); one sweep of them into a temporary cache, and the plan
    each op picks.  The smoke's own cache is restored after."""
    from slate_tpu_torch.tune import autotune
    shield = os.environ["SLATE_TORCH_TUNE_CACHE"]
    n = SERVE_WIDE_PICKS_N
    cands = {op: sorted({p.nb for p in autotune.candidates(op, n)
                         if p.kernel == "cuda"}) for op in BATCH_PLAN_OPS}
    seen = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke-picks-") as d:
        set_plan_cache(os.path.join(d, "picks.json"))
        try:
            won = autotune.tune_all(
                ns=(n,), ops=BATCH_PLAN_OPS, dtype="float32", iters=2,
                report=lambda op, m, plan, gf: seen.append(
                    {"op": op, "kernel": plan.kernel, "nb": plan.nb,
                     "bw": plan.bw, "gflops": gf}))
        finally:
            set_plan_cache(shield)
    picks = {op: {"kernel": plan.kernel, "nb": plan.nb, "bw": plan.bw,
                  "gflops": gf} for (op, _), (plan, gf) in won.items()}
    emit({"phase": "tuned_batch_picks", "n": n, "candidates_nb": cands,
          "swept": seen, "picks": picks,
          "seconds": time.perf_counter() - t0, "card": card})
    if any(cands[op] != [128, 256, 512] for op in BATCH_PLAN_OPS):
        raise AssertionError(f"tuned_batch_picks: the batch candidates at "
                             f"{n} are {cands}, not nb 128, 256 and 512")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=20480)
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--nrhs", type=int, default=128)
    ap.add_argument("--trace", action="store_true",
                    help="also break one warm posv, one warm CALU gesv, "
                         "one warm QR gels, one warm serving stream, and one "
                         "warm heev and svd down by phase and kernel")
    ap.add_argument("--gloo-child", nargs=2, metavar=("RANK", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.gloo_child:
        return gloo_child(int(args.gloo_child[0]), args.gloo_child[1])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # every phase before `tune` runs on the default plans, whatever plan
    # cache the machine holds: the port's cache points at an empty one
    plans_dir = tempfile.TemporaryDirectory(prefix="smoke-plans-")
    shield_path = os.path.join(plans_dir.name, "empty.json")
    with open(shield_path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "chips": {}}, fh)
    os.environ["SLATE_TORCH_TUNE_CACHE"] = shield_path
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
    # slice 23: K6-K8 at the tuned plan's widths, from --seed + 22
    wide_rows = check_serve_wide_kernels(
        torch.Generator(device="cuda").manual_seed(args.seed + 22))
    # K2's late panels and K0's pivoted U: a fifth generator
    check_k2_k0_edges(torch.Generator(device="cuda").manual_seed(
        args.seed + 4))
    # slice 21: K0-K3 at the wide widths, from --seed + 20
    wide_gen = torch.Generator(device="cuda").manual_seed(args.seed + 20)
    wide_rows.update(check_wide_kernels(wide_gen))
    # slice 22: K4 and K5 at the wide widths, from --seed + 21
    sel_gen = torch.Generator(device="cuda").manual_seed(args.seed + 21)
    wide_rows.update(check_wide_select_qr(sel_gen))

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
    # ---- slice 21: the same posv at nb = 256 and 512 ----
    wide_launches = check_wide_posv(st, a, b, x64, nb, kernels, reset,
                                    counts, card)
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
    # ---- slice 22: the same CALU gesv at nb = 256 and 512 ----
    wide_launches.update(check_wide_calu(st, a, b, x64, nb, kernels, reset,
                                         counts, card))
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
    # ---- slice 21: the NoPiv route at nb = 256, potrf_ooc at 256 ----
    wide_launches.update(check_wide_nopiv(st, a_n, b_n, kernels, reset,
                                          counts, card))
    del a_n, b_n, x_n
    torch.cuda.empty_cache()
    wide_launches.update(check_wide_ooc(st, wide_gen, nrhs, kernels, reset,
                                        counts, card))

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
    # ---- slice 22: QR gels at nb = 256 and 512 ----
    wide_launches.update(check_wide_gels(st, sel_gen, nb, nrhs, kernels,
                                         reset, counts, card))

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
    # ---- slice 23: the stream at the tuned widths, the tuner's picks ----
    wide_launches.update(check_serve_wide_streams(st, serve_reqs, kernels,
                                                  reset, counts, card))
    check_tuned_batch_picks(card)
    if args.trace:
        trace_serve(st, serve_reqs)
    # ---- the survival layer: graphs, the loop, the pool, the watchdog ----
    check_survival(st, serve_reqs, kernels, reset, counts)

    # ---- robustness: Abft, the fault sites and Speculate (--seed + 8) ----
    robust_launches = check_robustness(
        st, torch.Generator(device="cuda").manual_seed(args.seed + 8),
        torch.Generator(device="cuda").manual_seed(args.seed + 9),
        serve_reqs, nb, nrhs, n, reset, counts, args.trace)

    # ---- slice 12: mixed precision, band, Aasen, the API ----
    slice12_launches = check_slice12(st, args.seed, n, nb, nrhs, reset,
                                     counts)

    # ---- slice 13: the tuner, then driver telemetry (--seed + 14) ----
    slice13_launches = check_slice13(st, args.seed, n, nb, nrhs, serve_reqs,
                                     reset, counts, kernels, card,
                                     shield_path)
    del serve_reqs

    # ---- slice 14: the spectral drivers (--seed + 15) ----
    slice14_launches = check_slice14(st, args.seed, nb, reset, counts,
                                     args.trace)

    # ---- slice 15: durable jobs and compatibility (--seed + 16) ----
    slice15_launches = check_slice15(st, args.seed, nb, nrhs, reset, counts,
                                     kernels, card)

    # ---- slice 16: the distributed layer, one NCCL rank (--seed + 17) ----
    slice16_launches = check_slice16(st, args.seed, n, nb, nrhs, reset,
                                     counts)

    # ---- slice 17: distributed LU, CAQR, the mesh Aasen (--seed + 18) ----
    slice17_launches = check_slice17(st, args.seed, n, nb, nrhs, reset,
                                     counts, kernels, args.trace)

    # ---- slice 18: the distributed spectral reductions (--seed + 19) ----
    slice18_launches = check_slice18(st, args.seed, nb, reset, counts,
                                     args.trace)

    # ---- slice 19: the tester and the examples ----
    tester_total = check_slice19(st, kernels, reset, counts)
    plans_dir.cleanup()

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
                            **serve_launches, **robust_launches,
                            **slice12_launches, **slice13_launches,
                            **slice14_launches, **slice15_launches,
                            **slice16_launches, **slice17_launches,
                            **slice18_launches, **wide_launches,
                            "tester": tester_total}})
    replaces = {
        "upper_tri_inv": ("slate_tpu_torch/csrc/tri_inv.cu",
                          "slate_tpu/internal/pallas_tri.py:28",
                          "posv+posv_nb256+posv_nb512",
                          sum_launches("upper_tri_inv", main_launches,
                                       wide_launches["posv_nb256"],
                                       wide_launches["posv_nb512"])),
        "chol_tile": ("slate_tpu_torch/csrc/chol_tile.cu",
                      "slate_tpu/internal/pallas_chol.py:320",
                      "posv_tile_route+potrf_ooc+potrf_ooc_default_width"
                      "+dist_posv+dist_gels_cholqr+dist_hegv",
                      {"chol_tile": tile_launches["chol_tile"]
                       + slice15_launches["potrf_ooc"]["chol_tile"]
                       + wide_launches["potrf_ooc_default_width"][
                           "chol_tile"]
                       + slice16_launches["dist_posv"]["chol_tile"]
                       + slice17_launches["dist_gels_cholqr"]["chol_tile"]
                       + slice18_launches["dist_hegv"]["chol_tile"]}),
        "chol_panel_fused": ("slate_tpu_torch/csrc/chol_panel.cu",
                             "slate_tpu/internal/pallas_chol.py:180",
                             "posv+posv_nb256+posv_nb512",
                             sum_launches("chol_panel_fused", main_launches,
                                          wide_launches["posv_nb256"],
                                          wide_launches["posv_nb512"])),
        "lu_panel_fused": ("slate_tpu_torch/csrc/lu_panel.cu",
                           "slate_tpu/internal/pallas_lu.py:217",
                           "gesv_calu+gesv_calu_nb256+gesv_calu_nb512"
                           "+gesv_nopiv_nb256+dist_gesv"
                           "+dist_gesv_nopiv+dist_rbt",
                           sum_launches("lu_panel_fused", calu_launches,
                                        wide_launches["gesv_calu_nb256"],
                                        wide_launches["gesv_calu_nb512"],
                                        wide_launches["gesv_nopiv_nb256"],
                                        *(slice17_launches[k] for k in (
                                            "dist_gesv", "dist_gesv_nopiv",
                                            "dist_rbt")))),
        "lu_select": ("slate_tpu_torch/csrc/lu_select.cu",
                      "slate_tpu/internal/pallas_lu.py:346",
                      "gesv_calu+gesv_calu_nb256+gesv_calu_nb512+dist_gesv",
                      sum_launches("lu_select", calu_launches,
                                   wide_launches["gesv_calu_nb256"],
                                   wide_launches["gesv_calu_nb512"],
                                   slice17_launches["dist_gesv"])),
        "qr_panel": ("slate_tpu_torch/csrc/qr_panel.cu",
                     "slate_tpu/internal/pallas_qr.py:129",
                     "gels_qr+gels_qr_nb256+gels_qr_nb512+dist_gels",
                     sum_launches("qr_panel", qr_launches,
                                  wide_launches["gels_qr_nb256"],
                                  wide_launches["gels_qr_nb512"],
                                  slice17_launches["dist_gels"])),
    }
    streams = "serve_ragged+stream_nb256+stream_nb512"
    for name, source, ref in (
            ("chol_panel_batched", "chol_panel_batched.cu",
             "pallas_chol.py:286"),
            ("lu_panel_batched", "lu_panel_batched.cu", "pallas_lu.py:308"),
            ("qr_panel_batched", "qr_panel_batched.cu", "pallas_qr.py:154")):
        replaces[name] = (f"slate_tpu_torch/csrc/{source}",
                          f"slate_tpu/internal/{ref}", streams,
                          sum_launches(name, serve_launches["serve_ragged"],
                                       wide_launches["stream_nb256"],
                                       wide_launches["stream_nb512"]))
    line = []
    for name, (source, ref, path, launches) in replaces.items():
        r = rows[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": ref,
                     "launches": launches[name] + tester_total[name],
                     "path": path + "+tester",
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
                        if k in r},
                     **({"wide": [{k: w[k] for k in (
                         "shape", "max_abs_err", "kernel_ms", "plain_ms",
                         "bound_ms", "bound_by", "library_ms",
                         "bitwise_repeatable", "batch_invariant",
                         "bound_against", "bound_fp32_ms", "bound_tf32x3_ms",
                         "f64_err", "matmul_f32_f64_err", "split_us")
                         if k in w}
                         for w in wide_rows[name]]}
                        if name in wide_rows else {})})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
