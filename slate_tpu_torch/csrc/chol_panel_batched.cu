// K6: the ragged batched fused Cholesky panel step, the port of
// chol_panel_batched (slate_tpu/internal/pallas_chol.py:257, pallas_call at
// :286, kernel _chol_panel_batched_kernel at :197). The step, its two
// launches and the ragged contract are in batched_panel.cuh; the tile factor
// is K1's column loop (chol_factor.cuh) and U^-1 = (L00^T)^-1 K0's back
// substitution (tri_inv.cuh), both inside launch (a).
//
// Bound on this card: per live problem, 2 M_live K nb flops of the update,
// nb^3/3 of the factor, nb^3/3 of U^-1 and 2 (M_live - nb) nb^2 of the
// solve, against the bytes of the live tiles of col, left and lead read
// once and of upd and fac written once (dead tiles: a copy). With K >= nb
// it is bound by f32 operations, FFMA on the CUDA cores (the reference asks
// for Precision.HIGHEST, so never TF32): at most 67 TFLOP/s.
//
// Design: K2's, with a batch axis. Launch (a) puts one problem on each of B
// blocks (B SMs of 132 busy while the update of row tile 0 runs), launch (b)
// one block per (strip, problem). bf16 storage halves the bytes but not the
// FFMA count. wgmma for the products, and splitting launch (a)'s update
// over blocks, are what a faster version does.
#include "batched_panel.cuh"

extern "C" int slate_chol_panel_batched_fits(int device, int nb, int bw,
                                             int* fits) {
  return batched_panel::fits(batched_panel::CHOL, device, nb, bw, fits);
}

// below = 0: launch (a), rows 0 .. nb-1 of each problem's upd and fac, and
// uinv [B, nb, nb] f32; below = 1: launch (b), rows nb .. M-1 (M > nb).
extern "C" int slate_chol_panel_batched(
    int device, void* stream, int bf16, int below, const void* col,
    long long cb, long long cs0, long long cs1, const void* left, long long lb,
    long long ls0, long long ls1, const void* lead, long long db,
    long long ds0, long long ds1, const int* tiles, int B, int k, int K, int M,
    int nb, int bw, void* upd, void* fac, float* uinv) {
  return batched_panel::launch<batched_panel::CHOL>(
      device, stream, bf16, below, col, cb, cs0, cs1, left, lb, ls0, ls1,
      lead, db, ds0, ds1, tiles, B, k, K, M, nb, bw, upd, fac, uinv);
}
