// K7: the ragged batched fused no-pivot LU panel step, the port of
// lu_panel_batched (slate_tpu/internal/pallas_lu.py:282, pallas_call at
// :308, kernel _lu_panel_batched_kernel at :228). The step, its two launches
// and the ragged contract are in batched_panel.cuh; the tile factor is K3's
// slab loop (lu_factor_smem, lu_factor.cuh) and U^-1 = triu(tile)^-1 K0's
// back substitution (tri_inv.cuh), both inside launch (a). lead is the
// packed U block column A[:, :k0, k0:k0+nb]; fac is packed L\U with the unit
// lower diagonal implied.
//
// Bound on this card: per live problem, 2 M_live K nb flops of the update,
// 2 nb^3/3 of the tile's LU, nb^3/3 of U^-1 and 2 (M_live - nb) nb^2 of
// L21 = A21 U^-1, against the live tiles' bytes read and written once. With
// K >= nb it is bound by f32 operations (FFMA, never TF32): 67 TFLOP/s.
//
// Design: K3's, with a staged update in front (gemm_acc.cuh) and a batch
// axis: launch (a) puts one problem on each of B blocks, launch (b) one
// block per (32-row strip, problem).
#include "batched_panel.cuh"

extern "C" int slate_lu_panel_batched_fits(int device, int nb, int bw,
                                           int* fits) {
  return batched_panel::fits(device, nb, bw, fits);
}

// below = 0: launch (a), rows 0 .. nb-1 of each problem's upd and fac, and
// uinv [B, nb, nb] f32; below = 1: launch (b), rows nb .. M-1 (M > nb).
extern "C" int slate_lu_panel_batched(
    int device, void* stream, int bf16, int below, const void* col,
    long long cb, long long cs0, long long cs1, const void* left, long long lb,
    long long ls0, long long ls1, const void* lead, long long db,
    long long ds0, long long ds1, const int* tiles, int B, int k, int K, int M,
    int nb, int bw, void* upd, void* fac, float* uinv) {
  return batched_panel::launch(
      device, stream, bf16, below, col, cb, cs0, cs1, left, lb, ls0, ls1,
      lead, db, ds0, ds1, tiles, B, k, K, M, nb, bw, upd, fac, uinv);
}
