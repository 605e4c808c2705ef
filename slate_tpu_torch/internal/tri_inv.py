"""K0: inverse of an upper-triangular tile (port of
slate_tpu/internal/pallas_tri.py:28 ``upper_tri_inv``).

The kernel is the ``__device__`` routine ``upper_tri_inv_doubling`` of
``csrc/tri_inv.cuh``, launched by ``csrc/tri_inv.cu``.  On the Cholesky
paths the wrapper of K2 (internal/chol_kernels.py) calls
``upper_tri_inv`` between its launches; ``TRI_INV.launches`` counts the
launches made here and nowhere else.  The factor launches of K3, K6 and K7
run the same routine inside their own blocks.

Two plain versions: :func:`upper_tri_inv_plain` repeats K0's blocked
recursive doubling; :func:`back_substitution_plain` is the back
substitution of the reference's slab solve, which K3's plain tile
(``lu_kernels.lu_tile_plain``) runs on each slab.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import I32, I64, P, CudaKernel, check_cuda_f32, \
    device_and_stream, shape_query, workspace

TRI_INV = CudaKernel("upper_tri_inv", "tri_inv.cu", {
    "slate_upper_tri_inv": [I32, P, P, I64, I64, P, I32, P],
    "slate_upper_tri_inv_fits": [I32, I32, ctypes.POINTER(I32)],
    "slate_upper_tri_inv_work": [I32, I32, ctypes.POINTER(I32)],
    "slate_upper_tri_inv_trace": [I32, P, P, I64, I64, P, I32, P, P,
                                  ctypes.POINTER(I32)]})

DIAG = 8      # the diagonal blocks the doubling starts from (TRI_DIAG)
WIDE_N = 512  # the wide route's largest U (TI_MAX_N)
STAMPS = 8    # the wide route's stamps a CTA (TI_STAMPS)
WIDE_CLUSTER = 8   # its CTAs (TI_CLUSTER)


def back_substitution_plain(u: torch.Tensor) -> torch.Tensor:
    """U^-1 by back substitution, row by row from the bottom, X[i, :] =
    (e_i - U[i, i+1:] X[i+1:, :]) / U[i, i].  Entries below the diagonal
    are ignored.

    The reference's nilpotent series (U = D (I + N), (I + N)^-1 = (I - N)
    (I + N^2)(I + N^4)...) is accurate only while U is close to diagonal:
    on the U of a partially pivoted LU panel (cond ~ 100) it is off by
    ~1e-2 relative, where this is within ~1e-6."""
    n = u.shape[0]
    u = torch.triu(u)
    x = torch.zeros_like(u)
    for i in range(n - 1, -1, -1):
        row = -(u[i, i + 1:] @ x[i + 1:])
        row[i] += 1
        x[i] = row / u[i, i]
    return x


def upper_tri_inv_plain(u: torch.Tensor) -> torch.Tensor:
    """K0's arithmetic in torch ops: the 8 x 8 diagonal blocks inverted by
    back substitution, then neighbouring inverted blocks joined pairwise,
    b = 8, 16, 32, ...: X12 = -X11 (U12 X22) (LAPACK trtri's recursion).
    Entries below the diagonal are ignored.  As accurate as back
    substitution: within 1e-5 of the f64 inverse on a pivoted LU's U."""
    n = u.shape[0]
    u = torch.triu(u)
    x = torch.zeros_like(u)
    for d0 in range(0, n, DIAG):
        d1 = min(d0 + DIAG, n)
        x[d0:d1, d0:d1] = back_substitution_plain(u[d0:d1, d0:d1])
    b = DIAG
    while b < n:
        for i0 in range(0, n - b, 2 * b):
            j0, j1 = i0 + b, min(i0 + 2 * b, n)
            t = u[i0:j0, j0:j1] @ x[j0:j1, j0:j1]
            x[i0:j0, j0:j1] = -(x[i0:j0, i0:j0] @ t)
        b *= 2
    return x


def upper_tri_inv(u: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular [n, n] tile (nonzero diagonal;
    entries below the diagonal are ignored).  A CPU tensor takes the plain
    version; a CUDA tensor launches K0 (f32, n within the kernel's
    ``slate_upper_tri_inv_fits``: one block up to 128, one thread-block
    cluster of 1024-thread CTAs up to 512, a CTA a 128-column diagonal
    block, with the joins' scratch allocated here) or raises."""
    if u.device.type == "cpu":
        return upper_tri_inv_plain(u)
    check_cuda_f32("upper_tri_inv", u)
    n = u.shape[-1]
    if (u.dim() != 2 or u.shape[0] != n
            or not shape_query(TRI_INV, "slate_upper_tri_inv_fits",
                               u.device, n)):
        raise ValueError(f"upper_tri_inv: needs one square tile within the "
                         f"kernel's limits (slate_upper_tri_inv_fits), got "
                         f"{tuple(u.shape)}")
    x = torch.empty((n, n), dtype=u.dtype, device=u.device)
    work, work_ptr = workspace(TRI_INV, "slate_upper_tri_inv_work", u, n)
    TRI_INV.launch("slate_upper_tri_inv", *device_and_stream(u),
                   u.data_ptr(), u.stride(0), u.stride(1), x.data_ptr(), n,
                   work_ptr)
    return x


def upper_tri_inv_stamps(u: torch.Tensor):
    """K0's wide route once on a CUDA f32 U (128 < n <= 512) with each
    CTA's globaltimer stamps: (X, stamps, cluster).  stamps is [cluster,
    STAMPS] int64 nanoseconds (``tri_inv.cu``'s layout: the start, the
    copy-in, the diagonal inverse, each half-level of the joins, 0 where
    the launch has fewer, the store).  For chip_smoke.py's split of K0's
    time; the launch is not counted in ``TRI_INV.launches``, and X is the
    counted launch's, bit for bit."""
    check_cuda_f32("upper_tri_inv_stamps", u)
    n = u.shape[-1]
    if u.dim() != 2 or u.shape[0] != n or not 128 < n <= WIDE_N:
        raise ValueError(f"upper_tri_inv_stamps: needs one square U past "
                         f"128, got {tuple(u.shape)}")
    x = torch.empty((n, n), dtype=u.dtype, device=u.device)
    work, work_ptr = workspace(TRI_INV, "slate_upper_tri_inv_work", u, n)
    stamps = torch.zeros((WIDE_CLUSTER, STAMPS), dtype=torch.int64,
                         device=u.device)
    cluster = ctypes.c_int32(0)
    TRI_INV.call("slate_upper_tri_inv_trace", *device_and_stream(u),
                 u.data_ptr(), u.stride(0), u.stride(1), x.data_ptr(), n,
                 work_ptr, stamps.data_ptr(), ctypes.byref(cluster))
    return x, stamps[:cluster.value], cluster.value
