"""K0: inverse of an upper-triangular tile (port of
slate_tpu/internal/pallas_tri.py:28 ``upper_tri_inv``).

The kernel is the ``__device__`` routine of ``csrc/tri_inv.cuh``, launched
by ``csrc/tri_inv.cu``.  On the solve paths the wrappers of K2
(internal/chol_kernels.py) and K3 (internal/lu_kernels.py) call
``upper_tri_inv`` between their diagonal and below-diagonal launches;
``TRI_INV.launches`` counts the launches made here and nowhere else.
"""

from __future__ import annotations

import torch

from .kernels import I32, I64, P, CudaKernel, check_cuda_f32, \
    device_and_stream

TRI_INV = CudaKernel("upper_tri_inv", "tri_inv.cu",
                     {"slate_upper_tri_inv": [I32, P, P, I64, I64, P, I32]})

MAX_N = 128   # two n x (n+1) f32 tiles in one block's shared memory


def upper_tri_inv_plain(u: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: back substitution, row by row
    from the bottom, X[i, :] = (e_i - U[i, i+1:] X[i+1:, :]) / U[i, i].
    Entries below the diagonal are ignored.

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


def upper_tri_inv(u: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular [n, n] tile (nonzero diagonal;
    entries below the diagonal are ignored).  A CPU tensor takes the plain
    version; a CUDA tensor launches K0 (f32, n <= 128) or raises."""
    if u.device.type == "cpu":
        return upper_tri_inv_plain(u)
    check_cuda_f32("upper_tri_inv", u)
    n = u.shape[-1]
    if u.dim() != 2 or u.shape[0] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"upper_tri_inv: needs one square tile with "
                         f"n <= {MAX_N}, got {tuple(u.shape)}")
    x = torch.empty((n, n), dtype=u.dtype, device=u.device)
    TRI_INV.launch("slate_upper_tri_inv", *device_and_stream(u),
                   u.data_ptr(), u.stride(0), u.stride(1), x.data_ptr(), n)
    return x
