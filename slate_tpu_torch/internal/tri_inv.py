"""K0: inverse of an upper-triangular tile (port of
slate_tpu/internal/pallas_tri.py:28 ``upper_tri_inv``).

The kernel is the ``__device__`` routine of ``csrc/tri_inv.cuh``, launched
by ``csrc/tri_inv.cu``.  On the solve path K2's wrapper
(internal/chol_kernels.py) calls ``upper_tri_inv`` between its diagonal
and its below-diagonal launch; ``TRI_INV.launches`` counts the launches
made here and nowhere else.
"""

from __future__ import annotations

import torch

from .kernels import I32, I64, P, CudaKernel, check_cuda_f32, \
    device_and_stream

TRI_INV = CudaKernel("upper_tri_inv", "tri_inv.cu",
                     {"slate_upper_tri_inv": [I32, P, P, I64, I64, P, I32]})

MAX_N = 128   # two n x (n+1) f32 tiles in one block's shared memory


def upper_tri_inv_plain(u: torch.Tensor) -> torch.Tensor:
    """The reference's arithmetic in torch ops: U = D (I + N) with N
    strictly upper (nilpotent), (I + N)^-1 = (I - N)(I + N^2)(I + N^4)...,
    U^-1 = (I + N)^-1 D^-1.  Entries below the diagonal are ignored."""
    n = u.shape[0]
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    u = torch.triu(u)
    d = torch.diagonal(u)
    N = u * (1.0 / d)[:, None] - eye
    inv = eye - N
    N2 = N @ N
    steps = 1
    while 2 * steps < n:
        inv = inv @ (eye + N2)
        N2 = N2 @ N2
        steps *= 2
    return inv * (1.0 / d)[None, :]


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
