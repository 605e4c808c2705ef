"""K5 and K8: the Householder QR panel with its compact-WY T, and its ragged
batched form (port of slate_tpu/internal/pallas_qr.py ``qr_panel_pallas``
and ``qr_panel_batched``).

``qr_panel_plain`` repeats the kernel's arithmetic in torch ops, with the
kernel's slab blocking: the CPU tests run it, and on the card it is only
the comparison.  ``qr_panel`` takes it for CPU tensors only; for CUDA
tensors it launches the kernel (``csrc/qr_panel.cu``, whose per-panel
routine is ``csrc/qr_panel.cuh``: one thread-block cluster a panel, its
rows split over the cluster's CTAs; past 128 columns the same cluster
factors the panel by 128-column blocks) or raises.  ``qr_panel_batched`` does
the same with ``qr_panel_batched_plain`` and ``csrc/qr_panel_batched.cu``,
which runs the same per-panel routine, one cluster a problem.  The kernels
choose their cluster size themselves; :func:`panel_cluster` and
:func:`batched_panel_cluster` report it.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import (I32, I64, P, CudaKernel, check_cuda_f32,
                      check_cuda_storage, device_and_stream, fits, query,
                      shape_query, workspace)

QR_PANEL = CudaKernel("qr_panel", "qr_panel.cu", {
    "slate_qr_panel": [I32, P, P, I64, I64, I32, I32, I32, P, P, P],
    "slate_qr_panel_fits": [I32, I32, I32, I32, ctypes.POINTER(I32)],
    "slate_qr_panel_work": [I32, I32, I32, ctypes.POINTER(I32)],
    "slate_qr_panel_cluster": [I32, I32, I32, I32, ctypes.POINTER(I32)]})

# Past QR_BLOCK columns a panel is factored by blocks of that many, in the
# wide kernel and in the plain version.
QR_BLOCK = 128

QR_PANEL_BATCHED = CudaKernel("qr_panel_batched", "qr_panel_batched.cu", {
    "slate_qr_panel_batched": [I32, P, I32, P, I64, I64, I64, P, I32, I32,
                               I32, I32, P, P, P],
    "slate_qr_panel_batched_fits": [I32, I32, I32, I32,
                                    ctypes.POINTER(I32)],
    "slate_qr_panel_batched_work": [I32, I32, I32, I32, I32,
                                    ctypes.POINTER(I32)],
    "slate_qr_panel_batched_cluster": [I32, I32, I32, I32, I32,
                                       ctypes.POINTER(I32),
                                       ctypes.POINTER(I32)]})


def panel_fits(device: torch.device, mm: int, w: int, bw: int) -> bool:
    """True when K5 takes a [mm, w] panel at slab width bw on this CUDA
    device: the kernel's own limits (``slate_qr_panel_fits``: w <= 128, or
    w in {256, 384, 512} by 128-column blocks; mm >= w, bw <= 8) and its
    count of its shared memory against the device's per-block limit."""
    return bool(shape_query(QR_PANEL, "slate_qr_panel_fits", device, mm, w,
                            bw))


def panel_cluster(device: torch.device, mm: int, w: int, bw: int) -> int:
    """The cluster size (CTAs a panel) K5's launcher takes for a [mm, w]
    panel on this CUDA device: chosen from mm, and smaller only where the
    card holds no cluster of that size (``slate_qr_panel_cluster``)."""
    return query(QR_PANEL, "slate_qr_panel_cluster", device, mm, w, bw)


def _merge_apply(p: torch.Tensor, T: torch.Tensor, j0: int, j1: int,
                 right: int | None = None, merge: bool = True):
    """Fold the factored columns [j0, j1) of ``p`` into the rest, in place:
    Z = Vs^T P[j0:, :] with Vs the columns' unit lower V, the merge of
    their T block into the panel's, T12 = -T1 (V1^T Vs) Ts (unless not
    ``merge``), and the compact-WY update of the columns from ``right``
    (default j1) on, A_right -= Vs (Ts^T Z); right = w: no update."""
    w = p.shape[1]
    right = j1 if right is None else right
    r = torch.arange(j0, p.shape[0], device=p.device)[:, None]
    d = torch.arange(j0, j1, device=p.device)[None, :]
    vs = torch.where(r > d, p[j0:, j0:j1], (r == d).to(p.dtype))
    z = vs.T @ p[j0:]                             # Vs^T P[j0:, :]
    ts = T[j0:j1, j0:j1]
    if j0 and merge:
        T[:j0, j0:j1] = -(T[:j0, :j0] @ (z[:, :j0].T @ ts))
    if right < w:
        p[j0:, right:] -= vs @ (ts.T @ z[:, right:])


def qr_panel_plain(a: torch.Tensor, bw: int = 8):
    """K5's steps in torch ops on a real panel [mm, w], mm >= w: per slab
    of bw columns, column by column the larfg scalars of qr.py ``_larfg``
    from one product over the slab's rows below the diagonal (s_t =
    x^T P[:, t]; s_j = x^T x), w_t = P[j, t] + scale s_t (the reflector's
    row for t > j, T's recursion V_t^T v_j for t < j), the column and the
    slab's later columns written (a column with mu = 0 is left as it is);
    then the slab folded into the rest (:func:`_merge_apply`).  Past w =
    128, as the wide kernel, by 128-column blocks: each block factored so
    (rows from its diagonal down), its T merged into the panel's, and its
    slabs applied in turn to the columns right of it (the same update of
    those columns as one slab loop over the whole panel).  Returns (packed,
    T)."""
    mm, w = a.shape
    if mm < w or bw < 1 or a.is_complex():
        raise ValueError(f"qr_panel_plain: needs a real [mm, w] panel with "
                         f"mm >= w and bw >= 1, got {tuple(a.shape)}, "
                         f"{a.dtype}, bw={bw}")
    p = a.clone(memory_format=torch.contiguous_format)
    T = torch.zeros((w, w), dtype=a.dtype, device=a.device)
    if w > QR_BLOCK:
        for c0 in range(0, w, QR_BLOCK):
            c1 = min(c0 + QR_BLOCK, w)
            p[c0:, c0:c1], T[c0:c1, c0:c1] = qr_panel_plain(p[c0:, c0:c1],
                                                            bw)
            _merge_apply(p, T, c0, c1, right=w)
            if c1 < w:
                for s0 in range(c0, c1, bw):
                    _merge_apply(p, T, s0, min(s0 + bw, c1), right=c1,
                                 merge=False)
        return p, T
    for j0 in range(0, w, bw):
        j1 = min(j0 + bw, w)
        for j in range(j0, j1):
            jl = j - j0
            x = p[j + 1:, j]
            s = x @ p[j + 1:, j0:j1]
            alpha = p[j, j]
            mu = torch.sqrt(alpha * alpha + s[jl])
            live = mu > 0
            beta = torch.where(alpha >= 0, -mu, mu)
            sb = torch.where(live, beta, 1.0)
            tau = torch.where(live, (sb - alpha) / sb, 0.0)
            scale = torch.where(live, 1 / (alpha - sb), 0.0)
            g = p[j, j0:j1] + scale * s
            T[j, j] = tau
            if jl:
                T[j0:j, j] = -tau * (T[j0:j, j0:j] @ g[:jl])
            v = torch.cat([torch.ones_like(alpha)[None], x * scale])
            upd = p[j:, j + 1:j1] - tau * v[:, None] * g[None, jl + 1:]
            p[j:, j + 1:j1] = torch.where(live, upd, p[j:, j + 1:j1])
            col = torch.cat([beta[None], x * scale])
            p[j:, j] = torch.where(live, col, p[j:, j])
        if j0 == 0 and j1 == w:
            break
        _merge_apply(p, T, j0, j1)
    return p, T


def qr_panel(a: torch.Tensor, bw: int = 8):
    """Householder QR of a panel [mm, w], mm >= w: (packed, T) with
    ``householder_panel``'s packing and ``build_t``'s T (qr.py), Q = I -
    V T V^T.  Any strides.  A CPU tensor takes the plain version; a CUDA
    tensor launches K5 once (f32, within :func:`panel_fits`; past w = 128
    with a workspace allocated here) or raises."""
    mm, w = a.shape
    if mm < w or w < 1 or bw < 1:
        raise ValueError(f"qr_panel: needs mm >= w >= 1 and bw >= 1, got "
                         f"{tuple(a.shape)} and bw={bw}")
    if a.device.type == "cpu":
        return qr_panel_plain(a, bw)
    check_cuda_f32("qr_panel", a)
    packed = torch.empty((mm, w), dtype=a.dtype, device=a.device)
    T = torch.empty((w, w), dtype=a.dtype, device=a.device)
    work, work_ptr = workspace(QR_PANEL, "slate_qr_panel_work", a, mm, w)
    QR_PANEL.launch("slate_qr_panel", *device_and_stream(a), a.data_ptr(),
                    a.stride(0), a.stride(1), mm, w, bw, packed.data_ptr(),
                    T.data_ptr(), work_ptr)
    return packed, T


def batched_panel_fits(device: torch.device, mm: int, w: int,
                       bw: int) -> bool:
    """True when K8 takes [*, mm, w] panels at slab width bw on this CUDA
    device, as the kernel itself counts (``slate_qr_panel_batched_fits``:
    K5's limits, w <= 128 or w in {256, 384, 512}, mm >= w and bw <= 8,
    and its shared memory)."""
    return fits(QR_PANEL_BATCHED, "slate_qr_panel_batched_fits", device, mm,
                w, bw)


def batched_width_ok(mm: int, w: int, bw: int) -> bool:
    """The panels K8 takes, as the CPU route mirrors the kernel's gate
    (:func:`batched_panel_fits`): w up to 128, or 256, 384 or 512 by
    128-column blocks; mm >= w; 1 <= bw <= 8 (the slab's sums are
    registers).  The serving route asks it of CPU tensors, so that a
    bucket takes the same route on both devices."""
    return (mm >= w and 1 <= bw <= 8
            and (1 <= w <= QR_BLOCK or w in (256, 384, 512)))


def batched_panel_cluster(device: torch.device, dtype: torch.dtype,
                          mm: int, w: int, bw: int) -> tuple[int, int]:
    """The cluster size (CTAs a problem) K8's launcher takes for panels
    [mm, w] in ``dtype`` storage on this CUDA device, whatever the batch,
    and how many such clusters the card holds at once; a larger batch runs
    in waves (``slate_qr_panel_batched_cluster``)."""
    return query(QR_PANEL_BATCHED, "slate_qr_panel_batched_cluster",
                 device, int(dtype == torch.bfloat16), mm, w, bw, outs=2)


def qr_panel_batched_plain(a: torch.Tensor, rows: torch.Tensor,
                           bw: int = 8):
    """K8's arithmetic in torch ops: per problem, :func:`qr_panel_plain` on
    the panel widened to f32, rounded to the storage dtype; a problem with
    rows[b] == 0 keeps ``a``'s bits and gets T = 0."""
    outs = [qr_panel_plain(p.float(), bw) for p in a]
    packed = torch.stack([p for p, _ in outs]).to(a.dtype)
    t = torch.stack([t for _, t in outs]).to(a.dtype)
    live = (rows > 0)[:, None, None]
    return torch.where(live, packed, a), torch.where(live, t, 0)


def qr_panel_batched(a: torch.Tensor, rows: torch.Tensor, bw: int = 8):
    """Ragged batched Householder panel: (packed [B, mm, w], T [B, w, w])
    of ``a`` [B, mm, w], mm >= w, in a's storage dtype (f32 or bf16; the
    column loop runs in f32), with :func:`qr_panel`'s packing and T per
    problem.  Raggedness is by whole problem: rows[b] == 0 (a filler slot)
    passes ``a`` through bit for bit with T = 0; every live problem factors
    its whole panel.  Any strides.  A CPU tensor takes the plain version;
    CUDA tensors launch K8 once (within :func:`batched_panel_fits`: past w
    = 128 each problem's cluster runs K5's wide routine by 128-column
    blocks) or raise; ``rows`` is read on the device only.  The f32 scratch
    is allocated here, as the kernel sizes it
    (``slate_qr_panel_batched_work``): on bf16 storage the working panels,
    4 B mm w bytes, and past w = 128 the wide routine's workspace (and on
    bf16 its f32 T)."""
    bsz, mm, w = a.shape
    if mm < w or w < 1 or bw < 1 or rows.shape != (bsz,):
        raise ValueError(f"qr_panel_batched: needs mm >= w >= 1, bw >= 1 "
                         f"and rows [B], got {tuple(a.shape)}, rows "
                         f"{tuple(rows.shape)} and bw={bw}")
    if a.device.type == "cpu":
        return qr_panel_batched_plain(a, rows, bw)
    check_cuda_storage("qr_panel_batched", a)
    if rows.device != a.device or rows.dtype != torch.int32:
        raise ValueError(f"qr_panel_batched: rows must be int32 on "
                         f"{a.device}")
    rows = rows.contiguous()
    packed = torch.empty((bsz, mm, w), dtype=a.dtype, device=a.device)
    t = torch.empty((bsz, w, w), dtype=a.dtype, device=a.device)
    bf16 = int(a.dtype == torch.bfloat16)
    work, work_ptr = workspace(QR_PANEL_BATCHED,
                               "slate_qr_panel_batched_work", a, bf16, bsz,
                               mm, w)
    QR_PANEL_BATCHED.launch("slate_qr_panel_batched", *device_and_stream(a),
                            bf16, a.data_ptr(), *a.stride(), rows.data_ptr(),
                            bsz, mm, w, bw,
                            packed.data_ptr() if work is None else work_ptr,
                            packed.data_ptr(), t.data_ptr())
    return packed, t
