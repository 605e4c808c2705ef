"""Build and bind the hand-written CUDA kernels of ``slate_tpu_torch/csrc``.

Each ``csrc/*.cu`` file is compiled on first use by ``nvcc`` for sm_90a
into a shared library with a plain C interface and loaded with
``ctypes``; nothing includes PyTorch's headers, so a build takes seconds.
Libraries go to ``slate_tpu_torch/_build/`` under a name that hashes the
sources and flags, so an edited source is never served a stale build.
``build_all`` starts one ``nvcc`` per source at once.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after its launch; the
wrapper raises on a nonzero code, so a launch can be captured into a CUDA
graph (internal/graphs.py).  Each :class:`CudaKernel` counts the launches
that ran in two plain integers: ``launches``, added to by the wrapper
where it launches its kernel, and ``replayed``, added to by the graph
replays that run it.  A launch made while a graph is being captured only
enqueues the kernel into the graph: it goes to the capture's tally
(:func:`capture_tally`), and each replay of the graph adds that tally to
``replayed``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int

_TLS = threading.local()          # the capture tally of this thread, if any
_REPLAY_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    the first ``nvcc`` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("slate_tpu_torch: nvcc not found; the CUDA "
                           "kernels are built on the machine with the GPU")
    return found


class CudaKernel:
    """One kernel source, its lazily built library, and its launch count.

    ``functions`` maps each exported C symbol to its ctypes argument
    types; every symbol returns a CUDA error code (0 = launched)."""

    def __init__(self, name: str, source: str,
                 functions: dict[str, list]):
        self.name = name
        self.source = CSRC_DIR / source
        self.functions = functions
        self.launches = 0
        self.replayed = 0
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [self.source, *sorted(CSRC_DIR.glob("*.cuh"))]:
            h.update(path.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start nvcc for this source unless its library exists; returns
        the process (its log goes next to the library) or None."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w", encoding="utf-8")
        try:
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o",
                 str(tmp), str(self.source)],
                stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()
        proc.tmp_path, proc.out_path = tmp, out
        return proc

    @staticmethod
    def finish_build(proc: subprocess.Popen) -> None:
        """Wait for a build started by :meth:`start_build`; raise with the
        compiler's log when it failed."""
        rc = proc.wait()
        if rc != 0:
            log = proc.out_path.with_suffix(".log").read_text()
            raise RuntimeError(f"nvcc failed ({rc}) for {proc.out_path.name}:"
                               f"\n{log}")
        os.replace(proc.tmp_path, proc.out_path)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                # slate-lint: disable=CON003 -- one build per kernel by design: a thread waiting on this lock needs this library before it can launch anyway; build_all starts every source's nvcc at once, outside any lock
                proc = self.start_build()
                if proc is not None:
                    # slate-lint: disable=CON003 -- the wait for the build started above, under the same per-kernel lock for the same reason
                    self.finish_build(proc)
                lib = ctypes.CDLL(str(self.library_path()))
                for sym, argtypes in self.functions.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.slate_cuda_error_string.argtypes = [ctypes.c_int]
                lib.slate_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def call(self, symbol: str, *args) -> None:
        """Call one C entry point; raise if it returns a CUDA error."""
        lib = self.lib()
        rc = getattr(lib, symbol)(*args)
        if rc != 0:
            msg = lib.slate_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: {symbol} failed: CUDA error "
                               f"{rc} ({msg})")

    def launch(self, symbol: str, *args) -> None:
        """Call one C entry point that launches the kernel and count the
        launch; raise if CUDA refused it (the kernel then never ran).
        Inside :func:`capture_tally` the launch was only captured, and is
        counted in the tally instead."""
        self.call(symbol, *args)
        tally = getattr(_TLS, "tally", None)
        if tally is None:
            self.launches += 1
        else:
            tally[self] = tally.get(self, 0) + 1


@contextlib.contextmanager
def capture_tally():
    """Scope of a graph capture on this thread: yields a dict, kernel ->
    launches captured, that the kernels' launches in the scope fill in
    place of their ``launches`` counts."""
    prev = getattr(_TLS, "tally", None)
    _TLS.tally = tally = {}
    try:
        yield tally
    finally:
        _TLS.tally = prev


def add_replay(tally: dict) -> None:
    """One replay of a graph whose capture tallied ``tally``: each kernel
    in it ran that many more times."""
    with _REPLAY_LOCK:
        for kernel, n in tally.items():
            kernel.replayed += n


def build_all(kernels) -> None:
    """Build every kernel's library at once: one nvcc process per source,
    all started before any is waited for."""
    procs = [p for p in (k.start_build() for k in kernels) if p is not None]
    errors = []
    for proc in procs:
        try:
            CudaKernel.finish_build(proc)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    """``t``'s device index and the raw handle of PyTorch's current
    stream there: the first two arguments of every C entry point."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_f32(name: str, *tensors) -> None:
    """Raise unless every tensor is float32 on one CUDA device."""
    check_cuda_storage(name, *tensors, dtypes=(torch.float32,))


def check_cuda_storage(name: str, *tensors,
                       dtypes=(torch.float32, torch.bfloat16)) -> None:
    """Raise unless every tensor lies on one CUDA device in one storage
    dtype out of ``dtypes`` (the batched kernels take f32 or bf16)."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA "
                             f"device (got {t.device} and {dev})")
        if t.dtype not in dtypes or t.dtype != dt:
            names = " or ".join(str(d).removeprefix("torch.")
                                for d in dtypes)
            raise ValueError(f"{name}: the kernel takes {names} storage, "
                             f"one dtype for all operands (got {t.dtype})")


def query(kernel: CudaKernel, symbol: str, device: torch.device,
          *args: int, outs: int = 1):
    """Ask a kernel's library for integers about ``args`` on this device:
    its C entry point takes the device index, the arguments and ``outs``
    int* it fills in.  Returns the one integer, or a tuple of ``outs``."""
    vals = [ctypes.c_int(0) for _ in range(outs)]
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    kernel.call(symbol, index, *args, *(ctypes.byref(v) for v in vals))
    return vals[0].value if outs == 1 else tuple(v.value for v in vals)


def fits(kernel: CudaKernel, symbol: str, device: torch.device,
         *shape: int) -> bool:
    """Ask a kernel's library whether it takes ``shape`` on this device
    (its ``slate_*_fits`` entry point counts its own shared memory)."""
    return bool(query(kernel, symbol, device, *shape))


_ANSWERS: dict = {}


def shape_query(kernel: CudaKernel, symbol: str, device: torch.device,
                *shape: int) -> int:
    """:func:`query` for an answer that depends on ``shape`` and the device
    alone (a ``slate_*_fits`` gate, a ``slate_*_work`` scratch size),
    asked once per (kernel, symbol, device, shape): the wrappers on the
    panel loops ask it on every call."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (kernel.name, symbol, index, shape)
    if key not in _ANSWERS:
        _ANSWERS[key] = query(kernel, symbol, torch.device("cuda", index),
                              *shape)
    return _ANSWERS[key]


def workspace(kernel: CudaKernel, symbol: str, t: torch.Tensor, *shape: int):
    """The f32 scratch that a kernel's wide route takes for ``shape`` on
    ``t``'s device, sized by its library (``symbol``, a ``slate_*_work``
    entry point), as a raw pointer argument: the tensor's address, or None
    where the kernel takes none.  Returns (tensor or None, pointer); the
    caller holds the tensor until the launch is enqueued."""
    floats = shape_query(kernel, symbol, t.device, *shape)
    if not floats:
        return None, None
    buf = torch.empty(floats, dtype=torch.float32, device=t.device)
    return buf, buf.data_ptr()


# The ragged batched panel step of K6 and K7 (csrc/batched_step.cuh): the C
# signature of a launch (device, stream, which, bf16, then col, left and
# lead with their batch, row and column strides, tiles, B, k, K, M, nb, bw,
# upd, fac, work, uinv, wide), of the wide factor's scratch a problem
# (device, nb, floats out) and of the update launch's plan (device, bf16, K,
# nb, left and lead with their strides, then split, resident and staging
# out); each step is the launches UPDATE, FACTOR and, when M > nb, SOLVE.
BATCHED_PANEL_ARGS = [I32, P, I32, I32, P, I64, I64, I64, P, I64, I64, I64,
                      P, I64, I64, I64, P, I32, I32, I32, I32, I32, I32, P, P,
                      P, P, P]
BATCHED_WORK_ARGS = [I32, I32, ctypes.POINTER(I32)]
BATCHED_PLAN_ARGS = [I32, I32, I32, I32, P, I64, I64, I64, P, I64, I64, I64,
                     ctypes.POINTER(I32), ctypes.POINTER(I32),
                     ctypes.POINTER(I32)]
UPDATE, FACTOR, SOLVE = 0, 1, 2
STAGING = ("loads", "cp.async", "cp.async4")   # panel_gemm.cuh's modes


def check_batched_panel(kernel: CudaKernel, col, left, lead, tiles,
                        bw: int) -> None:
    """Raise unless K6's or K7's CUDA operands are launchable: col, left and
    lead in one storage dtype (f32 or bf16) on one device, tiles int32
    there, and (nb, bw) within the kernel's ``slate_{name}_fits``."""
    name = kernel.name
    check_cuda_storage(name, col, left, lead)
    if tiles.device != col.device or tiles.dtype != torch.int32:
        raise ValueError(f"{name}: tiles must be int32 on {col.device}")
    if not fits(kernel, f"slate_{name}_fits", col.device, col.shape[2], bw):
        raise ValueError(f"{name}: nb = {col.shape[2]}, bw = {bw} is past "
                         f"the kernel's limits (slate_{name}_fits)")


def batched_panel_step(kernel: CudaKernel, col, left, lead, tiles, k: int,
                       bw: int):
    """One ragged batched panel step of K6 or K7 on CUDA tensors: col [B, M,
    nb], left [B, M, K], lead [B, K, nb] in f32 or bf16 storage (any
    strides), tiles [B] int32.  Returns (upd, fac) [B, M, nb] in the storage
    dtype.  On the current stream: the update launch (every 128-row tile of
    every problem, the K loop split over a thread-block cluster), the
    kernel's factor launch (tile 0 and, when M > nb, U^-1, one block a
    problem) and, when M > nb, the solve launch (the live rows below tile
    0): three launches, two when M == nb, counted by ``kernel``.  Past nb =
    128 (256, 384 or 512) the update and the solve take the panel in
    128-column tiles and the factor launch is one thread-block cluster a
    problem.  ``tiles`` is read on the device only; the f32 scratch the
    launches hand on (upd before rounding on bf16 storage, U^-1, and past
    nb = 128 the wide factor's, ``slate_{name}_work`` floats a problem)
    is allocated here."""
    bsz, m, nb = col.shape
    kk = left.shape[2]
    check_batched_panel(kernel, col, left, lead, tiles, bw)
    tiles = tiles.contiguous()
    upd = torch.empty((bsz, m, nb), dtype=col.dtype, device=col.device)
    fac = torch.empty_like(upd)
    work = (upd if col.dtype == torch.float32 else
            torch.empty((bsz, m, nb), dtype=torch.float32, device=col.device))
    uinv = (torch.empty((bsz, nb, nb), dtype=torch.float32, device=col.device)
            if m > nb else None)
    floats = shape_query(kernel, f"slate_{kernel.name}_work", col.device, nb)
    wide = (torch.empty(bsz * floats, dtype=torch.float32, device=col.device)
            if floats else None)
    dev, stream = device_and_stream(col)
    operands = (int(col.dtype == torch.bfloat16), col.data_ptr(),
                *col.stride(), left.data_ptr(), *left.stride(),
                lead.data_ptr(), *lead.stride(), tiles.data_ptr(), bsz, k, kk,
                m, nb, bw, upd.data_ptr(), fac.data_ptr(), work.data_ptr(),
                None if uinv is None else uinv.data_ptr(),
                None if wide is None else wide.data_ptr())
    for which in (UPDATE, FACTOR, SOLVE)[:3 if m > nb else 2]:
        kernel.launch(f"slate_{kernel.name}", dev, stream, which, *operands)
    return upd, fac


def batched_panel_step_plan(kernel: CudaKernel, col, left, lead) -> dict:
    """How K6's or K7's update launch takes these CUDA operands, as the
    kernel's library reports it (``slate_{name}_plan``): ``split``, the CTAs
    of one (row tile, problem)'s cluster that share its K loop (a function
    of K, nb and the device alone, never of the batch); ``resident``, the
    clusters of that size the card holds at once; ``waves``, the grid's
    clusters (every row tile, and past nb = 128 every 128-column tile, of
    every problem, dead ones included) over ``resident``; ``left``/``lead``, each "cp.async" (f32, unit stride along
    K, aligned rows and batches: 16-byte copies), "cp.async4" (f32, unit
    stride along the other index: 4-byte copies) or "loads"."""
    bsz, m, nb = col.shape
    split, resident, staging = query(
        kernel, f"slate_{kernel.name}_plan", col.device,
        int(col.dtype == torch.bfloat16), left.shape[2], nb, left.data_ptr(),
        *left.stride(), lead.data_ptr(), *lead.stride(), outs=3)
    clusters = bsz * -(-m // 128) * max(1, nb // 128)
    return {"split": split, "resident": resident,
            "waves": -(-clusters // max(resident, 1)),
            "left": STAGING[staging & 3], "lead": STAGING[staging >> 2]}
