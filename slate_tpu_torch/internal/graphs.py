"""CUDA-graph capture of a function of static tensors: the port's
counterpart of the reference's compiled executables (serve/cache.py's
warm buckets, posv's ``Option.HoldLocalWorkspace``).

:class:`Captured` runs the function once eagerly on a side stream (the
warm-up: it loads the kernel libraries and runs every ``slate_*_plan`` /
``slate_*_fits`` query, shared-memory attribute and cuBLAS set-up outside
capture), then captures a second run into a ``torch.cuda.CUDAGraph``
whose inputs are the static tensors it was given, on the same side
stream.  Each call copies new operands into those tensors, replays the
graph on the current stream and returns copies of its outputs, so the
next replay cannot overwrite results already handed out.  Each graph
keeps its own memory pool; when a capture runs out of memory, the
allocator's cached blocks are released and the capture is made once
more.

The function must not read the device on the host, allocate outside
PyTorch, or branch on a device value: every launch it makes is recorded
once.  The hand kernels launch on the current stream and allocate
nothing, so they capture; their launches at capture are tallied
(internal/kernels.py ``capture_tally``) and each replay adds them to the
kernels' ``replayed`` counts.  Captures are made one at a time in the
process, in ``thread_local`` mode, so that other threads keep allocating
and launching while one captures; no thread may synchronize the whole
device while a capture is in flight.
"""

from __future__ import annotations

import threading

import torch

from . import kernels as _kernels

_CAPTURE_LOCK = threading.Lock()


class Captured:
    """``fn(*inputs)``, a tuple of tensors, captured as one CUDA graph over
    the static ``inputs`` (CUDA tensors this object keeps).  ``launches``
    is the capture's tally, kernel -> launches a replay makes, and
    ``replays`` counts the calls."""

    def __init__(self, fn, inputs):
        self.inputs = list(inputs)
        device = self.inputs[0].device
        caller = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(caller)
        with _CAPTURE_LOCK:
            try:
                # slate-lint: disable=CON003 -- captures are made one at a time in the process by design (module docstring): the lock holds back only other captures, never replays or eager launches
                tally = self._capture(fn, stream)
            except torch.cuda.OutOfMemoryError:
                tally = None
            if tally is None:
                # a graph's private pool cannot take the blocks the
                # allocator keeps cached, and nothing is freed during a
                # capture: drop the failed graph (its tensors went with
                # the exception), hand the cache back to the device and
                # try once more
                self.graph = None
                torch.cuda.empty_cache()
                # slate-lint: disable=CON003 -- the one retry of the capture above, under the same one-capture-at-a-time lock
                tally = self._capture(fn, stream)
        caller.wait_stream(stream)
        self.launches = dict(tally)
        self.replays = 0

    def _capture(self, fn, stream) -> dict:
        """The warm-up pass and the capture on ``stream``; returns the
        capture's tally.  (torch.cuda.graph would also synchronize the
        device and empty the allocator's cache at every capture, which
        every later eager allocation would pay for again.)"""
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            fn(*self.inputs)                          # the warm-up pass
            with _kernels.capture_tally() as tally:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.outputs = tuple(fn(*self.inputs))
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:   # the capture was invalidated
                        pass
                    raise
                self.graph.capture_end()
        return tally

    def __call__(self, *args) -> tuple:
        """Copy ``args`` into the static inputs, replay, and return copies
        of the outputs, all on the current stream.  Callers that share the
        static inputs between threads serialize their calls."""
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        _kernels.add_replay(self.launches)
        return tuple(o.clone() for o in self.outputs)
