"""Loops whose exit the device decides, and calls captured once into a
CUDA graph and replayed.

``while_loop(cond, body, device)`` runs ``body()`` while ``cond()`` (a 0-d
bool tensor) holds. The body updates state buffers the loop owns in place.

* On a CPU tensor, or on the card when no graph is being captured, it is
  the host loop: one read of ``cond`` per pass (the plain version).
* Under stream capture it adds a conditional WHILE node to the graph being
  captured (``csrc/graph_loop.cu``): a one-thread kernel sets the node's
  condition from ``cond()`` before the node, the body is captured from a
  second stream into the node's body graph, and the same kernel ends each
  pass with the new ``cond()``. A loop whose condition is already false
  runs zero passes; none of it reads anything back to the host. The
  body's allocations go to a memory pool the graph owns.

``loop_record(t, tol, itr, hist, go, max_it, ...)`` is a solver loop's
scalar bookkeeping at the end of a pass, one launch on the card (a
one-thread kernel of ``csrc/graph_loop.cu``), the same torch operations on
the CPU (the plain version).

``GraphedCall(fn, device)`` captures ``fn(*tensors)`` into a CUDA graph:
its first call runs ``fn`` eagerly (the warm-up: kernels load, device
constants are cached, loops run on the host), then captures it on static
copies of the inputs; later calls copy their inputs into those buffers and
replay. An operation that cannot be captured (a host read, a pageable
upload) raises ``CaptureError``; any other error, the WHILE node's own
among them (``GraphLoopError``), propagates as it is. On a CPU tensor it
calls ``fn``.

A graph addresses every tensor it reads by its pointer, so what a capture
reads from outside its own memory pool (cached device constants, multigrid
hierarchies, eigen-factors, the built solve) must live as long as the
graph: code that hands out such objects calls ``keep_alive`` on them, which
adds them to the ``keep`` list of every capture underway.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import re
import threading
import traceback

import torch

from pyapes_tpu_torch.utils.debug import record_kernel

nodes = 0
"""WHILE nodes added to captured graphs (a counter, like the kernels'
``launches``)."""


class CaptureError(RuntimeError):
    """A call could not be captured into a CUDA graph. Torch raises
    ``RuntimeError`` (``torch.AcceleratorError`` in newer versions, a
    ``RuntimeError`` too) for an operation that is not allowed while a stream
    captures, e.g. ``.item()`` or ``float(t)`` of a device tensor, or an
    upload from pageable host memory; ``GraphedCall`` re-raises it as this
    class, with the model state untouched."""


class GraphLoopError(RuntimeError):
    """The WHILE node could not be added or its body not captured (a fault
    of this module or of the CUDA runtime, never converted to ``CaptureError``)."""


# torch's and the CUDA runtime's messages for an operation a stream capture
# does not allow (cudaErrorStreamCaptureUnsupported and the errors a capture
# invalidated by it reports afterwards; torch's own capture checks)
_UNCAPTURABLE = re.compile(r"captur", re.IGNORECASE)

_local = threading.local()


def _stack() -> list:
    """The captures underway on this thread: one ``GraphedCall`` per
    capture (its ``keep``: tensors the graph reads that nothing else holds;
    its ``body_pool``: the memory of its loop bodies)."""
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def keep_alive(*objs) -> None:
    """Tie ``objs`` to every graph being captured on this thread (no-op
    outside a capture): a graph must not outlive what it reads."""
    for call in _stack():
        call.keep.extend(objs)


@contextlib.contextmanager
def host_loops():
    """Within: ``sync: False`` solves outside a capture run their host loop
    instead of a graph of the whole solve (``GraphedCall``'s warm-up)."""
    prev = getattr(_local, "host_loops", False)
    _local.host_loops = True
    try:
        yield
    finally:
        _local.host_loops = prev


def use_host_loops() -> bool:
    return getattr(_local, "host_loops", False)


@contextlib.contextmanager
def whole_step():
    """Within: the core of a fused whole step (``utils/fuse.py``), on the
    card (its warm-up and capture) or on the CPU."""
    prev = getattr(_local, "whole_step", False)
    _local.whole_step = True
    try:
        yield
    finally:
        _local.whole_step = prev


def in_whole_step() -> bool:
    return getattr(_local, "whole_step", False)


def capturing(device) -> bool:
    """Whether the current stream of ``device`` is capturing a graph."""
    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


def _lib():
    from pyapes_tpu_torch.ops import cuda_build

    lib = cuda_build.load("graph_loop")
    if not getattr(lib, "_typed", False):
        vp, ull = ctypes.c_void_p, ctypes.c_ulonglong
        lib.pyapes_while_begin.argtypes = [vp, vp, ctypes.POINTER(ull), ctypes.POINTER(vp)]
        lib.pyapes_capture_to_graph.argtypes = [vp, vp]
        lib.pyapes_while_end.argtypes = [vp, ull, vp]
        lib.pyapes_loop_record.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp, vp,
                                           ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
                                           ctypes.c_int]
        for f in (lib.pyapes_while_begin, lib.pyapes_capture_to_graph, lib.pyapes_while_end,
                  lib.pyapes_loop_record):
            f.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise GraphLoopError(f"graph_loop: {what} failed: "
                           f"{lib.pyapes_cuda_error_string(err).decode()} ({err})")


_STREAMS: dict = {}


def _stream(kind: str, device) -> torch.cuda.Stream:
    """A stream of ``device`` kept for the process (``kind``: "body" for
    loop bodies, "capture" for ``GraphedCall``), used once to run GEMMs in
    each float dtype, so cuBLAS holds its handle and workspace for it
    before any capture uses it."""
    key = (kind, str(device))
    if key not in _STREAMS:
        s = torch.cuda.Stream(device=device)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.float64):
                a = torch.ones(8, 8, dtype=dt, device=device)
                torch.matmul(a, a)
                torch.matmul(a.view(2, 4, 8), a)
        torch.cuda.synchronize(device)
        _STREAMS[key] = s
    return _STREAMS[key]


def while_loop(cond, body, device) -> None:
    """Run ``body()`` while ``cond()`` holds (see the module docstring)."""
    global nodes
    if not capturing(device):
        while bool(cond()):
            body()
        return
    if not _stack():
        raise GraphLoopError("graph_loop: a device loop needs a capture begun by GraphedCall")
    owner = _stack()[-1]
    lib = _lib()
    device = torch.device(device)
    flag0 = cond().to(torch.bool).contiguous()
    stream = torch.cuda.current_stream(device)
    handle, body_graph = ctypes.c_ulonglong(), ctypes.c_void_p()
    _check(lib, lib.pyapes_while_begin(stream.cuda_stream, flag0.data_ptr(),
                                       ctypes.byref(handle), ctypes.byref(body_graph)),
           "adding the WHILE node")
    bs = _stream("body", device)
    flag = None
    with torch.cuda.stream(bs):
        _check(lib, lib.pyapes_capture_to_graph(bs.cuda_stream, body_graph), "body capture")
        try:
            # the body's allocations: a pool of the graph's own (the
            # capturing graph's pool serves its capture stream only)
            with torch.cuda.use_mem_pool(owner.body_pool(), device):
                body()
                flag = cond().to(torch.bool).contiguous()
        finally:
            # end the body capture even when the body raised (a flag of
            # false then: the graph is discarded anyway)
            end_flag = flag if flag is not None else flag0
            err = lib.pyapes_while_end(bs.cuda_stream, handle.value, end_flag.data_ptr())
        _check(lib, err, "ending the body capture")
    owner.keep.extend((flag0, flag))
    nodes += 1


_RECORD_DTYPE = {torch.float32: 0, torch.float64: 1}


def loop_record(t, tol, itr, hist, go, max_it: int, tolerance: float | None = None,
                stall_ratio: float | None = None, stop=None) -> None:
    """The end of a solver loop's pass, on its state buffers: ``t`` (0-d
    float32 or float64, the pass's tolerance) is written to ``hist[itr]``
    (float32) and ``tol`` (float64), ``itr`` (int64) advances, and ``go``
    (0-d bool, the loop's condition) becomes ``itr < max_it``, and ``t >
    tolerance`` (when given), and not ``t > stall_ratio * (the previous
    tol)`` (when given), and not ``stop`` (a 0-d bool, when given)."""
    if t.device.type != "cuda":
        tn = t.double()
        hist.index_copy_(0, itr.view(1), tn.to(hist.dtype).view(1))
        g = itr < max_it - 1
        if tolerance is not None:
            g = g & (tn > tolerance)
        if stall_ratio is not None:
            g = g & ~(tn > stall_ratio * tol)
        if stop is not None:
            g = g & ~stop
        tol.copy_(tn)
        itr.add_(1)
        go.copy_(g)
        return
    if t.dtype not in _RECORD_DTYPE:
        raise TypeError(f"loop_record: t must be float32 or float64, got {t.dtype}")
    flags = (1 if tolerance is not None else 0) | (2 if stall_ratio is not None else 0) | (
        4 if stop is not None else 0)
    lib = _lib()
    stream = torch.cuda.current_stream(t.device)
    _check(lib, lib.pyapes_loop_record(
        stream.cuda_stream, _RECORD_DTYPE[t.dtype], t.data_ptr(), tol.data_ptr(), itr.data_ptr(),
        hist.data_ptr(), go.data_ptr(), stop.data_ptr() if stop is not None else None,
        int(max_it), float(tolerance) if tolerance is not None else 0.0,
        float(stall_ratio) if stall_ratio is not None else 0.0, flags), "the loop record launch")
    record_kernel("loop_record", tol)


def _abandon(graph, pool, device) -> None:
    """Leave the allocator as it was before a capture that failed: the
    routing of allocations to the graph's pool ended (a failed
    ``capture_end`` may not have reached it, and a routing left behind
    aborts the process at its next cache flush). The graph object and its
    pool are kept for the life of the process, never destroyed: whether its
    destructor would release the pool depends on how far ``capture_end``
    got (a capture ended but not instantiated releases it there; a second
    release aborts the process at its exit)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(idx, pool)
    except RuntimeError:
        pass  # capture_end had ended it
    ctypes.pythonapi.Py_IncRef(ctypes.py_object(graph))  # not even at the interpreter's exit


class GraphedCall:
    """``fn(*inputs) -> outputs`` (``inputs``: tensors; ``outputs``: a
    pytree of tensors) captured once into a CUDA graph and replayed.

    ``__call__`` returns ``fn``'s outputs: on the first call those of the
    eager warm-up, later the graph's static outputs, which the next replay
    overwrites (``clone`` what must outlive it)."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.static_inputs = None
        self.static_outputs = None
        self.keep: list = []
        self._body_pool = None
        self.capture_s = 0.0

    def warm(self, *inputs):
        """The eager warm-up call (host loops)."""
        with host_loops():
            return self.fn(*inputs)

    def body_pool(self):
        """The memory pool of this graph's loop bodies (made at the first
        loop; lives as long as the graph)."""
        if self._body_pool is None:
            self._body_pool = torch.cuda.MemPool()
        return self._body_pool

    def capture(self, *inputs) -> None:
        """Capture ``fn`` on static copies of ``inputs``; raises
        ``CaptureError`` when ``fn`` does what a capture does not allow,
        and any other error as it is."""
        import time

        tic = time.perf_counter()
        _lib()  # built and loaded before the capture: its faults propagate
        self.static_inputs = [t.clone() for t in inputs]
        g = torch.cuda.CUDAGraph()
        s = _stream("capture", self.device)
        _stream("body", self.device)  # made (and warmed) before the capture
        self.keep = []
        torch.cuda.synchronize(self.device)
        s.wait_stream(torch.cuda.current_stream(self.device))
        pool = torch.cuda.graph_pool_handle()
        # no collection during the capture: a graph or pool of an earlier
        # call that the collector frees then releases memory mid-capture,
        # which aborts the process
        gc_on = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.stream(s):
                g.capture_begin(pool=pool)
                _stack().append(self)
                try:
                    out = self.fn(*self.static_inputs)
                except BaseException:
                    try:
                        g.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by the error
                    raise
                finally:
                    _stack().pop()
                g.capture_end()
        except BaseException as e:
            self.static_inputs = None
            _abandon(g, pool, self.device)
            if (not isinstance(e, RuntimeError) or isinstance(
                    e, (CaptureError, GraphLoopError, NotImplementedError))
                    or not _UNCAPTURABLE.search(str(e))):
                raise
            where = traceback.extract_tb(e.__traceback__)[-1]
            raise CaptureError(f"{type(e).__name__} at {where.filename}:{where.lineno}: "
                               f"{str(e).splitlines()[0]}") from e
        finally:
            if gc_on:
                gc.enable()
        torch.cuda.current_stream(self.device).wait_stream(s)
        self.graph, self.static_outputs = g, out
        self.capture_s = time.perf_counter() - tic

    def replay(self, *inputs):
        for dst, src in zip(self.static_inputs, inputs):
            if src is not dst:
                dst.copy_(src)
        self.graph.replay()
        return self.static_outputs

    def __call__(self, *inputs):
        if self.device.type != "cuda":
            return self.fn(*inputs)
        if self.graph is None:
            out = self.warm(*inputs)
            self.capture(*inputs)
            return out
        return self.replay(*inputs)
