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

``GraphedCall(fn, device, lanes=devices)`` captures one graph per lane
(a card, or on one card a stream of its own) at the same time from one
thread: each lane has its own capture stream, graph, memory pool and body
pool, and while ``fn`` runs every lane's stream is current for its card, so
each operation joins the graph of the card its tensors lie on. A replay
launches every lane's graph, each from a thread of its own
(``_launch_lanes``), with no host wait for the cards.
Under such a capture ``while_loop`` adds a WHILE node to every lane's
graph, each ended by its own replica of the condition (``cond()`` returns a
``parallel.blocks.Replicated`` scalar, or one flag per lane); data crosses
between lanes only through ``ops.peer``'s put and wait kernels (their
counters come from the capture's pool, ``counter_slots``), and a copy
between two devices left in ``fn`` raises ``CrossCardCopy`` naming its call
site (``_CrossDeviceCopies``, a dispatch mode around the capture): it would
join the captures into one graph across cards, whose WHILE bodies the
runtime refuses. ``per_card()`` turns on the per-card form of a placed
solve (``parallel.blocks``: replicated scalars, reductions combined on
every card); ``per_card(blocks_as_cards=True)`` treats every block as its
own card, so the CPU tests drive that form on ``("cpu",) * n`` placements.

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
import os
import re
import threading
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


class CrossCardCopy(RuntimeError):
    """A copy between two devices inside a per-lane capture (see the module
    docstring); the message names its call site."""


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
def per_card(blocks_as_cards: bool = False):
    """Within: a placed solve runs in its per-card form (``parallel.blocks``:
    every scalar replicated on each card that holds blocks, reductions
    combined on every card in block order, moves between cards through
    ``blocks.copy_into``), the form a graph per card captures.
    ``blocks_as_cards``: every block counts as a card of its own (the CPU
    tests' stand-in for cards; a ``per_card()`` within it keeps it)."""
    prev = getattr(_local, "per_card", None)
    # inside the stand-in, every block stays a card of its own
    _local.per_card = "blocks" if blocks_as_cards or prev == "blocks" else "cards"
    try:
        yield
    finally:
        _local.per_card = prev


def per_card_mode():
    """None outside ``per_card``, else "cards" or "blocks"."""
    return getattr(_local, "per_card", None)


def lanes_capturing() -> bool:
    """Whether a capture of more than one lane is underway on this thread."""
    return bool(_stack()) and len(_stack()[-1].lanes) > 1


def graph_lanes():
    """The lanes (a tuple of devices) of the ``GraphedCall`` underway on this
    thread: its capture, its eager warm-up, or its plain call on the CPU;
    None outside every ``GraphedCall``."""
    if _stack():
        return _stack()[-1].lanes
    calls = getattr(_local, "calls", None)
    return calls[-1].lanes if calls else None


@contextlib.contextmanager
def _eager_call(call):
    """Within: ``call``'s eager run (its warm-up, or its call on the CPU),
    for ``graph_lanes``."""
    if not hasattr(_local, "calls"):
        _local.calls = []
    _local.calls.append(call)
    try:
        yield
    finally:
        _local.calls.pop()


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
        lib.pyapes_capture_graph.argtypes = [vp, ctypes.POINTER(vp)]
        lib.pyapes_graph_census.argtypes = [vp, ctypes.POINTER(ull), ctypes.c_char_p, ull]
        lib.pyapes_loop_record.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp, vp,
                                           ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
                                           ctypes.c_int]
        for f in (lib.pyapes_while_begin, lib.pyapes_capture_to_graph, lib.pyapes_while_end,
                  lib.pyapes_loop_record, lib.pyapes_capture_graph, lib.pyapes_graph_census,
                  lib.pyapes_graph_census_init):
            f.restype = ctypes.c_int
        lib.pyapes_graph_census_init()  # its driver entry points, before any capture
        lib._typed = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise GraphLoopError(f"graph_loop: {what} failed: "
                           f"{lib.pyapes_cuda_error_string(err).decode()} ({err})")


_STREAMS: dict = {}


def _stream(kind: str, device, lane: int = 0) -> torch.cuda.Stream:
    """A stream of ``device`` kept for the process (``kind``: "body" for
    loop bodies, "capture" for ``GraphedCall``; ``lane``: one per lane of a
    capture), used once to run GEMMs in each float dtype (bf16 among them:
    a multigrid cycle's transfers), so cuBLAS holds its handle and
    workspace for it before any capture uses it."""
    key = (kind, str(device), lane)
    if key not in _STREAMS:
        s = torch.cuda.Stream(device=device)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.float64, torch.bfloat16):
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
    if len(owner.lanes) > 1:
        _while_lanes(owner, cond, body)
        return
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
            with torch.cuda.use_mem_pool(owner.body_pool(device), device):
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


_CENSUS = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
           "event_record", "ext_signal", "ext_wait", "mem_alloc", "mem_free", "batch_mem_op",
           "conditional", "other", "memcpy_across_devices", "edges", "longest_chain",
           "kernel_other_context", "kernel_context_unread", "memcpy_other_device",
           "memset_other_device", "kernel_functions", "most_blocks", "roots", "queries_failed")
_NODE_KINDS = 16
"""The census' entries that count nodes by type (``body_nodes``)."""


def census(graph) -> dict:
    """What the CUDA graph ``graph`` (a raw ``cudaGraph_t``) holds, read on
    the current device (``csrc/graph_loop.cu`` ``pyapes_graph_census``):
    nodes by type (``conditional``: WHILE nodes), memcpy nodes between two
    devices or with an end on another device, memsets into another device,
    kernel nodes of another context than the current one's, edges, roots,
    the longest dependency chain (nodes), the distinct kernel functions and
    the most blocks of one kernel node; ``kernels_by_name``: kernel nodes
    by function; ``peer_puts`` / ``peer_waits``: the ``ops.peer`` kernels
    among them. A graph the runtime cannot read gives zeros and ``error``:
    the census observes, it never fails a capture."""
    lib = _lib()
    out = (ctypes.c_ulonglong * len(_CENSUS))()
    names = ctypes.create_string_buffer(1 << 18)
    err = lib.pyapes_graph_census(graph, out, names, len(names))
    res = dict(zip(_CENSUS, (int(n) for n in out)))
    if err:
        res["error"] = lib.pyapes_cuda_error_string(err).decode()
    by_name: dict = {}
    for line in names.value.decode(errors="replace").splitlines():
        count, _, name = line.partition(" ")
        by_name[name] = by_name.get(name, 0) + int(count)
    res["kernels_by_name"] = by_name
    res["peer_puts"] = sum(c for k, c in by_name.items() if "peer_put_kernel" in k)
    res["peer_waits"] = sum(c for k, c in by_name.items() if "peer_wait_kernel" in k)
    return res


def capture_census(stream) -> dict:
    """``census`` of the graph that ``stream`` is capturing (before its
    capture ends; the current device must be the stream's)."""
    lib = _lib()
    graph = ctypes.c_void_p()
    err = lib.pyapes_capture_graph(stream.cuda_stream, ctypes.byref(graph))
    if err:
        return {**dict.fromkeys(_CENSUS, 0), "kernels_by_name": {}, "peer_puts": 0,
                "peer_waits": 0, "error": lib.pyapes_cuda_error_string(err).decode()}
    return census(graph)


def _node_types(c: dict) -> dict:
    """The nonzero node counts by type of a ``census``."""
    return {k: c[k] for k in _CENSUS[:_NODE_KINDS] if c[k]}


def _lane_flags(c, owner) -> list:
    """One 0-d bool per lane of ``owner`` from a condition: a replicated
    scalar's replicas (``parallel.blocks.Replicated``) or a sequence of one
    flag per lane."""
    parts = getattr(c, "parts", c)
    if not isinstance(parts, (list, tuple)) or len(parts) != len(owner.lanes):
        raise GraphLoopError(f"graph_loop: a loop of {len(owner.lanes)} lanes needs one condition "
                             f"per lane, got {type(c).__name__}")
    out = []
    for f, dev in zip(parts, owner.lanes):
        if f.device != dev:
            raise GraphLoopError(f"graph_loop: a lane on {dev} got its condition on {f.device}")
        out.append(f.to(torch.bool).contiguous())
    return out


def _while_lanes(owner, cond, body) -> None:
    """``while_loop`` under a capture of several lanes: a WHILE node on every
    lane's graph, each lane's body stream current for its card (on one card,
    the lanes' streams are ``owner.current``) while ``body()`` runs once."""
    global nodes
    lib = _lib()
    flags0 = _lane_flags(cond(), owner)
    outer = list(owner.current)
    handles, graphs = [], []
    for i, (dev, st) in enumerate(zip(owner.lanes, outer)):
        handle, body_graph = ctypes.c_ulonglong(), ctypes.c_void_p()
        with torch.cuda.device(dev):
            _check(lib, lib.pyapes_while_begin(st.cuda_stream, flags0[i].data_ptr(),
                                               ctypes.byref(handle), ctypes.byref(body_graph)),
                   f"adding the WHILE node of lane {i}")
        handles.append(handle)
        graphs.append(body_graph)
    bodies = [_stream("body", dev, i) for i, dev in enumerate(owner.lanes)]
    begun, flags = [], None
    try:
        for i, (dev, bs) in enumerate(zip(owner.lanes, bodies)):
            with torch.cuda.device(dev):
                _check(lib, lib.pyapes_capture_to_graph(bs.cuda_stream, graphs[i]),
                       f"the body capture of lane {i}")
            begun.append(i)
        owner.current = bodies
        with contextlib.ExitStack() as stack:
            for dev in dict.fromkeys(owner.lanes):
                stack.enter_context(torch.cuda.use_mem_pool(owner.body_pool(dev), dev))
            for bs in bodies:
                stack.enter_context(torch.cuda.stream(bs))
            body()
            flags = _lane_flags(cond(), owner)
    finally:
        owner.current = outer
        errs = []
        for i in begun:
            end_flag = flags[i] if flags is not None else flags0[i]
            with torch.cuda.device(owner.lanes[i]):
                errs.append(lib.pyapes_while_end(bodies[i].cuda_stream, handles[i].value,
                                                 end_flag.data_ptr()))
    for i, err in enumerate(errs):
        _check(lib, err, f"ending the body capture of lane {i}")
    bodies_census = []
    for dev, g in zip(owner.lanes, graphs):
        with torch.cuda.device(dev):
            bodies_census.append(census(g))
    owner.keep.extend((*flags0, *flags))
    owner.flags.append(flags)
    owner.body_census.append(bodies_census)
    owner.body_nodes.append([_node_types(c) for c in bodies_census])
    nodes += len(owner.lanes)


_RECORD_DTYPE = {torch.float32: 0, torch.float64: 1}


def loop_record(t, tol, itr, hist, go, max_it: int, tolerance: float | None = None,
                stall_ratio: float | None = None, stop=None) -> None:
    """The end of a solver loop's pass, on its state buffers: ``t`` (0-d
    float32 or float64, the pass's tolerance) is written to ``hist[itr]``
    (float32) and ``tol`` (float64), ``itr`` (int64) advances, and ``go``
    (0-d bool, the loop's condition) becomes ``itr < max_it``, and ``t >
    tolerance`` (when given), and not ``t > stall_ratio * (the previous
    tol)`` (when given), and not ``stop`` (a 0-d bool, when given)."""
    if isinstance(getattr(t, "parts", None), tuple):  # a replicated scalar: once per card
        for i in range(len(t.parts)):
            loop_record(t.parts[i], tol.parts[i], itr.parts[i], hist.parts[i], go.parts[i],
                        max_it, tolerance, stall_ratio,
                        None if stop is None else stop.parts[i])
        return
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
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device)
        _check(lib, lib.pyapes_loop_record(
            stream.cuda_stream, _RECORD_DTYPE[t.dtype], t.data_ptr(), tol.data_ptr(),
            itr.data_ptr(), hist.data_ptr(), go.data_ptr(),
            stop.data_ptr() if stop is not None else None, int(max_it),
            float(tolerance) if tolerance is not None else 0.0,
            float(stall_ratio) if stall_ratio is not None else 0.0, flags),
            "the loop record launch")
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


COUNTER_CHUNK = 1 << 17
"""Counters of ``ops.peer`` channels a lane's card holds per capture (1 MiB)."""


def counter_slots(device, n: int) -> torch.Tensor:
    """``n`` zeroed int64 counters on ``device`` for an ``ops.peer`` channel:
    from the pool of the capture underway (zeroed before it began, kept as
    long as its graphs, outside their memory pools), else fresh zeros."""
    device = torch.device(device)
    if not _stack() or device not in _stack()[-1].counters:
        return torch.zeros(n, dtype=torch.int64, device=device)
    owner = _stack()[-1]
    pool, used = owner.counters[device]
    if used + n > pool.numel():
        raise GraphLoopError(f"graph_loop: the capture needs more than {pool.numel()} transfer "
                             f"counters on {device} (graph_loop.COUNTER_CHUNK)")
    owner.counters[device] = (pool, used + n)
    return pool[used:used + n]


_COPIES = ("_to_copy", "to", "copy_", "_copy_from", "_copy_from_and_resize")


def _copy_devices(func, args, kwargs):
    """``(source device, destination device)`` of a copy operator, else None."""
    name = func.overloadpacket.__name__
    if name not in _COPIES or not args or not isinstance(args[0], torch.Tensor):
        return None
    src = args[0].device
    if name in ("copy_",):
        other = args[1] if len(args) > 1 else kwargs.get("src")
        return (other.device, src) if isinstance(other, torch.Tensor) else None
    if name.startswith("_copy_from"):
        dst = args[1] if len(args) > 1 else kwargs.get("dst")
        return (src, dst.device) if isinstance(dst, torch.Tensor) else None
    dst = kwargs.get("device")
    for a in args[1:]:
        if isinstance(a, torch.Tensor):
            dst = a.device
        elif isinstance(a, (torch.device, str)):
            try:
                dst = torch.device(a)
            except RuntimeError:
                continue
    return (src, torch.device(dst)) if dst is not None else None


def _site() -> str:
    """The innermost frame of the caller's code (not torch's, not this
    module's): ``file:line in function``."""
    here = os.path.abspath(__file__)
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    for f in reversed(traceback.extract_stack()[:-2]):
        fn = os.path.abspath(f.filename)
        if fn != here and not fn.startswith(torch_dir):
            return f"{f.filename}:{f.lineno} in {f.name}"
    return "unknown"


class _CrossDeviceCopies(TorchDispatchMode):
    """Raise ``CrossCardCopy`` at a copy between two devices (a ``.to`` of
    another device, a ``copy_`` from one): inside a capture of several
    lanes such a copy records an event on one card and waits for it on
    another, which would join the captures into one graph across cards.
    Block vectors and replicated scalars are left to their own dispatch,
    whose per-block operations this mode then sees."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor) for t in types):
            return NotImplemented
        devs = _copy_devices(func, args, kwargs)
        if devs is not None and devs[0] != devs[1]:
            raise CrossCardCopy(
                f"graph_loop: a copy from {devs[0]} to {devs[1]} ({func}) inside a capture of one "
                f"graph per card, at {_site()}: move data between cards with "
                "parallel.blocks.copy_into / transfer (the ops.peer kernels)")
        return func(*args, **kwargs)


def cross_device_copies():
    """The check ``GraphedCall`` keeps on during a capture of several lanes
    (``_CrossDeviceCopies``), as a context manager."""
    return _CrossDeviceCopies()


class GraphedCall:
    """``fn(*inputs) -> outputs`` (``inputs``: tensors; ``outputs``: a
    pytree of tensors) captured once into a CUDA graph and replayed.

    ``lanes``: the devices of a capture of one graph per lane (see the
    module docstring; a device may repeat: lanes on one card, each its own
    stream); default one lane on ``device``.

    ``__call__`` returns ``fn``'s outputs: on the first call those of the
    eager warm-up, later the graph's static outputs, which the next replay
    overwrites (``clone`` what must outlive it)."""

    def __init__(self, fn, device, lanes=None):
        self.fn = fn
        self.device = torch.device(device)
        self.lanes = tuple(torch.device(d) for d in lanes) if lanes else (self.device,)
        self.graph = None
        self.graphs: list = []
        self.static_inputs = None
        self.static_outputs = None
        self.keep: list = []
        self._body_pools: dict = {}
        self.counters: dict = {}
        self.current: list = []
        self.body_nodes: list = []
        """Per WHILE node of a capture of several lanes, the nodes of each
        lane's body graph by type."""
        self.body_census: list = []
        """Per WHILE node of a capture of several lanes, each lane's body
        graph's ``census``."""
        self.census: list = []
        """Per lane of a capture of several lanes: ``{"top": the census of
        its top-level graph (read before its capture ended), "bodies": the
        census of each of its loop bodies}``."""
        self.flags: list = []
        """Per WHILE node of a capture of several lanes, each lane's
        condition (its replica of the loop's exit, read after a replay)."""
        self.capture_s = 0.0

    def warm(self, *inputs):
        """The eager warm-up call (host loops)."""
        with host_loops(), _eager_call(self):
            return self.fn(*inputs)

    def body_pool(self, device=None):
        """The memory pool of this graph's loop bodies on ``device`` (made at
        the first loop; lives as long as the graph)."""
        device = torch.device(device) if device is not None else self.device
        if device not in self._body_pools:
            with torch.cuda.device(device):
                self._body_pools[device] = torch.cuda.MemPool()
        return self._body_pools[device]

    def capture(self, *inputs) -> None:
        """Capture ``fn`` on static copies of ``inputs``; raises
        ``CaptureError`` when ``fn`` does what a capture does not allow,
        and any other error as it is."""
        import time

        if len(self.lanes) > 1:
            return self._capture_lanes(*inputs)
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
            _raise_capture_error(e)
        finally:
            if gc_on:
                gc.enable()
        torch.cuda.current_stream(self.device).wait_stream(s)
        self.graph, self.static_outputs = g, out
        self.graphs = [g]
        self.capture_s = time.perf_counter() - tic

    def _capture_lanes(self, *inputs) -> None:
        """``capture`` of one graph per lane, all begun before ``fn`` runs
        (relaxed capture mode: one lane's capture must not refuse the
        calls that begin, end and instantiate another's) and ``fn`` run
        once with every lane's stream current, under the cross-device copy
        check."""
        import time

        from pyapes_tpu_torch.ops import peer

        tic = time.perf_counter()
        _lib()
        peer.enable_peer_access(self.lanes)
        self.static_inputs = [t.clone() for t in inputs]
        streams = [_stream("capture", d, i) for i, d in enumerate(self.lanes)]
        for i, d in enumerate(self.lanes):
            _stream("body", d, i)
        self.keep, self.flags, self.body_nodes, self.body_census = [], [], [], []
        # the transfers' counters: zeroed before the capture, outside its pools
        self.counters = {d: (torch.zeros(COUNTER_CHUNK, dtype=torch.int64, device=d), 0)
                         for d in dict.fromkeys(self.lanes)}
        for d in dict.fromkeys(self.lanes):
            torch.cuda.synchronize(d)
        for d, s in zip(self.lanes, streams):
            s.wait_stream(torch.cuda.current_stream(d))
        graphs = [torch.cuda.CUDAGraph() for _ in self.lanes]
        pools = [torch.cuda.graph_pool_handle() for _ in self.lanes]
        gc_on = gc.isenabled()
        gc.collect()
        gc.disable()
        begun = []
        try:
            try:
                for g, s, p in zip(graphs, streams, pools):
                    with torch.cuda.stream(s):
                        g.capture_begin(pool=p, capture_error_mode="relaxed")
                    begun.append(g)
                _stack().append(self)
                self.current = list(streams)
                try:
                    with contextlib.ExitStack() as stack:
                        for s in streams:
                            stack.enter_context(torch.cuda.stream(s))
                        stack.enter_context(cross_device_copies())
                        out = self.fn(*self.static_inputs)
                finally:
                    _stack().pop()
                    self.current = []
            except BaseException:
                for g, s in zip(begun, streams):
                    try:
                        with torch.cuda.stream(s):
                            g.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by the error
                raise
            tops = []
            for s in streams:  # every lane's top-level graph, before any capture ends
                with torch.cuda.stream(s):
                    tops.append(capture_census(s))
            for g, s in zip(graphs, streams):
                with torch.cuda.stream(s):
                    g.capture_end()
        except BaseException as e:
            self.static_inputs = None
            for g, p, d in zip(graphs, pools, self.lanes):
                _abandon(g, p, d)
            _raise_capture_error(e)
        finally:
            if gc_on:
                gc.enable()
        for d, s in zip(self.lanes, streams):
            torch.cuda.current_stream(d).wait_stream(s)
        self.keep.append(self.counters)
        self.census = [{"top": top, "bodies": [b[i] for b in self.body_census]}
                       for i, top in enumerate(tops)]
        self.graphs, self.static_outputs = graphs, out
        self.graph = graphs[0]
        self.capture_s = time.perf_counter() - tic

    def replay(self, *inputs):
        for dst, src in zip(self.static_inputs, inputs):
            if src is not dst:
                dst.copy_(src)
        if len(self.graphs) == 1:
            self.graph.replay()
            return self.static_outputs
        # every lane's graph on its own stream (two lanes of one card must
        # not share one: a put would wait for a wait queued behind it),
        # ordered after the input copies and before what follows, each
        # launched from a thread of its own (_launch_lanes), no host wait
        # for the device
        streams = [_stream("capture", d, i) for i, d in enumerate(self.lanes)]
        for d, s in zip(self.lanes, streams):
            s.wait_stream(torch.cuda.current_stream(d))
        _launch_lanes(self.graphs, streams)
        for d, s in zip(self.lanes, streams):
            torch.cuda.current_stream(d).wait_stream(s)
        return self.static_outputs

    def __call__(self, *inputs):
        if self.device.type != "cuda":
            with _eager_call(self):
                return self.fn(*inputs)
        if self.graph is None:
            out = self.warm(*inputs)
            self.capture(*inputs)
            return out
        return self.replay(*inputs)


_LAUNCHERS: dict = {}


def _launch_lanes(graphs, streams) -> None:
    """Launch each lane's graph on its stream, every launch from a thread of
    its own (a pool of one thread per lane, kept for the process), and
    return once every launch has returned (the host never waits for a
    card). Launched one after another from one thread, a graph that holds a
    WHILE node and some thousands of nodes deadlocks: its launch returns
    only once its card has taken most of its work, while the card waits in
    a ``peer_wait`` for a put of a lane not launched yet; the wait traps at
    its timeout and the runtime then faults inside ``cudaGraphLaunch``
    (``scripts/graph_launch_repro.py``, on the CUDA runtime alone: 10,000
    kernel nodes ahead of the WHILE node faulted one timeout after the
    launch, and ran without the WHILE node, without the waits, or launched
    side by side). Side by side every lane drains: each wait's put lies at
    the same or an earlier place of the program every lane runs."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(graphs)
    if n not in _LAUNCHERS:
        _LAUNCHERS[n] = ThreadPoolExecutor(max_workers=n, thread_name_prefix="graph-lane")

    def launch(g, s):
        with torch.cuda.stream(s):
            g.replay()

    futures = [_LAUNCHERS[n].submit(launch, g, s) for g, s in zip(graphs, streams)]
    for f in futures:
        f.result()


def _raise_capture_error(e: BaseException):
    """Re-raise a capture's error: an operation a capture does not allow as
    ``CaptureError``, any other as it is."""
    if (not isinstance(e, RuntimeError) or isinstance(
            e, (CaptureError, GraphLoopError, CrossCardCopy, NotImplementedError))
            or not _UNCAPTURABLE.search(str(e))):
        raise e
    where = traceback.extract_tb(e.__traceback__)[-1]
    raise CaptureError(f"{type(e).__name__} at {where.filename}:{where.lineno}: "
                       f"{str(e).splitlines()[0]}") from e
