"""Bench's MG-PCG as a ``sync: False`` solve across cards, cell by cell:
the cycle's dtype {float32, bfloat16} x its FMG start {off, on} x the grid
{64^3, 256^3, 512^3} x the cards {2, 4}, each cell in a process of its own
(a fault in a replay leaves the CUDA context unusable, a segfault ends the
process) with ``faulthandler`` on.

A cell is ``chip_smoke.py``'s MG-PCG (``mg_cfg(BENCH_MG)``: CG, V(2,2),
omega 0.857, ``fuse_rz``) with the cell's dtype and FMG start, the Field, the
RHS and the solution on ``N_DECOMP`` (4, 2, 1) blocks round robin over the
cell's cards: one ``sync: True`` solve (the reference), the first ``sync:
False`` solve (its eager warm-up and the capture of one graph per card),
then ``REPLAYS`` replays, each held to the reference's solution bits,
``itr`` and ``tol``. A cell prints a line at each stage, so a process that
dies shows how far it got, and one JSON line at its end: the stages'
walls, the capture's transfers between cards and counters, every card's
peak and reserved memory. Each graph launch of a replay is announced on
the error stream first, so a fault inside ``cudaGraphLaunch`` names its
card.

With ``--native-stack`` every cell runs with a preloaded SIGSEGV handler
(built here with ``cc``) that prints the fault's address and the native
stack after Python's; where ``gdb`` is on the host the first cell that
dies runs again under ``gdb -batch``.

    python scripts/mg_across_matrix_torch.py                 # the matrix; needs 4 cards
    python scripts/mg_across_matrix_torch.py --grids 64 --cards 2 --native-stack
    python scripts/mg_across_matrix_torch.py --one bfloat16 1 512 4   # one cell

Prints one line per cell and, last, one JSON line: the torch and CUDA
versions, every card's name and power limit, and every cell's result
(exit code, the last stage reached, the end of its error stream).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPLAYS = 3
CELL_TIMEOUT_S = 300

_SEGV_C = r"""
#include <execinfo.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <unistd.h>
static struct sigaction prev;
static void on_segv(int sig, siginfo_t *si, void *ctx) {
  void *frames[64];
  char line[128];
  int n = backtrace(frames, 64);
  int k = snprintf(line, sizeof line, "native stack (signal %d at address %p):\n", sig,
                   si ? si->si_addr : 0);
  write(2, line, k);
  backtrace_symbols_fd(frames, n, 2);
  sigaction(SIGSEGV, &prev, 0);
  raise(sig);
}
__attribute__((constructor)) static void install(void) {
  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = on_segv;
  sa.sa_flags = SA_SIGINFO;
  sigaction(SIGSEGV, &sa, &prev);
}
"""


def _stage(msg: str) -> None:
    print(f"[stage] {msg}", flush=True)


# ``--variants``: how a cell's graphs per card are captured, instantiated and
# launched (``graph_loop.GraphedCall``'s capture of several lanes), one
# hypothesis each, set up in the cell's process by ``_variant``
VARIANTS = {
    "plain": "the port's: relaxed captures, each lane's graph instantiated as its capture ends",
    "deferred": "every lane's graph instantiated once every capture has ended",
    "reverse": "deferred, the lanes launched last card first",
    "thread_local": "deferred, the captures in thread_local mode (an unsafe call raises)",
    "nocopy": "deferred, every same-card contiguous copy a multiply-by-one kernel, no memcpy node",
}


def _variant(name: str) -> None:
    """Set up ``graph_loop`` for the variant ``name`` (``VARIANTS``) in this
    process."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from pyapes_tpu_torch.ops import graph_loop

    if name == "plain":
        return
    graph_cls = torch.cuda.CUDAGraph
    mode = "thread_local" if name == "thread_local" else "relaxed"

    class Kept(graph_cls):
        """A graph instantiated by ``instantiate`` alone, captured in ``mode``."""

        def __new__(cls, keep_graph: bool = True):
            return super().__new__(cls, True)

        def capture_begin(self, pool=None, capture_error_mode="global", **kw):
            return super().capture_begin(pool=pool, capture_error_mode=mode, **kw)

    real_capture = graph_loop.GraphedCall._capture_lanes

    def capture_lanes(self, *inputs):
        fn = self.fn
        if name == "nocopy":
            def wrapped(*a):
                with NoMemcpy():
                    return fn(*a)

            self.fn = wrapped
        torch.cuda.CUDAGraph = Kept
        try:
            real_capture(self, *inputs)
        finally:
            torch.cuda.CUDAGraph = graph_cls
            self.fn = fn
        for g, d in zip(self.graphs, self.lanes):  # every capture has ended
            with torch.cuda.device(d):
                g.instantiate()

    graph_loop.GraphedCall._capture_lanes = capture_lanes
    aten = torch.ops.aten

    class NoMemcpy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(t is not torch.Tensor and issubclass(t, torch.Tensor) for t in types):
                return NotImplemented  # block vectors: their parts' copies come here
            if (func is aten.copy_.default and not kwargs and len(args) == 2
                    and all(type(a) is torch.Tensor for a in args)):
                dst, src = args
                if (dst.device == src.device and dst.device.type == "cuda"
                        and dst.dtype == src.dtype and dst.shape == src.shape
                        and torch.cuda.is_current_stream_capturing()):
                    return torch.mul(src, 1, out=dst)
            return func(*args, **kwargs)

    if name == "reverse":
        def replay(self, *inputs):
            for dst, src in zip(self.static_inputs, inputs):
                if src is not dst:
                    dst.copy_(src)
            lanes = list(enumerate(self.lanes))[::-1]
            streams = {i: graph_loop._stream("capture", d, i) for i, d in lanes}
            for i, d in lanes:
                streams[i].wait_stream(torch.cuda.current_stream(d))
            for i, d in lanes:
                with torch.cuda.stream(streams[i]):
                    self.graphs[i].replay()
            for i, d in lanes:
                torch.cuda.current_stream(d).wait_stream(streams[i])
            return self.static_outputs

        graph_loop.GraphedCall.replay = replay


def one(dtype: str, fmg: bool, n: int, n_cards: int, variant: str = "plain") -> dict:
    """One cell, in this process (see the module docstring)."""
    import torch

    import chip_smoke as cs
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.linalg import dispatch
    from pyapes_tpu_torch.solver.ops import Solver

    _variant(variant)
    real_replay = torch.cuda.CUDAGraph.replay

    def announced(graph):
        _stage(f"launch a graph on cuda:{torch.cuda.current_device()}")
        return real_replay(graph)

    torch.cuda.CUDAGraph.replay = announced
    if hasattr(dispatch, "_check_across"):  # the raise this matrix bisects, lifted here
        dispatch._check_across = lambda *args: None
    dev = torch.device("cuda:0")
    cards = [f"cuda:{i}" for i in range(n_cards)]
    dd = DomainDecomposition(cs.N_DECOMP, devices=tuple(cards[i % n_cards]
                                                        for i in range(8)))
    opts = {**cs.BENCH_MG, "dtype": dtype, "fmg": fmg}
    cfg = {k: v for k, v in cs.mg_cfg(opts).items() if k != "donate"}
    cfg["decomp"] = dd
    _stage(f"problem {n}^3 on {cards}")
    _, var, rhs, coeff = cs._block_problem(dev, dd, (n,) * 3)
    fdm = FDM()
    solvers = {s: Solver({"fdm": {"report": False, **cfg, "sync": s}}) for s in (True, False)}

    def solve(sync):
        var().zero_()
        solvers[sync].set_eq(fdm.laplacian(coeff, var) == rhs)
        rep = solvers[sync].solve()
        cs._sync_all()
        return rep

    def bits():
        return [p.clone() for p in var().parts]

    out = {"dtype": dtype, "fmg": fmg, "n": n, "cards": n_cards, "variant": variant,
           "walls_s": {}}
    tic = time.perf_counter()
    ref_rep = solve(True)
    out["walls_s"]["sync_true"] = time.perf_counter() - tic
    ref = bits()
    out["itr"], out["tol"] = ref_rep["itr"], ref_rep["tol"]
    _stage(f"sync: True itr {ref_rep['itr']}; the warm-up and capture")
    t0 = blocks.transfers_across
    tic = time.perf_counter()
    solve(False)
    out["walls_s"]["warm_up_and_capture"] = time.perf_counter() - tic
    call = next(reversed(dispatch._GRAPH_CACHE.values()))[0]
    out["capture_s"] = call.capture_s
    out["graphs"] = len(call.graphs)
    out["while_nodes"] = len(call.body_nodes)
    out["transfers_across_captured"] = blocks.transfers_across - t0
    out["counters_used"] = {str(d): used for d, (_, used) in call.counters.items()}
    out["reserved_gib_per_card_after_capture"] = [torch.cuda.memory_reserved(c) / 2**30
                                                  for c in cards]
    out["body_nodes_per_card"] = [
        {k: sum(lanes[i].get(k, 0) for lanes in call.body_nodes)
         for k in set().union(*(lanes[i] for lanes in call.body_nodes))}
        for i in range(len(call.lanes))] if call.body_nodes else []
    _stage("loop bodies' nodes per card " + json.dumps(out["body_nodes_per_card"]))
    same, itrs, tols, walls = [], [], [], []
    for i in range(REPLAYS):
        _stage(f"replay {i + 1}")
        tic = time.perf_counter()
        rep = solve(False)
        walls.append(time.perf_counter() - tic)
        same.append(all(torch.equal(a, b) for a, b in zip(bits(), ref)))
        itrs.append(int(rep["itr"]))
        tols.append(float(rep["tol"]) == ref_rep["tol"])
    out.update({"same_bits": same, "sync_false_itr": itrs, "same_tol_bits": tols})
    out["walls_s"]["replays"] = walls
    out["peak_gib_per_card"] = [torch.cuda.max_memory_allocated(c) / 2**30 for c in cards]
    out["ok"] = all(same) and all(tols) and itrs == [ref_rep["itr"]] * REPLAYS
    return out


def _preload_lib(tmp: str) -> str | None:
    """The SIGSEGV handler as a shared library (``_SEGV_C``), or None where
    no C compiler is on the host."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    src, lib = os.path.join(tmp, "segv_stack.c"), os.path.join(tmp, "segv_stack.so")
    with open(src, "w") as f:
        f.write(_SEGV_C)
    run = subprocess.run([cc, "-shared", "-fPIC", "-O1", "-o", lib, src], capture_output=True,
                         text=True)
    return lib if run.returncode == 0 else None


# ``--knobs``: the first cell that dies, again under each of these (one
# hypothesis each: kernels loaded at start, no cuBLAS workspace, cuBLASLt
# for every GEMM, an unlimited main-thread stack)
KNOBS = {"CUDA_MODULE_LOADING=EAGER": {"CUDA_MODULE_LOADING": "EAGER"},
         "CUBLAS_WORKSPACE_CONFIG=:0:0": {"CUBLAS_WORKSPACE_CONFIG": ":0:0"},
         "TORCH_BLAS_PREFER_CUBLASLT=1": {"TORCH_BLAS_PREFER_CUBLASLT": "1"},
         "stack unlimited": None}


def _unlimited_stack():
    import resource

    hard = resource.getrlimit(resource.RLIMIT_STACK)[1]
    resource.setrlimit(resource.RLIMIT_STACK, (hard, hard))


def _cell(args: list, env: dict, gdb: bool = False, preexec=None) -> dict:
    cmd = [sys.executable, "-X", "faulthandler", os.path.abspath(__file__), "--one", *args]
    if gdb:
        cmd = ["gdb", "-batch", "-ex", "set pagination off", "-ex", "run", "-ex", "bt 40",
               "-ex", "info threads", "--args", *cmd]
    tic = time.perf_counter()
    try:
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=CELL_TIMEOUT_S,
                             env=env, cwd=ROOT, preexec_fn=preexec)
        code, stdout, stderr = run.returncode, run.stdout, run.stderr
    except subprocess.TimeoutExpired as e:
        code = "timeout"
        stdout = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        stderr = e.stderr.decode() if isinstance(e.stderr, bytes) else (e.stderr or "")
    lines = stdout.strip().splitlines()
    stages = [ln[len("[stage] "):] for ln in lines if ln.startswith("[stage] ")]
    result = None
    if lines and lines[-1].startswith("{"):
        result = json.loads(lines[-1])
    err = [ln for ln in (stderr + ("\n" + stdout if gdb else "")).splitlines()
           if ln.strip() and "Extension modules" not in ln and "UserWarning" not in ln]
    return {"exit_code": code, "wall_s": time.perf_counter() - tic,
            "last_stage": stages[-1] if stages else None, "stages": stages[-8:],
            "result": result,
            "stderr_tail": err[-40:] if code else err[-3:]}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--one", nargs="+", metavar="DTYPE FMG N CARDS [VARIANT]")
    p.add_argument("--variants", nargs="+", default=["plain"], choices=sorted(VARIANTS))
    p.add_argument("--grids", nargs="+", type=int, default=[64, 256, 512])
    p.add_argument("--cards", nargs="+", type=int, default=[2, 4])
    p.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    p.add_argument("--fmg", nargs="+", type=int, default=[0, 1])
    p.add_argument("--native-stack", action="store_true")
    p.add_argument("--knobs", action="store_true",
                   help="run the first cell that dies again under each of KNOBS")
    p.add_argument("--env", nargs="*", default=[], metavar="KEY=VALUE",
                   help="extra environment of every cell (e.g. CUDA_MODULE_LOADING=EAGER)")
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    a = p.parse_args()
    if a.one:
        dtype, fmg, n, cards = a.one[:4]
        print(json.dumps(one(dtype, bool(int(fmg)), int(n), int(cards), *a.one[4:])),
              flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("mg_across_matrix_torch: needs CUDA cards")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "cards": smi,
           "replays": REPLAYS, "cells": []}
    env = dict(os.environ)
    env.update(kv.split("=", 1) for kv in a.env)
    out["env"] = a.env
    tmp = tempfile.mkdtemp(prefix="mg_across_")
    if a.native_stack:
        lib = _preload_lib(tmp)
        out["native_stack"] = lib is not None
        if lib:
            env["LD_PRELOAD"] = lib
    first_fault = None
    for n in a.grids:
        for cards in a.cards:
            if cards > torch.cuda.device_count():
                continue
            for dtype in a.dtypes:
                for fmg in a.fmg:
                    for variant in a.variants:
                        args = [dtype, str(fmg), str(n), str(cards), variant]
                        cell = {"dtype": dtype, "fmg": bool(fmg), "n": n, "cards": cards,
                                "variant": variant, **_cell(args, env)}
                        out["cells"].append(cell)
                        r = cell["result"] or {}
                        print(f"[cell] {dtype} fmg={bool(fmg)} {n}^3 {cards} cards {variant}: "
                              f"exit {cell['exit_code']}, ok {r.get('ok')}, last stage "
                              f"{cell['last_stage']!r}, {cell['wall_s']:.1f} s", flush=True)
                    if cell["exit_code"] and first_fault is None:
                        first_fault = args
    if first_fault is not None and a.knobs:
        out["knobs"] = {}
        for name, extra in KNOBS.items():
            res = _cell(first_fault, {**env, **(extra or {})},
                        preexec=_unlimited_stack if extra is None else None)
            out["knobs"][name] = {"cell": first_fault, **res}
            print(f"[knob] {name}: exit {res['exit_code']}, last stage {res['last_stage']!r}",
                  flush=True)
    if first_fault is not None and a.native_stack and shutil.which("gdb"):
        out["gdb"] = {"cell": first_fault, **_cell(first_fault, dict(os.environ), gdb=True)}
    shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
