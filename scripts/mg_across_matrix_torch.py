"""Bench's MG-PCG as a ``sync: False`` solve across cards, cell by cell:
the cycle's dtype {float32, bfloat16} x its FMG start {off, on} x the grid
{64^3, 128^3, 256^3, 512^3} x the placement {(4, 2, 1) on two cards,
(4, 2, 1) on four, (2, 2, 1) on two}, the blocks round robin over the
cards (four, two and two blocks per card).

A cell is ``chip_smoke.py``'s MG-PCG (``mg_cfg(BENCH_MG)``: CG, V(2,2),
omega 0.857, ``fuse_rz``) with the cell's dtype and FMG start, the Field, the
RHS and the solution on the placement's blocks: one ``sync: True`` solve
(the reference), the first ``sync: False`` solve (its eager warm-up and the
capture of one graph per card), then ``REPLAYS`` replays, each held to the
reference's solution bits, ``itr`` and ``tol``. Before the first replay the
cell prints the census of every card's graphs (``GraphedCall.census``: the
top-level graph, read before its capture ended, and each loop body; nodes by
type, WHILE nodes, the ``ops.peer`` kernels, the longest dependency chain,
nodes of another card's context or memory), so a cell whose launch dies has
its census printed. Each graph launch is announced first, so a fault
inside ``cudaGraphLaunch`` names its card.

Cells run one after another in a worker process (``faulthandler`` on, a
preloaded SIGSEGV handler, built here with ``cc``, printing the fault's
address, the stack pointer and the main thread's stack bounds, then the
native stack); a worker that dies is replaced by a fresh one that goes on
with the next cell. ``--stack-mib N`` sets the workers' stack limit
(``ulimit -s``, a finite size: an unlimited one shrinks every other
thread's stack to glibc's 2 MiB default).

    python scripts/mg_across_matrix_torch.py                  # every cell; needs 4 cards
    python scripts/mg_across_matrix_torch.py --grids 64 128 --placements 421@2 221@2
    python scripts/mg_across_matrix_torch.py --one float32 1 256 421@4   # one cell, here

Prints one line per cell and, last, one JSON line: the torch and CUDA
versions, every card's name and power limit, the workers' stack limit and
every cell's result (exit code of its worker, the last stage reached, the
census, ms per replay, the end of the error stream of a worker that died).
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPLAYS = 3
WORKER_TIMEOUT_S = 1500
PLACEMENTS = {"421@2": ((4, 2, 1), 2), "421@4": ((4, 2, 1), 4), "221@2": ((2, 2, 1), 2)}
"""A placement: the blocks per axis and the cards they go round robin over."""
CENSUS_KEYS = ("kernel", "memcpy", "memset", "conditional", "edges", "longest_chain",
               "peer_puts", "peer_waits", "kernel_functions", "most_blocks",
               "kernel_other_context", "kernel_context_unread", "memcpy_other_device",
               "memcpy_across_devices", "memset_other_device", "wait_event", "event_record",
               "queries_failed")

_SEGV_C = r"""
#define _GNU_SOURCE
#include <execinfo.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <ucontext.h>
#include <unistd.h>
static struct sigaction prev;
static unsigned long stack_lo, stack_hi;
static void on_segv(int sig, siginfo_t *si, void *ctx) {
  void *frames[48];
  char line[256];
  unsigned long sp = 0;
#if defined(__x86_64__)
  sp = (unsigned long)((ucontext_t *)ctx)->uc_mcontext.gregs[REG_RSP];
#endif
  unsigned long addr = si ? (unsigned long)si->si_addr : 0;
  int k = snprintf(line, sizeof line,
                   "native fault: signal %d at address 0x%lx, sp 0x%lx (address - sp %ld), "
                   "main stack [0x%lx, 0x%lx)\n", sig, addr, sp, (long)(addr - sp),
                   stack_lo, stack_hi);
  write(2, line, k);
  int n = backtrace(frames, 48);
  backtrace_symbols_fd(frames, n, 2);
  sigaction(SIGSEGV, &prev, 0);
  raise(sig);
}
__attribute__((constructor)) static void install(void) {
  static char alt[1 << 16];
  stack_t ss;
  ss.ss_sp = alt;
  ss.ss_size = sizeof alt;
  ss.ss_flags = 0;
  sigaltstack(&ss, 0);
  FILE *f = fopen("/proc/self/maps", "r");
  char buf[512];
  while (f && fgets(buf, sizeof buf, f)) {
    if (strstr(buf, "[stack]")) sscanf(buf, "%lx-%lx", &stack_lo, &stack_hi);
  }
  if (f) fclose(f);
  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = on_segv;
  sa.sa_flags = SA_SIGINFO | SA_ONSTACK;
  sigaction(SIGSEGV, &sa, &prev);
}
"""


def _stage(msg: str) -> None:
    print(f"[stage] {msg} @{time.monotonic():.3f}", flush=True)


def _untimed(stage: str) -> str:
    return stage.rsplit(" @", 1)[0]


def _compact(c: dict) -> dict:
    return {k: c[k] for k in CENSUS_KEYS if c.get(k)}


def lane_census(call) -> list:
    """Each lane's census (``GraphedCall.census``) in short: the top-level
    graph's counts, the loop bodies' counts summed (the longest chain and
    the most blocks: their maximum), and the lane's kernel nodes by
    function, top-level and bodies together."""
    out = []
    for lane in call.census:
        bodies: dict = {}
        for b in lane["bodies"]:
            for k in CENSUS_KEYS:
                if k in ("longest_chain", "most_blocks"):
                    bodies[k] = max(bodies.get(k, 0), b[k])
                else:
                    bodies[k] = bodies.get(k, 0) + b[k]
        names: dict = {}
        for c in (lane["top"], *lane["bodies"]):
            for name, n in c["kernels_by_name"].items():
                names[name] = names.get(name, 0) + n
        out.append({"top": _compact(lane["top"]), "bodies": _compact(bodies),
                    "while_nodes": len(lane["bodies"]),
                    "kernels_by_name": dict(sorted(names.items(), key=lambda kv: -kv[1]))})
    return out


def one(dtype: str, fmg: bool, n: int, placement: str) -> dict:
    """One cell, in this process (see the module docstring)."""
    import torch

    import chip_smoke as cs
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.linalg import dispatch
    from pyapes_tpu_torch.solver.ops import Solver

    real_replay = torch.cuda.CUDAGraph.replay

    def announced(graph):
        _stage(f"launch a graph on cuda:{torch.cuda.current_device()}")
        return real_replay(graph)

    torch.cuda.CUDAGraph.replay = announced
    ms, n_cards = PLACEMENTS[placement]
    n_blocks = ms[0] * ms[1] * ms[2]
    dev = torch.device("cuda:0")
    cards = [f"cuda:{i}" for i in range(n_cards)]
    dd = DomainDecomposition(ms, devices=tuple(cards[i % n_cards] for i in range(n_blocks)))
    opts = {**cs.BENCH_MG, "dtype": dtype, "fmg": fmg}
    cfg = {k: v for k, v in cs.mg_cfg(opts).items() if k != "donate"}
    cfg["decomp"] = dd
    _stage(f"problem {n}^3, {ms} on {cards}, {dtype}, fmg {fmg}")
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

    out = {"dtype": dtype, "fmg": fmg, "n": n, "placement": placement, "mesh": list(ms),
           "cards": n_cards, "blocks_per_card": n_blocks // n_cards, "walls_s": {}}
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
    out["transfers_across_captured"] = blocks.transfers_across - t0
    out["reserved_gib_per_card_after_capture"] = [torch.cuda.memory_reserved(c) / 2**30
                                                  for c in cards]
    out["census"] = lane_census(call)
    _stage("census " + json.dumps([{k: v for k, v in c.items() if k != "kernels_by_name"}
                                   for c in out["census"]]))
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
    out["ms_per_replay"] = [1e3 * w for w in walls]
    out["peak_gib_per_card"] = [torch.cuda.max_memory_allocated(c) / 2**30 for c in cards]
    out["ok"] = all(same) and all(tols) and itrs == [ref_rep["itr"]] * REPLAYS
    del solvers, var, rhs, coeff, call
    dispatch.clear_cache()
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda.empty_cache()
    torch.cuda.CUDAGraph.replay = real_replay
    return out


def _worker(specs: list) -> None:
    """Run ``specs`` (``dtype,fmg,n,placement``) one after another in this
    process, one ``[cell] {json}`` line each."""
    import chip_smoke as cs

    cs.phase_build()
    for spec in specs:
        dtype, fmg, n, placement = spec.split(",")
        _stage(f"cell {spec}")
        print("[cell] " + json.dumps(one(dtype, bool(int(fmg)), int(n), placement)), flush=True)


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


def _stack_limit(mib: int | None):
    """A ``preexec_fn`` setting the stack limit to ``mib`` MiB (None: as it is)."""
    if mib is None:
        return None

    def set_limit():
        hard = resource.getrlimit(resource.RLIMIT_STACK)[1]
        want = mib << 20
        if hard != resource.RLIM_INFINITY and want > hard:
            want = hard
        resource.setrlimit(resource.RLIMIT_STACK, (want, hard))

    return set_limit


def _run_workers(specs: list, env: dict, stack_mib: int | None) -> list:
    """Every cell of ``specs`` through workers; a worker that dies costs the
    cell it was in, and a fresh one takes the rest."""
    cells, todo = [], list(specs)
    while todo:
        cmd = [sys.executable, "-X", "faulthandler", os.path.abspath(__file__), "--worker", *todo]
        tic = time.perf_counter()
        try:
            run = subprocess.run(cmd, capture_output=True, text=True, timeout=WORKER_TIMEOUT_S,
                                 env=env, cwd=ROOT, preexec_fn=_stack_limit(stack_mib))
            code, stdout, stderr = run.returncode, run.stdout, run.stderr
        except subprocess.TimeoutExpired as e:
            code = "timeout"
            stdout = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
            stderr = e.stderr.decode() if isinstance(e.stderr, bytes) else (e.stderr or "")
        end = time.monotonic()
        current, stages = None, []
        for ln in stdout.splitlines():
            if ln.startswith("[stage] cell "):
                current, stages = _untimed(ln[len("[stage] cell "):]), []
            elif ln.startswith("[stage] "):
                stages.append(ln[len("[stage] "):])
            elif ln.startswith("[cell] "):
                cells.append({"spec": current, "exit_code": 0, "result": json.loads(ln[7:]),
                              "last_stage": _untimed(stages[-1]) if stages else None})
                print(f"[cell] {current}: ok {cells[-1]['result']['ok']}, ms per replay "
                      f"{cells[-1]['result']['ms_per_replay']}", flush=True)
                todo.remove(current)
                current = None
        if current is not None or code:
            err = [ln for ln in stderr.splitlines()
                   if ln.strip() and "Extension modules" not in ln and "UserWarning" not in ln]
            census = [s for s in stages if s.startswith("census ")]
            last = stages[-1] if stages else None
            cells.append({"spec": current, "exit_code": code, "result": None,
                          "last_stage": _untimed(last) if last else None,
                          # the seconds from the last stage to the worker's end
                          "died_after_s": end - float(last.rsplit(" @", 1)[1]) if last else None,
                          "census": json.loads(_untimed(census[-1])[7:]) if census else None,
                          "worker_s": time.perf_counter() - tic,
                          "native_fault": [ln for ln in err if ln.startswith("native fault")],
                          "stderr_tail": err[-30:]})
            print(f"[cell] {current}: worker exit {code}, last stage "
                  f"{cells[-1]['last_stage']!r}", flush=True)
            if current is None:  # died before any cell: nothing left to learn from the rest
                break
            todo.remove(current)
    return cells


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--one", nargs=4, metavar=("DTYPE", "FMG", "N", "PLACEMENT"))
    p.add_argument("--worker", nargs="+", metavar="DTYPE,FMG,N,PLACEMENT")
    p.add_argument("--grids", nargs="+", type=int, default=[64, 128, 256, 512])
    p.add_argument("--placements", nargs="+", default=list(PLACEMENTS), choices=list(PLACEMENTS))
    p.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    p.add_argument("--fmg", nargs="+", type=int, default=[0, 1])
    p.add_argument("--stack-mib", type=int, default=None,
                   help="the workers' stack limit in MiB (ulimit -s; default: as inherited)")
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    a = p.parse_args()
    if a.worker:
        _worker(a.worker)
        return
    if a.one:
        import chip_smoke as cs

        cs.phase_build()
        dtype, fmg, n, placement = a.one
        print(json.dumps(one(dtype, bool(int(fmg)), int(n), placement)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("mg_across_matrix_torch: needs CUDA cards")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    n_cards = torch.cuda.device_count()
    specs = [f"{dtype},{fmg},{n},{pl}" for pl in a.placements if PLACEMENTS[pl][1] <= n_cards
             for n in a.grids for dtype in a.dtypes for fmg in a.fmg]
    env = dict(os.environ)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "cards": smi,
           "replays": REPLAYS, "stack_mib": a.stack_mib,
           "stack_limit_here": resource.getrlimit(resource.RLIMIT_STACK)}
    tmp = tempfile.mkdtemp(prefix="mg_across_")
    lib = _preload_lib(tmp)
    out["native_stack"] = lib is not None
    if lib:
        env["LD_PRELOAD"] = lib
    tic = time.perf_counter()
    out["cells"] = _run_workers(specs, env, a.stack_mib)
    out["wall_s"] = time.perf_counter() - tic
    shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
