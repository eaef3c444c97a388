"""Build and run ``graph_launch_repro.cu`` (graphs per card with a WHILE
node and N kernel nodes, on the CUDA runtime alone) over a ladder of
sizes, each run a process of its own: does the runtime's launch of such
graphs fail past some size, whatever the port captures?

For each card count, the ladder grows the top-level graph's kernel nodes
(``--top``) with the loop body fixed (``--body``), then the body with the
top-level fixed at its first rung; a ladder stops at its first run that
fails. ``--pairs`` put/wait pairs per 1,000 kernel nodes, as many in the
body as at the top level; the ladder launches the cards' graphs one after
another from one thread, with the WHILE node. ``--runs`` names runs one by
one instead, each
``lanes,top,top_pairs,body,body_pairs,threads,with_while[,devices]``: lane
``d`` on card ``d % devices`` (default: a card per lane; ``devices`` 1:
every lane a stream of one card; threads 1: each lane's graph launched
from a thread of its own; with_while 0: no WHILE node). A wait traps
after ``--wait-s`` seconds of spinning; each run's wall is recorded, so a
fault that follows the trap shows as a wall past it.

    python scripts/graph_launch_repro.py                       # needs 2 or 4 cards
    python scripts/graph_launch_repro.py --runs 2,10000,0,1000,0,0,1 2,10000,50,1000,5,0,1,1

Prints one line per run and, last, one JSON line: the cards' names and
power limits, the build, and every run (its arguments, exit code and last
lines).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().with_suffix(".cu")
BUILD = ROOT / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O2")


def build() -> Path:
    """The executable, built by ``nvcc`` into ``build/`` (keyed by the
    source's hash)."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    exe = BUILD / f"graph_launch_repro_{key}"
    if not exe.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([nvcc, *FLAGS, "-o", str(tmp), str(SRC)], check=True)
        os.replace(tmp, exe)
    return exe


def run(exe: Path, cards: int, top: int, top_pairs: int, body: int, body_pairs: int,
        threads: bool, with_while: bool, a, devices: int | None = None) -> dict:
    devices = devices or cards
    args = [cards, top, top_pairs, body, body_pairs, a.passes, a.replays, int(threads),
            int(with_while), a.wait_s, devices]
    tic = time.perf_counter()
    try:
        p = subprocess.run([str(exe), *map(str, args)], capture_output=True, text=True,
                           timeout=600)
        code, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        code, out, err = "timeout", str(e.stdout or ""), str(e.stderr or "")
    lines = out.strip().splitlines()
    ok = code == 0 and bool(lines) and lines[-1].startswith("ok")
    res = {"lanes": cards, "devices": devices, "top": top, "top_pairs": top_pairs, "body": body,
           "body_pairs": body_pairs, "threads": threads, "with_while": with_while,
           "wait_s": a.wait_s, "exit_code": code, "ok": ok,
           "wall_s": time.perf_counter() - tic, "out": lines[-2:],
           "err_tail": err.strip().splitlines()[-2:]}
    print(f"[run] {json.dumps(res)}", flush=True)
    return res


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", nargs="+", type=int, default=[2, 4])
    p.add_argument("--top", nargs="+", type=int, default=[1000, 10000, 30000, 100000, 300000])
    p.add_argument("--body", nargs="+", type=int, default=[1000, 10000, 30000, 100000])
    p.add_argument("--pairs", type=float, default=5.0, help="put/wait pairs per 1,000 nodes")
    p.add_argument("--passes", type=int, default=3)
    p.add_argument("--replays", type=int, default=2)
    p.add_argument("--wait-s", type=float, default=10.0)
    p.add_argument("--runs", nargs="+", default=None,
                   metavar="LANES,TOP,TOP_PAIRS,BODY,BODY_PAIRS,THREADS,WITH_WHILE[,DEVICES]")
    a = p.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    exe = build()
    out = {"cards_seen": smi, "exe": exe.name, "runs": []}
    if a.runs:
        for spec in a.runs:
            c, top, tp, body, bp, th, wh, *dv = (int(v) for v in spec.split(","))
            devices = dv[0] if dv else c
            if devices <= len(smi):
                out["runs"].append(run(exe, c, top, tp, body, bp, bool(th), bool(wh), a,
                                       devices))
        print(json.dumps(out), flush=True)
        return

    def ladder_run(cards, top, body):
        return run(exe, cards, top, int(top * a.pairs / 1000), body, int(body * a.pairs / 1000),
                   False, True, a)

    for cards in a.cards:
        if cards > len(smi):
            continue
        for top in a.top:  # the top-level graph grows, the body fixed
            r = ladder_run(cards, top, a.body[0])
            out["runs"].append(r)
            if not r["ok"]:
                break
        for body in a.body[1:]:  # the body grows, the top-level fixed
            r = ladder_run(cards, a.top[0], body)
            out["runs"].append(r)
            if not r["ok"]:
                break
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
