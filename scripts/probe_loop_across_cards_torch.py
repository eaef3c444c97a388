"""Does the CUDA runtime run a loop whose exit the device decides across
two cards?

Three variants, each in a process of its own (a replay that fails leaves
the CUDA context unusable):

* ``kernel_on_both_cards`` (``probe_loop_across("cuda:0", "cuda:1")``): ONE
  graph captured on card 0 whose WHILE body adds on card 0, copies to card
  1, doubles there and copies back, three passes, then replayed;
* ``peer_copies_only``: the same with the doubling on card 0, so that the
  body's only work on card 1 is the peer copies;
* ``per_card_graphs`` (``probe_per_card_graphs("cuda:0", "cuda:1")``): one
  graph PER CARD, captured at the same time from one thread, each a WHILE
  loop of three passes on its own card's stream; in each pass card 0 adds
  and puts its vector to card 1 (``ops.peer``'s put kernel), card 1 waits,
  doubles and puts it back, and card 0 waits; both graphs launched back to
  back with no host sync between them, twice.

Each must give the host loop's 14. ``per_card_graphs_one_card`` runs the
third on two streams of ``cuda:0`` (a one-card host runs only that one).
``per_card_graphs_large`` and ``per_card_graphs_one_card_large`` put
``LARGE_TOP`` kernels in each graph ahead of its loop, behind a wait for
the other lane's put: launched one after the other from one thread, such a
graph's launch waits for its card, which waits for the other lane's
graph (``scripts/graph_launch_repro.py``); ``GraphedCall`` launches each
lane's graph from a thread of its own.
Prints one JSON line: the torch and CUDA versions, the cards' names and
power limits, and each probe's result (the runtime's error word for word,
the line that raised it, the process's exit code and, where it aborted,
the abort's message).

    python scripts/probe_loop_across_cards_torch.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe_loop_across(dev_a, dev_b, kernel_on_b: bool = True) -> dict:
    """Whether the CUDA runtime takes a WHILE node whose body spans two
    cards: a graph captured on ``dev_a`` whose loop body (3 passes) adds on
    ``dev_a``, copies to ``dev_b``, doubles there (``kernel_on_b``; else
    on ``dev_a`` after a copy back, so the body's only work on ``dev_b`` is
    the peer copies) and copies back, then replayed. ``{"ok": True, ...}``
    when the replay gives the host loop's value (14), else ``{"ok": False,
    "error": ..., "at": ...}``: the runtime's error word for word and the
    probe's line that raised it. Runs on the card only, in a process of its
    own: a replay that fails leaves the CUDA context unusable."""
    import traceback

    import torch

    from pyapes_tpu_torch.ops import graph_loop
    from pyapes_tpu_torch.ops.graph_loop import GraphedCall, while_loop

    a, b = torch.device(dev_a), torch.device(dev_b)
    xa = torch.zeros(4, device=a)
    xb = torch.zeros(4, device=b)
    cnt = torch.zeros((), dtype=torch.int64, device=a)
    sb = torch.cuda.Stream(device=b)
    xb.copy_(xa)  # peer access enabled before the capture
    xa.copy_(xb)
    torch.cuda.synchronize(a)
    torch.cuda.synchronize(b)

    def body():
        # device b's current stream is sb while the body is captured: the
        # cross-device copies' barriers and the doubling join the capture
        with torch.cuda.stream(sb), torch.cuda.stream(torch.cuda.current_stream(a)):
            ev = torch.cuda.Event()
            ev.record()
            sb.wait_event(ev)
            xa.add_(1.0)
            xb.copy_(xa)
            if kernel_on_b:
                with torch.cuda.device(b):
                    xb.mul_(2.0)
                xa.copy_(xb)
            else:
                xa.copy_(xb)
                xa.mul_(2.0)
            cnt.add_(1)

    call = GraphedCall(lambda: while_loop(lambda: cnt < 3, body, a), a)
    try:
        call.capture()
        call.graph.replay()
        torch.cuda.synchronize(a)
        torch.cuda.synchronize(b)
    except Exception as e:  # noqa: BLE001 - the runtime's refusal is the result
        cause = e.__cause__ or e
        tb = [f for f in traceback.extract_tb(cause.__traceback__)
              if f.filename in (__file__, graph_loop.__file__)]
        where = f"{tb[-1].name}: {tb[-1].line}" if tb else None
        return {"ok": False, "error": f"{type(cause).__name__}: {str(cause).splitlines()[0]}",
                "at": where}
    got = xa.cpu().tolist()
    return {"ok": got == [14.0] * 4, "error": None, "value": got}


LARGE_TOP = 20000
"""Kernels ahead of the loop in each graph of the ``_large`` variants."""


def probe_per_card_graphs(dev_a, dev_b, replays: int = 2, top_nodes: int = 0) -> dict:
    """One graph per card (``dev_a``, ``dev_b``; the same card twice: two
    streams of it), captured together from one thread by ``GraphedCall(...,
    lanes=(dev_a, dev_b))``: each a WHILE loop of 3 passes; per pass lane a
    adds one and puts its vector to lane b, lane b waits, doubles and puts
    it back, lane a waits (``ops.peer``); with ``top_nodes``, ahead of the
    loop lane b puts its (zero) vector into lane a's, lane a waits for it,
    and each lane runs ``top_nodes`` kernels that add zero. Both graphs
    launched, ``replays`` times; ``{"ok": True, ...}`` when every replay gives the
    host loop's 14, else the runtime's error and the probe's line that
    raised it, as ``probe_loop_across``."""
    import traceback

    import torch

    from pyapes_tpu_torch.ops import graph_loop, peer
    from pyapes_tpu_torch.ops.graph_loop import GraphedCall, while_loop

    a, b = torch.device(dev_a), torch.device(dev_b)
    xa = torch.zeros(4, device=a)
    xb = torch.zeros(4, device=b)
    cnt = [torch.zeros((), dtype=torch.int64, device=d) for d in (a, b)]
    go = [torch.ones((), dtype=torch.bool, device=d) for d in (a, b)]
    torch.cuda.synchronize(a)
    torch.cuda.synchronize(b)

    def lanes():
        return graph_loop._stack()[-1].current

    def fn():
        for i, (x, s) in enumerate(zip((xa, xb), lanes())):
            with torch.cuda.stream(s):  # each lane resets its own state
                x.zero_()
                cnt[i].zero_()
                go[i].fill_(True)
        if top_nodes:
            sa, sb = lanes()
            first = peer.Channel.make(b, a)
            with torch.cuda.stream(sb):
                peer.peer_put(xb, xa, first)
            with torch.cuda.stream(sa):
                peer.peer_wait(first)
            for x, s in zip((xa, xb), (sa, sb)):
                with torch.cuda.stream(s):
                    for _ in range(top_nodes):
                        x.add_(0.0)

        def body():
            sa, sb = lanes()
            with torch.cuda.stream(sa):
                there = peer.Channel.make(a, b)
                xa.add_(1.0)
                peer.peer_put(xa, xb, there)
                cnt[0].add_(1)
                torch.lt(cnt[0], 3, out=go[0])
            with torch.cuda.stream(sb):
                peer.peer_wait(there)
                xb.mul_(2.0)
                back = peer.Channel.make(b, a)
                peer.peer_put(xb, xa, back)
                cnt[1].add_(1)
                torch.lt(cnt[1], 3, out=go[1])
            with torch.cuda.stream(sa):
                peer.peer_wait(back)

        while_loop(lambda: go, body, a)

    call = GraphedCall(fn, a, lanes=(a, b))
    got = []
    try:
        call.capture()
        for _ in range(replays):
            call.replay()
            torch.cuda.synchronize(a)
            torch.cuda.synchronize(b)
            got.append(xa.cpu().tolist())
    except Exception as e:  # noqa: BLE001 - the runtime's refusal is the result
        cause = e.__cause__ or e
        tb = [f for f in traceback.extract_tb(cause.__traceback__)
              if f.filename in (__file__, graph_loop.__file__)]
        where = f"{tb[-1].name}: {tb[-1].line}" if tb else None
        return {"ok": False, "error": f"{type(cause).__name__}: {str(cause).splitlines()[0]}",
                "at": where}
    return {"ok": all(g == [14.0] * 4 for g in got), "error": None, "value": got,
            "graphs": len(call.graphs), "while_nodes_per_graph": 1, "top_nodes": top_nodes,
            "kernels_per_top_graph": [c["top"]["kernel"] for c in call.census],
            "peer_put_launches": peer.peer_put.launches,
            "peer_wait_launches": peer.peer_wait.launches}


_VARIANTS = {
    "kernel_on_both_cards": lambda: probe_loop_across("cuda:0", "cuda:1", True),
    "peer_copies_only": lambda: probe_loop_across("cuda:0", "cuda:1", False),
    "per_card_graphs": lambda: probe_per_card_graphs("cuda:0", "cuda:1"),
    "per_card_graphs_one_card": lambda: probe_per_card_graphs("cuda:0", "cuda:0"),
    "per_card_graphs_large": lambda: probe_per_card_graphs("cuda:0", "cuda:1",
                                                           top_nodes=LARGE_TOP),
    "per_card_graphs_one_card_large": lambda: probe_per_card_graphs("cuda:0", "cuda:0",
                                                                    top_nodes=LARGE_TOP),
}


def main() -> None:
    import torch

    if len(sys.argv) > 1:  # one probe, in a process of its own
        print(json.dumps(_VARIANTS[sys.argv[1]]()), flush=True)
        return
    if not torch.cuda.is_available():
        sys.exit("probe_loop_across_cards_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "cards": smi.strip().splitlines()}
    variants = list(_VARIANTS) if torch.cuda.device_count() >= 2 else [
        "per_card_graphs_one_card", "per_card_graphs_one_card_large"]
    for variant in variants:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), variant],
                             capture_output=True, text=True, timeout=600)
        lines = run.stdout.strip().splitlines()
        out[variant] = {**(json.loads(lines[-1]) if lines else {"ok": False}),
                        "exit_code": run.returncode}
        if run.returncode:  # the process aborted: the runtime's own words
            out[variant]["aborted"] = [ln.strip() for ln in run.stderr.splitlines()
                                       if "what()" in ln or "CUDA error" in ln][:3]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
