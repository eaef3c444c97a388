"""Does the CUDA runtime take a WHILE node whose body spans two cards?

Runs ``probe_loop_across("cuda:0", "cuda:1")``: a graph
captured on card 0 whose device-ended loop adds on card 0, copies to card
1, doubles there and copies back, three passes, then replayed; and the
same with the doubling on card 0, so that the body's only work on card 1
is the peer copies. Each probe runs in a process of its own: a replay that
fails leaves the CUDA context unusable. Prints one JSON line: the torch
and CUDA versions, the cards' names and power limits, and each probe's
result (the runtime's error word for word, the line that raised it, the
process's exit code and, where it aborted, the abort's message).

    python scripts/probe_loop_across_cards_torch.py    # needs two cards
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


def main() -> None:
    import torch

    if len(sys.argv) > 1:  # one probe, in a process of its own
        kernel_on_b = sys.argv[1] == "kernel_on_both_cards"
        print(json.dumps(probe_loop_across("cuda:0", "cuda:1", kernel_on_b)), flush=True)
        return
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        sys.exit("probe_loop_across_cards_torch: needs two CUDA cards")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "cards": smi.strip().splitlines()}
    for variant in ("kernel_on_both_cards", "peer_copies_only"):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), variant],
                             capture_output=True, text=True)
        lines = run.stdout.strip().splitlines()
        out[variant] = {**(json.loads(lines[-1]) if lines else {"ok": False}),
                        "exit_code": run.returncode}
        if run.returncode:  # the process aborted: the runtime's own words
            out[variant]["aborted"] = [ln.strip() for ln in run.stderr.splitlines()
                                       if "what()" in ln or "CUDA error" in ln][:3]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
