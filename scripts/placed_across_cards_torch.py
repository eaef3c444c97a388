"""Phase 17's placed cases across cards, alone: ``chip_smoke.py``'s (p)
(``placed_graphs_across``: the probe of a WHILE body across cards, the
``sync: False`` solves as one graph per card, bench's bf16 V(2,2) FMG
MG-PCG among them, and the fused TGV-3D LES 257^3 as one graph per card
per step, its state whole and on the blocks) and then (q) and (r)'s eager
run with the blocks round robin over four cards (``options_across``). (r)
is held to (o)'s whole-state eager run of the same ``TORUS_STEPS`` steps,
made here on one card first. Prints each case's line and, last, one JSON
line of the results with every card's name and power limit.

    python scripts/placed_across_cards_torch.py           # needs four cards
    python scripts/placed_across_cards_torch.py --only-p  # (p) alone
"""
from __future__ import annotations

import json
import os
import sys
import time
from math import pi

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def whole_state_reference(cs, dev) -> dict:
    """(o)'s eager placed LES (``tgv_model`` at ``TGV_RUNG``^3 f32, solves
    on ``("cuda:0",) * 8``, the state whole) after ``TORUS_STEPS`` steps: the
    reference ``options_across`` reads (⟨E⟩, the card's peak, the wall)."""
    import torch

    model, dt = cs.tgv_model(dev, cs.TGV_RUNG, config={"decomp": cs._one_card_dd()})
    torch.cuda.reset_peak_memory_stats()
    model.run(dt, cs.GRAPH_WARM)
    cs._sync_all()
    tic = time.perf_counter()
    for _ in range(cs.TORUS_STEPS - cs.GRAPH_WARM):
        model.step(dt)
    cs._sync_all()
    wall = (time.perf_counter() - tic) / (cs.TORUS_STEPS - cs.GRAPH_WARM)
    out = {"E_mean": {"eager_placed": float(model.kinetic_energy()) / (2 * pi) ** 3},
           "peak_gib_card0": {"eager_placed": torch.cuda.max_memory_allocated() / 2**30},
           "wall_s_per_step_median": {"eager_placed": wall}}
    del model
    torch.cuda.empty_cache()
    return out


def main() -> None:
    import chip_smoke as cs

    dev, _ = cs.phase_device()
    cs.phase_build()
    out = {"cards": cs._card_line(), "p": cs.placed_graphs_across(dev)}
    if "--only-p" in sys.argv[1:]:
        print(json.dumps(out), flush=True)
        return
    out["o_ref"] = whole_state_reference(cs, dev)
    out["across"] = cs.options_across(dev, {}, out["o_ref"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
