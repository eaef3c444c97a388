#!/usr/bin/env python3
"""The Schäfer–Turek 2D-2 benchmark (Re 100 flow past a cylinder,
Schäfer & Turek 1996) through the PyTorch port on one NVIDIA GPU.

    python scripts/schafer_turek_torch.py [--ny 83] [--t-end 8.0] [--eager] [--out chiprun_out/st]
    python scripts/schafer_turek_torch.py --ny 43 --t-end 6.0 --every 20   # the coarse case
    python scripts/schafer_turek_torch.py --series chiprun_out/st/series_partial.npy

The cell is ``chip_smoke.py``'s ``SchaferTurek`` (the set-up of
``demos/schafer_turek.py``: Box[0:2.2, 0:0.41], a cylinder of d = 0.1 at
(0.2, 0.2), parabolic inflow of peak 1.5, nu 1e-3, dt = 0.2 dy / 2.3,
f64). As the demo: ``config={"sync": False}``, two bootstrap steps
through ``model.run(dt, 2, fused=True)``, then ``every``-step batches of
``model.run_batched(dt, every, diag_fn)`` up to ``t_end`` (``(int(t_end /
dt) - 2) // every * every`` steps; on the card one CUDA graph replay per
step, its solver loops WHILE nodes), each step's diagnostics (staircase
and control-volume forces, the front-rear pressure difference) computed
in the step's graph, kept on the card and fetched at the end
(``--eager``: the same steps eagerly, with the default ``sync``); the
functionals (``chip_smoke.st_functionals``: St from the spectral peak of
the developed half of the CV lift, Cd/Cl maxima, dP half a period after
the lift maximum) come from that series.

Prints, and writes to ``<out>/result.json`` with the series in
``<out>/series.npy`` (the series so far goes to ``series_partial.npy``
eight times during the run): the functionals, the wall of the stepped steps
(ended by a synchronize), cell-steps/s, the card's name and power limit,
and the JAX package's recorded 2D-2 physics (``MEASURE_r5.jsonl``, phase
``schafer_turek_2d2_cv``) beside them with St against the published
[0.295, 0.305] and the others' deviation from that record.

``--series`` post-processes a saved series instead (that of a run cut
short, ``series_partial.npy``; on the host, no card): the same
functionals over the steps it holds, for the grid ``--ny`` names.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ANCHOR_KEYS = ("St", "Cd_max_cv", "Cl_max_cv", "dP_surf")


def _anchor() -> dict | None:
    path = os.path.join(HERE, "MEASURE_r5.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("phase") == "schafer_turek_2d2_cv":
                return rec
    return None


def _with_anchor(res: dict) -> dict:
    anchor = _anchor()
    if anchor is not None and "St" in res:
        res["jax_anchor"] = {k: anchor[k] for k in ANCHOR_KEYS + ("nx", "ny", "steps")}
        res["St_in_published_interval"] = 0.295 <= res["St"] <= 0.305
        res["rel_dev_from_jax_anchor"] = {k: res[k] / anchor[k] - 1.0 for k in ANCHOR_KEYS}
    return res


def _from_series(path: str, ny: int) -> dict:
    import numpy as np

    import chip_smoke

    host = np.load(path)
    dt = 0.2 * (0.41 / (ny - 1)) / 2.3  # SchaferTurek's step
    return _with_anchor({"series": path, "ny": ny, "dt": dt, "steps": len(host) + 2,
                         "t_end": (len(host) + 2) * dt,
                         **chip_smoke.st_functionals(host, dt, 2)})


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ny", type=int, default=83)
    p.add_argument("--t-end", type=float, default=8.0)
    p.add_argument("--every", type=int, default=200, help="steps per batch (the demo's)")
    p.add_argument("--out", default="chiprun_out/schafer_turek")
    p.add_argument("--series", default=None, help="post-process this saved series instead")
    p.add_argument("--eager", action="store_true", help="eager steps instead of the fused runner")
    args = p.parse_args()
    if args.series:
        print(json.dumps(_from_series(args.series, args.ny)))
        return

    import numpy as np
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise RuntimeError("schafer_turek_torch: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    cell = chip_smoke.SchaferTurek(torch.device("cuda"), args.ny,
                                   config=None if args.eager else {"sync": False})
    model = cell.model
    n_batches = (int(args.t_end / cell.dt) - 2) // args.every
    if n_batches < 1:
        raise SystemExit(f"t_end {args.t_end} gives no batch of {args.every} steps")
    tic0 = time.perf_counter()
    model.run(cell.dt, 2, fused=not args.eager)
    torch.cuda.synchronize()
    warm = time.perf_counter() - tic0
    series = []  # per batch: (every, 6) device tensors
    tic = time.perf_counter()
    for i in range(n_batches):
        if args.eager:
            rows = []
            cell.run(args.every, rows)
            series.append(torch.stack(rows))
        else:
            series.append(model.run_batched(cell.dt, args.every,
                                            diag_fn=lambda m: cell.diag()))
        if (i + 1) % max(1, n_batches // 8) == 0:
            # the series so far, kept in case the run is cut (a host read)
            np.save(os.path.join(args.out, "series_partial.npy"),
                    torch.cat(series).cpu().numpy())
            print(f"batch {i + 1}/{n_batches} t={cell.model.t:.3f} "
                  f"(+{time.perf_counter() - tic:.1f} s)", flush=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    host = torch.cat(series).cpu().numpy()  # the one fetch of the run
    steps = n_batches * args.every
    res = {"nx": cell.nx, "ny": cell.ny, "dt": cell.dt, "steps": steps + 2,
           "fused": not args.eager,
           "t_end": cell.model.t, "wall_s": wall, "warm_steps_wall_s": warm,
           "wall_s_per_step": wall / steps, "cell_steps_per_s": cell.nx * cell.ny * steps / wall,
           **chip_smoke.st_functionals(host, cell.dt, 2), "card": smi,
           "flux_in": cell.model.flux(1), "flux_out": cell.model.flux(cell.nx - 2)}
    res = _with_anchor(res)
    np.save(os.path.join(args.out, "series.npy"), host)
    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
