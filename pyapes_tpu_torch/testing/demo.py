"""Shared pieces of the demo port scripts (``scripts/*_torch.py``): the
card's name and power limit, the gate check with the one-line JSON result,
and the optional plotting module."""
from __future__ import annotations

import json
import subprocess


def card(device: str):
    """The card's name and power limit as ``nvidia-smi`` gives them, printed
    (None on the CPU)."""
    if str(device) == "cpu":
        return None
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(line, flush=True)
    return line


def finish(name: str, out: dict, as_json: bool) -> dict:
    """Set ``out["ok"]`` from the gates in ``out["gate"]`` (name -> bool),
    print the result as one JSON line (``as_json``) and raise
    ``SystemExit`` when a gate is missed; returns ``out``."""
    out["gate"] = {k: bool(v) for k, v in out["gate"].items()}
    out["ok"] = all(out["gate"].values())
    if as_json:  # numpy and 0-d torch scalars by value
        print(json.dumps(out, default=lambda o: o.item()), flush=True)
    if not out["ok"]:
        raise SystemExit(f"{name}: gate missed: {out['gate']}")
    print(f"{name}: gates met", flush=True)
    return out


def pyplot():
    """matplotlib's pyplot (non-interactive), or None when matplotlib is
    not installed: plotting is optional."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("--plot: matplotlib is not installed; no plot written")
        return None
    return plt
