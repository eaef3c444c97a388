#!/usr/bin/env python3
"""Lid-driven cavity with an immersed no-slip square body through the
PyTorch port (the port of ``demos/cavity_obstacle.py``); writes a VTK
file for ParaView with ``utils/io.py``'s ``write_vtk`` and reads it back.

    python scripts/cavity_obstacle_torch.py [--out cavity_obstacle] [--device cpu]

The demo's set-up: 65^2 nodes, the body [0.4, 0.6] x [0.55, 0.75], nu
0.01, unit lid, dt 0.01, 300 eager steps. Gates: no slip on the body
(max |u| there below 1e-12), a finite flow outside it, and the VTK file
holding u, v, p and the speed equal to the fields in f32.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adjoint_inverse_source_torch import card_line  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="cavity_obstacle", help="VTK path prefix")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card_line(args.device)

    import numpy as np
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import LidDrivenCavity
    from pyapes_tpu_torch.utils.io import read_vtk, write_vtk

    mesh = Mesh(Box[0:1, 0:1], [Box[0.4:0.6, 0.55:0.75]], [65, 65], device=args.device,
                dtype="double")
    model = LidDrivenCavity(mesh, nu=0.01, lid_velocity=1.0)
    model.run(dt=0.01, n_steps=300)

    u, v = model.u()[0], model.v()[0]
    body = torch.as_tensor(mesh.obstacle_body_masks[0], device=u.device)
    out_max = float(u[~body].abs().max())
    body_max = float(u[body].abs().max())
    print(f"t = {float(model.t):.2f}")
    print(f"max |u| outside body: {out_max:.4f}")
    print(f"max |u| on body (no-slip): {body_max:.2e}")
    fields = {"u": u, "v": v, "p": model.p()[0], "speed": torch.sqrt(u**2 + v**2)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    path = write_vtk(args.out, mesh, fields)
    back = read_vtk(path)
    for name, f in fields.items():
        want = f.to(torch.float32).cpu().numpy()
        assert np.array_equal(back["fields"][name].reshape(want.shape), want), name
    print(f"wrote {path} (open in ParaView); read back equal in f32")
    assert body_max < 1e-12 and np.isfinite(out_max) and out_max > 0.1, (body_max, out_max)
    print("OK")


if __name__ == "__main__":
    main()
