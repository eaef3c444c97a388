"""Count the aten ops that one solve of a placed cell dispatches: a measure
of its host work that does not depend on the host's load (a one-card
placed solve is host-bound, so its wall follows this count).

    python scripts/count_ops_torch.py --root build/parent --cell darcy --n 256 --device cuda:0
    python scripts/count_ops_torch.py --cell mg --n 64 --device cpu --by-function

``--root`` is the checkout whose ``pyapes_tpu_torch`` is imported (default:
this one), e.g. a parent commit unpacked with ``git archive`` under
``build/``. The cells are ``chip_smoke.py``'s (this checkout's file, so both
versions get the same problem): ``darcy`` (``darcy_cfg``) or ``mg`` (bench's
MG-PCG, ``mg_cfg(BENCH_MG)``), the Field whole, the decomposition (4, 2, 1)
placed with every block on ``--device``. One warm-up solve, then one
counted solve (``TorchDispatchMode``: views count too). Prints one line:
the root, the cell, ``itr`` and the count; with ``--by-function`` also the
count per multigrid or Krylov function first met up the caller's stack
(the plain versions' ops on the CPU included in their caller's).
"""

import argparse
import collections
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUNCTIONS = ("set_gamma", "_transfer_axis", "_resize_blocks", "_resize", "_on_level", "fmg",
             "_residual", "_smooth", "_first_smooth", "precond", "_vcycle", "cg_fn", "run")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--cell", choices=("darcy", "mg"), required=True)
    p.add_argument("--n", type=int, required=True, help="nodes per axis")
    p.add_argument("--device", required=True, help="every block's device, e.g. cuda:0 or cpu")
    p.add_argument("--by-function", action="store_true")
    opt = p.parse_args()
    sys.path.insert(0, os.path.abspath(opt.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from pyapes_tpu_torch.parallel import DomainDecomposition
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.ops import Solver

    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            key = "all"
            if opt.by_function:
                f = sys._getframe(1)
                while f is not None and f.f_code.co_name not in FUNCTIONS:
                    f = f.f_back
                key = "other" if f is None else f.f_code.co_name
            counts[key] += 1
            return func(*args, **(kwargs or {}))

    darcy = opt.cell == "darcy"
    dd = DomainDecomposition(cs.N_DECOMP, devices=(opt.device,) * 8)
    cfg = cs.darcy_cfg() if darcy else {k: v for k, v in cs.mg_cfg(cs.BENCH_MG).items()
                                        if k != "donate"}
    mesh, var, rhs, coeff = cs._path_problem(opt.device, opt.n, darcy)
    solver = Solver({"fdm": {"report": False, **cfg, "decomp": dd}})
    fdm = FDM()
    solver.set_eq(fdm.laplacian(coeff, var) == rhs)
    solver.solve()
    var.set_var_tensor(torch.zeros_like(var()))
    solver.set_eq(fdm.laplacian(coeff, var) == rhs)
    with Count():
        rep = solver.solve()
    line = f"{opt.root} {opt.cell} {opt.n}^3 itr {rep['itr']} ops {sum(counts.values())}"
    if opt.by_function:
        line += f" {dict(counts.most_common())}"
    print(line)


if __name__ == "__main__":
    main()
