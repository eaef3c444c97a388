"""``ChannelFlow`` and the channel path of the port against the JAX package
(CPU, float64).

(a) The cylinder channel of ``tests/test_obstacle.py`` (97 x 33, a
    ``MaskObstacle`` circle) for 40 eager steps with the default config
    (both packages resolve it alike: plain BiCGSTAB momentum, BiCGSTAB
    with the plain-domain V-cycle for the pressure), and the same channel
    without a body under ``config={"method": "bicgstab", "precond":
    None}`` (the default would take fastdiag in the port and the JAX
    package's Krylov fallback): the same ``itr`` on every solve and the
    fields within 1e-8.
(b) A mid-run state carried over (``model_state_from_numpy``, ``dp``
    included) steps on with the same solves.
(c) The ``channel`` runner, with and without ``--obstacle``, through a
    subprocess on the CPU, against the JAX runner's numbers.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu import runner as jrunner  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.geometry import MaskObstacle as JMaskObstacle  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.models import ChannelFlow as JChannelFlow  # noqa: E402
from pyapes_tpu_torch.geometry import Box, MaskObstacle  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models import ChannelFlow  # noqa: E402
from pyapes_tpu_torch.utils.carry import model_state_from_numpy  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CYL = lambda X, Y: (X - 0.7) ** 2 + (Y - 0.5) ** 2 < 0.12**2  # noqa: E731
KRYLOV = {"method": "bicgstab", "precond": None}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _record_itr(model, out: list) -> None:
    for solver in (model.mom_solver, model.p_solver):
        real = solver.solve

        def solve(real=real):
            rep = real()
            out.append(rep["itr"])
            return rep

        solver.solve = solve


def _channels(body: bool, config=None):
    nx = [97, 33]
    jm = JMesh(JBox[0:3, 0:1], [JMaskObstacle(CYL)] if body else None, nx, dtype="double")
    pm = Mesh(Box[0:3, 0:1], [MaskObstacle(CYL)] if body else None, nx, device="cpu",
              dtype="double")
    return (JChannelFlow(jm, nu=0.02, u_in=1.0, config=config),
            ChannelFlow(pm, nu=0.02, u_in=1.0, config=config))


def _assert_fields(jmod, pmod, tol):
    for a, b in zip(jmod.state_fields(), pmod.state_fields()):
        assert np.abs(np.asarray(a()) - _np(b())).max() < tol, a.name


@pytest.mark.parametrize("case", ["cylinder", "no_body"])
def test_channel_same_solves_as_jax(case):
    """40 eager steps: the solver choice, every solve's ``itr`` and the
    fields within 1e-8; the flux balance and no slip in the body."""
    jmod, pmod = _channels(case == "cylinder", None if case == "cylinder" else KRYLOV)
    assert pmod.mom_solver.config == jmod.mom_solver.config
    assert pmod.p_solver.config == jmod.p_solver.config
    if case == "cylinder":
        assert pmod.p_solver.config["fdm"]["method"] == "bicgstab"
        assert pmod.p_solver.config["fdm"]["precond"] == "mg"
    ji, pi = [], []
    _record_itr(jmod, ji)
    _record_itr(pmod, pi)
    jmod.run(dt=0.005, n_steps=40)
    pmod.run(dt=0.005, n_steps=40)
    assert len(pi) == 120 and pi == ji
    _assert_fields(jmod, pmod, 1e-8)
    assert abs(pmod.flux(0) - jmod.flux(0)) < 1e-10
    assert abs(pmod.flux(-1) - jmod.flux(-1)) < 1e-8
    if case == "cylinder":
        body = pmod.mesh.obstacle_body_masks[0]
        assert np.abs(_np(pmod.u()[0])[body]).max() < 1e-12
        assert np.abs(pmod.body_force() - jmod.body_force()).max() < 1e-8


def test_carried_channel_state_steps_on_alike():
    """The JAX model's mid-run state, ``dp`` included, loaded into the port
    (``model_state_from_numpy``): the next steps take the same solves."""
    jmod, pmod = _channels(True)
    jmod.run(dt=0.005, n_steps=6)
    states = [(np.asarray(f()), np.asarray(f.VARo)) for f in jmod.state_fields()]
    assert [f.name for f in pmod.state_fields()] == ["u", "v", "p", "dp"]
    model_state_from_numpy(pmod, states, t=jmod.t)
    for pf in pmod.vel:
        pf.set_time(0.005, jmod.t)
    ji, pi = [], []
    _record_itr(jmod, ji)
    _record_itr(pmod, pi)
    jmod.run(dt=0.005, n_steps=3)
    pmod.run(dt=0.005, n_steps=3)
    assert pi == ji
    _assert_fields(jmod, pmod, 1e-8)


@pytest.mark.parametrize("obstacle", [False, True])
def test_runner_channel_matches_jax(obstacle):
    argv = ["channel", "--n", "25", "--steps", "10", "--dtype", "double"]
    argv += ["--obstacle"] if obstacle else []
    out = subprocess.run([sys.executable, "-m", "pyapes_tpu_torch.runner", *argv,
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    ours = json.loads(out.stdout.strip().splitlines()[-1])
    args = argparse.Namespace(n=25, dtype="double", nu=0.05, dt=0.005, steps=10,
                              obstacle=obstacle, vtk=None, save=None, resume=None)
    theirs = jrunner._run_channel(args)
    assert ours["steps"] == theirs["steps"] == 10 and ours["wall_s"] > 0
    keys = ["flux_in", "flux_out", "u_max"] + (["drag", "lift"] if obstacle else [])
    assert set(ours) == set(theirs)
    for k in keys:
        # the obstacle-free channel: the port's fastdiag against the JAX
        # package's Krylov fallback, within the solves' tolerance
        assert abs(ours[k] - theirs[k]) < (1e-8 if obstacle else 2e-6), (k, ours[k], theirs[k])
