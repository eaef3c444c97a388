"""The Schäfer–Turek 2D-2 cell of the port against the JAX demo (CPU,
float64): the SMOKE configuration of ``demos/schafer_turek.py`` (ny = 21,
t_end 0.2, the diagnostics of every step after two warm steps), stepped
eagerly in both packages (the port's cell is ``chip_smoke.SchaferTurek``,
which ``scripts/schafer_turek_torch.py`` and ``chip_smoke.py``'s phase 12
drive on the card): the staircase and control-volume force series and the
pressure differences within 1e-8, the flux balance in against out (the
scheme's own imbalance, the same in both packages) and the demo's
functionals of the two series alike."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.geometry import MaskObstacle as JMaskObstacle  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.models import ChannelFlow as JChannelFlow  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401


def _jax_smoke_series(ny: int, steps: int):
    """The demo's set-up and per-step diagnostics in the JAX package,
    stepped eagerly (the demo's fused batches compute the same steps), and
    the last step's flux through the inflow and outflow planes."""
    d, um, nu = 0.1, 1.5, 0.001
    dy = 0.41 / (ny - 1)
    nx = int(round(2.2 / dy)) + 1
    body = JMaskObstacle(lambda X, Y: (X - 0.2) ** 2 + (Y - 0.2) ** 2 < (d / 2) ** 2)
    model = JChannelFlow(JMesh(JBox[0:2.2, 0:0.41], [body], [nx, ny]), nu=nu, u_in=um)
    dt = 0.2 * dy / 2.3
    ia, ib, jc = (int(round(v / dy)) for v in (0.15, 0.25, 0.20))
    model.run(dt, 2)
    rows = []
    for _ in range(steps):
        model.step(dt)
        p = np.asarray(model.p()[0])
        rows.append(np.concatenate([
            np.asarray(model.body_force_device()), np.asarray(model.body_force_cv_device(margin=6)),
            [p[ia, jc] - p[ib, jc],
             (3.0 * p[ia - 1, jc] - 3.0 * p[ia - 2, jc] + p[ia - 3, jc])
             - (3.0 * p[ib + 1, jc] - 3.0 * p[ib + 2, jc] + p[ib + 3, jc])]]))
    return np.asarray(rows), dt, (model.flux(0), model.flux(-1))


def test_schafer_turek_smoke_force_series():
    """The demo's SMOKE configuration (ny = 21, t_end 0.2, ``every`` 5):
    the diagnostics of its 110 steps after the two warm ones."""
    ny, every = 21, 5
    cell = chip_smoke.SchaferTurek(torch.device("cpu"), ny)
    steps = (int(0.2 / cell.dt) - 2) // every * every
    assert (cell.nx, steps) == (108, 110)
    jrows, jdt, jflux = _jax_smoke_series(ny, steps)
    assert jdt == cell.dt
    cell.run(2)
    series = []
    cell.run(steps, series)
    prows = torch.stack(series).numpy()
    assert prows.shape == jrows.shape == (steps, 6)
    assert np.isfinite(prows).all()
    assert np.abs(prows - jrows).max() < 1e-8, np.abs(prows - jrows).max(axis=0)
    # the flux imbalance is the discrete scheme's, not the port's: the
    # same in and out fluxes as the JAX package's
    pflux = (cell.model.flux(0), cell.model.flux(-1))
    assert np.abs(np.subtract(pflux, jflux)).max() < 1e-10, (pflux, jflux)
    assert abs(pflux[0] - pflux[1]) / pflux[0] == pytest.approx(
        abs(jflux[0] - jflux[1]) / jflux[0], abs=1e-9)
    # the demo's post-processing of the two series alike
    pf, jf = (chip_smoke.st_functionals(r, cell.dt, 2) for r in (prows, jrows))
    assert set(pf) == set(jf)
    for k in pf:
        assert abs(pf[k] - jf[k]) <= 1e-6 * max(1.0, abs(jf[k])), (k, pf[k], jf[k])
