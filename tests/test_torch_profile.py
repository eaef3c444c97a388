"""``utils/profile.py`` and the small surface ported last
(``backend.local_device_count`` / ``default_backend``,
``mesh.tools.interior_mask``, ``ops.stencil.estimate_stencil_bytes``) on
the CPU, against the JAX package where the arithmetic is shared: the
roofline numbers are equal for the same ``hbm_gbps`` (1e-15 relative).
"""
import glob
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu import backend as jbackend  # noqa: E402
from pyapes_tpu.mesh import tools as jtools  # noqa: E402
from pyapes_tpu.ops import stencil as jstencil  # noqa: E402
from pyapes_tpu.utils import profile as jprofile  # noqa: E402
from pyapes_tpu_torch import backend  # noqa: E402
from pyapes_tpu_torch.mesh import tools  # noqa: E402
from pyapes_tpu_torch.ops import stencil  # noqa: E402
from pyapes_tpu_torch.utils import profile  # noqa: E402

SHAPES = [(512, 512, 512), (257, 257, 257), (129, 65), (1001,)]


@pytest.mark.parametrize("nx", SHAPES)
@pytest.mark.parametrize("dtype_bytes, hbm", [(4, 819.0), (8, 3350.0), (2, 2039.0)])
def test_roofline_numbers_equal_jax(nx, dtype_bytes, hbm):
    """``stencil_roofline`` and ``bandwidth_report`` (with and without the
    achievable rate) equal the JAX package's for the same ``hbm_gbps``."""
    assert profile.stencil_roofline(nx, dtype_bytes, hbm) == pytest.approx(
        jprofile.stencil_roofline(nx, dtype_bytes, hbm), rel=1e-15)
    for ach in (None, 2900.0):
        got = profile.bandwidth_report(nx, 1.7e-3, dtype_bytes, hbm, ach)
        want = jprofile.bandwidth_report(nx, 1.7e-3, dtype_bytes, hbm, ach)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-15)
    assert stencil.estimate_stencil_bytes(nx, dtype_bytes) == jstencil.estimate_stencil_bytes(
        nx, dtype_bytes)


def test_defaults_are_the_h100():
    """The defaults are the NVIDIA H100 80GB HBM3's 3350 GB/s, the figure
    behind the bounds of PERF.md section 6."""
    assert profile.H100_HBM_GBPS == 3350.0
    nx = (512, 512, 512)
    assert profile.stencil_roofline(nx) == 2 * 512**3 * 4 / 3.35e12
    assert profile.bandwidth_report(nx, 1e-3)["roofline_fraction"] == pytest.approx(
        2 * 512**3 * 4 / 1e-3 / 3.35e12, rel=1e-15)


def test_solve_timer():
    """The region's wall, the region itself synchronized (a no-op without a
    CUDA context)."""
    with profile.SolveTimer() as t:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed < 5.0


def test_trace_writes_a_chrome_trace(tmp_path):
    """A CPU trace writes one Chrome trace into ``logdir`` that names the
    operators run inside it; the yielded profiler has their averages."""
    logdir = str(tmp_path / "trace")
    x = torch.ones(64, 64)
    with profile.trace(logdir) as prof:
        torch.matmul(x, x)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_measure_achievable_bw_on_the_cpu():
    """On a host without CUDA it times the CPU's copy-scale: a positive
    rate (GB/s), from the same 2 n^3 * 4 bytes per pass."""
    bw = profile.measure_achievable_bw(n=32, reps=3)
    assert isinstance(bw, float) and bw > 0


def test_backend_surface():
    """``default_backend`` is "gpu" with CUDA, else "cpu" (the JAX
    package's name on this host too); ``local_device_count`` the CUDA
    devices."""
    assert backend.local_device_count() == torch.cuda.device_count()
    if not torch.cuda.is_available():
        assert backend.default_backend() == jbackend.default_backend() == "cpu"
    else:
        assert backend.default_backend() == "gpu"


@pytest.mark.parametrize("nx, slicer", [
    ((6,), (slice(1, -1),)),
    ((5, 7), (slice(1, -1), slice(None, -1))),
    ((4, 5, 6), (slice(1, None), slice(1, -1), slice(None))),
])
def test_interior_mask_equals_jax(nx, slicer):
    """The host mask equals the JAX package's and the device mask."""
    m = tools.interior_mask(nx, slicer)
    assert m.dtype == np.float64
    assert np.array_equal(m, np.asarray(jtools.interior_mask(nx, slicer)))
    assert np.array_equal(
        m, tools.interior_mask_device(nx, slicer, torch.float64, "cpu").numpy())
