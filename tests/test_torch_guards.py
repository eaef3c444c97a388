"""Guards on the port's boundaries: it never imports JAX, CUDA is never
silently replaced by the CPU (a kernel wrapper given a CUDA tensor
launches or raises), the unported features raise instead of taking
another path, and the CPU path never counts a kernel launch."""
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu_torch.backend import Device  # noqa: E402
from pyapes_tpu_torch.geometry import Box, Cylinder  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops import axis_stencil as axis_mod  # noqa: E402
from pyapes_tpu_torch.ops import jacobi as jacobi_mod  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil  # noqa: E402
from pyapes_tpu_torch.solver import FDM, FDC, Solver  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pyapes_tpu_torch")


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys, pyapes_tpu_torch\n"
        "for m in pkgutil.walk_packages(pyapes_tpu_torch.__path__, 'pyapes_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'pyapes_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+pyapes_tpu\b|from\s+pyapes_tpu[\s.])", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(path)
    assert not offenders


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for alias in ("cuda", "gpu", "cuda:0"):
        with pytest.raises(RuntimeError):
            Device(alias)
    assert Device("cpu").device == torch.device("cpu")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def _field(bc_type="dirichlet"):
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [6, 6, 6], dtype="double")
    return Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, bc_type)})


def _solve(cfg):
    var = _field()
    s = Solver({"fdm": {"method": "fastdiag", "tol": 1e-8, "max_it": 10, **cfg}})
    s.set_eq(FDM().laplacian(1.0, var) == torch.ones(1, 6, 6, 6, dtype=torch.float64))
    return s.solve()


@pytest.mark.parametrize(
    "case",
    ["periodic", "cg", "bicgstab", "decomp", "kernel", "sync", "fd_opts",
     "obstacle", "rz", "var_gamma", "ddt", "grad", "fdc_div", "fdc_apply"],
)
def test_unported_features_raise(case):
    with pytest.raises(NotImplementedError):
        if case == "periodic":
            _field("periodic")
        elif case == "cg":  # the FD preconditioner of the Krylov methods
            _solve({"method": "cg", "precond": "fd"})
        elif case == "bicgstab":  # a Krylov solve on a periodic problem
            var = _field("periodic")
            Solver({"fdm": {"method": "bicgstab", "precond": "mg"}}).set_eq(
                FDM().laplacian(1.0, var) == torch.ones(1, 6, 6, 6, dtype=torch.float64))
        elif case == "decomp":
            _solve({"decomp": {"axes": (0,)}})
        elif case == "kernel":
            _solve({"kernel": "jnp"})
        elif case == "sync":
            _solve({"sync": False})
        elif case == "fd_opts":
            _solve({"fd_opts": {"precision": "default"}})
        elif case == "obstacle":
            Mesh(Box[0:1, 0:1], [Box[0.4:0.6, 0.4:0.6]], [9, 9])
        elif case == "rz":
            Mesh(Cylinder[0:1, 0:1], None, [9, 9])
        elif case == "var_gamma":
            FDM().laplacian(torch.ones(6, 6, 6, dtype=torch.float64), _field())
        elif case == "ddt":
            FDM().ddt(_field())
        elif case == "grad":
            FDM().grad(_field())
        elif case == "fdc_div":
            FDC({"div": {"limiter": "none"}}).div(1.0, _field())
        else:
            FDC({"laplacian": {"edge": False}}).laplacian(_field())


def test_solve_on_cpu_counts_no_launch():
    before = axis_stencil.launches
    rep = _solve({})
    assert rep["converge"] and rep["itr"] >= 1
    assert axis_stencil.launches == before == 0


# (module, wrapper, its plain version, a call with a CUDA "tensor")
_WRAPPERS = {
    "axis_stencil": (axis_mod, "axis_stencil", "apply_axis_stencil", lambda f, t: f((), t)),
    "axis_stencil_dot": (axis_mod, "axis_stencil_dot", "apply_axis_stencil_dot",
                         lambda f, t: f((), t)),
    "jacobi3d": (jacobi_mod, "jacobi3d", "apply_jacobi3d",
                 lambda f, t: f(t, t, (1.0,) * 3, 1.0, 0.1, (0, 1, 2))),
    "jacobi3d_dot": (jacobi_mod, "jacobi3d_dot", "apply_jacobi3d_dot",
                     lambda f, t: f(t, t, (1.0,) * 3, 1.0, 0.1, (0, 1, 2))),
    "jacobi3d_x2": (jacobi_mod, "jacobi3d_x2", "apply_jacobi3d_x2",
                    lambda f, t: f(None, t, (1.0,) * 3, 0.1, (0, 1, 2), from_zero=True)),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_cuda_tensor_never_falls_back_to_plain(name, monkeypatch):
    """With the kernel library unloadable, a CUDA tensor raises: the
    wrapper neither computes the plain result nor counts a launch."""
    mod, fn_name, plain_name, call = _WRAPPERS[name]

    def no_lib():
        raise RuntimeError("kernel library cannot be loaded")

    def plain(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(mod, "_lib", no_lib)
    monkeypatch.setattr(mod, plain_name, plain)
    fn = getattr(mod, fn_name)
    before = fn.launches
    fake_cuda = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="cannot be loaded"):
        call(fn, fake_cuda)
    assert fn.launches == before


def test_mgpcg_on_cpu_counts_no_launch():
    var = _field()
    s = Solver({"fdm": {"method": "cg", "precond": "mg", "tol": 1e-8, "max_it": 50,
                        "criterion": "residual",
                        "mg_opts": {"fmg": True, "fuse_rz": True, "n_post": 1}}})
    s.set_eq(FDM().laplacian(1.0, var) == torch.ones(1, 6, 6, 6, dtype=torch.float64))
    fns = [axis_mod.axis_stencil, axis_mod.axis_stencil_dot, jacobi_mod.jacobi3d,
           jacobi_mod.jacobi3d_dot, jacobi_mod.jacobi3d_x2]
    rep = s.solve()
    assert rep["converge"]
    assert [f.launches for f in fns] == [0] * len(fns)
