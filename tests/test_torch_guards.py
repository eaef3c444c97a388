"""Guards on the port's boundaries: it never imports JAX (every module,
``utils/debug.py`` and ``utils/profile.py`` among them), CUDA is never
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
from pyapes_tpu_torch.geometry import Box, Cylinder, MaskObstacle  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.models import ChannelFlow  # noqa: E402
from pyapes_tpu_torch.ops import advect as advect_mod  # noqa: E402
from pyapes_tpu_torch.ops import axis_stencil as axis_mod  # noqa: E402
from pyapes_tpu_torch.ops import diff_field as diff_mod  # noqa: E402
from pyapes_tpu_torch.ops import jacobi as jacobi_mod  # noqa: E402
from pyapes_tpu_torch.ops.axis_stencil import axis_stencil  # noqa: E402
from pyapes_tpu_torch.parallel import DomainDecomposition  # noqa: E402
from pyapes_tpu_torch.solver.multigrid import MGSpec  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.utils.debug import NaNError  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import CylinderBoundary, homogeneous_bcs, mixed_bcs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pyapes_tpu_torch")
_CYL = lambda X, Y: (X - 0.7) ** 2 + (Y - 0.5) ** 2 < 0.15**2  # noqa: E731


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


def test_no_jax_import_in_port_scripts():
    """The port's scripts (``scripts/*_torch.py``, the demo ports among them)
    and ``chip_smoke.py`` import neither JAX nor the JAX package."""
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+pyapes_tpu\b|from\s+pyapes_tpu[\s.])",
                     re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")] + sorted(
        os.path.join(REPO, "scripts", f) for f in os.listdir(os.path.join(REPO, "scripts"))
        if f.endswith("_torch.py"))
    assert len(paths) >= 19
    offenders = []
    for path in paths:
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


def test_entry_points_default_to_cuda():
    """``Device()``, ``Mesh(...)`` (a Box, a Box with an obstacle, a
    Cylinder), ``ChannelFlow`` and the adjoint classes on a default mesh
    and the runner (``poisson``, ``rfp``, ``channel``, ``cavity --save``,
    ``convection --resume``) ask for the card unless the caller names the
    CPU, and raise where there is none; ``MGSpec`` has no default
    device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pyapes_tpu_torch import runner

    with pytest.raises(RuntimeError):
        Device()
    with pytest.raises(RuntimeError):
        Mesh(Box[0:1, 0:1], None, [5, 5])
    with pytest.raises(RuntimeError):
        runner.run(["poisson", "--n", "5"])
    with pytest.raises(RuntimeError):
        Mesh(Cylinder[0:1, 0:1], None, [5, 5])
    with pytest.raises(RuntimeError):
        runner.run(["rfp", "--n", "5", "--steps", "1"])
    with pytest.raises(TypeError):
        MGSpec((5, 5, 5), (1.0, 1.0, 1.0))
    with pytest.raises(RuntimeError):
        Mesh(Box[0:1, 0:1], [Box[0.4:0.6, 0.4:0.6]], [9, 9])
    with pytest.raises(RuntimeError):
        ChannelFlow(Mesh(Box[0:3, 0:1], [MaskObstacle(_CYL)], [13, 9]))
    with pytest.raises(RuntimeError):
        runner.run(["channel", "--n", "13", "--steps", "1", "--obstacle"])
    assert Mesh(Box[0:1, 0:1], None, [5, 5], device="cpu").device == torch.device("cpu")
    assert Mesh(Box[0:1, 0:1], [Box[0.4:0.6, 0.4:0.6]], [9, 9],
                device="cpu").device == torch.device("cpu")
    # the adjoint tier on a default mesh, and the runner's checkpoint flags
    from pyapes_tpu_torch.solver.adjoint import (
        DifferentiableDiffusionSolve,
        DifferentiableSolve,
        DifferentiableTransient,
        DifferentiableTransientDiffusion,
    )

    bcs = homogeneous_bcs(2, 0.0, "dirichlet")
    for make in (lambda m: DifferentiableSolve(m, bcs),
                 lambda m: DifferentiableDiffusionSolve(m, bcs),
                 lambda m: DifferentiableTransient(m, bcs, lambda t: t, dt=0.1),
                 lambda m: DifferentiableTransientDiffusion(m, bcs, dt=0.1)):
        with pytest.raises(RuntimeError):
            make(Mesh(Box[0:1, 0:1], None, [5, 5]))
    with pytest.raises(RuntimeError):
        runner.run(["cavity", "--n", "5", "--steps", "1", "--save", os.devnull])
    with pytest.raises(RuntimeError):
        runner.run(["convection", "--n", "5", "--steps", "1", "--resume", os.devnull])


def _field(bc_type="dirichlet"):
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [6, 6, 6], device="cpu", dtype="double")
    return Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, bc_type)})


def _channel(**kw):
    mesh = Mesh(Box[0:3, 0:1], [MaskObstacle(_CYL)], [25, 9], device="cpu", dtype="double")
    return ChannelFlow(mesh, nu=0.05, **kw)


def _solve(cfg):
    var = _field()
    s = Solver({"fdm": {"method": "fastdiag", "tol": 1e-8, "max_it": 10, **cfg}})
    s.set_eq(FDM().laplacian(1.0, var) == torch.ones(1, 6, 6, 6, dtype=torch.float64))
    return s.solve()


# what each case raises: NotImplementedError for what the port does not
# take; the fd_opts and ddt cases hold the guards of options ported since
# (an fd_opts precision outside the two accepted; a NaN met by a checked
# transient solve), their positive cases in test_torch_solver_options.py
_RAISES = {"fd_opts": ValueError, "ddt": NaNError}


@pytest.mark.parametrize(
    "case",
    ["decomp", "kernel", "fd_opts", "obstacle", "rz", "var_gamma", "ddt", "custom"],
)
def test_unported_features_raise(case):
    with pytest.raises(_RAISES.get(case, NotImplementedError)):
        if case == "decomp":  # a placed fastdiag whose pencils cannot divide (5 nodes, 2 blocks)
            mesh = Mesh(Box[0:1, 0:1, 0:1], None, [6, 5, 5], device="cpu", dtype="double")
            var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")})
            s = Solver({"fdm": {"method": "fastdiag", "tol": 1e-8, "max_it": 10, "decomp":
                                DomainDecomposition((2, 1, 1), devices=("cpu", "cpu"))}})
            s.set_eq(FDM().laplacian(1.0, var) == torch.ones(1, 6, 5, 5, dtype=torch.float64))
            s.solve()
        elif case == "kernel":  # the JAX package's plain-jnp tier: none on the card
            _solve({"kernel": "jnp"})
        elif case == "fd_opts":  # a precision other than "highest" / "default"
            _solve({"fd_opts": {"precision": "bf16_3x"}})
        elif case == "obstacle":  # a variable-Γ Laplacian with obstacle BCs (JAX fdm.py:207)
            mesh = Mesh(Box[0:1, 0:1], [Box[0.4:0.6, 0.4:0.6]], [9, 9], device="cpu",
                        dtype="double")
            var = Field("p", 1, mesh, {"domain": homogeneous_bcs(2, 0.0, "dirichlet"),
                                       "obstacle": [{"bc_type": "dirichlet", "bc_val": 1.0}]})
            FDM().laplacian(torch.ones(9, 9, dtype=torch.float64), var)
        elif case == "rz":  # a variable-Γ Laplacian on rz (the JAX package raises too)
            mesh = Mesh(Cylinder[0:1, 0:1], None, [9, 9], device="cpu", dtype="double")
            bcs = CylinderBoundary(**{f: {"bc_type": "dirichlet", "bc_val": 0.0}
                                      for f in ("rl", "ru", "zl", "zu")})()
            var = Field("p", 1, mesh, {"domain": bcs})
            FDM().laplacian(torch.ones(9, 9, dtype=torch.float64), var)
        elif case == "var_gamma":  # a nonzero Neumann flux of a variable-Γ Laplacian
            mesh = Mesh(Box[0:1, 0:1], None, [6, 6], device="cpu", dtype="double")
            var = Field("p", 1, mesh, {"domain": mixed_bcs(
                [1.0, 0.0, 0.0, 0.0], ["neumann", "dirichlet", "dirichlet", "dirichlet"])})
            FDM().laplacian(torch.ones(6, 6, dtype=torch.float64), var)
        elif case == "ddt":  # a transient solve with the in-loop NaN check meets a NaN
            var = _field()
            var.set_time(0.1, 0.0)
            var.save_old()
            s = Solver({"fdm": {"method": "bicgstab", "tol": 1e-8, "max_it": 10,
                                "debug": "nan"}})
            rhs = torch.ones(1, 6, 6, 6, dtype=torch.float64)
            rhs[0, 2, 3, 3] = float("nan")
            s.set_eq(FDM().ddt(var) - FDM().laplacian(1.0, var) == rhs)
            s.solve()
        elif case == "custom":  # a user operator term on a periodic axis
            var = _field("periodic")
            s = Solver({"fdm": {"method": "bicgstab", "tol": 1e-8, "max_it": 10}})
            s.set_eq(FDM().custom(lambda x: 2.0 * x, var)
                     == torch.ones(1, 6, 6, 6, dtype=torch.float64))
            s.solve()


def test_decomp_must_be_a_domain_decomposition():
    """The dict form that the JAX package's config type documents (and its
    solver never reads) raises, as does any other type."""
    for bad in ({"axes": (0,)}, (2, 1, 1)):
        with pytest.raises(TypeError, match="DomainDecomposition"):
            _solve({"decomp": bad})


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
    "axis_stencil5": (axis_mod, "axis_stencil5", "apply_axis_stencil", lambda f, t: f((), t)),
    "axis_stencil_ext": (axis_mod, "axis_stencil_ext", "apply_axis_stencil_ext",
                         lambda f, t: f((), t, (1, 0, 0))),
    "advect_pair": (advect_mod, "advect_pair", "apply_div_field",
                    lambda f, t: f(t, t, (), "upwind", (("none", "none"),) * 3)),
    "conv_component": (advect_mod, "conv_component", "apply_conv_field",
                       lambda f, t: f(t, t, (), "none", (("none", "none"),) * 3)),
    "jacobi3d": (jacobi_mod, "jacobi3d", "apply_jacobi3d",
                 lambda f, t: f(t, t, (1.0,) * 3, 1.0, 0.1, (0, 1, 2))),
    "jacobi3d_dot": (jacobi_mod, "jacobi3d_dot", "apply_jacobi3d_dot",
                     lambda f, t: f(t, t, (1.0,) * 3, 1.0, 0.1, (0, 1, 2))),
    "jacobi3d_x2": (jacobi_mod, "jacobi3d_x2", "apply_jacobi3d_x2",
                    lambda f, t: f(None, t, (1.0,) * 3, 0.1, (0, 1, 2), from_zero=True)),
    "diff_field": (diff_mod, "diff_field", "apply_diff_field",
                   lambda f, t: f(t, t, (1.0,) * 3, (("none", "none"),) * 3)),
    "diff_jacobi": (diff_mod, "diff_jacobi", "apply_diff_jacobi",
                    lambda f, t: f(None, t, t, (1.0,) * 3, (("none", "none"),) * 3,
                                   mode="smooth0")),
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


def _vg_args(shape=(5, 6, 7), dtype=torch.float64, g_shape=None, device="cpu"):
    x = torch.zeros((1, *shape), dtype=dtype, device=device)
    g = torch.ones(g_shape or shape, dtype=dtype, device=device)
    return x, g, (1.0,) * len(shape), (("none", "none"),) * len(shape)


@pytest.mark.parametrize(
    "case, exc",
    [("float16", TypeError), ("int", TypeError), ("gamma_dtype", TypeError),
     ("1d", ValueError), ("2_nodes", ValueError), ("gamma_shape", ValueError),
     ("noncontiguous", ValueError), ("periodic_surgery", ValueError), ("avg", ValueError),
     ("mode", ValueError), ("mask_axes", ValueError), ("x_shape", ValueError),
     ("meta_device", ValueError)],
)
def test_diff_wrappers_reject_what_the_kernels_do_not_take(case, exc):
    """The variable-Γ wrappers raise on an unsupported dtype, shape, layout,
    option or device, on the CPU path as on the card."""
    x, g, inv, surg = _vg_args()
    args = dict(x=x, b=x, g=g, inv=inv, surg=surg, avg="arithmetic", mode="smooth", axes=(0, 1, 2))
    if case in ("float16", "int"):
        x, g, inv, surg = _vg_args(dtype=torch.float16 if case == "float16" else torch.int32)
        args.update(x=x, b=x, g=g)
    elif case == "gamma_dtype":
        args["g"] = g.float()
    elif case == "1d":
        x, g, inv, surg = _vg_args(shape=(9,))
        args.update(x=x, b=x, g=g, inv=inv, surg=surg, axes=(0,))
    elif case == "2_nodes":
        x, g, inv, surg = _vg_args(shape=(5, 2, 7))
        args.update(x=x, b=x, g=g)
    elif case == "gamma_shape":
        args["g"] = torch.ones((2, 5, 6, 7), dtype=torch.float64)
    elif case == "noncontiguous":
        args["g"] = torch.ones((7, 6, 5), dtype=torch.float64).transpose(0, 2)
    elif case == "periodic_surgery":
        args["surg"] = (("periodic", "periodic"),) + surg[1:]
    elif case == "avg":
        args["avg"] = "geometric"
    elif case == "mode":
        args["mode"] = "smooth2"
    elif case == "mask_axes":
        args["axes"] = (0, 3)
    elif case == "x_shape":
        args["x"] = torch.zeros((2, 5, 6, 7), dtype=torch.float64)
    else:
        x, g, inv, surg = _vg_args(device="meta")
        args.update(x=x, b=x, g=g)
    with pytest.raises(exc):
        if case in ("mode", "mask_axes", "x_shape"):
            diff_mod.diff_jacobi(args["x"], args["b"], args["g"], args["inv"], args["surg"],
                                 args["avg"], 0.7, args["axes"], args["mode"])
        else:
            diff_mod.diff_field(args["x"], args["g"], args["inv"], args["surg"], args["avg"])


def test_rz_path_on_cpu_counts_no_launch():
    """The potentials (the fastdiag and the rz MG paths) and an implicit RFP
    step on CPU tensors take the plain versions and count no launch."""
    from pyapes_tpu_torch.models import RFPEvolution, RosenbluthPotentials

    mesh = Mesh(Cylinder[0:4, -4:4], None, [9, 17], device="cpu", dtype="double")
    f0 = torch.exp(-(mesh.R**2 + mesh.Z**2) / 2.0)
    before = axis_stencil.launches
    for cfg in (None, {"method": "bicgstab", "precond": "mg"}):
        H, G = RosenbluthPotentials(mesh, f0, cfg).solve(f0)
    model = RFPEvolution(mesh, H, G)
    model.step_implicit(Field("pdf", 1, mesh, None).set_var_tensor(f0), 1e-3)
    assert model.report["converge"]
    assert axis_stencil.launches == before == 0


def test_channel_path_on_cpu_counts_no_launch():
    """The channel path (plain BiCGSTAB momentum, BiCGSTAB with the
    plain-domain V-cycle on the obstacle pressure) on CPU tensors takes the
    plain versions and counts no launch."""
    model = _channel()
    reports = []
    real = model.p_solver.solve
    model.p_solver.solve = lambda: reports.append(real()) or reports[-1]
    model.run(0.005, 2)
    assert model.p_solver.config["fdm"]["precond"] == "mg" and reports
    assert all(r["converge"] for r in reports)
    assert axis_stencil.launches == 0


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
