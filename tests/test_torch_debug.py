"""``utils/debug.py`` and the ``debug: "nan"`` solver option on the CPU,
against the JAX package's ``checkify`` behaviour.

``checked`` flags the first operation whose floating output holds a NaN
(NaN only, not Inf; creations, copies and selects are not checked, as
checkify checks only its ``nan_primitives``); a checked run computes the
bits of an unchecked one. The solver's option raises ``NaNError`` naming
the operation before the end-of-solve "Invalid tolerance" symptom.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental.checkify import JaxRuntimeError  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.solver import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver import Solver as JSolver  # noqa: E402
from pyapes_tpu.utils import debug as jdebug  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu.variables.bcs import homogeneous_bcs as j_homogeneous_bcs  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.utils import debug  # noqa: E402
from pyapes_tpu_torch.utils.debug import NaNError, checked, nan_check, record_kernel  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401


def _cg_pair(rhs_np, debug_opt="nan"):
    """The JAX test's problem (17^2, homogeneous Dirichlet, CG) in both
    packages; returns the two solvers and fields."""
    cfg = {"method": "cg", "tol": 1e-8, "max_it": 50, "report": False}
    if debug_opt:
        cfg["debug"] = debug_opt
    jmesh = JMesh(JBox[0:1, 0:1], None, [17, 17])
    pmesh = Mesh(Box[0:1, 0:1], None, [17, 17], device="cpu")
    jvar = JField("p", 1, jmesh, {"domain": j_homogeneous_bcs(2, 0.0, "dirichlet")}, init_val=0.0)
    pvar = Field("p", 1, pmesh, {"domain": homogeneous_bcs(2, 0.0, "dirichlet")}, init_val=0.0)
    js, ps = JSolver({"fdm": dict(cfg)}), Solver({"fdm": dict(cfg)})
    js.set_eq(JFDM().laplacian(1.0, jvar) == jnp.asarray(rhs_np))
    ps.set_eq(FDM().laplacian(1.0, pvar) == torch.as_tensor(rhs_np))
    return js, ps, jvar, pvar


def test_debug_nan_checkify():
    """JAX ``test_solver.py::test_debug_nan_checkify`` on the port: a NaN
    entering the loop raises from the in-loop check (both packages), naming
    the operation, not the end-of-solve "Invalid tolerance"; a clean problem
    passes through the checked path with the unchecked bits and itr, and
    JAX's solution (1e-12)."""
    rhs = np.zeros((1, 17, 17))
    rhs[0, 5, 5] = np.nan
    js, ps, _, _ = _cg_pair(rhs)
    with pytest.raises((JaxRuntimeError, ValueError, RuntimeError)):
        js.solve()
    with pytest.raises(NaNError, match=r"nan generated by operation: aten\.") as info:
        ps.solve()
    assert "Invalid tolerance" not in str(info.value)
    assert info.value.op.startswith("aten.")

    ones = np.ones((1, 17, 17))
    js, ps, jvar, pvar = _cg_pair(ones)
    _, ps_plain, _, pvar_plain = _cg_pair(ones, debug_opt=None)
    rep, rep_plain, jrep = ps.solve(), ps_plain.solve(), js.solve()
    assert rep["converge"] and jrep["converge"]
    assert torch.equal(pvar(), pvar_plain()) and rep == rep_plain
    assert rep["itr"] == jrep["itr"]
    np.testing.assert_allclose(pvar().numpy(), np.asarray(jvar()), rtol=0, atol=1e-12)


def test_debug_validate_field():
    """JAX ``test_utils.py::test_debug_validate_field`` on both packages: the
    same exceptions and messages."""
    for mod, mesh_cls, box, field_cls, nan in (
            (jdebug, JMesh, JBox, JField, jnp.nan),
            (debug, lambda *a: Mesh(*a, device="cpu"), Box, Field, float("nan"))):
        var = field_cls("u", 1, mesh_cls(box[0:1], None, [9]), None, init_val=1.0)
        mod.validate_field(var)
        var.VAR = var() * nan
        with pytest.raises(FloatingPointError, match="u has 9 non-finite values"):
            mod.validate_field(var)
        mod.divergence_guard({"itr": 3, "tol": 1e-7, "converge": True})
        with pytest.raises(RuntimeError, match=r"solve: diverged \(tol=inf\)"):
            mod.divergence_guard({"itr": 3, "tol": float("inf"), "converge": False})


def test_validate_field_and_guard_take_tensors():
    """A bare tensor (label "array", or the name given), Inf counted as
    non-finite, and a 0-d tensor ``tol`` (a ``sync: False`` report)."""
    x = torch.ones(4, dtype=torch.float64)
    debug.validate_field(x)
    x[1], x[2] = float("inf"), float("nan")
    with pytest.raises(FloatingPointError, match="array has 2 non-finite"):
        debug.validate_field(x)
    with pytest.raises(FloatingPointError, match="rhs has 2 non-finite"):
        debug.validate_field(x, "rhs")
    debug.divergence_guard({"tol": torch.tensor(1e-9, dtype=torch.float64)})
    with pytest.raises(RuntimeError, match=r"step 4: diverged \(tol=nan\)"):
        debug.divergence_guard({"tol": torch.tensor(float("nan"))}, "step 4")
    with pytest.raises(RuntimeError):
        debug.divergence_guard({})


def test_checked_names_the_first_nan_operation():
    """The first NaN-producing operation is named, not a later one; Inf is
    not a NaN (checkify's rule), a NaN-filled creation is not checked, and
    the JAX package's ``checked`` flags the same function."""
    def f(x):
        h = torch.full((3,), float("nan"))  # a creation: not checked
        y = x / 0.0                         # Inf, not NaN
        z = y - y                           # inf - inf: the first NaN
        return torch.log(z) * 2.0 + h.sum() * 0

    with pytest.raises(NaNError) as info:
        checked(f)(torch.ones(3))
    assert info.value.op == "aten.sub.Tensor"
    with pytest.raises((JaxRuntimeError, ValueError)):
        jdebug.checked(lambda x: jnp.log((x / 0.0) - (x / 0.0)))(jnp.ones(3))
    out = checked(lambda x: (x / 0.0) * 2.0)(torch.ones(2))  # Inf only: no raise
    assert torch.isinf(out).all()
    assert torch.equal(checked(torch.sin)(torch.arange(4.0)), torch.sin(torch.arange(4.0)))


def test_checked_hand_kernel_outputs_by_name():
    """A hand kernel's wrapper reports its outputs under its own name; the
    check is a no-op outside a checked region, and an inner region's NaN
    surfaces in the outer one too."""
    bad = torch.tensor([1.0, float("nan")])
    record_kernel("axis_stencil", bad)  # outside a region: nothing happens
    with pytest.raises(NaNError, match="operation: diff_field") as info:
        with nan_check():
            torch.ones(2) + 1
            record_kernel("diff_field", torch.ones(2), bad)
            bad * 2.0
    assert info.value.op == "diff_field"
    with pytest.raises(NaNError, match="jacobi3d"):
        with nan_check():
            with nan_check():
                record_kernel("jacobi3d", bad, None)


def test_checked_exception_chain():
    """An exception raised inside a region that met a NaN becomes the cause
    of the ``NaNError``; without a NaN it propagates as it is."""
    def fail_after_nan():
        torch.tensor([float("nan")]) * 1.0
        raise RuntimeError("Invalid tolerance detected! tol: nan")

    with pytest.raises(NaNError) as info:
        checked(fail_after_nan)()
    assert isinstance(info.value.__cause__, RuntimeError)
    with pytest.raises(KeyError):
        checked(lambda: {}["x"])()


@pytest.mark.parametrize("method, precond", [("fastdiag", None), ("cg", "mg"), ("bicgstab", "mg"),
                                             ("cg", "fd")])
def test_checked_solve_same_bits_and_nan_named(method, precond):
    """Every solve method: a clean checked solve gives the unchecked bits and
    report, ``sync: False`` included; a NaN in the RHS raises ``NaNError``
    (not the end-of-solve "Invalid tolerance")."""
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [9, 9, 9], device="cpu", dtype="double")
    rhs = torch.as_tensor(np.random.default_rng(5).standard_normal((1, 9, 9, 9)))

    def run(extra, b=rhs, max_it=200):
        var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")}, init_val=0.0)
        cfg = {"method": method, "tol": 1e-10, "max_it": max_it, "criterion": "residual", **extra}
        if precond:
            cfg["precond"] = precond
        s = Solver({"fdm": cfg})
        s.set_eq(FDM().laplacian(1.0, var) == b)
        return var(), s.solve()

    x, rep = run({})
    for extra in ({"debug": "nan"}, {"debug": "nan", "sync": False}):
        xc, repc = run(extra)
        assert torch.equal(x, xc)
        assert int(repc["itr"]) == rep["itr"] and float(repc["tol"]) == rep["tol"]
    bad = rhs.clone()
    bad[0, 4, 4, 4] = float("nan")
    with pytest.raises(NaNError):
        run({"debug": "nan"}, bad, max_it=10)
    with pytest.raises(RuntimeError, match="Invalid tolerance"):
        run({}, bad, max_it=10)


def test_debug_nan_in_gamma_is_named():
    """A NaN in a variable-Γ coefficient: the checked solve raises naming an
    operation of the Γ operator (on the CPU its plain version's operators;
    on the card the kernel's wrapper, ``test_torch_cuda.py``)."""
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [9, 9, 9], device="cpu", dtype="double")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")}, init_val=0.0)
    gamma = torch.ones((9, 9, 9), dtype=torch.float64)
    gamma[4, 4, 4] = float("nan")
    s = Solver({"fdm": {"method": "cg", "precond": "mg", "tol": 1e-8, "max_it": 50,
                        "criterion": "residual", "debug": "nan",
                        "mg_opts": {"fmg": True}}})
    s.set_eq(FDM().laplacian(gamma, var) == torch.ones(1, 9, 9, 9, dtype=torch.float64))
    with pytest.raises(NaNError, match="aten"):
        s.solve()


def test_debug_option_values():
    """``debug`` other than "nan"/None raises ValueError (the JAX package
    ignores such values; the port never takes another path quietly)."""
    mesh = Mesh(Box[0:1, 0:1], None, [9, 9], device="cpu", dtype="double")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(2, 0.0, "dirichlet")}, init_val=0.0)
    s = Solver({"fdm": {"method": "cg", "tol": 1e-8, "max_it": 50, "debug": "inf"}})
    s.set_eq(FDM().laplacian(1.0, var) == torch.ones(1, 9, 9, dtype=torch.float64))
    with pytest.raises(ValueError, match="'nan' or None"):
        s.solve()


def test_debug_nan_in_fused_step_raises_as_jax():
    """Inside a fused whole step a checked solve cannot run: the JAX
    package's FusedStepRunner capture raises ValueError (checkify's check is
    not functionalized in the step's program), and so does the port's fused
    step, on the CPU as on the card, the model state untouched; eager steps
    run checked."""
    from pyapes_tpu.models.navier_stokes import LidDrivenCavity as JCavity
    from pyapes_tpu.utils.fuse import _solvers_of as j_solvers_of
    from pyapes_tpu_torch.models import LidDrivenCavity
    from pyapes_tpu_torch.utils.fuse import _solvers_of

    jm = JCavity(JMesh(JBox[0:1, 0:1], None, [17, 17], dtype="double"), nu=0.05)
    pm = LidDrivenCavity(Mesh(Box[0:1, 0:1], None, [17, 17], device="cpu", dtype="double"),
                         nu=0.05)
    for m, solvers in ((jm, j_solvers_of), (pm, _solvers_of)):
        for s in solvers(m):
            s.config["fdm"]["debug"] = "nan"
    with pytest.raises(ValueError):
        jm.run(0.01, 3, fused=True)
    pm.run(0.01, 2)  # eager: checked, clean
    before = [f().clone() for f in pm.state_fields()]
    t0 = pm.t
    with pytest.raises(ValueError, match="fused whole step"):
        pm.run(0.01, 1, fused=True)
    assert pm.t == t0
    assert all(torch.equal(a, f()) for a, f in zip(before, pm.state_fields()))
