"""The solver options the port took over last (CPU, against the JAX
package): ``fd_opts`` (``precision`` "highest"/"default", the factors'
``dtype``), ``kernel`` ("auto"/"pallas"; "jnp" raises), ``donate`` and a
transient solve under ``debug: "nan"``.

Tolerances: float64 solves of the two packages agree to 1e-12 relative
(the same algorithm, the sums in another order); the f32 fastdiag cases
keep the JAX test's gates (``converge``, ``tol < 1e-6``, ``itr <= 8``,
within 1e-4 of MG-CG) and take JAX's pass count (bf16 factors: within
one pass, the transforms round between stages in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.solver import FDM as JFDM  # noqa: E402
from pyapes_tpu.solver import Solver as JSolver  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu_torch.backend import transform_matmul  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.solver import FDM, Solver  # noqa: E402
from pyapes_tpu_torch.solver.linalg import build as build_mod  # noqa: E402
from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401


FACES = ["xl", "xu", "yl", "yu", "zl", "zu"]


def _mixed_bcs(dim):
    """Dirichlet on the x faces, Neumann on the rest (JAX test_fastdiag.py)."""
    return [{"bc_face": f, "bc_type": "dirichlet" if f[0] == "x" else "neumann",
             "bc_val": 0.0, "bc_val_opt": None} for f in FACES[: 2 * dim]]


def _dirichlet_bcs(dim):
    return [{"bc_face": f, "bc_type": "dirichlet", "bc_val": 0.0, "bc_val_opt": None}
            for f in FACES[: 2 * dim]]


class _Pair:
    """The same Poisson problem in both packages (3-D, seed-made RHS)."""

    def __init__(self, n=17, dtype="double", bcs=_mixed_bcs, seed=1, transient=False):
        box = JBox[0:1, 0:1, 0:1]
        self.jmesh = JMesh(box, None, [n] * 3, dtype=dtype)
        self.pmesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device="cpu", dtype=dtype)
        self.jvar = JField("p", 1, self.jmesh, {"domain": bcs(3), "obstacle": None}, init_val=0.0)
        self.pvar = Field("p", 1, self.pmesh, {"domain": bcs(3), "obstacle": None}, init_val=0.0)
        self.rhs_np = np.random.default_rng(seed).standard_normal((1, n, n, n))
        self.transient = transient
        if transient:
            for v in (self.jvar, self.pvar):
                v.set_time(0.05, 0.0)
                v.save_old()

    def solve_jax(self, cfg):
        s = JSolver({"fdm": {"report": False, **cfg}})
        f = JFDM()
        self.jvar.set_var_tensor(jnp.zeros_like(self.jvar()))
        rhs = jnp.asarray(self.rhs_np, dtype=self.jvar().dtype)
        eq = f.laplacian(1.0, self.jvar) == rhs
        if self.transient:
            eq = f.ddt(self.jvar) - f.laplacian(1.0, self.jvar) == rhs
        s.set_eq(eq)
        rep = s.solve()
        return np.asarray(self.jvar()), rep

    def solve_port(self, cfg, x0=None):
        s = Solver({"fdm": {"report": False, **cfg}})
        f = FDM()
        self.pvar.set_var_tensor(torch.zeros_like(self.pvar()) if x0 is None else x0)
        rhs = torch.as_tensor(self.rhs_np, dtype=self.pvar().dtype)
        eq = f.laplacian(1.0, self.pvar) == rhs
        if self.transient:
            eq = f.ddt(self.pvar) - f.laplacian(1.0, self.pvar) == rhs
        s.set_eq(eq)
        rep = s.solve()
        return self.pvar(), rep


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("fd_dtype", [None, "bfloat16"])
def test_fastdiag_3d_mixed_f32(fd_dtype):
    """JAX ``test_fastdiag.py::test_fastdiag_3d_mixed_f32`` on the port: 33^3
    mixed Dirichlet/Neumann f32, with true-f32 or bf16 transform factors;
    the JAX gates, and JAX's pass count (bf16: within one)."""
    pair = _Pair(n=33, dtype="single")
    cfg = {"method": "fastdiag", "tol": 1e-6, "max_it": 3000}
    if fd_dtype:
        cfg["fd_opts"] = {"dtype": fd_dtype}
    x_fd, rep = pair.solve_port(cfg)
    assert rep["converge"]
    assert rep["tol"] < 1e-6
    assert rep["itr"] <= 8
    _, jrep = pair.solve_jax(cfg)
    if fd_dtype:
        assert abs(rep["itr"] - jrep["itr"]) <= 1, (rep, jrep)
        assert pair.pvar.VAR.dtype == torch.float32
    else:
        assert rep["itr"] == jrep["itr"], (rep, jrep)
    x_cg, _ = pair.solve_port({"method": "cg", "tol": 1e-8, "max_it": 3000, "precond": "mg"})
    assert _rel(x_fd, x_cg) < 1e-4


@pytest.mark.parametrize("n", [33, 65])
@pytest.mark.parametrize("bcs", [_mixed_bcs, _dirichlet_bcs], ids=["mixed", "dirichlet"])
def test_fd_bf16_refinement_floor_matches_jax(n, bcs):
    """With bf16 factors and a tolerance no f32 solve reaches, the port's
    refinement follows the JAX package's pass by pass to the same stall
    exit: the same passes, each pass's residual within a factor 1.25 (the
    bf16 roundings between stages flip where the f32 sums differ in order;
    measured within 5%)."""
    pair = _Pair(n=n, dtype="single", bcs=bcs)
    cfg = {"method": "fastdiag", "tol": 1e-12, "max_it": 50, "history": True,
           "fd_opts": {"dtype": "bfloat16"}}
    _, rep = pair.solve_port(cfg)
    _, jrep = pair.solve_jax(cfg)
    assert not rep["converge"] and not jrep["converge"]
    assert rep["itr"] == jrep["itr"] < cfg["max_it"], (rep, jrep)
    port = np.asarray(rep["history"], dtype=np.float64)[: rep["itr"]]
    jax_ = np.asarray(jrep["history"], dtype=np.float64)[: jrep["itr"]]
    assert np.all(port <= 1.25 * jax_) and np.all(jax_ <= 1.25 * port), (port, jax_)


@pytest.mark.parametrize("dtype", ["single", "double"])
def test_fd_precision_default_cpu(dtype):
    """``precision: "default"`` gives the port's "highest" bits on the CPU (no
    TF32 there) and JAX's "default" pass count (its CPU backend ignores the
    precision of an f32 dot); the TF32 flags stay off."""
    pair = _Pair(n=17, dtype=dtype)
    cfg = {"method": "fastdiag", "tol": 1e-6 if dtype == "single" else 1e-10, "max_it": 100}
    x_hi, rep_hi = pair.solve_port(cfg)
    x_hi = x_hi.clone()
    x_df, rep_df = pair.solve_port({**cfg, "fd_opts": {"precision": "default"}})
    assert torch.equal(x_hi, x_df) and rep_hi == rep_df
    xj, jrep = pair.solve_jax({**cfg, "fd_opts": {"precision": "default"}})
    assert rep_df["itr"] == jrep["itr"]
    assert _rel(x_df.numpy(), xj) < (1e-5 if dtype == "single" else 1e-12)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("fd_opts", [{"precision": "default"}, {"dtype": "bfloat16"},
                                     {"precision": "default", "dtype": "float32"}])
def test_fd_preconditioner_with_fd_opts(fd_opts):
    """``precond: "fd"`` takes the same ``fd_opts``: a transient f64
    BiCGSTAB with the FD preconditioner equals the JAX package's (1e-10;
    bf16 factors: within one iteration, 1e-8)."""
    pair = _Pair(n=17, dtype="double", transient=True)
    cfg = {"method": "bicgstab", "precond": "fd", "tol": 1e-10, "max_it": 200,
           "criterion": "residual", "fd_opts": fd_opts}
    x, rep = pair.solve_port(cfg)
    xj, jrep = pair.solve_jax(cfg)
    assert rep["converge"] and jrep["converge"]
    bf16 = fd_opts.get("dtype") == "bfloat16"
    assert abs(rep["itr"] - jrep["itr"]) <= (1 if bf16 else 0), (rep, jrep)
    assert _rel(x.numpy(), xj) < (1e-8 if bf16 else 1e-10)


def test_fd_cache_keeps_fd_opts_apart():
    """Entries of ``_FD_CACHE`` that differ only in ``fd_opts`` are apart: a
    "highest" solve never reuses "default"'s or bf16's factors, and a
    repeated solve reuses its own."""
    clear_cache()
    pair = _Pair(n=9, dtype="single")
    cfg = {"method": "fastdiag", "tol": 1e-6, "max_it": 50}
    opts = [None, {"precision": "default"}, {"dtype": "bfloat16"},
            {"precision": "default", "dtype": "bfloat16"}]
    for o in opts + opts:
        pair.solve_port({**cfg, "fd_opts": o} if o else cfg)
    fds = list(build_mod._FD_CACHE.values())
    assert len(fds) == len(opts)
    got = sorted((fd.precision, str(fd.fwd[0].dtype)) for fd in fds)
    assert got == sorted([("highest", "torch.float32"), ("default", "torch.float32"),
                          ("highest", "torch.bfloat16"), ("default", "torch.bfloat16")])


@pytest.mark.parametrize("fd_opts, match", [
    ({"precision": "high"}, "'highest' or 'default'"),
    ({"precision": "fastest"}, "'highest' or 'default'"),
    ({"dtype": "int8"}, "dtype must be one of"),
    ({"dtype": "float16"}, "dtype must be one of"),
    ({"dtype": torch.float16}, "dtype must be one of"),
    ({"precison": "default"}, "unknown keys"),
])
def test_fd_opts_rejected(fd_opts, match):
    """An unknown precision raises ValueError naming the two accepted; so do
    an unknown key and a dtype other than bfloat16 and float32 (float16
    included: no test holds its accumulation)."""
    pair = _Pair(n=9)
    for method in ("fastdiag", "cg"):
        with pytest.raises(ValueError, match=match):
            pair.solve_port({"method": method, "precond": "fd", "fd_opts": fd_opts})


def test_transform_matmul_restores_flags():
    """The TF32 scope of ``precision: "default"`` puts every flag that
    ``set_full_precision_matmul`` pins back, an exception included."""
    m = torch.backends.cuda.matmul
    before = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision(), m.allow_bf16_reduced_precision_reduction)
    with pytest.raises(KeyError):
        with transform_matmul(tf32=True, bf16_f32_accumulate=True):
            assert m.allow_tf32 and torch.get_float32_matmul_precision() != "highest"
            assert not m.allow_bf16_reduced_precision_reduction
            raise KeyError("inside")
    after = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(), m.allow_bf16_reduced_precision_reduction)
    assert after == before


@pytest.mark.parametrize("method", ["fastdiag", "cg", "bicgstab"])
def test_kernel_option(method):
    """``kernel`` "auto" and "pallas" give the same bits and report (the plain
    versions on the CPU, the counterpart of Pallas interpret mode); "jnp"
    raises NotImplementedError saying there is no plain tier on the card;
    any other value ValueError. The JAX package's "pallas" solve agrees."""
    pair = _Pair(n=17, bcs=_dirichlet_bcs)
    cfg = {"method": method, "tol": 1e-10, "max_it": 500, "criterion": "residual",
           **({"precond": "mg"} if method != "fastdiag" else {})}
    x_auto, rep_auto = pair.solve_port({**cfg, "kernel": "auto"})
    x_auto = x_auto.clone()
    x_pal, rep_pal = pair.solve_port({**cfg, "kernel": "pallas"})
    assert torch.equal(x_auto, x_pal) and rep_auto == rep_pal
    xj, jrep = pair.solve_jax({**cfg, "kernel": "pallas"})
    assert _rel(x_pal.numpy(), xj) < 1e-10
    with pytest.raises(NotImplementedError, match="no plain tier on the card"):
        pair.solve_port({**cfg, "kernel": "jnp"})
    with pytest.raises(ValueError, match="'auto' or 'pallas'"):
        pair.solve_port({**cfg, "kernel": "xla"})


@pytest.mark.parametrize("case", ["fastdiag", "cg", "cg_fmg_delta", "bicgstab", "bicgstab_fmg",
                                  "fd_precond"])
def test_donate_same_bits_in_the_guess_storage(case):
    """``donate: True``: the same bits and report as without, the solution
    in the storage of the initial guess the field held (its history does
    not alias it here); the JAX package's donated solve agrees (1e-10)."""
    cfg = {"fastdiag": {"method": "fastdiag", "tol": 1e-10},
           "cg": {"method": "cg", "precond": "mg", "criterion": "residual"},
           "cg_fmg_delta": {"method": "cg", "precond": "mg", "mg_opts": {"fmg": True}},
           "bicgstab": {"method": "bicgstab", "precond": "mg", "criterion": "residual"},
           "bicgstab_fmg": {"method": "bicgstab", "precond": "mg", "mg_opts": {"fmg": True},
                            "criterion": "residual"},
           "fd_precond": {"method": "cg", "precond": "fd", "criterion": "residual"}}[case]
    cfg = {"tol": 1e-10, "max_it": 500, **cfg}
    pair = _Pair(n=17, bcs=_mixed_bcs)
    x_ref, rep_ref = pair.solve_port(cfg)
    x_ref = x_ref.clone()
    guess = torch.zeros_like(x_ref)
    x_don, rep_don = pair.solve_port({**cfg, "donate": True}, x0=guess)
    assert torch.equal(x_don, x_ref) and rep_don == rep_ref
    assert x_don.data_ptr() == guess.data_ptr()
    xj, _ = pair.solve_jax({**cfg, "donate": True})
    assert _rel(x_don.numpy(), xj) < 1e-10


def test_donate_does_not_apply_on_the_torus():
    """On periodic axes the solve runs on the reduced torus (a strided view)
    and re-appends the seam: donation saves nothing there and the guess is
    left as it was; the bits are those of the undonated solve."""
    kinds = [{"bc_face": f, "bc_type": "periodic" if f[0] == "x" else "dirichlet",
              "bc_val": None if f[0] == "x" else 0.0, "bc_val_opt": None} for f in FACES]
    pair = _Pair(n=17, bcs=lambda dim: kinds)
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-10, "max_it": 300,
           "criterion": "residual"}
    x_ref, rep_ref = pair.solve_port(cfg)
    x_ref = x_ref.clone()
    guess = torch.zeros_like(x_ref)
    x_don, rep_don = pair.solve_port({**cfg, "donate": True}, x0=guess)
    assert torch.equal(x_don, x_ref) and rep_don == rep_ref
    assert x_don.data_ptr() != guess.data_ptr() and not guess.any()


@pytest.mark.parametrize("method", ["bicgstab", "cg", "fastdiag"])
def test_transient_solve_with_debug_nan(method):
    """A transient (ddt) solve under ``debug: "nan"`` runs (it raised while
    the option was unported) and gives the unchecked solve's bits and
    report; the JAX package's checked solve agrees (1e-10)."""
    pair = _Pair(n=9, transient=True)
    cfg = {"method": method, "tol": 1e-10, "max_it": 100, "criterion": "residual"}
    x, rep = pair.solve_port(cfg)
    x = x.clone()
    x_chk, rep_chk = pair.solve_port({**cfg, "debug": "nan"})
    assert torch.equal(x, x_chk) and rep == rep_chk
    xj, jrep = pair.solve_jax({**cfg, "debug": "nan"})
    assert rep_chk["itr"] == jrep["itr"]
    assert _rel(x_chk.numpy(), xj) < 1e-10
