"""Parity of the port's coefficient vectors and fast-diagonalization
factors with the JAX package (CPU).

Both packages build the per-axis Laplacian vectors and the eigen-factors
on the host with the same numpy code, so they must be BIT-equal; the
Kronecker solve itself runs as torch matmuls vs XLA dots and agrees to
float64 round-off.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.mesh.tools import boundary_slicer as j_slicer  # noqa: E402
from pyapes_tpu.ops.stencil import laplacian_axis_coeffs as j_coeffs  # noqa: E402
from pyapes_tpu.solver.fastdiag import FastDiag as JFastDiag  # noqa: E402
from pyapes_tpu.solver.fastdiag import axis_matrix_np as j_axis_matrix  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.mesh.tools import boundary_slicer  # noqa: E402
from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs  # noqa: E402
from pyapes_tpu_torch.solver.fastdiag import FastDiag, axis_matrix_np  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: E402,F401

CASES = {
    "2d": (
        (slice(0, 1), slice(0, 2)), [9, 12],
        ["neumann", "symmetry", "dirichlet", "neumann"],
    ),
    "3d": (
        (slice(0, 1), slice(0, 2), slice(0, 0.5)), [9, 12, 7],
        ["dirichlet", "neumann", "symmetry", "dirichlet", "neumann", "symmetry"],
    ),
    "3d_dirichlet": (
        (slice(0, 1), slice(0, 1), slice(0, 1)), [6, 7, 8], ["dirichlet"] * 6,
    ),
}
FACES = ["xl", "xu", "yl", "yu", "zl", "zu"]


def _bcs(kinds):
    return [
        {"bc_face": f, "bc_type": k, "bc_val": 0.25 * i, "bc_val_opt": None}
        for i, (f, k) in enumerate(zip(FACES, kinds))
    ]


def _pair(case, dtype):
    box, nx, kinds = CASES[case]
    jm = JMesh(JBox[box], None, nx, dtype=dtype)
    pm = Mesh(Box[box], None, nx, device="cpu", dtype=dtype)
    jf = JField("p", 1, jm, {"domain": _bcs(kinds)})
    pf = Field("p", 1, pm, {"domain": _bcs(kinds)})
    return jm, jf, pm, pf


def _axis_mats(mesh, bcs, coeffs, slicer):
    sl = slicer(mesh.dim, bcs, mesh.coord_sys)
    return sl, [
        (j_axis_matrix if slicer is j_slicer else axis_matrix_np)(*coeffs[j], active=sl[j], periodic=False)
        for j in range(mesh.dim)
    ]


@pytest.mark.parametrize("dtype", ["double", "single"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_laplacian_axis_coeffs_bit_equal(case, dtype):
    jm, jf, pm, pf = _pair(case, dtype)
    jc = j_coeffs(jm, jf.bcs)
    pc = laplacian_axis_coeffs(pm, pf.bcs)
    assert len(jc) == len(pc) == len(CASES[case][1])
    for ja, pa in zip(jc, pc):
        for a, b in zip(ja, pa):
            assert a.dtype == b.dtype
            assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["double", "single"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fastdiag_factors_bit_equal_and_solve(case, dtype):
    jm, jf, pm, pf = _pair(case, dtype)
    jsl, jmats = _axis_mats(jm, jf.bcs, j_coeffs(jm, jf.bcs), j_slicer)
    psl, pmats = _axis_mats(pm, pf.bcs, laplacian_axis_coeffs(pm, pf.bcs), boundary_slicer)
    assert jsl == psl
    for a, b in zip(jmats, pmats):
        assert np.array_equal(a, b)
    tdt = torch.float64 if dtype == "double" else torch.float32
    jfd = JFastDiag(jmats, dtype=jm.dtype.float)
    pfd = FastDiag(pmats, dtype=tdt, device="cpu")
    for name in ("fwd", "inv", "lams"):
        for a, b in zip(getattr(jfd, name), getattr(pfd, name)):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert jfd.lam_scale == pfd.lam_scale

    if dtype == "single":
        return
    shape = tuple(m.shape[0] for m in pmats)
    r = np.random.default_rng(2).standard_normal((2,) + shape)
    for c_ax, c_dt, pseudo in ((1.0, 0.0, False), (-1.5, 0.3, False), (1.0, 0.0, True)):
        want = np.asarray(jfd.solve(jnp.asarray(r), c_ax, c_dt, pseudo=pseudo))
        got = pfd.solve(torch.from_numpy(r), c_ax, c_dt, pseudo=pseudo).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_fastdiag_solve_inverts_the_operator():
    """Independent of the JAX package: FD.solve(A r) == r for the dense
    Kronecker-sum operator of mixed-BC axis matrices."""
    _, _, pm, pf = _pair("3d", "double")
    _, mats = _axis_mats(pm, pf.bcs, laplacian_axis_coeffs(pm, pf.bcs), boundary_slicer)
    n = [m.shape[0] for m in mats]
    eye = [np.eye(k) for k in n]
    A = (
        np.kron(np.kron(mats[0], eye[1]), eye[2])
        + np.kron(np.kron(eye[0], mats[1]), eye[2])
        + np.kron(np.kron(eye[0], eye[1]), mats[2])
    )
    x = np.random.default_rng(4).standard_normal(int(np.prod(n)))
    b = (A @ x).reshape((1, *n))
    fd = FastDiag(mats, dtype=torch.float64, device="cpu")
    got = fd.solve(torch.from_numpy(b), 1.0).numpy().ravel()
    assert np.abs(got - x).max() <= 1e-10 * np.abs(x).max()


def _fastdiag_itr_both(n):
    """``itr`` and the final relative residual of the 3-D all-Dirichlet f32
    random-RHS fastdiag solve (``bench.py``'s Poisson problem, tol 1e-6,
    residual criterion) through both packages' ``Solver.solve``, on the
    same numpy RHS."""
    from pyapes_tpu.solver.fdm import FDM as JFDM
    from pyapes_tpu.solver.ops import Solver as JSolver
    from pyapes_tpu_torch.solver import FDM, Solver

    cfg = {"method": "fastdiag", "tol": 1e-6, "max_it": 4000, "criterion": "residual"}
    rhs = np.random.default_rng(0).standard_normal((1, n, n, n)).astype(np.float32)
    box = (slice(0, 1),) * 3
    bcs = [{"bc_face": f, "bc_type": "dirichlet", "bc_val": 0.0} for f in FACES]
    jf = JField("p", 1, JMesh(JBox[box], None, [n] * 3, dtype="single"),
                {"domain": bcs, "obstacle": None}, init_val=0.0)
    js = JSolver({"fdm": dict(cfg)})
    js.set_eq(JFDM().laplacian(1.0, jf) == jnp.asarray(rhs))
    jrep = js.solve()
    del js, jf
    pf = Field("p", 1, Mesh(Box[box], None, [n] * 3, device="cpu", dtype="single"),
               {"domain": bcs, "obstacle": None}, init_val=0.0)
    ps = Solver({"fdm": dict(cfg)})
    ps.set_eq(FDM().laplacian(1.0, pf) == torch.from_numpy(rhs))
    prep = ps.solve()
    return jrep, prep


def test_f32_fastdiag_passes_match_the_reference_256():
    """ROADMAP C's closed fault: f32 fastdiag at 256^3 takes one pass in
    both packages (the port took 2 at 512^3 on the card while the JAX
    package took 1 on its TPU; on the CPU both take 2 there, see the slow
    case below, so the gap was the TPU's matmul)."""
    jrep, prep = _fastdiag_itr_both(256)
    assert prep["itr"] == jrep["itr"] == 1, (prep, jrep)
    assert prep["converge"] and jrep["converge"]
    assert prep["tol"] <= 1e-6 and jrep["tol"] <= 1e-6


@pytest.mark.slow
def test_f32_fastdiag_passes_match_the_reference_512():
    """The same at 512^3 (a few GB, ~40 s): both packages take 2 passes."""
    jrep, prep = _fastdiag_itr_both(512)
    assert prep["itr"] == jrep["itr"] == 2, (prep, jrep)
    assert prep["converge"] and jrep["converge"]
