"""Checkpoints, VTK export, the native host tier and the runner's
``--vtk/--save/--resume``, port against the JAX package (CPU).

Checkpoints cross the packages both ways in the shared ``.npz`` layout
(f32 and f64 exactly; a JAX bf16 checkpoint reads into the port bit for
bit); the JAX package's ``test_utils.py`` checkpoint tests and
``test_native.py`` cases run by name on the port; VTK and snapshot files
are byte-identical across the packages and across the native and numpy
paths; a resumed run equals the uninterrupted one.
"""
from math import pi

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

from pyapes_tpu import native as jnative  # noqa: E402
from pyapes_tpu.geometry import Box as JBox  # noqa: E402
from pyapes_tpu.mesh import Mesh as JMesh  # noqa: E402
from pyapes_tpu.utils import checkpoint as jckpt  # noqa: E402
from pyapes_tpu.utils import io as jio  # noqa: E402
from pyapes_tpu.variables import Field as JField  # noqa: E402
from pyapes_tpu_torch import native  # noqa: E402
from pyapes_tpu_torch import runner  # noqa: E402
from pyapes_tpu_torch.geometry import Box  # noqa: E402
from pyapes_tpu_torch.mesh import Mesh  # noqa: E402
from pyapes_tpu_torch.ops.stencil import apply_axis_stencil, laplacian_axis_coeffs  # noqa: E402
from pyapes_tpu_torch.utils import checkpoint  # noqa: E402
from pyapes_tpu_torch.utils import io as vio  # noqa: E402
from pyapes_tpu_torch.variables import Field  # noqa: E402
from pyapes_tpu_torch.variables.bcs import homogeneous_bcs  # noqa: E402

needs_native = pytest.mark.skipif(not native.available(), reason="g++ toolchain unavailable")


def _mesh(box, nx, dtype="double"):
    return Mesh(box, None, nx, device="cpu", dtype=dtype)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# -- the JAX package's test_utils.py checkpoint tests, on the port ------------

def test_checkpoint_roundtrip(tmp_path) -> None:
    mesh = _mesh(Box[0:1, 0:1], [9, 9])
    var = Field("u", 1, mesh, None, init_val="random")
    var.set_time(0.01, 0.5)
    var.save_old()
    var.VAR = var() * 2.0

    path = str(tmp_path / "ckpt")
    checkpoint.save(path, [var])
    var2 = Field("u", 1, mesh, None, init_val=0.0)
    checkpoint.load(path, [var2])

    assert torch.equal(var2(), var())
    assert torch.equal(var2.VARo, var.VARo)
    assert var2._t == 0.5
    assert var2._dt == 0.01


def test_checkpoint_orbax_roundtrip(tmp_path) -> None:
    mesh = _mesh(Box[0:1], [9])
    var = Field("u", 1, mesh, None, init_val="random")
    var.set_time(0.1, 1.5)
    var.save_old()

    path = str(tmp_path / "orbax_ckpt")
    checkpoint.save_orbax(path, [var])
    var2 = Field("u", 1, mesh, None, init_val=0.0)
    checkpoint.load_orbax(path, [var2])
    assert torch.equal(var2(), var())
    assert var2._t == 1.5


def test_checkpoint_orbax_async(tmp_path) -> None:
    """Non-blocking save: ``wait_for_checkpoints`` makes it durable; the
    payload snapshot is taken at save time (later writes, in place too,
    are not captured)."""
    mesh = _mesh(Box[0:1], [9])
    var = Field("u", 1, mesh, None, init_val="random")
    var.set_time(0.1, 2.5)
    snap = var().clone()

    path = str(tmp_path / "orbax_async")
    checkpoint.save_orbax(path, [var], block=False)
    var().mul_(0.0)  # in place, after the save returned
    var.set_var_tensor(var() + 1.0)
    checkpoint.wait_for_checkpoints()

    var2 = Field("u", 1, mesh, None, init_val=0.0)
    checkpoint.load_orbax(path, [var2])
    assert torch.equal(var2(), snap)
    assert var2._t == 2.5


def test_checkpoint_async_error_surfaces_at_wait(tmp_path) -> None:
    """A failed background write raises at ``wait_for_checkpoints``."""
    mesh = _mesh(Box[0:1], [9])
    var = Field("u", 1, mesh, None, init_val=1.0)
    checkpoint.save_orbax(str(tmp_path / "missing_dir" / "ck"), [var], block=False)
    with pytest.raises(OSError):
        checkpoint.wait_for_checkpoints()
    checkpoint.wait_for_checkpoints()  # the error is reported once


def _bdf2_case(mesh):
    from pyapes_tpu_torch.solver import FDM, Solver

    def make_var():
        v = Field("u", 1, mesh, {"domain": homogeneous_bcs(1, 0.0, "dirichlet"),
                                 "obstacle": None})
        v.set_var_tensor(torch.sin(pi * mesh.X)[None])
        v.set_time(0.01, 0.0)
        return v

    solver = Solver({"fdm": {"method": "cg", "tol": 1e-13, "max_it": 2000, "report": False,
                             "criterion": "residual"}})
    fdm = FDM()

    def step(v, n):
        for _ in range(n):
            v.save_old()
            solver.set_eq(fdm.ddt(v, scheme="bdf2") - fdm.laplacian(0.5, v) == 0.0)
            solver.solve()
            v.update_time()

    return make_var, step


def test_checkpoint_bdf2_state_roundtrip(tmp_path) -> None:
    """BDF2 history (VARoo, n_hist) survives save/load on both backends,
    and a resumed BDF2 run matches the uninterrupted one."""
    make_var, step = _bdf2_case(_mesh(Box[0:1], [33]))
    v1 = make_var()
    step(v1, 6)
    v2 = make_var()
    step(v2, 3)
    checkpoint.save(str(tmp_path / "bdf2"), [v2])

    v3 = make_var()
    checkpoint.load(str(tmp_path / "bdf2"), [v3])
    assert v3.n_hist == v2.n_hist
    assert torch.equal(v3.VARoo, v2.VARoo)
    step(v3, 3)
    assert_allclose(_np(v3()), _np(v1()), atol=1e-14)

    v2.set_time(0.0, v2.t)  # a legitimately zero dt round-trips
    checkpoint.save_orbax(str(tmp_path / "bdf2_orbax"), [v2])
    v4 = make_var()
    checkpoint.load_orbax(str(tmp_path / "bdf2_orbax"), [v4])
    assert v4.n_hist == v2.n_hist
    assert v4._dt == 0.0
    assert torch.equal(v4.VARoo, v2.VARoo)


def test_checkpoint_resume_transient(tmp_path) -> None:
    """Resume from a checkpoint reproduces the uninterrupted ``Burgers1D``
    run (within 1e-12)."""
    from pyapes_tpu_torch.models import Burgers1D

    mesh = _mesh(Box[0 : 2 * pi], [65])
    m1 = Burgers1D(mesh, nu=0.1)
    for _ in range(10):
        m1.step(0.01)
    m2 = Burgers1D(mesh, nu=0.1)
    for _ in range(5):
        m2.step(0.01)
    checkpoint.save(str(tmp_path / "burgers"), [m2.var])

    m3 = Burgers1D(mesh, nu=0.1)
    checkpoint.load(str(tmp_path / "burgers"), [m3.var])
    assert m3.var.t == m2.var.t
    for _ in range(5):
        m3.step(0.01)
    assert_allclose(_np(m3.var()), _np(m1.var()), atol=1e-12)


# -- across the packages -------------------------------------------------------

def _pair(dtype, seed=0):
    """The same random field state in both packages: ``(jax field, port
    field, fresh jax field, fresh port field)``."""
    jm = JMesh(JBox[0:1, 0:1], None, [7, 9], dtype=dtype)
    pm = _mesh(Box[0:1, 0:1], [7, 9], dtype=dtype)
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal((1, 7, 9)) for _ in range(3)]
    jv = JField("u", 1, jm, None, init_val=0.0)
    pv = Field("u", 1, pm, None, init_val=0.0)
    for v, conv in ((jv, jnp.asarray), (pv, torch.as_tensor)):
        v.set_time(0.02, 0.0)
        for a in vals:
            v.save_old()
            v.set_var_tensor(conv(a))
            v.update_time()
    return jv, pv, JField("u", 1, jm, None, init_val=0.0), Field("u", 1, pm, None, init_val=0.0)


def _same_state(jv, pv) -> None:
    for a, b in ((jv(), pv()), (jv.VARo, pv.VARo), (jv.VARoo, pv.VARoo)):
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        b = _np(b.float() if b.dtype == torch.bfloat16 else b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert float(jv._t) == float(pv._t) and jv._dt == pv._dt and jv.n_hist == pv.n_hist


@pytest.mark.parametrize("dtype", ["single", "double"])
def test_checkpoint_jax_to_port(tmp_path, dtype) -> None:
    jv, _, _, fresh = _pair(dtype)
    jckpt.save(str(tmp_path / "j"), [jv])
    checkpoint.load(str(tmp_path / "j"), [fresh])
    _same_state(jv, fresh)


@pytest.mark.parametrize("dtype", ["single", "double"])
def test_checkpoint_port_to_jax(tmp_path, dtype) -> None:
    _, pv, fresh, _ = _pair(dtype)
    checkpoint.save(str(tmp_path / "p"), [pv])
    jckpt.load(str(tmp_path / "p"), [fresh])
    _same_state(fresh, pv)


def test_checkpoint_files_identical_across_packages(tmp_path) -> None:
    """The same state saved by both packages gives the same arrays and the
    same metadata entry by entry."""
    jv, pv, _, _ = _pair("double", seed=3)
    jckpt.save(str(tmp_path / "j"), [jv])
    checkpoint.save(str(tmp_path / "p"), [pv])
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_checkpoint_bf16_from_jax(tmp_path) -> None:
    """A JAX bf16 checkpoint (numpy stores ml_dtypes bfloat16 as raw
    ``|V2``) reads into a port bf16 field bit for bit, and the port writes
    the same ``|V2`` bits."""
    jv, _, _, fresh = _pair("bf16", seed=4)
    jckpt.save(str(tmp_path / "j"), [jv])
    checkpoint.load(str(tmp_path / "j"), [fresh])
    assert fresh().dtype == torch.bfloat16
    _same_state(jv, fresh)
    checkpoint.save(str(tmp_path / "p"), [fresh])
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_checkpoint_load_casts_to_field_dtype(tmp_path) -> None:
    """``load`` restores onto each field's own dtype (an f64 checkpoint
    into an f32 field)."""
    _, pv, _, _ = _pair("double", seed=5)
    checkpoint.save(str(tmp_path / "p"), [pv])
    f32 = Field("u", 1, _mesh(Box[0:1, 0:1], [7, 9], dtype="single"), None, init_val=0.0)
    checkpoint.load(str(tmp_path / "p"), [f32])
    assert f32().dtype == torch.float32
    assert torch.equal(f32(), pv().float())
    with pytest.raises(KeyError, match="not found"):
        checkpoint.load(str(tmp_path / "p"), [Field("w", 1, f32.mesh, None)])


# -- test_native.py on the port's native copy ----------------------------------

@needs_native
@pytest.mark.parametrize("dims,nx", [(2, [12, 10]), (3, [8, 6, 10])])
def test_native_stencil_oracle(dims, nx) -> None:
    """The C++ reference implementation agrees with the port's roll-sum."""
    mesh = _mesh(Box[tuple(slice(0, 1) for _ in range(dims))], nx)
    var = Field("t", 1, mesh, {"domain": homogeneous_bcs(dims, 1.0, "neumann"),
                               "obstacle": None}, init_val="random")
    coeffs = tuple(tuple(torch.as_tensor(c) for c in cs)
                   for cs in laplacian_axis_coeffs(mesh, var.bcs))
    ref = _np(apply_axis_stencil(coeffs, var()))[0]
    out = native.stencil_apply_ref(coeffs, var()[0])
    assert_allclose(out, ref, atol=1e-12)


@pytest.mark.parametrize("path_kind", ["native", "numpy"])
def test_native_snapshot_roundtrip(tmp_path, monkeypatch, path_kind) -> None:
    if path_kind == "native" and not native.available():
        pytest.skip("g++ toolchain unavailable")
    if path_kind == "numpy":
        monkeypatch.setattr(native, "load", lambda: None)
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        arr = rng.standard_normal((7, 9, 5)).astype(dtype)
        path = str(tmp_path / f"snap_{np.dtype(dtype).name}.bin")
        native.snapshot_write(path, arr)
        back = native.snapshot_read(path, dtype)
        assert back.shape == arr.shape
        assert np.array_equal(back, arr)


@pytest.mark.parametrize("path_kind", ["native", "numpy"])
def test_native_snapshot_detects_corruption(tmp_path, monkeypatch, path_kind) -> None:
    if path_kind == "native" and not native.available():
        pytest.skip("g++ toolchain unavailable")
    if path_kind == "numpy":
        monkeypatch.setattr(native, "load", lambda: None)
    arr = np.arange(64, dtype=np.float64).reshape(8, 8)
    path = str(tmp_path / "snap.bin")
    native.snapshot_write(path, arr)
    data = bytearray(open(path, "rb").read())
    data[50] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError):
        native.snapshot_read(path, np.float64)


@needs_native
def test_native_snapshot_paths_same_bytes(tmp_path, monkeypatch) -> None:
    """The numpy path writes the C++ writer's bytes, the JAX package's
    writer's too, and each path reads the other's files."""
    arr = np.random.default_rng(1).standard_normal((5, 3, 4))
    native.snapshot_write(str(tmp_path / "c.bin"), arr)
    if jnative.available():
        jnative.snapshot_write(str(tmp_path / "j.bin"), arr)
        assert open(tmp_path / "j.bin", "rb").read() == open(tmp_path / "c.bin", "rb").read()
    monkeypatch.setattr(native, "load", lambda: None)
    native.snapshot_write(str(tmp_path / "n.bin"), arr)
    assert open(tmp_path / "n.bin", "rb").read() == open(tmp_path / "c.bin", "rb").read()
    assert np.array_equal(native.snapshot_read(str(tmp_path / "c.bin"), np.float64), arr)


def _vtk_roundtrip(tmp_path, mesh):
    rng = np.random.default_rng(4)
    f1 = rng.standard_normal(tuple(mesh.nx)).astype(np.float32)
    f2 = torch.as_tensor(rng.standard_normal((1,) + tuple(mesh.nx)))  # f64 tensor
    p = vio.write_vtk(str(tmp_path / "out"), mesh, {"a": f1, "b": f2})
    back = vio.read_vtk(p)
    assert back["fields"]["a"].shape == tuple(mesh.nx) + (1,) * (3 - mesh.dim)
    assert np.array_equal(back["fields"]["a"].reshape(mesh.nx), f1)
    assert np.array_equal(back["fields"]["b"].reshape(mesh.nx), _np(f2[0].float()))
    assert_allclose(back["coords"][0], np.asarray(mesh._x_np[0], np.float32))
    return p


def test_vtk_export_roundtrip_2d(tmp_path) -> None:
    _vtk_roundtrip(tmp_path, _mesh(Box[0:1, 0:2], [9, 17]))


def test_vtk_export_roundtrip_3d(tmp_path) -> None:
    _vtk_roundtrip(tmp_path, _mesh(Box[0:1, 0:1, 0:1], [5, 7, 9]))


def test_vtk_python_fallback_matches_native(tmp_path, monkeypatch) -> None:
    """The numpy path writes byte-identical files to the C++ writer."""
    mesh = _mesh(Box[0:1, 0:1], [6, 8])
    f = np.random.default_rng(5).standard_normal(tuple(mesh.nx)).astype(np.float32)
    p1 = vio.write_vtk(str(tmp_path / "nat"), mesh, {"phi": f})
    monkeypatch.setattr(native, "load", lambda: None)
    p2 = vio.write_vtk(str(tmp_path / "pyf"), mesh, {"phi": f})
    if native.available():
        assert open(p1, "rb").read() == open(p2, "rb").read()
    back = vio.read_vtk(p2)
    assert np.array_equal(back["fields"]["phi"].reshape(mesh.nx), f)


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_vtk_bytes_identical_to_jax(tmp_path, dims) -> None:
    """The port's VTK files are the JAX package's bytes for the same mesh
    and fields (f64 fields rounded to f32 alike; a tensor and its array)."""
    nx = [9, 6, 5][:dims]
    box = tuple(slice(0, 1 + j) for j in range(dims))
    rng = np.random.default_rng(dims)
    fields = {"u": rng.standard_normal(nx), "p": rng.standard_normal([1] + nx)}
    pj = jio.write_vtk(str(tmp_path / "j"), JMesh(JBox[box], None, nx),
                       {k: jnp.asarray(v) for k, v in fields.items()})
    pp = vio.write_vtk(str(tmp_path / "p"), _mesh(Box[box], nx),
                       {k: torch.as_tensor(v) for k, v in fields.items()})
    assert open(pj, "rb").read() == open(pp, "rb").read()


def test_pvd_collection(tmp_path) -> None:
    mesh = _mesh(Box[0:1], [11])
    files = [(0.1 * i, vio.write_vtk(str(tmp_path / f"s{i}"), mesh,
                                     {"u": np.full(mesh.nx, float(i), dtype=np.float32)}))
             for i in range(3)]
    p = vio.write_pvd(str(tmp_path / "series"), files)
    text = open(p).read()
    assert text.count("<DataSet") == 3
    assert 'timestep="0.2"' in text
    pj = jio.write_pvd(str(tmp_path / "series_jax"), files)
    assert open(pj).read() == text


# -- the runner's --vtk / --save / --resume --------------------------------------

def test_runner_cavity_save_resume_vtk(tmp_path) -> None:
    """``cavity --save`` after 3 steps, then ``--resume`` for 3 more, equals
    6 uninterrupted steps bit for bit (state, time, centreline); ``--vtk``
    adds the JAX runner's ``vtk`` key and the file holds u, v and p."""
    base = ["cavity", "--n", "13", "--dt", "0.01", "--device", "cpu", "--dtype", "double"]
    full = runner.run(base + ["--steps", "6", "--save", str(tmp_path / "full")])
    runner.run(base + ["--steps", "3", "--save", str(tmp_path / "half")])
    res = runner.run(base + ["--steps", "3", "--resume", str(tmp_path / "half"),
                             "--save", str(tmp_path / "res"), "--vtk", str(tmp_path / "cav")])
    assert res["t"] == full["t"] and res["u_centerline_min"] == full["u_centerline_min"]
    assert "vtk" not in full and res["vtk"] == str(tmp_path / "cav.vtk")
    with np.load(tmp_path / "full.npz") as a, np.load(tmp_path / "res.npz") as b:
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    back = vio.read_vtk(res["vtk"])
    assert set(back["fields"]) == {"u", "v", "p"}


def test_runner_vtk_keys_as_jax(tmp_path) -> None:
    """``--vtk`` on the poisson, burgers, darcy and rfp cases writes the JAX
    runner's fields; darcy's ``--save`` checkpoints its pressure."""
    cases = {
        "poisson": (["--n", "9", "--dtype", "double"], {"p"}),
        "burgers": (["--n", "17", "--steps", "2", "--dtype", "double"], {"u"}),
        "darcy": (["--n", "9", "--dtype", "double", "--save", str(tmp_path / "d")], {"p", "K"}),
        "rfp": (["--n", "8", "--steps", "2", "--refresh", "1", "--dtype", "double"], {"pdf"}),
    }
    for case, (extra, names) in cases.items():
        out = runner.run([case, "--device", "cpu", "--vtk", str(tmp_path / case)] + extra)
        assert set(vio.read_vtk(out["vtk"])["fields"]) == names, case
    with np.load(tmp_path / "d.npz") as data:
        assert {"p__VAR", "p__VARo", "p__VARoo", "__pyapes_meta__"} == set(data.files)
