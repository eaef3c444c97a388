"""pyapes-tpu-torch: the PyTorch / CUDA port of ``pyapes_tpu``.

Same public surface as the JAX package (``Mesh``, ``Field``, ``FDM``,
``FDC``, ``Solver``, the models and the runner), written in plain PyTorch
with an explicit device on the mesh, and hand-written CUDA kernels for
NVIDIA Hopper (sm_90a) where the JAX package has Pallas TPU kernels. The
JAX package stays the reference the port is tested against; this package
never imports JAX.
"""
__version__ = "0.1.0"


def __getattr__(name):
    # Lazy top-level conveniences.
    if name in ("Box", "Cylinder"):
        from pyapes_tpu_torch import geometry

        return getattr(geometry, name)
    if name == "Mesh":
        from pyapes_tpu_torch.mesh import Mesh

        return Mesh
    if name == "Field":
        from pyapes_tpu_torch.variables import Field

        return Field
    if name in ("FDM", "FDC", "Solver"):
        from pyapes_tpu_torch import solver

        return getattr(solver, name)
    if name == "DomainDecomposition":
        from pyapes_tpu_torch.parallel import DomainDecomposition

        return DomainDecomposition
    raise AttributeError(name)
