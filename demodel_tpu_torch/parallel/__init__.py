"""Device meshes of the port (one GPU until ROADMAP A7)."""

from demodel_tpu_torch.parallel.mesh import Mesh, make_mesh, one_device

__all__ = ["Mesh", "make_mesh", "one_device"]
