"""Sharding plan: tensor name/shape → partition spec for delivery (the
port of ``demodel_tpu/sink/plan.py``).

Weight matrices shard on their leading axis over ``tp`` (contiguous in
safetensors/GGUF files, so every device's shard is a single range read);
small tensors (biases, norms, scalars) replicate. A spec is a tuple that
mirrors jax's ``PartitionSpec``: ``("tp", None, ...)`` splits axis 0 over
``tp``, ``()`` replicates.
"""

from __future__ import annotations

from demodel_tpu_torch.parallel.mesh import Mesh
from demodel_tpu_torch.utils.env import env_int


class ShardingPlan:
    """Default placement rules over a mesh's ``tp`` axis.

    ``min_shard_bytes``: tensors smaller than this replicate — sharding a
    128-byte layernorm wastes more in dispatch than it saves in memory
    (override via ``DEMODEL_MIN_SHARD_KB``).
    """

    def __init__(self, mesh: Mesh, min_shard_bytes: int | None = None):
        self.mesh = mesh
        self.tp = int(mesh.shape.get("tp", 1))
        if min_shard_bytes is None:
            min_shard_bytes = env_int("DEMODEL_MIN_SHARD_KB", 4, minimum=0) << 10
        self.min_shard_bytes = min_shard_bytes

    def sharding_for(self, name: str, shape: tuple[int, ...],
                     itemsize: int) -> tuple[str | None, ...]:
        del name  # rules are shape-driven; name kept for subclass overrides
        nbytes = itemsize
        for d in shape:
            nbytes *= int(d)
        if (len(shape) >= 2 and self.tp > 1 and shape[0] % self.tp == 0
                and nbytes >= self.min_shard_bytes):
            return ("tp",) + (None,) * (len(shape) - 1)
        return ()
