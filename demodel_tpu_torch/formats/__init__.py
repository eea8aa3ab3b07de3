"""Weight-file formats of the port: copies of the JAX package's jax-free
``formats`` modules (GGUF, and what the sink needs of safetensors)."""

from demodel_tpu_torch.formats import gguf, safetensors

__all__ = ["gguf", "safetensors"]
