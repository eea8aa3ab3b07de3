"""PyTorch/CUDA port of the demodel-tpu device plane.

The package mirrors ``demodel_tpu``'s module paths so each counterpart is
easy to find: ``ops/`` holds the attention and GGUF dequant kernels
(hand-written CUDA for Hopper, ``csrc/``) beside their plain PyTorch
versions, ``formats/`` the GGUF and safetensors readers, ``sink/`` and
``parallel/`` the placement of weight files onto the device,
``models/`` the Llama step functions, ``serve/`` the continuous-batching
engine and its ``/generate`` HTTP surface.

It imports torch, numpy and the standard library only — never jax and
never ``demodel_tpu``; what it needs from a jax-free module there is
copied here. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`demodel_tpu_torch.device`).
"""

from __future__ import annotations

__version__ = "0.1.0"
