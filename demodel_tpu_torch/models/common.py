"""Shared numerics for the model families.

Norm statistics run in float32 whatever the activation dtype: bf16
mean/variance across a wide hidden axis loses enough mantissa to shift
logits (stats in fp32, scale in the activation dtype).
"""

from __future__ import annotations

import torch

from demodel_tpu_torch.ops.flash_default import use_flash_attention as _p


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def use_flash_attention(device: torch.device | str) -> bool:
    """Route model attention on ``device`` through the fused kernel
    (ops/flash_attention.py)? See :mod:`~demodel_tpu_torch.ops.flash_default`."""
    return _p(device)
