"""Default policy for the fused attention kernel.

``DEMODEL_FLASH_ATTN`` is the caller's explicit choice and always wins:
``1`` routes model attention through :func:`flash_attention` anywhere
(on CPU tensors that is the kernel's plain version), ``0`` forces the
einsum path. Unset, the kernel is on exactly when the tensors are on
CUDA. There is no validation-record gate: the kernel is held against its
plain version by ``chip_smoke.py`` and the tests instead.
"""

from __future__ import annotations

import torch

from demodel_tpu_torch.utils.env import flash_attn_env


def use_flash_attention(device: torch.device | str) -> bool:
    """Should model attention on ``device`` route through the kernel?"""
    env = flash_attn_env()
    if env is not None:
        return env
    return torch.device(device).type == "cuda"
