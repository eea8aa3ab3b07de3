"""Weights carried across from the JAX package.

:func:`params_from_numpy` turns a Llama params tree of the JAX package,
given as numpy arrays (``jax.tree.map(np.asarray, params)``: projections
``[in, out]``), into the port's dict of tensors, leaf for leaf — the two
packages then compute the same function. bf16 arrays (numpy's
``bfloat16`` extension dtype) are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from demodel_tpu_torch.device import resolve


def to_tensor(arr, device: torch.device,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """One array (numpy, including its bfloat16 extension type, or a
    tensor) as a tensor on ``device``, cast to ``dtype`` when given."""
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        a = np.ascontiguousarray(arr)
        if not a.flags.writeable:  # e.g. a view of a jax buffer
            a = a.copy()
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, cfg, device: str | torch.device | None = None,
                      dtype: torch.dtype | None = None):
    """The JAX params tree (nested dicts/lists of arrays) → the same tree
    of tensors on ``device`` (default ``cuda``) in ``dtype`` (default
    ``cfg.dtype``)."""
    dev = resolve(device)
    dt = dtype or cfg.torch_dtype

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return to_tensor(node, dev, dt)

    return conv(tree)
