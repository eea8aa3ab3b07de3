"""Shared numerics for the model families, and their training step.

Norm statistics run in float32 whatever the activation dtype: bf16
mean/variance across a wide hidden axis loses enough mantissa to shift
logits (stats in fp32, scale in the activation dtype).

:func:`momentum_sgd` is the ``make_train_step`` of the JAX package's
Llama and MoE families: ``jax.value_and_grad`` of the loss becomes
autograd over a detached copy of every leaf, and the momentum state
mirrors the params tree leaf for leaf, in each leaf's own dtype.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from demodel_tpu_torch.ops.flash_default import use_flash_attention as _p
from demodel_tpu_torch.utils.tree import leaves, tree_map, unflatten

#: a config's ``dtype`` name → its torch dtype (every family's
#: ``torch_dtype``)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * weight + bias


def use_flash_attention(device: torch.device | str) -> bool:
    """Route model attention on ``device`` through the fused kernel
    (ops/flash_attention.py)? See :mod:`~demodel_tpu_torch.ops.flash_default`."""
    return _p(device)


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of ``logits`` [B, T-1, V] (the forward of
    ``tokens[:, :-1]``) against ``tokens[:, 1:]``, the softmax in
    float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean()


def momentum_sgd(loss_fn: Callable[[dict, torch.Tensor], torch.Tensor],
                 lr: float = 1e-3, momentum: float = 0.9,
                 reduce_grads: Callable[[list], list] | None = None):
    """``(init_opt, train_step)`` for ``loss_fn(params, tokens)``:
    ``init_opt(params)`` is a zero tree like ``params``;
    ``train_step(params, opt, tokens)`` returns ``(new_params, new_opt,
    loss)`` with ``new_opt = momentum·opt + grad`` and ``new_params =
    params − lr·new_opt``, new trees (the inputs are not modified).
    ``reduce_grads`` maps the gradient leaves before the update (the sum
    over the ranks of a split batch)."""

    def init_opt(params):
        return tree_map(torch.zeros_like, params)

    def train_step(params, opt_state, tokens):
        inputs = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = loss_fn(inputs, tokens)
            grads = torch.autograd.grad(loss, leaves(inputs))
        if reduce_grads is not None:
            grads = reduce_grads(list(grads))
        grads = unflatten(params, grads)
        with torch.no_grad():
            new_opt = tree_map(lambda m, g: momentum * m + g, opt_state,
                               grads)
            del grads  # before the new params: two new trees at a time
            new_params = tree_map(lambda p, m: p - lr * m, params, new_opt)
        return new_params, new_opt, loss.detach()

    return init_opt, train_step
