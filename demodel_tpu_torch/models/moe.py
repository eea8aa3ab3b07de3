"""Mixture-of-Experts LM: top-1 token-choice routing with a capacity.

Counterpart of ``demodel_tpu/models/moe.py`` on one device. A token goes
to its most probable expert (the first on ties); each expert serves the
tokens that chose it in arrival order up to its capacity and drops the
rest (they contribute zero). Dispatch and combine are dense one-hot
einsums, the reference's static-shape formulation, so the function, its
drops and its gradient are the JAX package's. MoE has no attention and
no kernel: its matmuls are cuBLAS's. The ``ep`` axis that shards the
experts is ROADMAP A7.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.models.common import (
    DTYPES,
    momentum_sgd,
    next_token_nll,
    rms_norm,
)
from demodel_tpu_torch.parallel.mesh import Mesh, one_device


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 256
    hidden_size: int = 64
    intermediate_size: int = 128
    num_layers: int = 2
    num_experts: int = 4
    capacity_factor: float = 1.25
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @classmethod
    def tiny(cls) -> "MoEConfig":
        return cls()


def init_params(generator: torch.Generator | None, cfg: MoEConfig,
                device: str | torch.device | None = None) -> dict:
    """Random weights from ``generator`` (on ``device``; None seeds one
    with 0), made on ``device`` (default ``cuda``) in ``cfg.dtype``:
    router and experts ~ N(0, 1/fan_in), embedding ~ N(0, 0.02²), norms 1
    — the JAX package's recipe, not its numbers."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    dt = cfg.torch_dtype
    D, I, E, V = (cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
                  cfg.vocab_size)

    def normal(shape, fan_in=None):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (t / math.sqrt(fan_in) if fan_in else t * 0.02).to(dt)

    def ones():
        return torch.ones((D,), dtype=dt, device=dev)

    with torch.no_grad():
        layers = [{"norm": ones(), "router": normal((D, E), D),
                   "w_in": normal((E, D, I), D), "w_out": normal((E, I, D), I)}
                  for _ in range(cfg.num_layers)]
        return {"embed": normal((V, D)), "layers": layers,
                "final_norm": ones(), "head": normal((D, V), D)}


def param_shardings(cfg: MoEConfig, mesh: Mesh) -> dict:
    """The partition spec of every leaf (expert weights on the ``ep``
    axis), for a one-device ``mesh``; more devices raise (ROADMAP A7)."""
    one_device(mesh, "MoE param_shardings")
    layer = {"norm": (None,), "router": (None, None),
             "w_in": ("ep", None, None), "w_out": ("ep", None, None)}
    return {"embed": (None, None), "layers": [layer] * cfg.num_layers,
            "final_norm": (None,), "head": (None, None)}


def route(logits: torch.Tensor, capacity: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routing with per-expert capacity.

    logits [N, E] → (combine [N, E, C] in logits' dtype, dispatch bool
    [N, E, C]). Each token occupies at most one slot; each (expert, slot)
    holds at most one token; tokens past an expert's capacity are
    dropped. The integer part (choice, queue position, cut) is exact."""
    E = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)                  # first max
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, E)                         # [N, E] int64
    # position of each token within its expert's queue (arrival order)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1        # -1: not chosen
    kept = (pos >= 0) & (pos < capacity)
    slot = torch.where(kept, pos, 0)
    dispatch = kept[..., None] & (F.one_hot(slot, capacity) > 0)
    combine = dispatch * gate[:, None, None]
    return combine.to(logits.dtype), dispatch


def moe_ffn(layer, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x [B, T, D] → [B, T, D] through capacity-routed experts."""
    B, T, D = x.shape
    N = B * T
    capacity = max(1, int(cfg.capacity_factor * N / cfg.num_experts))
    flat = x.reshape(N, D)
    combine, dispatch = route(flat @ layer["router"], capacity)
    buf = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), flat)
    h = F.silu(torch.einsum("ecd,edi->eci", buf, layer["w_in"]))
    out = torch.einsum("eci,eid->ecd", h, layer["w_out"])
    return torch.einsum("nec,ecd->nd", combine, out).reshape(B, T, D)


def forward(params, tokens: torch.Tensor, cfg: MoEConfig,
            mesh: Mesh | None = None) -> torch.Tensor:
    """tokens [B, T] → logits [B, T, V]."""
    del mesh
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = x + moe_ffn(layer, rms_norm(x, layer["norm"]), cfg)
    return rms_norm(x, params["final_norm"]) @ params["head"]


def loss_fn(params, tokens: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Next-token cross entropy (fp32 logits for the softmax)."""
    return next_token_nll(forward(params, tokens[:, :-1], cfg), tokens)


def make_train_step(cfg: MoEConfig, mesh: Mesh | None = None,
                    lr: float = 1e-3, momentum: float = 0.9):
    """``(init_opt, train_step)``, momentum SGD as Llama's
    (:func:`~demodel_tpu_torch.models.common.momentum_sgd`). ``mesh``:
    one device (more raise, ROADMAP A7)."""
    if mesh is not None:
        one_device(mesh, "the MoE train step")
    return momentum_sgd(lambda p, t: loss_fn(p, t, cfg), lr, momentum)
