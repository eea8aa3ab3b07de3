"""GPT-2 family: learned positions, pre-LN blocks, fused QKV, tied head.

Counterpart of ``demodel_tpu/models/gpt2.py``: the same params tree as a
dict of tensors. HF's ``Conv1D`` stores its weights ``[in, out]``, which
is how this forward consumes them (``x @ W``), so the loader transposes
nothing. Attention goes through the fused kernel
(:func:`~demodel_tpu_torch.ops.flash_attention.flash_attention`, causal)
when :func:`~demodel_tpu_torch.models.common.use_flash_attention` says so
(by default: on CUDA); otherwise it is einsum attention with masked
scores set to -1e30 and the softmax in float32, as in the JAX package.

q, k and v are column slices of one ``c_attn`` output (a row stride of
3·n_embd elements): the kernel reads them in place at head dim 64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.models.common import (
    DTYPES,
    layer_norm,
    use_flash_attention,
)
from demodel_tpu_torch.ops.flash_attention import flash_attention
from demodel_tpu_torch.ops.ring_attention import mask_scores
from demodel_tpu_torch.parallel.mesh import Mesh, one_device


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @classmethod
    def tiny(cls) -> "GPT2Config":
        return cls(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                   n_head=4)

    @classmethod
    def from_hf(cls, config: dict) -> "GPT2Config":
        return cls(
            vocab_size=config.get("vocab_size", 50257),
            n_positions=config.get("n_positions", 1024),
            n_embd=config.get("n_embd", 768),
            n_layer=config.get("n_layer", 12),
            n_head=config.get("n_head", 12),
            layer_norm_epsilon=config.get("layer_norm_epsilon", 1e-5),
        )


def init_params(generator: torch.Generator | None, cfg: GPT2Config,
                device: str | torch.device | None = None) -> dict:
    """Random weights from ``generator`` (on ``device``; None seeds one
    with 0), made on ``device`` (default ``cuda``) in ``cfg.dtype``:
    projections ~ N(0, 1/fan_in), token embeddings ~ N(0, 0.02²),
    positions ~ N(0, 0.01²), norms 1 and biases 0 — the JAX package's
    recipe, not its numbers."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    dt = cfg.torch_dtype
    D = cfg.n_embd

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    def dense(n_in, n_out):
        return {"w": (normal((n_in, n_out)) / math.sqrt(n_in)).to(dt),
                "b": torch.zeros((n_out,), dtype=dt, device=dev)}

    def ln():
        return {"w": torch.ones((D,), dtype=dt, device=dev),
                "b": torch.zeros((D,), dtype=dt, device=dev)}

    with torch.no_grad():
        layers = [{"ln_1": ln(), "c_attn": dense(D, 3 * D),
                   "c_proj": dense(D, D), "ln_2": ln(),
                   "mlp_fc": dense(D, 4 * D), "mlp_proj": dense(4 * D, D)}
                  for _ in range(cfg.n_layer)]
        return {"wte": (normal((cfg.vocab_size, D)) * 0.02).to(dt),
                "wpe": (normal((cfg.n_positions, D)) * 0.01).to(dt),
                "layers": layers, "ln_f": ln()}


def param_shardings(cfg: GPT2Config, mesh: Mesh) -> dict:
    """The partition spec of every leaf (tp shards ``c_attn``/``mlp_fc``
    by column and ``c_proj``/``mlp_proj`` by row), for a one-device
    ``mesh``; more devices raise (ROADMAP A7)."""
    one_device(mesh, "GPT-2 param_shardings")
    ln = {"w": (None,), "b": (None,)}
    col = {"w": (None, "tp"), "b": (None,)}
    row = {"w": ("tp", None), "b": (None,)}
    layer = {"ln_1": ln, "c_attn": col, "c_proj": row, "ln_2": ln,
             "mlp_fc": col, "mlp_proj": row}
    return {"wte": (None, None), "wpe": (None, None),
            "layers": [layer] * cfg.n_layer, "ln_f": ln}


def forward(params, tokens: torch.Tensor, cfg: GPT2Config,
            mesh: Mesh | None = None) -> torch.Tensor:
    """tokens [B, T] → logits [B, T, V] (head tied to wte, as HF)."""
    del mesh  # dense attention; placement comes from the params
    B, T = tokens.shape
    eps = cfg.layer_norm_epsilon
    H = cfg.n_head
    hd = cfg.n_embd // H
    pos = torch.arange(T, device=tokens.device)
    x = params["wte"][tokens] + params["wpe"][pos]
    flash = use_flash_attention(x.device)
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    for layer in params["layers"]:
        h = layer_norm(x, layer["ln_1"]["w"], layer["ln_1"]["b"], eps)
        qkv = h @ layer["c_attn"]["w"] + layer["c_attn"]["b"]
        q, k, v = (t.view(B, T, H, hd) for t in qkv.split(cfg.n_embd, -1))
        if flash:
            a = flash_attention(q, k, v, causal=True)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
            scores = mask_scores(scores, mask[None, None])
            probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
            a = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        a = a.reshape(B, T, -1)
        x = x + (a @ layer["c_proj"]["w"] + layer["c_proj"]["b"])
        h = layer_norm(x, layer["ln_2"]["w"], layer["ln_2"]["b"], eps)
        h = F.gelu(h @ layer["mlp_fc"]["w"] + layer["mlp_fc"]["b"],
                   approximate="tanh")
        x = x + (h @ layer["mlp_proj"]["w"] + layer["mlp_proj"]["b"])
    x = layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"], eps)
    return x @ params["wte"].T  # tied head
