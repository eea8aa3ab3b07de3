"""HF-checkpoint → params mapping for Llama (``load_llama_params`` of
``demodel_tpu/models/hf_loader.py``).

Consumes a flat ``{tensor_name: array}`` holding a ``transformers``-layout
state dict: ``nn.Linear`` stores ``[out, in]``, so projections transpose
on the way in to the port's ``[in, out]``. Optional name prefixes
("model.", "transformer.", "bert.") are stripped; a checkpoint without
``lm_head.weight`` ties the head to the embedding.
"""

from __future__ import annotations

import torch

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.models.convert import to_tensor
from demodel_tpu_torch.models.llama import LlamaConfig

_PREFIXES = ("", "model.", "transformer.", "bert.")


class _Weights:
    def __init__(self, weights: dict, device: torch.device,
                 dtype: torch.dtype | None):
        self.w = weights
        self.device = device
        self.dtype = dtype

    def get(self, name: str, transpose: bool = False) -> torch.Tensor:
        for p in _PREFIXES:
            if p + name in self.w:
                t = to_tensor(self.w[p + name], self.device, self.dtype)
                return t.T if transpose else t
        raise KeyError(f"checkpoint has no tensor {name!r} "
                       f"(tried prefixes {_PREFIXES})")

    def has(self, name: str) -> bool:
        return any(p + name in self.w for p in _PREFIXES)


def load_llama_params(weights: dict, cfg: LlamaConfig,
                      device: str | torch.device | None = None,
                      dtype: torch.dtype | None = None) -> dict:
    """HF Llama state dict → the port's params on ``device`` (default
    ``cuda``), in ``dtype`` when given (else each tensor's own)."""
    w = _Weights(weights, resolve(device), dtype)
    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"layers.{i}."
        layers.append({
            "attn_norm": w.get(pre + "input_layernorm.weight"),
            "q_proj": w.get(pre + "self_attn.q_proj.weight", transpose=True),
            "k_proj": w.get(pre + "self_attn.k_proj.weight", transpose=True),
            "v_proj": w.get(pre + "self_attn.v_proj.weight", transpose=True),
            "o_proj": w.get(pre + "self_attn.o_proj.weight", transpose=True),
            "mlp_norm": w.get(pre + "post_attention_layernorm.weight"),
            "gate_proj": w.get(pre + "mlp.gate_proj.weight", transpose=True),
            "up_proj": w.get(pre + "mlp.up_proj.weight", transpose=True),
            "down_proj": w.get(pre + "mlp.down_proj.weight", transpose=True),
        })
    embed = w.get("embed_tokens.weight")
    if w.has("lm_head.weight"):
        head = w.get("lm_head.weight", transpose=True)
    else:  # tied embeddings
        head = embed.T
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": w.get("norm.weight"),
        "lm_head": head,
    }
