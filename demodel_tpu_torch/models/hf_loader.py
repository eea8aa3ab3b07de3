"""HF-checkpoint → params mapping for Llama, GPT-2 and BERT (the
loaders of ``demodel_tpu/models/hf_loader.py``).

Consumes a flat ``{tensor_name: array}`` holding a ``transformers``-layout
state dict: ``nn.Linear`` stores ``[out, in]``, so Llama's and BERT's
projections transpose on the way in to the port's ``[in, out]``; GPT-2's
``Conv1D`` already stores ``[in, out]`` and loads as stored. Optional name
prefixes ("model.", "transformer.", "bert.") are stripped; a Llama
checkpoint without ``lm_head.weight`` ties the head to the embedding.
BERT's pooler is not read.
"""

from __future__ import annotations

import torch

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.models.bert import BertConfig
from demodel_tpu_torch.models.convert import to_tensor
from demodel_tpu_torch.models.gpt2 import GPT2Config
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


def load_gpt2_params(weights: dict, cfg: GPT2Config,
                     device: str | torch.device | None = None,
                     dtype: torch.dtype | None = None) -> dict:
    """HF GPT-2 state dict → the port's params on ``device`` (default
    ``cuda``), in ``dtype`` when given (else each tensor's own)."""
    w = _Weights(weights, resolve(device), dtype)

    def affine(name):
        return {"w": w.get(name + ".weight"), "b": w.get(name + ".bias")}

    layers = [{"ln_1": affine(f"h.{i}.ln_1"),
               "c_attn": affine(f"h.{i}.attn.c_attn"),
               "c_proj": affine(f"h.{i}.attn.c_proj"),
               "ln_2": affine(f"h.{i}.ln_2"),
               "mlp_fc": affine(f"h.{i}.mlp.c_fc"),
               "mlp_proj": affine(f"h.{i}.mlp.c_proj")}
              for i in range(cfg.n_layer)]
    return {"wte": w.get("wte.weight"), "wpe": w.get("wpe.weight"),
            "layers": layers, "ln_f": affine("ln_f")}


def load_bert_params(weights: dict, cfg: BertConfig,
                     device: str | torch.device | None = None,
                     dtype: torch.dtype | None = None) -> dict:
    """HF BERT state dict (``BertModel``; the pooler is not read) → the
    port's params on ``device`` (default ``cuda``), in ``dtype`` when
    given (else each tensor's own)."""
    w = _Weights(weights, resolve(device), dtype)

    def lin(name):
        return {"w": w.get(name + ".weight", transpose=True),
                "b": w.get(name + ".bias")}

    def ln(name):
        return {"w": w.get(name + ".weight"), "b": w.get(name + ".bias")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layer.{i}."
        layers.append({
            "q": lin(pre + "attention.self.query"),
            "k": lin(pre + "attention.self.key"),
            "v": lin(pre + "attention.self.value"),
            "attn_out": lin(pre + "attention.output.dense"),
            "attn_ln": ln(pre + "attention.output.LayerNorm"),
            "inter": lin(pre + "intermediate.dense"),
            "out": lin(pre + "output.dense"),
            "out_ln": ln(pre + "output.LayerNorm"),
        })
    return {
        "word_emb": w.get("embeddings.word_embeddings.weight"),
        "pos_emb": w.get("embeddings.position_embeddings.weight"),
        "type_emb": w.get("embeddings.token_type_embeddings.weight"),
        "emb_ln": ln("embeddings.LayerNorm"),
        "layers": layers,
    }
