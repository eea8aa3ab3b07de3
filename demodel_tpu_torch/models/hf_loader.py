"""HF-checkpoint → params mapping for Llama, GPT-2 and BERT (the
loaders of ``demodel_tpu/models/hf_loader.py``).

Consumes a flat ``{tensor_name: array}`` holding a ``transformers``-layout
state dict: ``nn.Linear`` stores ``[out, in]``, so Llama's and BERT's
projections transpose on the way in to the port's ``[in, out]``; GPT-2's
``Conv1D`` already stores ``[in, out]`` and loads as stored. Optional name
prefixes ("model.", "transformer.", "bert.") are stripped; a Llama
checkpoint without ``lm_head.weight`` ties the head to the embedding.
BERT's pooler is not read.

Over a mesh of several ranks the weights are a placement's local shards
(each under the spec the delivery plan gave it, which splits a 2-D
weight on axis 0). For HF's ``q_proj.weight`` ``[out, in]`` that is, once
transposed, already the column shard, but for ``o_proj`` and
``down_proj`` it splits the output where row-parallel wants the input.
The JAX package leaves the move to XLA; the Llama loader makes it
explicit, bringing each leaf to :func:`~demodel_tpu_torch.models.llama.
param_shardings`' layout through
:func:`~demodel_tpu_torch.parallel.collectives.redistribute` (that
swap is one all-to-all).
"""

from __future__ import annotations

import torch

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.models.bert import BertConfig
from demodel_tpu_torch.models.convert import to_tensor
from demodel_tpu_torch.models.gpt2 import GPT2Config
from demodel_tpu_torch.models.llama import LlamaConfig, param_shardings
from demodel_tpu_torch.parallel import collectives
from demodel_tpu_torch.parallel.mesh import Mesh

_PREFIXES = ("", "model.", "transformer.", "bert.")


class _Weights:
    def __init__(self, weights: dict, device: torch.device,
                 dtype: torch.dtype | None, mesh: Mesh | None = None,
                 specs: dict | None = None):
        self.w = weights
        self.device = device
        self.dtype = dtype
        self.mesh = mesh
        self.specs = specs or {}

    def get(self, name: str, transpose: bool = False,
            spec: tuple | None = None) -> torch.Tensor:
        """The tensor, transposed when asked, as this rank's shard under
        ``spec`` (on a mesh; its placed spec read from ``specs``)."""
        for p in _PREFIXES:
            if p + name in self.w:
                t = to_tensor(self.w[p + name], self.device, self.dtype)
                src = tuple(self.specs.get(p + name, ()))
                if transpose:
                    t = t.T
                    src = tuple(reversed(src + (None,) * (2 - len(src))))
                if self.mesh is not None and spec is not None:
                    t = collectives.redistribute(t, self.mesh, src, spec)
                return t
        raise KeyError(f"checkpoint has no tensor {name!r} "
                       f"(tried prefixes {_PREFIXES})")

    def has(self, name: str) -> bool:
        return any(p + name in self.w for p in _PREFIXES)


def load_llama_params(weights: dict, cfg: LlamaConfig,
                      device: str | torch.device | None = None,
                      dtype: torch.dtype | None = None,
                      mesh: Mesh | None = None,
                      specs: dict | None = None) -> dict:
    """HF Llama state dict → the port's params on ``device`` (default
    ``cuda``), in ``dtype`` when given (else each tensor's own). On
    ``mesh`` the weights are this rank's shards under ``specs`` (a
    placement's; a name missing there is whole) and each leaf comes out
    as its shard under :func:`~demodel_tpu_torch.models.llama.
    param_shardings`."""
    w = _Weights(weights, resolve(device), dtype, mesh, specs)
    sh = (param_shardings(cfg, mesh) if mesh is not None else
          {"embed": None, "final_norm": None, "lm_head": None,
           "layers": [{}] * cfg.num_hidden_layers})
    names = {"attn_norm": "input_layernorm",
             "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
             "mlp_norm": "post_attention_layernorm",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj"}
    layers = []
    for i in range(cfg.num_hidden_layers):
        spec = sh["layers"][i]
        layers.append({
            leaf: w.get(f"layers.{i}.{hf}.weight",
                        transpose=not leaf.endswith("norm"),
                        spec=spec.get(leaf))
            for leaf, hf in names.items()})
    embed = w.get("embed_tokens.weight", spec=sh["embed"])
    if w.has("lm_head.weight"):
        head = w.get("lm_head.weight", transpose=True, spec=sh["lm_head"])
    else:  # tied embeddings: embed's shard, transposed, is the head's
        head = embed.T
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": w.get("norm.weight", spec=sh["final_norm"]),
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
