"""Seeded ``transformers``-layout GPT-2 and BERT checkpoints for the port's
tests: HF tensor names and layouts (GPT-2's ``Conv1D`` weights ``[in,
out]``, BERT's ``nn.Linear`` weights ``[out, in]``, BERT's pooler
included), float32 numpy, and the files a Hub repo holds (``config.json``
and one safetensors shard)."""

from __future__ import annotations

import json

import numpy as np

from demodel_tpu_torch.formats import safetensors as tst

GPT2_CONFIG = {"model_type": "gpt2", "vocab_size": 256, "n_positions": 64,
               "n_embd": 64, "n_layer": 2, "n_head": 4,
               "layer_norm_epsilon": 1e-5, "torch_dtype": "float32"}
BERT_CONFIG = {"model_type": "bert", "vocab_size": 256, "hidden_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 4,
               "intermediate_size": 128, "max_position_embeddings": 64,
               "type_vocab_size": 2, "layer_norm_eps": 1e-12,
               "torch_dtype": "float32"}


def _normal(rng):
    def w(*shape, std=None, mean=0.0):
        return (mean + rng.standard_normal(shape)
                * (std or shape[0] ** -0.5)).astype(np.float32)
    return w


def gpt2_state(cfg: dict = GPT2_CONFIG, seed: int = 0) -> dict:
    """A GPT2LMHeadModel state dict (``transformer.`` names, the tied
    ``lm_head.weight``) of seeded random weights."""
    w = _normal(np.random.default_rng(seed))
    D, V = cfg["n_embd"], cfg["vocab_size"]
    sd = {"transformer.wte.weight": w(V, D, std=0.02),
          "transformer.wpe.weight": w(cfg["n_positions"], D, std=0.01)}
    for i in range(cfg["n_layer"]):
        p = f"transformer.h.{i}."
        for name, n_in, n_out in (("attn.c_attn", D, 3 * D),
                                  ("attn.c_proj", D, D),
                                  ("mlp.c_fc", D, 4 * D),
                                  ("mlp.c_proj", 4 * D, D)):
            sd[p + name + ".weight"] = w(n_in, n_out)
            sd[p + name + ".bias"] = w(n_out, std=0.1)
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = w(D, std=0.1, mean=1.0)
            sd[p + ln + ".bias"] = w(D, std=0.1)
    sd["transformer.ln_f.weight"] = w(D, std=0.1, mean=1.0)
    sd["transformer.ln_f.bias"] = w(D, std=0.1)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def bert_state(cfg: dict = BERT_CONFIG, seed: int = 0) -> dict:
    """A BertModel state dict (``bert.`` names, the pooler included) of
    seeded random weights."""
    w = _normal(np.random.default_rng(seed))
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    e = "bert.embeddings."
    sd = {e + "word_embeddings.weight": w(cfg["vocab_size"], D, std=0.02),
          e + "position_embeddings.weight":
              w(cfg["max_position_embeddings"], D, std=0.02),
          e + "token_type_embeddings.weight":
              w(cfg["type_vocab_size"], D, std=0.02),
          e + "LayerNorm.weight": w(D, std=0.1, mean=1.0),
          e + "LayerNorm.bias": w(D, std=0.1)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}."
        for name, n_in, n_out in (("attention.self.query", D, D),
                                  ("attention.self.key", D, D),
                                  ("attention.self.value", D, D),
                                  ("attention.output.dense", D, D),
                                  ("intermediate.dense", D, I),
                                  ("output.dense", I, D)):
            sd[p + name + ".weight"] = w(n_out, n_in, std=n_in ** -0.5)
            sd[p + name + ".bias"] = w(n_out, std=0.1)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = w(D, std=0.1, mean=1.0)
            sd[p + ln + ".bias"] = w(D, std=0.1)
    sd["bert.pooler.dense.weight"] = w(D, D)
    sd["bert.pooler.dense.bias"] = w(D, std=0.1)
    return sd


def repo_files(config: dict, state: dict) -> dict:
    """The Hub repo of ``state``: config.json and model.safetensors (a
    tied tensor stored once, as ``transformers`` saves it)."""
    seen, shard = set(), {}
    for name, arr in state.items():
        if id(arr) not in seen:
            seen.add(id(arr))
            shard[name] = arr
    return {"config.json": json.dumps(config).encode(),
            "model.safetensors": tst.serialize(shard)}
