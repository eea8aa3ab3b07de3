"""BERT encoder family (``bert-base-uncased``'s architecture).

Counterpart of ``demodel_tpu/models/bert.py``: a post-LN encoder with
token types and erf GELU, the same params tree as a dict of tensors
(projections ``[in, out]``). A padding mask is an additive float32 bias
of -1e30 (large but finite, so a fully padded row keeps a valid softmax
and finite outputs). Attention goes through the fused kernel
(bidirectional) only when there is no mask and
:func:`~demodel_tpu_torch.models.common.use_flash_attention` says so: the
kernel takes one key window for the whole batch, so per-example masks
keep the einsum path, as in the JAX package.
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
from demodel_tpu_torch.parallel.mesh import Mesh, one_device

NEG_INF = -1e30


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=64)

    @classmethod
    def from_hf(cls, config: dict) -> "BertConfig":
        return cls(
            vocab_size=config.get("vocab_size", 30522),
            hidden_size=config.get("hidden_size", 768),
            num_hidden_layers=config.get("num_hidden_layers", 12),
            num_attention_heads=config.get("num_attention_heads", 12),
            intermediate_size=config.get("intermediate_size", 3072),
            max_position_embeddings=config.get("max_position_embeddings", 512),
            type_vocab_size=config.get("type_vocab_size", 2),
            layer_norm_eps=config.get("layer_norm_eps", 1e-12),
        )


def init_params(generator: torch.Generator | None, cfg: BertConfig,
                device: str | torch.device | None = None) -> dict:
    """Random weights from ``generator`` (on ``device``; None seeds one
    with 0), made on ``device`` (default ``cuda``) in ``cfg.dtype``:
    projections ~ N(0, 1/fan_in), embeddings ~ N(0, 0.02²), norms 1 and
    biases 0 — the JAX package's recipe, not its numbers."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    dt = cfg.torch_dtype
    D, I = cfg.hidden_size, cfg.intermediate_size

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    def dense(n_in, n_out):
        return {"w": (normal((n_in, n_out)) / math.sqrt(n_in)).to(dt),
                "b": torch.zeros((n_out,), dtype=dt, device=dev)}

    def ln():
        return {"w": torch.ones((D,), dtype=dt, device=dev),
                "b": torch.zeros((D,), dtype=dt, device=dev)}

    def emb(rows):
        return (normal((rows, D)) * 0.02).to(dt)

    with torch.no_grad():
        layers = [{"q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
                   "attn_out": dense(D, D), "attn_ln": ln(),
                   "inter": dense(D, I), "out": dense(I, D), "out_ln": ln()}
                  for _ in range(cfg.num_hidden_layers)]
        return {"word_emb": emb(cfg.vocab_size),
                "pos_emb": emb(cfg.max_position_embeddings),
                "type_emb": emb(cfg.type_vocab_size), "emb_ln": ln(),
                "layers": layers}


def param_shardings(cfg: BertConfig, mesh: Mesh) -> dict:
    """The partition spec of every leaf (tp shards q, k, v and ``inter``
    by column, ``attn_out`` and ``out`` by row), for a one-device
    ``mesh``; more devices raise (ROADMAP A7)."""
    one_device(mesh, "BERT param_shardings")
    ln = {"w": (None,), "b": (None,)}
    col = {"w": (None, "tp"), "b": (None,)}
    row = {"w": ("tp", None), "b": (None,)}
    layer = {"q": col, "k": col, "v": col, "attn_out": row, "attn_ln": ln,
             "inter": col, "out": row, "out_ln": ln}
    return {"word_emb": (None, None), "pos_emb": (None, None),
            "type_emb": (None, None), "emb_ln": ln,
            "layers": [layer] * cfg.num_hidden_layers}


def encode(params, tokens: torch.Tensor, cfg: BertConfig,
           attention_mask: torch.Tensor | None = None,
           token_type_ids: torch.Tensor | None = None,
           mesh: Mesh | None = None) -> torch.Tensor:
    """tokens [B, T] → last hidden state [B, T, D]. ``attention_mask``
    [B, T]: keys where it is 0 are padding."""
    del mesh
    B, T = tokens.shape
    eps = cfg.layer_norm_eps
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(tokens)
    pos = torch.arange(T, device=tokens.device)
    x = (params["word_emb"][tokens] + params["pos_emb"][pos]
         + params["type_emb"][token_type_ids])
    x = layer_norm(x, params["emb_ln"]["w"], params["emb_ln"]["b"], eps)
    H = cfg.num_attention_heads
    hd = cfg.hidden_size // H
    flash = attention_mask is None and use_flash_attention(x.device)
    if attention_mask is None:
        bias = torch.zeros((B, 1, 1, T), dtype=torch.float32,
                           device=x.device)
    else:
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           NEG_INF)  # float32
    for layer in params["layers"]:
        q, k, v = ((x @ layer[n]["w"] + layer[n]["b"]).view(B, T, H, hd)
                   for n in ("q", "k", "v"))
        if flash:
            a = flash_attention(q, k, v, causal=False)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
            probs = torch.softmax(scores.float() + bias, dim=-1).to(x.dtype)
            a = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        a = a.reshape(B, T, -1) @ layer["attn_out"]["w"] \
            + layer["attn_out"]["b"]
        x = layer_norm(x + a, layer["attn_ln"]["w"], layer["attn_ln"]["b"],
                       eps)
        h = F.gelu(x @ layer["inter"]["w"] + layer["inter"]["b"])
        h = h @ layer["out"]["w"] + layer["out"]["b"]
        x = layer_norm(x + h, layer["out_ln"]["w"], layer["out_ln"]["b"], eps)
    return x
