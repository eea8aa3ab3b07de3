"""Llama family — the model the serving plane runs.

Counterpart of ``demodel_tpu/models/llama.py``: the same params tree as
a plain dict of tensors (projections stored ``[in, out]``, so ``x @ W``),
GQA attention with HF's rotate-half RoPE, and the serving step functions
``step_prefill`` / ``step_decode``. Prefill attention goes through the
fused kernel (:func:`~demodel_tpu_torch.ops.flash_attention.flash_attention`)
when :func:`~demodel_tpu_torch.models.common.use_flash_attention` says so
(by default: on CUDA); the decode step is einsum attention with no
kernel, exactly as in the JAX package.

Mixed dtypes promote as ``jnp`` does: a bf16 model decoding over an fp32
KV pool computes attention, and from there the residual stream, in fp32.
``torch.matmul``/``einsum`` do not promote on their own, so :func:`_mm`
and :func:`_einsum` cast both operands to the promoted type first.

Not ported here: ``param_shardings`` and the ``sp`` ring branch (the
multi-GPU slice), ``_head_align`` (an XLA/GSPMD workaround with no
single-device counterpart) and the train step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.models.common import rms_norm, use_flash_attention
from demodel_tpu_torch.ops.flash_attention import flash_attention
from demodel_tpu_torch.ops.ring_attention import dense_attention, mask_scores

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Test-sized config: real GQA (4 q heads per kv head)."""
        return cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=8,
                   num_key_value_heads=2)

    @classmethod
    def from_hf(cls, config: dict) -> "LlamaConfig":
        return cls(
            vocab_size=config.get("vocab_size", 32000),
            hidden_size=config.get("hidden_size", 4096),
            intermediate_size=config.get("intermediate_size", 11008),
            num_hidden_layers=config.get("num_hidden_layers", 32),
            num_attention_heads=config.get("num_attention_heads", 32),
            num_key_value_heads=config.get(
                "num_key_value_heads", config.get("num_attention_heads", 32)),
            rope_theta=config.get("rope_theta", 10000.0),
            rms_norm_eps=config.get("rms_norm_eps", 1e-6),
        )


# ------------------------------------------------------------------ params


def init_params(generator: torch.Generator | None, cfg: LlamaConfig,
                device: str | torch.device | None = None) -> dict:
    """Random weights from ``generator`` (a ``torch.Generator`` on
    ``device``; None seeds one with 0), made on ``device`` (default
    ``cuda``) in ``cfg.dtype``: projections ~ N(0, 1/fan_in), embeddings
    ~ N(0, 0.02²), norms 1 — the JAX package's recipe, not its numbers."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    dt = cfg.torch_dtype
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd = cfg.head_dim
    H, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    def dense(shape):
        return (normal(shape) / math.sqrt(shape[0])).to(dt)

    def ones():
        return torch.ones((D,), dtype=dt, device=dev)

    with torch.no_grad():
        layers = [{
            "attn_norm": ones(),
            "q_proj": dense((D, H * hd)),
            "k_proj": dense((D, Hkv * hd)),
            "v_proj": dense((D, Hkv * hd)),
            "o_proj": dense((H * hd, D)),
            "mlp_norm": ones(),
            "gate_proj": dense((D, I)),
            "up_proj": dense((D, I)),
            "down_proj": dense((I, D)),
        } for _ in range(cfg.num_hidden_layers)]
        embed = (normal((V, D)) * 0.02).to(dt)
        return {"embed": embed, "layers": layers, "final_norm": ones(),
                "lm_head": dense((D, V))}


# --------------------------------------------------------------- helpers


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jnp's dtype promotion (bf16 @ f32 → f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """HF rotate-half convention: pairs are (i, i + hd/2)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    ang = positions[..., None].float() * torch.from_numpy(inv).to(x.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- forward


def _attn(layer, x, cfg: LlamaConfig, positions, kv_cache=None,
          cache_pos: int | None = None):
    B, T, _ = x.shape
    hd = cfg.head_dim
    H, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    q = _rope(_mm(x, layer["q_proj"]).reshape(B, T, H, hd), positions,
              cfg.rope_theta)
    k = _rope(_mm(x, layer["k_proj"]).reshape(B, T, Hkv, hd), positions,
              cfg.rope_theta)
    v = _mm(x, layer["v_proj"]).reshape(B, T, Hkv, hd)

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        # in place (JAX's dynamic_update_slice is functional): the cache
        # is the decode-time memory bill, so it is never copied
        ck[:, cache_pos:cache_pos + T] = k
        cv[:, cache_pos:cache_pos + T] = v
        new_cache = (ck, cv)
        if use_flash_attention(q.device):
            # fused: no repeat of the cache across query heads, K tiles
            # past the filled prefix skipped
            out = flash_attention(q, ck, cv, kv_len=cache_pos + T,
                                  causal=True)
        else:
            S = ck.shape[1]
            kk = ck.repeat_interleave(H // Hkv, dim=2)
            vv = cv.repeat_interleave(H // Hkv, dim=2)
            scores = _einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
            kpos = torch.arange(S, device=x.device)
            qpos = cache_pos + torch.arange(T, device=x.device)
            mask = kpos[None, :] <= qpos[:, None]
            scores = mask_scores(scores, mask[None, None])
            probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
            out = _einsum("bhqk,bkhd->bqhd", probs, vv)
    elif use_flash_attention(q.device):
        out = flash_attention(q, k, v, causal=True)
    else:
        out = dense_attention(q, k, v, causal=True)
    return _mm(out.reshape(B, T, H * hd), layer["o_proj"]), new_cache


def _mlp(layer, y):
    return _mm(F.silu(_mm(y, layer["gate_proj"])) * _mm(y, layer["up_proj"]),
               layer["down_proj"])


def _block(layer, x, cfg, positions, kv_cache=None, cache_pos=None):
    h, new_cache = _attn(layer, rms_norm(x, layer["attn_norm"],
                                         cfg.rms_norm_eps),
                         cfg, positions, kv_cache, cache_pos)
    x = x + h
    x = x + _mlp(layer, rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps))
    return x, new_cache


def _head(params, x, cfg):
    return _mm(rms_norm(x, params["final_norm"], cfg.rms_norm_eps),
               params["lm_head"])


def forward(params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """tokens [B, T] int → logits [B, T, V]."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x, _ = _block(layer, x, cfg, positions)
    return _head(params, x, cfg)


# ------------------------------------------------------------ decode path


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None):
    """Per-layer zero ``(k, v)`` pairs, each [batch, max_len, Hkv, hd],
    in ``dtype`` (default ``cfg.dtype``) on ``device`` (default cuda)."""
    dt = dtype or cfg.torch_dtype
    dev = resolve(device)
    shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))
            for _ in range(cfg.num_hidden_layers)]


def forward_with_cache(params, tokens: torch.Tensor, cfg: LlamaConfig,
                       cache, pos: int):
    """Incremental forward: ``tokens`` [B, T] appended at ``pos`` (prefill
    with T>1, decode with T=1). Returns (logits, cache); the cache
    tensors are updated in place and returned."""
    B, T = tokens.shape
    positions = pos + torch.arange(T, device=tokens.device).expand(B, T)
    x = params["embed"][tokens]
    new_cache = []
    for layer, kv in zip(params["layers"], cache):
        x, nkv = _block(layer, x, cfg, positions, kv_cache=kv, cache_pos=pos)
        new_cache.append(nkv)
    return _head(params, x, cfg), new_cache


def step_prefill(params, tokens: torch.Tensor, cfg: LlamaConfig):
    """Prefill leg of the serving plane: ``tokens`` [B, T] →
    ``(last_logits [B, V], kv)``, ``kv`` the per-layer ``(k, v)`` pair,
    each [B, T, Hkv, hd] — exactly the prompt's keys/values, which the
    caller pages out into pool blocks."""
    B, T = tokens.shape
    cache = init_cache(cfg, B, T, device=tokens.device)
    logits, kv = forward_with_cache(params, tokens, cfg, cache, 0)
    return logits[:, -1], kv


def step_decode(params, tokens: torch.Tensor, cfg: LlamaConfig, cache,
                lengths: torch.Tensor):
    """One continuous-batching decode step over a ragged batch.

    ``tokens`` [B] — the last sampled token of each sequence; ``cache``
    per-layer ``(k, v)``, each [B, S, Hkv, hd], a dense gather of each
    sequence's paged blocks (rows at or past ``lengths[b]`` are stale and
    masked here); ``lengths`` [B] — filled prefix per sequence, so the
    fed token sits at position ``lengths[b]``. Returns ``(logits [B, V],
    new_kv)`` with ``new_kv`` per-layer ``(k, v)`` each [B, 1, Hkv, hd].
    Pad rows ride along with ``lengths[b] == 0``."""
    B = tokens.shape[0]
    hd = cfg.head_dim
    H, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    positions = lengths[:, None]                        # [B, 1]
    x = params["embed"][tokens[:, None]]                # [B, 1, D]
    new_kv = []
    for layer, (ck, cv) in zip(params["layers"], cache):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q = _rope(_mm(h, layer["q_proj"]).reshape(B, 1, H, hd), positions,
                  cfg.rope_theta)
        k = _rope(_mm(h, layer["k_proj"]).reshape(B, 1, Hkv, hd), positions,
                  cfg.rope_theta)
        v = _mm(h, layer["v_proj"]).reshape(B, 1, Hkv, hd)
        new_kv.append((k, v))
        S = ck.shape[1]
        kk = torch.cat([ck, k], dim=1).repeat_interleave(H // Hkv, dim=2)
        vv = torch.cat([cv, v], dim=1).repeat_interleave(H // Hkv, dim=2)
        scores = _einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
        kpos = torch.arange(S + 1, device=x.device)
        valid = (kpos[None, :] < lengths[:, None]) | (kpos[None, :] == S)
        scores = mask_scores(scores, valid[:, None, None, :])
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = _einsum("bhqk,bkhd->bqhd", probs, vv)
        x = x + _mm(out.reshape(B, 1, H * hd), layer["o_proj"])
        x = x + _mlp(layer, rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps))
    return _head(params, x, cfg)[:, 0], new_kv


@torch.inference_mode()
def generate(params, cfg: LlamaConfig, prompt,
             max_new_tokens: int) -> torch.Tensor:
    """Greedy autoregressive decode: prefill the prompt once, then one
    cached step per token. Returns [B, max_new_tokens] token ids."""
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    if prompt.ndim == 1:
        prompt = prompt[None]
    B, T0 = prompt.shape
    cache = init_cache(cfg, B, T0 + max_new_tokens, device=dev)
    logits, cache = forward_with_cache(params, prompt, cfg, cache, 0)
    last = logits[:, -1]
    out = []
    for i in range(max_new_tokens):
        tok = torch.argmax(last, dim=-1)
        out.append(tok)
        if i + 1 < max_new_tokens:  # the last token's logits go unused
            logits, cache = forward_with_cache(params, tok[:, None], cfg,
                                               cache, T0 + i)
            last = logits[:, -1]
    return torch.stack(out, dim=1)
