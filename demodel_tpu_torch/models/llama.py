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

``generate`` samples with temperature from the caller's
``torch.Generator`` (the JAX package draws from ``jax.random``, another
RNG, so only greedy tokens compare across packages). ``loss_fn`` and
``make_train_step`` are the training side: the gradient reaches the
projections through K1's backward (``FlashAttention``).

Over a mesh of several ranks (one process each, :mod:`~demodel_tpu_torch.
parallel.mesh`), every rank holds its shards of the params as
:func:`param_shardings` lays them out and runs the same code on them:

- ``tp``: Megatron-style. The q/k/v and gate/up projections are
  column-parallel (their input goes through an identity whose backward
  sums over ``tp``), ``o_proj`` and ``down_proj`` row-parallel (an
  all-reduce after them), the embedding vocab-parallel (a masked lookup,
  then an all-reduce), and ``lm_head`` split over the vocabulary with the
  logits gathered before any softmax, argmax or draw. Attention runs on
  the rank's own heads when ``tp`` divides the head count and on every
  head otherwise (the reference's ``_head_align`` rule): a column split
  that cuts a head is gathered before RoPE, whose rotate-half slice would
  cross the cut. A width ``tp`` does not divide is replicated.
- ``sp``: :func:`forward` and the train step give each rank ``T/sp``
  positions, offset by its ``sp`` coordinate, with ``T`` padded to a
  multiple of ``sp``, and attention goes round the ring
  (:func:`~demodel_tpu_torch.ops.ring_attention.ring_attention`).
- ``dp``: the same split of the batch.

The cached step functions split over ``tp`` only (the reference's cache
path takes no ring either); ``sp`` and ``dp`` ranks repeat the work. The
train step averages the loss over the valid tokens of every ``sp`` and
``dp`` rank and sums each gradient over them. A mesh whose ``tp``,
``sp`` and ``dp`` are all 1 runs exactly the one-device code.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from demodel_tpu_torch.device import resolve
from demodel_tpu_torch.models.common import (
    DTYPES,
    momentum_sgd,
    next_token_nll,
    rms_norm,
    use_flash_attention,
)
from demodel_tpu_torch.ops.flash_attention import flash_attention
from demodel_tpu_torch.ops.ring_attention import (
    dense_attention,
    mask_scores,
    ring_attention,
    ring_rotation,
)
from demodel_tpu_torch.parallel import collectives as col
from demodel_tpu_torch.parallel.mesh import Mesh, local_device


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
        return DTYPES[self.dtype]

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


def param_shardings(cfg: LlamaConfig, mesh: Mesh) -> dict:
    """Partition specs matching :func:`init_params` (the reference's
    ``NamedSharding`` tree, as tuples): column-parallel in-projections
    and row-parallel out-projections over ``tp``, each replicated where
    ``tp`` does not divide its width; norms replicated; the embedding and
    ``lm_head`` split over the vocabulary when ``tp`` divides it. A fresh
    dict per layer."""
    tp = mesh.axis_size("tp")
    col_, row_ = (None, "tp"), ("tp", None)
    rep1, rep2 = (None,), (None, None)
    q_ok = (cfg.num_attention_heads * cfg.head_dim) % tp == 0
    kv_ok = (cfg.num_key_value_heads * cfg.head_dim) % tp == 0
    mlp_ok = cfg.intermediate_size % tp == 0
    vocab_ok = cfg.vocab_size % tp == 0

    def layer() -> dict:
        return {
            "attn_norm": rep1,
            "q_proj": col_ if q_ok else rep2,
            "k_proj": col_ if kv_ok else rep2,
            "v_proj": col_ if kv_ok else rep2,
            "o_proj": row_ if q_ok else rep2,
            "mlp_norm": rep1,
            "gate_proj": col_ if mlp_ok else rep2,
            "up_proj": col_ if mlp_ok else rep2,
            "down_proj": row_ if mlp_ok else rep2,
        }

    return {
        "embed": ("tp", None) if vocab_ok else rep2,
        "layers": [layer() for _ in range(cfg.num_hidden_layers)],
        "final_norm": rep1,
        "lm_head": (None, "tp") if vocab_ok else rep2,
    }


def shard_params(params: dict, cfg: LlamaConfig, mesh: Mesh) -> dict:
    """This rank's shards of whole ``params`` under
    :func:`param_shardings` (on a one-process mesh, ``params`` itself)."""
    specs = param_shardings(cfg, mesh)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        if isinstance(p, list):
            return [walk(a, b) for a, b in zip(p, s)]
        return col.redistribute(p, mesh, (), s)

    return walk(params, specs)


@dataclass(frozen=True)
class _Par:
    """How this rank runs the model on its mesh."""
    mesh: Mesh
    tp: int
    sp: int
    dp: int
    r: int                  # this rank's tp coordinate
    q_col: bool             # q_proj column-parallel (and o_proj row)
    kv_col: bool
    mlp_col: bool
    vocab: bool             # embed and lm_head split over the vocabulary
    heads: bool             # attention on this rank's H/tp q heads
    #: the kv heads this rank's q heads read, where that is not its own
    #: Hkv/tp block (tp divides H but not Hkv); None otherwise
    kv_index: tuple[int, ...] | None


def _kv_index(H: int, G: int, tp: int, r: int) -> tuple[int, ...]:
    """The kv heads of rank ``r``'s q heads ``[r·H/tp, (r+1)·H/tp)``:
    each once when they keep a whole GQA ratio, else one per q head."""
    hl, g = H // tp, H // G
    per_head = tuple((r * hl + j) // g for j in range(hl))
    uniq = tuple(sorted(set(per_head)))
    if hl % len(uniq) == 0 and all(
            per_head[j] == uniq[j // (hl // len(uniq))] for j in range(hl)):
        return uniq
    return per_head


def _par(cfg: LlamaConfig, mesh: Mesh | None) -> _Par | None:
    """None where the one-device code runs (no mesh, or tp, sp and dp
    all 1)."""
    if mesh is None:
        return None
    local_device(mesh, "Llama")
    tp, sp, dp = (mesh.axis_size(a) for a in ("tp", "sp", "dp"))
    if tp == sp == dp == 1:
        return None
    H, G, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    r = mesh.coords.get("tp", 0)
    heads = H % tp == 0
    return _Par(mesh=mesh, tp=tp, sp=sp, dp=dp, r=r,
                q_col=(H * hd) % tp == 0, kv_col=(G * hd) % tp == 0,
                mlp_col=cfg.intermediate_size % tp == 0,
                vocab=cfg.vocab_size % tp == 0, heads=heads,
                kv_index=(_kv_index(H, G, tp, r)
                          if heads and G % tp and tp > 1 else None))


def _tp(par: _Par | None) -> bool:
    return par is not None and par.tp > 1


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


def _embed(params, tokens: torch.Tensor, par: _Par | None) -> torch.Tensor:
    E = params["embed"]
    if not (_tp(par) and par.vocab):
        return E[tokens]
    n = E.shape[0]  # this rank's rows of the vocabulary
    ids = tokens - par.r * n
    keep = (ids >= 0) & (ids < n)
    x = E[ids.clamp(0, n - 1)] * keep[..., None].to(E.dtype)
    return col.reduce_from(x, par.mesh, "tp")


def _qkv(layer, x, cfg: LlamaConfig, par: _Par | None):
    """q [B, T, H', hd] and k, v [B, T, G', hd] as this rank's attention
    reads them (H' = H/tp and G' its kv heads when ``par.heads``, else
    every head)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    if not _tp(par):
        return tuple(_mm(x, layer[n]).reshape(B, T, -1, hd)
                     for n in ("q_proj", "k_proj", "v_proj"))
    mesh = par.mesh
    xin = col.copy_to(x, mesh, "tp")
    q = _mm(xin if par.q_col else x, layer["q_proj"])
    if par.q_col and not par.heads:
        q = col.gather_from(q, mesh, "tp", 2)
    kv = [_mm(xin if par.kv_col else x, layer[n])
          for n in ("k_proj", "v_proj")]
    if par.kv_col and not (par.heads and par.kv_index is None):
        kv = [col.gather_from(t, mesh, "tp", 2) for t in kv]
    kv = [t.reshape(B, T, -1, hd) for t in kv]
    if par.kv_index is not None:
        idx = torch.tensor(par.kv_index, device=x.device)
        kv = [col.select_from(t, mesh, "tp", 2, idx) for t in kv]
    return (q.reshape(B, T, -1, hd), *kv)


def _out(layer, out: torch.Tensor, par: _Par | None) -> torch.Tensor:
    """``o_proj`` of the attention output [B, T, H', hd]."""
    B, T = out.shape[:2]
    out = out.reshape(B, T, -1)
    if not (_tp(par) and par.q_col):
        return _mm(out, layer["o_proj"])
    if not par.heads:  # every head here: this rank's columns
        out = col.scatter_to(out, par.mesh, "tp", 2)
    return col.reduce_from(_mm(out, layer["o_proj"]), par.mesh, "tp")


# ----------------------------------------------------------------- forward


def _attn(layer, x, cfg: LlamaConfig, positions, par: _Par | None = None,
          kv_cache=None, cache_pos: int | None = None, ring=None):
    hd = cfg.head_dim
    q, k, v = _qkv(layer, x, cfg, par)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    H, Hkv, T = q.shape[2], k.shape[2], q.shape[1]

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
    elif ring is not None:
        out = ring(q, k, v)
    elif use_flash_attention(q.device):
        out = flash_attention(q, k, v, causal=True)
    else:
        out = dense_attention(q, k, v, causal=True)
    return _out(layer, out, par), new_cache


def _mlp(layer, y, par: _Par | None = None):
    if not (_tp(par) and par.mlp_col):
        return _mm(F.silu(_mm(y, layer["gate_proj"]))
                   * _mm(y, layer["up_proj"]), layer["down_proj"])
    yin = col.copy_to(y, par.mesh, "tp")
    h = _mm(F.silu(_mm(yin, layer["gate_proj"])) * _mm(yin, layer["up_proj"]),
            layer["down_proj"])
    return col.reduce_from(h, par.mesh, "tp")


def _block(layer, x, cfg, positions, par=None, kv_cache=None,
           cache_pos=None, ring=None):
    h, new_cache = _attn(layer, rms_norm(x, layer["attn_norm"],
                                         cfg.rms_norm_eps),
                         cfg, positions, par, kv_cache, cache_pos, ring)
    x = x + h
    x = x + _mlp(layer, rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps),
                 par)
    return x, new_cache


def _head(params, x, cfg, par: _Par | None = None):
    h = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if not (_tp(par) and par.vocab):
        return _mm(h, params["lm_head"])
    logits = _mm(col.copy_to(h, par.mesh, "tp"), params["lm_head"])
    return col.gather_from(logits, par.mesh, "tp", 2)


def _split(par: _Par, B: int, T: int):
    """This rank's rows of a [B, T] batch padded to multiples of dp and
    sp: ``(batch slice, sequence slice, padded B, padded T)``."""
    Bp, Tp = -(-B // par.dp) * par.dp, -(-T // par.sp) * par.sp
    bl, tl = Bp // par.dp, Tp // par.sp
    c = par.mesh.coords
    b0, t0 = c.get("dp", 0) * bl, c.get("sp", 0) * tl
    return slice(b0, b0 + bl), slice(t0, t0 + tl), Bp, Tp


def _forward_local(params, tokens: torch.Tensor, cfg: LlamaConfig,
                   par: _Par | None) -> torch.Tensor:
    """This rank's logits [B', T', V] (gathered over tp) of its rows
    (:func:`_split`); every row when ``par`` is None."""
    B, T = tokens.shape
    ring = None
    if par is not None:
        bs, ts, Bp, Tp = _split(par, B, T)
        tokens = F.pad(tokens, (0, Tp - T, 0, Bp - B))[bs, ts]
        if par.sp > 1:
            ring = functools.partial(
                ring_attention, rotate=ring_rotation(par.mesh, "sp"),
                my=par.mesh.coords["sp"], n=par.sp, causal=True,
                kv_len=T if Tp != T else None)
        t0 = ts.start
    else:
        t0 = 0
    positions = (t0 + torch.arange(tokens.shape[1], device=tokens.device)
                 ).expand(tokens.shape)
    x = _embed(params, tokens, par)
    for layer in params["layers"]:
        x, _ = _block(layer, x, cfg, positions, par, ring=ring)
    return _head(params, x, cfg, par)


def forward(params, tokens: torch.Tensor, cfg: LlamaConfig,
            mesh: Mesh | None = None) -> torch.Tensor:
    """tokens [B, T] int → logits [B, T, V] (on a mesh: this rank's shards
    of the params, the same whole tokens and logits on every rank)."""
    par = _par(cfg, mesh)
    logits = _forward_local(params, tokens, cfg, par)
    if par is None:
        return logits
    if par.sp > 1:
        logits = col.gather_from(logits, par.mesh, "sp", 1)
    if par.dp > 1:
        logits = col.gather_from(logits, par.mesh, "dp", 0)
    B, T = tokens.shape
    return logits[:B, :T]


# ------------------------------------------------------------ decode path


def cache_heads(cfg: LlamaConfig, mesh: Mesh | None = None) -> int:
    """Hkv': the kv heads this rank's attention reads on ``mesh``, which
    its KV cache holds — ``len(_kv_index)`` where ``tp`` divides H but
    not Hkv, Hkv/tp where it divides both, Hkv otherwise."""
    par = _par(cfg, mesh)
    G = cfg.num_key_value_heads
    if _tp(par) and par.heads:
        G = len(par.kv_index) if par.kv_index is not None else G // par.tp
    return G


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None,
               mesh: Mesh | None = None):
    """Per-layer zero ``(k, v)`` pairs, each [batch, max_len, Hkv', hd]
    (Hkv' the kv heads this rank's attention reads on ``mesh``,
    :func:`cache_heads`), in ``dtype`` (default ``cfg.dtype``) on
    ``device`` (default cuda)."""
    dt = dtype or cfg.torch_dtype
    dev = resolve(device)
    shape = (batch, max_len, cache_heads(cfg, mesh), cfg.head_dim)
    return [(torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))
            for _ in range(cfg.num_hidden_layers)]


def forward_with_cache(params, tokens: torch.Tensor, cfg: LlamaConfig,
                       cache, pos: int, mesh: Mesh | None = None):
    """Incremental forward: ``tokens`` [B, T] appended at ``pos`` (prefill
    with T>1, decode with T=1). Returns (logits, cache); the cache
    tensors are updated in place and returned. On ``mesh`` the cache
    holds this rank's heads (:func:`init_cache`)."""
    par = _par(cfg, mesh)
    B, T = tokens.shape
    positions = pos + torch.arange(T, device=tokens.device).expand(B, T)
    x = _embed(params, tokens, par)
    new_cache = []
    for layer, kv in zip(params["layers"], cache):
        x, nkv = _block(layer, x, cfg, positions, par, kv_cache=kv,
                        cache_pos=pos)
        new_cache.append(nkv)
    return _head(params, x, cfg, par), new_cache


def step_prefill(params, tokens: torch.Tensor, cfg: LlamaConfig,
                 mesh: Mesh | None = None):
    """Prefill leg of the serving plane: ``tokens`` [B, T] →
    ``(last_logits [B, V], kv)``, ``kv`` the per-layer ``(k, v)`` pair,
    each [B, T, Hkv', hd] — exactly the prompt's keys/values (this rank's
    heads on ``mesh``), which the caller pages out into pool blocks."""
    B, T = tokens.shape
    cache = init_cache(cfg, B, T, device=tokens.device, mesh=mesh)
    logits, kv = forward_with_cache(params, tokens, cfg, cache, 0, mesh)
    return logits[:, -1], kv


def step_decode(params, tokens: torch.Tensor, cfg: LlamaConfig, cache,
                lengths: torch.Tensor, mesh: Mesh | None = None):
    """One continuous-batching decode step over a ragged batch.

    ``tokens`` [B] — the last sampled token of each sequence; ``cache``
    per-layer ``(k, v)``, each [B, S, Hkv', hd], a dense gather of each
    sequence's paged blocks (rows at or past ``lengths[b]`` are stale and
    masked here); ``lengths`` [B] — filled prefix per sequence, so the
    fed token sits at position ``lengths[b]``. Returns ``(logits [B, V],
    new_kv)`` with ``new_kv`` per-layer ``(k, v)`` each [B, 1, Hkv', hd].
    Pad rows ride along with ``lengths[b] == 0``."""
    par = _par(cfg, mesh)
    hd = cfg.head_dim
    positions = lengths[:, None]                        # [B, 1]
    x = _embed(params, tokens[:, None], par)            # [B, 1, D]
    new_kv = []
    for layer, (ck, cv) in zip(params["layers"], cache):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, h, cfg, par)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        new_kv.append((k, v))
        S = ck.shape[1]
        rep = q.shape[2] // k.shape[2]
        kk = torch.cat([ck, k], dim=1).repeat_interleave(rep, dim=2)
        vv = torch.cat([cv, v], dim=1).repeat_interleave(rep, dim=2)
        scores = _einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
        kpos = torch.arange(S + 1, device=x.device)
        valid = (kpos[None, :] < lengths[:, None]) | (kpos[None, :] == S)
        scores = mask_scores(scores, valid[:, None, None, :])
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = _einsum("bhqk,bkhd->bqhd", probs, vv)
        x = x + _out(layer, out, par)
        x = x + _mlp(layer, rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps),
                     par)
    return _head(params, x, cfg, par)[:, 0], new_kv


def sample(last: torch.Tensor, temperature: float = 0.0,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Next tokens [B] from logits ``last`` [B, V]: the argmax at
    temperature 0 (whatever ``generator``), else a draw from
    ``softmax(last / temperature)`` (in float32) with ``generator``."""
    if temperature <= 0:
        return torch.argmax(last, dim=-1)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(params, cfg: LlamaConfig, prompt, max_new_tokens: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             mesh: Mesh | None = None) -> torch.Tensor:
    """Autoregressive decode: prefill the prompt once, then one cached
    step per token; each token from :func:`sample` (greedy at
    temperature 0; above it, ``generator`` draws, a generator on the
    params' device seeded with 0 when None). Returns
    [B, max_new_tokens] token ids. On ``mesh`` every rank gets the same
    logits (gathered over ``tp``) and so the same tokens, given equally
    seeded generators."""
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    if prompt.ndim == 1:
        prompt = prompt[None]
    B, T0 = prompt.shape
    if temperature > 0 and generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    cache = init_cache(cfg, B, T0 + max_new_tokens, device=dev, mesh=mesh)
    logits, cache = forward_with_cache(params, prompt, cfg, cache, 0, mesh)
    last = logits[:, -1]
    out = []
    for i in range(max_new_tokens):
        tok = sample(last, temperature, generator)
        out.append(tok)
        if i + 1 < max_new_tokens:  # the last token's logits go unused
            logits, cache = forward_with_cache(params, tok[:, None], cfg,
                                               cache, T0 + i, mesh)
            last = logits[:, -1]
    return torch.stack(out, dim=1)


# -------------------------------------------------------------- train step


def loss_fn(params, tokens: torch.Tensor, cfg: LlamaConfig,
            mesh: Mesh | None = None) -> torch.Tensor:
    """Next-token cross entropy (fp32 logits for the softmax). Split over
    ``sp`` or ``dp``, each rank sums the loss of its valid tokens over
    the global count and the value is summed over those axes: every rank
    returns the whole mean, and its gradient is that rank's share (the
    train step sums the shares)."""
    par = _par(cfg, mesh)
    if par is None or par.sp == par.dp == 1:
        return next_token_nll(forward(params, tokens[:, :-1], cfg, mesh),
                              tokens)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    B, T = inp.shape
    bs, ts, Bp, Tp = _split(par, B, T)
    logits = _forward_local(params, inp, cfg, par)
    tgt = F.pad(tgt, (0, Tp - T, 0, Bp - B))[bs, ts]
    dev = tokens.device
    valid = ((bs.start + torch.arange(tgt.shape[0], device=dev) < B)[:, None]
             & (ts.start + torch.arange(tgt.shape[1], device=dev) < T))
    ll = F.log_softmax(logits.float(), dim=-1).gather(
        -1, tgt[..., None].long())[..., 0]
    loss = -(ll * valid).sum() / (B * T)
    for axis in ("sp", "dp"):
        if par.mesh.axis_size(axis) > 1:
            loss = col.reduce_from(loss, par.mesh, axis)
    return loss


def make_train_step(cfg: LlamaConfig, mesh: Mesh | None = None,
                    lr: float = 1e-3, momentum: float = 0.9):
    """``(init_opt, train_step)`` with a momentum-SGD state that mirrors
    the params tree leaf for leaf (:func:`~demodel_tpu_torch.models.
    common.momentum_sgd`). On ``mesh`` the trees are this rank's shards
    (:func:`param_shardings`) and each gradient is summed over ``sp`` and
    ``dp``, the axes every leaf is replicated over and the batch is
    split over."""
    par = _par(cfg, mesh)
    reduce = None
    if par is not None and (par.sp > 1 or par.dp > 1):
        axes = [a for a in ("sp", "dp") if par.mesh.axis_size(a) > 1]

        def reduce(grads):
            for a in axes:
                grads = [col.all_reduce(g, par.mesh, a) for g in grads]
            return grads
    return momentum_sgd(lambda p, t: loss_fn(p, t, cfg, mesh), lr, momentum,
                        reduce_grads=reduce)
