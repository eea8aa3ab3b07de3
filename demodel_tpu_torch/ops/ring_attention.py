"""Dense attention — the single-device reference of
``demodel_tpu/ops/ring_attention.py``, which ``llama.forward`` uses when
the fused kernel is off. (The ring itself waits for the multi-GPU
slice.)"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-but-finite: -inf rows would NaN through exp/where


def mask_scores(scores: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``scores`` with :data:`NEG_INF` where ``keep`` is false, as
    ``jnp.where`` writes it in scores' dtype: in float16, whose range ends
    at 65504, that is -inf."""
    fill = torch.tensor(NEG_INF, dtype=scores.dtype).item()
    return scores.masked_fill(~keep, fill)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q: [B,T,H,D], k/v: [B,T,Hkv,D] → [B,T,H,D] in q's dtype."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    if scale is None:
        scale = D ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        scores = mask_scores(scores, mask[None, None])
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
