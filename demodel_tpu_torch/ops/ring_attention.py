"""Ring attention: exact context-parallel attention over an ``sp`` mesh
axis (the port of ``demodel_tpu/ops/ring_attention.py``), and the dense
single-device attention ``llama.forward`` uses when the fused kernel is
off.

The sequence is split over the ring: rank ``my`` of ``n`` holds query,
key and value rows ``[my·T/n, (my+1)·T/n)``. Each step attends the local
queries to the key/value block in hand and passes that block on to rank
``my+1`` while taking rank ``my-1``'s, so after ``n`` steps every query
has seen every key, exactly as dense attention would, with activation
memory O(T/n) a rank and ``n-1`` hops instead of an all-gather.

Two bodies, as in the JAX package: the einsum ring keeps a running
(max, numerator, denominator) in fp32; the flash ring runs K1
(:func:`~demodel_tpu_torch.ops.flash_attention.flash_attention`) once a
step, its diagonal shifted to the global positions (``causal_offset =
my·Tq − src·Tk``) and its keys cut to the block's share of the global
``kv_len``, and merges the normalised partials by their log-sum-exp.
The device picks the body: the flash ring on CUDA tensors, the einsum
ring on the CPU; ``use_flash=`` overrides it.

The per-rank body :func:`ring_attention` receives the rotation as a
function, ``rotate(k, v) -> (k, v)`` of the previous rank. Across
processes that is :func:`ring_rotation`: ``batch_isend_irecv`` on the
mesh's ``sp`` sub-group, wrapped in an autograd function so that the
gradients of k and v travel the other way round the ring (what
``lax.ppermute``'s transpose does in JAX; c10d's send and recv are not
differentiable). :func:`local_rotation` hands over the other ranks'
blocks in one process instead, which makes exactly the kernel launches,
with exactly the windows, that each rank of a real ring makes.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from demodel_tpu_torch.utils import trace

NEG_INF = -1e30  # large-but-finite: -inf rows would NaN through exp/where

Rotation = Callable[[torch.Tensor, torch.Tensor],
                    tuple[torch.Tensor, torch.Tensor]]


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


# --------------------------------------------------------------- rotation


def _shift(xs, mesh, axis: str, d: int) -> list[torch.Tensor]:
    """Send each of ``xs`` to the rank ``d`` ahead on ``axis`` and take
    the one ``d`` behind: one batch of sends and receives."""
    group = mesh.group(axis)
    n, my = mesh.axis_size(axis), mesh.coords[axis]
    to = dist.get_global_rank(group, (my + d) % n)
    frm = dist.get_global_rank(group, (my - d) % n)
    outs, ops = [], []
    for x in xs:
        x = x.contiguous()
        out = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, to, group))
        ops.append(dist.P2POp(dist.irecv, out, frm, group))
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class RingShift(torch.autograd.Function):
    """Tensors to the next rank of ``axis``, the previous rank's back;
    the backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(_shift(xs, mesh, axis, +1))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_shift(gs, ctx.mesh, ctx.axis, -1))


def ring_rotation(mesh, axis: str = "sp") -> Rotation:
    """The rotation of a ring over the processes of ``mesh``'s ``axis``."""
    def rotate(k, v):
        return RingShift.apply(mesh, axis, k, v)
    return rotate


def local_rotation(ks: list[torch.Tensor], vs: list[torch.Tensor],
                   my: int) -> Rotation:
    """Rank ``my``'s rotation over blocks that one process holds for all
    ``n`` ranks: the ``s``-th call hands over rank ``my - s``'s block, as
    the ``s``-th hop of a real ring would. Gradients reach the blocks
    directly."""
    step = 0

    def rotate(k, v):
        nonlocal step
        step += 1
        src = (my - step) % len(ks)
        return ks[src], vs[src]
    return rotate


# ------------------------------------------------------------------ bodies


def _ring_flash(q, k, v, rotate, my, n, causal, scale, kv_len):
    """Per step, K1 returns the normalised partial and its per-row LSE;
    partials merge as ``O ← O·e^{L−L'} + O_i·e^{L_i−L'}`` with ``L' =
    logaddexp(L, L_i)``. A block no query row may see (after the query
    block when causal, or all padding) still launches: K1 returns zeros
    and an LSE of NEG_INF, which the merge weighs 0."""
    from demodel_tpu_torch.ops.flash_attention import flash_attention

    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    O = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    L = torch.full((B, Tq, H), NEG_INF, dtype=torch.float32,
                   device=q.device)
    for step in range(n):
        src = (my - step) % n
        # query i (global my·Tq+i) sees key j (global src·Tk+j) iff
        # j ≤ i + (my·Tq − src·Tk); ring padding is key validity
        kv_local = Tk if kv_len is None else min(max(kv_len - src * Tk, 0),
                                                 Tk)
        out_i, lse_i = flash_attention(
            q, k, v, kv_len=kv_local, causal=causal, scale=scale,
            causal_offset=my * Tq - src * Tk, return_lse=True)
        L_comb = torch.logaddexp(L, lse_i)
        O = (O * torch.exp(L - L_comb)[..., None]
             + out_i.float() * torch.exp(lse_i - L_comb)[..., None])
        L = L_comb
        if step != n - 1:
            k, v = rotate(k, v)
    return O.to(q.dtype)


def _ring_einsum(q, k, v, rotate, my, n, causal, scale, kv_len):
    B, Tq, H, D = q.shape
    Hkv, Tk = k.shape[2], k.shape[1]
    dev = q.device
    q32 = q.float() * scale
    num = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    den = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=dev)
    q_pos = my * Tq + torch.arange(Tq, device=dev)
    for step in range(n):
        src = (my - step) % n
        # GQA repeats the block in hand: the ring carries Hkv heads
        kk = k.repeat_interleave(H // Hkv, dim=2) if H != Hkv else k
        vv = v.repeat_interleave(H // Hkv, dim=2) if H != Hkv else v
        k_pos = src * Tk + torch.arange(Tk, device=dev)
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, kk.float())
        valid = torch.ones((Tq, Tk), dtype=torch.bool, device=dev)
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        if kv_len is not None:
            valid = valid & (k_pos < kv_len)[None, :]
        scores = scores.masked_fill(~valid[None, None], NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        # masked entries are zeroed explicitly, not by underflow: a row
        # with no visible key this step has m_new == NEG_INF, so
        # exp(scores - m_new) would be 1 for every masked entry
        p = torch.where(valid[None, None],
                        torch.exp(scores - m_new[..., None]), 0.0)
        num = num * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vv.float())
        den = den * alpha + p.sum(dim=-1)
        m = m_new
        if step != n - 1:
            k, v = rotate(k, v)
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rotate: Rotation, my: int, n: int, causal: bool = True,
                   scale: float | None = None, kv_len: int | None = None,
                   use_flash: bool | None = None) -> torch.Tensor:
    """Rank ``my`` of an ``n``-rank ring: q [B, T_loc, H, D], k/v
    [B, T_loc, Hkv, D] (this rank's rows; GQA repeats on the fly) →
    [B, T_loc, H, D] in q's dtype. ``kv_len`` (global) masks ring padding
    when the true sequence length is not a multiple of the ring size.
    ``use_flash`` picks the body; None takes the flash ring exactly when
    the tensors are on CUDA."""
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    if scale is None:
        scale = q.shape[-1] ** -0.5
    body = _ring_flash if use_flash else _ring_einsum
    return body(q, k, v, rotate, my, n, causal, scale, kv_len)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, axis: str = "sp",
                           causal: bool = True,
                           use_flash: bool | None = None) -> torch.Tensor:
    """Global-view wrapper on every rank of ``axis``: q, k, v are the
    whole [B, T, ...] tensors (the same on each rank); the sequence is
    padded to a multiple of the ring (the padding masked by a global
    ``kv_len``), this rank's rows go round the ring, and the output is
    gathered back and unpadded. Differentiable: the slice's backward
    gathers the gradients, the gather's takes this rank's rows.
    ``use_flash`` picks the body as in :func:`ring_attention`.

    Under the export tier of :mod:`~demodel_tpu_torch.utils.trace` the
    call runs under a ``compute.ring-attention`` span that synchronises
    the device, so it times the compute; the default observe tier skips
    it and keeps launches asynchronous."""
    from demodel_tpu_torch.parallel import collectives as col
    from demodel_tpu_torch.parallel.mesh import local_device

    local_device(mesh, "ring attention")
    n = mesh.axis_size(axis)
    B, T, H, D = q.shape

    def run() -> torch.Tensor:
        pad = (-T) % n
        qq, kk, vv = q, k, v
        if pad:
            qq, kk, vv = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (q, k, v))
        if n > 1:
            qq, kk, vv = (col.scatter_to(t, mesh, axis, 1)
                          for t in (qq, kk, vv))
            rotate = ring_rotation(mesh, axis)
        else:
            rotate = None
        out = ring_attention(qq, kk, vv, rotate, mesh.coords.get(axis, 0),
                             n, causal=causal, kv_len=T if pad else None,
                             use_flash=use_flash)
        if n > 1:
            out = col.gather_from(out, mesh, axis, 1)
        return out[:, :T] if pad else out

    if not trace.enabled():
        return run()
    with trace.span("compute.ring-attention", batch=B, tokens=T, heads=H,
                    head_dim=D, ring=n, causal=causal):
        out = run()
        if out.device.type == "cuda":
            # observability-only sync, under opted-in export tracing
            torch.cuda.synchronize(out.device)
        return out
