"""Port parity of K1's gradient and of its float32 launch plan.

The JAX package's ``flash_attention`` is a ``custom_vjp`` whose backward
recomputes ``reference_attention_lse`` and takes its VJP; the port's
``FlashAttention`` (a ``torch.autograd.Function``) applies the same rule
on every device. Here q, k and v come from a seeded numpy generator and go
to both packages; the JAX side runs its Pallas kernel in interpret mode
under ``jax.grad`` (jitted), the port its plain version on CPU tensors, and
dq, dk, dv must agree at the reference's own tolerance of 1e-4
(tests/test_flash_attention.py). The float32 launch plan is held against
the constants of ``csrc/flash_attention.cu``, parsed from the source: no
build and no card.
"""

from __future__ import annotations

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("demodel_tpu.ops.flash_attention")

torch.set_num_threads(1)

GRAD_TOL = 1e-4

# name, B, Sq, Sk, H, G, D, causal, kv_len, causal_offset, return_lse
GRAD_CASES = [
    # tests/test_flash_attention.py::test_flash_grad_matches_reference's
    ("causal_mha", 1, 32, 32, 2, 2, 16, True, None, None, False),
    ("gqa", 2, 24, 24, 4, 2, 16, True, None, None, False),
    ("vector_windows_kv_len_zero_row", 3, 6, 20, 4, 2, 16, True,
     [0, 13, 20], [5, 7, -2], False),
    ("non_causal", 2, 9, 30, 4, 4, 16, False, [11, 30], None, False),
    ("return_lse", 2, 12, 16, 4, 2, 16, True, [0, 9], None, True),
]


def _inputs(B, Sq, Sk, H, G, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, G, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, G, D)).astype(np.float32)
    w = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    w_lse = rng.standard_normal((B, Sq, H)).astype(np.float32)
    return q, k, v, w, w_lse


def _window(x, lib):
    if x is None:
        return None
    a = np.asarray(x, np.int32)
    return jnp.asarray(a) if lib == "jax" else torch.from_numpy(a)


def _jax_grads(q, k, v, w, w_lse, causal, kv_len, off, return_lse):
    """dq, dk, dv of sum(out * w) (+ sum(lse * w_lse) over rows with a
    visible key) through the JAX kernel."""
    kv, co = _window(kv_len, "jax"), _window(off, "jax")

    def loss(q_, k_, v_):
        res = jfa.flash_attention(q_, k_, v_, kv_len=kv, causal=causal,
                                  causal_offset=co, block_q=16, block_k=16,
                                  return_lse=return_lse)
        if not return_lse:
            return (res * w).sum()
        out, lse = res
        return (out * w).sum() + jnp.where(lse > jfa.NEG_INF / 2,
                                           lse * w_lse, 0.0).sum()

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_grads_match_jax_grad_through_the_kernel(case):
    """The port's dq, dk and dv through ``flash_attention`` equal
    ``jax.grad`` through the JAX kernel: causal MHA, GQA, per-batch
    windows with a ``kv_len = 0`` row (which gets the reference's
    gradient: its all-masked softmax averages V), non-causal, and a loss
    on the LSE."""
    _, B, Sq, Sk, H, G, D, causal, kv_len, off, return_lse = case
    q, k, v, w, w_lse = _inputs(B, Sq, Sk, H, G, D, seed=Sq + Sk)
    want = _jax_grads(q, k, v, w, w_lse, causal, kv_len, off, return_lse)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    res = tfa.flash_attention(tq, tk, tv, kv_len=_window(kv_len, "torch"),
                              causal=causal,
                              causal_offset=_window(off, "torch"),
                              return_lse=return_lse)
    if return_lse:
        out, lse = res
        loss = (out * torch.from_numpy(w)).sum() + torch.where(
            lse > tfa.NEG_INF / 2, lse * torch.from_numpy(w_lse), 0.0).sum()
    else:
        loss = (res * torch.from_numpy(w)).sum()
    loss.backward()
    for name, got, exp in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert got is not None and got.shape == exp.shape, name
        np.testing.assert_allclose(got.numpy(), exp, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_kv_len_zero_row_takes_the_reference_gradient():
    """A row with no visible key comes out as zeros, but its gradient is
    the reference's (``jax.grad`` gives the same): its softmax over
    all-masked scores spreads the row's cotangent evenly over V."""
    q, k, v, w, _ = _inputs(1, 1, 8, 1, 1, 4, seed=3)
    tv = torch.from_numpy(v).requires_grad_()
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), tv,
                              kv_len=0)
    assert not out.any()
    (out * torch.from_numpy(w)).sum().backward()
    want = np.broadcast_to(w / 8, v.shape)
    np.testing.assert_allclose(tv.grad.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("return_lse", [False, True], ids=["out", "out_lse"])
def test_output_carries_the_function_grad_fn(return_lse):
    """With a gradient wanted the outputs come from ``FlashAttention``;
    with none wanted (inputs that need none, ``no_grad``,
    ``inference_mode``) no graph node is made and nothing is saved."""
    q, k, v, _, _ = _inputs(1, 5, 5, 2, 2, 8, seed=4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    res = tfa.flash_attention(tq.requires_grad_(), tk, tv,
                              return_lse=return_lse)
    outs = res if return_lse else (res,)
    for t in outs:
        assert type(t.grad_fn).__name__ == "FlashAttentionBackward"

    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        for mode in (torch.inference_mode, torch.no_grad):
            with mode():
                res = tfa.flash_attention(tq, tk, tv, return_lse=return_lse)
            outs = res if return_lse else (res,)
            assert all(t.grad_fn is None for t in outs)
        res = tfa.flash_attention(tq.detach(), tk, tv, return_lse=return_lse)
        outs = res if return_lse else (res,)
        assert all(t.grad_fn is None for t in outs)
    assert saved == []


def test_llama_grads_match_jax_through_flash(monkeypatch):
    """Grads of one loss through ``llama.forward`` on
    ``LlamaConfig.tiny()`` (attention through flash in both packages, the
    JAX kernel interpreted) equal the JAX package's, leaf for leaf, at f32
    tolerance: the projections before attention get their gradient
    through K1's backward. The limit is 1e-4 of each leaf's largest
    gradient: the leaves reach 10 to 950 (the embedding's, through the
    norm of 0.02-scaled rows), where the two packages' fp32 sums differ
    by about 1e-6 of that scale, more than 1e-4 of an element that
    cancels large terms."""
    from demodel_tpu.models import llama as jl
    from demodel_tpu_torch.models import convert
    from demodel_tpu_torch.models import llama as tl

    monkeypatch.setenv("DEMODEL_FLASH_ATTN", "1")
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    jparams = jax.jit(jl.init_params, static_argnums=(1,))(
        jax.random.key(5), jcfg)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, tcfg.vocab_size, (1, 9))
    w = rng.standard_normal((1, 9, tcfg.vocab_size)).astype(np.float32)

    def jloss(p):
        return (jl.forward(p, jnp.asarray(tok), jcfg) * w).sum()

    want = jax.jit(jax.grad(jloss))(jparams)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    leaves = [tparams["embed"], tparams["final_norm"], tparams["lm_head"],
              *(t for layer in tparams["layers"] for t in layer.values())]
    for t in leaves:
        t.requires_grad_()
    (tl.forward(tparams, torch.from_numpy(tok), tcfg)
     * torch.from_numpy(w)).sum().backward()
    pairs = [(tparams[n], want[n]) for n in ("embed", "final_norm",
                                              "lm_head")]
    for tlayer, jlayer in zip(tparams["layers"], want["layers"]):
        pairs += [(tlayer[n], jlayer[n]) for n in tlayer]
    for t, g in pairs:
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= GRAD_TOL * np.abs(g).max()
    assert tparams["layers"][0]["q_proj"].grad.abs().sum() > 0


# ------------------------------------------------------------ launch plan

#: head dims other than 64 and 128 (100: OpenLLaMA-3B's, 99 odd), and the
#: padded head dim of the float32 instantiation that takes each: the head
#: dim rounded up to a multiple of 16
F32_HEAD_DIMS = {8: 16, 32: 32, 80: 80, 96: 96, 99: 112, 100: 112,
                 256: 256}


def _c_constants() -> dict[str, int]:
    """The float32 kernel's ``constexpr int kF32*`` of the CUDA source."""
    (src,) = tfa.SOURCES
    return {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (kF32\w+) = (\d+);", src.read_text())}


@pytest.mark.parametrize("D", sorted(F32_HEAD_DIMS))
def test_f32_plan_matches_the_c_constants(D):
    """Every float32 head dim goes to the 3xTF32 kernel: one block of
    ``kF32Threads`` per ``kF32Rows`` query rows of one head, and shared
    memory for the Q tile and the ``kF32Stages``-deep K and V rings of
    ``kF32Keys`` keys, Q and K rows DP + ``kF32PadQK`` floats apart where
    DP is a multiple of 32 (else DP) and V rows DP + ``kF32PadV`` — as the
    C side's ``f32_smem_bytes`` computes it."""
    c = _c_constants()
    q = torch.zeros(1, 512, 32, D)
    k = torch.zeros(1, 512, 8, D)
    plan = tfa.launch_plan(q, k, k, kv_len=512)
    dp = F32_HEAD_DIMS[D]
    assert (plan.kernel, plan.code) == ("tf32x3_f32", 0)
    assert plan.kernel in tfa.launches_by_kernel
    assert tfa.padded_head_dim(plan.kernel, D) == dp
    assert plan.threads == c["kF32Threads"]
    assert plan.grid == (-(-512 // c["kF32Rows"]), 32, 1)
    ring = c["kF32Stages"] * c["kF32Keys"]
    ld_qk = dp + c["kF32PadQK"] if dp % 32 == 0 else dp
    assert plan.smem_bytes == 4 * (ld_qk * (c["kF32Rows"] + ring)
                                   + (dp + c["kF32PadV"]) * ring)
    assert plan.smem_bytes <= 232448        # what a block may use
    assert (plan.copy, plan.maps) == ((False,) * 3, ("strides",) * 3)


@pytest.mark.parametrize("view", ["column_slice", "head_slice",
                                  "misaligned_base", "kv_cache",
                                  "odd_head_dim"])
def test_f32_views_need_no_copy_with_a_unit_last_stride(view):
    """The float32 kernel reads through strides (16-byte copies where
    base and strides allow, 4-byte ones elsewhere), so no view with a unit
    last stride is copied: padded rows, a head slice, a base off 16-byte
    alignment, a KV cache's first rows, D=99. A last stride other than 1
    is copied contiguous once."""
    t = {"column_slice": lambda: torch.zeros(2, 40, 8, 132)[..., :128],
         "head_slice": lambda: torch.zeros(2, 40, 16, 128)[:, :, 8:],
         "misaligned_base": lambda: torch.zeros(2 * 40 * 8 * 128 + 1)[1:]
         .view(2, 40, 8, 128),
         "kv_cache": lambda: torch.zeros(2, 2048, 8, 100)[:, :40],
         "odd_head_dim": lambda: torch.zeros(2, 40, 8, 99)}[view]()
    q = torch.zeros(2, 40, 8, t.shape[3])
    plan = tfa.launch_plan(q, t, t)
    assert plan.kernel == "tf32x3_f32"
    assert plan.copy == (False, False, False)
    transposed = torch.zeros(2, 40, t.shape[3], 8).transpose(2, 3)
    assert tfa.launch_plan(q, t, transposed).copy == (False, False, True)
