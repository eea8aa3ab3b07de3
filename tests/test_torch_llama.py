"""Port parity: ``demodel_tpu_torch.models`` (Llama step functions,
weight converter, HF loader) against ``demodel_tpu.models`` on the CPU.

The tiny config in fp32 with the JAX package's own weights, carried
across by ``params_from_numpy``; token inputs from a seeded numpy
generator. Logits agree within 2e-4 (the reference's cached-logits
tolerance) and greedy tokens are identical. ``DEMODEL_FLASH_ATTN=1``
cases route both packages through their fused attention (the Pallas
kernel interpreted, the port's kernel plain version).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu.models import common as jcommon
from demodel_tpu.models import hf_loader as jhf
from demodel_tpu.models import llama as jl
from demodel_tpu_torch.models import common as tcommon
from demodel_tpu_torch.models import convert
from demodel_tpu_torch.models import hf_loader as thf
from demodel_tpu_torch.models import llama as tl

torch.set_num_threads(1)

LOGITS_TOL = 2e-4
BF16_TOL = 2e-2

#: jitted JAX references (eager dispatch compiles every op per shape)
_jinit = jax.jit(jl.init_params, static_argnums=(1,))
_jprefill = jax.jit(jl.step_prefill, static_argnums=(2,))
_jdecode = jax.jit(jl.step_decode, static_argnums=(2,))
_jforward = jax.jit(jl.forward, static_argnums=(2,))


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny()
    tcfg = tl.LlamaConfig.tiny()
    jparams = _jinit(jax.random.key(2), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


def _tokens(B, T, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


@pytest.fixture(params=["einsum", "flash"])
def attn_path(request, monkeypatch):
    if request.param == "flash":
        monkeypatch.setenv("DEMODEL_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("DEMODEL_FLASH_ATTN", raising=False)
    return request.param


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    dt = getattr(torch, dtype)
    got = tcommon.rms_norm(torch.from_numpy(x).to(dt),
                           torch.from_numpy(w).to(dt))
    tol = LOGITS_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hd,start", [(8, 0), (16, 7), (32, 1000)])
def test_rope_matches_jax(hd, start):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, hd)).astype(np.float32)
    pos = start + np.broadcast_to(np.arange(6), (2, 6)) \
        + np.array([[0], [3]])
    want = jl._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_config_from_hf_matches_jax():
    hf = {"vocab_size": 1000, "hidden_size": 256, "intermediate_size": 512,
          "num_hidden_layers": 3, "num_attention_heads": 8,
          "num_key_value_heads": 2, "rope_theta": 500000.0,
          "rms_norm_eps": 1e-5}
    assert dataclasses.asdict(tl.LlamaConfig.from_hf(hf)) == \
        dataclasses.asdict(jl.LlamaConfig.from_hf(hf))
    assert dataclasses.asdict(tl.LlamaConfig()) == \
        dataclasses.asdict(jl.LlamaConfig())


def test_init_params_tree_matches_jax():
    """Same tree, shapes and dtypes as the JAX init (the numbers differ:
    a torch.Generator is not a jax key)."""
    cfg = tl.LlamaConfig.tiny()
    got = tl.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    want = _jinit(jax.random.key(0), jl.LlamaConfig.tiny())
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    assert torch.equal(got["final_norm"], torch.ones(cfg.hidden_size))


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("B,T", [(2, 11), (1, 33)])
def test_forward_matches_jax(models, attn_path, B, T):
    jparams, jcfg, tparams, tcfg = models
    tok = _tokens(B, T, seed=T)
    want = _jforward(jparams, jnp.asarray(tok), jcfg)
    got = tl.forward(tparams, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_forward_with_cache_matches_jax(models, attn_path):
    """Prefill at pos 0 then two single-token decode steps through the
    cache — logits at every step."""
    jparams, jcfg, tparams, tcfg = models
    B, T, steps = 2, 9, 2
    tok = _tokens(B, T + steps, seed=5)
    jcache = jl.init_cache(jcfg, B, T + steps)
    tcache = tl.init_cache(tcfg, B, T + steps, device="cpu")
    jstep = jax.jit(lambda p, t, c, pos: jl.forward_with_cache(
        p, t, jcfg, c, pos))
    pos = 0
    for width in (T,) + (1,) * steps:
        chunk = tok[:, pos:pos + width]
        want, jcache = jstep(jparams, jnp.asarray(chunk), jcache, pos)
        got, tcache = tl.forward_with_cache(
            tparams, torch.from_numpy(chunk), tcfg, tcache, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        pos += width
    np.testing.assert_allclose(tcache[1][0].numpy(),
                               np.asarray(jcache[1][0]),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_step_prefill_matches_jax(models):
    jparams, jcfg, tparams, tcfg = models
    tok = _tokens(1, 13, seed=6)
    want, wkv = _jprefill(jparams, jnp.asarray(tok), jcfg)
    got, gkv = tl.step_prefill(tparams, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    assert len(gkv) == tcfg.num_hidden_layers
    for (gk, gv), (wk, wv) in zip(gkv, wkv):
        assert tuple(gk.shape) == wk.shape == (1, 13, 2, 8)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)


def _decode_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.num_key_value_heads, cfg.head_dim)
    cache = [(rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal(shape).astype(np.float32))
             for _ in range(cfg.num_hidden_layers)]
    return rng.integers(0, cfg.vocab_size, (B,)), cache


@pytest.mark.parametrize("lengths", [[5, 0, 9, 16], [1, 1, 3, 2]],
                         ids=["ragged_with_pad_row", "short"])
def test_step_decode_matches_jax(models, lengths):
    """Ragged batched decode over a gathered cache: stale rows past each
    length and the length-0 pad row are masked the same way."""
    jparams, jcfg, tparams, tcfg = models
    toks, cache = _decode_inputs(tcfg, 4, 16, seed=7)
    lens = np.asarray(lengths)
    want, wkv = _jdecode(
        jparams, jnp.asarray(toks, jnp.int32), jcfg,
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in cache],
        jnp.asarray(lens, jnp.int32))
    got, gkv = tl.step_decode(
        tparams, torch.from_numpy(toks), tcfg,
        [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in cache],
        torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    np.testing.assert_allclose(gkv[-1][0].numpy(), np.asarray(wkv[-1][0]),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_step_decode_bf16_model_over_fp32_pool_promotes_like_jax():
    """A bf16 model decoding over the fp32 pool: JAX promotes attention
    and from there the residual stream to fp32; so must the port."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype="bfloat16")
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype="bfloat16")
    jparams = _jinit(jax.random.key(3), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    toks, cache = _decode_inputs(tcfg, 2, 8, seed=8)
    lens = np.asarray([8, 3])
    want, _ = _jdecode(
        jparams, jnp.asarray(toks, jnp.int32), jcfg,
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in cache],
        jnp.asarray(lens, jnp.int32))
    got, _ = tl.step_decode(
        tparams, torch.from_numpy(toks), tcfg,
        [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in cache],
        torch.from_numpy(lens))
    assert np.asarray(want).dtype == np.float32
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("n_prompt,n_new", [(3, 6), (9, 5), (16, 8)])
def test_generate_tokens_identical(models, n_prompt, n_new):
    jparams, jcfg, tparams, tcfg = models
    prompt = _tokens(1, n_prompt, seed=n_prompt)[0].tolist()
    want = np.asarray(jl.generate(jparams, jcfg, prompt, n_new))[0]
    got = tl.generate(tparams, tcfg, prompt, n_new)
    assert got.shape == (1, n_new)
    assert got[0].tolist() == [int(t) for t in want]


def test_generate_tokens_identical_flash(models, monkeypatch):
    monkeypatch.setenv("DEMODEL_FLASH_ATTN", "1")
    jparams, jcfg, tparams, tcfg = models
    prompt = _tokens(1, 7, seed=11)[0].tolist()
    want = np.asarray(jl.generate(jparams, jcfg, prompt, 4))[0]
    assert tl.generate(tparams, tcfg, prompt, 4)[0].tolist() == \
        [int(t) for t in want]


# ------------------------------------------------------------ weights in


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_is_bit_exact(dtype):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=dtype)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=dtype)
    jparams = _jinit(jax.random.key(4), jcfg)
    got = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    flat_w, tree_w = jax.tree.flatten(jparams)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def _hf_state_dict(cfg, tied: bool, seed=9):
    rng = np.random.default_rng(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": w(D)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": w(D),
            p + "self_attn.q_proj.weight": w(H * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": w(D, H * hd),
            p + "post_attention_layernorm.weight": w(D),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": w(D, I),
        })
    if not tied:
        sd["lm_head.weight"] = w(V, D)
    return sd


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_load_llama_params_matches_hf_loader(tied):
    """HF [out, in] state dict → the same params as the JAX loader
    (transposes, 'model.' prefix, tied head), then the same logits."""
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    sd = _hf_state_dict(tcfg, tied)
    want = jhf.load_llama_params(sd, jcfg)
    got = thf.load_llama_params(sd, tcfg, device="cpu")
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tok = _tokens(1, 6, seed=12)
    np.testing.assert_allclose(
        tl.forward(got, torch.from_numpy(tok), tcfg).numpy(),
        np.asarray(_jforward(want, jnp.asarray(tok), jcfg)),
        rtol=LOGITS_TOL, atol=LOGITS_TOL)
