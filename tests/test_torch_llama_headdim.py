"""Port parity at a head dim no tensor-core tile has: a Llama with head
dim 100 (OpenLLaMA-3B's: hidden 3200 over 32 heads), cut to one head of
100, 2 layers and a 256-token vocabulary, in fp32 on the CPU, against
``demodel_tpu.models.llama``.

The weights are made once in numpy from a seed and carried across by
the port's converter; token inputs come from a seeded numpy generator.
Logits agree within 2e-4 (the reference's cached-logits tolerance) and
greedy tokens are identical, on the einsum path and, under
``DEMODEL_FLASH_ATTN=1``, through both packages' fused attention (the
Pallas kernel interpreted, the port's kernel's plain version). On the
card the same shapes plan onto the f16 tensor-core kernel at padded
head dim 128, which ``chip_smoke.py``'s openllama phase drives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu.models import llama as jl
from demodel_tpu_torch.models import convert
from demodel_tpu_torch.models import llama as tl
from demodel_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

LOGITS_TOL = 2e-4
HF = {"vocab_size": 256, "hidden_size": 100, "intermediate_size": 128,
      "num_hidden_layers": 2, "num_attention_heads": 1,
      "num_key_value_heads": 1}

_jforward = jax.jit(jl.forward, static_argnums=(2,))


def _numpy_params(cfg, seed=13) -> dict:
    """The params tree of both packages, in numpy: projections
    N(0, 1/fan_in), embeddings N(0, 0.02²), norms near 1."""
    rng = np.random.default_rng(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def dense(n_in, n_out):
        return (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)
                ).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    layers = [{"attn_norm": norm(), "q_proj": dense(D, H * hd),
               "k_proj": dense(D, Hkv * hd), "v_proj": dense(D, Hkv * hd),
               "o_proj": dense(H * hd, D), "mlp_norm": norm(),
               "gate_proj": dense(D, I), "up_proj": dense(D, I),
               "down_proj": dense(I, D)}
              for _ in range(cfg.num_hidden_layers)]
    return {"embed": (0.02 * rng.standard_normal((V, D))).astype(np.float32),
            "layers": layers, "final_norm": norm(), "lm_head": dense(D, V)}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jl.LlamaConfig.from_hf(HF), tl.LlamaConfig.from_hf(HF)
    tree = _numpy_params(tcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.params_from_numpy(tree, tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


@pytest.fixture(params=["einsum", "flash"])
def attn_path(request, monkeypatch):
    if request.param == "flash":
        monkeypatch.setenv("DEMODEL_FLASH_ATTN", "1")
    else:
        monkeypatch.delenv("DEMODEL_FLASH_ATTN", raising=False)
    return request.param


def _tokens(B, T, seed):
    return np.random.default_rng(seed).integers(0, HF["vocab_size"], (B, T))


def test_config_has_head_dim_100(models):
    _, jcfg, _, tcfg = models
    assert tcfg.head_dim == jcfg.head_dim == 100


@pytest.mark.parametrize("B,T", [(1, 17), (2, 9)])
def test_forward_matches_jax(models, attn_path, B, T):
    jparams, jcfg, tparams, tcfg = models
    tok = _tokens(B, T, seed=T)
    want = _jforward(jparams, jnp.asarray(tok), jcfg)
    got = tl.forward(tparams, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_cached_logits_match_jax(models, attn_path):
    """Prefill at pos 0, then two single-token steps through the cache:
    logits at every step, and the cache the steps left."""
    jparams, jcfg, tparams, tcfg = models
    B, T, steps = 1, 11, 2
    tok = _tokens(B, T + steps, seed=3)
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
    np.testing.assert_allclose(tcache[-1][1].numpy(),
                               np.asarray(jcache[-1][1]),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_generate_tokens_identical(models, attn_path):
    jparams, jcfg, tparams, tcfg = models
    prompt = _tokens(1, 10, seed=5)[0].tolist()
    want = np.asarray(jl.generate(jparams, jcfg, prompt, 6))[0]
    got = tl.generate(tparams, tcfg, prompt, 6)
    assert got[0].tolist() == [int(t) for t in want]


@pytest.mark.parametrize("heads,copy", [(1, True), (32, False)],
                         ids=["this_model", "openllama_3b"])
def test_prefill_plans_on_the_tensor_cores(models, heads, copy):
    """A head-dim-100 prefill in f16, as it would reach the card: the f16
    tensor-core kernel at padded head dim 128. At OpenLLaMA-3B's 32
    heads q/k/v are read in place through the row map (6400-byte rows);
    this model's one head leaves 200-byte rows, which no map takes, so
    the plan pads a copy to head dim 104 for the 4-D map."""
    T = 9
    q = torch.zeros(1, T, heads, models[3].head_dim, dtype=torch.float16)
    plan = tfa.launch_plan(q, q, q, kv_len=T)
    assert (plan.kernel, plan.smem_bytes) == ("wgmma_f16", 82944)
    assert plan.copy == (copy,) * 3
    assert plan.maps == (("4d",) if copy else ("rows",)) * 3
    if copy:
        padded = tfa._pad8(q)
        assert padded.stride() == (T * heads * 104, heads * 104, 104, 1)
        assert tfa.tma_map(padded) == "4d"
