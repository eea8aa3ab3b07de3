"""Llama over ``tp``, ``sp`` and ``dp`` in the port against the JAX
package's ``models/llama.py`` on the same axis sizes.

Four gloo ranks (``tests/torch_mesh_rig.py``) each hold their shards of
the reference's ``init_params`` (numpy, through ``shard_params``) and run
``forward``, ``generate`` or one ``make_train_step`` step on the mesh;
the reference runs here on the first four virtual CPU devices with its
params placed by its ``param_shardings``. Tolerances are the reference
tests' own (``tests/test_ring_attention.py:112-154``,
``tests/test_models.py:73-95``): forward on sp=4 3e-4, the sp train
step's loss 1e-4, the tp step's loss and ``q_proj`` 1e-5, greedy tokens
exact; the train step's gradients (its new momentum) within 1e-4 of each
leaf's largest value. Configs whose head counts or widths ``tp`` does not
divide take the replicated fallback and the ``_head_align`` rule. Also
held here:
``param_shardings`` against the reference's specs, and a mesh of one
giving exactly the one-device tensors.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu_torch.models import convert
from demodel_tpu_torch.models import llama as tl
from demodel_tpu_torch.parallel import mesh as tmesh

from .torch_mesh_rig import Ranks, flat_params

jl = importlib.import_module("demodel_tpu.models.llama")
jmesh = importlib.import_module("demodel_tpu.parallel.mesh")

torch.set_num_threads(1)
WORLD = 4

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=2)
#: tp=4 divides no head count (2 q heads, 1 kv head): every head on every
#: rank, the column-split q/k/v gathered before RoPE
FEW_HEADS = dict(TINY, num_attention_heads=2, num_key_value_heads=1)
#: tp=4 divides the q heads but not the kv heads (each rank reads the
#: kv head of its q heads), nor the vocabulary (embed and head replicated)
FEW_KV = dict(TINY, num_attention_heads=4, num_key_value_heads=2,
              vocab_size=250, intermediate_size=120)
CFGS = {"tiny": TINY, "few_heads": FEW_HEADS, "few_kv": FEW_KV}
#: a train step's gradient against the one-device step's, relative to
#: each leaf's largest value (the sums over ranks change only the order
#: of f32 additions)
GRAD_REL = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(WORLD, tmp_path_factory.mktemp("ranks"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (name, kw) in enumerate(CFGS.items()):
        jcfg = jl.LlamaConfig(**kw)
        jparams = jl.init_params(jax.random.key(i), jcfg)
        host = jax.tree.map(np.asarray, jparams)
        out[name] = (jcfg, jparams, host, flat_params(host))
    return out


def _toks(vocab: int, b: int, t: int) -> np.ndarray:
    return (np.arange(b * t).reshape(b, t) % vocab).astype(np.int32)


def _placed(jparams, jcfg, mesh):
    return jax.tree.map(jax.device_put, jparams,
                        jl.param_shardings(jcfg, mesh))


def _wide(sizes: dict) -> tmesh.Mesh:
    """A one-process mesh of ``sizes`` (spec arithmetic only)."""
    n = int(np.prod(list(sizes.values())))
    cpus = np.empty(n, dtype=object)
    cpus[:] = [torch.device("cpu")] * n
    return tmesh.Mesh(cpus.reshape(tuple(sizes.values())), tuple(sizes))


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(CFGS))
def test_param_shardings_match_the_reference(name, tp):
    cfg = jl.LlamaConfig(**CFGS[name])
    ref = jl.param_shardings(cfg, jmesh.make_mesh(8, tp=tp))
    got = tl.param_shardings(tl.LlamaConfig(**CFGS[name]),
                             _wide(tmesh.axis_sizes(8, tp=tp)))
    flat_ref = jax.tree.leaves(ref, is_leaf=lambda x: hasattr(x, "spec"))
    flat_got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(s.spec) for s in flat_ref] == flat_got
    assert got["layers"][0] is not got["layers"][1]


def test_forward_on_sp4_matches_the_reference(ranks, models):
    jcfg, jparams, _, inputs = models["tiny"]
    toks = _toks(jcfg.vocab_size, 2, 24)
    mesh = jmesh.make_mesh(WORLD, sp=4, tp=1)
    want = np.asarray(jax.jit(lambda p, t: jl.forward(p, t, jcfg, mesh))(
        jparams, jnp.asarray(toks)))
    out = ranks.run("llama_forward", {"axes": {"sp": 4, "tp": 1},
                                      "cfg": CFGS["tiny"]},
                    dict(inputs, tokens=toks))
    for got, _ in out:
        np.testing.assert_allclose(got["logits"], want, atol=3e-4)


@pytest.mark.parametrize("axes", [{"tp": 4}, {"tp": 2}, {"dp": 2, "tp": 2},
                                  {"sp": 2}], ids=str)
@pytest.mark.parametrize("name", list(CFGS))
def test_forward_on_a_mesh_matches_the_reference(ranks, models, name, axes):
    jcfg, jparams, _, inputs = models[name]
    toks = _toks(jcfg.vocab_size, 2, 13)
    want = np.asarray(jax.jit(lambda p, t: jl.forward(p, t, jcfg))(
        jparams, jnp.asarray(toks)))
    out = ranks.run("llama_forward", {"axes": axes, "cfg": CFGS[name]},
                    dict(inputs, tokens=toks))
    for got, _ in out:
        np.testing.assert_allclose(got["logits"], want, atol=3e-4)


def test_train_step_on_sp2_matches_the_reference(ranks, models):
    """make_mesh(4, sp=2) is {dp: 1, sp: 2, tp: 2} in both packages."""
    jcfg, jparams, _, inputs = models["tiny"]
    toks = _toks(jcfg.vocab_size, 2, 25)
    mesh = jmesh.make_mesh(WORLD, sp=2)
    ps = _placed(jparams, jcfg, mesh)
    init_s, step_s = jl.make_train_step(jcfg, mesh)
    _, _, loss_sp = step_s(ps, init_s(ps), jnp.asarray(toks))
    out = ranks.run("llama_train", {"axes": {"sp": 2}, "cfg": CFGS["tiny"]},
                    dict(inputs, tokens=toks))
    for got, _ in out:
        assert abs(float(got["loss"]) - float(loss_sp)) < 1e-4


@pytest.mark.parametrize("axes", [{"tp": 4}, {"tp": 2}, {"dp": 2, "sp": 2},
                                  {"dp": 4, "tp": 1}], ids=str)
@pytest.mark.parametrize("name", list(CFGS))
def test_train_step_on_a_mesh_matches_one_device(ranks, models, name, axes):
    """The reference's sharded step against its one-device step: loss and
    ``q_proj`` within 1e-5; here every new leaf is held, and so is every
    new momentum leaf, which after one step from zero is the whole
    gradient: within :data:`GRAD_REL` of that leaf's largest value. One
    step at lr 1e-3 moves the params by ~1e-6, so only the momentum holds
    the backward passes of the tp operators."""
    jcfg, jparams, _, inputs = models[name]
    toks = _toks(jcfg.vocab_size, 2, 17)
    init_d, step_d = jl.make_train_step(jcfg, None)
    p0, m0, l0 = step_d(jparams, init_d(jparams), jnp.asarray(toks))
    want = flat_params(jax.tree.map(np.asarray, p0), prefix="")
    grads = flat_params(jax.tree.map(np.asarray, m0), prefix="m.")
    out = ranks.run("llama_train", {"axes": axes, "cfg": CFGS[name]},
                    dict(inputs, tokens=toks))
    for got, _ in out:
        assert abs(float(got["loss"]) - float(l0)) < 1e-5
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=1e-5,
                                       err_msg=path)
        for path, g in grads.items():
            err = np.abs(got[path] - g).max()
            assert err <= GRAD_REL * np.abs(g).max(), (path, err,
                                                       np.abs(g).max())


@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 4}], ids=str)
@pytest.mark.parametrize("name", list(CFGS))
def test_generate_on_tp_is_exact(ranks, models, name, axes):
    jcfg, jparams, _, inputs = models[name]
    prompt = _toks(jcfg.vocab_size, 2, 8)
    want = np.asarray(jl.generate(jparams, jcfg, jnp.asarray(prompt), 4))
    out = ranks.run("llama_generate", {"axes": axes, "cfg": CFGS[name],
                                       "new": 4}, dict(inputs, prompt=prompt))
    for got, _ in out:
        assert np.array_equal(got["tokens"], want)


def test_generate_on_sp2_with_an_odd_prompt_is_exact(ranks, models):
    jcfg, jparams, _, inputs = models["tiny"]
    prompt = _toks(jcfg.vocab_size, 2, 9)
    mesh = jmesh.make_mesh(WORLD, sp=2)
    ps = _placed(jparams, jcfg, mesh)
    want = np.asarray(jl.generate(ps, jcfg, jnp.asarray(prompt), 4,
                                  mesh=mesh))
    assert np.array_equal(want, np.asarray(
        jl.generate(jparams, jcfg, jnp.asarray(prompt), 4)))
    out = ranks.run("llama_generate", {"axes": {"sp": 2}, "cfg": CFGS["tiny"],
                                       "new": 4}, dict(inputs, prompt=prompt))
    for got, _ in out:
        assert np.array_equal(got["tokens"], want)


def test_a_mesh_of_one_is_the_one_device_path(models):
    """Bit for bit: forward, the cached prefill, generate and a train
    step on make_mesh(1, sp=1) against no mesh."""
    jcfg, _, host, _ = models["tiny"]
    cfg = tl.LlamaConfig(**CFGS["tiny"])
    params = convert.params_from_numpy(host, cfg, device="cpu")
    mesh = tmesh.make_mesh(1, sp=1, device="cpu")
    toks = torch.from_numpy(_toks(cfg.vocab_size, 2, 11)).long()
    assert torch.equal(tl.forward(params, toks, cfg, mesh),
                       tl.forward(params, toks, cfg))
    a, b = (tl.step_prefill(params, toks, cfg, m) for m in (mesh, None))
    assert torch.equal(a[0], b[0])
    assert torch.equal(tl.generate(params, cfg, toks[:, :6], 3, mesh=mesh),
                       tl.generate(params, cfg, toks[:, :6], 3))
    steps = [tl.make_train_step(cfg, m) for m in (mesh, None)]
    res = [step(params, init(params), toks) for init, step in steps]
    assert torch.equal(res[0][2], res[1][2])
    assert torch.equal(res[0][0]["layers"][1]["q_proj"],
                       res[1][0]["layers"][1]["q_proj"])


def test_a_one_process_mesh_of_several_devices_raises(models):
    _, _, host, _ = models["tiny"]
    cfg = tl.LlamaConfig(**CFGS["tiny"])
    params = convert.params_from_numpy(host, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="one process per rank"):
        tl.forward(params, torch.zeros(1, 4, dtype=torch.long), cfg,
                   _wide({"dp": 1, "tp": 2}))


def test_kv_heads_of_a_rank():
    """Rank r's q heads read the kv heads the reference's GQA gives them:
    once each when they keep a whole ratio, else one per q head."""
    assert tl._kv_index(8, 2, 4, 1) == (0,)
    assert tl._kv_index(8, 2, 4, 3) == (1,)
    assert tl._kv_index(8, 4, 8, 5) == (2,)
    assert tl._kv_index(12, 3, 2, 0) == (0, 0, 0, 0, 1, 1)
    for H, G, tp in ((8, 2, 4), (12, 3, 2), (16, 4, 8), (8, 1, 2)):
        for r in range(tp):
            idx = tl._kv_index(H, G, tp, r)
            hl = H // tp
            per = hl // len(idx)
            assert [idx[j // per] for j in range(hl)] == [
                (r * hl + j) // (H // G) for j in range(hl)]
    cfg = tl.LlamaConfig(**FEW_KV)
    assert tl.init_cache(cfg, 1, 4, device="cpu")[0][0].shape == (1, 4, 2, 16)
