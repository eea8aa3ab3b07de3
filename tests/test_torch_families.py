"""Port parity of the GPT-2 and BERT families — ``layer_norm``, GPT-2
``forward``, BERT ``encode``, their HF loaders and ``model_from_pull`` —
against ``demodel_tpu`` on the CPU.

Weights are seeded HF-named state dicts made in numpy
(``tests/hf_families.py``), loaded by each package's own loader; token
inputs come from a seeded numpy generator. Outputs agree within 1e-5 in
fp32 (2e-4 for the built-from-a-pull models, the reference's HF-logits
tolerance), on the einsum path and, under ``DEMODEL_FLASH_ATTN=1``,
through both packages' fused attention (the Pallas kernel interpreted,
the port's kernel's plain version). BERT with a padding mask keeps the
einsum path in both packages. On the card the same functions reach K1
at head dim 64, which ``chip_smoke.py``'s families phase drives at the
published widths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu import delivery as jdelivery
from demodel_tpu.config import ProxyConfig as JConfig
from demodel_tpu.models import auto as jauto
from demodel_tpu.models import bert as jbert
from demodel_tpu.models import common as jcommon
from demodel_tpu.models import gpt2 as jgpt2
from demodel_tpu.models import hf_loader as jloader
from demodel_tpu.store import Store as JStore
from demodel_tpu_torch import delivery as tdelivery
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.models import auto as tauto
from demodel_tpu_torch.models import bert as tbert
from demodel_tpu_torch.models import common as tcommon
from demodel_tpu_torch.models import convert
from demodel_tpu_torch.models import gpt2 as tgpt2
from demodel_tpu_torch.models import hf_loader as tloader
from demodel_tpu_torch.ops import flash_attention as tfa
from demodel_tpu_torch.parallel import Mesh, make_mesh
from demodel_tpu_torch.store import Store as TStore

from .fake_registries import make_hf_handler
from .hf_families import (
    BERT_CONFIG,
    GPT2_CONFIG,
    bert_state,
    gpt2_state,
    repo_files,
)
from .servers import FakeUpstream
from .torch_refnative import reference_native_lib  # noqa: F401

torch.set_num_threads(1)

TOL = 1e-5
PULL_TOL = 2e-4

_jgpt2 = jax.jit(jgpt2.forward, static_argnums=(2,))
_jbert = jax.jit(jbert.encode, static_argnums=(2,))


def _tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


@pytest.fixture(scope="module")
def gpt2():
    sd = gpt2_state(seed=1)
    jcfg, tcfg = (m.GPT2Config.from_hf(GPT2_CONFIG) for m in (jgpt2, tgpt2))
    return (jloader.load_gpt2_params(sd, jcfg), jcfg,
            tloader.load_gpt2_params(sd, tcfg, device="cpu"), tcfg)


@pytest.fixture(scope="module")
def bert():
    sd = bert_state(seed=2)
    jcfg, tcfg = (m.BertConfig.from_hf(BERT_CONFIG) for m in (jbert, tbert))
    return (jloader.load_bert_params(sd, jcfg), jcfg,
            tloader.load_bert_params(sd, tcfg, device="cpu"), tcfg)


@pytest.fixture(params=["einsum", "flash"])
def attn_path(request, monkeypatch):
    monkeypatch.setenv("DEMODEL_FLASH_ATTN",
                       "1" if request.param == "flash" else "0")
    return request.param


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ layer_norm


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 0)])
def test_layer_norm_matches_jax(dtype, tol):
    """fp32 statistics, the scale in the activation dtype: bf16 outputs
    are bit-identical, fp32 within 1e-6."""
    rng = np.random.default_rng(3)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 96))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a, dtype) for a in (x, w, b))
    want = np.asarray(jcommon.layer_norm(jx, jw, jb, 1e-5).astype(
        jnp.float32))
    tdt = getattr(torch, dtype)
    got = tcommon.layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x, w, b)),
                             eps=1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------- loaders


def test_gpt2_loader_matches_jax(gpt2):
    """Conv1D weights load as stored ([in, out]), every leaf equal."""
    jparams, _, tparams, tcfg = gpt2
    jl, tl = jax.tree.leaves(jparams), _sorted_leaves(tparams)
    assert len(jl) == len(tl) == 4 + 12 * tcfg.n_layer
    for j, t in zip(jl, tl):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert tparams["layers"][0]["c_attn"]["w"].shape == (64, 192)


def test_bert_loader_matches_jax(bert):
    """nn.Linear weights transposed to [in, out], the pooler not read,
    every leaf equal."""
    jparams, _, tparams, tcfg = bert
    jl, tl = jax.tree.leaves(jparams), _sorted_leaves(tparams)
    assert len(jl) == len(tl) == 5 + 16 * tcfg.num_hidden_layers
    for j, t in zip(jl, tl):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert tparams["layers"][0]["inter"]["w"].shape == (64, 128)


def _sorted_leaves(tree) -> list:
    """The port tree's leaves in ``jax.tree.leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


@pytest.mark.parametrize("family", ["gpt2", "bert"])
def test_params_from_numpy_carries_the_reference_tree(family):
    """A params tree made by the reference's ``init_params`` carried across
    by ``params_from_numpy`` computes the reference's function."""
    jmod, tmod = (jgpt2, tgpt2) if family == "gpt2" else (jbert, tbert)
    cfg_cls = "GPT2Config" if family == "gpt2" else "BertConfig"
    jcfg, tcfg = getattr(jmod, cfg_cls).tiny(), getattr(tmod, cfg_cls).tiny()
    jparams = jax.jit(jmod.init_params, static_argnums=(1,))(
        jax.random.key(9), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    tok = _tokens(2, 11, tcfg.vocab_size, seed=9)
    run = _jgpt2 if family == "gpt2" else _jbert
    want = run(jparams, jnp.asarray(tok), jcfg)
    fn = tgpt2.forward if family == "gpt2" else tbert.encode
    _close(fn(tparams, torch.from_numpy(tok), tcfg), want)


# ------------------------------------------------------------------ GPT-2


@pytest.mark.parametrize("B,T", [(2, 17), (1, 64)])
def test_gpt2_forward_matches_jax(gpt2, attn_path, B, T):
    jparams, jcfg, tparams, tcfg = gpt2
    tok = _tokens(B, T, tcfg.vocab_size, seed=T)
    want = _jgpt2(jparams, jnp.asarray(tok), jcfg)
    got = tgpt2.forward(tparams, torch.from_numpy(tok), tcfg)
    assert got.shape == (B, T, tcfg.vocab_size)
    _close(got, want)


def test_gpt2_is_causal(gpt2, attn_path):
    """A token changed at position t leaves the logits before t as they
    were, and moves those from t on."""
    _, _, tparams, tcfg = gpt2
    tok = _tokens(1, 20, tcfg.vocab_size, seed=4)
    alt = tok.copy()
    alt[0, 12] = (alt[0, 12] + 1) % tcfg.vocab_size
    a, b = (tgpt2.forward(tparams, torch.from_numpy(t), tcfg)
            for t in (tok, alt))
    assert torch.equal(a[:, :12], b[:, :12])
    assert not torch.allclose(a[:, 12:], b[:, 12:])


def test_gpt2_qkv_views_read_in_place_on_the_card():
    """GPT-2 at its published widths: q, k and v are column slices of the
    c_attn output (a 2304-element row stride), which both kernels read in
    place at head dim 64 (the 4-D map in bf16/f16, strides in f32): no
    padded copy before K1."""
    B, T, H, hd = 2, 1024, 12, 64
    for dtype, kernel, maps in (
            (torch.bfloat16, "wgmma_bf16", ("4d",) * 3),
            (torch.float32, "tf32x3_f32", ("strides",) * 3)):
        qkv = torch.zeros(B, T, 3 * H * hd, dtype=dtype)
        q, k, v = (t.view(B, T, H, hd) for t in qkv.split(H * hd, -1))
        plan = tfa.launch_plan(q, k, v)
        assert (plan.kernel, plan.copy, plan.maps) == (kernel, (False,) * 3,
                                                       maps)


# ------------------------------------------------------------------- BERT


@pytest.mark.parametrize("B,T", [(2, 13), (1, 64)])
def test_bert_encode_matches_jax(bert, attn_path, B, T):
    jparams, jcfg, tparams, tcfg = bert
    tok = _tokens(B, T, tcfg.vocab_size, seed=T)
    types = _tokens(B, T, 2, seed=T + 1)
    want = _jbert(jparams, jnp.asarray(tok), jcfg,
                  token_type_ids=jnp.asarray(types))
    got = tbert.encode(tparams, torch.from_numpy(tok), tcfg,
                       token_type_ids=torch.from_numpy(types))
    assert got.shape == (B, T, tcfg.hidden_size)
    _close(got, want)


def test_bert_padding_mask_matches_jax(bert, attn_path):
    """Right-padded rows and one row that is all padding (finite: the
    bias is -1e30, not -inf), with flash asked for or not: the mask keeps
    the einsum path in both packages."""
    jparams, jcfg, tparams, tcfg = bert
    B, T = 3, 16
    tok = _tokens(B, T, tcfg.vocab_size, seed=7)
    mask = np.ones((B, T), np.int32)
    mask[0, 11:] = 0
    mask[2, :] = 0
    want = _jbert(jparams, jnp.asarray(tok), jcfg,
                  attention_mask=jnp.asarray(mask))
    got = tbert.encode(tparams, torch.from_numpy(tok), tcfg,
                       attention_mask=torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    _close(got, want)


# ------------------------------------------------------ model_from_pull


@pytest.fixture(scope="module")
def pulled(tmp_path_factory):
    """GPT-2 and BERT pulled from one fake Hub by both packages into
    their own stores, each built by its package's ``model_from_pull``:
    {family: (port fn, params, cfg, reference fn, params)}."""
    tmp = tmp_path_factory.mktemp("families")
    repos = {"org/gpt2": repo_files(GPT2_CONFIG, gpt2_state(seed=5)),
             "org/bert": repo_files(BERT_CONFIG, bert_state(seed=6))}
    built = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("DEMODEL_FETCH_WORKERS", "2")
    try:
        with FakeUpstream(handler=make_hf_handler(repos)) as up:
            hub = f"http://{up.authority}"
            for repo in repos:
                fam = repo.split("/")[1]
                tcfg = TConfig(cache_dir=tmp / f"t-{fam}", data_dir=tmp / "d")
                jcfg = JConfig(cache_dir=tmp / f"j-{fam}", data_dir=tmp / "d")
                trep, tplaced = tdelivery.pull_to_hbm(
                    repo, tcfg, endpoint=hub, mesh=make_mesh(device="cpu"))
                jrep, jplaced = jdelivery.pull_to_hbm(repo, jcfg,
                                                      endpoint=hub)
                ts = TStore(tcfg.cache_dir / "proxy")
                js = JStore(jcfg.cache_dir / "proxy")
                try:
                    tfn, tparams, tmcfg = tauto.model_from_pull(
                        ts, trep, placement=tplaced)
                    jfn, jparams, _ = jauto.model_from_pull(
                        js, jrep, placement=jplaced)
                finally:
                    ts.close()
                    js.close()
                built[fam] = (tfn, tparams, tmcfg, jfn, jparams)
    finally:
        mp.undo()
    return built


@pytest.mark.parametrize("family,cfg_cls", [("gpt2", tgpt2.GPT2Config),
                                            ("bert", tbert.BertConfig)])
def test_model_from_pull_matches_jax(pulled, attn_path, family, cfg_cls):
    tfn, tparams, tmcfg, jfn, jparams = pulled[family]
    assert isinstance(tmcfg, cfg_cls) and tmcfg.dtype == "float32"
    tok = _tokens(2, 12, 256, seed=8)
    want = jax.jit(jfn)(jparams, jnp.asarray(tok))
    got = tfn(tparams, torch.from_numpy(tok))
    assert got.device.type == "cpu"
    _close(got, want, PULL_TOL)


def test_param_shardings_take_one_device(gpt2, bert):
    """On one device every leaf has a spec (the tp split of the
    reference); a mesh of more devices is ROADMAP A7."""
    mesh = make_mesh(device="cpu")
    for mod, (_, _, params, cfg) in ((tgpt2, gpt2), (tbert, bert)):
        specs = _spec_leaves(mod.param_shardings(cfg, mesh))
        assert len(specs) == len(_sorted_leaves(params))
        assert all(isinstance(s, tuple) for s in specs)
    cpus = np.empty(2, dtype=object)
    cpus[:] = [torch.device("cpu")] * 2
    wide = Mesh(cpus.reshape(1, 2), ("dp", "tp"))
    for mod, cfg in ((tgpt2, gpt2[3]), (tbert, bert[3])):
        with pytest.raises(NotImplementedError, match="A7"):
            mod.param_shardings(cfg, wide)


def _spec_leaves(tree) -> list:
    """A spec tree's leaves, each spec (a tuple) one leaf."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]
