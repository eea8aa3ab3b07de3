"""``GenEngine`` over several ranks in the port against the JAX package's
``serve/scheduler.py`` on one device.

Gloo ranks (``tests/torch_mesh_rig.py``) each hold their shards of the
reference's ``init_params`` (numpy, through ``shard_params``) and run a
port ``GenEngine`` on the mesh: rank 0 leads (submits, batches, emits),
every other rank runs rank 0's plans in lockstep. The reference engine
runs here on one CPU device, jitted, on the same params and prompts. The
config is a 2-layer f32 GQA Llama (H=4, Hkv=2), so ``tp=4`` takes
``llama._kv_index`` (one kv head a rank). Held, on ``{tp: 2}``,
``{tp: 4}``, ``{dp: 2, tp: 2}``, ``{sp: 2}`` and ``{dp: 2}``: greedy
tokens exactly equal to the reference's for a ragged mix with requests
joining a running batch; every rank's pool equal to rank 0's (blocks in
use after each plan, block count) and empty at the end; each pool
holding that rank's kv heads; ``submit`` refused on a follower. Then
``stop()`` on rank 0 with a running and a waiting request; a failed
decode on a follower (``{tp: 2}``, and ``{dp: 2}`` whose steps have no
collective) settling every request with an error, no token after it and
every rank stopped within a short group timeout; ``/generate`` on rank
0 through ``serve/http.py``; and a cold ``serve.load_model`` over two
ranks from a fake Hub, one store per rank, against the reference's
``load_model`` on one device.
"""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest
import torch

from demodel_tpu import serve as jserve
from demodel_tpu.config import ProxyConfig as JConfig

from .fake_registries import make_hf_handler
from .servers import FakeUpstream
from .test_torch_pull import MODEL, _llama_files
from .torch_mesh_rig import Ranks, flat_params
from .torch_refnative import reference_native_lib  # noqa: F401

jl = importlib.import_module("demodel_tpu.models.llama")
jsched = importlib.import_module("demodel_tpu.serve.scheduler")

torch.set_num_threads(1)

GQA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2)
#: a ragged mix: request 0 alone, 1 and 2 join its running batch, then 3
PROMPT_LENS = (9, 5, 12, 17)
NEW = 6
MESHES = {"tp2": (2, {"tp": 2}), "tp4": (4, {"tp": 4}),
          "dp2_tp2": (4, {"dp": 2, "tp": 2}), "sp2": (2, {"sp": 2}),
          "dp2": (2, {"dp": 2})}
#: the kv heads each rank's pool holds: Hkv/tp, or len(_kv_index) where
#: tp divides H but not Hkv (tp=4: one), Hkv where tp is 1
HEADS = {"tp2": 1, "tp4": 1, "dp2_tp2": 1, "sp2": 2, "dp2": 2}
#: the failure cases' group timeout (s): a rank waiting in a collective
#: that a failed sibling skipped gives up after this
FAIL_TIMEOUT_S = 4


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("two"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    r = Ranks(4, tmp_path_factory.mktemp("four"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig(**GQA)
    jparams = jl.init_params(jax.random.key(19), jcfg)
    return jcfg, jparams, flat_params(jax.tree.map(np.asarray, jparams))


def _prompts(lens, seed: int = 0) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GQA["vocab_size"], n).tolist() for n in lens]


def _inputs(flat: dict, prompts) -> dict:
    return dict(flat, prompts=np.concatenate(prompts).astype(np.int64),
                prompt_lens=np.array([len(p) for p in prompts], np.int64))


def _reference(jparams, jcfg, prompts, new: int) -> list[list[int]]:
    """The reference engine's greedy tokens on one device."""
    engine = jsched.GenEngine(jparams, jcfg, max_batch=4, queue_limit=16,
                              max_new_tokens=new, kv_mb=4).start()
    try:
        reqs = [engine.submit(p, new) for p in prompts]
        return [r.result(timeout=120) for r in reqs]
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def want(model):
    jcfg, jparams, _ = model
    return _reference(jparams, jcfg, _prompts(PROMPT_LENS), NEW)


@pytest.fixture(scope="module")
def served(request, model):
    """Per mesh name, the ``serve`` case's per-rank results (run once)."""
    runs: dict = {}

    def run(name: str):
        if name not in runs:
            world, axes = MESHES[name]
            ranks = request.getfixturevalue("two" if world == 2 else "four")
            runs[name] = ranks.run(
                "serve", {"axes": axes, "cfg": GQA, "new": NEW,
                          "max_batch": 4},
                _inputs(model[2], _prompts(PROMPT_LENS)))
        return runs[name]

    return run


@pytest.mark.parametrize("name", list(MESHES))
def test_tokens_equal_the_reference_engine(served, want, name):
    out = served(name)
    assert out[0][1]["leader"] and out[0][1]["tokens"] == want


@pytest.mark.parametrize("name", list(MESHES))
def test_every_pool_mirrors_rank_0s_and_ends_empty(served, name):
    out = served(name)
    log0, meta0 = out[0][0]["pool_log"], out[0][1]
    # a prefill and a decode step per plan, and the releases: the mix
    # leased blocks and gave them all back
    assert log0.size > len(PROMPT_LENS) and log0.max() > 0
    for arrays, meta in out:
        np.testing.assert_array_equal(arrays["pool_log"], log0)
        assert meta["num_blocks"] == meta0["num_blocks"]
        assert meta["in_use"] == 0


@pytest.mark.parametrize("name", list(MESHES))
def test_each_pool_holds_its_ranks_kv_heads(served, name):
    assert [m["heads"] for _, m in served(name)] == \
        [HEADS[name]] * MESHES[name][0]


@pytest.mark.parametrize("name", list(MESHES))
def test_followers_refuse_submit_and_stop_with_rank_0(served, name):
    out = served(name)
    assert out[0][1]["joined"]
    for _, meta in out[1:]:
        assert not meta["leader"] and meta["refused"] and meta["joined"]


def test_stop_on_rank_0_settles_every_request_and_stops_every_rank(
        two, model):
    prompts = _prompts((5, 7), seed=1)
    out = two.run("serve_stop", {"axes": {"tp": 2}, "cfg": GQA, "new": 200},
                  _inputs(model[2], prompts))
    lead = out[0][1]
    running, waiting = lead["errors"]
    assert running == "engine shutdown" and waiting == "engine shutdown"
    assert 1 <= lead["generated"] < 200
    assert lead["joined"] and lead["outstanding"] == 0
    assert out[1][1]["refused"] and out[1][1]["joined"]
    assert [m["in_use"] for _, m in out] == [0, 0]


@pytest.mark.parametrize("axes", [{"tp": 2}, {"dp": 2}], ids=str)
def test_a_failed_follower_step_stops_every_rank(two, model, want, axes):
    """Rank 1's third decode raises: rank 0 emits the prefill's token and
    the first two decode steps' and nothing after, every request fails,
    submit refuses, and both engines end within a few group timeouts.
    (The case runs on a mesh of its own, whose groups it leaves out of
    step.)"""
    prompts = _prompts(PROMPT_LENS[:2])
    out = two.run("serve_fail", {
        "axes": axes, "cfg": GQA, "new": NEW, "fail_rank": 1, "fail_at": 3,
        "timeout_s": FAIL_TIMEOUT_S}, _inputs(model[2], prompts))
    lead = out[0][1]
    assert all(e and e.startswith("mesh step failed") for e in
               lead["errors"]), lead["errors"]
    assert lead["tokens"] == [w[:3] for w in want[:2]]
    assert "stopped" in lead["submit_after"]
    for _, meta in out:
        assert meta["joined"] and meta["in_use"] == 0
        assert meta["stopped_s"] < 4 * FAIL_TIMEOUT_S, meta


def test_generate_over_http_on_rank_0(two, model, want):
    prompts = _prompts(PROMPT_LENS[:2])
    out = two.run("serve_http", {"axes": {"tp": 2}, "cfg": GQA, "new": NEW},
                  _inputs(model[2], prompts))
    lead, follower = out[0][1], out[1][1]
    assert lead["installed"] and not follower["installed"]
    assert lead["http"] == lead["submit"] == want[:2]
    assert lead["joined"] and follower["refused"] and follower["joined"]
    assert lead["in_use"] == follower["in_use"] == 0


#: the Hub's Llama: test_torch_pull's, with GQA = 4 q heads over 2 kv
HUB_CONFIG = {"num_attention_heads": 4, "num_key_value_heads": 2}


@pytest.fixture(scope="module")
def hub():
    with FakeUpstream(handler=make_hf_handler(
            {MODEL: _llama_files(3, HUB_CONFIG)})) as up:
        yield f"http://{up.authority}"


def test_cold_load_model_over_two_ranks_serves_the_reference_tokens(
        two, hub, tmp_path, monkeypatch):
    monkeypatch.setenv("DEMODEL_FETCH_WORKERS", "2")
    prompts = _prompts((5, 11), seed=2)
    out = two.run("serve_load_model", {
        "axes": {"tp": 2}, "new": NEW, "model": MODEL, "hub": hub,
        "root": str(tmp_path / "ranks")}, _inputs({}, prompts))
    jengine = jserve.load_model(
        MODEL, JConfig(cache_dir=tmp_path / "j-cache",
                       data_dir=tmp_path / "j-data"),
        endpoint=hub, max_new_tokens=NEW, kv_mb=4)
    try:
        ref = [jengine.submit(p, NEW).result(timeout=120) for p in prompts]
    finally:
        jengine.stop()
        jserve.install(None)
    lead, follower = out[0][1], out[1][1]
    assert lead["tokens"] == ref
    assert lead["installed"] and not follower["installed"]
    assert follower["refused"] and follower["joined"]
    # each rank pulled through its own store
    assert lead["store"] == follower["store"] and "proxy" in lead["store"]
    assert lead["in_use"] == follower["in_use"] == 0
