"""Placement over two ranks in the port against the JAX package's
``sink/hbm.py`` on a two-device mesh (``tests/test_two_host_delivery.py``
and ``tests/test_sink.py:128-192``'s cases).

Two gloo ranks (``tests/torch_mesh_rig.py``) deliver the same stored
blobs; the reference delivers them here onto the first two virtual CPU
devices at the same axis sizes. Both read from one directory through the
store surface the sinks use (``DirStore``, which also counts the bytes a
rank reads past the headers). Held: each rank's shard equals the
reference array's shard on the same device, byte for byte, with the same
spec; under ``tp`` each rank reads only its shards, and with
``ici_complete`` on a ``dp`` mesh each reads at most 0.55 of the
replicated bytes while together they read the file once, the all-gather
completing the replicas; ``ici_complete`` changes no byte; Q8_0, Q4_0
and K-quant GGUF dequantize each rank's rows only (and the whole tensor,
sliced, where rows do not align to blocks); fingerprints agree across
ranks; ``model_from_pull`` over two ranks gives the reference's logits.
"""

from __future__ import annotations

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu_torch.sink import hbm, streaming

from .torch_mesh_rig import Ranks
from .torch_mesh_worker import DirStore

jst = importlib.import_module("demodel_tpu.formats.safetensors")
jgguf = importlib.import_module("demodel_tpu.formats.gguf")
jhbm = importlib.import_module("demodel_tpu.sink.hbm")
jauto = importlib.import_module("demodel_tpu.models.auto")
jmesh = importlib.import_module("demodel_tpu.parallel.mesh")

torch.set_num_threads(1)
WORLD = 2
AXES = {"tp": {"tp": 2}, "dp": {"tp": 1}}
LOGITS_TOL = 2e-4  # tests/test_torch_pull.py


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(WORLD, tmp_path_factory.mktemp("ranks"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    """One directory of stored blobs: the two-host checkpoint (two
    tp-shardable weights and a large tensor the plan replicates on a dp
    mesh), and a GGUF file of every quant family."""
    root = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(0)
    ckpt = {"blocks.0.w": rng.standard_normal((256, 128)).astype(np.float32),
            "blocks.1.w": rng.standard_normal((256, 128)).astype(np.float32),
            "replicated.big": rng.standard_normal((512, 64)).astype(
                np.float32),
            "norm": rng.standard_normal((64,)).astype(np.float32)}
    (root / "ckpt").write_bytes(jst.serialize(ckpt))
    g = {"q8": rng.standard_normal((64, 256)).astype(np.float32),
         "q4": rng.standard_normal((32, 64)).astype(np.float32),
         "q4k": rng.standard_normal((64, 256)).astype(np.float32),
         "q5k": rng.standard_normal((16, 256)).astype(np.float32),
         "q2k": rng.standard_normal((16, 256)).astype(np.float32),
         "q6k": rng.standard_normal((32, 256)).astype(np.float32),
         "odd": rng.standard_normal((64, 48)).astype(np.float32),
         "f32": rng.standard_normal((32, 32)).astype(np.float32)}
    types = {"q8": jgguf.GGML_Q8_0, "q4": jgguf.GGML_Q4_0,
             "q4k": jgguf.GGML_Q4_K, "q5k": jgguf.GGML_Q5_K,
             "q2k": jgguf.GGML_Q2_K, "q6k": jgguf.GGML_Q6_K,
             "odd": jgguf.GGML_Q8_0, "f32": jgguf.GGML_F32}
    (root / "gguf").write_bytes(jgguf.serialize(g, types))
    return root, ckpt


def _reference(root, key, mode, **kw):
    mesh = jmesh.make_mesh(WORLD, **AXES[mode])
    store = DirStore(root)
    if key == "gguf":
        return jhbm.deliver_gguf(store, key, mesh=mesh, **kw)
    return jhbm.deliver_safetensors(store, key, mesh=mesh, **kw)


def _same_shards(out, ref, view=None) -> None:
    for r, (got, meta) in enumerate(out):
        assert set(got) == set(ref.arrays)
        for name, arr in ref.arrays.items():
            shard = {s.device.id: np.asarray(s.data)
                     for s in arr.addressable_shards}[r]
            want = shard.view(view) if view else shard
            assert got[name].tobytes() == want.tobytes(), (r, name)
            assert tuple(meta["specs"][name]) == tuple(arr.sharding.spec)
        assert meta["fp"] == out[0][1]["fp"]  # agree across ranks


@pytest.mark.parametrize("ici", [False, True], ids=["naive", "ici"])
@pytest.mark.parametrize("mode", ["tp", "dp"])
def test_safetensors_shards_match_the_reference(ranks, blobs, mode, ici):
    root, ckpt = blobs
    ref = _reference(root, "ckpt", mode, ici_complete=ici)
    out = ranks.run("sink", {"axes": AXES[mode], "store": str(root),
                             "key": "ckpt", "format": "safetensors",
                             "ici_complete": ici})
    _same_shards(out, ref)
    total = sum(a.nbytes for n, a in ckpt.items() if a.nbytes > 4096)
    reads = [meta["bytes_read"] for _, meta in out]
    if mode == "tp" or ici:
        # each rank reads its half; together, each byte once
        assert all(b <= 0.55 * total for b in reads), reads
        assert sum(reads) == total
    else:  # naive replication: every rank reads every byte
        assert reads == [total, total]


def test_ici_complete_changes_no_byte(ranks, blobs):
    root, ckpt = blobs
    runs = [ranks.run("sink", {"axes": AXES["dp"], "store": str(root),
                               "key": "ckpt", "format": "safetensors",
                               "ici_complete": ici}) for ici in (False, True)]
    for (naive, _), (staged, _) in zip(*runs):
        for name, want in ckpt.items():
            assert naive[name].tobytes() == staged[name].tobytes() \
                == want.tobytes(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gguf_dequantizes_each_ranks_rows(ranks, blobs, dtype):
    root, _ = blobs
    ref = _reference(root, "gguf", "tp", out_dtype=getattr(jnp, dtype))
    out = ranks.run("sink", {"axes": AXES["tp"], "store": str(root),
                             "key": "gguf", "format": "gguf",
                             "dtype": dtype})
    _same_shards(out, ref, view=np.int16 if dtype == "bfloat16" else None)
    for got, meta in out:
        assert meta["specs"]["q4k"] == ["tp", None]
        assert got["q4k"].shape == (32, 256)
    # each rank read only its rows of the row-aligned tensors, and all of
    # "odd" (48 columns: not whole Q8_0 blocks) once
    size = (root / "gguf").stat().st_size
    reads = [meta["bytes_read"] for _, meta in out]
    assert all(b < 0.6 * size for b in reads), reads


def _llama_dir(root) -> dict:
    """A seeded transformers-layout F32 Llama (config.json, two shards):
    the pull report ``model_from_pull`` reads."""
    cfg = {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 8, "num_key_value_heads": 2}
    rng = np.random.default_rng(9)
    D, I, V, hd = 64, 128, 256, 8

    def w(*shape, std=None):
        return (rng.standard_normal(shape)
                * (std or shape[-1] ** -0.5)).astype(np.float32)

    shards = [{"model.embed_tokens.weight": w(V, D, std=0.02)}, {}]
    for i in range(2):
        p = f"model.layers.{i}."
        shards[i].update({
            p + "input_layernorm.weight": 1 + w(D, std=0.1),
            p + "self_attn.q_proj.weight": w(8 * hd, D),
            p + "self_attn.k_proj.weight": w(2 * hd, D),
            p + "self_attn.v_proj.weight": w(2 * hd, D),
            p + "self_attn.o_proj.weight": w(D, 8 * hd),
            p + "post_attention_layernorm.weight": 1 + w(D, std=0.1),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": w(D, I)})
    shards[1]["model.norm.weight"] = 1 + w(D, std=0.1)
    shards[1]["lm_head.weight"] = w(V, D)
    (root / "cfg").write_text(json.dumps(cfg))
    files = [{"name": "config.json", "key": "cfg"}]
    for k, shard in enumerate(shards):
        (root / f"shard{k}").write_bytes(jst.serialize(shard))
        files.append({"name": f"model-{k + 1:05d}-of-00002.safetensors",
                      "key": f"shard{k}"})
    return {"files": files}


def test_model_from_pull_over_two_ranks_matches_the_reference(
        ranks, tmp_path):
    """Each rank places its shards, the loader moves o_proj and down_proj
    from the delivery's row split to row-parallel (one all-to-all), and
    the tp=2 forward equals the reference's logits."""
    report = _llama_dir(tmp_path)
    toks = np.random.default_rng(3).integers(0, 256, (2, 9)).astype(
        np.int32)
    mesh = jmesh.make_mesh(WORLD)
    jfn, jparams, _ = jauto.model_from_pull(DirStore(tmp_path), report,
                                            mesh=mesh)
    want = np.asarray(jfn(jparams, jnp.asarray(toks)))
    out = ranks.run("model_from_pull", {"axes": {"tp": 2},
                                        "store": str(tmp_path),
                                        "report": report}, {"tokens": toks})
    total = sum((tmp_path / f"shard{k}").stat().st_size for k in range(2))
    for got, meta in out:
        assert meta["dtype"] == "float32"
        np.testing.assert_allclose(got["logits"], want, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)
        assert meta["bytes_read"] < 0.6 * total


def test_ici_complete_default(monkeypatch):
    monkeypatch.delenv("DEMODEL_ICI_COMPLETE", raising=False)
    assert not hbm._ici_complete_default()  # no process group here
    monkeypatch.setenv("DEMODEL_ICI_COMPLETE", "1")
    assert hbm._ici_complete_default()
    monkeypatch.setenv("DEMODEL_ICI_COMPLETE", "off")
    assert not hbm._ici_complete_default()


def test_the_streaming_sink_never_all_gathers(monkeypatch, blobs):
    """Streamed files land in fetch order, which differs across ranks:
    the sink passes ``ici_complete=False`` whatever the default says."""
    root, ckpt = blobs
    monkeypatch.setenv("DEMODEL_ICI_COMPLETE", "1")
    seen = []
    inner = streaming.deliver_file

    def spy(*a, **kw):
        seen.append(kw.get("ici_complete"))
        return inner(*a, **kw)

    monkeypatch.setattr(streaming, "deliver_file", spy)
    from demodel_tpu_torch.parallel.mesh import make_mesh

    sink = streaming.StreamingSink(DirStore(root),
                                   mesh=make_mesh(device="cpu"))
    sink.submit({"name": "model.safetensors", "key": "ckpt"})
    placed = sink.finish()
    assert seen == [False]
    assert placed.arrays["norm"].numpy().tobytes() == ckpt["norm"].tobytes()
    assert placed.specs["blocks.0.w"] == ()
