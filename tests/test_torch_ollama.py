"""Port parity: the Ollama source of ``demodel_tpu_torch`` (registry-v2
client, ``delivery.pull`` and ``pull_to_hbm(source="ollama")``) against
``demodel_tpu`` on the CPU.

One fake registry-v2 (``tests/fake_registries.make_ollama_handler``)
serves ``build_ollama_model``'s manifest with a seeded GGUF (Q8_0, Q4_K
and F32 tensors, written by the reference's ``gguf.serialize``) as the
model layer. Both packages land the same keys, bytes and sha256 in their
stores, write the same manifest record, and place byte-identical tensors
(the port on the CPU, through the dequant kernels' plain versions). A
blob whose bytes do not match its digest raises and commits nothing.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from demodel_tpu import delivery as jdelivery
from demodel_tpu.config import ProxyConfig as JConfig
from demodel_tpu.formats import gguf as jg
from demodel_tpu.registry import ollama as jollama
from demodel_tpu.store import Store as JStore
from demodel_tpu_torch import delivery as tdelivery
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.parallel import make_mesh
from demodel_tpu_torch.registry import ollama as tollama
from demodel_tpu_torch.store import Store as TStore
from demodel_tpu_torch.store import key_for_uri

from .fake_registries import build_ollama_model, make_ollama_handler
from .servers import FakeUpstream
from .torch_refnative import reference_native_lib  # noqa: F401

torch.set_num_threads(1)

MODEL = "llama:7b-q4_K_M"
REPO = "library/llama:7b-q4_K_M"
MODEL_MEDIA = "application/vnd.ollama.image.model"


@pytest.fixture(autouse=True)
def _two_workers(monkeypatch):
    monkeypatch.setenv("DEMODEL_FETCH_WORKERS", "2")
    monkeypatch.delenv("DEMODEL_PEERS", raising=False)
    monkeypatch.delenv("DEMODEL_PROFILE_DIR", raising=False)


def _gguf_blob(seed: int = 5) -> bytes:
    rng = np.random.default_rng(seed)
    tensors = {
        "token_embd.weight": rng.standard_normal((8, 256)).astype(np.float32),
        "blk.0.attn_q.weight": rng.standard_normal((4, 512)).astype(
            np.float32),
        "blk.0.attn_norm.weight": rng.standard_normal((64,)).astype(
            np.float32),
    }
    types = {"token_embd.weight": jg.GGML_Q4_K,
             "blk.0.attn_q.weight": jg.GGML_Q8_0}
    return jg.serialize(tensors, types, {"general.architecture": "llama"})


def _model(seed: int = 5) -> tuple[dict, dict[str, bytes]]:
    """``build_ollama_model``'s manifest and blobs with a GGUF as its
    model layer."""
    manifest, blobs = build_ollama_model(seed=seed, blob_kb=1)
    layer = next(x for x in manifest["layers"]
                 if x["mediaType"] == MODEL_MEDIA)
    del blobs[layer["digest"]]
    gguf = _gguf_blob(seed)
    layer["digest"] = "sha256:" + hashlib.sha256(gguf).hexdigest()
    layer["size"] = len(gguf)
    blobs[layer["digest"]] = gguf
    return manifest, blobs


@pytest.fixture(scope="module")
def registry():
    manifest, blobs = _model()
    handler = make_ollama_handler({REPO: manifest}, blobs)
    with FakeUpstream(handler=handler) as up:
        yield f"http://{up.authority}", manifest, blobs, handler


def _configs(tmp_path, name):
    return (TConfig(cache_dir=tmp_path / f"t-{name}", data_dir=tmp_path / "d"),
            JConfig(cache_dir=tmp_path / f"j-{name}", data_dir=tmp_path / "d"))


def _no_timings(rec: dict) -> dict:
    rec = {k: v for k, v in rec.items() if k not in ("secs", "tpu_sink")}
    rec["files"] = [{k: v for k, v in f.items() if k != "secs"}
                    for f in rec["files"]]
    return rec


@pytest.mark.parametrize("name,want", [
    ("llama3", ("library/llama3", "latest")),
    ("llama3:8b", ("library/llama3", "8b")),
    ("user/model", ("user/model", "latest")),
    ("user/model:tag", ("user/model", "tag")),
])
def test_normalize_name_matches_reference(name, want):
    assert tollama.normalize_name(name) == jollama.normalize_name(name) \
        == want


def test_manifest_and_urls_match_reference(registry, tmp_path):
    url, manifest, _, _ = registry
    with TStore(tmp_path / "t") as ts, JStore(tmp_path / "j") as js:
        treg = tollama.OllamaRegistry(ts, endpoint=url + "/")
        jreg = jollama.OllamaRegistry(js, endpoint=url + "/")
        try:
            assert treg.manifest("llama", "7b-q4_K_M") == \
                jreg.manifest("llama", "7b-q4_K_M") == manifest
            assert treg.manifest_url(*tollama.normalize_name(MODEL)) == \
                jreg.manifest_url(*jollama.normalize_name(MODEL))
            digest = manifest["layers"][0]["digest"]
            assert treg.blob_url(REPO.split(":")[0], digest) == \
                jreg.blob_url(REPO.split(":")[0], digest)
        finally:
            treg.fetcher.close()


def test_pull_lands_the_reference_keys_bytes_and_manifest(registry,
                                                           tmp_path):
    """``delivery.pull(source="ollama", sink="cache")`` in both packages:
    the manifest, the config and three layers, each under the same key
    with the same bytes, meta and sha256; the same manifest record."""
    url, _, blobs, _ = registry
    tcfg, jcfg = _configs(tmp_path, "cache")
    trep = tdelivery.pull(MODEL, tcfg, source="ollama", endpoint=url)
    jrep = jdelivery.pull(MODEL, jcfg, source="ollama", endpoint=url)
    assert _no_timings(trep) == _no_timings(jrep)
    assert trep["source"] == "ollama" and len(trep["files"]) == 5
    assert "tpu_sink" not in trep
    mkey = tdelivery.manifest_key("ollama", MODEL)
    ts, js = TStore(tcfg.cache_dir / "proxy"), JStore(jcfg.cache_dir / "proxy")
    try:
        assert sorted(ts.list()) == sorted(js.list())
        for f in trep["files"][1:]:
            body = blobs[f["name"]]
            assert ts.get(f["key"]) == js.get(f["key"]) == body
            assert f["sha256"] == hashlib.sha256(body).hexdigest() \
                == f["name"].split(":")[1]
            assert ts.meta(f["key"]) == js.meta(f["key"])
        trec, jrec = (json.loads(s.get(mkey)) for s in (ts, js))
        assert _no_timings(trec) == _no_timings(jrec)
        assert ts.meta(mkey)["source"] == "ollama"
    finally:
        ts.close()
        js.close()


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_placement_matches_reference(registry, tmp_path):
    """``pull_to_hbm(source="ollama")``: the GGUF layer streams through
    the sink and dequantizes in bf16; the port's CPU placement is byte
    for byte the reference's on its CPU mesh, and only the model layer
    is placed."""
    url, manifest, blobs, _ = registry
    tcfg, jcfg = _configs(tmp_path, "hbm")
    trep, tplaced = tdelivery.pull_to_hbm(MODEL, tcfg, source="ollama",
                                          endpoint=url,
                                          mesh=make_mesh(device="cpu"))
    jrep, jplaced = jdelivery.pull_to_hbm(MODEL, jcfg, source="ollama",
                                          endpoint=url)
    assert sorted(tplaced.arrays) == sorted(jplaced.arrays) == [
        "blk.0.attn_norm.weight", "blk.0.attn_q.weight", "token_embd.weight"]
    for name, t in tplaced.arrays.items():
        want = np.asarray(jplaced.arrays[name])
        assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
        assert tuple(t.shape) == want.shape
        assert _bytes(t) == want.tobytes(), name
    assert trep["tpu_sink"]["tensors"] == jrep["tpu_sink"]["tensors"] == 3
    assert _no_timings(trep) == _no_timings(jrep)


def test_digest_mismatch_raises_and_commits_nothing(tmp_path):
    """A layer served with other bytes than its digest: the pull raises
    in both packages and neither store holds the layer's key."""
    manifest, blobs = _model(seed=6)
    bad = manifest["layers"][0]["digest"]
    blobs = dict(blobs)
    blobs[bad] = b"corrupted-bytes" * 100
    manifest["layers"][0]["size"] = len(blobs[bad])
    handler = make_ollama_handler({"library/bad:latest": manifest}, blobs)
    tcfg, jcfg = _configs(tmp_path, "bad")
    with FakeUpstream(handler=handler) as up:
        url = f"http://{up.authority}"
        with pytest.raises(IOError, match="digest mismatch"):
            tdelivery.pull("bad", tcfg, source="ollama", endpoint=url)
        with pytest.raises(IOError, match="digest mismatch"):
            jdelivery.pull("bad", jcfg, source="ollama", endpoint=url)
    key = key_for_uri(f"{url}/v2/library/bad/blobs/{bad}")
    for s in (TStore(tcfg.cache_dir / "proxy"),
              JStore(jcfg.cache_dir / "proxy")):
        try:
            assert not s.has(key)
            assert not s.has(tdelivery.manifest_key("ollama", "bad"))
        finally:
            s.close()


def test_schema_version_other_than_2_is_refused(tmp_path):
    manifest, blobs = _model(seed=7)
    manifest["schemaVersion"] = 1
    handler = make_ollama_handler({"library/old:latest": manifest}, blobs)
    tcfg, _ = _configs(tmp_path, "old")
    with FakeUpstream(handler=handler) as up:
        with pytest.raises(ValueError, match="schemaVersion"):
            tdelivery.pull("old", tcfg, source="ollama",
                           endpoint=f"http://{up.authority}")
    assert handler.request_counts.get("blob", 0) == 0


def test_repeated_layer_is_fetched_once(tmp_path):
    """A digest listed twice (config and layer alike) is fetched once and
    reported at both places, as in the reference."""
    manifest, blobs = _model(seed=8)
    manifest["layers"].append(dict(manifest["layers"][1]))
    handler = make_ollama_handler({"library/dup:latest": manifest}, blobs)
    tcfg, _ = _configs(tmp_path, "dup")
    with FakeUpstream(handler=handler) as up:
        rep = tdelivery.pull("dup", tcfg, source="ollama",
                             endpoint=f"http://{up.authority}")
    assert len(rep["files"]) == 6
    assert rep["files"][-1] == rep["files"][3]  # manifest, config, layers
    # four distinct blobs, each a HEAD (the size probe) and one GET
    assert handler.request_counts["blob"] == 2 * 4
