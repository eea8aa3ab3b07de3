"""Port parity: manifests from a client-warmed cache — ``synthesize_manifest``
(HF, gated, Ollama) and ``materialize`` of ``demodel_tpu_torch.delivery``
against ``demodel_tpu.delivery``, on the CPU.

A store is warmed only by a foreign client through the port's MITM
proxy (``chip_smoke``'s stdlib clients: ``huggingface-cli``'s resolve →
302 → CDN flow against a TLS ``make_hf_handler`` Hub serving
``tests/test_torch_pull.py``'s seeded F32 two-layer GQA Llama, and
``ollama pull``'s registry-v2 flow, token included, against a TLS
``make_ollama_handler``). Each package synthesizes on its own copy of
the store: equal records, equal persisted manifests, equal store trees,
and ``materialize`` writes equal bytes. The gated cases of
``tests/test_pod_delivery.py`` run on both packages. Then the port's
``pull_manifest_to_hbm`` off the MITM-warmed proxy places the tensors
the reference places, and a tiny Llama built from them gives the
reference's greedy tokens exactly.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import time

import numpy as np
import pytest
import torch

import chip_smoke
from demodel_tpu import delivery as jdelivery
from demodel_tpu.models import hf_loader as jhf
from demodel_tpu.models import llama as jl
from demodel_tpu.parallel import peer as jpeer
from demodel_tpu.sink import remote as jremote
from demodel_tpu.store import Store as JStore
from demodel_tpu.utils import faults as jfaults
from demodel_tpu_torch import delivery as tdelivery
from demodel_tpu_torch import pki as tpki
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.formats import safetensors as tst
from demodel_tpu_torch.models import hf_loader as thf
from demodel_tpu_torch.models import llama as tl
from demodel_tpu_torch.parallel import make_mesh
from demodel_tpu_torch.parallel import peer as tpeer
from demodel_tpu_torch.proxy import ProxyServer as TProxy
from demodel_tpu_torch.sink import remote as tremote
from demodel_tpu_torch.store import Store as TStore
from demodel_tpu_torch.store import key_for_uri
from demodel_tpu_torch.utils import faults as tfaults

from .fake_registries import (build_ollama_model, make_hf_handler,
                              make_ollama_handler)
from .servers import FakeUpstream
from .test_torch_pull import MODEL, _llama_files

torch.set_num_threads(1)

OLLAMA_MODEL = "tiny:latest"


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    monkeypatch.setenv("DEMODEL_FETCH_WORKERS", "2")
    monkeypatch.setenv("DEMODEL_RETRY_BASE_MS", "20")
    monkeypatch.delenv("DEMODEL_PEERS", raising=False)
    monkeypatch.delenv("DEMODEL_PROFILE_DIR", raising=False)
    for mod in (tfaults, jfaults):
        mod.PeerHealth.reset_shared()
    yield
    for mod in (tpeer, jpeer):
        mod.PeerGossip.reset_shared()
    for mod in (tfaults, jfaults):
        mod.PeerHealth.reset_shared()


def _await(store_root, uris) -> None:
    """Until the store holds an entry for each of ``uris`` (the native
    plane may commit after the client's last byte; a credentialed entry's
    key is scoped, so match on the URI)."""
    deadline = time.monotonic() + 30
    with TStore(store_root) as s:
        while not set(uris) <= {(s.meta(k) or {}).get("uri")
                                for k in s.list()}:
            assert time.monotonic() < deadline, "store did not commit"
            time.sleep(0.05)


@pytest.fixture(scope="module")
def warmed(tmp_path_factory):
    """A TLS Hub and a TLS registry-v2, the port's MITM proxy over both,
    and a store warmed through it by the stdlib clients only: yields
    (proxy, store root, the Hub's files, the Ollama manifest)."""
    tmp = tmp_path_factory.mktemp("warmed")
    files = _llama_files()
    manifest, blobs = build_ollama_model(seed=3)
    mp = pytest.MonkeyPatch()
    mp.setenv("DEMODEL_PROXY_IDLE_TIMEOUT", "1")
    hub = FakeUpstream(handler=make_hf_handler({MODEL: files}),
                       tls_dir=tmp / "hubca").start()
    reg = FakeUpstream(handler=make_ollama_handler(
        {"library/tiny:latest": manifest}, blobs, require_token=True),
        tls_dir=tmp / "regca").start()
    bundle = tmp / "upstream-cas.pem"
    bundle.write_bytes(hub.ca_path.read_bytes() + reg.ca_path.read_bytes())
    cfg = TConfig(host="127.0.0.1", port=0, cache_dir=tmp / "cache",
                  data_dir=tmp / "data", use_ecdsa=True,
                  mitm_hosts=[hub.authority, reg.authority])
    proxy = TProxy(cfg, upstream_ca=str(bundle), verbose=False,
                   session_threads=4).start()
    try:
        opener = chip_smoke._client(proxy.url,
                                    tpki.ca_paths(cfg.data_dir)[0])
        base = f"https://{hub.authority}"
        got = chip_smoke._hf_download(opener, base, MODEL, sorted(files))
        assert got == {n: (len(b), hashlib.sha256(b).hexdigest())
                       for n, b in files.items()}
        assert chip_smoke._v2_pull(opener, f"https://{reg.authority}",
                                   OLLAMA_MODEL) == manifest
        v2 = f"https://{reg.authority}/v2/library/tiny"
        _await(cfg.cache_dir / "proxy", [
            f"{base}/{MODEL}/resolve/main/{n}" for n in files] + [
            f"{base}/cdn/{MODEL}/{hashlib.sha256(b).hexdigest()}"
            for n, b in files.items() if n.endswith(".safetensors")] + [
            f"{v2}/manifests/latest"] + [f"{v2}/blobs/{d}" for d in blobs])
        yield proxy, cfg.cache_dir / "proxy", files, manifest
    finally:
        proxy.stop()
        hub.stop()
        reg.stop()
        mp.undo()


def _copies(root, tmp_path) -> tuple:
    """Two copies of the store at ``root``: the port's and the
    reference's."""
    t, j = tmp_path / "t", tmp_path / "j"
    shutil.copytree(root, t)
    shutil.copytree(root, j)
    return t, j


def _tree(root) -> dict:
    """key → (size, meta) of a store."""
    with TStore(root) as s:
        return {k: (s.size(k), s.meta(k)) for k in s.list()}


@pytest.mark.parametrize("source,model", [("hf", MODEL),
                                          ("ollama", OLLAMA_MODEL)])
def test_synthesized_records_match_the_reference(warmed, tmp_path, source,
                                                 model):
    _, root, files, manifest = warmed
    troot, jroot = _copies(root, tmp_path)
    with TStore(troot) as ts, JStore(jroot) as js:
        trec = tdelivery.synthesize_manifest(ts, model, source=source)
        jrec = jdelivery.synthesize_manifest(js, model, source=source)
        mkey = tdelivery.manifest_key(source, model)
        assert trec == jrec
        assert ts.get(mkey) == js.get(mkey)
        tout = tdelivery.materialize(trec, ts, tmp_path / "mt")
        jout = jdelivery.materialize(jrec, js, tmp_path / "mj")
    assert _tree(troot) == _tree(jroot)
    assert [p.name for p in tout] == [p.name for p in jout]
    for a, b in zip(tout, jout):
        assert a.read_bytes() == b.read_bytes()
    if source == "hf":
        want = {n: (len(b), hashlib.sha256(b).hexdigest())
                for n, b in files.items()}
        assert {f["name"]: (f["size"], f["sha256"])
                for f in trec["files"]} == want
        for f in trec["files"]:
            if f["name"].endswith(".safetensors"):
                assert f["key"] == key_for_uri(
                    f"demodel://synth/{MODEL}/{f['name']}")
        assert {p.name: p.read_bytes() for p in tout} == files
    else:
        layers = [manifest["config"], *manifest["layers"]]
        assert sorted(f["name"] for f in trec["files"]) == sorted(
            b["digest"].split(":")[1] for b in layers)
        for p in tout:
            assert hashlib.sha256(p.read_bytes()).hexdigest() == p.name


def test_nothing_cached_raises_in_both(tmp_path):
    with TStore(tmp_path / "t") as ts, JStore(tmp_path / "j") as js:
        for fn, s in ((tdelivery.synthesize_manifest, ts),
                      (jdelivery.synthesize_manifest, js)):
            with pytest.raises(FileNotFoundError, match="resolve"):
                fn(s, "org/absent")
            with pytest.raises(FileNotFoundError, match="manifests"):
                fn(s, "absent:latest", source="ollama")


def _gated_republish(delivery, store) -> list:
    body = tst.serialize({"w": np.ones((8, 8), np.float32)})
    uri = "https://hub/org/gated/resolve/main/model.safetensors"
    store.put("gatedentry000001", body, {
        "uri": uri, "status": 200, "auth_scope": "deadbeef00000000",
        "sha256": hashlib.sha256(body).hexdigest()})
    assert store.is_private("gatedentry000001")
    out = []
    with pytest.raises(PermissionError, match="include_private") as e:
        delivery.synthesize_manifest(store, "org/gated")
    out.append(str(e.value))
    record = delivery.synthesize_manifest(store, "org/gated",
                                          include_private=True)
    (entry,) = record["files"]
    assert entry["key"] != "gatedentry000001"
    assert not store.is_private(entry["key"])
    assert store.get(entry["key"]) == body
    return out + [record, store.meta(entry["key"])]


def _gated_mixed(delivery, store) -> list:
    pub = tst.serialize({"w": np.ones((4, 4), np.float32)})
    gated_aux = b'{"vocab": {}}'
    base = "https://hub/org/mixed/resolve/main"
    store.put("publicentry00001", pub, {
        "uri": f"{base}/model.safetensors", "status": 200,
        "sha256": hashlib.sha256(pub).hexdigest()})
    store.put("gatedentry000001", gated_aux, {
        "uri": f"{base}/tokenizer.json", "status": 200,
        "auth_scope": "deadbeef00000000",
        "sha256": hashlib.sha256(gated_aux).hexdigest()})
    out = [delivery.synthesize_manifest(store, "org/mixed")]
    assert [f["name"] for f in out[0]["files"]] == ["model.safetensors"]
    out.append(delivery.synthesize_manifest(store, "org/mixed",
                                            include_private=True))
    assert sorted(f["name"] for f in out[1]["files"]) == [
        "model.safetensors", "tokenizer.json"]
    gated_w = tst.serialize({"g": np.zeros((4, 4), np.float32)})
    store.put("gatedweight00001", gated_w, {
        "uri": f"{base}/model-00002.safetensors", "status": 200,
        "auth_scope": "deadbeef00000000",
        "sha256": hashlib.sha256(gated_w).hexdigest()})
    with pytest.raises(PermissionError, match="weights") as e:
        delivery.synthesize_manifest(store, "org/mixed")
    return out + [str(e.value)]


def _gated_corrupt_copy(delivery, store) -> list:
    """A gated entry whose bytes do not hash to its recorded digest is
    refused under ``include_private``, and nothing is published."""
    uri = "https://hub/org/bad/resolve/main/model.safetensors"
    store.put("gatedentry000001", b"not the recorded bytes", {
        "uri": uri, "status": 200, "auth_scope": "deadbeef00000000",
        "sha256": "0" * 64})
    with pytest.raises(IOError, match="does not match") as e:
        delivery.synthesize_manifest(store, "org/bad", include_private=True)
    assert not store.has(key_for_uri(
        "demodel://synth/org/bad/model.safetensors"))
    return [str(e.value)]


@pytest.mark.parametrize("case", [_gated_republish, _gated_mixed,
                                  _gated_corrupt_copy],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_gated_entries_match_the_reference(tmp_path, case):
    """``tests/test_pod_delivery.py``'s gated cases, each on both
    packages: the same records, errors and resulting store trees."""
    with TStore(tmp_path / "t") as ts:
        tout = case(tdelivery, ts)
    with JStore(tmp_path / "j") as js:
        jout = case(jdelivery, js)
    assert tout == jout
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


def test_sharded_pull_off_the_mitm_warmed_proxy(warmed):
    """``tests/test_pod_delivery.py:549`` on the port: no record, no
    sharded pull; after the port's ``manifest`` the port's placement off
    the proxy equals the reference's, byte for byte, and a tiny Llama
    built from it gives the reference's greedy tokens."""
    proxy, root, files, _ = warmed
    with TStore(root) as s:
        mkey = tdelivery.manifest_key("hf", MODEL)
        if s.has(mkey):
            s.remove(mkey)
        with pytest.raises(IOError):
            tremote.fetch_manifest([proxy.url], MODEL)
        record = tdelivery.synthesize_manifest(s, MODEL)
    assert tremote.fetch_manifest([proxy.url], MODEL)[1] == record
    trep, tplaced = tremote.pull_manifest_to_hbm(
        MODEL, [proxy.url], mesh=make_mesh(device="cpu"))
    _, jplaced = jremote.pull_manifest_to_hbm(MODEL, [proxy.url])
    assert sorted(tplaced.arrays) == sorted(jplaced.arrays)
    for name, t in tplaced.arrays.items():
        assert _bytes(t) == _bytes(jplaced.arrays[name]), name
    weight = sum(len(b) for n, b in files.items()
                 if n.endswith(".safetensors"))
    assert trep["network_bytes"] == trep["weight_bytes"] == weight

    config = json.loads(files["config.json"])
    tcfg, jcfg = tl.LlamaConfig.from_hf(config), jl.LlamaConfig.from_hf(
        config)
    tparams = thf.load_llama_params(tplaced.arrays, tcfg, device="cpu")
    jparams = jhf.load_llama_params(
        {k: np.asarray(v) for k, v in jplaced.arrays.items()}, jcfg)
    prompt = np.random.default_rng(5).integers(0, 256, 9).tolist()
    want = np.asarray(jl.generate(jparams, jcfg, prompt, 6))[0]
    got = tl.generate(tparams, tcfg, prompt, 6)
    assert got[0].tolist() == [int(t) for t in want]
