"""Port parity: the pull plane of ``demodel_tpu_torch`` — the fetcher on
``http.client``, the HF registry, streaming delivery, ``model_from_pull``
and ``serve.load_model`` — against ``demodel_tpu`` on the CPU.

One fake HuggingFace Hub (``tests/fake_registries.make_hf_handler`` under
``tests/servers.FakeUpstream``) serves a seeded F32 two-layer GQA Llama
in two safetensors shards. The reference's and the port's pulls land the
same keys and bytes, write the same manifest record and place
byte-identical tensors; the built models' logits agree within 2e-4 (the
reference's HF-logits tolerance) and ``load_model`` serves the same
greedy tokens, the port's through ``/generate``. Then the fetcher's wire
semantics on both packages against one origin (a body cut mid-way
resumes with one retry; a wrong digest raises at once; the native
parallel fetch lands what the reference's lands), the wire policy's
classification, the streaming sink's byte budget, and the failure paths
(unsupported config fields, an unknown family; GPT-2 and BERT build).
The Ollama source and peers are held in ``test_torch_ollama.py`` and
``test_torch_peer.py``.
"""

from __future__ import annotations

import hashlib
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demodel_tpu import delivery as jdelivery
from demodel_tpu import serve as jserve
from demodel_tpu.config import ProxyConfig as JConfig
from demodel_tpu.models import auto as jauto
from demodel_tpu.registry import base as jbase
from demodel_tpu.store import Store as JStore
from demodel_tpu_torch import delivery as tdelivery
from demodel_tpu_torch import serve as tserve
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.formats import safetensors as tst
from demodel_tpu_torch.models import auto as tauto
from demodel_tpu_torch.models import bert as tbert
from demodel_tpu_torch.models import gpt2 as tgpt2
from demodel_tpu_torch.parallel import make_mesh
from demodel_tpu_torch.registry import base as tbase
from demodel_tpu_torch.serve import http as thttp
from demodel_tpu_torch.sink import streaming
from demodel_tpu_torch.store import Store as TStore
from demodel_tpu_torch.utils import faults

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

LOGITS_TOL = 2e-4
MODEL = "org/llama"
CONFIG = {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 8, "num_key_value_heads": 2,
          "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
          "tie_word_embeddings": False, "torch_dtype": "float32"}


@pytest.fixture(autouse=True)
def _two_workers(monkeypatch):
    monkeypatch.setenv("DEMODEL_FETCH_WORKERS", "2")
    monkeypatch.delenv("DEMODEL_PEERS", raising=False)
    monkeypatch.delenv("DEMODEL_PROFILE_DIR", raising=False)


def _llama_files(seed: int = 0, config: dict | None = None) -> dict:
    """A ``transformers``-layout F32 Llama (``[out, in]`` projections) of
    seeded random weights: config.json, two shards and their index."""
    cfg = dict(CONFIG, **(config or {}))
    rng = np.random.default_rng(seed)
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    nh, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = H // nh

    def w(*shape, std=None):
        return (rng.standard_normal(shape)
                * (std or shape[-1] ** -0.5)).astype(np.float32)

    shards: list[dict] = [{"model.embed_tokens.weight": w(V, H, std=0.02)},
                          {}]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shards[i % 2].update({
            p + "input_layernorm.weight": 1 + w(H, std=0.1),
            p + "self_attn.q_proj.weight": w(nh * hd, H),
            p + "self_attn.k_proj.weight": w(kv * hd, H),
            p + "self_attn.v_proj.weight": w(kv * hd, H),
            p + "self_attn.o_proj.weight": w(H, nh * hd),
            p + "post_attention_layernorm.weight": 1 + w(H, std=0.1),
            p + "mlp.gate_proj.weight": w(I, H),
            p + "mlp.up_proj.weight": w(I, H),
            p + "mlp.down_proj.weight": w(H, I)})
    shards[1]["model.norm.weight"] = 1 + w(H, std=0.1)
    shards[1]["lm_head.weight"] = w(V, H)
    files = {"config.json": json.dumps(cfg).encode()}
    weight_map = {}
    for k, shard in enumerate(shards):
        name = f"model-{k + 1:05d}-of-00002.safetensors"
        files[name] = tst.serialize(shard)
        weight_map.update(dict.fromkeys(shard, name))
    files["model.safetensors.index.json"] = json.dumps(
        {"metadata": {}, "weight_map": weight_map}).encode()
    return files


@pytest.fixture(scope="module")
def hub():
    """The fake Hub serving the Llama; yields its endpoint."""
    with FakeUpstream(handler=make_hf_handler(
            {MODEL: _llama_files()})) as up:
        yield f"http://{up.authority}"


def _configs(tmp_path, name):
    return (TConfig(cache_dir=tmp_path / f"t-{name}", data_dir=tmp_path / "d"),
            JConfig(cache_dir=tmp_path / f"j-{name}", data_dir=tmp_path / "d"))


def _no_timings(rec: dict) -> dict:
    """A manifest record without its wall-clock fields (and the device
    summary, whose mesh differs: one CPU device against eight)."""
    rec = {k: v for k, v in rec.items() if k not in ("secs", "tpu_sink")}
    rec["files"] = [{k: v for k, v in f.items() if k != "secs"}
                    for f in rec["files"]]
    return rec


@pytest.fixture(scope="module")
def pulled(hub, tmp_path_factory):
    """Both packages' pulls into their own stores: (port report and
    placement, reference report and placement, the two configs)."""
    tmp = tmp_path_factory.mktemp("pull")
    tcfg, jcfg = _configs(tmp, "pull")
    mp = pytest.MonkeyPatch()
    mp.setenv("DEMODEL_FETCH_WORKERS", "2")
    try:
        trep, tplaced = tdelivery.pull_to_hbm(
            MODEL, tcfg, endpoint=hub, mesh=make_mesh(device="cpu"))
        jrep, jplaced = jdelivery.pull_to_hbm(MODEL, jcfg, endpoint=hub)
    finally:
        mp.undo()
    return trep, tplaced, jrep, jplaced, tcfg, jcfg


def _open(cfg):
    return (TStore if isinstance(cfg, TConfig) else JStore)(
        cfg.cache_dir / "proxy")


def test_pulls_land_the_same_keys_bytes_and_manifest(pulled):
    trep, _, jrep, _, tcfg, jcfg = pulled
    assert _no_timings(trep) == _no_timings(jrep)
    assert trep["tpu_sink"]["tensors"] == jrep["tpu_sink"]["tensors"] == 21
    mkey = tdelivery.manifest_key("hf", MODEL)
    assert mkey == jdelivery.manifest_key("hf", MODEL)
    ts, js = _open(tcfg), _open(jcfg)
    try:
        assert sorted(ts.list()) == sorted(js.list())
        assert len(ts.list()) == 5
        for key in set(ts.list()) - {mkey}:
            assert ts.get(key) == js.get(key), key
            assert ts.meta(key) == js.meta(key), key
        trec, jrec = (json.loads(s.get(mkey)) for s in (ts, js))
        assert _no_timings(trec) == _no_timings(jrec)
        # the record's own digest differs with its timings
        tmeta, jmeta = (s.meta(mkey) for s in (ts, js))
        assert tmeta.pop("sha256") and jmeta.pop("sha256")
        assert tmeta == jmeta == {"kind": "model-manifest", "model": MODEL,
                                  "source": "hf"}
    finally:
        ts.close()
        js.close()


def test_placements_are_byte_identical(pulled):
    _, tplaced, _, jplaced, _, _ = pulled
    assert sorted(tplaced.arrays) == sorted(jplaced.arrays)
    for name, t in tplaced.arrays.items():
        want = np.asarray(jplaced.arrays[name])
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), want), name


def test_model_from_pull_logits_match(pulled):
    trep, tplaced, jrep, jplaced, tcfg, jcfg = pulled
    ts, js = _open(tcfg), _open(jcfg)
    try:
        tfn, tparams, tmcfg = tauto.model_from_pull(ts, trep,
                                                    placement=tplaced)
        jfn, jparams, _ = jauto.model_from_pull(js, jrep, placement=jplaced)
    finally:
        ts.close()
        js.close()
    assert tmcfg.dtype == "float32" and tmcfg.num_key_value_heads == 2
    toks = np.random.default_rng(3).integers(0, 256, (2, 9))
    want = np.asarray(jfn(jparams, jnp.asarray(toks, jnp.int32)))
    got = tfn(tparams, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)


def _post(url: str, doc: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_load_model_serves_the_reference_tokens(hub, tmp_path):
    """A cold ``load_model`` in each package; the port's engine answers
    ``/generate`` with the reference engine's greedy tokens, exactly."""
    tcfg, jcfg = _configs(tmp_path, "serve")
    prompts = [np.random.default_rng(i).integers(0, 256, n).tolist()
               for i, n in enumerate((5, 11))]
    engine = server = None
    try:
        engine = tserve.load_model(MODEL, tcfg, endpoint=hub, device="cpu",
                                   max_new_tokens=6, kv_mb=4)
        assert engine.params["embed"].device.type == "cpu"
        server = thttp.start()
        got = [_post(f"{server.url}/generate",
                     {"prompt": p, "max_new_tokens": 6})["tokens"]
               for p in prompts]
    finally:
        if server is not None:
            server.stop()
        if engine is not None:
            engine.stop()
        tserve.install(None)
    jengine = jserve.load_model(MODEL, jcfg, endpoint=hub, max_new_tokens=6,
                                kv_mb=4)
    try:
        want = [jengine.submit(p, 6).result(timeout=120) for p in prompts]
    finally:
        jengine.stop()
        jserve.install(None)
    assert got == want


def test_load_model_records_the_manifest(hub, tmp_path):
    tcfg, _ = _configs(tmp_path, "manifest")
    engine = tserve.load_model(MODEL, tcfg, endpoint=hub, device="cpu",
                               max_new_tokens=2, kv_mb=1)
    engine.stop()
    tserve.install(None)
    store = tdelivery.open_store(tcfg)
    try:
        rec = json.loads(store.get(tdelivery.manifest_key("hf", MODEL)))
    finally:
        store.close()
    assert rec["source"] == "hf" and rec["name"] == MODEL
    assert sorted(f["name"] for f in rec["files"]) == sorted(_llama_files())


def test_profile_dir_writes_a_torch_profiler_trace(hub, tmp_path,
                                                   monkeypatch):
    """``DEMODEL_PROFILE_DIR`` opens a ``torch.profiler`` window around the
    delivery and writes it as a Chrome trace there."""
    monkeypatch.setenv("DEMODEL_PROFILE_DIR", str(tmp_path / "prof"))
    tcfg, _ = _configs(tmp_path, "prof")
    _, placed = tdelivery.pull_to_hbm(MODEL, tcfg, endpoint=hub,
                                      mesh=make_mesh(device="cpu"))
    assert len(placed.arrays) == 21
    (trace,) = (tmp_path / "prof").glob("delivery-*.json")
    assert "traceEvents" in json.loads(trace.read_text())


# ---------------------------------------------------------- failure paths


def _pull_files(tmp_path, files: dict):
    """Pull ``files`` through the port without delivery; (store, report)."""
    with FakeUpstream(handler=make_hf_handler({"org/bad": files})) as up:
        tcfg, _ = _configs(tmp_path, "bad")
        store = tdelivery.open_store(tcfg)
        report, _ = tdelivery.pull_to_hbm(
            "org/bad", tcfg, endpoint=f"http://{up.authority}", store=store,
            deliver=False)
    return store, report


@pytest.mark.parametrize("field,value", [
    ("rope_scaling", {"type": "linear", "factor": 2.0}),
    ("sliding_window", 4096), ("attention_bias", True)])
def test_model_from_pull_refuses_unsupported_fields(tmp_path, field, value):
    store, report = _pull_files(tmp_path, _llama_files(config={field: value}))
    try:
        with pytest.raises(ValueError, match=field):
            tauto.model_from_pull(store, report,
                                  mesh=make_mesh(device="cpu"))
    finally:
        store.close()


def _family_files(model_type: str) -> dict:
    """The repo pulled for ``model_type``: GPT-2 and BERT as their own
    seeded HF checkpoints, anything else the Llama files under that
    ``model_type``."""
    if model_type == "gpt2":
        return repo_files(GPT2_CONFIG, gpt2_state())
    if model_type == "bert":
        return repo_files(BERT_CONFIG, bert_state())
    return _llama_files(config={"model_type": model_type})


@pytest.mark.parametrize("model_type,built", [
    ("mamba", None), ("gpt2", tgpt2.GPT2Config), ("bert", tbert.BertConfig)])
def test_model_from_pull_refuses_other_families(tmp_path, model_type, built):
    """An unknown family is refused; GPT-2 and BERT (ported since ROADMAP
    A8) build from their pulled files and run on the placement's
    device."""
    store, report = _pull_files(tmp_path, _family_files(model_type))
    try:
        if built is None:
            with pytest.raises(ValueError, match="model_type"):
                tauto.model_from_pull(store, report,
                                      mesh=make_mesh(device="cpu"))
            return
        fn, params, cfg = tauto.model_from_pull(
            store, report, mesh=make_mesh(device="cpu"))
    finally:
        store.close()
    assert isinstance(cfg, built) and cfg.dtype == "float32"
    out = fn(params, torch.arange(10).reshape(2, 5))
    assert out.shape[:2] == (2, 5) and out.device.type == "cpu"
    assert torch.isfinite(out).all()


# ------------------------------------------------------------ the fetcher


class _Origin(BaseHTTPRequestHandler):
    """A plain Range-capable origin for one blob. ``cut`` GETs from offset
    0 answer half the body and close; every GET is logged with its
    Range header."""

    protocol_version = "HTTP/1.1"
    body = b""
    cut = 0
    status_first: int | None = None
    gets: list = []
    lock = threading.Lock()

    def log_message(self, *a):
        pass

    def do_HEAD(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.body)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        rng = self.headers.get("Range", "")
        with self.lock:
            self.gets.append(rng)
            first = len(self.gets) == 1
            cut = type(self).cut > 0 and not rng
            if cut:
                type(self).cut -= 1
        if first and self.status_first:
            self.send_response(self.status_first)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        start, end = 0, len(self.body) - 1
        if rng.startswith("bytes="):
            a, _, b = rng[6:].partition("-")
            start, end = int(a), int(b) if b else end
            self.send_response(206)
            self.send_header("Content-Range",
                             f"bytes {start}-{end}/{len(self.body)}")
        else:
            self.send_response(200)
        part = self.body[start:end + 1]
        self.send_header("Content-Length", str(len(part)))
        self.send_header("ETag", '"e0"')
        self.end_headers()
        if cut:
            self.wfile.write(part[:len(part) // 2])
            self.wfile.flush()
            self.close_connection = True
            return
        self.wfile.write(part)


@pytest.fixture()
def origin():
    """(handler class, base URL): a fresh origin per test."""
    handler = type("Origin", (_Origin,), {
        "body": np.random.default_rng(5).bytes(3 << 20), "gets": [],
        "cut": 0, "status_first": None})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield handler, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def _fetchers(tmp_path):
    """The port's and the reference's Fetcher, each on its own store, with
    the native parallel path off and no real sleeps."""
    ts, js = TStore(tmp_path / "t"), JStore(tmp_path / "j")
    tf, jf = tbase.Fetcher(ts), jbase.Fetcher(js)
    sleeps: dict[str, list] = {"port": [], "reference": []}
    tf._policy.sleep = sleeps["port"].append
    jf._policy.sleep = sleeps["reference"].append
    return (tf, jf), (ts, js), sleeps


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_cut_body_resumes_with_one_retry(tmp_path, origin, monkeypatch, pkg):
    monkeypatch.setenv("DEMODEL_UPSTREAM_STREAMS", "1")
    handler, base = origin
    handler.cut = 1
    (tf, jf), stores, sleeps = _fetchers(tmp_path)
    f = tf if pkg == "port" else jf
    sha = hashlib.sha256(handler.body).hexdigest()
    try:
        art = f.fetch(f"{base}/blob", "blob", expected_digest=sha)
        store = stores[0] if pkg == "port" else stores[1]
        assert store.get(art.key) == handler.body
    finally:
        tf.close()
        for s in stores:
            s.close()
    assert len(sleeps[pkg]) == 1
    assert handler.gets[0] == "" and handler.gets[1].startswith("bytes=")
    assert art.resumed_from == int(handler.gets[1][6:-1]) > 0
    assert art.sha256 == sha and art.size == len(handler.body)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_wrong_digest_raises_without_retrying(tmp_path, origin, monkeypatch,
                                              pkg):
    monkeypatch.setenv("DEMODEL_UPSTREAM_STREAMS", "1")
    handler, base = origin
    (tf, jf), stores, sleeps = _fetchers(tmp_path)
    f = tf if pkg == "port" else jf
    try:
        with pytest.raises(IOError, match="digest mismatch") as ei:
            f.fetch(f"{base}/blob", "blob", expected_digest="0" * 64)
        store = stores[0] if pkg == "port" else stores[1]
        assert not store.has(tbase.key_for_uri(f"{base}/blob"))
        assert store.partial_size(tbase.key_for_uri(f"{base}/blob")) <= 0
    finally:
        tf.close()
        for s in stores:
            s.close()
    if pkg == "port":
        assert isinstance(ei.value, faults.DigestMismatch)
    assert handler.gets == [""] and sleeps[pkg] == []


def test_server_error_retries_then_lands(tmp_path, origin, monkeypatch):
    monkeypatch.setenv("DEMODEL_UPSTREAM_STREAMS", "1")
    handler, base = origin
    handler.status_first = 503
    (tf, _), stores, sleeps = _fetchers(tmp_path)
    try:
        art = tf.fetch(f"{base}/blob", "blob")
        assert stores[0].get(art.key) == handler.body
    finally:
        tf.close()
        for s in stores:
            s.close()
    assert len(sleeps["port"]) == 1 and handler.gets == ["", ""]


def test_native_parallel_fetch_lands_what_the_reference_lands(
        tmp_path, origin, monkeypatch):
    """A file past ``DEMODEL_UPSTREAM_PARALLEL_MIN_MB`` with a known size
    goes through the native Range fetch in both packages: the same bytes
    and the same meta record, and no single-stream GET."""
    monkeypatch.setenv("DEMODEL_UPSTREAM_PARALLEL_MIN_MB", "1")
    handler, base = origin
    (tf, jf), (ts, js), _ = _fetchers(tmp_path)
    sha = hashlib.sha256(handler.body).hexdigest()
    try:
        arts = [f.fetch(f"{base}/blob", "blob", expected_digest=sha)
                for f in (tf, jf)]
        assert ts.get(arts[0].key) == js.get(arts[1].key) == handler.body
        assert ts.meta(arts[0].key) == js.meta(arts[1].key)
    finally:
        tf.close()
        ts.close()
        js.close()
    assert arts[0].sha256 == arts[1].sha256 == sha
    assert all(g.startswith("bytes=") for g in handler.gets)


def test_retry_classification_matches_the_reference():
    import requests

    from demodel_tpu.utils import faults as jfaults

    def resp(status):
        r = requests.Response()
        r.status_code = status
        return r

    class Raw:
        def __init__(self, status):
            self.status = status
            self.headers = {}
            self.will_close = True

    pairs = [
        (faults.HTTPError(faults.Response(Raw(503), "GET", "u", None)),
         requests.HTTPError(response=resp(503))),
        (faults.HTTPError(faults.Response(Raw(429), "GET", "u", None)),
         requests.HTTPError(response=resp(429))),
        (faults.HTTPError(faults.Response(Raw(404), "GET", "u", None)),
         requests.HTTPError(response=resp(404))),
        (faults.TruncatedBody("short"), jfaults.TruncatedBody("short")),
        (faults.DigestMismatch("bad"), jfaults.DigestMismatch("bad")),
        (ConnectionResetError(), requests.ConnectionError()),
        (TimeoutError(), requests.Timeout()),
        (json.JSONDecodeError("x", "", 0), ValueError("junk")),
        (OSError(28, "No space left"), OSError(28, "No space left")),
    ]
    for port_exc, ref_exc in pairs:
        assert faults.retryable(port_exc) == jfaults.retryable(ref_exc), \
            port_exc


def test_retry_policy_backoff_and_caps():
    calls, sleeps = [], []
    pol = faults.RetryPolicy(max_attempts=3, deadline=60, base_delay=0.1,
                             sleep=sleeps.append)

    def flaky():
        calls.append(1)
        raise faults.TruncatedBody("short")

    with pytest.raises(faults.TruncatedBody):
        pol.call(flaky)
    assert len(calls) == 3 and len(sleeps) == 2
    assert 0 <= sleeps[0] <= 0.1 and 0 <= sleeps[1] <= 0.2
    calls.clear()

    def poisoned():
        calls.append(1)
        raise faults.DigestMismatch("bad")

    with pytest.raises(faults.DigestMismatch):
        pol.call(poisoned)
    assert len(calls) == 1


# ------------------------------------------------------- streaming sink


def test_byte_budget_blocks_until_release_and_admits_oversize_alone():
    budget = streaming.ByteBudget(100)
    budget.acquire(60)
    done = threading.Event()

    def second():
        budget.acquire(60)
        done.set()

    t = threading.Thread(target=second)
    t.start()
    assert not done.wait(0.2) and budget.waiters == 1
    budget.release(60)
    assert done.wait(10)
    t.join(timeout=10)
    assert not t.is_alive() and budget.in_use == 60
    budget.release(60)
    budget.acquire(500)  # larger than the budget: admitted alone
    assert budget.high_water == 500


def test_sink_delivers_buffered_artifacts_without_the_store():
    tensors = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
               "b": np.ones(4, np.float32)}
    buf = np.frombuffer(tst.serialize(tensors), np.uint8).copy()
    sink = streaming.StreamingSink(None, mesh=make_mesh(device="cpu"),
                                   max_buffered_bytes=1 << 20)
    sink.submit(tbase.FileArtifact(name="m.safetensors", uri="u", key="k",
                                   size=buf.nbytes, sha256="", buffer=buf))
    sink.submit(tbase.FileArtifact(name="config.json", uri="c", key="c",
                                   size=2, sha256=""))
    placed = sink.finish()
    assert sorted(placed.arrays) == ["b", "w"]
    for name, want in tensors.items():
        assert np.array_equal(placed.arrays[name].numpy(), want)
    assert sink.budget.in_use == 0 and sink.budget.high_water == buf.nbytes
