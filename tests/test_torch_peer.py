"""Port parity: the peer plane of ``demodel_tpu_torch`` (consistent-hash
placement, breakers, ``PeerSet``, the Fetcher's peer legs, the peers
branch of ``pull_to_hbm`` and the peer-serving ``ProxyServer``) against
``demodel_tpu`` on the CPU.

A peer is a node whose proxy serves its store on ``/peer/*``. Here the
port's ``ProxyServer`` (native library built by the port) and the
reference's serve stores filled by a pull from one fake HuggingFace Hub
(``tests/fake_registries.make_hf_handler``) holding a seeded F32 Llama in
two shards. Held: the ring and the breaker against the reference's; the
port's ``PeerSet`` reads both packages' proxies to the same bytes; a cold
pull with peers takes every file from the peer and no CDN byte (into the
store and onto the device sink, placements equal to the reference's; by
content digest under another key); corrupt peer bytes are refused and
healed from upstream; junk indexes degrade to nothing; a dead peer's
breaker opens and the pull completes upstream; ``defer_cache_commit``
finalizes with the manifest in the store.
"""

from __future__ import annotations

import hashlib
import json
import socket

import numpy as np
import pytest
import torch

from demodel_tpu import delivery as jdelivery
from demodel_tpu.config import ProxyConfig as JConfig
from demodel_tpu.parallel import peer as jpeer
from demodel_tpu.parallel import placement as jplacement
from demodel_tpu.proxy import ProxyServer as JProxy
from demodel_tpu.utils import faults as jfaults
from demodel_tpu_torch import delivery as tdelivery
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.parallel import make_mesh
from demodel_tpu_torch.parallel import peer as tpeer
from demodel_tpu_torch.parallel import placement as tplacement
from demodel_tpu_torch.proxy import ProxyServer as TProxy
from demodel_tpu_torch.registry.hf import HFRegistry
from demodel_tpu_torch.store import Store as TStore
from demodel_tpu_torch.store import key_for_uri
from demodel_tpu_torch.utils import faults as tfaults
from demodel_tpu_torch.utils.metrics import HUB

from .fake_registries import build_hf_repo, make_hf_handler
from .servers import FakeUpstream
from .test_peer_degrade import _ConfigurableHandler
from .test_torch_pull import MODEL, _llama_files

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Two fetch workers, fast retries, and fresh breakers and gossip per
    test in both packages (their refresher threads stopped after)."""
    monkeypatch.setenv("DEMODEL_FETCH_WORKERS", "2")
    monkeypatch.setenv("DEMODEL_RETRY_BASE_MS", "1")
    monkeypatch.delenv("DEMODEL_PEERS", raising=False)
    monkeypatch.delenv("DEMODEL_PROFILE_DIR", raising=False)
    for mod in (tfaults, jfaults):
        mod.PeerHealth.reset_shared()
    yield
    for mod in (tpeer, jpeer):
        mod.PeerGossip.reset_shared()
    for mod in (tfaults, jfaults):
        mod.PeerHealth.reset_shared()


@pytest.fixture(scope="module")
def hub():
    handler = make_hf_handler({MODEL: _llama_files()})
    with FakeUpstream(handler=handler) as up:
        yield f"http://{up.authority}", handler


def _tcfg(path) -> TConfig:
    return TConfig(host="127.0.0.1", port=0, no_mitm=True, cache_dir=path,
                   data_dir=path.parent / "data")


def _jcfg(path) -> JConfig:
    return JConfig(host="127.0.0.1", port=0, no_mitm=True, cache_dir=path,
                   data_dir=path.parent / "data")


@pytest.fixture(scope="module")
def peer_cache(hub, tmp_path_factory):
    """A store filled by a pull from the hub (no device), as a peer
    node's proxy would hold it."""
    url, _ = hub
    path = tmp_path_factory.mktemp("peer") / "cache"
    mp = pytest.MonkeyPatch()
    mp.setenv("DEMODEL_FETCH_WORKERS", "2")
    try:
        tdelivery.pull(MODEL, _tcfg(path), endpoint=url)
    finally:
        mp.undo()
    return path


@pytest.fixture(scope="module")
def peer(peer_cache):
    """The port's peer-serving proxy over ``peer_cache``."""
    with TProxy(_tcfg(peer_cache), session_threads=4) as proxy:
        yield proxy


def _upstream_bytes(handler) -> int:
    """GETs that move file bytes from the hub: resolve bodies and CDN."""
    return sum(n for k, n in handler.request_counts.items()
               if k == "cdn" or k.startswith("resolve:"))


def _dead_url() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}"


# ----------------------------------------------------------- placement


@pytest.mark.parametrize("n_nodes", [1, 5])
def test_ring_matches_reference(n_nodes):
    rng = np.random.default_rng(n_nodes)
    nodes = [f"http://10.0.0.{i}:8080" for i in range(n_nodes)]
    keys = [f"{k:016x}" for k in rng.integers(0, 2 ** 63, 64)]
    tring = tplacement.HashRing(nodes, vnodes=64)
    jring = jplacement.HashRing(nodes, vnodes=64)
    for k in keys:
        assert tring.owner(k) == jring.owner(k)
        assert tring.owners(k, 3) == jring.owners(k, 3)
    assert tplacement.HashRing([]).owner("x") is None


# ---------------------------------------------------------- the proxy


def test_mitm_proxy_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TProxy(TConfig(no_mitm=False))


@pytest.mark.parametrize("server", ["port", "reference"])
def test_peerset_reads_either_proxy(peer_cache, tmp_path, server):
    """The port's ``PeerSet`` against the port's and the reference's
    proxy over the same store: the same index, and every object copied
    byte for byte into a fresh store (native parallel fetch)."""
    make = (lambda: TProxy(_tcfg(peer_cache), session_threads=2)) \
        if server == "port" else \
        (lambda: JProxy(_jcfg(peer_cache), verbose=False, session_threads=2))
    src = TStore(peer_cache / "proxy")
    dst = TStore(tmp_path / "dst")
    try:
        with make() as proxy:
            ps = tpeer.PeerSet([proxy.url], timeout=10)
            try:
                index = ps.index(proxy.url)
                assert set(index) == set(src.list())
                for key in src.list():
                    body = src.get(key)
                    assert index[key] == hashlib.sha256(body).hexdigest()
                    assert ps.fetch_into(dst, key, expected_digest=index[key])
                    assert dst.get(key) == body
                assert ps.locate("0" * 16) is None
            finally:
                ps.close()
    finally:
        src.close()
        dst.close()


# ------------------------------------------------------------- pulls


def test_peer_pull_to_device_matches_reference(hub, peer, tmp_path):
    """``pull_to_hbm(peers=...)`` on a cold store in both packages (the
    port against its own proxy, the reference against a reference proxy
    over the same peer store): every file from the peer, none from the
    CDN, the same manifest record, byte-identical placements, and every
    file in the store."""
    url, handler = hub
    before = _upstream_bytes(handler)
    files_before = HUB.get("pull_files_from_peer_total")
    tcfg = _tcfg(tmp_path / "t")
    trep, tplaced = tdelivery.pull_to_hbm(
        MODEL, tcfg, endpoint=url, mesh=make_mesh(device="cpu"),
        peers=[peer.url])
    with JProxy(_jcfg(peer.cfg.cache_dir), verbose=False,
                session_threads=2) as jproxy:
        jrep, jplaced = jdelivery.pull_to_hbm(
            MODEL, _jcfg(tmp_path / "j"), endpoint=url, peers=[jproxy.url])
    assert _upstream_bytes(handler) == before
    assert all(f["from_peer"] for f in trep["files"])
    assert HUB.get("pull_files_from_peer_total") - files_before == \
        len(trep["files"])
    strip = ("secs", "from_peer", "from_cache")
    assert [{k: v for k, v in f.items() if k not in strip}
            for f in trep["files"]] == \
        [{k: v for k, v in f.items() if k not in strip}
         for f in jrep["files"]]
    assert sorted(tplaced.arrays) == sorted(jplaced.arrays)
    for name, t in tplaced.arrays.items():
        assert np.array_equal(t.numpy(), np.asarray(jplaced.arrays[name]))
    store = TStore(tcfg.cache_dir / "proxy")
    try:
        for f in trep["files"]:
            assert hashlib.sha256(store.get(f["key"])).hexdigest() == \
                f["sha256"]
        rec = json.loads(store.get(tdelivery.manifest_key("hf", MODEL)))
        assert [f["key"] for f in rec["files"]] == \
            [f["key"] for f in trep["files"]]
    finally:
        store.close()


def test_pull_into_store_from_peer(hub, peer, tmp_path):
    """Without a device sink the peer bytes go into the store (the
    native parallel fetch): every file from the peer, no CDN bytes."""
    url, handler = hub
    before = _upstream_bytes(handler)
    rep = tdelivery.pull(MODEL, _tcfg(tmp_path / "c"), endpoint=url,
                         peers=[peer.url])
    assert _upstream_bytes(handler) == before
    assert all(f["from_peer"] and not f["from_cache"] for f in rep["files"])


def test_dedup_by_digest_with_no_cdn_request(tmp_path):
    """A peer holding the same content under another key serves it by
    content address: zero CDN requests (as the reference's
    ``test_peer_dedup_by_digest``)."""
    repo = build_hf_repo(n_shards=1)
    body = repo["model.safetensors"]
    digest = hashlib.sha256(body).hexdigest()
    cache = tmp_path / "peer-cache"
    seed = TStore(cache / "proxy")
    seed.put("totallydifferent1", body, {"sha256": digest,
                                         "size": len(body)})
    seed.close()
    handler = make_hf_handler({"org/d": repo})
    with TProxy(_tcfg(cache), session_threads=2) as proxy, \
            FakeUpstream(handler=handler) as up:
        store = TStore(tmp_path / "cold")
        ps = tpeer.PeerSet([proxy.url])
        try:
            reg = HFRegistry(store, endpoint=f"http://{up.authority}",
                             peers=ps)
            report = reg.pull("org/d")
            art = next(f for f in report.files
                       if f.name == "model.safetensors")
            assert art.from_peer
            assert store.get(art.key) == body
            assert handler.request_counts.get("cdn", 0) == 0
        finally:
            ps.close()
            store.close()


@pytest.mark.parametrize("sink", ["tpu", "cache"])
def test_corrupt_peer_bytes_are_rejected_and_healed_upstream(
        tmp_path, monkeypatch, sink):
    """A peer holding corrupt bytes under the shard's exact key: the
    sha256 check before delivery rejects them, the shard comes from the
    upstream, and the store (and the placement) holds the good bytes, in
    both packages (the reference under its inline check, the port's only
    one)."""
    monkeypatch.setenv("DEMODEL_PEER_VERIFY", "eager")
    repo = build_hf_repo(n_shards=1, rows=2048)
    good = repo["model.safetensors"]
    corrupt = bytearray(good)
    corrupt[10] ^= 0xFF
    handler = make_hf_handler({"org/heal": repo})
    with FakeUpstream(handler=handler) as up:
        url = f"http://{up.authority}"
        evil_cache = tmp_path / "evil"
        s = TStore(evil_cache / "proxy")
        try:
            s.put(key_for_uri(f"{url}/org/heal/resolve/{'c0ffee' * 6}c0ff/"
                              "model.safetensors"),
                  bytes(corrupt), {"size": len(corrupt)})
        finally:
            s.close()
        with TProxy(_tcfg(evil_cache), session_threads=2) as evil:
            tcfg, jcfg = _tcfg(tmp_path / "t"), _jcfg(tmp_path / "j")
            cdn = handler.request_counts.get("cdn", 0)
            if sink == "tpu":
                rep, placed = tdelivery.pull_to_hbm(
                    "org/heal", tcfg, endpoint=url,
                    mesh=make_mesh(device="cpu"), peers=[evil.url])
                _, jplaced = jdelivery.pull_to_hbm(
                    "org/heal", jcfg, endpoint=url, peers=[evil.url])
                assert sorted(placed.arrays) == sorted(jplaced.arrays)
                for name, t in placed.arrays.items():
                    assert np.array_equal(t.numpy(),
                                          np.asarray(jplaced.arrays[name]))
            else:
                rep = tdelivery.pull("org/heal", tcfg, endpoint=url,
                                     peers=[evil.url])
                jdelivery.pull("org/heal", jcfg, endpoint=url,
                               peers=[evil.url])
            # the shard's bytes came from the upstream's CDN
            assert handler.request_counts.get("cdn", 0) > cdn
    shard = next(f for f in rep["files"] if f["name"] == "model.safetensors")
    assert not shard["from_peer"]
    for path, cls in ((tcfg.cache_dir, TStore), (jcfg.cache_dir, TStore)):
        store = cls(path / "proxy")
        try:
            assert store.get(shard["key"]) == good
        finally:
            store.close()


# ------------------------------------------------------------- degrade


@pytest.fixture
def junk_peer():
    from http.server import ThreadingHTTPServer
    import threading

    handler = type("Handler", (_ConfigurableHandler,), {"routes": {}})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", handler
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("body, ctype", [
    (b"<html>hotel wifi login</html>", "text/html"),
    (b'"just a string"', "application/json"),
    (b"[1, 2, 3]", "application/json"),
    (b'{"keys": "not-a-list"}', "application/json"),
], ids=["html", "string", "list", "keys_not_a_list"])
def test_junk_index_degrades_to_empty(junk_peer, body, ctype):
    url, handler = junk_peer
    handler.routes["/peer/index"] = (200, ctype, body)
    ps = tpeer.PeerSet([url], timeout=5)
    jps = jpeer.PeerSet([url], timeout=5)
    try:
        assert ps.index(url) == jps.index(url) == {}
        assert ps.locate("deadbeefdeadbeef") is None
    finally:
        ps.close()


def test_malformed_index_entries_are_skipped(junk_peer):
    url, handler = junk_peer
    handler.routes["/peer/index"] = (200, "application/json", (
        b'{"keys": [17, {"nokey": true}, '
        b'{"key": "aaaabbbbccccdddd", "sha256": "ff00"}, '
        b'{"key": "eeeeffff00001111"}]}'))
    ps = tpeer.PeerSet([url], timeout=5)
    try:
        assert ps.index(url) == jpeer.PeerSet([url]).index(url) == {
            "aaaabbbbccccdddd": "ff00", "eeeeffff00001111": ""}
    finally:
        ps.close()


@pytest.mark.parametrize("meta", [b"[1, 2, 3]", b'{"size": "junk"}'],
                         ids=["not_an_object", "junk_size"])
def test_junk_meta_fails_over_not_crashes(junk_peer, tmp_path, meta):
    """The peer lists the key but serves junk meta: ``fetch_into`` is
    False (the caller goes upstream)."""
    url, handler = junk_peer
    key = "aaaabbbbccccdddd"
    handler.routes["/peer/index"] = (
        200, "application/json", ('{"keys": [{"key": "%s"}]}' % key).encode())
    handler.routes[f"/peer/meta/{key}"] = (200, "application/json", meta)
    store = TStore(tmp_path / "store")
    ps = tpeer.PeerSet([url], timeout=5)
    try:
        assert ps.fetch_into(store, key) is False
        assert not store.has(key)
    finally:
        ps.close()
        store.close()


def test_dead_peer_opens_its_breaker_and_the_pull_completes_upstream(
        hub, tmp_path):
    """A peer that refuses connections: its breaker opens within one
    pull, later lookups skip it, and every file comes from upstream."""
    url, handler = hub
    dead = _dead_url()
    before = _upstream_bytes(handler)
    rep, placed = tdelivery.pull_to_hbm(
        MODEL, _tcfg(tmp_path / "c"), endpoint=url,
        mesh=make_mesh(device="cpu"), peers=[dead])
    breaker = tfaults.PeerHealth.shared().breaker(dead)
    assert breaker.state() == tfaults.STATE_OPEN
    assert not tfaults.PeerHealth.shared().admissible(dead)
    assert not any(f["from_peer"] for f in rep["files"])
    assert len(placed.arrays) == 21
    # the hub served the same requests as for a pull without peers
    dead_pull = _upstream_bytes(handler) - before
    tdelivery.pull(MODEL, _tcfg(tmp_path / "plain"), endpoint=url)
    assert _upstream_bytes(handler) - before == 2 * dead_pull


@pytest.mark.parametrize("outcome", ["success", "failure"])
def test_breaker_opens_and_readmits_after_cooldown(outcome):
    """The port's breaker and the reference's over one sequence of
    outcomes: open after ``threshold`` failures, admissible again once the
    cooldown has passed, then closed by a success or re-armed by a
    failure."""
    now = [0.0]
    peer = "http://p:1"
    healths = [mod.PeerHealth(threshold=2, cooldown=10,
                              clock=lambda: now[0])
               for mod in (tfaults, jfaults)]

    def seen():
        got = [(h.admissible(peer), h.breaker(peer).state())
               for h in healths]
        assert got[0] == got[1]
        return got[0]

    def record(ok: bool):
        for h in healths:
            (h.record_success if ok else h.record_failure)(peer)

    record(False)
    assert seen() == (True, tfaults.STATE_CLOSED)
    record(False)
    assert seen() == (False, tfaults.STATE_OPEN)
    now[0] = 11.0
    assert seen() == (True, tfaults.STATE_OPEN)
    record(outcome == "success")
    if outcome == "success":
        assert seen() == (True, tfaults.STATE_CLOSED)
    else:
        assert seen() == (False, tfaults.STATE_OPEN)
        now[0] = 22.0
        assert seen() == (True, tfaults.STATE_OPEN)


# ------------------------------------------------------ deferred commit


def test_defer_cache_commit_finalizes_with_the_manifest(hub, peer,
                                                        tmp_path):
    """``defer_cache_commit=True``: the call returns with the placement,
    ``finalize()`` joins the background manifest write, and then the
    store holds every file and the manifest record."""
    url, _ = hub
    cfg = _tcfg(tmp_path / "d")
    rep, placed = tdelivery.pull_to_hbm(
        MODEL, cfg, endpoint=url, mesh=make_mesh(device="cpu"),
        peers=[peer.url], defer_cache_commit=True)
    assert placed.finalizer is not None
    placed.finalize(timeout=60)
    assert placed.finalize_error is None
    store = TStore(cfg.cache_dir / "proxy")
    try:
        rec = json.loads(store.get(tdelivery.manifest_key("hf", MODEL)))
        assert [f["key"] for f in rec["files"]] == \
            [f["key"] for f in rep["files"]]
        assert all(store.has(f["key"]) for f in rep["files"])
    finally:
        store.close()
    with pytest.raises(ValueError, match="own the store"):
        with TStore(tmp_path / "x") as s:
            tdelivery.pull_to_hbm(MODEL, cfg, store=s,
                                  defer_cache_commit=True)
