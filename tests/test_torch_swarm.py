"""Port parity: the chunk swarm of ``demodel_tpu_torch`` (the ring and
chunk grid of ``parallel/placement``, ``ChunkBoard``, ``SwarmScheduler``
and ``SwarmBlobReader`` of ``sink/remote``, and the swarm routes of
``restore/server``) against ``demodel_tpu`` on the CPU.

The placement primitives must agree bit for bit with the reference: a
port host and a JAX host in one swarm compute the same owners. The
integration tests run real swarms in one process: N schedulers, each
serving its chunk board over its own ``RestoreServer``, pulling one
manifest off a live warm ``ProxyServer`` — and one swarm mixes a JAX
host (the reference's scheduler and server) with a port host.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from demodel_tpu.parallel import peer as jpeer
from demodel_tpu.parallel import placement as jplacement
from demodel_tpu.sink import remote as jremote
from demodel_tpu.utils import faults as jfaults
from demodel_tpu.utils import metrics as jmetrics
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.parallel import make_mesh
from demodel_tpu_torch.parallel import peer as tpeer
from demodel_tpu_torch.parallel import placement as tplacement
from demodel_tpu_torch.proxy import ProxyServer as TProxy
from demodel_tpu_torch.restore.server import RestoreRegistry as TRegistry
from demodel_tpu_torch.restore.server import RestoreServer as TRestore
from demodel_tpu_torch.sink import remote as tremote
from demodel_tpu_torch.store import Store as TStore
from demodel_tpu_torch.utils import faults as tfaults
from demodel_tpu_torch.utils import metrics as tmetrics

from .test_fault_injection import MODEL as CHAOS_MODEL
from .test_fault_injection import _seed_store
from .torch_refnative import reference_native_lib  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    monkeypatch.setenv("DEMODEL_SWARM_CHUNK_MB", "1")
    monkeypatch.setenv("DEMODEL_SWARM_GOSSIP_MS", "150")
    monkeypatch.setenv("DEMODEL_SWARM_FILL_TIMEOUT", "4")
    monkeypatch.setenv("DEMODEL_PROXY_IDLE_TIMEOUT", "1")
    monkeypatch.setenv("DEMODEL_FETCH_WORKERS", "2")

    def reset():
        for mod in (tfaults, jfaults):
            mod.PeerHealth.reset_shared()
        for mod in (tpeer, jpeer):
            mod.PeerGossip.reset_shared()

    reset()
    for mod in (tmetrics, jmetrics):
        mod.HUB.reset()
    yield
    reset()


# ------------------------------------------------------- placement parity


@pytest.mark.parametrize("n_hosts,n_items", [(1, 5), (3, 24), (4, 97),
                                             (7, 300)])
def test_bounded_assign_matches_reference(n_hosts, n_items):
    rng = np.random.default_rng(n_hosts * 1000 + n_items)
    hosts = [f"h{rng.integers(1 << 30):x}" for _ in range(n_hosts)]
    items = [f"{rng.integers(1 << 62):016x}:{i}" for i in range(n_items)]
    got = tplacement.bounded_assign(tplacement.HashRing(hosts), items)
    want = jplacement.bounded_assign(jplacement.HashRing(hosts), items)
    assert got == want and set(got) == set(items)
    loads: dict = {}
    for h in got.values():
        loads[h] = loads.get(h, 0) + 1
    assert max(loads.values()) <= -(-n_items // n_hosts)
    assert [tplacement.spread_key(i) for i in items] == \
        [jplacement.spread_key(i) for i in items]
    assert tplacement.bounded_assign(tplacement.HashRing([]), items) == {}


@pytest.mark.parametrize("size,chunk", [(1, 1 << 20), (5 << 20, 1 << 20),
                                        ((5 << 20) + 123, 1 << 20),
                                        (0, 8 << 20), (3_211_352, 1 << 20)])
def test_chunk_grid_matches_reference(size, chunk):
    n = tplacement.chunk_count(size, chunk)
    assert n == jplacement.chunk_count(size, chunk)
    spans = [tplacement.chunk_span(size, chunk, i) for i in range(n)]
    assert spans == [jplacement.chunk_span(size, chunk, i) for i in range(n)]
    if size:
        assert sum(ln for _, ln in spans) == size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitmaps_and_board_summary_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    have = {int(i) for i in rng.integers(0, n, int(rng.integers(0, n + 1)))}
    hexs = tplacement._bitmap_hex(have, n)
    assert hexs == jplacement._bitmap_hex(have, n)
    assert tplacement.bitmap_indices(hexs, n) == \
        jplacement.bitmap_indices(hexs, n) == have
    assert tplacement.bitmap_indices("zz", n) == set()
    boards = [mod.ChunkBoard("pull-x", "host-a")
              for mod in (tplacement, jplacement)]
    for b in boards:
        b.add_file("fk", n)
        b.add_file("gk", 3)
        for i in sorted(have):
            b.put("fk", i, bytes([i % 256]) * 10)
        b.put("gk", 2, b"g")
        if have:
            b.reap("fk", min(have))
    assert boards[0].summary() == boards[1].summary()
    assert boards[0].stats() == boards[1].stats()
    for b in boards:
        b.clear()


def test_board_reap_unreap_and_stats():
    board = tplacement.ChunkBoard("p", "h")
    board.add_file("fk", 3)
    board.put("fk", 0, b"a" * 10)
    board.put("fk", 1, b"b" * 10)
    assert board.reap("fk", 0) == 10
    assert board.reap("fk", 2) == 0
    assert board.get("fk", 0) is None
    assert board.done("fk", 0) and board.reaped("fk", 0)
    st = board.stats()
    assert (st["chunks_have"], st["chunks_reaped"], st["bytes_reaped"],
            st["bytes_held"]) == (2, 1, 10, 10)
    assert tplacement.bitmap_indices(
        board.summary()["files"]["fk"]["have"], 3) == {1}
    board.put("fk", 0, b"c" * 10)
    assert not board.reaped("fk", 0)
    board.unreap("fk", 1)
    with pytest.raises(KeyError):
        board.put("nope", 0, b"x")
    board.clear()


# ------------------------------------------------------- gossip merges


def _sched(pull="p", me="a", others=("b",)):
    parts = {me: "http://127.0.0.1:9", **{o: "http://127.0.0.1:9"
                                          for o in others}}
    s = tremote.SwarmScheduler(pull, me, parts)
    s.add_file("fk", 3 << 20, object())
    return s


def test_scheduler_merge_rejects_stale_and_junk():
    s = _sched()
    try:
        s.merge_summary("b", {"pull": "p", "host": "b", "v": 5,
                              "files": {"fk": {"n": 3, "have": "03"}}})
        assert s._advertisers("fk", 0) == ["b"]
        s.merge_summary("b", {"v": 2, "files": {"fk": {"n": 3,
                                                       "have": "04"}}})
        assert s._advertisers("fk", 1) == ["b"]
        assert s._advertisers("fk", 2) == []
        for junk in ("not a dict", {"v": "NaN?", "files": 7}):
            s.merge_summary("b", junk)
        assert s._advertisers("fk", 1) == ["b"]
    finally:
        s.close()


def test_restarted_sibling_resurrects_despite_lower_version():
    s = _sched()
    try:
        s.merge_summary("b", {"v": 50, "files": {"fk": {"n": 3,
                                                        "have": "03"}}})
        for _ in range(3):
            s._poll_failed("b")
        assert "b" in s._snapshot_dead()
        s.merge_summary("b", {"v": 1, "files": {"fk": {"n": 3,
                                                       "have": "04"}}})
        assert "b" not in s._snapshot_dead()
        assert s._advertisers("fk", 2) == ["b"]
    finally:
        s.close()


def test_reap_gates_on_gossiped_done_set_not_have_set():
    bm = tplacement._bitmap_hex
    s = tremote.SwarmScheduler("tdone", "me", {"me": "http://127.0.0.1:9",
                                               "sib": "http://127.0.0.1:9"})
    try:
        s.board.add_file("fk", 2)
        with s._lock:
            s._files["fk"] = (2 << 20, 2, None)
            s._consumed_upto["fk"] = 2 << 20
        s.board.put("fk", 0, b"a" * (1 << 20))
        s.board.put("fk", 1, b"b" * (1 << 20))
        s.merge_summary("sib", {"v": 5, "files": {"fk": {
            "n": 2, "have": bm(set(), 2), "done": bm({0, 1}, 2)}}})
        assert sorted(s._reap_candidates()) == [("fk", 0), ("fk", 1)]
        with s._lock:
            s._active_reads["fk"] = [0]
        assert s._reap_candidates() == []
        with s._lock:
            s._active_reads["fk"] = [1 << 20]
        assert s._reap_candidates() == [("fk", 0)]
        with s._lock:
            s._active_reads["fk"] = []
        s.merge_summary("sib", {"v": 6, "files": {"fk": {
            "n": 2, "have": bm(set(), 2), "done": bm(set(), 2)}}})
        assert s._reap_candidates() == []
        s.merge_summary("sib", {"v": 7, "files": {"fk": {
            "n": 2, "have": bm({0, 1}, 2)}}})
        assert sorted(s._reap_candidates()) == [("fk", 0), ("fk", 1)]
    finally:
        s.close()


# ------------------------------------------------------ swarm integration


def _seed_origin(tmp_path, n_files=2, mb=3, tag="sw"):
    """A port ``ProxyServer`` over a store of ``n_files`` random blobs."""
    cfg = TConfig(host="127.0.0.1", port=0, no_mitm=True,
                  cache_dir=tmp_path / f"{tag}-origin-cache",
                  data_dir=tmp_path / f"{tag}-origin-data")
    rng = np.random.default_rng(7)
    files = []
    with TStore(cfg.cache_dir / "proxy") as store:
        for i in range(n_files):
            body = rng.bytes(mb << 20)
            key = f"{tag}key{i}"
            store.put(key, body, {"content-type": "application/octet-stream"})
            files.append({"key": key, "size": len(body),
                          "sha256": hashlib.sha256(body).hexdigest()})
    return TProxy(cfg, session_threads=4).start(), files


def _board_server(root) -> TRestore:
    """A swarm host's serve surface: a ``RestoreServer`` over an empty
    registry (its store is closed by :func:`_close`)."""
    return TRestore(TRegistry(TStore(root)), host="127.0.0.1").start()


def _servers(tmp_path, host_ids):
    servers = {h: _board_server(tmp_path / f"board-{h}") for h in host_ids}
    return servers, {h: f"http://127.0.0.1:{s.port}"
                     for h, s in servers.items()}


def _close(scheds, servers):
    for s in scheds:
        s.close()
    for srv in servers:
        srv.stop()
        srv.registry.store.close()


def _read_all(s, files) -> dict:
    out = {}
    for f in files:
        buf = bytearray(f["size"])
        s.read_into(f["key"], memoryview(buf), 0)
        out[f["key"]] = hashlib.sha256(buf).hexdigest()
    return out


def _run_all(scheds, files) -> dict:
    digests: dict = {}
    errors: list = []

    def run(s):
        try:
            s.fetch_all()
            digests[s.self_id] = _read_all(s, files)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    ths = [threading.Thread(target=run, args=(s,)) for s in scheds]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    assert errors == [] and len(digests) == len(scheds)
    return digests


def test_three_host_swarm_disjoint_origin_and_exact_bytes(tmp_path):
    """3 hosts: every chunk crosses origin exactly once, the other two
    copies travel peer to peer, every host ends bytes-exact, and the
    serve surface counts what it served."""
    origin, files = _seed_origin(tmp_path)
    servers, parts = _servers(tmp_path, ("hA", "hB", "hC"))
    scheds = []
    try:
        for hid in parts:
            s = tremote.SwarmScheduler("t3", hid, parts)
            for f in files:
                s.add_file(f["key"], f["size"], tremote.PeerBlobReader(
                    origin.url, f["key"], f["size"]))
            scheds.append(s)
        for s in scheds:
            s.start()
        owned = [set(s._owned) for s in scheds]
        total = sum(tplacement.chunk_count(f["size"], 1 << 20)
                    for f in files)
        assert sum(len(o) for o in owned) == total == len(set().union(*owned))
        digests = _run_all(scheds, files)
        for d in digests.values():
            assert d == {f["key"]: f["sha256"] for f in files}
        size = sum(f["size"] for f in files)
        hub = tmetrics.HUB
        assert hub.get("swarm_origin_bytes_total") == size
        assert hub.get("swarm_peer_bytes_total") == 2 * size
        assert hub.get("swarm_bytes_served_total") == 2 * size
        assert hub.get("swarm_chunks_refetched_total") == 0
        assert any(b["pull"] == "t3" and b["chunks_have"] == total
                   for b in tplacement.boards_snapshot())
    finally:
        _close(scheds, servers.values())
        origin.stop()


def test_dead_host_chunks_reowned_not_repulled(tmp_path):
    """A host in the ring that never answers: its owned chunks are
    re-sourced by ring successors once each; origin bytes stay 1×."""
    origin, files = _seed_origin(tmp_path, n_files=1, mb=6, tag="dead")
    servers, parts = _servers(tmp_path, ("hA", "hB"))
    parts = dict(parts, hC="http://127.0.0.1:9")
    scheds = []
    try:
        for hid in ("hA", "hB"):
            s = tremote.SwarmScheduler("tdead", hid, parts)
            for f in files:
                s.add_file(f["key"], f["size"], tremote.PeerBlobReader(
                    origin.url, f["key"], f["size"]))
            scheds.append(s)
        for s in scheds:
            s.start()
        ghost = tremote.SwarmScheduler("tdead-ghost", "hC", parts)
        for f in files:
            ghost.add_file(f["key"], f["size"], object())
        ghost._plan()
        owned_c = len(ghost._owned)
        ghost.close()
        assert owned_c > 0
        for s in scheds:
            s.fetch_all()
        for s in scheds:
            assert _read_all(s, files) == {f["key"]: f["sha256"]
                                           for f in files}
        hub = tmetrics.HUB
        assert hub.get("swarm_origin_bytes_total") == files[0]["size"]
        assert hub.get("swarm_chunks_refetched_total") == owned_c
    finally:
        _close(scheds, servers.values())
        origin.stop()


def test_reaper_frees_boards_and_reaped_chunks_reread(tmp_path):
    """Once every live sibling holds a chunk and the local delivery has
    consumed past it, the reaper frees its bytes; a later re-read
    re-lands it from origin bytes-exact without condemning the
    sibling."""
    origin, files = _seed_origin(tmp_path, n_files=1, mb=3, tag="reap")
    servers, parts = _servers(tmp_path, ("hA", "hB"))
    scheds = []
    try:
        for hid in parts:
            s = tremote.SwarmScheduler("treap", hid, parts)
            for f in files:
                s.add_file(f["key"], f["size"], tremote.PeerBlobReader(
                    origin.url, f["key"], f["size"]))
            scheds.append(s)
        for s in scheds:
            s.start()
        for s in scheds:
            s.fetch_all()
            assert _read_all(s, files) == {f["key"]: f["sha256"]
                                           for f in files}
        total = tplacement.chunk_count(files[0]["size"], 1 << 20)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and any(
                s.board.stats()["bytes_held"] > 0 for s in scheds):
            time.sleep(0.1)
        for s in scheds:
            st = s.board.stats()
            assert (st["bytes_held"], st["chunks_reaped"],
                    st["chunks_have"]) == (0, total, total)
        hub = tmetrics.HUB
        assert hub.get("swarm_chunks_reaped_total") == 2 * total
        t0 = time.monotonic()
        assert _read_all(scheds[0], files) == {f["key"]: f["sha256"]
                                               for f in files}
        assert time.monotonic() - t0 < 15
        assert not scheds[0]._snapshot_dead()
        assert hub.get("swarm_chunks_unreaped_total") > 0
    finally:
        _close(scheds, servers.values())
        origin.stop()


def test_a_held_range_floors_the_reaper(tmp_path):
    """A fetch that reads one tensor window by window holds its start
    (``holding``) for the whole fetch: a later range read to its end
    must not let the reaper free the chunks the held fetch has yet to
    read. Solo board: the reaper gates on consumption alone."""
    origin, files = _seed_origin(tmp_path, n_files=1, mb=3, tag="hold")
    servers, parts = _servers(tmp_path, ("hA",))
    s = tremote.SwarmScheduler("thold", "hA", parts)
    f = files[0]
    try:
        s.add_file(f["key"], f["size"], tremote.PeerBlobReader(
            origin.url, f["key"], f["size"]))
        reader = tremote.SwarmBlobReader(s, f["key"], f["size"], None)
        s.start()
        s.fetch_all()
        tail = bytearray(1 << 20)
        with reader.holding(0):
            reader.pread_into(f["key"], tail, 2 << 20)
            assert s._reap_candidates() == []
            assert all(s.board.get(f["key"], i) is not None
                       for i in range(3))
        # released: every chunk is reapable (or the reaper already took it)
        chunks = {(f["key"], i) for i in range(3)}
        assert set(s._reap_candidates()) | {
            c for c in chunks if s.board.reaped(*c)} == chunks
    finally:
        _close([s], servers.values())
        origin.stop()


def test_swarm_routes_404_without_a_board(tmp_path):
    """No board: the swarm routes 404; an empty registry lists no
    models."""
    with TStore(tmp_path / "s") as store, \
            TRestore(TRegistry(store), host="127.0.0.1") as srv:
        for path in ("/swarm/nope/h1/chunks", "/swarm/nope/h1/chunk/k/0"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}{path}", timeout=5)
            assert ei.value.code == 404
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/restore/models",
                timeout=5) as r:
            assert (r.status, json.loads(r.read())) == (200, {"models": []})


def test_mixed_swarm_of_a_jax_host_and_a_port_host(tmp_path):
    """One JAX host (the reference's scheduler, board registry and
    ``RestoreServer``) and one port host in one swarm off one origin:
    both compute the same owners, both end bytes-exact, and the two
    packages' origin byte counters sum to exactly 1× the files."""
    from demodel_tpu.restore.server import RestoreRegistry
    from demodel_tpu.restore.server import RestoreServer as JRestore
    from demodel_tpu.store import Store as JStore

    origin, files = _seed_origin(tmp_path, n_files=2, mb=3, tag="mix")
    jstore = JStore(tmp_path / "mix-j")
    jsrv = JRestore(RestoreRegistry(jstore), host="127.0.0.1").start()
    tsrv = _board_server(tmp_path / "mix-t")
    parts = {"hJ": f"http://127.0.0.1:{jsrv.port}",
             "hT": f"http://127.0.0.1:{tsrv.port}"}
    scheds = []
    try:
        js = jremote.SwarmScheduler("tmix", "hJ", parts)
        ts = tremote.SwarmScheduler("tmix", "hT", parts)
        for f in files:
            js.add_file(f["key"], f["size"], jremote.PeerBlobReader(
                origin.url, f["key"], f["size"]))
            ts.add_file(f["key"], f["size"], tremote.PeerBlobReader(
                origin.url, f["key"], f["size"]))
        scheds = [js, ts]
        for s in scheds:
            s.start()
        assert js._primary == ts._primary
        assert set(js._owned).isdisjoint(ts._owned)
        digests = _run_all(scheds, files)
        for d in digests.values():
            assert d == {f["key"]: f["sha256"] for f in files}
        size = sum(f["size"] for f in files)
        origin_bytes = [m.HUB.get("swarm_origin_bytes_total")
                        for m in (tmetrics, jmetrics)]
        assert sum(origin_bytes) == size and min(origin_bytes) > 0
        assert tmetrics.HUB.get("swarm_peer_bytes_total") + \
            jmetrics.HUB.get("swarm_peer_bytes_total") == size
        assert ts.stats()["chunks_refetched"] == \
            js.stats()["chunks_refetched"] == 0
    finally:
        _close(scheds, [jsrv, tsrv])
        origin.stop()


def test_swarm_pull_places_exact_with_1x_origin(tmp_path, monkeypatch):
    """``pull_manifest_to_hbm(swarm=...)`` on two port hosts at once from
    one warm peer: both placements exact, origin chunk bytes 1× the
    weight files, the other copy peer to peer, no re-fetch."""
    monkeypatch.setenv("DEMODEL_SINK_PREFETCH", "1")
    path = tmp_path / "swp-cache"
    with TStore(path / "proxy") as store:
        tensors, files, weight = _seed_store(store, "swp", 3, 0)
    cfg = TConfig(host="127.0.0.1", port=0, no_mitm=True, cache_dir=path,
                  data_dir=tmp_path / "swp-data")
    servers, parts = _servers(tmp_path, ("hA", "hB"))
    scheds = [tremote.SwarmScheduler("tswp", h, parts) for h in parts]
    results: dict = {}
    errors: list = []
    try:
        with TProxy(cfg, session_threads=4) as origin:
            def run(s):
                try:
                    results[s.self_id] = tremote.pull_manifest_to_hbm(
                        CHAOS_MODEL, [origin.url],
                        mesh=make_mesh(device="cpu"), swarm=s)
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)

            ths = [threading.Thread(target=run, args=(s,)) for s in scheds]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=60)
        assert errors == [] and len(results) == 2
        for rep, placed in results.values():
            assert rep["pipelined"] and rep["weight_bytes"] == weight
            assert sorted(placed.arrays) == sorted(tensors)
            for name, want in tensors.items():
                np.testing.assert_array_equal(placed.arrays[name].numpy(),
                                              want)
        hub = tmetrics.HUB
        assert hub.get("swarm_origin_bytes_total") == weight
        assert hub.get("swarm_peer_bytes_total") == weight
        assert hub.get("swarm_chunks_refetched_total") == 0
    finally:
        _close(scheds, servers.values())
