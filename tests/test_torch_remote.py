"""Port parity: the sharded pull of ``demodel_tpu_torch`` (``sink/remote``:
``pull_manifest_to_hbm``, ``PeerBlobReader``, the prefetch pipeline and
``materialize_aux_files``) against ``demodel_tpu`` on the CPU.

Warm peers are each package's ``ProxyServer`` over one store: a store
filled by the port's pull from one fake Hub (a seeded F32 2-layer GQA
Llama in two shards, ``tests/test_torch_pull.py``), a store filled by an
Ollama pull (a seeded GGUF), or a store seeded with three 3.2 MB shards
(``tests/test_fault_injection.py``'s, big enough for a fault to land
mid-window). Faults come from the reference's chaos proxy
(``tests/chaoshttp.py``). The port places on a CPU mesh, the reference
on its 8-device CPU mesh; placements are compared byte for byte.
"""

from __future__ import annotations

import contextlib
import json
import threading

import numpy as np
import pytest
import torch

from demodel_tpu.config import ProxyConfig as JConfig
from demodel_tpu.parallel import peer as jpeer
from demodel_tpu.proxy import ProxyServer as JProxy
from demodel_tpu.sink import remote as jremote
from demodel_tpu.utils import faults as jfaults
from demodel_tpu_torch import delivery as tdelivery
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.parallel import make_mesh
from demodel_tpu_torch.parallel import peer as tpeer
from demodel_tpu_torch.proxy import ProxyServer as TProxy
from demodel_tpu_torch.sink import remote as tremote
from demodel_tpu_torch.store import Store as TStore
from demodel_tpu_torch.utils import faults as tfaults
from demodel_tpu_torch.utils.metrics import HUB

from .chaoshttp import ChaosPeer, FaultPlan, FaultSpec
from .fake_registries import make_hf_handler, make_ollama_handler
from .servers import FakeUpstream
from .test_fault_injection import MODEL as CHAOS_MODEL
from .test_fault_injection import _seed_store
from .test_torch_ollama import MODEL as OLLAMA_MODEL
from .test_torch_ollama import REPO as OLLAMA_REPO
from .test_torch_ollama import _model as _ollama_model
from .test_torch_pull import MODEL, _llama_files
from .torch_refnative import reference_native_lib  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """Two fetch workers, fast retries, short keep-alive on the peers, and
    fresh breakers and gossip per test in both packages."""
    monkeypatch.setenv("DEMODEL_FETCH_WORKERS", "2")
    monkeypatch.setenv("DEMODEL_RETRY_BASE_MS", "20")
    monkeypatch.setenv("DEMODEL_RETRY_DEADLINE", "60")
    monkeypatch.setenv("DEMODEL_BREAKER_COOLDOWN", "1")
    monkeypatch.setenv("DEMODEL_PROXY_IDLE_TIMEOUT", "1")
    monkeypatch.delenv("DEMODEL_PEERS", raising=False)
    monkeypatch.delenv("DEMODEL_PROFILE_DIR", raising=False)
    for mod in (tfaults, jfaults):
        mod.PeerHealth.reset_shared()
    yield
    for mod in (tpeer, jpeer):
        mod.PeerGossip.reset_shared()
    for mod in (tfaults, jfaults):
        mod.PeerHealth.reset_shared()


def _tcfg(path) -> TConfig:
    return TConfig(host="127.0.0.1", port=0, no_mitm=True, cache_dir=path,
                   data_dir=path.parent / "data")


def _jcfg(path) -> JConfig:
    return JConfig(host="127.0.0.1", port=0, no_mitm=True, cache_dir=path,
                   data_dir=path.parent / "data")


def _cpu():
    return make_mesh(device="cpu")


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


def _assert_same(tplaced, jplaced) -> None:
    assert sorted(tplaced.arrays) == sorted(jplaced.arrays)
    for name, t in tplaced.arrays.items():
        want = np.asarray(jplaced.arrays[name])
        assert t.device.type == "cpu" and tuple(t.shape) == want.shape
        assert _bytes(t) == want.tobytes(), name


def _assert_exact(tplaced, tensors: dict) -> None:
    assert sorted(tplaced.arrays) == sorted(tensors)
    for name, want in tensors.items():
        np.testing.assert_array_equal(tplaced.arrays[name].numpy(), want)


@pytest.fixture(scope="module")
def peer_cache(tmp_path_factory):
    """A store filled by the port's pull from a fake Hub (no device)."""
    path = tmp_path_factory.mktemp("peer") / "cache"
    mp = pytest.MonkeyPatch()
    mp.setenv("DEMODEL_FETCH_WORKERS", "2")
    try:
        with FakeUpstream(handler=make_hf_handler(
                {MODEL: _llama_files()})) as up:
            tdelivery.pull(MODEL, _tcfg(path),
                           endpoint=f"http://{up.authority}")
    finally:
        mp.undo()
    return path


@pytest.fixture(scope="module")
def peers(peer_cache):
    """The port's and the reference's proxies over ``peer_cache``."""
    with TProxy(_tcfg(peer_cache), session_threads=4) as tp, \
            JProxy(_jcfg(peer_cache), verbose=False,
                   session_threads=4) as jp:
        yield tp, jp


def _manifest(peer_cache, source: str, model: str) -> dict:
    with TStore(peer_cache / "proxy") as s:
        return json.loads(s.get(tdelivery.manifest_key(source, model)))


# -------------------------------------------------------- the sharded pull


def test_sharded_pull_matches_reference(peers, peer_cache):
    """The same warm peer's bytes, placed by both packages: byte-identical
    tensors, the same network and weight byte counts, the pipelined path,
    no native fallback."""
    tp, jp = peers
    fallback0 = HUB.get("peer_window_fallback_total")
    trep, tplaced = tremote.pull_manifest_to_hbm(MODEL, [tp.url],
                                                 mesh=_cpu())
    jrep, jplaced = jremote.pull_manifest_to_hbm(MODEL, [jp.url])
    _assert_same(tplaced, jplaced)
    weight = sum(f["size"] for f in _manifest(peer_cache, "hf", MODEL)
                 ["files"] if f["name"].endswith(".safetensors"))
    assert trep["weight_bytes"] == jrep["weight_bytes"] == weight
    # header reads plus every tensor's window: each file byte once
    assert trep["network_bytes"] == jrep["network_bytes"] == weight
    assert trep["pipelined"] and trep["peer"] == tp.url
    assert set(trep["phase_secs"]) == set(jrep["phase_secs"])
    assert HUB.get("peer_window_fallback_total") == fallback0
    assert all(t.dtype == torch.float32 for t in tplaced.arrays.values())


def test_sharded_pull_reads_the_reference_proxy_too(peers):
    """The port's reader against the reference's proxy and the reverse
    pairing land the same bytes."""
    tp, jp = peers
    _, a = tremote.pull_manifest_to_hbm(MODEL, [jp.url], mesh=_cpu())
    _, b = jremote.pull_manifest_to_hbm(MODEL, [tp.url])
    _assert_same(a, b)


def test_striping_over_two_peers(peers):
    """Two warm peers: the two shards stripe one to each (bounded-load
    consistent hash), so both proxies serve weight bytes; placements equal
    the reference's over the same two peers."""
    tp, jp = peers
    served0 = [p.metrics().get("serve_bytes_total", 0) for p in (tp, jp)]
    trep, tplaced = tremote.pull_manifest_to_hbm(
        MODEL, [tp.url, jp.url], mesh=_cpu())
    served = [p.metrics().get("serve_bytes_total", 0) - b
              for p, b in zip((tp, jp), served0)]
    assert all(n > 100_000 for n in served), served
    jrep, jplaced = jremote.pull_manifest_to_hbm(MODEL, [tp.url, jp.url])
    _assert_same(tplaced, jplaced)
    assert trep["network_bytes"] == jrep["network_bytes"]


def test_materialize_aux_files_matches_reference(peers, peer_cache,
                                                 tmp_path):
    tp, jp = peers
    manifest = _manifest(peer_cache, "hf", MODEL)
    tout = tremote.materialize_aux_files(manifest, tp.url, tmp_path / "t")
    jout = jremote.materialize_aux_files(manifest, jp.url, tmp_path / "j")
    assert [p.name for p in tout] == [p.name for p in jout]
    assert "config.json" in [p.name for p in tout]
    for a, b in zip(tout, jout):
        assert a.read_bytes() == b.read_bytes()
    files = _llama_files()
    assert (tmp_path / "t" / "config.json").read_bytes() == \
        files["config.json"]


def test_ensure_artifacts_matches_reference(peers, peer_cache, tmp_path):
    """``ensure_artifacts`` fills a fresh store from a peer in both
    packages: the same stats, the same bytes; an artifact no peer holds
    is a miss without an upstream, an upstream fetch with one."""
    from demodel_tpu.parallel.peer import PeerSet as JPeerSet
    from demodel_tpu.parallel.peer import ensure_artifacts as jensure
    from demodel_tpu.store import Store as JStore

    tp, jp = peers
    files = _manifest(peer_cache, "hf", MODEL)["files"]
    arts = files + [{"key": "0" * 16, "name": "absent.bin", "sha256": None}]
    ts, js = TStore(tmp_path / "t"), JStore(tmp_path / "j")
    tset, jset = tpeer.PeerSet([tp.url], timeout=10), \
        JPeerSet([jp.url], timeout=10)
    try:
        tstats = tpeer.ensure_artifacts(ts, arts, tset)
        jstats = jensure(js, arts, jset)
        assert (tstats.from_peers, tstats.peer_bytes, tstats.misses) == \
            (jstats.from_peers, jstats.peer_bytes, jstats.misses) == \
            (len(files), sum(f["size"] for f in files), ["absent.bin"])
        for f in files:
            assert ts.get(f["key"]) == js.get(f["key"])
        fetched = []
        again = tpeer.ensure_artifacts(ts, arts, tset,
                                       upstream_fetch=fetched.append)
        assert (again.from_peers, again.from_upstream) == (0, 1)
        assert [a["name"] for a in fetched] == ["absent.bin"]
    finally:
        tset.close()
        ts.close()
        js.close()


def test_gossip_split_matches_reference():
    gossips = [tpeer.PeerGossip(), jpeer.PeerGossip(refresh_s=60.0)]
    for g in gossips:
        g.refresh_s = 60.0
        g.observe("http://a:1", {"k1", "k2"})
        g.observe("http://b:1", None, ok=False)
    peers = ["http://a:1", "http://b:1", "http://c:1"]
    got = [g.split(peers) for g in gossips]
    assert got[0] == got[1] == (["http://a:1"], ["http://b:1"],
                                ["http://c:1"])
    assert gossips[0].keys("http://a:1") == frozenset({"k1", "k2"})
    assert gossips[0].keys("http://b:1") is None


def test_no_peer_holds_the_manifest_raises(peers):
    tp, _ = peers
    with pytest.raises(IOError, match="no peer holds a manifest"):
        tremote.pull_manifest_to_hbm("org/absent", [tp.url], mesh=_cpu())


def test_entry_point_defaults_to_cuda(peers):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    tp, _ = peers
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tremote.pull_manifest_to_hbm(MODEL, [tp.url])


def test_large_window_takes_the_native_fetch(tmp_path):
    """A window of 4 MiB or more on an ``http://`` peer goes through the
    native multi-stream window fetch (``dm_peer_fetch_window``) in both
    packages: bytes exact, each byte counted once, no fallback to the
    Python transport."""
    body = np.random.default_rng(9).bytes((6 << 20) + 12345)
    path = tmp_path / "big-cache"
    with TStore(path / "proxy") as store:
        store.put("bigobject0000001", body,
                  {"content-type": "application/octet-stream"})
    fallback0 = HUB.get("peer_window_fallback_total")
    with TProxy(_tcfg(path), session_threads=4) as tp:
        got = {}
        for name, mod in (("port", tremote), ("ref", jremote)):
            reader = mod.PeerBlobReader(tp.url, "bigobject0000001",
                                        len(body), streams=3)
            out = bytearray(len(body) - 100)
            assert reader.pread_into("bigobject0000001", out, 100) == \
                len(out)
            got[name] = (bytes(out), reader.bytes_fetched)
    assert got["port"] == got["ref"] == (body[100:], len(body) - 100)
    assert HUB.get("peer_window_fallback_total") == fallback0


# ------------------------------------------------------------ gguf leg


def test_gguf_over_the_wire_matches_reference(tmp_path):
    """An Ollama pull's store behind each package's proxy: the GGUF layer
    takes the per-file path into ``deliver_gguf`` (the dequant kernels'
    plain versions on the CPU), bf16 placements byte-equal the
    reference's, and equal ``deliver_gguf`` from the store."""
    from demodel_tpu_torch.sink import deliver_gguf

    manifest, blobs = _ollama_model()
    cache = tmp_path / "ollama-cache"
    with FakeUpstream(handler=make_ollama_handler(
            {OLLAMA_REPO: manifest}, blobs)) as up:
        tdelivery.pull(OLLAMA_MODEL, _tcfg(cache), source="ollama",
                       endpoint=f"http://{up.authority}")
    with TProxy(_tcfg(cache), session_threads=2) as tp, \
            JProxy(_jcfg(cache), verbose=False, session_threads=2) as jp:
        trep, tplaced = tremote.pull_manifest_to_hbm(
            OLLAMA_MODEL, [tp.url], source="ollama", mesh=_cpu())
        jrep, jplaced = jremote.pull_manifest_to_hbm(
            OLLAMA_MODEL, [jp.url], source="ollama")
    _assert_same(tplaced, jplaced)
    assert sorted(tplaced.arrays) == [
        "blk.0.attn_norm.weight", "blk.0.attn_q.weight", "token_embd.weight"]
    assert all(t.dtype == torch.bfloat16 for t in tplaced.arrays.values())
    assert not trep["pipelined"]
    assert trep["weight_bytes"] == jrep["weight_bytes"]
    assert trep["network_bytes"] == jrep["network_bytes"]
    layer = next(f for f in trep["files"]
                 if f["media_type"] == "application/vnd.ollama.image.model")
    with TStore(cache / "proxy") as s:
        ref = deliver_gguf(s, layer["key"], mesh=_cpu())
    for name, t in tplaced.arrays.items():
        assert torch.equal(t, ref.arrays[name]), name


# ------------------------------------------------------- chaos on the wire


@contextlib.contextmanager
def _seeded_nodes(tmp_path, tag: str, n_shards: int = 3):
    """Each package's proxy over one store seeded with ``n_shards`` 3.2 MB
    f32 shards and their manifest record."""
    path = tmp_path / f"{tag}-cache"
    with TStore(path / "proxy") as store:
        seeded = _seed_store(store, tag, n_shards, 0)
    with TProxy(_tcfg(path), session_threads=4) as tp, \
            JProxy(_jcfg(path), verbose=False, session_threads=4) as jp:
        yield tp, jp, seeded


def _retries() -> float:
    return sum(v for k, v in HUB.snapshot().items()
               if k.startswith("peer_retries_total"))


@pytest.mark.parametrize("kind,at_byte,shard", [
    ("reset-at-byte", 2_500_000, 1),
    ("truncate", 2_400_000, 0),
])
def test_window_fault_resumes_at_the_offset(tmp_path, kind, at_byte,
                                            shard):
    """A reset (RST) or a truncated body (clean FIN) partway through a
    tensor window on the only peer: the window resumes at the received
    offset, so network bytes stay within 1.05× the weights + 1 MiB in both
    packages and placements are exact; after a truncation the resume
    Range starts past the cut (from the shim's request log)."""
    with _seeded_nodes(tmp_path, kind) as (tp, jp, (tensors, files, weight)):
        key = files[shard]["key"]
        results = {}
        for pkg, node, mod in (("port", tp, tremote), ("ref", jp, jremote)):
            plan = FaultPlan(FaultSpec(kind, path=key, at_byte=at_byte,
                                       min_body=1 << 20), seed=11)
            retries0 = _retries()
            with ChaosPeer(node.url, plan) as chaos:
                kw = {"mesh": _cpu()} if pkg == "port" else {}
                rep, placed = mod.pull_manifest_to_hbm(
                    CHAOS_MODEL, [chaos.url], **kw)
                starts = sorted(int(r.split("=")[1].split("-")[0])
                                for p, r in chaos.requests_log
                                if key in p and r.startswith("bytes="))
            assert plan.fired(kind) == 1, pkg
            assert weight <= rep["network_bytes"] <= \
                weight * 1.05 + (1 << 20), (pkg, rep["network_bytes"])
            if kind == "truncate":
                # a FIN delivers every byte before the cut: one full
                # window request and one resume 2 MiB or more into it (an
                # RST may discard what sat unread in the receive buffer)
                win = [s for s in starts if s > 8]
                assert win.count(win[0]) == 1, (pkg, win)
                assert sum(s >= win[0] + (2 << 20) for s in win) == 1, \
                    (pkg, win)
            results[pkg] = placed
            if pkg == "port":
                assert _retries() - retries0 >= 1
                _assert_exact(placed, tensors)
    _assert_same(results["port"], results["ref"])


def test_dead_peer_fails_over_to_the_second(tmp_path):
    """Two shims in front of one node share a plan whose ``die`` fault
    fires on the first request for shard 0, on whichever shim the
    striping sends it to: that shim stays dark, every window it would have
    served fails over to the other, and the bytes land exact in both
    packages."""
    with _seeded_nodes(tmp_path, "die") as (tp, jp, (tensors, files, weight)):
        results = {}
        for pkg, node, mod in (("port", tp, tremote), ("ref", jp, jremote)):
            plan = FaultPlan(FaultSpec("die", path=files[0]["key"]), seed=3)
            with ChaosPeer(node.url, plan) as a, \
                    ChaosPeer(node.url, plan) as b:
                kw = {"mesh": _cpu()} if pkg == "port" else {}
                rep, placed = mod.pull_manifest_to_hbm(
                    CHAOS_MODEL, [a.url, b.url], **kw)
                dead = a if a.dead else b
                alive = b if dead is a else a
                assert not alive.dead
                assert any(files[0]["key"] in p
                           for p, _ in alive.requests_log), pkg
            assert plan.fired("die") == 1, pkg
            assert rep["weight_bytes"] == weight
            results[pkg] = placed
        _assert_exact(results["port"], tensors)
    _assert_same(results["port"], results["ref"])


def test_breaker_half_open_probe_matches_reference():
    """``allow`` admits exactly one half-open probe per cooldown in both
    packages; ``describe`` and ``healthy`` agree."""
    now = [0.0]
    peer = "http://p:1"
    hs = [mod.PeerHealth(threshold=2, cooldown=10, clock=lambda: now[0])
          for mod in (tfaults, jfaults)]

    def seen():
        got = [(h.allow(peer), h.admissible(peer), h.breaker(peer).state(),
                h.describe()[peer]["state"]) for h in hs]
        assert got[0] == got[1]
        return got[0]

    for h in hs:
        h.record_failure(peer)
        h.record_failure(peer)
    assert seen() == (False, False, tfaults.STATE_OPEN, "open")
    now[0] = 11.0
    assert seen() == (True, False, tfaults.STATE_HALF_OPEN, "half-open")
    assert seen() == (False, False, tfaults.STATE_HALF_OPEN, "half-open")
    for h in hs:
        h.record_failure(peer)
    assert seen() == (False, False, tfaults.STATE_OPEN, "open")
    assert [h.healthy([peer, "http://q:2"]) for h in hs] == \
        [["http://q:2"]] * 2
    now[0] = 30.0
    for h in hs:
        assert h.allow(peer)
        h.record_success(peer)
    assert seen() == (True, True, tfaults.STATE_CLOSED, "closed")


@pytest.mark.parametrize("status,cannot", [(404, True), (416, True),
                                           (429, False), (503, False)])
def test_cannot_serve_classification_matches_reference(status, cannot):
    import requests

    class R:
        status_code = status
        url = "http://p/x"
        headers: dict = {}

    tr = tfaults.HTTPError(R())
    jr = requests.HTTPError(response=requests.Response())
    jr.response.status_code = status
    assert tfaults.peer_cannot_serve(tr) == jfaults.peer_cannot_serve(jr) \
        == cannot
    assert tfaults.retryable(tr) == jfaults.retryable(jr) == (not cannot)
    ignored = (tfaults.RangeIgnored("x"), jfaults.RangeIgnored("x"))
    assert [f.peer_cannot_serve(e) for f, e in
            zip((tfaults, jfaults), ignored)] == [True, True]
    assert not tfaults.retryable(tfaults.BreakerOpen("x"))


# ------------------------------------------------ the pipeline's byte budget


def _blob_and_index(n_tensors=3, rows=150, cols=1024):
    from demodel_tpu_torch.formats import safetensors as st

    rng = np.random.default_rng(3)
    tensors = {f"t{i}": rng.standard_normal((rows, cols)).astype(np.float32)
               for i in range(n_tensors)}
    blob = st.serialize(tensors)
    index = st.read_index_from(lambda off, ln: blob[off:off + ln],
                               total_size=len(blob))
    return tensors, blob, index


class _BlobReader:
    """The reader surface ``_deliver_jobs_pipelined`` touches; optionally
    fails the window at one offset."""

    def __init__(self, blob: bytes, fail_at_offset: int | None = None):
        self.blob = blob
        self.fail_at_offset = fail_at_offset
        self.bytes_fetched = 0

    def pread_into(self, key, out, offset=0) -> int:
        if self.fail_at_offset is not None and offset == self.fail_at_offset:
            raise IOError("synthetic mid-pipeline window failure")
        view = memoryview(out).cast("B")
        view[:] = self.blob[offset:offset + view.nbytes]
        self.bytes_fetched += view.nbytes
        return view.nbytes


class _RecordingBudget:
    """ByteBudget stand-in recording the high-water mark of outstanding
    bytes."""

    instances: list = []

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._in_use = 0
        self._cv = threading.Condition()
        self._aborted = False
        self.high_water = 0
        _RecordingBudget.instances.append(self)

    @property
    def in_use(self) -> int:
        return self._in_use

    def acquire(self, nbytes: int) -> None:
        with self._cv:
            while (self._in_use > 0 and self._in_use + nbytes > self.max_bytes
                   and not self._aborted):
                self._cv.wait()
            self._in_use += nbytes
            self.high_water = max(self.high_water, self._in_use)

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._in_use -= nbytes
            self._cv.notify_all()

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()


@pytest.fixture
def recording_budget(monkeypatch):
    from demodel_tpu_torch.sink import streaming

    _RecordingBudget.instances = []
    monkeypatch.setattr(streaming, "ByteBudget", _RecordingBudget)
    monkeypatch.setenv("DEMODEL_SINK_BUFFER_MB", "1")
    monkeypatch.setenv("DEMODEL_SINK_PREFETCH", "2")
    return _RecordingBudget


def _pipeline(jobs):
    from demodel_tpu_torch.sink.plan import ShardingPlan

    mesh = _cpu()
    return tremote._deliver_jobs_pipelined(jobs, mesh, ShardingPlan(mesh))


def test_pipelined_buffers_ride_the_byte_budget(recording_budget):
    """With a budget smaller than two windows, prefetch workers serialize
    at acquire: the high-water mark stays at one window although the
    prefetch depth would admit two, and every byte is released."""
    tensors, blob, index = _blob_and_index()
    one_window = next(iter(index.tensors.values())).nbytes
    assert 2 * one_window > (1 << 20) > one_window
    reader = _BlobReader(blob)
    out = _pipeline([(reader, "k", n, s) for n, s in index.tensors.items()])
    _assert_exact(out, tensors)
    [budget] = recording_budget.instances
    assert budget.high_water == one_window
    assert budget.in_use == 0
    assert set(out.phase_secs) == {"fetch_stall_secs", "place_secs"}


def test_pipeline_failure_releases_and_unblocks(recording_budget):
    """A mid-pipeline window failure neither deadlocks the executor join
    nor loses the landed tensors."""
    tensors, blob, index = _blob_and_index()
    specs = list(index.tensors.items())
    reader = _BlobReader(blob, fail_at_offset=specs[1][1].start)
    with pytest.raises(tremote.PipelineFailure) as exc:
        _pipeline([(reader, "k", n, s) for n, s in specs])
    assert specs[0][0] in exc.value.partial.arrays
    [budget] = recording_budget.instances
    assert budget._aborted


def test_place_failure_wakes_blocked_acquirer(recording_budget):
    """A place() failure (a duplicate tensor) while a prefetch worker sits
    blocked in ``acquire`` aborts the budget before the executor join."""
    tensors, blob, index = _blob_and_index()
    specs = list(index.tensors.items())
    reader = _BlobReader(blob)
    jobs = [(reader, "k", specs[0][0], specs[0][1]),
            (reader, "k", specs[0][0], specs[0][1]),
            (reader, "k", specs[1][0], specs[1][1]),
            (reader, "k", specs[2][0], specs[2][1])]
    result: dict = {}

    def run():
        try:
            _pipeline(jobs)
            result["outcome"] = "returned"
        except BaseException as e:  # noqa: BLE001 — recorded for assert
            result["outcome"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "pipelined delivery deadlocked on failure"
    assert isinstance(result["outcome"], ValueError), result
    [budget] = recording_budget.instances
    assert budget._aborted


def test_alive_peers_probe_concurrently():
    """K dead peers cost about one deadline, the live one is kept."""
    import http.server
    import time

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        live = f"http://127.0.0.1:{srv.server_address[1]}"
        dead = [f"http://127.0.0.1:{p}" for p in (1, 2, 3, 4)]
        t0 = time.perf_counter()
        got = tremote._alive_peers(dead[:2] + [live] + dead[2:], timeout=2.0)
        assert got == [live]
        assert time.perf_counter() - t0 < 5.0
        assert tremote._alive_peers([]) == []
    finally:
        srv.shutdown()
        srv.server_close()
