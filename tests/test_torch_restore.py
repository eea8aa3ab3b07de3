"""Port parity: the restore node of ``demodel_tpu_torch`` (``restore/server``
with its registry, the native tensor plane behind ``ProxyServer``,
``restore/client``, the streamed save, ``scrub`` and ``render(proxy,
store)``) against ``demodel_tpu``'s on the CPU.

Each package pulls ``tests/fake_registries.build_hf_repo(n_shards=2)``
from one fake Hub into a store of its own; the two stores hold the same
keys and bytes. Each package's ``RestoreServer`` (and ``ProxyServer``,
where the native plane is attached) serves its own store, and the same
requests go to both.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import shutil
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from demodel_tpu import delivery as jdelivery
from demodel_tpu import scrub as jscrub
from demodel_tpu.config import ProxyConfig as JConfig
from demodel_tpu.proxy import ProxyServer as JProxy
from demodel_tpu.restore import client as jclient
from demodel_tpu.restore import server as jserver
from demodel_tpu.store import Store as JStore
from demodel_tpu.parallel import peer as jpeer
from demodel_tpu.sink import remote as jremote
from demodel_tpu.utils import faults as jfaults
from demodel_tpu.utils import metrics as jmetrics
from demodel_tpu.utils import profiler as jprofiler
from demodel_tpu.utils import retention as jretention
from demodel_tpu.utils import trace as jtrace
from demodel_tpu_torch import delivery as tdelivery
from demodel_tpu_torch import scrub as tscrub
from demodel_tpu_torch import serve as tserve
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.formats import safetensors as tst
from demodel_tpu_torch.models import llama as tl
from demodel_tpu_torch.parallel import make_mesh
from demodel_tpu_torch.parallel import peer as tpeer
from demodel_tpu_torch.proxy import ProxyServer as TProxy
from demodel_tpu_torch.restore import client as tclient
from demodel_tpu_torch.restore import server as tserver
from demodel_tpu_torch.restore.orbax_http import save_state_dict
from demodel_tpu_torch.serve import http as thttp
from demodel_tpu_torch.sink import remote as tremote
from demodel_tpu_torch.store import Store as TStore
from demodel_tpu_torch.store import key_for_uri
from demodel_tpu_torch.utils import faults as tfaults
from demodel_tpu_torch.utils import metrics as tmetrics
from demodel_tpu_torch.utils import profiler as tprofiler
from demodel_tpu_torch.utils import retention as tretention
from demodel_tpu_torch.utils import trace as ttrace

from .fake_registries import build_hf_repo, make_hf_handler
from .servers import FakeUpstream
from .torch_refnative import reference_native_lib  # noqa: F401

torch.set_num_threads(1)

MODEL = "org/m"
PKG = {"port": (TStore, tserver, TProxy, TConfig),
       "reference": (JStore, jserver, JProxy, JConfig)}


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    monkeypatch.setenv("DEMODEL_RETRY_BASE_MS", "20")
    monkeypatch.setenv("DEMODEL_PROXY_IDLE_TIMEOUT", "1")
    for var in ("DEMODEL_ADVERTISE_HOST", "DEMODEL_SCRUB_INTERVAL_SECS",
                "DEMODEL_PEERS", "DEMODEL_RESTORE_WORKERS"):
        monkeypatch.delenv(var, raising=False)
    for mod in (tfaults, jfaults):
        mod.PeerHealth.reset_shared()
    yield
    for mod in (tfaults, jfaults):
        mod.PeerHealth.reset_shared()
    # each RestoreServer.start() starts its package's sampling profiler
    for mod in (tprofiler, jprofiler):
        mod.stop()


@pytest.fixture(scope="module")
def pulled(tmp_path_factory):
    """``{"port": cache_dir, "reference": cache_dir}``: the same 2-shard
    repo pulled by each package into its own store."""
    root = tmp_path_factory.mktemp("restore")
    mp = pytest.MonkeyPatch()
    mp.setenv("DEMODEL_FETCH_WORKERS", "2")
    try:
        with FakeUpstream(handler=make_hf_handler(
                {MODEL: build_hf_repo(n_shards=2, rows=128)})) as up:
            for pkg, (_, _, _, cfg_cls) in PKG.items():
                cfg = cfg_cls(cache_dir=root / pkg, data_dir=root / "data")
                mod = tdelivery if pkg == "port" else jdelivery
                mod.pull(MODEL, cfg, endpoint=f"http://{up.authority}")
    finally:
        mp.undo()
    return {pkg: root / pkg for pkg in PKG}


def _copy(src, dst):
    """A store tree copied without its pin markers (a copy's GC must
    not honour the source's pins)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("pins"))
    return dst


class Node:
    """One package's registry over a store root, its ``RestoreServer``
    on 127.0.0.1, and optionally its native plane attached."""

    def __init__(self, pkg: str, cache_dir, native: str | None = None,
                 advertise: str | None = None, register: bool = False):
        store_cls, server, proxy_cls, cfg_cls = PKG[pkg]
        self.store = store_cls(cache_dir / "proxy")
        self.registry = server.RestoreRegistry(self.store)
        if register:
            mkey = tdelivery.manifest_key("hf", MODEL)
            self.registry.register_report(
                MODEL, json.loads(self.store.get(mkey)))
        self.proxy = None
        if native is not None:
            self.proxy = proxy_cls(cfg_cls(
                host=native, port=0, no_mitm=True, cache_dir=cache_dir,
                data_dir=cache_dir.parent / "data"), verbose=False).start()
            self.registry.attach_native(self.proxy, advertise=advertise)
        self.server = server.RestoreServer(self.registry, host="127.0.0.1",
                                           proxy=self.proxy).start()
        self.url = f"http://127.0.0.1:{self.server.port}"

    def close(self):
        self.server.stop()
        if self.proxy is not None:
            self.proxy.stop()
        self.store.close()


@pytest.fixture()
def nodes():
    made = []

    def make(*a, **kw) -> Node:
        made.append(Node(*a, **kw))
        return made[-1]

    yield make
    for n in made:
        n.close()


def _req(url: str, method: str = "GET", body: bytes | None = None,
         headers: dict | None = None):
    """(status, headers, body) of one request, whatever the status."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        target = f"{u.path}?{u.query}" if u.query else u.path
        conn.request(method, target, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.headers, r.read()
    finally:
        conn.close()


def _stored_tensors(cache_dir) -> dict[str, np.ndarray]:
    """Every tensor of the pulled model, read from its stored blobs."""
    out = {}
    with TStore(cache_dir / "proxy") as store:
        record = json.loads(store.get(tdelivery.manifest_key("hf", MODEL)))
        for f in record["files"]:
            if not f["name"].endswith(".safetensors"):
                continue
            idx = tst.read_index_from(
                lambda off, ln, k=f["key"]: store.pread(k, ln, off))
            for name, spec in idx.tensors.items():
                raw = store.pread(f["key"], spec.nbytes, spec.start)
                out[name] = np.frombuffer(raw, np.float32).reshape(
                    spec.shape)
    return out


# ------------------------------------------------------------- manifests


#: (registration, native bind, advertise, Host header of the request)
MANIFEST_CASES = {
    "explicit": ("explicit", None, None, None),
    "lazy": ("lazy", None, None, None),
    "native-127.0.0.1": ("lazy", "127.0.0.1", None, None),
    "wildcard-host": ("explicit", "0.0.0.0", None, "h:1"),
    "wildcard-ipv6-host": ("explicit", "0.0.0.0", None, "[::1]:1"),
    "advertise-h": ("lazy", "0.0.0.0", "pod-host-3", "other:1"),
    "advertise-h:p": ("lazy", "0.0.0.0", "pod-host-3:9000", None),
    "advertise-bare-ipv6": ("lazy", "0.0.0.0", "fe80::1", None),
    "advertise-[v6]": ("lazy", "0.0.0.0", "[fe80::1]", None),
    "advertise-[v6]:p": ("lazy", "127.0.0.1", "[fe80::1]:9000", None),
}


@pytest.mark.parametrize("case,via_env", [
    (case, via_env) for case, (_, _, adv, _) in MANIFEST_CASES.items()
    for via_env in ((False, True) if adv else (False,))])
def test_manifest_equals_the_reference(pulled, nodes, monkeypatch, case,
                                       via_env):
    """The manifest over HTTP (and from the registry with no request
    host) equals the reference's: the tensors, and the data endpoint
    with each node's own proxy port. ``via_env``: the advertised host
    comes from ``DEMODEL_ADVERTISE_HOST``."""
    reg, bind, advertise, host = MANIFEST_CASES[case]
    if via_env:
        monkeypatch.setenv("DEMODEL_ADVERTISE_HOST", advertise)
    got = {}
    for pkg in PKG:
        n = nodes(pkg, pulled[pkg], native=bind,
                  advertise=None if via_env else advertise,
                  register=reg == "explicit")
        status, _, body = _req(f"{n.url}/restore/{MODEL}/manifest",
                               headers={"Host": host} if host else None)
        assert status == 200
        port = str(n.proxy.port) if n.proxy else "-"
        got[pkg] = [json.dumps(m).replace(f":{port}", ":PORT") for m in (
            json.loads(body), n.registry.manifest(MODEL))]
        if host is None:
            assert json.loads(body) == n.registry.manifest(
                MODEL, request_host=f"127.0.0.1:{n.server.port}")
    assert got["port"] == got["reference"]
    manifest = json.loads(got["port"][0])
    assert sorted(manifest["tensors"]) == ["layer.0.b", "layer.0.w",
                                           "layer.1.b", "layer.1.w"]
    want = {"explicit": None, "lazy": None,
            "native-127.0.0.1": "http://127.0.0.1:PORT",
            "wildcard-host": "http://h:PORT",
            "wildcard-ipv6-host": "http://[::1]:PORT",
            "advertise-h": "http://pod-host-3:PORT",
            "advertise-h:p": "http://pod-host-3:9000",
            "advertise-bare-ipv6": "http://[fe80::1]:PORT",
            "advertise-[v6]": "http://[fe80::1]:PORT",
            "advertise-[v6]:p": "http://[fe80::1]:9000"}[case]
    assert manifest.get("data_endpoint") == want


def test_unknown_model_and_tensor_404(pulled, nodes):
    """Unknown names 404 on both nodes (a tensor request resolves the
    model lazily); ``/debug/statusz`` answers on both, an unknown
    ``/debug/*`` route 404s on both."""
    for pkg in PKG:
        n = nodes(pkg, pulled[pkg])
        assert json.loads(_req(f"{n.url}/restore/models")[2]) == {
            "models": []}
        assert _req(f"{n.url}/restore/ghost/manifest")[0] == 404
        assert _req(f"{n.url}/restore/{MODEL}/tensor/ghost")[0] == 404
        assert json.loads(_req(f"{n.url}/restore/models")[2]) == {
            "models": [MODEL]}
    port = nodes("port", pulled["port"]).url
    for url in (n.url, port):
        assert _req(f"{url}/debug/statusz")[0] == 200
        assert _req(f"{url}/debug/ghost")[:3:2] == (404,
                                                  b'{"error":"not found"}')


# ----------------------------------------------------------------- Range


#: Range header → (status, [start, end) or None) on a 256-byte tensor,
#: as the native plane answers; the reference's Python server differs
#: where ``REFERENCE_RANGE`` says
RANGE_CASES = {
    "none": (None, 200, (0, 256)),
    "a-b": ("bytes=8-23", 206, (8, 24)),
    "a-": ("bytes=4-", 206, (4, 256)),
    "suffix": ("bytes=-8", 206, (248, 256)),
    "suffix-past-start": ("bytes=-1000", 206, (0, 256)),
    "end-clamped": ("bytes=250-100000", 206, (250, 256)),
    "last-byte": ("bytes=255-255", 206, (255, 256)),
    "start-past-end": ("bytes=256-", 416, None),
    "zero-suffix": ("bytes=-0", 416, None),
    "garbage": ("bytes=x-y", 200, (0, 256)),
    "multi": ("bytes=0-1,4-5", 200, (0, 256)),
    "other-unit": ("items=0-5", 200, (0, 256)),
    "empty-spec": ("bytes=-", 200, (0, 256)),
    "reversed": ("bytes=8-4", 200, (0, 256)),
    "no-dash": ("bytes=5", 200, (0, 256)),
    "double-dash": ("bytes=--5", 200, (0, 256)),
    "spaces": ("bytes= 5-9", 200, (0, 256)),
}
#: where the reference's Python server departs from its own native plane
#: (it parses with ``int()``, and answers a reversed range 416)
REFERENCE_RANGE = {"reversed": (416, None), "no-dash": (206, (5, 256)),
                   "double-dash": (416, None), "spaces": (206, (5, 10))}


@pytest.fixture(scope="module")
def range_nodes(pulled):
    ns = {"port": Node("port", pulled["port"], native="127.0.0.1",
                       register=True),
          "reference": Node("reference", pulled["reference"])}
    yield ns
    for n in ns.values():
        n.close()


@pytest.mark.parametrize("case", list(RANGE_CASES))
def test_range_replies(pulled, range_nodes, case):
    """The port's Python server and its native plane answer a Range
    alike (status, body, ``Content-Range``), and the reference's Python
    server answers the same but where it departs from its native
    plane."""
    rng, status, window = RANGE_CASES[case]
    whole = _stored_tensors(pulled["port"])["layer.0.b"].tobytes()
    assert len(whole) == 256
    path = f"/restore/{MODEL}/tensor/layer.0.b"
    headers = {"Range": rng} if rng else None
    port, ref = range_nodes["port"], range_nodes["reference"]
    replies = {"python": _req(port.url + path, headers=headers),
               "native": _req(port.proxy.url + path, headers=headers),
               "reference": _req(ref.url + path, headers=headers)}
    for side, (got_status, hdrs, body) in replies.items():
        want_status, want = (REFERENCE_RANGE.get(case, (status, window))
                             if side == "reference" else (status, window))
        assert got_status == want_status, side
        if want is None:
            continue
        assert body == whole[want[0]:want[1]], side
        assert hdrs.get("Content-Range") == (
            f"bytes {want[0]}-{want[1] - 1}/256" if want_status == 206
            else None), side


def test_byte_window_matches_the_native_parser():
    """``byte_window`` on odd sizes (0 and 1 bytes) against the cases the
    native ``resolve_range`` documents."""
    w = tserver.byte_window
    assert w(None, 0) == (200, 0, 0)
    assert w("bytes=0-", 0) is None
    assert w("bytes=-5", 0) == (206, 0, 0)
    assert w("bytes=0-0", 1) == (206, 0, 1)
    assert w("bytes=1-", 1) is None


# --------------------------------------------------------------- restores


@pytest.mark.parametrize("client,server,native", [
    ("port", "port", True), ("port", "port", False),
    ("port", "reference", True), ("reference", "port", True)])
def test_restore_across_packages(pulled, nodes, mesh8, client, server,
                                 native):
    """A restore by either package from either package's node, bytes
    from the native plane or the Python server: every value equals the
    stored bytes, and ``bytes_fetched`` is the tensors' bytes."""
    n = nodes(server, pulled[server],
              native="127.0.0.1" if native else None)
    want = _stored_tensors(pulled[server])
    if client == "port":
        before = n.proxy.metrics()["bytes_cache"] if native else 0
        res = tclient.restore(n.url, MODEL, mesh=make_mesh(device="cpu"))
        got = {k: v.numpy() for k, v in res.arrays.items()}
        assert all(v.device.type == "cpu" for v in res.arrays.values())
        if native:
            assert n.proxy.metrics()["bytes_cache"] - before >= \
                sum(v.nbytes for v in want.values())
    else:
        res = jclient.restore(n.url, MODEL, mesh=mesh8)
        got = {k: np.asarray(v) for k, v in res.arrays.items()}
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr)
    assert res.bytes_fetched == sum(v.nbytes for v in want.values())
    assert set(res.manifest["tensors"]) == set(want)


def test_reregistration_drops_stale_tensors(pulled, nodes, tmp_path):
    """A re-registration with another tensor set: the new names serve
    from the native plane, the stale ones 404 there, and the replaced
    checkpoint's blobs are unpinned (GC evicts them)."""
    n = nodes("port", _copy(pulled["port"], tmp_path / "c"),
              native="127.0.0.1", register=True)
    url = f"{n.proxy.url}/restore/{MODEL}/tensor"
    assert _req(f"{url}/layer.0.w")[0] == 200
    blob = tst.serialize({"renamed.w": np.full((8, 8), 3.0, np.float32)})
    n.store.put("reregnewckpt0001", blob, {})
    assert n.registry.register_safetensors(MODEL, ["reregnewckpt0001"]) == 1
    status, _, body = _req(f"{url}/renamed.w")
    assert status == 200 and body == np.full((8, 8), 3.0,
                                             np.float32).tobytes()
    for stale in ("layer.0.w", "layer.0.b", "layer.1.w", "layer.1.b"):
        assert _req(f"{url}/{stale}")[0] == 404, stale
    record = json.loads(n.store.get(tdelivery.manifest_key("hf", MODEL)))
    old = {f["key"] for f in record["files"]
           if f["name"].endswith(".safetensors")}
    n.store.gc(1)
    assert not any(n.store.has(k) for k in old)
    assert n.store.has("reregnewckpt0001")


def test_unregister_lets_gc_evict(pulled, nodes, tmp_path):
    n = nodes("port", _copy(pulled["port"], tmp_path / "c"),
              native="127.0.0.1", register=True)
    url = f"{n.proxy.url}/restore/{MODEL}/tensor/layer.0.w"
    keys = {loc.key for loc in n.registry._models[MODEL].values()}
    n.store.gc(1)
    assert all(n.store.has(k) for k in keys)  # pinned while registered
    assert _req(url)[0] == 200
    assert n.registry.unregister(MODEL) is True
    assert n.registry.unregister(MODEL) is False
    assert n.registry.models() == []
    assert _req(url)[0] == 404
    _, freed, evicted = n.store.gc(1)
    assert evicted >= len(keys) and freed > 0
    assert not any(n.store.has(k) for k in keys)


# ------------------------------------------------------------ push paths


def _reply_status(f) -> int:
    status = int(f.readline().split()[1])
    length = 0
    while (line := f.readline()) not in (b"\r\n", b""):
        k, _, v = line.decode().partition(":")
        if k.lower() == "content-length":
            length = int(v)
    f.read(length)
    return status


def _raw(port: int, head: bytes, body: bytes, half_close: bool = False,
         then: bytes | None = None) -> list[int]:
    """Statuses of the replies to ``head + body``, then to ``then`` on
    the same connection, sent on a raw socket; ``half_close`` ends the
    body early by shutting the write side."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        f = s.makefile("rb")
        s.sendall(head + body)
        if half_close:
            s.shutdown(socket.SHUT_WR)
        statuses = [_reply_status(f)]
        if then is not None:
            s.sendall(then)
            statuses.append(_reply_status(f))
        return statuses


def _put(path: str, body: bytes, length: int | None = None) -> bytes:
    n = len(body) if length is None else length
    return (f"PUT {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {n}\r\n\r\n"
            .encode())


def _push_sequence(n: Node, blob: bytes, digest: str) -> list:
    """One run of every push path; each reply's status (and its JSON for
    a 200)."""
    out = []

    def call(method, path, body=None, headers=None):
        status, _, reply = _req(n.url + path, method, body, headers)
        out.append((method, path.replace(digest, "D"), status,
                    json.loads(reply) if status == 200 else None))

    bad = "0" * 64
    call("GET", f"/restore/blob/{digest}")
    call("PUT", f"/restore/blob/{digest}", b"")                  # 411
    call("PUT", f"/restore/blob/{bad}", blob)                    # mismatch
    call("PUT", "/restore/blob/xyz", blob)                       # 404
    call("PUT", f"/restore/blob/{digest}", blob)                 # 200
    call("GET", f"/restore/blob/{digest}")
    call("PUT", f"/restore/blob/{digest}", blob)                 # held
    call("POST", f"/restore/{MODEL}-p/commit",
         json.dumps({"digests": [bad]}).encode())                # unknown
    call("GET", f"/restore/{MODEL}-p/manifest")                  # 404
    call("POST", f"/restore/{MODEL}-p/commit",
         json.dumps({"digests": []}).encode())                   # empty
    call("POST", f"/restore/{MODEL}-p/commit", b"not json")
    call("POST", f"/restore/{MODEL}-p/commit", b"")              # 411
    call("POST", f"/restore/{MODEL}-p/commit",
         json.dumps({"digests": [digest]}).encode())             # 200
    call("GET", f"/restore/{MODEL}-p/manifest")
    call("PUT", f"/restore/{MODEL}-w/safetensors", blob)         # 200
    call("PUT", f"/restore/{MODEL}-w/safetensors", b"junk" * 4)  # 400
    call("GET", f"/restore/{MODEL}-w/manifest")                  # gone? no
    call("PUT", f"/restore/{MODEL}-w/safetensors", b"")          # 411
    call("PUT", "/restore/nope", blob)                           # 404
    call("POST", "/nope", b"{}")                                 # 404
    call("GET", "/restore/models")
    # a body cut short: 400, and nothing is left in the store
    out.append(("truncated-blob", _raw(
        n.server.port, _put(f"/restore/blob/{'1' * 64}", blob,
                            len(blob) + 10), blob, half_close=True)))
    out.append(("truncated-safetensors", _raw(
        n.server.port, _put(f"/restore/{MODEL}-t/safetensors", blob,
                            len(blob) + 10), blob, half_close=True)))
    # a held blob's body is drained: the connection serves the next one
    out.append(("held-then-probe", _raw(
        n.server.port, _put(f"/restore/blob/{digest}", blob), blob,
        then=f"GET /restore/blob/{digest} HTTP/1.1\r\nHost: x\r\n\r\n"
        .encode())))
    return out


def test_push_paths_answer_as_the_reference(tmp_path, nodes):
    blob = tst.serialize({"w": np.arange(24, dtype=np.float32
                                         ).reshape(4, 6)})
    digest = hashlib.sha256(blob).hexdigest()
    runs = {}
    for pkg in PKG:
        n = nodes(pkg, tmp_path / pkg)
        runs[pkg] = _push_sequence(n, blob, digest)
        assert not n.store.has(key_for_uri(
            f"demodel://restore/tensor/{'1' * 64}"))
        assert not n.store.has(key_for_uri(
            f"demodel://restore/{MODEL}-t/pushed"))
        assert n.registry.models() == [f"{MODEL}-p", f"{MODEL}-w"]
    assert runs["port"] == runs["reference"]
    statuses = [r[2] if len(r) == 4 else r[1] for r in runs["port"]]
    assert statuses == [404, 411, 400, 404, 200, 200, 200, 400, 404, 400,
                        400, 411, 200, 200, 200, 400, 200, 411, 404, 404,
                        200, [400], [400], [200, 200]]


def test_save_dedups_across_packages(tmp_path, nodes):
    """The port's ``save_state_dict`` to a reference node, then the
    reference's ``save_pytree`` of the same values to a port node over
    the same store: every blob is held, nothing is sent."""
    from demodel_tpu.restore.orbax_http import save_pytree

    rng = np.random.default_rng(3)
    values = {"a.w": rng.standard_normal((16, 8)).astype(np.float32),
              "a.h": rng.standard_normal((4, 4)).astype(np.float16),
              "b.i": np.arange(6, dtype=np.int32).reshape(2, 3)}
    bf16 = torch.from_numpy(rng.standard_normal((8, 2)).astype(np.float32)
                            ).to(torch.bfloat16)
    sd = {k: torch.from_numpy(v) for k, v in values.items()} | {"c.b": bf16}
    ref = nodes("reference", tmp_path / "shared")
    port = nodes("port", tmp_path / "shared")
    assert save_state_dict(ref.url, "m1", sd) == {
        "tensors": 4, "pushed": 4, "skipped": 0,
        "sent_bytes": sum(len(tst.serialize({k: v})) for k, v in sd.items())}
    import jax.numpy as jnp

    tree = {k: jnp.asarray(v) for k, v in values.items()} | {
        "c.b": jnp.asarray(bf16.float().numpy(), dtype=jnp.bfloat16)}
    out = save_pytree(port.url, "m2", tree)
    assert out == {"tensors": 4, "pushed": 0, "skipped": 4, "sent_bytes": 0}
    assert save_state_dict(port.url, "m3", sd)["sent_bytes"] == 0
    for n, name in ((ref, "m1"), (port, "m2"), (port, "m3")):
        res = tclient.restore(n.url, name, mesh=make_mesh(device="cpu"))
        for k, v in sd.items():
            assert torch.equal(res.arrays[k], v), (name, k)


# ----------------------------------------------- /generate and /metrics


def test_generate_is_one_implementation(pulled, nodes):
    """503 with no engine (as the reference's node answers), then with a
    tiny engine booted the restore server's tokens equal
    ``serve/http.py``'s."""
    port = nodes("port", pulled["port"])
    ref = nodes("reference", pulled["reference"])
    doc = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 5}).encode()
    tserve.install(None)
    assert [_req(n.url + "/generate", "POST", doc)[::2] for n in
            (port, ref)] == [(503, b'{"error":"serving disabled '
                                   b'(no engine booted)"}')] * 2
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    engine = tserve.boot(params, cfg, device="cpu", max_batch=2,
                         queue_limit=4, max_new_tokens=8, kv_mb=4)
    gen = thttp.start()
    try:
        replies = [json.loads(_req(url + "/generate", "POST", doc)[2])
                   for url in (port.url, gen.url)]
    finally:
        gen.stop()
        tserve.install(None)
        engine.stop()
    assert replies[0]["tokens"] == replies[1]["tokens"]
    assert len(replies[0]["tokens"]) == 5
    assert replies[0]["tokens"] == [int(t) for t in tl.generate(
        params, cfg, [1, 2, 3], 5)[0]]


STORE_FAMILIES = ("demodel_store_objects", "demodel_store_bytes",
                  "demodel_store_evictions_total")


def _families(text: str) -> dict[str, str]:
    """The native proxy's and the store's families: name → type."""
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE ") and (
                line.split()[2].startswith("demodel_proxy_")
                or line.split()[2] in STORE_FAMILIES)}


def _route_timed(proxy, timeout_s: float = 10.0) -> None:
    """Wait until the native plane has timed a served request. It
    observes ``serve_request_seconds`` and ``serve_ttfb_seconds`` once
    the body is drained, which can land after the client has read it."""
    deadline = time.monotonic() + timeout_s
    while True:
        hist = proxy.metrics().get("hist", {})
        if all(hist.get(f, {}).get("routes") for f in
               ("serve_request_seconds", "serve_ttfb_seconds")):
            return
        assert time.monotonic() < deadline, hist
        time.sleep(0.01)


def test_metrics_render_matches_the_reference(pulled, nodes):
    """``render(proxy, store)`` over one store: the same
    ``demodel_proxy_*`` and store families (and types) as the
    reference's, equal store gauges, and ``/metrics`` on the node serves
    them."""
    ns = {pkg: nodes(pkg, pulled["port"], native="127.0.0.1",
                     register=True) for pkg in PKG}
    for n in ns.values():  # one restore-tensor request on each plane
        assert _req(f"{n.proxy.url}/restore/{MODEL}/tensor/layer.0.b"
                    )[0] == 200
        _route_timed(n.proxy)
    texts = {"port": tmetrics.render(proxy=ns["port"].proxy,
                                     store=ns["port"].store),
             "reference": jmetrics.render(proxy=ns["reference"].proxy,
                                          store=ns["reference"].store)}
    fams = {k: _families(t) for k, t in texts.items()}
    assert fams["port"] == fams["reference"]
    assert {*STORE_FAMILIES, "demodel_proxy_bytes_cache"} <= set(
        fams["port"])

    def gauges(text):
        return {line.split()[0]: line.split()[1]
                for line in text.splitlines()
                if line.split()[0] in STORE_FAMILIES}

    assert gauges(texts["port"]) == gauges(texts["reference"])
    assert gauges(texts["port"])["demodel_store_objects"] == \
        str(len(ns["port"].store.index()["keys"]))
    served = _req(ns["port"].url + "/metrics")[2].decode()
    assert set(_families(served)) == set(fams["port"])
    assert tmetrics.render() == tmetrics.render(None, None)


# ---------------------------------------------------------------- scrub


SCRUB_FAMILIES = ("scrub_objects_total", "scrub_bytes_total",
                  "scrub_mismatch_total", "scrub_passes_total",
                  "store_quarantined_total")


def test_scrubber_quarantines_as_the_reference(pulled, tmp_path,
                                               monkeypatch):
    """A flipped byte in one object of identical stores: each package's
    ``Scrubber.slice`` quarantines it with the same counts, and the
    object is gone from the store."""
    monkeypatch.setenv("DEMODEL_SCRUB_INTERVAL_SECS", "1")
    monkeypatch.setenv("DEMODEL_SCRUB_RATE_MB_S", "64")
    out = {}
    for pkg, (store_cls, *_), scrub, hub in (
            ("port", PKG["port"], tscrub, tmetrics.HUB),
            ("reference", PKG["reference"], jscrub, jmetrics.HUB)):
        root = _copy(pulled["port"] / "proxy", tmp_path / pkg)
        with store_cls(root) as store:
            victim = sorted(e["key"] for e in store.index()["keys"])[0]
            before = {f: hub.get(f) for f in SCRUB_FAMILIES}
        obj = root / "objects" / victim
        raw = bytearray(obj.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        obj.write_bytes(bytes(raw))
        with store_cls(root) as store:
            result = scrub.Scrubber(store).slice()
            assert not store.has(victim)
            # a quarantine by hand (as on a read that found EIO)
            other = sorted(e["key"] for e in store.index()["keys"])[0]
            by_hand = (store.quarantine(other), store.quarantine(other),
                       store.has(other))
        out[pkg] = (result, by_hand, {f: hub.get(f) - before[f]
                                      for f in SCRUB_FAMILIES})
    assert out["port"] == out["reference"]
    (wrapped, objs, _, mismatched), by_hand, delta = out["port"]
    assert wrapped and mismatched == 1 and objs > 1
    assert by_hand == (True, False, False)
    assert delta["scrub_mismatch_total"] == 1
    assert delta["store_quarantined_total"] == 2


def test_restore_server_runs_the_scrubber(tmp_path, monkeypatch):
    """``DEMODEL_SCRUB_INTERVAL_SECS`` set: ``start`` runs one scrubber
    for the store, ``stop`` stops it; unset, none runs."""
    with TStore(tmp_path / "s") as store:
        srv = tserver.RestoreServer(tserver.RestoreRegistry(store),
                                    host="127.0.0.1").start()
        srv.stop()
        assert tscrub.snapshot() == []
        monkeypatch.setenv("DEMODEL_SCRUB_INTERVAL_SECS", "30")
        srv = tserver.RestoreServer(tserver.RestoreRegistry(store),
                                    host="127.0.0.1").start()
        try:
            assert tscrub.snapshot() == [{
                "root": str(store.root), "running": True,
                "interval_secs": 30, "rate_mb_s": 8}]
        finally:
            srv.stop()
        assert tscrub.snapshot() == []


# ------------------------------------------------------------- /debug/*

OBS = {"port": (ttrace, tprofiler, tretention),
       "reference": (jtrace, jprofiler, jretention)}


@pytest.fixture()
def obs_env(monkeypatch, tmp_path):
    """Fresh trace state, no archive and no profiler in either package;
    the same on the way out."""
    for var in ("DEMODEL_TRACE", "DEMODEL_OBS", "DEMODEL_TELEMETRY_ARCHIVE"):
        monkeypatch.setenv(var, "")
    monkeypatch.setenv("DEMODEL_RECORDER_DIR", str(tmp_path))

    def reset():
        for tr, prof, ret in OBS.values():
            tr.reset()
            prof.stop()
            ret._reset_for_tests()

    reset()
    yield monkeypatch
    reset()


def _doc(node, path: str, **kw):
    status, headers, body = _req(f"{node.url}{path}", **kw)
    return status, headers.get("Content-Type"), body


def test_debug_routes_answer_as_the_reference(pulled, nodes, obs_env):
    """statusz, telemetry and profile answer 200 on both packages' nodes
    with the same keys; the history route 404s with the reference's body
    while no archive runs."""
    got = {}
    for pkg in PKG:
        n = nodes(pkg, pulled[pkg], register=True)
        statusz = _doc(n, "/debug/statusz")
        tele = _doc(n, "/debug/telemetry")
        prof = _doc(n, "/debug/profile?seconds=0.3&hz=97")
        collapsed = _doc(n, "/debug/profile?seconds=0&format=collapsed")
        history = _doc(n, "/debug/telemetry/history?family=x")
        got[pkg] = (statusz, tele, prof, collapsed, history)
    for pkg, (statusz, tele, prof, collapsed, history) in got.items():
        assert statusz[:2] == tele[:2] == prof[:2] == (200, "application/json")
        assert collapsed[:2] == (200, "text/plain; charset=utf-8")
        assert history[0] == 404
        doc = json.loads(statusz[2])
        assert doc["server"] == "restore" and doc["models"] == [MODEL]
        assert doc["statusz"] == 4 and doc["profiler"]["running"]
        p = json.loads(prof[2])
        assert p["server"] == "restore" and p["hz"] == 97
        assert p["samples"] > 0 and p["plane"] == "python"
        assert all(" " in line for line in
                   collapsed[2].decode().splitlines())
    port, ref = got["port"], got["reference"]
    assert port[4] == ref[4] == (
        404, "application/json",
        b'{"error":"no telemetry archive (set DEMODEL_TELEMETRY_ARCHIVE)"}')
    for i in range(3):
        assert sorted(json.loads(port[i][2])) == sorted(json.loads(ref[i][2]))
    assert sorted(json.loads(port[1][2])["windows"]) == \
        sorted(json.loads(ref[1][2])["windows"])


def test_profile_answers_503_under_obs_off(pulled, nodes, obs_env):
    obs_env.setenv("DEMODEL_OBS", "0")
    for tr, _, _ in OBS.values():
        tr.reset()
    replies = []
    for pkg in PKG:
        n = nodes(pkg, pulled[pkg])
        replies.append(_doc(n, "/debug/profile?seconds=0.1"))
        statusz = json.loads(_doc(n, "/debug/statusz")[2])
        assert statusz["trace"]["mode"] == "off"
        assert statusz["profiler"] is None and statusz["inflight_spans"] == []
    assert replies[0] == replies[1] == (
        503, "application/json",
        b'{"error":"profiler disabled (DEMODEL_OBS=0)"}')
    assert tprofiler.current() is None


def test_history_reads_the_archive_across_packages(pulled, nodes, obs_env,
                                                   tmp_path):
    """With ``DEMODEL_TELEMETRY_ARCHIVE`` set each node starts its
    package's archive at ``start``; the history route flushes, then
    answers the series; each package's history of the other's archive is
    the same document."""
    roots = {}
    for pkg in PKG:
        roots[pkg] = tmp_path / f"arch-{pkg}"
        obs_env.setenv("DEMODEL_TELEMETRY_ARCHIVE", str(roots[pkg]))
        n = nodes(pkg, pulled[pkg])
        ret = OBS[pkg][2]
        assert ret.current() is not None
        for _ in range(3):
            _req(f"{n.url}/restore/models")
            ret.current().flush_once()
            time.sleep(0.3)
        status, ctype, body = _doc(
            n, "/debug/telemetry/history?family=stage_duration_seconds"
               "&label=span=serve.restore")
        assert (status, ctype) == (200, "application/json")
        doc = json.loads(body)
        assert doc["server"] == "restore" and doc["records"] >= 1
        assert list(doc["series"]) == [
            'stage_duration_seconds{span="serve.restore"}']
        ret.current().stop()
    for root in roots.values():
        docs = [OBS[p][2].TelemetryArchive(root).history() for p in PKG]
        assert docs[0] == docs[1] and docs[0]["records"] >= 1


def _await_spans(tr, name: str, n: int, timeout_s: float = 10.0):
    """The first ``n`` finished ``name`` spans in ``tr``'s recorder (a
    server span finishes just after its response is written)."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = [r for r in tr.recorder().snapshot() if r["name"] == name]
        if len(got) >= n or time.monotonic() > deadline:
            return got[:n]
        time.sleep(0.01)


def test_serve_restore_joins_the_client_trace(pulled, nodes, obs_env):
    """A request carrying a W3C traceparent runs under a ``serve.restore``
    span of the client's trace, parented on the client's span, on both
    packages' nodes."""
    tp_trace, tp_span = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    for pkg in PKG:
        n = nodes(pkg, pulled[pkg])
        tr = OBS[pkg][0]
        assert _req(f"{n.url}/restore/models",
                    headers={"traceparent": f"00-{tp_trace}-{tp_span}-01"}
                    )[0] == 200
        _req(f"{n.url}/restore/models", headers={"traceparent": "junk"})
        mine = _await_spans(tr, "serve.restore", 2)
        joined = [r for r in mine if r["trace"] == tp_trace]
        fresh = [r for r in mine if r["trace"] != tp_trace]
        assert [r["parent"] for r in joined] == [tp_span]
        assert [r["parent"] for r in fresh] == [None]
        assert joined[0]["attrs"] == {"method": "GET",
                                      "path": "/restore/models"}


def test_generate_spans_join_the_client_trace(pulled, nodes, obs_env):
    """The engine thread files a request's prefill and decode steps under
    the server span of that request, so they join the client's trace."""
    tp_trace, tp_span = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    n = nodes("port", pulled["port"])
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    engine = tserve.boot(params, cfg, device="cpu", max_batch=2,
                         queue_limit=4, max_new_tokens=8, kv_mb=4)
    try:
        status, _, body = _req(
            n.url + "/generate", "POST",
            json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 4}).encode(),
            headers={"traceparent": f"00-{tp_trace}-{tp_span}-01"})
    finally:
        tserve.install(None)
        engine.stop()
    assert status == 200 and len(json.loads(body)["tokens"]) == 4
    (root,) = _await_spans(ttrace, "serve.restore", 1)
    assert (root["trace"], root["parent"]) == (tp_trace, tp_span)
    below = [r for r in ttrace.recorder().snapshot()
             if r["name"] in ("serve.admit", "serve.prefill",
                              "serve.decode-step")]
    assert sorted({r["name"] for r in below}) == [
        "serve.admit", "serve.decode-step", "serve.prefill"]
    assert all(r["trace"] == tp_trace and r["parent"] == root["span"]
               for r in below)
    assert sum(r["name"] == "serve.decode-step" for r in below) == 3


# ------------------------------------- traceparent on the peer requests


class _RecordingPeer:
    """A peer that serves one object on ``/peer/object/{key}`` (Range
    aware) and records each request's path, Range and traceparent."""

    def __init__(self, body: bytes):
        self.body = body
        self.seen: list[tuple[str, str | None, str | None]] = []
        peer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                return

            def do_GET(self):
                peer.seen.append((self.path, self.headers.get("Range"),
                                  self.headers.get("traceparent")))
                start, end = 0, len(peer.body)
                rng = self.headers.get("Range")
                if rng:
                    a, _, b = rng[len("bytes="):].partition("-")
                    start, end = int(a), (int(b) + 1 if b else end)
                data = peer.body[start:end]
                self.send_response(206 if rng else 200)
                if rng:
                    self.send_header("Content-Range", f"bytes {start}-"
                                     f"{end - 1}/{len(peer.body)}")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("pkg", list(PKG))
def test_peer_requests_carry_the_traceparent(pkg, tmp_path, obs_env):
    """``parallel/peer``'s streamed object GET and ``sink/remote``'s
    window GET (the Python transports) carry the ambient span's
    traceparent, in both packages."""
    tr = OBS[pkg][0]
    peer_mod, remote_mod = ((tpeer, tremote) if pkg == "port"
                            else (jpeer, jremote))
    store_cls = PKG[pkg][0]
    body = np.random.default_rng(3).bytes(100_000)
    key = key_for_uri("https://hub.example/org/m/resolve/main/w.bin")
    fake = _RecordingPeer(body)
    try:
        with store_cls(tmp_path / "s") as store, tr.span("pull") as root:
            peer_mod.PeerSet([fake.url])._stream_object_into(
                store, fake.url, key, key, hashlib.sha256(body).hexdigest(),
                {"uri": "x", "size": len(body)})
            assert store.get(key) == body
            reader = remote_mod.PeerBlobReader(fake.url, key, len(body))
            out = np.empty(4096, dtype=np.uint8)
            assert reader.pread_into(key, out, 1000) == 4096
            assert out.tobytes() == body[1000:5096]
    finally:
        fake.close()
    spans = {r["name"]: r for r in tr.recorder().snapshot()}
    (obj_path, obj_range, obj_tp), (win_path, win_range, win_tp) = fake.seen
    assert obj_path == f"/peer/object/{key}" and obj_range is None
    assert win_range == "bytes=1000-5095"
    assert tr.parse_traceparent(obj_tp) == (root.trace_id,
                                            spans["peer-stream"]["span"])
    assert tr.parse_traceparent(win_tp) == (root.trace_id,
                                            spans["window-read"]["span"])


def test_native_profile_and_telemetry_equal_the_reference(pulled, nodes,
                                                          obs_env):
    """``ProxyServer.profile`` over ``dm_proxy_profile`` answers as the
    reference's wrapper (JSON and collapsed), and with the native plane
    attached ``/debug/telemetry`` carries its scrape-diffed mirror."""
    got = {}
    for pkg in PKG:
        n = nodes(pkg, pulled[pkg], native="127.0.0.1", register=True)
        for _ in range(3):
            _req(f"{n.proxy.url}/restore/{MODEL}/tensor/"
                 f"model.embed_tokens.weight")
        prof = n.proxy.profile(seconds=0.3, hz=200)
        collapsed = n.proxy.profile(seconds=0.0, fmt="collapsed")
        tele = json.loads(_doc(n, "/debug/telemetry")[2])
        got[pkg] = (prof, collapsed, tele)
    for prof, collapsed, tele in got.values():
        assert prof["plane"] == "native" and prof["samples"] >= 0
        assert isinstance(collapsed, str)
        assert all(" " in line for line in collapsed.splitlines())
        assert sorted(tele) == ["native", "pid", "server", "telemetry",
                                "time", "windows"]
    port, ref = got["port"], got["reference"]
    assert sorted(port[0]) == sorted(ref[0])
    assert sorted(port[2]["native"]) == sorted(ref[2]["native"])
