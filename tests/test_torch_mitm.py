"""Port parity: the MITM caching proxy of ``demodel_tpu_torch`` (its
``ProxyServer`` with the port's libcrypto PKI behind the native plane)
against ``demodel_tpu``'s, on the CPU.

Each case runs one request sequence through both packages' proxies side
by side, against one loopback TLS upstream (``tests/servers.FakeUpstream``
with ``tests/test_proxy_e2e.py``'s origin). Each client trusts only its
own proxy's CA, so every answered HTTPS request proves that proxy's
minted leaf. The legs are ``tests/test_proxy_e2e.py``'s: a miss then a
hit, a hit after the upstream died, HEAD, plain HTTP, tunnelled versus
intercepted hosts, ``mitm_all``, ``no_mitm``, the HF metadata headers,
the auth-scoped cache and Range. Held at each step: the two answers'
status, body and cache headers are equal; after each leg: the two stores
hold the same keys with the same sizes, sha256 and meta (the upstream's
``Date`` header aside).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import pytest
import requests

from demodel_tpu import pki as jpki
from demodel_tpu.config import ProxyConfig as JConfig
from demodel_tpu.proxy import ProxyServer as JProxy
from demodel_tpu_torch import pki as tpki
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.proxy import ProxyServer as TProxy
from demodel_tpu_torch.store import Store as TStore

from .servers import FakeUpstream
from .test_proxy_e2e import _BODY, _Handler

#: the response headers held equal between the packages
HEADERS = ("X-Demodel-Cache", "Content-Length", "Content-Range", "ETag",
           "X-Linked-Etag", "X-Linked-Size", "X-Repo-Commit")


@dataclass
class Pair:
    up: FakeUpstream
    proxies: dict
    sessions: dict
    stores: dict
    base: str

    def drive(self, method: str, url: str, **kw) -> tuple:
        """``method url`` through both proxies; asserts the answers are
        equal and returns it as (status, body, headers)."""
        out = {}
        for pkg, s in self.sessions.items():
            r = s.request(method, url, timeout=30, **kw)
            out[pkg] = (r.status_code, r.content,
                        {h: r.headers.get(h) for h in HEADERS})
        assert out["port"] == out["reference"], out
        return out["port"]


def _view(root) -> dict:
    """key → (size, sha256, meta without the upstream's Date header)."""
    with TStore(root) as s:
        out = {}
        for k in s.list():
            meta = s.meta(k) or {}
            meta.get("headers", {}).pop("date", None)
            out[k] = (s.size(k), meta.get("sha256"), meta)
        return out


def _settled_views(pair: Pair) -> tuple[dict, dict]:
    """Both stores' views once they agree (a fill may commit after the
    client's last byte), or as they stand after 10 s."""
    deadline = time.monotonic() + 10
    while True:
        views = tuple(_view(r) for r in pair.stores.values())
        if views[0] == views[1] or time.monotonic() > deadline:
            return views
        time.sleep(0.05)


@pytest.fixture()
def make_pair(tmp_path, monkeypatch):
    """``make_pair(**cfg)``: a TLS upstream and both packages' proxies
    over it, each with its own store and CA (ECDSA), the upstream's
    authority the intercepted host unless ``cfg`` says otherwise."""
    for var in ("REQUESTS_CA_BUNDLE", "CURL_CA_BUNDLE"):
        monkeypatch.delenv(var, raising=False)
    _Handler.hits = {}
    started = []

    def make(**overrides) -> Pair:
        up = FakeUpstream(handler=_Handler, tls_dir=tmp_path / "hubca")
        up.start()
        started.append(up)
        proxies, sessions, stores = {}, {}, {}
        for pkg, Config, Proxy, pki in (
                ("reference", JConfig, JProxy, jpki),
                ("port", TConfig, TProxy, tpki)):
            kw = dict(host="127.0.0.1", port=0, mitm_hosts=[up.authority],
                      cache_dir=tmp_path / pkg / "cache",
                      data_dir=tmp_path / pkg / "data", use_ecdsa=True)
            kw.update(overrides)
            cfg = Config(**kw)
            proxy = Proxy(cfg, upstream_ca=str(up.ca_path), verbose=False)
            proxy.start()
            started.append(proxy)
            s = requests.Session()
            s.proxies = {"https": proxy.url, "http": proxy.url}
            s.verify = str(pki.ca_paths(cfg.data_dir)[0])
            proxies[pkg], sessions[pkg] = proxy, s
            stores[pkg] = cfg.cache_dir / "proxy"
        return Pair(up, proxies, sessions, stores, f"https://{up.authority}")

    yield make
    for thing in reversed(started):
        thing.stop()


def _same_stores(pair: Pair) -> dict:
    jview, tview = _settled_views(pair)
    assert tview == jview
    return tview


def test_miss_then_hit(make_pair):
    p = make_pair()
    assert p.drive("GET", f"{p.base}/blob") == (200, _BODY, {
        **dict.fromkeys(HEADERS), "X-Demodel-Cache": "MISS",
        "Content-Length": str(len(_BODY)), "ETag": '"blob-v1"'})
    status, body, h = p.drive("GET", f"{p.base}/blob")
    assert (status, body, h["X-Demodel-Cache"]) == (200, _BODY, "HIT")
    assert p.drive("GET", f"{p.base}/chunked")[1] == b"alpha-beta-gamma"
    assert p.drive("GET", f"{p.base}/chunked")[2]["X-Demodel-Cache"] == "HIT"
    # one upstream fetch per proxy, the rest from each store
    assert _Handler.hits["/blob"] == _Handler.hits["/chunked"] == 2
    view = _same_stores(p)
    assert sorted(size for size, _, _ in view.values()) == [16, len(_BODY)]
    for pkg, proxy in p.proxies.items():
        assert proxy.metrics()["mitm"] >= 1, pkg


def test_hit_after_the_upstream_died(make_pair):
    p = make_pair()
    assert p.drive("GET", f"{p.base}/blob")[0] == 200
    p.up.stop()
    status, body, h = p.drive("GET", f"{p.base}/blob")
    assert (status, body, h["X-Demodel-Cache"]) == (200, _BODY, "HIT")
    _same_stores(p)


def test_head(make_pair):
    p = make_pair()
    p.drive("GET", f"{p.base}/blob")
    status, body, h = p.drive("HEAD", f"{p.base}/blob")
    assert (status, body, h["X-Demodel-Cache"]) == (200, b"", "HIT")
    assert int(h["Content-Length"]) == len(_BODY)
    _same_stores(p)


def test_plain_http(make_pair):
    p = make_pair()
    with FakeUpstream(handler=_Handler) as plain:
        status, body, _ = p.drive("GET",
                                  f"http://{plain.authority}/echo-plain")
    assert (status, body) == (200, b"echo:/echo-plain")
    _same_stores(p)


def test_tunnel_versus_intercepted_hosts(make_pair, tmp_path):
    """An authority off the list is tunnelled: a client trusting only the
    proxy's CA fails TLS, one trusting the origin's CA gets through, and
    nothing of it is cached; the listed one is intercepted."""
    p = make_pair()
    with FakeUpstream(handler=_Handler, tls_dir=tmp_path / "other") as other:
        for pkg, s in p.sessions.items():
            with pytest.raises(requests.exceptions.SSLError):
                s.get(f"https://{other.authority}/echo", timeout=30)
        status, body, h = p.drive("GET", f"https://{other.authority}/echo",
                                  verify=str(other.ca_path))
        assert (status, body, h["X-Demodel-Cache"]) == (200, b"echo:/echo",
                                                        None)
    assert p.drive("GET", f"{p.base}/echo-mitm")[2]["X-Demodel-Cache"] == \
        "MISS"
    view = _same_stores(p)
    assert [m["uri"] for _, _, m in view.values()] == [f"{p.base}/echo-mitm"]


def test_mitm_all(make_pair):
    p = make_pair(mitm_all=True, mitm_hosts=[])
    status, body, _ = p.drive("GET", f"{p.base}/blob")
    assert (status, body) == (200, _BODY)
    assert len(_same_stores(p)) == 1


def test_no_mitm_wins_over_everything(make_pair):
    p = make_pair(no_mitm=True, mitm_all=True)
    status, body, h = p.drive("GET", f"{p.base}/echo",
                              verify=str(p.up.ca_path))
    assert (status, body, h["X-Demodel-Cache"]) == (200, b"echo:/echo", None)
    assert _same_stores(p) == {}
    for pkg, proxy in p.proxies.items():
        assert proxy.ca is None, pkg


def test_hf_metadata_headers_survive_the_cache(make_pair):
    p = make_pair()
    p.drive("GET", f"{p.base}/meta")
    _, _, h = p.drive("HEAD", f"{p.base}/meta")
    assert h["X-Demodel-Cache"] == "HIT"
    assert h["X-Linked-Etag"] == '"' + "ab" * 32 + '"'
    assert (h["X-Linked-Size"], h["X-Repo-Commit"]) == ("9", "c0ffee")
    _same_stores(p)


def test_auth_scoped_cache(make_pair):
    """Each credential gets its own entry; an anonymous client goes
    upstream (401), never to the cache."""
    p = make_pair()
    url = f"{p.base}/private"
    a = p.drive("GET", url, headers={"Authorization": "Bearer tok-a"})
    assert a[1] == b"secret-for-Bearer tok-a"
    assert p.drive("GET", url, headers={"Authorization": "Bearer tok-a"}
                   )[2]["X-Demodel-Cache"] == "HIT"
    b = p.drive("GET", url, headers={"Authorization": "Bearer tok-b"})
    assert b[1] == b"secret-for-Bearer tok-b"
    assert p.drive("GET", url)[0] == 401
    view = _same_stores(p)
    scopes = {m.get("auth_scope") for _, _, m in view.values()}
    assert len(view) == 2 and None not in scopes and len(scopes) == 2


def test_range(make_pair):
    """A cold Range fills the whole object; warm Ranges come from it."""
    p = make_pair()
    status, body, h = p.drive("GET", f"{p.base}/blob",
                              headers={"Range": "bytes=1000-1999"})
    assert (status, body) == (206, _BODY[1000:2000])
    assert h["X-Demodel-Cache"] in ("FILL", "FILL-ATTACH")
    _same_stores(p)
    status, body, h = p.drive("GET", f"{p.base}/blob",
                              headers={"Range": "bytes=100-199"})
    assert (status, body) == (206, _BODY[100:200])
    assert h["Content-Range"] == f"bytes 100-199/{len(_BODY)}"
    assert h["X-Demodel-Cache"] == "HIT"
    assert p.drive("GET", f"{p.base}/blob")[1] == _BODY
    assert _Handler.hits["/blob"] == 2
    view = _same_stores(p)
    assert [size for size, _, _ in view.values()] == [len(_BODY)]
