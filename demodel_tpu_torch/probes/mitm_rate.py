"""Probe: what sets a client's rate through the port's MITM proxy — the
loopback stream, TLS, or the proxy and its store?

One body of ``--mb`` MiB of seeded bytes is served by an in-process
``http.server``, once over plain HTTP and once over TLS (a CA and a
127.0.0.1 leaf from the port's ``pki``), each path a fresh object. One
``urllib`` client, hashing the body as it streams (as ``chip_smoke.py``'s
mitm phase does), fetches it on one connection:

- ``direct_http`` and ``direct_https``: no proxy;
- ``proxy_http``: through the port's ``ProxyServer`` in absolute form
  (cached, no TLS);
- ``mitm_cold``: through it by CONNECT, intercepted (TLS on both legs,
  cached), after one tiny request has minted the host's leaf;
- ``mitm_warm``: the same URL again, answered from the store over TLS.

Run from the repo root::

    python -m demodel_tpu_torch.probes.mitm_rate [--mb 512]

It prints one JSON line per leg (seconds, GB/s, whether the sha256
matched, the proxy's cache header) and exits 0. The proxy reads
``DEMODEL_PROXY_KTLS`` as always (see ``probes/mitm_ktls.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import ssl
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from demodel_tpu_torch import pki
from demodel_tpu_torch.config import ProxyConfig
from demodel_tpu_torch.probes.mitm_ktls import ViaProxy, origin_context
from demodel_tpu_torch.proxy import ProxyServer


def _handler(body: memoryview):
    class Origin(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            out = body[:1] if self.path == "/mint" else body
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    return Origin


def _serve(handler, ctx=None) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    if ctx is not None:
        server.socket = ctx.wrap_socket(server.socket, server_side=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _leg(name: str, opener, url: str, want: str, nbytes: int) -> None:
    sha, n = hashlib.sha256(), 0
    t0 = time.perf_counter()
    with opener.open(url, timeout=600) as r:
        cache = r.headers.get("X-Demodel-Cache")
        while part := r.read(16 << 20):
            sha.update(part)
            n += len(part)
    secs = time.perf_counter() - t0
    print(json.dumps({"leg": name, "bytes": n, "secs": secs,
                      "GBps": n / secs / 1e9, "cache": cache,
                      "sha256_ok": n == nbytes and sha.hexdigest() == want}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=512)
    args = ap.parse_args()
    nbytes = args.mb << 20
    body = memoryview(np.random.default_rng(0).integers(
        0, 256, nbytes, dtype=np.uint8).data)
    want = hashlib.sha256(body).hexdigest()
    root = Path(tempfile.mkdtemp(prefix="mitm-rate-"))
    sctx, origin_ca = origin_context(root / "origin")
    plain, tls = _serve(_handler(body)), _serve(_handler(body), sctx)
    http_base = f"http://127.0.0.1:{plain.server_port}"
    tls_auth = f"127.0.0.1:{tls.server_port}"
    cfg = ProxyConfig(host="127.0.0.1", port=0, cache_dir=root / "cache",
                      data_dir=root / "data", mitm_hosts=[tls_auth])
    proxy = ProxyServer(cfg, upstream_ca=str(origin_ca),
                        verbose=False).start()
    try:
        direct = urllib.request.build_opener(
            urllib.request.ProxyHandler({}), urllib.request.HTTPSHandler(
                context=ssl.create_default_context(cafile=str(origin_ca))))
        via = urllib.request.build_opener(
            ViaProxy(proxy.url),
            urllib.request.HTTPSHandler(context=ssl.create_default_context(
                cafile=str(pki.ca_paths(cfg.data_dir)[0]))))
        _leg("direct_http", direct, f"{http_base}/a", want, nbytes)
        _leg("direct_https", direct, f"https://{tls_auth}/a", want, nbytes)
        _leg("proxy_http", via, f"{http_base}/b", want, nbytes)
        via.open(f"https://{tls_auth}/mint", timeout=60).close()  # the leaf
        _leg("mitm_cold", via, f"https://{tls_auth}/c", want, nbytes)
        time.sleep(2.0)  # the fill's commit
        _leg("mitm_warm", via, f"https://{tls_auth}/c", want, nbytes)
    finally:
        proxy.stop()
        for s in (plain, tls):
            s.shutdown()
            s.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
