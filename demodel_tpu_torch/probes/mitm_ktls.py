"""Probe: does a client's TLS session through the port's MITM proxy come
up with the native plane's kernel-TLS option on (``DEMODEL_PROXY_KTLS``
unset) and off (``=0``)?

The native plane asks OpenSSL for kTLS (``SSL_OP_ENABLE_KTLS``) before
each client handshake when ``setsockopt(TCP_ULP, "tls")`` on a fresh
socket does not answer ENOENT, ENOPROTOOPT or EINVAL
(``native/proxy.cc`` ``Proxy::ktls_available``). A kernel can pass that
test and still break the handshake. The probe serves one small file from
an in-process ``http.server`` over TLS (a CA and a 127.0.0.1 leaf from the
port's ``pki``), puts the port's ``ProxyServer`` in front of it with
MITM, and fetches the file through it with ``urllib`` once per variant:
kTLS on and off, each with the client's TLS capped at 1.3 (the default)
and at 1.2. Run from the repo root::

    python -m demodel_tpu_torch.probes.mitm_ktls

It prints the kernel's release and TCP ULP list, then one JSON line per
variant (the body's length or the client's error, the proxy's ``mitm``
and ``errors`` counters), and exits 0: a failure is a result.
"""

from __future__ import annotations

import json
import os
import ssl
import tempfile
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from demodel_tpu_torch import pki
from demodel_tpu_torch.config import ProxyConfig
from demodel_tpu_torch.proxy import ProxyServer

BODY = b"probe-" * 1024


class _Origin(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(BODY)))
        self.end_headers()
        self.wfile.write(BODY)


class ViaProxy(urllib.request.ProxyHandler):
    """Every request of an opener through the proxy at ``url`` (HTTPS by
    CONNECT), whatever ``no_proxy`` says."""

    def __init__(self, url: str):
        super().__init__({"http": url, "https": url})

    def proxy_open(self, req, proxy, type):
        req.set_proxy(urllib.parse.urlsplit(proxy).netloc, "http")
        return None  # the HTTP(S) handler opens the tunnel


def origin_context(tls_dir: Path, host: str = "127.0.0.1"
                   ) -> tuple[ssl.SSLContext, Path]:
    """A server context for ``host`` with a CA (P-256) and a leaf minted
    by the port's ``pki`` under ``tls_dir``; and the CA's file."""
    ca = pki.read_or_new_ca(tls_dir, use_ecdsa=True)
    chain, key = pki.LeafMinter(ca, tls_dir, use_ecdsa=True).fetch(host)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(chain, key)
    return ctx, pki.ca_paths(tls_dir)[0]


def _fetch(proxy: ProxyServer, ca_file: Path, url: str, tls12: bool):
    ctx = ssl.create_default_context(cafile=str(ca_file))
    if tls12:
        ctx.maximum_version = ssl.TLSVersion.TLSv1_2
    opener = urllib.request.build_opener(
        ViaProxy(proxy.url), urllib.request.HTTPSHandler(context=ctx))
    try:
        with opener.open(url, timeout=30) as r:
            return len(r.read())
    except OSError as e:  # a failed session is the result
        return f"{type(e).__name__}: {e}"


def main() -> int:
    ulp = Path("/proc/sys/net/ipv4/tcp_available_ulp")
    print(json.dumps({"kernel": os.uname().release,
                      "tcp_available_ulp": ulp.read_text().strip()
                      if ulp.exists() else None,
                      "openssl": pki.openssl_version()}), flush=True)
    root = Path(tempfile.mkdtemp(prefix="mitm-ktls-"))
    sctx, origin_ca = origin_context(root / "origin")
    origin = ThreadingHTTPServer(("127.0.0.1", 0), _Origin)
    origin.socket = sctx.wrap_socket(origin.socket, server_side=True)
    threading.Thread(target=origin.serve_forever, daemon=True).start()
    authority = f"127.0.0.1:{origin.server_port}"
    before = os.environ.get("DEMODEL_PROXY_KTLS")
    try:
        for i, (ktls, tls12) in enumerate([(None, False), (None, True),
                                           ("0", False), ("0", True)]):
            if ktls is None:
                os.environ.pop("DEMODEL_PROXY_KTLS", None)
            else:
                os.environ["DEMODEL_PROXY_KTLS"] = ktls
            cfg = ProxyConfig(host="127.0.0.1", port=0,
                              cache_dir=root / f"cache{i}",
                              data_dir=root / f"data{i}",
                              mitm_hosts=[authority], use_ecdsa=True)
            with ProxyServer(cfg, upstream_ca=str(origin_ca),
                             verbose=False) as proxy:
                got = _fetch(proxy, pki.ca_paths(cfg.data_dir)[0],
                             f"https://{authority}/x", tls12)
                m = proxy.metrics()
            print(json.dumps({"DEMODEL_PROXY_KTLS": ktls,
                              "client_max_tls": "1.2" if tls12 else "1.3",
                              "ok": got == len(BODY), "got": got,
                              "mitm": m.get("mitm"),
                              "errors": m.get("errors")}), flush=True)
    finally:
        if before is None:
            os.environ.pop("DEMODEL_PROXY_KTLS", None)
        else:
            os.environ["DEMODEL_PROXY_KTLS"] = before
        origin.shutdown()
        origin.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
