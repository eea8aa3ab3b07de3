"""The native proxy over the port's store library (the port of
``demodel_tpu/proxy.py``), for a node that serves its store to peers.

A :class:`ProxyServer` with ``no_mitm=True`` tunnels CONNECTs untouched
and serves the content-addressed store under ``cfg.cache_dir / "proxy"``
on ``/peer/index``, ``/peer/meta/{key}`` and ``/peer/object/{key}``
(range-aware, from ``native/proxy.cc``), which is what
:class:`~demodel_tpu_torch.parallel.peer.PeerSet` reads. Intercepting
TLS (MITM) needs leaf certificates minted by the JAX package's
``pki.py`` on ``cryptography``, which the port does not take: asking for
it raises ``NotImplementedError`` (``ROADMAP.md`` Queue A).
"""

from __future__ import annotations

import ctypes
import json

from demodel_tpu_torch import native
from demodel_tpu_torch.config import ProxyConfig
from demodel_tpu_torch.utils.env import env_int

#: where MITM in the port stands
MITM_ROADMAP = ("MITM in the port's proxy (leaf minting through pki.py) is "
                "not ported yet: ROADMAP.md Queue A")


class ProxyServer:
    """One native proxy instance serving ``cfg``'s store to peers."""

    def __init__(self, cfg: ProxyConfig, session_threads: int | None = None):
        if not cfg.no_mitm:
            raise NotImplementedError(
                f"{MITM_ROADMAP}; a peer-serving node runs with "
                "ProxyConfig(no_mitm=True)")
        self.cfg = cfg
        self._lib = native.lib()
        store_root = str(cfg.cache_dir / "proxy") if cfg.cache_enabled else ""
        # no MITM, so no intercepted hosts, leaf minter, upstream CA or
        # upstream fill: 0 and -1 keep the native side's defaults for the
        # rest; session_threads 0 lets the native side pick (2 × CPUs)
        self._h = self._lib.dm_proxy_new(
            cfg.host.encode(), cfg.port, 0, 1, b"", store_root.encode(), b"",
            1 if cfg.cache_enabled else 0, None, 0, 0, 0,
            env_int("DEMODEL_CACHE_MAX_GB", 0) << 10,  # → MB; 0 = unbounded
            1, -1, -1, -1, session_threads or 0, 0, -1, 0)
        if not self._h:
            raise OSError("proxy allocation failed")

    def start(self) -> "ProxyServer":
        rc = self._lib.dm_proxy_start(self._h)
        if rc != 0:
            raise OSError(-rc, "proxy start failed")
        return self

    @property
    def port(self) -> int:
        return self._lib.dm_proxy_port(self._h)

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.cfg.host in ("0.0.0.0", "") else \
            self.cfg.host
        return f"http://{host}:{self.port}"

    def metrics(self) -> dict:
        """The native plane's counters (``serve_bytes_total`` and the
        rest)."""
        cap = 8192
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.dm_proxy_metrics(self._h, buf, cap)
            if n < cap:
                return json.loads(buf.value.decode())
            cap = n + 1

    def stop(self) -> None:
        if self._h:
            self._lib.dm_proxy_stop(self._h)
            self._lib.dm_proxy_free(self._h)
            self._h = None

    def __enter__(self) -> "ProxyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
