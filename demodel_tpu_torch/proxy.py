"""The MITM caching proxy: the native data plane (``native/proxy.cc``)
over the port's store library, with the port's PKI behind it (the port
of ``demodel_tpu/proxy.py``).

CONNECTs to the intercepted authorities (``ProxyConfig.mitm_hosts``,
``mitm_all``) are terminated with a leaf certificate for the host: the
native plane calls :data:`_MINT_CB` the first time it sees a host, which
mints through :class:`~demodel_tpu_torch.pki.LeafMinter`, then caches
the ``SSL_CTX`` natively. Responses are cached in the content-addressed
store under ``cfg.cache_dir / "proxy"``; other authorities are tunnelled
untouched. The same port serves the store to peers on ``/peer/index``,
``/peer/meta/{key}`` and ``/peer/object/{key}`` (range-aware), which is
what :class:`~demodel_tpu_torch.parallel.peer.PeerSet` reads, and
``/restore/{model}/tensor/{name}`` (range-aware) for the tensors a
restore registry mirrors into it (:meth:`ProxyServer.register_tensor`).
A ``no_mitm`` node intercepts nothing and needs no PKI.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading

from demodel_tpu_torch import native
from demodel_tpu_torch.config import ProxyConfig
from demodel_tpu_torch.utils.env import env_int

#: the leaf-mint callback (``native/proxy.h`` ``MintCb``): the host, then
#: two buffers of ``cap`` bytes that receive the NUL-terminated chain and
#: key file paths; nonzero is a mint failure (the CONNECT is answered 502)
_MINT_CB = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_char_p,                 # host
    ctypes.POINTER(ctypes.c_char),   # cert path out
    ctypes.POINTER(ctypes.c_char),   # key path out
    ctypes.c_int,                    # buffer cap
)


class ProxyServer:
    """Owns a native proxy instance, and the CA and minter that feed it."""

    def __init__(
        self,
        cfg: ProxyConfig,
        upstream_ca: str | None = None,
        verbose: bool = True,
        io_timeout_sec: int = 75,
        max_body_mb: int = 64,
        session_threads: int | None = None,
        session_queue: int | None = None,
        reactor: bool | None = None,
        max_conns: int | None = None,
    ):
        self.cfg = cfg
        if upstream_ca is None:
            upstream_ca = cfg.upstream_ca
        self._lib = native.lib()
        self._stop_evt = threading.Event()

        if cfg.no_mitm:
            # a tunnel or peer-serving node never mints a leaf
            self.ca = None
            self._minter = None
            self._mint_cb = None
        else:
            from demodel_tpu_torch import pki

            self.ca = pki.read_or_new_ca(cfg.data_dir, use_ecdsa=cfg.use_ecdsa)
            self._minter = pki.LeafMinter(self.ca, cfg.data_dir,
                                          use_ecdsa=cfg.use_ecdsa)

            def _mint(host: bytes, cert_out, key_out, cap: int) -> int:
                try:
                    cert, key = self._minter.fetch(host.decode())
                    cb = cert.encode() + b"\0"
                    kb = key.encode() + b"\0"
                    if len(cb) > cap or len(kb) > cap:
                        return -1
                    ctypes.memmove(cert_out, cb, len(cb))
                    ctypes.memmove(key_out, kb, len(kb))
                    return 0
                except Exception:  # noqa: BLE001 — crossing the C boundary
                    return -1

            # keep a reference: the native side holds this pointer for the
            # proxy's lifetime
            self._mint_cb = _MINT_CB(_mint)

        store_root = str(cfg.cache_dir / "proxy") if cfg.cache_enabled else ""
        self._h = self._lib.dm_proxy_new(
            cfg.host.encode(),
            cfg.port,
            1 if cfg.mitm_all else 0,
            1 if cfg.no_mitm else 0,
            ",".join(cfg.mitm_hosts).encode(),
            store_root.encode(),
            (upstream_ca or "").encode(),
            1 if cfg.cache_enabled else 0,
            ctypes.cast(self._mint_cb, ctypes.c_void_p)
            if self._mint_cb is not None else None,
            1 if verbose else 0,
            io_timeout_sec,
            env_int("DEMODEL_MAX_BODY_MB", max_body_mb),
            env_int("DEMODEL_CACHE_MAX_GB", 0) << 10,  # → MB; 0 = unbounded
            0 if os.environ.get("DEMODEL_RANGED_FILL", "").strip().lower()
            in ("0", "false", "no", "off") else 1,
            env_int("DEMODEL_FILL_MAX_MB", 512),
            env_int("DEMODEL_FILL_MIN_PCT", 5),
            env_int("DEMODEL_CHALLENGE_TTL_S", 86400),
            # the session pool: an explicit value wins, 0 lets the native
            # side resolve DEMODEL_PROXY_THREADS / DEMODEL_PROXY_QUEUE, then
            # 2 × CPUs
            session_threads if session_threads is not None else 0,
            session_queue if session_queue is not None else 0,
            # the event-driven serve plane: None → -1 lets the native side
            # resolve DEMODEL_PROXY_REACTOR (on by default); max_conns None
            # → 0 resolves DEMODEL_PROXY_MAX_CONNS (4096)
            (-1 if reactor is None else (1 if reactor else 0)),
            max_conns if max_conns is not None else 0,
        )
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

    def register_tensor(self, model: str, tensor: str, key: str,
                        start: int, nbytes: int) -> None:
        """Serve the byte window ``[start, start + nbytes)`` of stored
        object ``key`` as ``GET /restore/{model}/tensor/{tensor}`` on the
        proxy port (Range-aware, by sendfile). The entry pins ``key`` in
        the plane's own store; a same-name entry is replaced atomically."""
        self._lib.dm_proxy_register_tensor(
            self._h, f"{model}/{tensor}".encode(), key.encode(), start,
            nbytes)

    def unregister_model(self, model: str) -> None:
        """Drop every ``model/*`` entry and its pin (full teardown). A
        re-registration registers the new set and then drops the stale
        names with :meth:`unregister_tensor` instead, so kept tensors
        never 404."""
        self._lib.dm_proxy_unregister_model(self._h, model.encode())

    def unregister_tensor(self, model: str, tensor: str) -> None:
        """Drop one entry and its pin."""
        self._lib.dm_proxy_unregister_tensor(
            self._h, f"{model}/{tensor}".encode())

    def metrics(self) -> dict:
        """The native plane's counters (``mitm``, ``serve_bytes_total``
        and the rest)."""
        cap = 8192
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.dm_proxy_metrics(self._h, buf, cap)
            if n < cap:
                return json.loads(buf.value.decode())
            cap = n + 1

    def wait(self) -> None:
        """Block until :meth:`stop`."""
        self._stop_evt.wait()

    def stop(self) -> None:
        if self._h:
            self._lib.dm_proxy_stop(self._h)
            self._lib.dm_proxy_free(self._h)
            self._h = None
        self._stop_evt.set()

    def __enter__(self) -> "ProxyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
