"""``/generate`` and ``/metrics`` over HTTP, without a restore registry:
the token-serving route of :mod:`demodel_tpu_torch.restore.server` (one
implementation, :class:`~demodel_tpu_torch.restore.server.BaseHandler`)
on a ``ThreadingHTTPServer`` of its own.

- ``POST /generate`` ``{"prompt": [ids], "max_new_tokens": n,
  "stream": bool, "timeout": s}`` against the process-wide engine
  (:func:`demodel_tpu_torch.serve.current`): a JSON reply, or with
  ``stream`` a chunked NDJSON stream (one ``{"token": id}`` line per
  token, then a ``{"done": true, ...}`` line). 503 + ``Retry-After`` on
  queue overflow, 503 with no engine booted, 400 on a bad body, 411
  without a length, 413 past 8 MiB, 504 on timeout — each outcome counted
  in ``gen_http_total{code=}``.
- ``GET /metrics``: Prometheus exposition of the port's hub.

Usage: ``srv = http.start(port=8000)`` … ``srv.stop()``.
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer

from demodel_tpu_torch.restore.server import BaseHandler
from demodel_tpu_torch.utils import metrics
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("serve.http")


class _Handler(BaseHandler):
    def do_GET(self):
        if self.path == "/metrics":
            self._send(200, metrics.render().encode(),
                       ctype="text/plain; version=0.0.4")
            return
        self._send(404, b'{"error":"not found"}')

    def do_POST(self):
        if self.path != "/generate":
            self._send(404, b'{"error":"not found"}')
            return
        self._generate()


class GenServer:
    """``/generate`` + ``/metrics`` on a background thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="gen-http", daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "GenServer":
        self._thread.start()
        log.info("generate API listening on :%d", self.port)
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)


def start(host: str = "127.0.0.1", port: int = 0) -> GenServer:
    """Serve the process-wide engine on ``host:port`` (0 = any free
    port); returns the running :class:`GenServer`."""
    return GenServer(host, port).start()
