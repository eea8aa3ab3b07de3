"""``/generate`` and ``/metrics`` over HTTP: the token-serving route of
``demodel_tpu/restore/server.py`` on a ``ThreadingHTTPServer``.

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

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from demodel_tpu_torch import serve
from demodel_tpu_torch.utils import metrics
from demodel_tpu_torch.utils.logging import get_logger
from demodel_tpu_torch.utils.metrics import labeled

log = get_logger("serve.http")

#: pre-register the /generate outcome families (house idiom)
for _code in ("200", "400", "411", "413", "500", "503", "504"):
    metrics.HUB.inc(labeled("gen_http_total", code=_code), 0)

_MAX_BODY = 8 << 20


def _count(code: int) -> None:
    metrics.HUB.inc(labeled("gen_http_total", code=str(code)))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, status, body: bytes, ctype="application/json",
              extra=None):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _content_length(self) -> int:
        try:
            return int(self.headers.get("Content-Length", "0"))
        except ValueError:
            return 0

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

    def _generate(self):  # noqa: C901
        engine = serve.current()
        if engine is None:
            _count(503)
            self._send(503, b'{"error":"serving disabled '
                            b'(no engine booted)"}')
            return
        length = self._content_length()
        if length <= 0:
            _count(411)
            self._send(411, b'{"error":"Content-Length required"}')
            return
        if length > _MAX_BODY:
            _count(413)
            self._send(413, b'{"error":"body exceeds 8 MiB limit"}')
            return
        try:
            body = json.loads(self.rfile.read(length))
            prompt = body["prompt"]
            if not isinstance(prompt, list) or not prompt:
                raise ValueError(
                    "prompt must be a non-empty list of token ids")
            max_new = int(body.get("max_new_tokens", 16))
            stream = bool(body.get("stream", False))
            timeout = float(body.get("timeout", 300.0))
        except Exception as e:  # noqa: BLE001 — bad body → client error
            _count(400)
            self._send(400, json.dumps({"error": str(e)}).encode())
            return
        try:
            req = engine.submit(prompt, max_new)
        except serve.QueueOverflow as e:
            _count(503)
            self._send(503, json.dumps({
                "error": str(e), "retry_after": e.retry_after}).encode(),
                extra={"Retry-After": str(e.retry_after)})
            return
        except (ValueError, RuntimeError) as e:
            _count(400)
            self._send(400, json.dumps({"error": str(e)}).encode())
            return
        if not stream:
            try:
                toks = req.result(timeout=timeout)
            except TimeoutError:
                req.cancel()
                _count(504)
                self._send(504, b'{"error":"generation timed out"}')
                return
            except RuntimeError as e:
                _count(500)
                self._send(500, json.dumps({"error": str(e)}).encode())
                return
            _count(200)
            self._send(200, json.dumps({
                "id": req.id, "tokens": toks,
                "prompt_tokens": len(req.prompt),
                "queue_ms": round(((req.started_s or req.submitted_s)
                                   - req.submitted_s) * 1e3, 3),
                "total_ms": round(((req.finished_s or req.submitted_s)
                                   - req.submitted_s) * 1e3, 3)}).encode())
            return
        _count(200)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def _chunk(obj) -> None:
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        try:
            for tok in req.iter_tokens(timeout=timeout):
                _chunk({"token": tok})
            _chunk({"done": True, "id": req.id, "tokens": req.tokens})
        except RuntimeError as e:
            _chunk({"error": str(e)})
        except (queue.Empty, BrokenPipeError, ConnectionResetError):
            # consumer gone or stream stalled: evict the sequence so its
            # blocks free now instead of decoding to a dead pipe
            req.cancel()
            return
        self.wfile.write(b"0\r\n\r\n")


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
