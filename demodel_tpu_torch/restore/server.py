"""The swarm's serve surface (the part of ``demodel_tpu/restore/server.py``
that a swarm pull needs).

A host in a swarm pull re-serves its chunk board to its siblings:

- ``GET /swarm/{pull}/{host}/chunks`` → the board's versioned possession
  summary (one bitmap per file);
- ``GET /swarm/{pull}/{host}/chunk/{key}/{i}`` → one held chunk's bytes,
  counted in ``swarm_chunks_served_total`` and
  ``swarm_bytes_served_total``.

Boards are found in :mod:`demodel_tpu_torch.parallel.placement`'s
registry, where a :class:`~demodel_tpu_torch.sink.remote.SwarmScheduler`
registers its own; a node that never swarmed answers 404. The
reference's ``RestoreRegistry`` and its ``/restore/*`` routes (tensor
addressing over the store, Orbax-style restore) are not ported yet
(ROADMAP A10), nor its ``/generate``, ``/metrics`` and ``/debug/*``
routes, which the port serves elsewhere (``serve/http.py``) or not yet.
"""

from __future__ import annotations

import json
import re
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from demodel_tpu_torch.utils import metrics
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("restore")

_CHUNKS = re.compile(r"^/swarm/([^/]+)/([^/]+)/chunks$")
_CHUNK = re.compile(r"^/swarm/([^/]+)/([^/]+)/chunk/([^/]+)/(\d+)$")


def _swarm_board(pull_id: str, host_id: str):
    """A swarm chunk board, without importing the swarm plane: a board
    exists only if this process runs a scheduler, which imported the
    placement module."""
    placement = sys.modules.get("demodel_tpu_torch.parallel.placement")
    if placement is None:
        return None
    return placement.board(pull_id, host_id)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a) -> None:  # noqa: ARG002
        pass

    def _send(self, status: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        m = _CHUNKS.match(self.path)
        if m:
            board = _swarm_board(m.group(1), m.group(2))
            if board is None:
                self._send(404, b'{"error":"no such swarm board"}')
                return
            self._send(200, json.dumps(board.summary()).encode())
            return
        m = _CHUNK.match(self.path)
        if m:
            board = _swarm_board(m.group(1), m.group(2))
            data = board.get(m.group(3), int(m.group(4))) \
                if board is not None else None
            if data is None:
                self._send(404, b'{"error":"chunk not held"}')
                return
            metrics.HUB.inc("swarm_chunks_served_total")
            metrics.HUB.inc("swarm_bytes_served_total", len(data))
            self._send(200, data, ctype="application/octet-stream")
            return
        self._send(404, b'{"error":"not found"}')


class RestoreServer:
    """Threaded HTTP server of the swarm routes; ``port=0`` picks a free
    port (read :attr:`port` after construction)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "RestoreServer":
        self._thread.start()
        log.info("swarm serve surface listening on :%d", self.port)
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def __enter__(self) -> "RestoreServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
