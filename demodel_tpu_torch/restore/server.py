"""The restore node's control plane (the port of
``demodel_tpu/restore/server.py``): checkpoint-shaped HTTP over the
content-addressed store.

- ``GET /restore/models`` → the registered model names;
- ``GET /restore/{model}/manifest`` → every tensor's dtype, shape and
  byte count, and the ``data_endpoint`` that serves their bytes when the
  native plane is attached; a model pulled into the store but never
  registered resolves from its pull record on first use;
- ``GET /restore/{model}/tensor/{name}`` → that tensor's bytes,
  Range-aware, so a restoring host fetches only the windows it places;
- ``GET /restore/blob/{sha256}`` → 200 when a pushed single-tensor blob
  with that digest is held (the streamed save's dedup probe), else 404;
- ``PUT /restore/{model}/safetensors`` → commit one whole-checkpoint blob
  and register the model from it;
- ``PUT /restore/blob/{sha256}`` → commit one single-tensor blob under
  its content address (the digest is checked);
- ``POST /restore/{model}/commit`` ``{"digests": [...]}`` → register the
  model from pushed blobs, in order;
- ``POST /generate`` → tokens from this process's serving engine
  (:mod:`demodel_tpu_torch.serve`), 503 when none was booted; the one
  implementation, which :mod:`demodel_tpu_torch.serve.http` shares;
- ``GET /metrics`` → the hub, the native proxy's counters and the
  store's gauges (:func:`~demodel_tpu_torch.utils.metrics.render`);
- ``GET /swarm/{pull}/{host}/chunks`` and ``/chunk/{key}/{i}`` → a swarm
  host's chunk board (404 where this process runs no swarm scheduler);
- ``GET /debug/statusz`` → what the node is doing now
  (:func:`~demodel_tpu_torch.utils.statusz.snapshot`, with ``server`` and
  ``models``); ``GET /debug/telemetry`` → sliding-window rates and
  quantiles (:func:`~demodel_tpu_torch.utils.metrics.telemetry_doc`);
  ``GET /debug/telemetry/history?family=&label=&since=&until=`` → the
  durable archive's series across restarts (404 without
  ``DEMODEL_TELEMETRY_ARCHIVE``); ``GET /debug/profile?seconds=&hz=&
  format=json|collapsed`` → a sampling-profiler capture (503 under
  ``DEMODEL_OBS=0``).

Every request runs under a ``serve.restore`` span whose parent is the
client's W3C ``traceparent`` header when it sends one.

Tensor bytes ride the native plane once :meth:`RestoreRegistry.
attach_native` mirrors the registrations into a
:class:`~demodel_tpu_torch.proxy.ProxyServer`; this server stays the
control plane. Range headers are read as the native plane reads them
(RFC 9110 §14.2: a malformed, reversed or multi-range spec is ignored
and the whole tensor answers 200; a start past the end or a zero suffix
answers 416; an end past the tensor is clamped).
"""

from __future__ import annotations

import json
import queue
import re
import sys
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from demodel_tpu_torch.formats import safetensors as st
from demodel_tpu_torch.store import Store, key_for_uri
from demodel_tpu_torch.utils import metrics, trace
from demodel_tpu_torch.utils.env import (advertise_host,
                                         scrub_interval_secs,
                                         telemetry_archive_dir)
from demodel_tpu_torch.utils.logging import get_logger
from demodel_tpu_torch.utils.metrics import labeled

log = get_logger("restore")

#: pre-registered: a scrape types the /generate outcomes on a node that
#: never booted an engine
for _code in ("200", "400", "411", "413", "500", "503", "504"):
    metrics.HUB.inc(labeled("gen_http_total", code=_code), 0)

_MAX_GENERATE_BODY = 8 << 20
_MAX_COMMIT_BODY = 16 << 20
_CHUNK = 1 << 20

_SWARM_CHUNKS = re.compile(r"^/swarm/([^/]+)/([^/]+)/chunks$")
_SWARM_CHUNK = re.compile(r"^/swarm/([^/]+)/([^/]+)/chunk/([^/]+)/(\d+)$")
_BLOB = re.compile(r"^/restore/blob/([0-9a-f]{64})$")
_MANIFEST = re.compile(r"^/restore/(.+)/manifest$")
_TENSOR = re.compile(r"^/restore/(.+)/tensor/(.+)$")
_SAFETENSORS = re.compile(r"^/restore/(.+)/safetensors$")
_COMMIT = re.compile(r"^/restore/(.+)/commit$")
_RANGE = re.compile(r"^bytes=([0-9]*)-([0-9]*)$")
_JSON = "application/json"


def _gen_engine():
    """(serve module, engine) of this process, or (None, None), without
    importing the serving plane: an engine exists only where
    ``serve.boot`` or ``serve.load_model`` ran, which imported it."""
    serve = sys.modules.get("demodel_tpu_torch.serve")
    if serve is None:
        return None, None
    return serve, serve.current()


def _swarm_board(pull_id: str, host_id: str):
    """A swarm chunk board, without importing the swarm plane: a board
    exists only if this process runs a scheduler, which imported the
    placement module."""
    placement = sys.modules.get("demodel_tpu_torch.parallel.placement")
    if placement is None:
        return None
    return placement.board(pull_id, host_id)


def byte_window(rng: str | None, size: int) -> tuple[int, int, int] | None:
    """``(status, offset, length)`` of a GET of a ``size``-byte object
    with Range header ``rng``, as the native plane's
    ``parse_single_range`` and ``resolve_range`` give it; None when the
    range is unsatisfiable (416)."""
    m = _RANGE.match(rng) if rng else None
    if m is None or not (m[1] or m[2]) or (
            m[1] and m[2] and int(m[2]) < int(m[1])):
        return 200, 0, size
    if not m[1]:  # suffix: the last n bytes
        n = int(m[2])
        if n <= 0:
            return None
        off = max(0, size - n)
        return 206, off, size - off
    off = int(m[1])
    if off >= size:
        return None
    end = int(m[2]) if m[2] and int(m[2]) < size else size - 1
    return 206, off, end - off + 1


@dataclass(frozen=True)
class _TensorLoc:
    key: str      # store key of the safetensors blob
    dtype: str    # safetensors dtype tag
    shape: tuple[int, ...]
    start: int    # absolute offset within the blob
    nbytes: int


def _read_exact(src, length: int, sink) -> None:
    """Copy ``length`` bytes of ``src`` into ``sink`` in 1 MiB chunks;
    a body that ends early raises ValueError."""
    remaining = length
    while remaining > 0:
        chunk = src.read(min(_CHUNK, remaining))
        if not chunk:
            raise ValueError(f"body truncated at {length - remaining}"
                             f"/{length} bytes")
        sink(chunk)
        remaining -= len(chunk)


class RestoreRegistry:
    """Model name → tensor locations, built from stored safetensors
    blobs. Every advertised blob is pinned against GC."""

    def __init__(self, store: Store):
        self.store = store
        self._models: dict[str, dict[str, _TensorLoc]] = {}
        self._pinned: dict[str, list[str]] = {}  # model → pinned keys
        self._lock = threading.Lock()
        self._native = None  # the ProxyServer serving tensor bytes
        self._native_port: int | None = None
        self._data_endpoint: str | None = None

    def register_safetensors(self, model: str, keys: list[str]) -> int:
        """Register ``model`` from the stored blobs ``keys`` (replacing
        an earlier registration); returns its tensor count."""
        if not keys:
            raise ValueError(f"model {model}: no safetensors blobs to "
                             "register")
        tensors: dict[str, _TensorLoc] = {}
        for key in keys:
            index = st.read_index_from(
                lambda off, ln, k=key: self.store.pread(k, ln, off))
            for name, spec in index.tensors.items():
                if name in tensors:
                    raise ValueError(f"duplicate tensor {name} in model "
                                     f"{model}")
                tensors[name] = _TensorLoc(key=key, dtype=spec.dtype,
                                           shape=spec.shape,
                                           start=spec.start,
                                           nbytes=spec.nbytes)
        # pins are refcounted: the new set is pinned before the replaced
        # set is released, so a kept blob is never pin-free
        for key in keys:
            self.store.pin(key)
        with self._lock:
            old_keys = self._pinned.pop(model, [])
            stale = set(self._models.get(model, ())) - set(tensors)
            self._pinned[model] = list(keys)
            self._models[model] = tensors
            native = self._native
        if native is not None:
            # the new set first (same names replace atomically under the
            # native lock), then only the stale names: dropping all and
            # re-adding would 404 live fetches of kept tensors
            for name, loc in tensors.items():
                native.register_tensor(model, name, loc.key, loc.start,
                                       loc.nbytes)
            for name in stale:
                native.unregister_tensor(model, name)
        for key in old_keys:
            self.store.unpin(key)
        log.info("registered model %s: %d tensors", model, len(tensors))
        return len(tensors)

    def register_report(self, model: str, report) -> int:
        """Register ``model`` from a pull report or its manifest record
        (the ``.safetensors`` files)."""
        files = report.files if hasattr(report, "files") else report["files"]
        keys = [(f.key if hasattr(f, "key") else f["key"]) for f in files
                if (f.name if hasattr(f, "name") else f["name"]
                    ).endswith(".safetensors")]
        return self.register_safetensors(model, keys)

    def attach_native(self, proxy, advertise: str | None = None) -> None:
        """Serve tensor bytes from ``proxy``'s native plane: existing and
        later registrations are mirrored into it, and manifests advertise
        it as ``data_endpoint``.

        The advertised host is ``advertise`` or ``DEMODEL_ADVERTISE_HOST``
        (``h``, ``h:p``, a bare IPv6 literal, ``[v6]`` or ``[v6]:p``; the
        proxy's port where none is given); else the proxy's own address
        when it bound an explicit one; else, on a wildcard bind, the host
        each manifest request reached this server by (no single routable
        name exists, and ``127.0.0.1`` would name the client's own
        machine)."""
        advertise = advertise or advertise_host()
        with self._lock:
            self._native = proxy
            self._native_port = proxy.port
            if advertise:
                if advertise.startswith("["):
                    host = advertise if "]:" in advertise else \
                        f"{advertise}:{proxy.port}"
                elif advertise.count(":") > 1:
                    host = f"[{advertise}]:{proxy.port}"
                elif ":" in advertise:
                    host = advertise
                else:
                    host = f"{advertise}:{proxy.port}"
                self._data_endpoint = f"http://{host}"
            elif proxy.cfg.host not in ("0.0.0.0", ""):
                self._data_endpoint = proxy.url
            else:
                self._data_endpoint = None
            models = {m: dict(t) for m, t in self._models.items()}
        for model, tensors in models.items():
            for name, loc in tensors.items():
                proxy.register_tensor(model, name, loc.key, loc.start,
                                      loc.nbytes)

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def unregister(self, model: str) -> bool:
        """Drop ``model`` from the registry and the native plane and
        release its pins, so GC can evict the checkpoint. False when it
        was not registered."""
        with self._lock:
            if model not in self._models:
                return False
            del self._models[model]
            old_keys = self._pinned.pop(model, [])
            native = self._native
        if native is not None:
            native.unregister_model(model)
        for key in old_keys:
            self.store.unpin(key)
        log.info("unregistered model %s", model)
        return True

    def put_safetensors(self, model: str, src, length: int) -> int:
        """Commit a pushed whole-checkpoint blob (``length`` bytes of the
        stream ``src``) and register ``model`` from it; returns the tensor
        count. A re-push replaces the earlier one; a blob that does not
        parse is removed again."""
        key = key_for_uri(f"demodel://restore/{model}/pushed")
        if self.store.has(key):
            self.store.remove(key)
        w = self.store.begin(key)
        try:
            _read_exact(src, length, w.append)
            w.commit({"kind": "pushed-checkpoint", "model": model,
                      "size": length})
        except BaseException:
            w.abort(keep_partial=False)
            raise
        try:
            return self.register_safetensors(model, [key])
        except Exception:
            self.store.remove(key)
            raise

    @staticmethod
    def _tensor_blob_key(digest: str) -> str:
        return key_for_uri(f"demodel://restore/tensor/{digest}")

    def has_tensor_blob(self, digest: str) -> bool:
        """True when a pushed single-tensor blob of this sha256 is held:
        the streamed save never sends an unchanged tensor again."""
        return self.store.has(self._tensor_blob_key(digest))

    def put_tensor_blob(self, digest: str, src, length: int) -> None:
        """Commit one single-tensor blob under its content address,
        streamed in 1 MiB chunks; the store's running sha256 must equal
        ``digest``. A blob already held is drained (the connection stays
        usable) and kept."""
        if not (len(digest) == 64
                and all(c in "0123456789abcdef" for c in digest)):
            raise ValueError("digest must be 64 hex chars")
        key = self._tensor_blob_key(digest)
        if self.store.has(key):
            remaining = length
            while remaining > 0:
                chunk = src.read(min(_CHUNK, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
            return
        w = self.store.begin(key)
        try:
            _read_exact(src, length, w.append)
            got = w.digest()
            if got != digest:
                raise ValueError(f"blob digest mismatch: got {got}")
            w.commit({"kind": "pushed-tensor", "sha256": digest,
                      "size": length})
        except BaseException:
            w.abort(keep_partial=False)
            raise

    def commit_push(self, model: str, digests: list[str]) -> int:
        """Register ``model`` from pushed blobs, in the given order;
        returns the tensor count. An unknown digest raises before any
        registration changes."""
        keys = []
        for d in digests:
            key = self._tensor_blob_key(d)
            if not self.store.has(key):
                raise ValueError(f"no pushed tensor blob for digest "
                                 f"{d[:12]}")
            keys.append(key)
        return self.register_safetensors(model, keys)

    def _lazy_resolve(self, model: str) -> bool:
        """Register ``model`` from the pull record that
        :func:`demodel_tpu_torch.delivery.pull` left in the store."""
        from demodel_tpu_torch.delivery import manifest_key

        for source in ("hf", "ollama"):
            mkey = manifest_key(source, model)
            if not self.store.has(mkey):
                continue
            try:
                self.register_report(model,
                                     json.loads(self.store.get(mkey)))
                return True
            except (ValueError, KeyError) as e:
                log.warning("manifest record for %s unusable: %s", model, e)
        return False

    def manifest(self, model: str,
                 request_host: str | None = None) -> dict | None:
        """The model's manifest, or None when it is neither registered
        nor in the store. ``request_host`` is the request's ``Host``
        header: on a wildcard bind the data endpoint is that host with
        the native port."""
        with self._lock:
            tensors = self._models.get(model)
        if tensors is None and self._lazy_resolve(model):
            with self._lock:
                tensors = self._models.get(model)
        if tensors is None:
            return None
        out = {
            "model": model,
            "format": "safetensors-ranges",
            "tensors": {name: {"dtype": t.dtype, "shape": list(t.shape),
                               "nbytes": t.nbytes}
                        for name, t in tensors.items()},
        }
        if self._data_endpoint:
            out["data_endpoint"] = self._data_endpoint
        elif self._native_port is not None and request_host:
            host = request_host.rsplit(":", 1)[0] \
                if not request_host.startswith("[") \
                else request_host.rpartition("]")[0] + "]"
            out["data_endpoint"] = f"http://{host}:{self._native_port}"
        return out

    def locate(self, model: str, tensor: str) -> _TensorLoc | None:
        with self._lock:
            loc = self._models.get(model, {}).get(tensor)
        if loc is None and model not in self.models() \
                and self._lazy_resolve(model):
            with self._lock:
                loc = self._models.get(model, {}).get(tensor)
        return loc


class BaseHandler(BaseHTTPRequestHandler):
    """JSON replies, ``Content-Length`` and ``POST /generate``: what the
    restore server and :mod:`demodel_tpu_torch.serve.http` share."""

    protocol_version = "HTTP/1.1"
    #: headers and body go out in two writes; with Nagle on, a small
    #: body waits for the client's delayed ACK of the headers (~40 ms a
    #: reply on loopback)
    disable_nagle_algorithm = True

    def log_message(self, *a) -> None:  # noqa: ARG002
        pass

    def _send(self, status: int, body: bytes,
              ctype: str = "application/json", extra=None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _content_length(self) -> int:
        try:
            return int(self.headers.get("Content-Length", "0"))
        except ValueError:
            return 0

    def _gen_reply(self, status: int, body: bytes, extra=None) -> None:
        metrics.HUB.inc(labeled("gen_http_total", code=str(status)))
        self._send(status, body, extra=extra)

    def _generate(self) -> None:  # noqa: C901
        """``{"prompt": [ids], "max_new_tokens": n, "stream": bool,
        "timeout": s}`` against this process's engine: a JSON reply, or
        with ``stream`` chunked NDJSON (a ``{"token": id}`` line a token,
        then ``{"done": true, ...}``). 503 (with ``Retry-After`` on queue
        overflow) when no engine was booted or the queue is full, 400 on
        a bad body, 411 without a length, 413 past 8 MiB, 504 on timeout;
        each outcome counted in ``gen_http_total{code}``."""
        serve, engine = _gen_engine()
        if engine is None:
            self._gen_reply(503, b'{"error":"serving disabled '
                                 b'(no engine booted)"}')
            return
        length = self._content_length()
        if length <= 0:
            self._gen_reply(411, b'{"error":"Content-Length required"}')
            return
        if length > _MAX_GENERATE_BODY:
            self._gen_reply(413, b'{"error":"body exceeds 8 MiB limit"}')
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
            self._gen_reply(400, json.dumps({"error": str(e)}).encode())
            return
        try:
            req = engine.submit(prompt, max_new)
        except serve.QueueOverflow as e:
            # loud rejection with a backoff hint, never a silent drop
            self._gen_reply(503, json.dumps({
                "error": str(e), "retry_after": e.retry_after}).encode(),
                extra={"Retry-After": str(e.retry_after)})
            return
        except (ValueError, RuntimeError) as e:
            self._gen_reply(400, json.dumps({"error": str(e)}).encode())
            return
        if not stream:
            try:
                toks = req.result(timeout=timeout)
            except TimeoutError:
                req.cancel()
                self._gen_reply(504, b'{"error":"generation timed out"}')
                return
            except RuntimeError as e:
                self._gen_reply(500, json.dumps({"error": str(e)}).encode())
                return
            self._gen_reply(200, json.dumps({
                "id": req.id, "tokens": toks,
                "prompt_tokens": len(req.prompt),
                "queue_ms": round(((req.started_s or req.submitted_s)
                                   - req.submitted_s) * 1e3, 3),
                "total_ms": round(((req.finished_s or req.submitted_s)
                                   - req.submitted_s) * 1e3, 3)}).encode())
            return
        metrics.HUB.inc(labeled("gen_http_total", code="200"))
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


def _query(path: str) -> dict[str, str]:
    """The first value of each non-empty query parameter."""
    return {k: v[0] for k, v in parse_qs(urlsplit(path).query).items()
            if v and v[0]}


def _number(q: dict[str, str], key: str, default, cast):
    try:
        return cast(q[key]) if key in q else default
    except ValueError:
        return default


def _debug(path: str, registry: RestoreRegistry, proxy
           ) -> tuple[int, bytes, str] | None:
    """The ``/debug/*`` routes (None for any other path): status, body
    and content type, with the reference's bodies."""
    if path.startswith("/debug/telemetry/history"):
        # an archive exists only if retention was started, so peek
        # sys.modules instead of importing the module
        retention = sys.modules.get("demodel_tpu_torch.utils.retention")
        archive = retention.current() if retention is not None else None
        if archive is None:
            return (404, b'{"error":"no telemetry archive '
                         b'(set DEMODEL_TELEMETRY_ARCHIVE)"}', _JSON)
        q = _query(path)
        # windows the background flusher has not reached yet, so the
        # history is current up to this poll
        archive.flush_once()
        doc = archive.history(family=q.get("family"), label=q.get("label"),
                              since=_number(q, "since", None, float),
                              until=_number(q, "until", None, float))
        doc["server"] = "restore"
        return 200, json.dumps(doc, default=str).encode(), _JSON
    if path == "/debug/telemetry":
        doc = metrics.telemetry_doc(proxy=proxy)
        doc["server"] = "restore"
        return 200, json.dumps(doc, default=str).encode(), _JSON
    if path.startswith("/debug/profile"):
        from demodel_tpu_torch.utils import profiler

        q = _query(path)
        prof = profiler.capture(seconds=_number(q, "seconds", 1.0, float),
                                hz=_number(q, "hz", 0, int))
        if prof is None:
            return 503, b'{"error":"profiler disabled (DEMODEL_OBS=0)"}', \
                _JSON
        prof["server"] = "restore"
        if q.get("format") == "collapsed":
            return (200, profiler.collapse(prof).encode(),
                    "text/plain; charset=utf-8")
        return 200, json.dumps(prof, default=str).encode(), _JSON
    if path == "/debug/statusz":
        from demodel_tpu_torch.utils import statusz

        doc = statusz.snapshot(extra={"server": "restore",
                                      "models": registry.models()})
        return 200, json.dumps(doc, default=str).encode(), _JSON
    return None


def make_handler(registry: RestoreRegistry, proxy=None):
    class RestoreHandler(BaseHandler):
        def _traced(self, fn) -> None:
            # the server half of the cross-host trace: parented on the
            # client's W3C traceparent when it sends one
            with trace.span("serve.restore",
                            remote_parent=self.headers.get("traceparent"),
                            method=self.command, path=self.path):
                fn()

        def do_HEAD(self) -> None:
            self.do_GET()

        def do_GET(self) -> None:
            self._traced(self._get)

        def do_PUT(self) -> None:
            self._traced(self._put)

        def do_POST(self) -> None:
            self._traced(self._post)

        def _get(self) -> None:  # noqa: C901
            if self.path == "/metrics":
                self._send(200, metrics.render(
                    proxy=proxy, store=registry.store).encode(),
                    ctype="text/plain; version=0.0.4")
                return
            if self.path.startswith("/debug/"):
                found = _debug(self.path, registry, proxy)
                if found is not None:
                    status, body, ctype = found
                    self._send(status, body, ctype=ctype)
                    return
            if self.path == "/restore/models":
                self._send(200, json.dumps(
                    {"models": registry.models()}).encode())
                return
            m = _SWARM_CHUNKS.match(self.path)
            if m:
                board = _swarm_board(m[1], m[2])
                if board is None:
                    self._send(404, b'{"error":"no such swarm board"}')
                    return
                self._send(200, json.dumps(board.summary()).encode())
                return
            m = _SWARM_CHUNK.match(self.path)
            if m:
                board = _swarm_board(m[1], m[2])
                data = board.get(m[3], int(m[4])) \
                    if board is not None else None
                if data is None:
                    self._send(404, b'{"error":"chunk not held"}')
                    return
                metrics.HUB.inc("swarm_chunks_served_total")
                metrics.HUB.inc("swarm_bytes_served_total", len(data))
                self._send(200, data, ctype="application/octet-stream")
                return
            m = _BLOB.match(self.path)
            if m:
                if registry.has_tensor_blob(m[1]):
                    self._send(200, b'{"present":true}')
                else:
                    self._send(404, b'{"present":false}')
                return
            m = _MANIFEST.match(self.path)
            if m:
                manifest = registry.manifest(
                    m[1], request_host=self.headers.get("Host"))
                if manifest is None:
                    self._send(404, b'{"error":"model not registered"}')
                    return
                self._send(200, json.dumps(manifest).encode())
                return
            m = _TENSOR.match(self.path)
            if m:
                loc = registry.locate(m[1], m[2])
                if loc is None:
                    self._send(404, b'{"error":"no such tensor"}')
                    return
                window = byte_window(self.headers.get("Range"), loc.nbytes)
                if window is None:
                    self._send(416, b"")
                    return
                status, off, length = window
                extra = {"Accept-Ranges": "bytes"}
                if status == 206:
                    extra["Content-Range"] = \
                        f"bytes {off}-{off + length - 1}/{loc.nbytes}"
                # read into one buffer and send a view of it: no copy of
                # the window under the GIL
                buf = bytearray(length)
                body = memoryview(buf)[:registry.store.pread_into(
                    loc.key, buf, loc.start + off)]
                metrics.HUB.inc("restore_tensor_requests_total")
                metrics.HUB.inc("restore_bytes_total", len(body))
                self._send(status, body, ctype="application/octet-stream",
                           extra=extra)
                return
            self._send(404, b'{"error":"not found"}')

        def _put(self) -> None:
            blob = _BLOB.match(self.path)
            m = blob or _SAFETENSORS.match(self.path)
            if m is None:
                self._send(404, b'{"error":"not found"}')
                return
            length = self._content_length()
            if length <= 0:
                self._send(411, b'{"error":"Content-Length required"}')
                return
            try:
                if blob:
                    registry.put_tensor_blob(m[1], self.rfile, length)
                else:
                    n = registry.put_safetensors(m[1], self.rfile, length)
            except Exception as e:  # noqa: BLE001 — bad blob → client error
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            metrics.HUB.inc("restore_put_bytes_total", length)
            if blob:
                self._send(200, b'{"ok":true}')
                return
            metrics.HUB.inc("restore_put_total")
            self._send(200, json.dumps({"model": m[1],
                                        "tensors": n}).encode())

        def _post(self) -> None:
            if self.path == "/generate":
                self._generate()
                return
            m = _COMMIT.match(self.path)
            if m is None:
                self._send(404, b'{"error":"not found"}')
                return
            length = self._content_length()
            if not 0 < length <= _MAX_COMMIT_BODY:
                self._send(411, b'{"error":"Content-Length required"}')
                return
            try:
                digests = json.loads(self.rfile.read(length))["digests"]
                if not isinstance(digests, list) or not digests:
                    raise ValueError("digests must be a non-empty list")
                n = registry.commit_push(m[1], digests)
            except Exception as e:  # noqa: BLE001 — bad commit → client error
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            metrics.HUB.inc("restore_put_total")
            self._send(200, json.dumps({"model": m[1],
                                        "tensors": n}).encode())

    return RestoreHandler


class RestoreServer:
    """Threaded HTTP server over a :class:`RestoreRegistry`; ``port=0``
    picks a free port (read :attr:`port`). ``proxy`` adds the native
    plane's counters to ``/metrics``. A swarm-only host passes an empty
    registry."""

    def __init__(self, registry: RestoreRegistry, host: str = "0.0.0.0",
                 port: int = 0, proxy=None):
        self.registry = registry
        self._proxy = proxy
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(registry, proxy))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="restore-http", daemon=True)

    def start(self) -> "RestoreServer":
        self._thread.start()
        if telemetry_archive_dir():
            # durable telemetry only when its knob is set: unset, the
            # retention module is never imported
            from demodel_tpu_torch.utils import retention

            retention.ensure(proxy=self._proxy)
        # the sampling profiler is always on at the observe tier (a node
        # is profilable from curl without a restart); DEMODEL_OBS=0 makes
        # this a no-op and no thread starts
        from demodel_tpu_torch.utils import profiler

        profiler.ensure()
        if scrub_interval_secs() > 0:
            # opt-in: a node without the interval set never imports it
            from demodel_tpu_torch import scrub

            scrub.ensure(self.registry.store)
        log.info("restore API listening on :%d", self.port)
        return self

    def stop(self) -> None:
        scrub = sys.modules.get("demodel_tpu_torch.scrub")
        if scrub is not None:
            scrub.stop_all()
        self.httpd.shutdown()
        self.httpd.server_close()

    def __enter__(self) -> "RestoreServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
