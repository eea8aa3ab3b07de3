"""Sharded pulls from warm peers straight onto the device, and the chunk
swarm (the port of ``demodel_tpu/sink/remote.py``).

Where the whole-file pull path copies every weight file into the store
first, this path places a model off warm peers with no store on the
receiving node: a reader whose ``pread``/``pread_into`` are HTTP
**Range** requests on a peer's ``/peer/object/{key}`` endpoint drives
the same placement machinery (:func:`~demodel_tpu_torch.sink.hbm
.place_tensor`, :func:`~demodel_tpu_torch.sink.hbm.deliver_safetensors`,
:func:`~demodel_tpu_torch.sink.hbm.deliver_gguf`):

- the model manifest record (``demodel://models/{source}/{model}``, which
  a pull publishes) is found on a peer, so a cold node needs no registry
  round-trip at all (:func:`fetch_manifest`);
- safetensors files stripe over the responsive peers by consistent hash
  with bounded loads, and every tensor's byte window is read into one
  prefetch pipeline spanning file boundaries, its landing buffer charged
  to a :class:`~demodel_tpu_torch.sink.streaming.ByteBudget`
  (:func:`_deliver_jobs_pipelined`); each tensor goes to the device as it
  lands, and the :class:`~demodel_tpu_torch.sink.tuner.PullTuner` moves
  the window size, streams and prefetch depth between windows;
- GGUF files take the per-file path into ``deliver_gguf``, so the
  dequant kernels run on them;
- a failed window resumes at the exact received offset, on the next
  healthy peer when one holds the key (:class:`PeerBlobReader`).

With a :class:`SwarmScheduler`, N cold hosts split every file's chunk
grid over a hash ring: each fetches only its owned chunks from origin
and cross-fills the rest from its siblings' chunk boards (served by
:mod:`demodel_tpu_torch.restore.server`), so aggregate origin bytes come
to about 1× the manifest.

One process addresses one device here: placement over several GPUs and
the ``ici_complete`` leg are ROADMAP A7. The wire is
:class:`~demodel_tpu_torch.utils.faults.HTTPClient` (one connection per
host per thread) and, for windows of 4 MiB and more on an ``http://``
peer, the native library's multi-stream window fetch.
"""

from __future__ import annotations

import ctypes
import re
import threading
import time
from pathlib import Path

import numpy as np
import torch

from demodel_tpu_torch.delivery import manifest_key
from demodel_tpu_torch.parallel import placement as swarm_placement
from demodel_tpu_torch.parallel.mesh import Mesh, make_mesh
from demodel_tpu_torch.parallel.placement import (
    ChunkBoard,
    HashRing,
    bitmap_indices,
    bounded_assign,
    chunk_count,
    chunk_span,
    default_chunk_bytes,
)
from demodel_tpu_torch.sink.hbm import Placement, is_weight_file, merge_placement
from demodel_tpu_torch.sink.plan import ShardingPlan
from demodel_tpu_torch.utils import metrics, trace
from demodel_tpu_torch.utils.env import (available_cpus, default_peer_streams,
                                         env_int)
from demodel_tpu_torch.utils.faults import (
    TRANSPORT_ERRORS,
    HTTPClient,
    PeerHealth,
    RangeIgnored,
    RetryPolicy,
    TruncatedBody,
    count_retry,
    peer_cannot_serve,
    request_with_retry,
    retryable,
)
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("sink.remote")

#: window reads at/under this ride one pooled HTTP connection; larger
#: windows fan out over native range streams
_NATIVE_MIN_BYTES = 4 << 20

#: what one window attempt can raise from the wire
_WIRE_ERRORS = TRANSPORT_ERRORS + (OSError,)

#: the peer URLs the native window fetch can dial: ``http://host[:port]``
_NATIVE_URL = re.compile(r"^http://(\[[0-9a-fA-F:]+\]|[^:/]+)(?::(\d+))?$")

#: pre-registered: a scrape types the fallback counter before the first
#: event (``chip_smoke.py`` gates it at 0 on loopback)
metrics.HUB.inc("peer_window_fallback_total", 0)


class WindowAbort(IOError):
    """A window transfer died mid-body. ``got`` bytes already landed in
    the caller's buffer (real network bytes, never re-fetched); ``cause``
    carries the transport error for retry classification."""

    def __init__(self, got: int, cause: BaseException):
        super().__init__(str(cause))
        self.got = got
        self.cause = cause


class PeerBlobReader:
    """Store-shaped reads (``size``/``pread``/``pread_into``) served by
    HTTP Range requests against one object on one peer.

    Duck-types the part of :class:`~demodel_tpu_torch.store.Store` that
    the placement functions touch. Thread-safe; counts ``bytes_fetched``.

    Window-level recovery: a failed Range read resumes at the exact
    received offset — first on the next healthy ``failover`` peer holding
    the same key (breaker-gated through the shared :class:`PeerHealth`),
    with backoff when no alternative exists.
    """

    def __init__(self, peer: str, remote_key: str, size: int,
                 streams: int | None = None, timeout: float | None = None,
                 path: str | None = None,
                 failover: list[str] | None = None,
                 health: PeerHealth | None = None,
                 policy: RetryPolicy | None = None):
        self.remote_key = remote_key
        #: served resource path, ``/peer/object/{key}`` by default
        self.path = path or f"/peer/object/{remote_key}"
        self._size = int(size)
        self.timeout = timeout if timeout is not None else float(
            env_int("DEMODEL_PEER_TIMEOUT", 120, minimum=1))
        self.streams = (streams if streams is not None
                        else default_peer_streams())
        self._client = HTTPClient()
        self.bytes_fetched = 0
        self._count_lock = threading.Lock()
        first = peer.rstrip("/")
        self._peers = [first] + [q for q in
                                 (p.rstrip("/") for p in (failover or []))
                                 if q != first]
        self._health = health if health is not None else PeerHealth.shared()
        self._policy = policy if policy is not None else RetryPolicy()
        #: guards peer/_native_host/_native_port: one thread's failover
        #: must not hand another thread host A with port B
        self._peer_lock = threading.Lock()
        self._set_peer(first)

    def close(self) -> None:
        """Close the connections this reader opened (it stays usable:
        a later read dials again)."""
        self._client.close()

    def _set_peer(self, peer: str) -> None:
        m = _NATIVE_URL.match(peer)
        with self._peer_lock:
            self.peer = peer
            # https and odd peers: every read takes the Python transport
            self._native_host = m.group(1).strip("[]") if m else None
            self._native_port = int(m.group(2) or 80) if m else 0

    def _snapshot(self) -> tuple[str, str | None, int]:
        """A consistent (peer, native_host, native_port) for one attempt."""
        with self._peer_lock:
            return self.peer, self._native_host, self._native_port

    def _fail_over(self, from_peer: str,
                   exclude: set | frozenset = frozenset()) -> bool:
        """Rotate to the next breaker-admitted peer holding this key,
        skipping ``exclude`` (peers proven unable to serve it). True when
        the source changed, also by a concurrent window's rotation."""
        with self._peer_lock:
            current = self.peer
        if current != from_peer and current not in exclude:
            return True
        if len(self._peers) > 1:
            i = self._peers.index(current)
            for step in range(1, len(self._peers)):
                cand = self._peers[(i + step) % len(self._peers)]
                if cand != from_peer and cand not in exclude \
                        and self._health.allow(cand):
                    self._set_peer(cand)
                    return True
        return False

    def _add_fetched(self, n: int) -> None:
        if n:
            with self._count_lock:
                self.bytes_fetched += n
            # the delivery rate the tuner reads as a windowed rate
            metrics.HUB.inc("pull_bytes_total", n)

    # -- Store duck-type ------------------------------------------------
    def size(self, key: str) -> int:  # noqa: ARG002 — single-object reader
        return self._size

    def pread(self, key: str, length: int, offset: int) -> bytes:
        out = np.empty(length, dtype=np.uint8)
        got = self.pread_into(key, out, offset)
        return out[:got].tobytes()

    def pread_into(self, key: str, out, offset: int = 0) -> int:  # noqa: ARG002
        view = memoryview(out).cast("B")
        length = view.nbytes
        if length == 0:
            return 0
        if offset < 0 or offset + length > self._size:
            raise IOError(f"window [{offset}, {offset + length}) outside "
                          f"object of {self._size} bytes")
        with trace.span("window-read", key=self.remote_key, offset=offset,
                        length=length, peer=self._snapshot()[0]) as sp:
            return self._pread_into_traced(view, length, offset, sp)

    def _pread_into_traced(self, view, length: int, offset: int,
                           sp) -> int:
        got = 0
        attempt = 0
        start = self._policy.clock()
        cannot_serve: set = set()  # peers that refused THIS key
        while True:
            peer, native_host, native_port = self._snapshot()
            try:
                while got < length:
                    remaining = length - got
                    sub = view[got:]
                    if native_host and remaining >= _NATIVE_MIN_BYTES:
                        n = self._window_native(sub, offset + got, remaining,
                                                peer, native_host,
                                                native_port)
                    else:
                        n = self._window_http(sub, offset + got,
                                              remaining, peer)
                    self._add_fetched(n)
                    got += n
            except WindowAbort as e:
                # e.got bytes are in the buffer AND moved over the wire:
                # count them, keep them, never re-fetch them
                self._add_fetched(e.got)
                got += e.got
                if retryable(e.cause):
                    self._health.record_failure(peer)
                    attempt += 1
                    delay = self._policy.should_retry(attempt, start,
                                                      e.cause)
                    if delay is None:
                        raise IOError(
                            f"window [{offset}, +{length}) of "
                            f"{self.remote_key} failed at +{got} after "
                            f"{attempt} attempt(s): {e.cause}") from e.cause
                    count_retry(delay=delay, peer=peer)
                    switched = self._fail_over(peer, exclude=cannot_serve)
                    sp.event("retry", attempt=attempt, peer=peer,
                             resume_at=got,
                             error=f"{type(e.cause).__name__}: {e.cause}")
                    if switched:
                        sp.event("failover", from_peer=peer,
                                 to_peer=self._snapshot()[0],
                                 resume_at=got)
                    log.warning(
                        "window [%d, +%d) of %s died at +%d on %s (%s); "
                        "resuming at the exact offset via %s "
                        "(attempt %d/%d)",
                        offset, length, self.remote_key, got, peer,
                        e.cause, self._snapshot()[0], attempt + 1,
                        self._policy.max_attempts)
                    if not switched:
                        self._policy.sleep(delay)
                elif peer_cannot_serve(e.cause):
                    # content-shaped refusal: not a health event, and a
                    # same-peer retry re-fails — rotate once per peer
                    cannot_serve.add(peer)
                    if (self._policy.deadline_left(start) <= 0
                            or not self._fail_over(peer,
                                                   exclude=cannot_serve)):
                        raise IOError(
                            f"window [{offset}, +{length}) of "
                            f"{self.remote_key}: no peer in the rotation "
                            f"can serve it ({e.cause})") from e.cause
                    sp.event("failover", from_peer=peer,
                             to_peer=self._snapshot()[0],
                             reason="cannot-serve", resume_at=got)
                    log.warning(
                        "peer %s cannot serve %s (%s); failing the window "
                        "over to %s", peer, self.remote_key, e.cause,
                        self._snapshot()[0])
                else:
                    raise IOError(
                        f"window [{offset}, +{length}) of "
                        f"{self.remote_key} failed at +{got}: "
                        f"{e.cause}") from e.cause
            else:
                self._health.record_success(peer)
                return length

    # -- transports -----------------------------------------------------
    def _window_native(self, view: memoryview, offset: int, length: int,
                       peer: str, native_host: str,
                       native_port: int) -> int:
        from demodel_tpu_torch import native

        arr = np.frombuffer(view, dtype=np.uint8)
        errbuf = ctypes.create_string_buffer(512)
        n = native.lib().dm_peer_fetch_window(
            native_host.encode(), native_port, self.path.encode(),
            offset, length, self._size, self.streams,
            arr.ctypes.data_as(ctypes.c_void_p), errbuf, 512)
        if n != length:
            # the reference's wire behaviour, counted here
            metrics.HUB.inc("peer_window_fallback_total")
            log.warning("native window fetch [%d,+%d) of %s failed (%s); "
                        "using the Python transport", offset, length,
                        self.remote_key,
                        errbuf.value.decode(errors="replace"))
            return self._window_http(view, offset, length, peer)
        return int(n)

    def _window_http(self, view: memoryview, offset: int,
                     length: int, peer: str) -> int:
        """One Range attempt against ``peer`` (an explicit snapshot: a
        concurrent failover must not swap the target mid-attempt). Bytes
        land in ``view`` as they arrive; any failure raises
        :class:`WindowAbort` carrying how many did."""
        got = 0
        try:
            r = self._client.request(
                "GET", f"{peer}{self.path}",
                headers={"Range": f"bytes={offset}-{offset + length - 1}"},
                stream=True, timeout=self.timeout)
            try:
                r.raise_for_status()
                if r.status_code != 206 and not (
                        r.status_code == 200 and offset == 0
                        and length == self._size):
                    raise RangeIgnored(
                        f"peer ignored Range (status {r.status_code}) "
                        f"for {self.remote_key}")
                for chunk in r.iter_content(1 << 20):
                    if not chunk:
                        continue
                    take = min(len(chunk), length - got)
                    view[got:got + take] = chunk[:take]
                    got += take
                    if got >= length:
                        break
            finally:
                r.close()
        except _WIRE_ERRORS as e:
            raise WindowAbort(got, e) from e
        if got != length:
            raise WindowAbort(got, TruncatedBody(
                f"short peer window read: {got} != {length} "
                f"for {self.remote_key}"))
        return got


def fetch_manifest(peers: list[str], model: str, source: str = "hf",
                   timeout: float = 30.0,
                   health: PeerHealth | None = None,
                   policy: RetryPolicy | None = None) -> tuple[str, dict]:
    """Locate and fetch the model-manifest record on a warm peer:
    ``(peer_base_url, manifest_dict)``. Peers whose breaker is open are
    skipped until their half-open probe is due; each attempted peer
    rides the retry policy."""
    mkey = manifest_key(source, model)
    health = health if health is not None else PeerHealth.shared()
    policy = policy if policy is not None else RetryPolicy()
    client = HTTPClient()
    try:
        with trace.span("manifest-discovery", model=model, source=source,
                        peers=len(peers)):
            return _fetch_manifest(peers, mkey, model, source, timeout,
                                   health, policy, client)
    finally:
        client.close()


def _fetch_manifest(peers, mkey, model, source, timeout, health, policy,
                    client) -> tuple[str, dict]:
    last_err: Exception | None = None
    candidates = [p.rstrip("/") for p in peers]
    # read-only filter (burns no probe slot); the claiming allow()
    # happens right before each dial
    admitted = [p for p in candidates if health.admissible(p)]
    if len(admitted) < len(candidates):
        log.info("manifest discovery skipping %d breaker-open peer(s)",
                 len(candidates) - len(admitted))
    last_resort = not admitted
    if last_resort:
        # every breaker refuses: a last-resort sweep beats an outage
        admitted = candidates
    for peer in admitted:
        if not last_resort and not health.allow(peer):
            continue  # raced shut, or another caller owns the probe
        try:
            r = request_with_retry(
                client, "GET", f"{peer}/peer/object/{mkey}",
                policy=policy, health=health, peer=peer,
                ok_statuses=(404,), timeout=timeout,
                what=f"manifest {source}/{model} from {peer}")
            if r.status_code == 404:
                continue
            return peer, r.json()
        except _WIRE_ERRORS + (ValueError,) as e:
            last_err = e
            log.warning("peer %s manifest for %s failed: %s", peer, model, e)
    raise IOError(f"no peer holds a manifest for {source}/{model}"
                  + (f" (last error: {last_err})" if last_err else ""))


def _peer_alive(peer: str, timeout: float = 3.0) -> bool:
    """Short-deadline liveness probe (``/healthz``), one attempt; the
    outcome feeds the shared breakers."""
    client = HTTPClient()
    try:
        request_with_retry(
            client, "GET", f"{peer}/healthz",
            policy=RetryPolicy(max_attempts=1, deadline=timeout),
            health=PeerHealth.shared(), peer=peer.rstrip("/"),
            timeout=timeout, what=f"liveness {peer}")
        return True
    except _WIRE_ERRORS:
        return False
    finally:
        client.close()


def _alive_peers(peers: list, timeout: float = 3.0) -> list:
    """Probe every candidate peer concurrently under one shared deadline:
    K stale peers cost about one timeout, not K. Stragglers are left
    behind at the deadline and count as dead."""
    if not peers:
        return []
    from concurrent.futures import ThreadPoolExecutor, wait

    ex = ThreadPoolExecutor(max_workers=min(32, len(peers)),
                            thread_name_prefix="peer-probe")
    try:
        futs = {p: ex.submit(_peer_alive, p, timeout) for p in peers}
        done, _pending = wait(set(futs.values()), timeout=timeout + 0.5)
        return [p for p, f in futs.items()
                if f in done and not f.cancelled()
                and f.exception() is None and f.result()]
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def _responsive_peers(peers: list, timeout: float = 3.0) -> list:
    """The striping rotation's membership, gossip first: peers the
    background index refresh heard from recently join with no wire
    traffic, failed ones drop out, and only never-heard-from peers take
    the concurrent probe round. Every pull enrolls its peers."""
    if not peers:
        return []
    from demodel_tpu_torch.parallel.peer import PeerGossip

    gossip = PeerGossip.shared()
    gossip.track(peers)
    alive, dead, unknown = gossip.split(peers)
    if dead:
        log.info("striping rotation drops %d gossip-dead peer(s)",
                 len(dead))
    return alive + (_alive_peers(unknown, timeout) if unknown else [])


def _reader_and_index(f: dict, peer_order: list[str], streams):
    """Open ``f`` on the first peer that can serve its safetensors index
    (header reads fail over peer by peer; window reads recover inside
    the reader)."""
    from demodel_tpu_torch.formats import safetensors as st

    last_err: Exception | None = None
    for i, source_peer in enumerate(peer_order):
        reader = PeerBlobReader(
            source_peer, f["key"], int(f["size"]), streams=streams,
            failover=peer_order[i + 1:] + peer_order[:i])
        try:
            with trace.span("index-read", file=f["name"],
                            peer=source_peer):
                index = st.read_index_from(
                    lambda off, ln: reader.pread(f["key"], ln, off),
                    total_size=reader.size(f["key"]))
            return reader, index
        except (OSError, ValueError) as e:
            # ValueError: a corrupt header parses as junk — the next peer
            # holds a good copy
            reader.close()
            last_err = e
            log.warning("index of %s from %s failed (%s); trying next "
                        "peer", f["name"], source_peer, e)
    raise IOError(f"no peer could serve {f['name']}") from last_err


# --------------------------------------------------------------- swarm fetch
#
# N hosts pulling one manifest partition every file's fixed chunk grid
# over a consistent-hash ring (disjoint origin chunk sets), fetch only
# their owned chunks from origin, and cross-fill the rest from each
# other as possession advertisements land. The per-chunk transport is
# PeerBlobReader.pread_into, so window resume holds inside every chunk.


def _swarm_chunk_id(key: str, index: int) -> str:
    return f"{key}:{index}"


def _swarm_origin_read(reader: PeerBlobReader, key: str, offset: int,
                       length: int) -> bytes:
    """The origin transport of the swarm plane: one owned (or re-owned)
    chunk off the origin rotation. Every origin byte a swarm pull moves
    goes through here, called only from :class:`SwarmScheduler`, where
    the ownership decision lives."""
    buf = bytearray(length)
    with trace.span("chunk-origin", key=key, offset=offset, bytes=length):
        reader.pread_into(key, buf, offset)
    metrics.HUB.inc("swarm_origin_bytes_total", length)
    return bytes(buf)


class SwarmScheduler:
    """Chunk-level swarm fetch for one pull on one host.

    ``participants``: ``{host_id: base_url}`` of every host in the swarm,
    this one included (``self_id``). All hosts build the same
    :class:`HashRing` over the sorted host ids, so chunk ownership needs
    no coordination traffic.

    Between :meth:`start` and :meth:`close` run the origin pump (owned
    chunks off origin, rarest first), the gossip poller (siblings'
    possession bitmaps from ``/swarm/{pull}/{host}/chunks``; three
    straight failures declare a sibling dead), fill workers (advertised
    non-owned chunks from whichever sibling has them) and the reaper
    (chunks every live sibling holds and the local delivery has passed).

    A dead owner's chunk is re-owned by the next live host on its ring
    arc; only that successor goes back to origin (counted in
    ``swarm_chunks_refetched_total``), everyone else cross-fills.
    """

    def __init__(self, pull_id: str, self_id: str,
                 participants: dict[str, str],
                 chunk_bytes: int | None = None,
                 health: PeerHealth | None = None,
                 policy: RetryPolicy | None = None):
        if self_id not in participants:
            raise ValueError(f"self_id {self_id!r} not in participants")
        self.pull_id = pull_id
        self.self_id = self_id
        self.participants = dict(participants)
        self.chunk_bytes = chunk_bytes or default_chunk_bytes()
        self.ring = HashRing(sorted(participants))
        self.board = ChunkBoard(pull_id, self_id)
        self._health = health if health is not None else PeerHealth.shared()
        self._policy = policy if policy is not None else RetryPolicy()
        #: per-owner wait before a chunk succeeds to the next ring host,
        #: sized for a live-but-busy owner (death shows in ~3 gossip ticks)
        self._fill_timeout = swarm_placement.default_fill_timeout()
        self._gossip_s = env_int(
            "DEMODEL_SWARM_GOSSIP_MS", 500, minimum=10) / 1000.0
        self._fill_streams = env_int(
            "DEMODEL_SWARM_FILL_STREAMS", 4, minimum=1)
        #: concurrent origin connections per host
        self._origin_sem = threading.Semaphore(
            swarm_placement.default_origin_streams())
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: file key → (size, n_chunks, origin PeerBlobReader)
        self._files: dict[str, tuple[int, int, PeerBlobReader]] = {}
        self._primary: dict[tuple[str, int], str] = {}
        self._owned: list[tuple[str, int]] = []
        self._inflight: set[tuple[str, int]] = set()
        self._peer_have: dict[str, dict[str, set[int]]] = {}
        #: gossiped done-sets (have ∪ reaped) per sibling: the reap gate
        self._peer_done: dict[str, dict[str, set[int]]] = {}
        self._peer_ver: dict[str, int] = {}
        self._poll_fails: dict[str, int] = {}
        self._dead: set[str] = set()
        self._peer_bytes: dict[str, int] = {}   # file key → peer-fill bytes
        self._spread: dict[tuple[str, int], int] = {}  # rarest tie-break
        self.chunks_refetched = 0
        #: offsets of in-flight read_into calls per file: the reaper never
        #: frees below an active read's start
        self._active_reads: dict[str, list[int]] = {}
        #: per-file local consumption watermark
        self._consumed_upto: dict[str, int] = {}
        self._reap = swarm_placement.reap_enabled()
        self._reap_s = max(2 * self._gossip_s, 0.5)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        #: sibling polls and cross-fills (one connection per host per
        #: thread)
        self._client = HTTPClient()
        swarm_placement.register_board(self.board)

    # -- planning --------------------------------------------------------
    def add_file(self, key: str, size: int,
                 origin_reader: PeerBlobReader) -> None:
        """Register one manifest file's chunk grid, for every weight file
        before :meth:`start` (ownership is assigned over the whole grid)."""
        if self._threads:
            raise RuntimeError("add_file after start(): the ownership "
                               "assignment is already fixed")
        n = chunk_count(size, self.chunk_bytes)
        with self._lock:
            self._files[key] = (int(size), n, origin_reader)
            self._peer_bytes.setdefault(key, 0)
        self.board.add_file(key, n)

    def _plan(self) -> None:
        """Ring succession for agreement and death recovery, bounded
        loads for balance (the swarm's wall clock is the largest owned
        share's origin time)."""
        with self._lock:
            grid = [(k, i) for k, (_s, n, _r) in sorted(self._files.items())
                    for i in range(n)]
        with trace.span("swarm-schedule", chunks=len(grid),
                        files=len(self._files),
                        hosts=len(self.participants)) as sp:
            assigned = bounded_assign(
                self.ring, [_swarm_chunk_id(k, i) for k, i in grid])
            # _plan runs from start() before any pump thread exists, and
            # add_file refuses registration after start
            with self._lock:
                self._primary = {
                    (k, i): assigned[_swarm_chunk_id(k, i)]
                    for k, i in grid}
                self._owned = [c for c, owner in self._primary.items()
                               if owner == self.self_id]
                owned_n = len(self._owned)
            sp.set_attr("owned", owned_n)

    def start(self) -> "SwarmScheduler":
        if self._threads:
            return self
        self._plan()
        self._threads.append(threading.Thread(
            target=self._pump_origin, name="swarm-pump", daemon=True))
        if self._reap:
            self._threads.append(threading.Thread(
                target=self._pump_reap, name="swarm-reap", daemon=True))
        if len(self.participants) > 1:
            self._threads.append(threading.Thread(
                target=self._pump_gossip, name="swarm-gossip", daemon=True))
            for i in range(self._fill_streams):
                self._threads.append(threading.Thread(
                    target=self._pump_fill, name=f"swarm-fill-{i}",
                    daemon=True))
        for t in self._threads:
            t.start()
        return self

    def close(self) -> None:
        """Stop the pumps, free the board, unregister the serve surface.
        Closing before every sibling has the bytes pushes the swarm's
        stragglers back to origin: the caller decides when."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        self._threads.clear()
        swarm_placement.unregister_board(self.board)
        self.board.clear()
        self._client.close()

    # -- read surface ----------------------------------------------------
    def peer_bytes_for(self, key: str) -> int:
        with self._lock:
            return self._peer_bytes.get(key, 0)

    def read_into(self, key: str, view: memoryview, offset: int) -> int:
        """Copy ``[offset, offset+len(view))`` of ``key`` out of the
        board, blocking per covering chunk until the swarm lands it."""
        with self._lock:
            size, _n, _r = self._files[key]
        length = view.nbytes
        if offset < 0 or offset + length > size:
            raise IOError(f"swarm window [{offset}, {offset + length}) "
                          f"outside {key} of {size} bytes")
        # an in-flight read floors the reaper: prefetch workers complete
        # out of order as the norm
        with self._lock:
            self._active_reads.setdefault(key, []).append(offset)
        try:
            pos = 0
            while pos < length:
                idx = (offset + pos) // self.chunk_bytes
                c_off, c_len = chunk_span(size, self.chunk_bytes, idx)
                data = self.ensure(key, idx)
                lo = offset + pos - c_off
                take = min(c_len - lo, length - pos)
                view[pos:pos + take] = data[lo:lo + take]
                pos += take
        finally:
            with self._lock:
                self._active_reads[key].remove(offset)
        # completed-read high-water: a rare later re-read of a reaped
        # chunk degrades to one counted re-fetch, never a wrong byte
        with self._lock:
            if offset + length > self._consumed_upto.get(key, 0):
                self._consumed_upto[key] = offset + length
        return length

    def fetch_all(self) -> None:
        """Block until every chunk of every registered file is on the
        board (a host that joins the swarm without placing)."""
        with self._lock:
            grid = [(k, i) for k, (_s, n, _r) in sorted(self._files.items())
                    for i in range(n)]
        for key, idx in grid:
            self.ensure(key, idx)

    # -- chunk acquisition ----------------------------------------------
    def ensure(self, key: str, index: int) -> bytes:
        """The ownership decision: owned → origin; non-owned → wait for
        the owner's advertisement and cross-fill; owner dead or stuck →
        succession along the raw ring order, where only the next live
        host re-sources from origin."""
        chunk_id = _swarm_chunk_id(key, index)
        with self._lock:
            primary = self._primary.get((key, index))
        if primary is None:
            raise RuntimeError("ensure() before start(): no ownership "
                               "assignment yet")
        owners = [primary] + [
            o for o in self.ring.owners(chunk_id, len(self.participants))
            if o != primary]
        waited_since: dict[str, float] = {}
        while not self._stop.is_set():
            data = self.board.get(key, index)
            if data is not None:
                return data
            if self.board.reaped(key, index):
                # a local re-read wants a chunk the reaper freed (and the
                # siblings likely freed too): re-land it from origin
                self.board.unreap(key, index)
                metrics.HUB.inc("swarm_chunks_unreaped_total")
                self._fetch_origin(key, index, reowned=False)
                continue
            live = [o for o in owners if o not in self._snapshot_dead()]
            target = live[0] if live else self.self_id
            if target == self.self_id:
                self._fetch_origin(key, index,
                                   reowned=(owners[0] != self.self_id))
                continue
            # a sibling owns it: take it from any advertiser, else wait
            adv = self._advertisers(key, index)
            if adv:
                if self._fetch_peer(key, index, adv):
                    continue
            now = time.monotonic()
            waited_since.setdefault(target, now)
            if now - waited_since[target] > self._fill_timeout:
                # the live owner never produced the chunk: succession
                with self._lock:
                    self._dead.add(target)
                    self._cv.notify_all()
                log.warning(
                    "swarm owner %s never advertised chunk %s/%d within "
                    "%.0fs; treating it as dead (succession)", target,
                    key, index, self._fill_timeout)
                self._take_over_orphans()
                continue
            with self._cv:
                self._cv.wait(timeout=min(0.2, self._gossip_s))
        raise IOError(f"swarm pull {self.pull_id} closed while waiting "
                      f"for chunk {key}/{index}")

    def _snapshot_dead(self) -> set[str]:
        with self._lock:
            return set(self._dead)

    def _advertisers(self, key: str, index: int) -> list[str]:
        with self._lock:
            return [h for h, files in self._peer_have.items()
                    if h not in self._dead and index in files.get(key, ())]

    def _claim(self, key: str, index: int) -> bool:
        with self._lock:
            if (key, index) in self._inflight \
                    or self.board.done(key, index):
                return False
            self._inflight.add((key, index))
            return True

    def _release(self, key: str, index: int) -> None:
        with self._cv:
            self._inflight.discard((key, index))
            self._cv.notify_all()

    def _fetch_origin(self, key: str, index: int,
                      reowned: bool = False) -> None:
        if not self._claim(key, index):
            # someone else is on it: wait for their outcome
            with self._cv:
                self._cv.wait(timeout=0.2)
            return
        try:
            with self._lock:
                size, _n, reader = self._files[key]
            off, ln = chunk_span(size, self.chunk_bytes, index)
            with self._origin_sem:
                data = _swarm_origin_read(reader, key, off, ln)
            if reowned:
                with self._lock:
                    self.chunks_refetched += 1
                metrics.HUB.inc("swarm_chunks_refetched_total")
                log.info("swarm re-owned chunk %s/%d from origin "
                         "(owner dead)", key, index)
            self.board.put(key, index, data)
        finally:
            self._release(key, index)

    def _fetch_peer(self, key: str, index: int,
                    advertisers: list[str]) -> bool:
        """One cross-fill attempt off the best advertiser (ring owner
        first). True when the chunk landed or someone else's fetch is in
        flight (the caller re-checks the board)."""
        if not self._claim(key, index):
            return True
        chunk_id = _swarm_chunk_id(key, index)
        order = [o for o in self.ring.owners(chunk_id,
                                             len(self.participants))
                 if o in advertisers] or advertisers
        try:
            with self._lock:
                size, _n, _r = self._files[key]
            _off, ln = chunk_span(size, self.chunk_bytes, index)
            for host in order:
                url = self.participants[host]
                try:
                    with trace.span("chunk-peer-fill", key=key,
                                    index=index, peer=host, bytes=ln):
                        r = request_with_retry(
                            self._client, "GET",
                            f"{url}/swarm/{self.pull_id}/{host}"
                            f"/chunk/{key}/{index}",
                            policy=RetryPolicy(max_attempts=2,
                                               deadline=30.0),
                            health=self._health, peer=url.rstrip("/"),
                            timeout=30.0,
                            what=f"swarm chunk {key}/{index} from {host}")
                    if len(r.content) != ln:
                        raise TruncatedBody(
                            f"swarm chunk {key}/{index}: "
                            f"{len(r.content)} != {ln}")
                    metrics.HUB.inc("swarm_peer_bytes_total", ln)
                    with self._lock:
                        self._peer_bytes[key] = \
                            self._peer_bytes.get(key, 0) + ln
                    self.board.put(key, index, r.content)
                    return True
                except _WIRE_ERRORS as e:
                    log.warning("swarm fill of %s/%d from %s failed: %s",
                                key, index, host, e)
                    self._poll_failed(host)
            return False
        finally:
            self._release(key, index)

    # -- background pumps ------------------------------------------------
    def _pump_origin(self) -> None:
        """Owned chunks off origin, rarest first: among the remaining
        owned set, the chunk the fewest siblings advertise (hash
        tie-break). Runs until close(): succession can grow the owned
        set at any time."""
        while not self._stop.is_set():
            with self._lock:
                remaining = [c for c in self._owned
                             if c not in self._inflight
                             and not self.board.done(*c)]
                peer_have = {h: files
                             for h, files in self._peer_have.items()
                             if h not in self._dead}
            if not remaining:
                with self._cv:
                    self._cv.wait(timeout=0.5)
                continue

            def rarity(c: tuple[str, int]) -> tuple[int, int]:
                sk = self._spread.get(c)
                if sk is None:
                    sk = self._spread[c] = swarm_placement.spread_key(
                        _swarm_chunk_id(*c))
                n = sum(1 for files in peer_have.values()
                        if c[1] in files.get(c[0], ()))
                return (n, sk)

            key, index = min(remaining, key=rarity)
            with self._lock:
                reowned = self._primary.get((key, index)) != self.self_id
            try:
                # _primary is write-once at plan time; the fetch
                # re-claims under the lock before any work
                self._fetch_origin(key, index, reowned=reowned)
            except IOError as e:
                log.warning("swarm origin fetch of %s/%d failed: %s "
                            "(will retry / re-ensure on demand)",
                            key, index, e)
                with self._cv:
                    self._cv.wait(timeout=0.5)

    def _pump_gossip(self) -> None:
        # dead hosts stay in the poll rotation: death is a routing
        # verdict, and a recovered sibling re-enters on its first
        # successful poll
        siblings = [h for h in self.participants if h != self.self_id]
        while not self._stop.is_set():
            for host in siblings:
                if self._stop.is_set():
                    return
                self._poll_one(host)
            self._stop.wait(self._gossip_s)

    def _poll_one(self, host: str) -> None:
        # span-free and single-attempt: a poll failing against a dead
        # sibling is routine, and the next tick is the retry
        url = self.participants[host]
        try:
            r = self._client.request(
                "GET", f"{url}/swarm/{self.pull_id}/{host}/chunks",
                timeout=5.0)
            r.raise_for_status()
            self.merge_summary(host, r.json())
        except _WIRE_ERRORS + (ValueError, TypeError):
            self._poll_failed(host)

    def merge_summary(self, host: str, summary: dict) -> None:
        """Versioned merge of one sibling's possession bitmap."""
        if not isinstance(summary, dict):
            return
        try:
            version = int(summary.get("v", 0))
            files = summary.get("files", {})
            have = {
                str(k): bitmap_indices(str(spec.get("have", "")),
                                       int(spec.get("n", 0)))
                for k, spec in files.items() if isinstance(spec, dict)
            }
            # done ⊇ have; a summary without it degrades to have, which
            # only delays our reap
            done = {
                str(k): bitmap_indices(str(spec.get("done",
                                                    spec.get("have", ""))),
                                       int(spec.get("n", 0)))
                for k, spec in files.items() if isinstance(spec, dict)
            }
        except (TypeError, ValueError, AttributeError):
            return  # junk gossip degrades to nothing
        with self._cv:
            # a dead host's successful poll always wins: a restarted
            # sibling's board restarts its version near zero
            if host not in self._dead \
                    and version < self._peer_ver.get(host, -1):
                return  # stale reordering
            self._peer_ver[host] = version
            self._peer_have[host] = have
            self._peer_done[host] = done
            self._poll_fails[host] = 0
            if host in self._dead:
                # resurrection: chunks already taken over stay ours
                self._dead.discard(host)
                log.info("swarm sibling %s resurrected (gossip poll "
                         "succeeded)", host)
            self._cv.notify_all()

    def _poll_failed(self, host: str) -> None:
        died = False
        with self._cv:
            fails = self._poll_fails.get(host, 0) + 1
            self._poll_fails[host] = fails
            if fails >= 3 and host not in self._dead:
                self._dead.add(host)
                died = True
                log.warning("swarm sibling %s declared dead after %d "
                            "straight failures; its chunks re-own via "
                            "ring succession", host, fails)
            self._cv.notify_all()
        if died:
            self._take_over_orphans()

    def _take_over_orphans(self) -> None:
        """Proactive succession: chunks whose primary is dead and whose
        first live ring successor is this host join the origin pump now,
        so waiting siblings cross-fill from us."""
        with self._cv:
            dead = set(self._dead)
            mine = set(self._owned)
            takeover = []
            for (key, idx), primary in self._primary.items():
                if primary not in dead or (key, idx) in mine:
                    continue
                chunk_id = _swarm_chunk_id(key, idx)
                live = [o for o in self.ring.owners(
                            chunk_id, len(self.participants))
                        if o == self.self_id or o not in dead]
                if live and live[0] == self.self_id:
                    takeover.append((key, idx))
            if not takeover:
                return
            self._owned.extend(takeover)
            self._cv.notify_all()
        log.info("swarm succession: taking over %d orphaned chunk(s) "
                 "from dead sibling(s) %s", len(takeover), sorted(dead))

    def _pump_reap(self) -> None:
        """Free chunks that every live sibling already holds (by the
        gossiped done-sets) and the local delivery has consumed past; a
        solo board reaps on consumption alone."""
        while not self._stop.is_set():
            self._stop.wait(self._reap_s)
            if self._stop.is_set():
                return
            for key, index in self._reap_candidates():
                freed = self.board.reap(key, index)
                if freed:
                    metrics.HUB.inc("swarm_chunks_reaped_total")
                    metrics.HUB.inc("swarm_bytes_reaped_total", freed)

    def _reap_candidates(self) -> list[tuple[str, int]]:
        with self._lock:
            live = [h for h in self.participants
                    if h != self.self_id and h not in self._dead]
            # gate on the DONE sets: a sibling that reaped first stops
            # advertising a chunk, and gating on have would block every
            # later host from reaping it
            peer_done = {h: self._peer_done.get(h, {}) for h in live}
            sizes = {k: s for k, (s, _n, _r) in self._files.items()}
            consumed = dict(self._consumed_upto)
            floors = {k: min(starts) for k, starts
                      in self._active_reads.items() if starts}
        out = []
        for key, index in self.board.held():
            size = sizes.get(key)
            if size is None:
                continue
            c_off, c_len = chunk_span(size, self.chunk_bytes, index)
            safe_upto = min(consumed.get(key, 0),
                            floors.get(key, float("inf")))
            if c_off + c_len > safe_upto:
                continue  # local delivery may still need it
            if all(index in peer_done[h].get(key, ()) for h in live):
                out.append((key, index))
        return out

    def _pump_fill(self) -> None:
        """Cross-fill any advertised, non-local chunk: keeps the pipe
        full, so ensure() only waits for chunks the pumps have not
        reached."""
        while not self._stop.is_set():
            target = None
            with self._lock:
                for host, files in self._peer_have.items():
                    if host in self._dead:
                        continue
                    for key, idxs in files.items():
                        if key not in self._files:
                            continue
                        for i in sorted(idxs):
                            if (key, i) not in self._inflight \
                                    and not self.board.done(key, i):
                                target = (key, i)
                                break
                        if target:
                            break
                    if target:
                        break
            if target is None:
                with self._cv:
                    self._cv.wait(timeout=self._gossip_s)
                continue
            # the pick is advisory: _fetch_peer's _claim re-validates
            # under the lock before any bytes move
            adv = self._advertisers(*target)
            if adv:
                self._fetch_peer(*target, adv)

    def stats(self) -> dict:
        with self._lock:
            out = {
                "pull": self.pull_id, "host": self.self_id,
                "hosts": len(self.participants),
                "owned_chunks": len(self._owned),
                "chunks_refetched": self.chunks_refetched,
                "dead": sorted(self._dead),
                "peer_fill_bytes": sum(self._peer_bytes.values()),
            }
        out.update(self.board.stats())
        return out


class SwarmBlobReader:
    """Store-shaped reads served off a swarm scheduler's chunk board: what
    the delivery pipeline reads instead of an origin reader in swarm
    mode. ``bytes_fetched`` counts origin bytes (through the wrapped
    reader, headers included) plus this file's peer-fill bytes."""

    def __init__(self, scheduler: SwarmScheduler, remote_key: str,
                 size: int, origin_reader: PeerBlobReader):
        self.scheduler = scheduler
        self.remote_key = remote_key
        self._size = int(size)
        self._origin = origin_reader

    @property
    def bytes_fetched(self) -> int:
        return self._origin.bytes_fetched \
            + self.scheduler.peer_bytes_for(self.remote_key)

    def close(self) -> None:
        self._origin.close()

    def size(self, key: str) -> int:  # noqa: ARG002 — single-object reader
        return self._size

    def pread(self, key: str, length: int, offset: int) -> bytes:
        out = bytearray(length)
        self.pread_into(key, out, offset)
        return bytes(out)

    def pread_into(self, key: str, out, offset: int = 0) -> int:  # noqa: ARG002
        view = memoryview(out).cast("B")
        if view.nbytes == 0:
            return 0
        return self.scheduler.read_into(self.remote_key, view, offset)


class PipelineFailure(OSError):
    """A mid-pipeline delivery failure carrying the tensors that did land
    before the error: the caller resumes from them instead of redoing
    every device transfer."""

    def __init__(self, cause: OSError, partial: Placement):
        super().__init__(str(cause))
        self.cause = cause
        self.partial = partial


def _world_size() -> int:
    """Processes placing this pull: the ``torch.distributed`` world size,
    1 when it is not initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _default_prefetch_depth(mesh: Mesh) -> int:
    """Prefetch overlap needs a spare core or a transfer that leaves the
    core: 2 with more than one CPU; on one CPU, 1 when the copy goes to a
    CUDA device (it runs off the GIL) and 0 on the CPU (the "device"
    copy is a memcpy on the same core, which one fetch thread contends)."""
    if available_cpus() > 1:
        return 2
    return 1 if mesh.devices.flat[0].type == "cuda" else 0


def _deliver_jobs_pipelined(jobs, mesh: Mesh, plan: ShardingPlan,
                            cast_to: torch.dtype | None = None,
                            prefetch_depth: int | None = None) -> Placement:
    """Single-process safetensors delivery with a tensor prefetch window
    spanning file boundaries: while tensor N goes to the device, the next
    ``prefetch_depth`` tensors' byte windows download — wall clock about
    max(network, host→device) instead of their sum.

    ``jobs``: ``[(reader, key, name, spec)]`` in manifest order.
    """
    from concurrent.futures import ThreadPoolExecutor

    from demodel_tpu_torch.formats.safetensors import torch_dtype
    from demodel_tpu_torch.sink import tuner as tuner_mod
    from demodel_tpu_torch.sink.hbm import place_tensor
    from demodel_tpu_torch.sink.streaming import ByteBudget

    if prefetch_depth is None:
        prefetch_depth = env_int("DEMODEL_SINK_PREFETCH",
                                 _default_prefetch_depth(mesh), minimum=0)
    out = Placement(mesh_desc=f"{mesh.shape}")
    # landing buffers are charged to the budget the streaming sink
    # enforces (DEMODEL_SINK_BUFFER_MB)
    budget = ByteBudget(env_int("DEMODEL_SINK_BUFFER_MB", 1024,
                                minimum=1) << 20)

    # FIFO admission tickets: budget grants follow job order. The main
    # loop consumes futures in order, so if a later window could win
    # capacity freed for an earlier one, the three-way wait closes: main
    # blocks on the earlier future, whose worker blocks in acquire,
    # waiting for a release that only happens when main places the LATER
    # buffer. With tickets, the head job is the only one in acquire, and
    # everything it waits on is already in main's consume path.
    admission = {"next": 0, "dead": False}
    admit_cv = threading.Condition()

    # the closed loop: DEMODEL_TUNER=0 keeps every knob at its default
    tuner = (tuner_mod.PullTuner(budget=budget,
                                 prefetch_depth=prefetch_depth).start()
             if tuner_mod.tuner_enabled() else None)

    def fetch(job, idx):
        reader, key, name, spec = job
        nbytes = spec.end - spec.start
        with trace.span("prefetch-fetch", tensor=name, bytes=nbytes,
                        job=idx):
            # the ticket wait + budget charge: the "waiting for RAM"
            # stage of a slow pull
            with trace.span("budget-wait", bytes=nbytes):
                with admit_cv:
                    while admission["next"] != idx \
                            and not admission["dead"]:
                        admit_cv.wait()
                got = False
                try:
                    # charge before the bytes exist; released after place
                    budget.acquire(nbytes)
                    got = True
                finally:
                    try:
                        with admit_cv:
                            admission["next"] = idx + 1
                            admit_cv.notify_all()
                    except BaseException:
                        # the ticket is held by now: give it back
                        if got:
                            budget.release(nbytes)
                        raise
            try:
                buf = np.empty(nbytes, dtype=np.uint8)
                tuner_mod.fetch_windows(reader, key, buf, spec.start,
                                        tuner)
            except BaseException:
                budget.release(nbytes)
                raise
            return buf

    def place(buf, name, spec):
        mv = memoryview(buf)
        start = spec.start

        def read_at(off, ln, _mv=mv, _s=start):
            return _mv[off - _s:off - _s + ln]

        dtype = torch_dtype(spec.dtype)
        if name in out.arrays:
            raise ValueError(f"duplicate tensor across shards: {name}")
        sharding = plan.sharding_for(name, spec.shape, dtype.itemsize)
        with trace.span("place", tensor=name, bytes=buf.nbytes):
            out.arrays[name] = place_tensor(
                read_at, spec.shape, dtype, spec.start, mesh, sharding,
                cast_to)

    # phase accounting: fetch wall vs place wall tells a network-bound
    # pull from a device-transfer-bound one. Under prefetch overlap the
    # first key is the EXPOSED stall on the next buffer.
    fetch_key = "fetch_secs" if prefetch_depth == 0 else "fetch_stall_secs"
    phases = {fetch_key: 0.0, "place_secs": 0.0}
    out.phase_secs = phases

    if prefetch_depth == 0:
        # thread-free: fetch inline, place, next
        try:
            for i, (reader, key, name, spec) in enumerate(jobs):
                t0 = time.perf_counter()
                try:
                    buf = fetch((reader, key, name, spec), i)
                except OSError as e:
                    raise PipelineFailure(e, out) from e
                t1 = time.perf_counter()
                try:
                    place(buf, name, spec)
                finally:
                    budget.release(buf.nbytes)
                t2 = time.perf_counter()
                phases[fetch_key] += t1 - t0
                phases["place_secs"] += t2 - t1
        finally:
            if tuner is not None:
                tuner.stop()
        return out

    # with a live tuner the pool is sized to the prefetch ceiling and
    # the submit loop keeps only the tuner's current depth in flight
    pool_size = tuner.max_prefetch if tuner is not None else prefetch_depth
    with ThreadPoolExecutor(max_workers=max(1, pool_size)) as ex:
        # the try lives INSIDE the `with`: on an exception the executor's
        # __exit__ joins its workers, so a worker blocked in
        # budget.acquire has to be woken by abort() before that join
        try:
            pending: list = []
            next_job = 0

            def top_up() -> None:
                nonlocal next_job
                depth = (max(1, min(tuner.prefetch_depth, pool_size))
                         if tuner is not None else prefetch_depth)
                while len(pending) < depth and next_job < len(jobs):
                    pending.append(ex.submit(trace.wrap(fetch),
                                             jobs[next_job], next_job))
                    next_job += 1

            top_up()
            for i, (reader, key, name, spec) in enumerate(jobs):
                t0 = time.perf_counter()
                try:
                    buf = pending.pop(0).result()
                except OSError as e:
                    # surface what already landed: the resume path keeps it
                    for p in pending:
                        p.cancel()
                    raise PipelineFailure(e, out) from e
                t1 = time.perf_counter()
                top_up()
                try:
                    place(buf, name, spec)
                finally:
                    budget.release(buf.nbytes)
                phases[fetch_key] += t1 - t0
                phases["place_secs"] += time.perf_counter() - t1
        except BaseException:
            # wake both wait states before the executor join:
            # acquire-waiters via abort, ticket-waiters via "dead"
            budget.abort()
            with admit_cv:
                admission["dead"] = True
                admit_cv.notify_all()
            raise
        finally:
            if tuner is not None:
                tuner.stop()
    return out


def pull_manifest_to_hbm(
    model: str,
    peers: list[str],
    mesh: Mesh | None = None,
    plan: ShardingPlan | None = None,
    source: str = "hf",
    cast_to: torch.dtype | None = None,
    streams: int | None = None,
    swarm: SwarmScheduler | None = None,
):
    """Place ``model`` on the device straight off warm peers, reading only
    byte windows; no store is written on this node.

    ``mesh`` defaults to the CUDA device (a CPU mesh, e.g.
    ``make_mesh(device="cpu")``, places on the CPU). ``swarm``: a
    startable :class:`SwarmScheduler` makes this a swarm-mode cold pull —
    this host fetches only its ring-owned chunks from the peers and
    cross-fills the rest from its swarm siblings. The caller owns the
    scheduler: keep it open until every sibling is done, then close it.

    Returns ``(report, Placement)``; ``report["network_bytes"]`` is what
    this host read over the wire, ``report["weight_bytes"]`` the weight
    files' sizes.
    """
    import os

    if mesh is None:
        mesh = make_mesh()
    if plan is None:
        plan = ShardingPlan(mesh)
    profile_dir = os.environ.get("DEMODEL_PROFILE_DIR", "").strip()
    window = None
    if profile_dir:
        from demodel_tpu_torch.delivery import _ProfileWindow

        window = _ProfileWindow(profile_dir)
        window.start()
    try:
        # the root span of a sharded pull
        with trace.span("pull", model=model, source=source,
                        swarm=(swarm.self_id if swarm else None)):
            return _pull_manifest_to_hbm(model, peers, mesh, plan, source,
                                         cast_to, streams, swarm)
    finally:
        if window is not None:
            window.stop()


def _pull_manifest_to_hbm(model, peers, mesh, plan, source, cast_to,
                          streams, swarm=None):
    from demodel_tpu_torch.sink.hbm import deliver_gguf, deliver_safetensors

    t0 = time.perf_counter()
    peer, manifest = fetch_manifest(peers, model, source=source)
    placement = Placement(mesh_desc=f"{mesh.shape}")
    report: dict = {
        "name": model, "source": source, "peer": peer,
        "files": list(manifest.get("files", [])),
        "network_bytes": 0, "weight_bytes": 0, "pipelined": False,
    }
    readers: list = []
    # Peer policy in one process: files stripe over the RESPONSIVE peers,
    # with the rest of the order as failover. Several processes pin
    # everything to the manifest peer and re-raise on failure (a host
    # that retried a file locally would pair its collectives wrongly).
    single = _world_size() == 1
    if single:
        others = [p.rstrip("/") for p in peers if p.rstrip("/") != peer]
        peer_order = [peer] + _responsive_peers(others)
    else:
        peer_order = [peer]
    weight_files = []
    for f in manifest.get("files", []):
        if not is_weight_file(f["name"], f.get("media_type", "")):
            continue
        if int(f.get("size") or 0) <= 0:
            raise IOError(f"manifest entry {f['name']} lacks a size")
        weight_files.append(f)

    try:
        # safetensors in one process: one prefetch pipeline over all
        # tensors of all files in manifest order
        pipelined = False
        resume_skip: set = set()       # tensors placed by a failed pipeline
        file_tensors: dict = {}        # file key → its tensor names
        if (single and weight_files
                and all(f["name"].endswith(".safetensors")
                        for f in weight_files)):
            try:
                jobs = []
                health = PeerHealth.shared()
                # consistent hash with bounded loads: every host computes
                # the same file → primary peer, no peer's share exceeds
                # ceil(files/N); breaker-open peers drop out of the rest
                stripe = bounded_assign(
                    HashRing(peer_order), [f["key"] for f in weight_files])
                for f in weight_files:
                    primary = stripe.get(f["key"]) or peer_order[0]
                    rotated = [primary] + [p for p in peer_order
                                           if p != primary]
                    reader, index = _reader_and_index(
                        f, health.healthy(rotated), streams)
                    fkey, fsize = f["key"], int(f["size"])
                    file_tensors[fkey] = set(index.tensors)
                    if swarm is not None:
                        swarm.add_file(fkey, fsize, reader)
                        reader = SwarmBlobReader(swarm, fkey, fsize, reader)
                    readers.append(reader)
                    for tname, spec in index.tensors.items():
                        jobs.append((reader, fkey, tname, spec))
                if swarm is not None:
                    swarm.start()
                delivered = _deliver_jobs_pipelined(
                    jobs, mesh, plan, cast_to=cast_to)
                merge_placement(placement, delivered)
                report["phase_secs"] = delivered.phase_secs
                report["weight_bytes"] += sum(int(f["size"])
                                              for f in weight_files)
                pipelined = True
            except PipelineFailure as e:
                # keep every tensor that landed; the per-file failover
                # below delivers only the missing ones
                merge_placement(placement, e.partial)
                report["phase_secs"] = e.partial.phase_secs
                report["phase_secs_partial"] = True
                resume_skip = set(e.partial.arrays)
                log.warning("pipelined delivery failed (%s); %d tensors "
                            "landed — resuming the rest with per-file "
                            "failover", e.cause, len(resume_skip))
                report["weight_bytes"] = 0
            except OSError as e:
                # failure outside the pipeline loop (header/index reads):
                # nothing landed, full per-file fallback
                log.warning("pipelined delivery failed (%s); retrying "
                            "with per-file failover", e)
                placement = Placement(mesh_desc=f"{mesh.shape}")
                report["weight_bytes"] = 0
        report["pipelined"] = pipelined

        if not pipelined:
            for f in weight_files:
                name, key = f["name"], f["key"]
                size = int(f["size"])
                if resume_skip and key in file_tensors \
                        and file_tensors[key] <= resume_skip:
                    # every tensor of this file survived the pipeline
                    report["weight_bytes"] += size
                    continue
                placed = None
                last_err: Exception | None = None
                retry_order = PeerHealth.shared().healthy(peer_order)
                for pi, source_peer in enumerate(retry_order):
                    reader = PeerBlobReader(
                        source_peer, key, size, streams=streams,
                        failover=retry_order[pi + 1:] + retry_order[:pi])
                    readers.append(reader)  # wasted bytes count too
                    try:
                        if name.endswith(".safetensors"):
                            # skip ONLY the resume survivors, so the
                            # cross-shard duplicate guard stays on
                            placed = deliver_safetensors(
                                reader, key, mesh=mesh, plan=plan,
                                cast_to=cast_to, skip=resume_skip)
                        else:
                            placed = deliver_gguf(reader, key, mesh=mesh,
                                                  plan=plan)
                        break
                    except (OSError, ValueError) as e:
                        # ValueError: corrupt header bytes
                        last_err = e
                        log.warning("delivery of %s from %s failed (%s); "
                                    "trying next peer", name, source_peer,
                                    e)
                if placed is None:
                    raise IOError(f"no peer could serve {name}") \
                        from last_err
                merge_placement(placement, placed)
                report["weight_bytes"] += size
        t_block = time.perf_counter()
        # the single end-of-delivery sync: every copy is dispatched here
        device = mesh.devices.flat[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report["block_secs"] = round(time.perf_counter() - t_block, 3)
        report["network_bytes"] = sum(r.bytes_fetched for r in readers)
    finally:
        for r in readers:
            r.close()
    report["secs"] = round(time.perf_counter() - t0, 3)
    log.info("placed %d tensors (%.1f MB weights) from %s: fetched %.1f MB "
             "over the wire in %.2fs", len(placement.arrays),
             report["weight_bytes"] / 1e6, peer,
             report["network_bytes"] / 1e6, report["secs"])
    return report, placement


def materialize_aux_files(manifest: dict, peer: str, dest,
                          timeout: float = 60.0) -> list:
    """Fetch the small non-weight files (config, tokenizer, index) of a
    peer-held model into ``dest``; weight bytes stay on the wire → device
    path."""
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    client = HTTPClient()
    health = PeerHealth.shared()
    policy = RetryPolicy()
    out = []
    try:
        for f in manifest.get("files", []):
            if is_weight_file(f["name"], f.get("media_type", "")):
                continue
            r = request_with_retry(
                client, "GET", f"{peer}/peer/object/{f['key']}",
                policy=policy, health=health, peer=peer.rstrip("/"),
                timeout=timeout, what=f"aux file {f['name']}")
            p = dest / f["name"].replace("/", "_")
            p.write_bytes(r.content)
            out.append(p)
    finally:
        client.close()
    return out
