"""Peer shard cache (the port of ``demodel_tpu/parallel/peer.py``).

Every node's proxy serves its content-addressed store on
``/peer/index``, ``/peer/meta/{key}`` and ``/peer/object/{key}`` (the C++
data plane, range-aware; :class:`demodel_tpu_torch.proxy.ProxyServer`
serves it in the port). This module is the client side: find which peer
holds a key (or the same content under another key), fetch it into the
store with digest verification and resume, and say so when no peer has
it, so the caller goes to the upstream registry (:func:`ensure_artifacts`
over a whole artifact list). :meth:`PeerGossip.split` tells a sharded
pull which peers are alive without a probe round.

HTTP goes through :class:`~demodel_tpu_torch.utils.faults.HTTPClient`
(one connection per host per thread) under the wire retry policy and the
process-wide peer breakers; bulk bytes go through the native library
(``dm_peer_fetch_parallel``, Range streams into the store).
"""

from __future__ import annotations

import ctypes
import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import ClassVar

from demodel_tpu_torch import native, tier
from demodel_tpu_torch.parallel.placement import HashRing
from demodel_tpu_torch.store import Store
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.env import default_peer_streams, env_int
from demodel_tpu_torch.utils.faults import (TRANSPORT_ERRORS,
                                            DigestMismatch, HTTPClient,
                                            PeerHealth, RetryPolicy,
                                            request_with_retry)
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("peer")

#: what a peer answer can raise that degrades to "this peer has nothing":
#: transport and status errors, and junk bodies (json.JSONDecodeError is
#: a ValueError; a non-dict body makes ``.get`` raise TypeError)
PEER_ERRORS = TRANSPORT_ERRORS + (OSError, ValueError, TypeError)

#: the peer URLs the native data plane can dial: ``http://host[:port]``
_NATIVE_URL = re.compile(r"^http://(\[[0-9a-fA-F:]+\]|[^:/]+)(?::(\d+))?/?$")


def _index_keys(body) -> dict[str, str]:
    """``{key: sha256-or-""}`` of a ``/peer/index`` body; anything that is
    not ``{"keys": [{"key": ...}, ...]}`` gives what entries it can, or
    nothing (a captive portal or another service on the port must not
    crash a pull)."""
    entries = body.get("keys", ()) if isinstance(body, dict) else ()
    if not isinstance(entries, (list, tuple)):
        return {}
    return {str(e["key"]): str(e.get("sha256") or "")
            for e in entries if isinstance(e, dict) and "key" in e}


class PeerGossip:
    """Process-wide, versioned possession index over the peer set.

    Every ``/peer/index`` download in the process is observed here, and
    peers enrolled with :meth:`track` are re-polled every
    ``DEMODEL_SWARM_INDEX_REFRESH_S`` seconds by one background thread,
    so locate calls answer from the freshest index anything already
    paid for. Gossip never feeds the breakers: a background poller must
    not open breakers behind a live pull's back. :meth:`stop` ends the
    refresher (tests and ``chip_smoke.py`` call it, through
    :meth:`reset_shared` for the shared instance).
    """

    _shared: ClassVar["PeerGossip | None"] = None
    _shared_lock: ClassVar[threading.Lock] = threading.Lock()

    def __init__(self):
        self.refresh_s = float(
            env_int("DEMODEL_SWARM_INDEX_REFRESH_S", 2, minimum=1))
        self.max_keys = env_int("DEMODEL_SWARM_INDEX_KEYS", 65536,
                                minimum=16)
        self._lock = threading.Lock()
        #: peer → (version, keys or None, monotonic ts, ok)
        self._entries: dict[str, tuple[int, frozenset | None, float,
                                       bool]] = {}
        self._tracked: set[str] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @classmethod
    def shared(cls) -> "PeerGossip":
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls()
            return cls._shared

    @classmethod
    def reset_shared(cls) -> None:
        """Drop the process-wide instance, stopping its refresher."""
        with cls._shared_lock:
            inst, cls._shared = cls._shared, None
        if inst is not None:
            inst.stop()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)

    def observe(self, peer: str, keys: set[str] | None,
                ok: bool = True) -> None:
        """Merge one index outcome; ``keys=None, ok=False`` records a
        failed one."""
        peer = peer.rstrip("/")
        frozen = None
        if keys is not None:
            frozen = frozenset(sorted(keys)[:self.max_keys]
                               if len(keys) > self.max_keys else keys)
        with self._lock:
            version = self._entries.get(peer, (0,))[0] + 1
            self._entries[peer] = (version, frozen, time.monotonic(), ok)

    def track(self, peers: list[str]) -> None:
        """Enroll peers for background refresh (starts the refresher on
        first use; idempotent)."""
        cleaned = {p.rstrip("/") for p in peers if p}
        if not cleaned:
            return
        with self._lock:
            self._tracked |= cleaned
            start = self._thread is None and not self._stop.is_set()
            if start:
                self._thread = threading.Thread(
                    target=self._refresh_loop, name="peer-gossip",
                    daemon=True)
        if start:
            self._thread.start()

    def describe(self) -> dict[str, dict]:
        """The statusz view: each peer's freshness, never its key set."""
        now = time.monotonic()
        with self._lock:
            return {
                peer: {"version": v, "keys": len(k) if k is not None else 0,
                       "age_sec": round(now - ts, 3), "ok": ok}
                for peer, (v, k, ts, ok) in sorted(self._entries.items())
            }

    def _fresh(self, peer: str,
               max_age: float) -> tuple[frozenset | None, bool] | None:
        with self._lock:
            e = self._entries.get(peer.rstrip("/"))
        if e is None or time.monotonic() - e[2] > max_age:
            return None
        return e[1], e[3]

    def keys(self, peer: str) -> frozenset | None:
        """The possession set of ``peer`` if gossip saw it within three
        refresh periods, else None (the caller fetches the index
        itself)."""
        e = self._fresh(peer, 3 * self.refresh_s)
        if e is None or not e[1]:
            return None
        return e[0]

    def split(self, peers: list, max_age: float | None = None
              ) -> tuple[list, list, list]:
        """``(alive, dead, unknown)`` partition of ``peers`` by gossip
        freshness: only ``unknown`` (never heard from) peers still need a
        real probe."""
        age = max_age if max_age is not None else 3 * self.refresh_s
        alive: list = []
        dead: list = []
        unknown: list = []
        for p in peers:
            e = self._fresh(p, age)
            if e is None:
                unknown.append(p)
            elif e[1]:
                alive.append(p)
            else:
                dead.append(p)
        return alive, dead, unknown

    def _refresh_loop(self) -> None:
        client = HTTPClient()
        try:
            while not self._stop.wait(self.refresh_s):
                with self._lock:
                    peers = sorted(self._tracked)
                for peer in peers:
                    if self._stop.is_set():
                        return
                    self._refresh_one(client, peer)
        finally:
            client.close()

    def _refresh_one(self, client: HTTPClient, peer: str) -> None:
        # one attempt: a dead peer failing a background refresh is routine
        # liveness data, and the next tick is the retry
        try:
            r = client.request("GET", f"{peer}/peer/index", timeout=5.0)
            r.raise_for_status()
            self.observe(peer, set(_index_keys(r.json())), ok=True)
        except PEER_ERRORS:
            self.observe(peer, None, ok=False)


@dataclass
class PeerStats:
    from_peers: int = 0
    from_upstream: int = 0
    peer_bytes: int = 0
    misses: list = field(default_factory=list)


class PeerSet:
    """A set of peer base URLs (``http://host:port``)."""

    def __init__(self, peers: list[str], timeout: float = 30.0):
        self.peers = [p.rstrip("/") for p in peers]
        self.timeout = timeout
        #: process-wide breakers: a peer found dead anywhere is skipped
        #: here too
        self._health = PeerHealth.shared()
        self._policy = RetryPolicy()
        #: floor (seconds) between forced index refreshes, so a pull with
        #: many misses does not download every index once per artifact
        self.index_ttl = 5.0
        #: one connection per peer per thread: fetch workers share it
        self.http = HTTPClient()
        self._lock = threading.Lock()
        self._ring_cache: HashRing | None = None
        self._index_cache: dict[str, tuple[dict[str, str], float]] = {}
        #: one index download per peer at a time (a cold fan-out of fetch
        #: workers must not stampede /peer/index)
        self._index_fetch_locks: dict[str, threading.Lock] = {}

    def close(self) -> None:
        self.http.close()

    def index(self, peer: str, refresh: bool = False) -> dict[str, str]:
        """``{key: sha256-or-""}`` held by ``peer`` (cached; ``refresh``
        refetches at most once per ``index_ttl`` seconds). A peer that
        fails or answers junk has an empty index."""
        def fresh_enough(cached) -> bool:
            return cached is not None and (
                not refresh or time.monotonic() - cached[1] < self.index_ttl)

        with self._lock:
            cached = self._index_cache.get(peer)
            fetch_lock = self._index_fetch_locks.setdefault(
                peer, threading.Lock())
        if fresh_enough(cached):
            return cached[0]
        with fetch_lock:
            with self._lock:
                cached = self._index_cache.get(peer)
            if fresh_enough(cached):
                return cached[0]
            try:
                r = request_with_retry(
                    self.http, "GET", f"{peer}/peer/index",
                    policy=self._policy, health=self._health, peer=peer,
                    timeout=self.timeout, what=f"peer index {peer}")
                keys = _index_keys(r.json())
                PeerGossip.shared().observe(peer, set(keys))
            except PEER_ERRORS as e:
                log.warning("peer %s index failed: %s", peer, e)
                keys = {}
                PeerGossip.shared().observe(peer, None, ok=False)
            with self._lock:
                self._index_cache[peer] = (keys, time.monotonic())
            return keys

    def _ring(self) -> HashRing:
        ring = self._ring_cache
        if ring is None:
            ring = self._ring_cache = HashRing(self.peers)
        return ring

    def locate(self, key: str) -> str | None:
        """A peer holding ``key``: the ring's owner and its successor
        first (from gossip or the cached index, no broadcast), then a
        scan of every peer, cached indexes first, then refreshed ones.
        Peers whose breaker is open are skipped."""
        with trace.span("peer-locate", key=key) as sp:
            gossip = PeerGossip.shared()
            for peer in self._ring().owners(key, 2):
                if not self._health.admissible(peer):
                    continue
                known = gossip.keys(peer)
                if known is not None:
                    if key in known:
                        sp.set_attr("peer", peer)
                        return peer
                    continue
                if key in self.index(peer):
                    sp.set_attr("peer", peer)
                    return peer
            for refresh in (False, True):
                for peer in self.peers:
                    if not self._health.admissible(peer):
                        continue
                    if key in self.index(peer, refresh=refresh):
                        sp.set_attr("peer", peer)
                        return peer
            return None

    def locate_digest(self, digest: str) -> tuple[str, str] | None:
        """``(peer, their_key)`` of any object with sha256 ``digest``:
        dedup by content across differing keys."""
        for refresh in (False, True):
            for peer in self.peers:
                if not self._health.admissible(peer):
                    continue
                for k, sha in self.index(peer, refresh=refresh).items():
                    if sha == digest:
                        return peer, k
        return None

    def _find(self, key: str, expected_digest: str | None
              ) -> tuple[str, str] | None:
        """``(peer, remote_key)`` holding ``key``, or its content."""
        peer = self.locate(key)
        if peer is not None:
            return peer, key
        if expected_digest:
            hit = self.locate_digest(expected_digest)
            if hit is not None:
                log.info("peer %s holds digest %s as %s; deduping", hit[0],
                         expected_digest[:12], hit[1])
            return hit
        return None

    def _meta(self, peer: str, remote_key: str) -> dict:
        r = request_with_retry(
            self.http, "GET", f"{peer}/peer/meta/{remote_key}",
            policy=self._policy, health=self._health, peer=peer,
            timeout=self.timeout, what=f"peer meta {remote_key}")
        meta = r.json()
        if not isinstance(meta, dict):
            raise ValueError(f"peer meta for {remote_key} is not an object")
        return meta

    def fetch_into(self, store: Store, key: str,
                   expected_digest: str | None = None) -> bool:
        """Copy ``key`` from whichever peer has it into ``store``,
        verified against ``expected_digest`` (or the peer's recorded
        sha256), with the peer's meta sidecar. False when no peer has it
        or every way to fetch it failed. Concurrent calls for one key
        collapse to one transfer (the store's single-flight registry)."""
        if store.has(key):
            return True
        got = tier.shared(store).flights.do(
            "peer:" + key,
            lambda: store.has(key)
            or self._fetch_into_once(store, key, expected_digest))
        if got is None:  # waiter: the leader's outcome is in the store
            return store.has(key)
        return bool(got)

    def _fetch_into_once(self, store: Store, key: str,
                         expected_digest: str | None) -> bool:
        found = self._find(key, expected_digest)
        if found is None:
            return False
        peer, remote_key = found
        try:
            peer_meta = self._meta(peer, remote_key)
            want = expected_digest or peer_meta.get("sha256")
            if self._native_fetch(store, peer, key, want, peer_meta,
                                  remote_key):
                return True
            self._stream_object_into(store, peer, key, remote_key, want,
                                     peer_meta)
            return True
        except PEER_ERRORS as e:
            log.warning("peer fetch of %s from %s failed: %s", key, peer, e)
            return False

    def _stream_object_into(self, store: Store, peer: str, key: str,
                            remote_key: str, want: str | None,
                            peer_meta: dict) -> None:
        """Stream one object into the store under the retry policy: a
        transfer cut mid-body keeps its partial and the next attempt
        resumes it with a Range request. A digest mismatch drops the
        partial and does not retry."""

        def one_attempt() -> None:
            partial = store.partial_size(key)
            headers = {"Range": f"bytes={partial}-"} if partial > 0 else {}
            # a raw streaming GET (resume lives here, not in the retry
            # policy): carry the ambient span's traceparent on it
            headers = trace.inject_headers(headers) or headers
            r = self.http.request("GET", f"{peer}/peer/object/{remote_key}",
                                  headers=headers, stream=True,
                                  timeout=max(self.timeout, 300))
            try:
                resumed = partial > 0 and r.status_code == 206
                r.raise_for_status()
                w = store.begin(key, resume=resumed)
                try:
                    for chunk in r.iter_content(1 << 20):
                        w.append(chunk)
                    digest = w.digest()
                    if want and digest != want:
                        w.abort(keep_partial=False)
                        raise DigestMismatch(
                            f"peer digest mismatch for {key}: {digest} != "
                            f"{want}")
                    w.commit(peer_meta)
                except BaseException:
                    if w._open:  # noqa: SLF001 — writer state check
                        w.abort(keep_partial=True)
                    raise
            finally:
                r.close()

        with trace.span("peer-stream", key=remote_key, peer=peer):
            self._policy.call(
                one_attempt, peer=peer, health=self._health,
                what=f"peer object {remote_key} from {peer} "
                     "(each retry resumes the kept partial)")

    def _native_fetch(self, store: Store, peer: str, key: str,
                      want: str | None, peer_meta: dict,
                      remote_key: str) -> bool:
        """Socket(s) → store in the native data plane with digest
        verification, over ``DEMODEL_PEER_STREAMS`` Range connections.
        False sends the caller to the HTTP stream (https peers, native
        errors)."""
        m = _NATIVE_URL.match(peer)
        if m is None:
            return False
        host, port = m.group(1).strip("[]"), int(m.group(2) or 80)
        errbuf = ctypes.create_string_buffer(512)
        n = native.lib().dm_peer_fetch_parallel(
            store._h, host.encode(), port,  # noqa: SLF001 — data-plane handoff
            f"/peer/object/{remote_key}".encode(), key.encode(),
            int(peer_meta.get("size") or 0), default_peer_streams(),
            (want or "").encode(), json.dumps(peer_meta).encode(), errbuf,
            512)
        if n < 0:
            log.warning("native peer fetch of %s from %s failed: %s "
                        "(streaming it instead)", key, peer,
                        errbuf.value.decode(errors="replace"))
            return False
        return True


def ensure_artifacts(store: Store, artifacts: list, peers: PeerSet | None,
                     upstream_fetch=None) -> PeerStats:
    """Make every artifact local: peer first, upstream fallback.

    ``artifacts`` are objects or dicts with ``key``/``sha256``/``name``;
    ``upstream_fetch(artifact)`` runs for anything no peer holds.
    """
    from demodel_tpu_torch.registry.base import parallel_fetch

    stats = PeerStats()
    stats_lock = threading.Lock()
    t0 = time.perf_counter()

    def field_of(art, name: str, default=None):
        return getattr(art, name) if hasattr(art, name) \
            else art.get(name, default)

    def ensure_one(art):
        key = field_of(art, "key")
        sha = field_of(art, "sha256")
        name = field_of(art, "name", key)
        if store.has(key):
            return
        if peers is not None and peers.fetch_into(store, key,
                                                  expected_digest=sha):
            with stats_lock:
                stats.from_peers += 1
                stats.peer_bytes += store.size(key)
            return
        if upstream_fetch is not None:
            upstream_fetch(art)
            with stats_lock:
                stats.from_upstream += 1
        else:
            with stats_lock:
                stats.misses.append(name)

    # dedup by key: concurrent writers on one key would collide
    unique: dict[str, object] = {}
    for art in artifacts:
        unique.setdefault(field_of(art, "key"), art)
    parallel_fetch(list(unique.values()), ensure_one)
    if stats.from_peers or stats.from_upstream:
        log.info("ensured %d artifacts in %.2fs: %d from peers (%.1f MB), "
                 "%d upstream", len(artifacts), time.perf_counter() - t0,
                 stats.from_peers, stats.peer_bytes / 1e6,
                 stats.from_upstream)
    return stats
