"""Streaming fetch machinery for registry adapters (the port of
``demodel_tpu/registry/base.py``).

:class:`Fetcher` streams an upstream file into the content-addressed
store under its URI key, with chunk-level resume: a cache hit costs no
network, a kept partial resumes with a Range request, a known digest is
verified, and transport failures retry under the wire
:class:`~demodel_tpu_torch.utils.faults.RetryPolicy`, each attempt
resuming the partial. Large files with a known size fan out over several
native Range connections (``dm_upstream_fetch_parallel``). The HTTP
client is the standard library's
(:class:`~demodel_tpu_torch.utils.faults.HTTPClient`).

With a :class:`~demodel_tpu_torch.parallel.peer.PeerSet`, a miss asks
the peers first, whose bytes land in the store verified against the
file's digest; only what no peer holds goes to the upstream registry.
"""

from __future__ import annotations

import ctypes
import json
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from urllib.parse import urlsplit

from demodel_tpu_torch import native, tier
from demodel_tpu_torch.store import Store, key_for_uri
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.env import env_int
from demodel_tpu_torch.utils.faults import (TRANSPORT_ERRORS, DigestMismatch,
                                            HTTPClient, RetryPolicy,
                                            request_with_retry)
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("registry")

CHUNK = 1 << 20


def _registry_timeout() -> int:
    """Per-request timeout for upstream-registry metadata calls
    (``DEMODEL_REGISTRY_TIMEOUT``, seconds). Retries ride the wire
    :class:`RetryPolicy` on top of this."""
    return env_int("DEMODEL_REGISTRY_TIMEOUT", 60, minimum=1)


@dataclass
class FileArtifact:
    name: str
    uri: str            # canonical (pre-redirect) URI — store key derives from it
    key: str
    size: int
    sha256: str
    media_type: str = ""
    etag: str = ""
    from_cache: bool = False
    from_peer: bool = False
    resumed_from: int = 0
    secs: float = 0.0
    #: host landing buffer (memory-first delivery) — consumed by the
    #: device sink; never serialized into reports
    buffer: object = None
    #: True when the buffer's bytes were charged against the delivery's
    #: shared ByteBudget at allocation (the sink releases them on landing)
    budget_charged: bool = False


@dataclass
class PullReport:
    source: str
    name: str
    revision: str
    files: list[FileArtifact] = field(default_factory=list)
    secs: float = 0.0

    @property
    def total_bytes(self) -> int:
        return sum(f.size for f in self.files)

    def to_dict(self) -> dict:
        return {
            "source": self.source,
            "name": self.name,
            "revision": self.revision,
            "total_bytes": self.total_bytes,
            "secs": round(self.secs, 3),
            "files": [{k: v for k, v in vars(f).items()
                       if k not in ("buffer", "budget_charged")}
                      for f in self.files],
        }


class Fetcher:
    """Streaming downloader writing through the Store. One
    :class:`HTTPClient` keeps a connection per host per thread, so
    registry adapters fetch shards concurrently."""

    def __init__(self, store: Store, ca: str | None = None,
                 headers: dict | None = None, peers=None):
        self.store = store
        self.ca = ca
        self.http = HTTPClient(ca=ca, headers=headers)
        #: Optional[demodel_tpu_torch.parallel.peer.PeerSet]
        self.peers = peers
        #: one wire policy per Fetcher (constructed per pull, so env
        #: overrides land); upstream registries get retries but no
        #: breakers — there is exactly one of each, nothing to rotate to
        self._policy = RetryPolicy()

    def close(self) -> None:
        self.http.close()

    def get_json(self, url: str) -> dict:
        r = request_with_retry(self.http, "GET", url, policy=self._policy,
                               timeout=_registry_timeout(),
                               what=f"registry GET {url}")
        return r.json()

    def probe_lfs_digest(self, url: str) -> str | None:
        """HEAD ``url`` (no redirect follow) and return the LFS blob sha256
        from ``X-Linked-Etag`` when present (the HF Hub convention for
        ``/resolve`` of an LFS file). One cheap round-trip that enables
        content-address dedup and verification before any bytes move."""
        try:
            r = request_with_retry(
                self.http, "HEAD", url, policy=self._policy,
                timeout=min(30, _registry_timeout()), allow_redirects=False,
                check_status=False, what="LFS digest probe")
        except TRANSPORT_ERRORS:
            return None
        etag = (r.headers.get("X-Linked-Etag") or "").strip('"')
        if len(etag) == 64 and all(c in "0123456789abcdef" for c in etag):
            return etag
        return None

    def _try_upstream_parallel(self, url, name, expected_digest, media_type,
                               extra_headers, t0):
        """Large known-size upstream files fan out over N native Range
        connections. Returns a FileArtifact, or None to take the
        single-stream path. Never used for credentialed requests
        (Authorization would not be forwarded)."""
        streams = _upstream_streams()
        min_bytes = env_int("DEMODEL_UPSTREAM_PARALLEL_MIN_MB", 64,
                            minimum=1) << 20
        if streams <= 1 or extra_headers:
            return None
        try:
            h = request_with_retry(
                self.http, "HEAD", url, policy=self._policy,
                timeout=min(30, _registry_timeout()), allow_redirects=True,
                check_status=False, what="upstream size probe")
        except TRANSPORT_ERRORS:
            return None
        size = int(h.headers.get("Content-Length") or 0)
        if (not h.ok or size < min_bytes
                or "bytes" not in h.headers.get("Accept-Ranges", "")):
            return None
        parts = urlsplit(h.url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            return None
        if "Authorization" in self.http.headers and not (
                h.url != url and parts.query):
            # a gated-repo token never enters the native path, which
            # forwards no auth: only a redirect to a signed URL (query-
            # string credentials) may go there
            return None
        port = parts.port or (443 if parts.scheme == "https" else 80)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        ca = self.ca or ""
        key = key_for_uri(url)
        meta = {
            "uri": url, "name": name, "size": size,
            "sha256": expected_digest or "", "media_type": media_type,
            "final_url": h.url,
            "headers": {"content-type": h.headers.get("Content-Type", "")},
        }
        errbuf = ctypes.create_string_buffer(512)
        n = native.lib().dm_upstream_fetch_parallel(
            self.store._h,  # noqa: SLF001 — data-plane handoff
            parts.hostname.encode(), port,
            1 if parts.scheme == "https" else 0, ca.encode(), path.encode(),
            key.encode(), size, streams, (expected_digest or "").encode(),
            json.dumps(meta).encode(), errbuf, 512)
        if n != size:
            log.debug("native upstream parallel fetch of %s failed (%s); "
                      "using single-stream", name,
                      errbuf.value.decode(errors="replace"))
            return None
        dt = time.perf_counter() - t0
        log.info("fetched %s: %d bytes upstream over %d streams in %.2fs",
                 name, size, streams, dt)
        stored = self.store.meta(key) or {}
        return FileArtifact(
            name=name, uri=url, key=key, size=size,
            sha256=stored.get("sha256", expected_digest or ""),
            media_type=media_type, etag=h.headers.get("ETag", "").strip('\'"'),
            secs=dt,
        )

    def fetch(
        self,
        url: str,
        name: str,
        expected_digest: str | None = None,
        media_type: str = "",
        extra_headers: dict | None = None,
    ) -> FileArtifact:
        """Stream ``url`` into the store under its URI key.

        - cache hit → served locally, zero network;
        - partial present → resumed with a Range request (a full restart
          when the server ignores the range);
        - ``expected_digest`` (hex sha256) verified against the streamed
          bytes; a mismatch removes the entry and raises
          :class:`DigestMismatch`;
        - transport failures (resets, timeouts, 429/5xx, truncation)
          retry under the wire :class:`RetryPolicy`, each attempt
          resuming from the kept partial — digest mismatches and other
          4xx never retry.
        """
        with trace.span("registry-fetch", file=name) as sp:
            # single-flight admission on the registry miss edge: N
            # concurrent fetches of one key cost one upstream transfer —
            # the leader runs the retried fetch, waiters re-run
            # _fetch_once afterwards (a cache hit, zero network)
            art = tier.shared(self.store).flights.do(
                "origin:" + key_for_uri(url),
                lambda: self._policy.call(
                    lambda: self._fetch_once(url, name, expected_digest,
                                             media_type, extra_headers),
                    what=f"fetch {name} "
                         "(each retry resumes the kept partial)"))
            if art is None:  # waiter — the leader landed it
                art = self._fetch_once(url, name, expected_digest,
                                       media_type, extra_headers)
            sp.set_attr("bytes", art.size)
            sp.set_attr("from_peer", art.from_peer)
            sp.set_attr("from_cache", art.from_cache)
            return art

    def _fetch_once(
        self,
        url: str,
        name: str,
        expected_digest: str | None = None,
        media_type: str = "",
        extra_headers: dict | None = None,
    ) -> FileArtifact:
        key = key_for_uri(url)
        t0 = time.perf_counter()
        if (not self.store.has(key) and expected_digest
                and self.store.has_digest(expected_digest)):
            # content-address hit: the same bytes are already local under
            # another key — publish a hardlink, zero transfer
            try:
                self.store.materialize(key, expected_digest, {
                    "uri": url, "name": name, "sha256": expected_digest,
                    "media_type": media_type,
                })
                log.info("dedup %s: materialized from local digest %s", name,
                         expected_digest[:12])
            except OSError as e:
                # benign race: the last key holding that digest was
                # removed between has_digest and link — fetch normally
                log.debug("dedup %s failed (%s); fetching normally", name, e)
        from_peer = False
        if not self.store.has(key) and self.peers is not None:
            # a peer that holds the bytes beats the upstream registry
            from_peer = self.peers.fetch_into(
                self.store, key, expected_digest=expected_digest)
        meta = self.store.meta(key) if self.store.has(key) else None
        if meta is not None:
            if expected_digest and meta.get("sha256") != expected_digest:
                log.warning("cached %s digest mismatch; refetching", name)
                self.store.remove(key)
            else:
                return FileArtifact(
                    name=name, uri=url, key=key,
                    size=meta.get("size", self.store.size(key)),
                    sha256=meta.get("sha256", ""), media_type=media_type,
                    etag=meta.get("etag", ""), from_cache=not from_peer,
                    from_peer=from_peer, secs=time.perf_counter() - t0,
                )

        if self.store.partial_size(key) == 0:
            art = self._try_upstream_parallel(url, name, expected_digest,
                                              media_type, extra_headers, t0)
            if art is not None:
                return art

        resumed_from = 0
        partial = self.store.partial_size(key)
        headers = dict(extra_headers or {})
        if partial > 0:
            headers["Range"] = f"bytes={partial}-"

        r = self.http.request("GET", url, headers=headers, stream=True,
                              timeout=300, allow_redirects=True)
        if partial > 0 and r.status_code == 416:
            # partial covers the whole object (e.g. crash between last
            # byte and commit) — the range is unsatisfiable; restart clean
            r.close()
            r = self.http.request("GET", url, headers=extra_headers,
                                  stream=True, timeout=300,
                                  allow_redirects=True)
            partial = 0
        try:
            if partial > 0 and r.status_code == 206:
                w = self.store.begin(key, resume=True)
                resumed_from = partial
            else:
                r.raise_for_status()
                w = self.store.begin(key, resume=False)
            try:
                for chunk in r.iter_content(CHUNK):
                    w.append(chunk)
                digest = w.digest()
                if expected_digest and digest != expected_digest:
                    w.abort(keep_partial=False)
                    raise DigestMismatch(
                        f"digest mismatch for {name}: got {digest}, want "
                        f"{expected_digest}")
                etag = (r.headers.get("ETag") or "").strip('"')
                size = w.offset
                w.commit(
                    {
                        "uri": url,
                        "name": name,
                        "size": size,
                        "sha256": digest,
                        "etag": etag,
                        "media_type": media_type,
                        "final_url": r.url,
                        "headers": {
                            "content-type": r.headers.get("Content-Type", ""),
                            "content-encoding": r.headers.get(
                                "Content-Encoding", ""),
                        },
                    }
                )
            except BaseException:
                # keep bytes for resume on transport errors; a digest
                # mismatch already dropped them above
                if w._open:  # noqa: SLF001 — writer state check
                    w.abort(keep_partial=True)
                raise
        finally:
            r.close()
        dt = time.perf_counter() - t0
        log.info("fetched %s: %d bytes in %.2fs (resumed_from=%d)", name, size,
                 dt, resumed_from)
        return FileArtifact(
            name=name, uri=url, key=key, size=size, sha256=digest,
            media_type=media_type, etag=etag, resumed_from=resumed_from,
            secs=dt,
        )


def _upstream_streams() -> int:
    """Range connections per large upstream fetch
    (``DEMODEL_UPSTREAM_STREAMS``); 1 disables the native upstream path."""
    return env_int("DEMODEL_UPSTREAM_STREAMS", 4, minimum=1)


def fetch_workers() -> int:
    """Concurrent shard fetches per pull (``DEMODEL_FETCH_WORKERS``), so a
    multi-shard checkpoint fills the link instead of round-tripping per
    file."""
    return env_int("DEMODEL_FETCH_WORKERS", 8, minimum=1)


def parallel_fetch(jobs: list, fn) -> list:
    """Run ``fn(job)`` over a thread pool, preserving job order.

    Any failure cancels nothing already in flight (their partials stay
    resumable) but re-raises the first error after all workers settle."""
    if len(jobs) <= 1 or fetch_workers() == 1:
        return [fn(j) for j in jobs]
    # trace.wrap PER JOB: worker threads don't inherit contextvars, and a
    # context can only be entered by one thread at a time
    with ThreadPoolExecutor(max_workers=min(fetch_workers(), len(jobs))) as ex:
        futs = [ex.submit(trace.wrap(fn), j) for j in jobs]
        return [f.result() for f in futs]
