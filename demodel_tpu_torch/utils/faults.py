"""Wire-plane fault tolerance for the pull path (the part of
``demodel_tpu/utils/faults.py`` a registry pull touches), on the
standard library's ``http.client``.

- :class:`HTTPClient` — keep-alive HTTP(S) with one connection per host
  per thread (the reference's per-thread ``requests.Session``), redirects
  followed, TLS verified against the system store or ``ca``.
- :class:`RetryPolicy` — exponential backoff with full jitter, bounded by
  an attempt cap (``DEMODEL_RETRY_MAX``) and a wall-clock deadline
  (``DEMODEL_RETRY_DEADLINE``), over the explicit classification of
  :func:`retryable`: connect errors, resets, timeouts, 429/5xx and
  truncated bodies retry; digest mismatches and other 4xx don't.
- :class:`PeerHealth` — a process-wide registry of per-peer
  :class:`CircuitBreaker`\\ s (closed → open after consecutive failures →
  one half-open probe per cooldown until a success closes it), shared
  by every peer caller, so a peer that dies mid-pull stops costing each
  remaining file a full timeout.
- :func:`peer_cannot_serve` — a healthy peer that cannot serve this
  object (a missing blob, an ignored Range): the caller fails over to
  another peer instead of retrying this one.
- :func:`request_with_retry` — one request under a policy, feeding a
  peer's breaker when ``health=`` and ``peer=`` name one.

Sleeps and clocks are injectable, so the policy and the breakers
unit-test without real sleeps.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import ssl
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, ClassVar, Iterator, TypeVar
from urllib.parse import urljoin, urlsplit

from demodel_tpu_torch.utils import metrics
from demodel_tpu_torch.utils.env import env_int
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("faults")

T = TypeVar("T")


# ------------------------------------------------------------ error taxonomy


class WireError(IOError):
    """A transport-shaped failure worth retrying (reset, truncation, a peer
    answering the wrong protocol) — as opposed to a content-shaped one."""


class TruncatedBody(WireError):
    """The server promised N bytes and delivered fewer before a clean
    close — retryable: the next attempt resumes at the received offset."""


class RangeIgnored(WireError):
    """The peer answered 200-from-zero to a nonzero Range request. Not
    retryable against the same peer (it will ignore the next Range too);
    :func:`peer_cannot_serve` marks it failover-eligible."""


class DigestMismatch(IOError):
    """Delivered bytes hash wrong. NOT retryable: the transfer completed,
    so the wire is fine and the server's copy (or our expectation) is
    poisoned — re-reading the same object cannot converge."""


class BreakerOpen(IOError):
    """A request was refused locally because the peer's breaker is open."""


class HTTPError(IOError):
    """A non-2xx answer; ``response`` carries the status and headers."""

    def __init__(self, response: "Response"):
        super().__init__(f"HTTP {response.status_code} for {response.url}")
        self.response = response


#: HTTP statuses a retry can plausibly outlive (408 request-timeout, 429
#: backpressure, and the transient 5xx family)
RETRYABLE_STATUS = frozenset({408, 429, 500, 502, 503, 504})

#: what one HTTP exchange can raise besides a status: resets, refused
#: connects, timeouts, protocol junk, TLS and name-resolution failures
TRANSPORT_ERRORS = (WireError, HTTPError, http.client.HTTPException,
                    ConnectionError, TimeoutError, ssl.SSLError,
                    socket.gaierror)


def retryable(exc: BaseException) -> bool:
    """The classification every wire caller shares: transport errors,
    resets, timeouts, 429/5xx and truncated bodies retry; digest
    mismatches, JSON junk, other 4xx and local (store) errors don't."""
    if isinstance(exc, (DigestMismatch, BreakerOpen, RangeIgnored)):
        return False
    if isinstance(exc, WireError):
        return True
    if isinstance(exc, HTTPError):
        status = exc.response.status_code
        return status in RETRYABLE_STATUS or status >= 500
    if isinstance(exc, ValueError):
        return False  # junk content (json.JSONDecodeError), not the wire
    return isinstance(exc, (http.client.HTTPException, ConnectionError,
                            TimeoutError, ssl.SSLError, socket.gaierror))


def peer_cannot_serve(exc: BaseException) -> bool:
    """THIS peer cannot serve THIS object, though the peer is healthy: a
    missing blob (404/410), an unsatisfiable or ignored Range, an
    unimplemented method. Not a health event and not worth a same-peer
    retry — but a rotation holding the same key tries its next peer."""
    if isinstance(exc, RangeIgnored):
        return True
    if isinstance(exc, HTTPError):
        status = exc.response.status_code
        return 400 <= status < 500 and status not in RETRYABLE_STATUS
    return False


# --------------------------------------------------------------- HTTP client


class Response:
    """One answer: ``status_code``, case-insensitive ``headers``, the final
    ``url`` after redirects, and the body (read whole unless streamed)."""

    def __init__(self, raw: http.client.HTTPResponse, method: str, url: str,
                 release: Callable[[bool], None]):
        self.status_code = raw.status
        self.headers = raw.headers
        self.url = url
        self._raw = raw
        self._release: Callable[[bool], None] | None = release
        self._content: bytes | None = None
        n = raw.headers.get("Content-Length", "")
        bodiless = method == "HEAD" or raw.status in (204, 304) \
            or raw.status < 200
        self._length = int(n) if n.isdigit() and not bodiless else None

    @property
    def ok(self) -> bool:
        return self.status_code < 400

    def iter_content(self, chunk: int) -> Iterator[bytes]:
        """The body in chunks of up to ``chunk`` bytes; raises
        :class:`TruncatedBody` when the server closes before its
        ``Content-Length``."""
        got = 0
        clean = False
        try:
            while True:
                part = self._raw.read(chunk)
                if not part:
                    break
                got += len(part)
                yield part
            if self._length is not None and got < self._length:
                raise TruncatedBody(f"{self.url}: {got} of {self._length} "
                                    "bytes before the connection closed")
            clean = True
        finally:
            self._finish(reusable=clean)

    @property
    def content(self) -> bytes:
        if self._content is None:
            self._content = b"".join(self.iter_content(1 << 20))
        return self._content

    def json(self) -> Any:
        return json.loads(self.content)

    def raise_for_status(self) -> None:
        if not self.ok:
            self.close()
            raise HTTPError(self)

    def close(self) -> None:
        """Release the connection; one with an unread body is closed."""
        self._finish(reusable=self._raw.isclosed())

    def _finish(self, reusable: bool) -> None:
        if self._release is not None:
            release, self._release = self._release, None
            release(reusable and not self._raw.will_close)


#: a kept-alive connection the server closed meanwhile fails with these
#: before any answer; the request then goes once more on a fresh one
_STALE = (http.client.RemoteDisconnected, ConnectionResetError,
          BrokenPipeError)


class HTTPClient:
    """Keep-alive HTTP(S) over ``http.client``: one connection per
    (scheme, host, port) per thread, so fetch workers share a client.
    ``ca`` verifies TLS against that bundle instead of the system store.
    :meth:`close` closes every connection the client opened.
    """

    MAX_REDIRECTS = 10

    def __init__(self, ca: str | None = None,
                 headers: dict[str, str] | None = None):
        self.headers = dict(headers or {})
        self._ctx = ssl.create_default_context(cafile=ca) if ca else \
            ssl.create_default_context()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._opened: list[http.client.HTTPConnection] = []

    def _idle(self) -> dict:
        return self._tls.__dict__.setdefault("idle", {})

    def _new_conn(self, scheme: str, host: str, port: int,
                  timeout: float) -> http.client.HTTPConnection:
        if scheme == "https":
            conn = http.client.HTTPSConnection(host, port, timeout=timeout,
                                               context=self._ctx)
        else:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
        with self._lock:
            self._opened.append(conn)
        return conn

    def _once(self, method: str, url: str, headers: dict[str, str],
              timeout: float) -> Response:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"unsupported URL {url!r}")
        port = parts.port or (443 if parts.scheme == "https" else 80)
        key = (parts.scheme, parts.hostname, port)
        path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        conn = self._idle().pop(key, None)
        if conn is not None and conn.sock is not None:
            conn.sock.settimeout(timeout)
        while True:
            reused = conn is not None
            if conn is None:
                conn = self._new_conn(*key, timeout)
            try:
                conn.request(method, path, headers=headers)
                raw = conn.getresponse()
                break
            except _STALE:
                conn.close()
                if not reused:
                    raise
                conn = None
            except BaseException:
                conn.close()
                raise

        def release(reusable: bool) -> None:
            if not reusable:
                conn.close()
                return
            old = self._idle().pop(key, None)
            if old is not None:
                old.close()
            self._idle()[key] = conn

        return Response(raw, method, url, release)

    def request(self, method: str, url: str, *,
                headers: dict[str, str] | None = None, timeout: float = 60,
                allow_redirects: bool = True,
                stream: bool = False) -> Response:
        """One request (redirects followed when asked). The body is read
        whole unless ``stream``; a streamed body must be iterated or
        closed."""
        hdrs = {**self.headers, **(headers or {})}
        for _ in range(self.MAX_REDIRECTS + 1):
            r = self._once(method, url, hdrs, timeout)
            location = r.headers.get("Location")
            if not (allow_redirects and location
                    and r.status_code in (301, 302, 303, 307, 308)):
                break
            r.content  # drained, so the connection is reused
            url = urljoin(url, location)
            if r.status_code == 303 and method != "HEAD":
                method = "GET"
        else:
            raise WireError(f"more than {self.MAX_REDIRECTS} redirects")
        if not stream:
            r.content
        return r

    def close(self) -> None:
        with self._lock:
            opened, self._opened = self._opened, []
        for conn in opened:
            conn.close()


# --------------------------------------------------------------- RetryPolicy


def _default_max_attempts() -> int:
    return env_int("DEMODEL_RETRY_MAX", 4, minimum=1)


def _default_deadline() -> float:
    """Wall-clock budget across all attempts of one logical operation;
    it must exceed the largest per-attempt read timeout (300 s object
    streams), or a first-attempt stall eats the whole budget."""
    return float(env_int("DEMODEL_RETRY_DEADLINE", 600, minimum=1))


def _default_base_delay() -> float:
    return env_int("DEMODEL_RETRY_BASE_MS", 100, minimum=1) / 1000.0


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter (``uniform(0, base·2^k)``),
    capped by attempts AND a wall-clock deadline."""

    max_attempts: int = field(default_factory=_default_max_attempts)
    #: wall-clock budget across ALL attempts of one logical operation
    deadline: float = field(default_factory=_default_deadline)
    base_delay: float = field(default_factory=_default_base_delay)
    max_delay: float = 5.0
    #: injectables — tests swap in stubs; no real sleeps on fast paths
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    rng: random.Random = field(default_factory=random.Random)

    def next_delay(self, attempt: int) -> float:
        """Full-jitter delay before retry number ``attempt`` (1-based)."""
        ceiling = min(self.base_delay * (2 ** max(0, attempt - 1)),
                      self.max_delay)
        return self.rng.uniform(0.0, ceiling)

    def deadline_left(self, start: float) -> float:
        return self.deadline - (self.clock() - start)

    def should_retry(self, attempt: int, start: float,
                     exc: BaseException) -> float | None:
        """The retry decision for loops with their own resume semantics
        (partial windows): None means give up (not retryable, attempt cap
        or deadline), else the jittered, deadline-clipped backoff to sleep
        before attempt+1."""
        if not retryable(exc):
            return None
        left = self.deadline_left(start)
        if attempt >= self.max_attempts or left <= 0:
            return None
        return min(self.next_delay(attempt), left)

    def call(self, fn: Callable[[], T], *, what: str = "",
             peer: str | None = None,
             health: "PeerHealth | None" = None) -> T:
        """Run ``fn`` under this policy: retryable failures back off and
        re-try until the attempt cap or deadline; every outcome feeds
        ``health`` (when given with ``peer``) and the retry counters."""
        start = self.clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                result = fn()
            except Exception as e:  # noqa: BLE001 — classified right below
                if health is not None and peer is not None and retryable(e):
                    health.record_failure(peer)
                left = self.deadline_left(start)
                if (not retryable(e) or attempt >= self.max_attempts
                        or left <= 0):
                    raise
                if health is not None and peer is not None \
                        and not health.admissible(peer):
                    # the breaker opened under our own failures: more
                    # same-peer retries are the stampede it exists to stop
                    raise
                delay = min(self.next_delay(attempt), max(0.0, left))
                count_retry(delay=delay, peer=peer)
                log.warning("%s failed (%s: %s); retry %d/%d in %.2fs",
                            what or "wire call", type(e).__name__, e,
                            attempt, self.max_attempts - 1, delay)
                self.sleep(delay)
            else:
                if health is not None and peer is not None:
                    health.record_success(peer)
                return result


def count_retry(delay: float | None = None, peer: str | None = None) -> None:
    """One retry against ``peer`` (or an upstream when None); ``delay``
    (the backoff about to be slept) feeds the ``retry_delay_seconds``
    histogram. The reference takes ``(peer, delay)``: call by keyword."""
    name = "peer_retries_total"
    metrics.HUB.inc(metrics.labeled(name, peer=peer) if peer else name)
    if delay is not None:
        metrics.HUB.observe("retry_delay_seconds", delay)


# ----------------------------------------------------------- circuit breaker


def default_breaker_threshold() -> int:
    return env_int("DEMODEL_BREAKER_THRESHOLD", 3, minimum=1)


def default_breaker_cooldown() -> float:
    return float(env_int("DEMODEL_BREAKER_COOLDOWN", 15, minimum=1))


#: ``peer_breaker_state`` gauge values
STATE_CLOSED, STATE_HALF_OPEN, STATE_OPEN = 0, 1, 2

_STATE_NAMES = {STATE_CLOSED: "closed", STATE_HALF_OPEN: "half-open",
                STATE_OPEN: "open"}


class CircuitBreaker:
    """Per-peer breaker: closed → open after ``threshold`` consecutive
    failures → one half-open probe per ``cooldown`` until a success closes
    it again. Thread-safe; the clock is injectable."""

    def __init__(self, peer: str, threshold: int, cooldown: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.peer = peer
        self.threshold = threshold
        self.cooldown = cooldown
        self._clock = clock
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0

    def state(self) -> int:
        with self._lock:
            return self._state

    def admissible(self) -> bool:
        """Read-only: could a request go to this peer now? For filters
        that may never dial the peer — it claims no probe slot
        (:meth:`allow` claims)."""
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            now = self._clock()
            if self._state == STATE_OPEN:
                return now - self._opened_at >= self.cooldown
            return not (self._probing
                        and now - self._probe_started < self.cooldown)

    def allow(self) -> bool:
        """May a request go to this peer now? Call it right before
        dialing: an open breaker whose cooldown elapsed admits exactly
        one caller as the half-open probe (the claim is this call);
        everyone else is refused until the probe reports."""
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            now = self._clock()
            if self._state == STATE_OPEN:
                if now - self._opened_at < self.cooldown:
                    return False
                self._set_state(STATE_HALF_OPEN)
                self._probing = True
                self._probe_started = now
                return True
            # half-open: one probe in flight; re-admit if the prober
            # vanished without reporting
            if self._probing and now - self._probe_started < self.cooldown:
                return False
            self._probing = True
            self._probe_started = now
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != STATE_CLOSED:
                log.info("peer %s breaker closed", self.peer)
                self._set_state(STATE_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            failed_probe = self._state == STATE_HALF_OPEN
            self._probing = False
            if self._state == STATE_OPEN:
                # a dial past the elapsed cooldown failed: the peer is
                # still dead, so the cooldown starts again
                self._opened_at = self._clock()
                return
            if failed_probe or (self._state == STATE_CLOSED
                                and self._failures >= self.threshold):
                self._opened_at = self._clock()
                self._set_state(STATE_OPEN)
                metrics.HUB.inc(metrics.labeled(
                    "peer_breaker_open_total", peer=self.peer))
                log.warning("peer %s breaker OPEN (%d consecutive "
                            "failures); cooling down %.1fs", self.peer,
                            self._failures, self.cooldown)

    def describe(self) -> dict[str, Any]:
        """State name, consecutive failures, cooldown and, when not
        closed, how long the peer has been cooling."""
        with self._lock:
            out: dict[str, Any] = {
                "state": _STATE_NAMES.get(self._state, str(self._state)),
                "failures": self._failures,
                "threshold": self.threshold,
                "cooldown_sec": self.cooldown,
            }
            if self._state != STATE_CLOSED:
                out["open_age_sec"] = round(
                    max(0.0, self._clock() - self._opened_at), 3)
                out["probe_in_flight"] = self._probing
            return out

    def _set_state(self, state: int) -> None:
        # caller holds self._lock
        self._state = state
        metrics.HUB.set_gauge(
            metrics.labeled("peer_breaker_state", peer=self.peer),
            float(state))


class PeerHealth:
    """Process-wide breaker registry, shared by every peer caller so one
    component's failures protect every other component's critical path."""

    _shared: ClassVar["PeerHealth | None"] = None
    _shared_lock: ClassVar[threading.Lock] = threading.Lock()

    def __init__(self, threshold: int | None = None,
                 cooldown: float | None = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.threshold = (threshold if threshold is not None
                          else default_breaker_threshold())
        self.cooldown = (cooldown if cooldown is not None
                         else default_breaker_cooldown())
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    @classmethod
    def shared(cls) -> "PeerHealth":
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls()
            return cls._shared

    @classmethod
    def reset_shared(cls) -> None:
        """Drop the process-wide registry (tests)."""
        with cls._shared_lock:
            cls._shared = None

    def breaker(self, peer: str) -> CircuitBreaker:
        peer = peer.rstrip("/")
        with self._lock:
            b = self._breakers.get(peer)
            if b is None:
                b = self._breakers[peer] = CircuitBreaker(
                    peer, self.threshold, self.cooldown, self._clock)
            return b

    def allow(self, peer: str) -> bool:
        """Claiming check — call right before dialing ``peer``."""
        return self.breaker(peer).allow()

    def admissible(self, peer: str) -> bool:
        """Read-only check — for filters that may never dial ``peer``."""
        return self.breaker(peer).admissible()

    def record_success(self, peer: str) -> None:
        self.breaker(peer).record_success()

    def record_failure(self, peer: str) -> None:
        self.breaker(peer).record_failure()

    def describe(self) -> dict[str, dict[str, Any]]:
        """``peer → breaker snapshot`` for every peer this process has
        talked to; creates no breaker and claims no probe."""
        with self._lock:
            breakers = dict(self._breakers)
        return {peer: b.describe() for peer, b in sorted(breakers.items())}

    def healthy(self, peers: list[str]) -> list[str]:
        """``peers`` the breakers admit, order kept, read-only; the full
        list when every breaker refuses (a rotation with no source would
        turn a brown-out into an outage)."""
        alive = [p for p in peers if self.admissible(p)]
        return alive if alive else list(peers)


def request_with_retry(client: HTTPClient, method: str, url: str, *,
                       policy: RetryPolicy | None = None,
                       health: PeerHealth | None = None,
                       peer: str | None = None,
                       ok_statuses: tuple[int, ...] = (),
                       check_status: bool = True, what: str = "",
                       **kw: Any) -> Response:
    """One HTTP request under ``policy``. ``ok_statuses`` pass through;
    other non-2xx raise :class:`HTTPError` (retried for 408/429/5xx
    only); ``check_status=False`` returns whatever arrived. With
    ``health`` and ``peer``, every outcome feeds that peer's breaker
    (admission is the caller's: ``health.admissible`` before dialing)."""
    pol = policy if policy is not None else RetryPolicy()

    def one_attempt() -> Response:
        r = client.request(method, url, **kw)
        if check_status and r.status_code not in ok_statuses:
            r.raise_for_status()
        return r

    return pol.call(one_attempt, what=what or f"{method} {url}", peer=peer,
                    health=health)
