"""Dependency-free distributed tracing for the pull, serve and restore
planes: the port of ``demodel_tpu.utils.trace`` (stdlib only, the same
env knobs, record shapes and wire format), which answers "where did the
30 s go": budget wait? breaker cooldown? window retry? peer stream?

- :class:`Span` — monotonic-clock timed, with attributes, timestamped
  events (retry attempts, breaker transitions, failovers) and an error
  status. Spans nest through ``contextvars`` so the ambient parent flows
  through ``await`` points for free; :func:`wrap` captures the ambient
  context for callables handed to thread pools (``contextvars`` does NOT
  cross ``threading`` boundaries on its own).
- :class:`TraceBuffer` — process-wide bounded ring of finished spans
  (``DEMODEL_TRACE_BUFFER``, default 8192); the Chrome exporter and tests
  read it back.
- exporters — ``DEMODEL_TRACE=/path`` appends one JSON object per finished
  span; :func:`dump_chrome` / :func:`chrome_events` emit Chrome
  trace-event JSON that loads in Perfetto / ``chrome://tracing``.
- wire propagation — :func:`traceparent` / :func:`parse_traceparent`
  implement the W3C header; clients inject it on their raw GETs
  (``sink/remote``, ``parallel/peer``), servers extract it and start a
  child span, so a multi-host pull stitches into ONE trace.
- every finished span feeds the metrics exposition:
  ``stage_duration_seconds{span=...}`` (histogram),
  ``trace_spans_total{span=...}`` and ``trace_span_seconds_total{span=...}``
  (the pull tuner reads the budget-wait share of wall time from the
  latter as a rate).

Observability has THREE tiers:

- **export** (``DEMODEL_TRACE=/path`` or :func:`enable`): everything below
  plus the JSONL sink and the export :class:`TraceBuffer`.
- **observe** (the DEFAULT): spans run and feed (a) the per-stage latency
  histograms on the metrics scrape, (b) the always-on **flight recorder**
  — a small bounded ring of recently completed spans, separate from the
  export buffer, dumped to disk on ``SIGUSR2`` and automatically when a
  ROOT span finishes with error status — and (c) the **in-flight
  registry** every live span sits in until it finishes, so
  ``/debug/statusz`` can print what a stuck pull is doing *right now*.
  Nothing is exported.
- **off** (``DEMODEL_OBS=0``): :func:`span` returns a shared no-op
  context manager after one module-global check — no allocation, no
  clock read.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import random
import tempfile
import threading
import time
from collections import deque
from typing import IO, Any, Callable

#: ambient parent span (crosses asyncio awaits for free; for threads use
#: :func:`wrap` at the submit site)
_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "demodel_trace_span", default=None)

_TRACEPARENT_VERSION = "00"
_SAMPLED = "01"


def _hex(nbytes: int) -> str:
    return "%0*x" % (nbytes * 2, random.getrandbits(nbytes * 8))


# ------------------------------------------------------------------ state


def _env_off(name: str) -> bool:
    """True when ``name`` is explicitly disabled (``0/false/off/no``)."""
    return os.environ.get(name, "").strip().lower() in (
        "0", "false", "off", "no")


class _State:
    """Resolved-from-env exporter state. Rebuilt by :func:`reset`."""

    def __init__(self) -> None:
        path = os.environ.get("DEMODEL_TRACE", "").strip()
        self.enabled = bool(path) or _FORCED
        #: observe tier: spans run (recorder + histograms + in-flight
        #: registry) even with no exporter configured. DEMODEL_OBS=0 is
        #: the full kill switch — span() then returns the shared no-op.
        self.observing = not _env_off("DEMODEL_OBS")
        self.jsonl_path = path or None
        self.sample = _sample_rate()
        self.buffer = TraceBuffer(_buffer_cap())
        #: the flight recorder: always-on bounded ring of recently
        #: COMPLETED spans, separate from the export buffer — the
        #: post-mortem a fault leaves behind without pre-enabled tracing
        self.recorder = TraceBuffer(_recorder_cap())
        self.recorder_dir = os.environ.get(
            "DEMODEL_RECORDER_DIR", "").strip() or tempfile.gettempdir()
        self.autodump = not _env_off("DEMODEL_RECORDER_AUTODUMP")
        self.autodump_min_s = _autodump_min_s()
        self.last_dump: str | None = None
        self._dump_lock = threading.Lock()
        self._dump_seq = 0
        self._last_autodump = 0.0
        self._sink_lock = threading.Lock()
        self._sink: IO[str] | None = None  # lazily opened JSONL file

    def export(self, rec: dict[str, Any]) -> None:
        self.buffer.add(rec)
        if self.jsonl_path is None:
            return
        line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        try:
            with self._sink_lock:
                if self._sink is None:
                    # demodel: allow(no-blocking-io-under-lock) —
                    # single-flight by design: this lock exists ONLY to
                    # serialize appends to the one trace sink (interleaved
                    # JSONL lines would corrupt the file); nothing else
                    # ever waits on it
                    self._sink = open(  # noqa: SIM115 — process lifetime
                        self.jsonl_path, "a", encoding="utf-8")
                self._sink.write(line)
                self._sink.flush()
        except OSError as e:
            # tracing must never take the plane down: disable the sink,
            # keep the in-memory buffer
            self.jsonl_path = None
            _log().warning("trace sink unusable (%s); JSONL export off", e)


def _buffer_cap() -> int:
    from demodel_tpu_torch.utils.env import env_int

    return env_int("DEMODEL_TRACE_BUFFER", 8192, minimum=16)


def _recorder_cap() -> int:
    from demodel_tpu_torch.utils.env import env_int

    return env_int("DEMODEL_RECORDER_CAP", 512, minimum=16)


def _autodump_min_s() -> float:
    """Rate limit between automatic error-root dumps (seconds; 0 = every
    error root dumps — tests). A fault storm must leave ONE post-mortem
    per window, not grind the disk with one file per failed window."""
    raw = os.environ.get("DEMODEL_RECORDER_MIN_S", "").strip()
    if not raw:
        return 60.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 60.0


def _sample_rate() -> float:
    """``DEMODEL_TRACE_SAMPLE`` ∈ [0, 1]: head-sampling probability for new
    ROOT spans (default 1.0 — record everything). Multi-user serve traffic
    sets e.g. ``0.01`` so tracing overhead/volume scales with the sample,
    not the load. EXPORT-only: a sampled-out trace skips the JSONL sink and
    export buffer, but its spans still run — the flight recorder, statusz
    in-flight view and latency histograms are always-on by contract and
    must not go dark because an export knob was tuned. Malformed values
    degrade to 1.0, same policy as env_int."""
    raw = os.environ.get("DEMODEL_TRACE_SAMPLE", "").strip()
    if not raw:
        return 1.0
    try:
        rate = float(raw)
    except ValueError:
        _log().warning("DEMODEL_TRACE_SAMPLE=%r is not a float; sampling "
                       "everything", raw)
        return 1.0
    return min(1.0, max(0.0, rate))


def _log() -> logging.Logger:
    from demodel_tpu_torch.utils.logging import get_logger

    return get_logger("trace")


_FORCED = False           # enable() without an env var (tests/CLI)
_state: _State | None = None
_state_lock = threading.Lock()


def _get_state() -> _State:
    global _state
    st = _state
    if st is None:
        with _state_lock:
            st = _state
            if st is None:
                st = _state = _State()
        _install_recorder_signal()
    return st


def enabled() -> bool:
    """Full EXPORT tracing on (JSONL sink / export buffer)."""
    st = _state
    return st.enabled if st is not None else _get_state().enabled


def active() -> bool:
    """Spans run at all (export OR the default observe tier). The guard
    for call sites that pay real work building span attributes."""
    st = _state
    if st is None:
        st = _get_state()
    return st.enabled or st.observing


def mode() -> str:
    """``"export"`` / ``"observe"`` / ``"off"`` — for /debug/statusz."""
    st = _get_state()
    if st.enabled:
        return "export"
    return "observe" if st.observing else "off"


def enable(jsonl_path: str | None = None) -> None:
    """Force tracing on (tests / CLI), optionally with a JSONL sink."""
    global _FORCED, _state
    with _state_lock:
        _FORCED = True
        if jsonl_path is not None:
            os.environ["DEMODEL_TRACE"] = jsonl_path
        _state = None
    _get_state()


def reset() -> None:
    """Drop exporter state and re-read the env (tests; cheap). Clears the
    in-flight registry too — spans left open by a failed test must not
    haunt the next test's statusz snapshot."""
    global _FORCED, _state
    with _state_lock:
        _FORCED = False
        _state = None
    with _inflight_lock:
        _inflight.clear()


# ----------------------------------------------------------------- buffer


class TraceBuffer:
    """Bounded ring of finished-span records (dicts, newest last)."""

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self._lock = threading.Lock()
        self._spans: deque[dict[str, Any]] = deque(maxlen=cap)
        self.dropped = 0

    def add(self, rec: dict[str, Any]) -> None:
        with self._lock:
            if len(self._spans) == self.cap:
                self.dropped += 1
            self._spans.append(rec)

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def buffer() -> TraceBuffer:
    return _get_state().buffer


def recorder() -> TraceBuffer:
    """The flight-recorder ring (completed spans, always on under the
    observe tier)."""
    return _get_state().recorder


# -------------------------------------------------- in-flight span registry

#: every live (entered-but-unfinished) Span, keyed by id() — what
#: /debug/statusz prints when you ask a stuck node what it is doing NOW
_inflight_lock = threading.Lock()
_inflight: dict[int, "Span"] = {}


def inflight() -> list[dict[str, Any]]:
    """Flat snapshot of every currently-open span: name, ids, age (secs
    since start), live attrs, thread. Newest-last by age."""
    with _inflight_lock:
        spans = list(_inflight.values())
    now = time.perf_counter()
    out = []
    for s in spans:
        if s.dur is not None:
            continue  # finished between snapshot and render
        out.append({
            "name": s.name,
            "trace": s.trace_id,
            "span": s.span_id,
            "parent": s.parent_id,
            "age_sec": round(max(0.0, now - s._t0), 6),
            "thread": s._thread_name,
            **({"attrs": dict(s.attrs)} if s.attrs else {}),
        })
    out.sort(key=lambda r: -float(r["age_sec"]))
    return out


def nest_spans(flat: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Flat span dicts (``span``/``parent`` keys) → trees: every span
    whose parent is not in the set (remote or already-finished parents
    both root a local tree) becomes a root, descendants nest under
    ``children``. Shared by :func:`inflight_tree` and readers of a
    recorder dump."""
    by_id = {r["span"]: dict(r, children=[]) for r in flat if "span" in r}
    roots: list[dict[str, Any]] = []
    for r in by_id.values():
        parent = r.get("parent")
        if parent is not None and parent in by_id:
            by_id[parent]["children"].append(r)
        else:
            roots.append(r)
    return roots


def inflight_tree() -> list[dict[str, Any]]:
    """The open spans as trees — the statusz "what is this pull doing
    right now" view."""
    return nest_spans(inflight())


# --------------------------------------------------- flight recorder dumps


def dump_recorder(reason: str, path: str | None = None) -> str:
    """Write the flight recorder (completed-span ring + the in-flight
    span snapshot) as one JSON file; returns the path written. The
    post-mortem artifact: SIGUSR2 and error-status roots both land here."""
    st = _get_state()
    with st._dump_lock:
        st._dump_seq += 1
        seq = st._dump_seq
    if path is None:
        path = os.path.join(
            st.recorder_dir, f"demodel-flightrec-{os.getpid()}-{seq}.json")
    doc = {
        "kind": "demodel-flight-recorder",
        "reason": reason,
        "ts": time.time(),
        "pid": os.getpid(),
        "dropped": st.recorder.dropped,
        "spans": st.recorder.snapshot(),
        "inflight": inflight(),
    }
    # one signal, spans AND frames: embed the profiler's last rolled
    # window (or its live aggregate) when the profiler plane is loaded.
    # sys.modules peek, same dep-light stance as the statusz sections —
    # a recorder dump must never be the thing that imports the profiler.
    import sys as _sys

    prof = _sys.modules.get("demodel_tpu_torch.utils.profiler")
    if prof is not None:
        try:
            window = prof.recorder_window()
            if window is not None:
                doc["profile"] = window
        except Exception as e:  # noqa: BLE001 — post-mortem must still
            # land even if the profiler misbehaves; record why it is bare
            doc["profile_error"] = str(e)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"), default=str)
    st.last_dump = path
    _log().warning("flight recorder dumped (%s): %s", reason, path)
    return path


def _maybe_autodump(rec: dict[str, Any]) -> None:
    """Error-status ROOT span finished: leave a post-mortem on disk
    (rate-limited) — the first fault in prod must not require a restart
    with tracing pre-enabled to be diagnosable."""
    st = _get_state()
    if not st.autodump:
        return
    now = time.monotonic()
    with st._dump_lock:
        if st._last_autodump and now - st._last_autodump < st.autodump_min_s:
            return
        st._last_autodump = now
    try:
        dump_recorder(f"error-root:{rec['name']}")
    except OSError as e:
        _log().warning("flight-recorder dump failed: %s", e)


_signal_installed = False


def _install_recorder_signal() -> None:
    """SIGUSR2 → flight-recorder dump. Installed once per process, from
    the main thread only, and never over a user-set handler (only the
    default disposition — which would kill the process — is replaced).
    Called at module import (normally the main thread) AND on every state
    (re)build, so a process whose first span ran on a worker thread still
    gets the handler from any later main-thread state rebuild."""
    global _signal_installed
    if _signal_installed or _env_off("DEMODEL_RECORDER_SIGNAL"):
        return
    try:
        import signal

        if threading.current_thread() is not threading.main_thread():
            return  # not installable from here; later main-thread calls try
        if signal.getsignal(signal.SIGUSR2) is not signal.SIG_DFL:
            _signal_installed = True  # someone owns it; never contend
            return

        def _dump_thread() -> None:
            try:
                dump_recorder("sigusr2")
            except OSError as e:
                _log().warning("SIGUSR2 dump failed: %s", e)

        def _on_sigusr2(_signum: int, _frame: Any) -> None:
            # NEVER dump from the handler itself: it runs on the main
            # thread on top of whatever frame the signal preempted — if
            # that frame holds the recorder/inflight/dump lock (any span
            # start/finish does), a direct dump self-deadlocks the node
            # the dump exists to diagnose. A thread just waits its turn.
            threading.Thread(target=_dump_thread, daemon=True,
                             name="demodel-sigusr2-dump").start()

        signal.signal(signal.SIGUSR2, _on_sigusr2)
        _signal_installed = True
    except (ValueError, OSError, AttributeError):  # non-main thread race /
        return  # platforms without SIGUSR2 — the recorder still works


# ------------------------------------------------------------------- Span


class Span:
    """One timed operation. Use via ``with trace.span("window-read", ...):``
    — entering makes it the ambient parent, exiting finishes + exports it.
    An exception propagating through marks ``status=error`` (and records
    the exception type/message) before re-raising."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "events", "status", "error", "_t0", "_wall0", "dur",
                 "_token", "_thread_name", "_thread_ident",
                 "_suppress_export", "_unsampled_token")

    def __init__(self, name: str, trace_id: str, parent_id: str | None,
                 attrs: dict[str, Any] | None,
                 suppress_export: bool = False) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = _hex(8)
        self.parent_id = parent_id
        self.attrs: dict[str, Any] = attrs or {}
        self.events: list[tuple[float, str, dict[str, Any]]] = []
        self.status = "ok"
        self.error: str | None = None
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self.dur: float | None = None
        self._token: contextvars.Token["Span | None"] | None = None
        th = threading.current_thread()
        self._thread_name = th.name
        # starting-thread ident, recorded NOW: the profiler joins samples
        # to the innermost live span per thread, and must not wait for
        # finish() to learn which thread a span runs on
        self._thread_ident = th.ident
        #: head-sampled OUT (export tier only): the span still runs —
        #: recorder/statusz/histograms stay whole — but never exports
        self._suppress_export = suppress_export
        self._unsampled_token: contextvars.Token[bool] | None = None
        # live until finish(): the /debug/statusz in-flight view
        with _inflight_lock:
            _inflight[id(self)] = self

    # -- enrichment ----------------------------------------------------
    def set_attr(self, key: str, value: Any) -> None:
        # copy-on-write: statusz's inflight() snapshots attrs from another
        # thread with no lock — rebinding a fresh dict is atomic, mutating
        # in place would let dict(attrs) race a concurrent insert
        self.attrs = {**self.attrs, key: value}

    def event(self, name: str, **attrs: Any) -> None:
        """Timestamped point event on this span (retry attempt, breaker
        transition, failover) — offset seconds from span start."""
        self.events.append(
            (round(time.perf_counter() - self._t0, 6), name, attrs))

    # -- lifecycle -----------------------------------------------------
    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        if self._suppress_export and not _unsampled.get():
            # mark the context so descendants (and wrap()-crossed thread
            # tasks) inherit the export-drop with this root — whole
            # traces drop from the export, never mid-trace fragments
            self._unsampled_token = _unsampled.set(True)
        return self

    def __exit__(self, exc_type: type[BaseException] | None,
                 exc: BaseException | None, tb: object) -> None:
        if self._unsampled_token is not None:
            _unsampled.reset(self._unsampled_token)
            self._unsampled_token = None
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc is not None:
            self.status = "error"
            self.error = f"{type(exc).__name__}: {exc}"
        self.finish()

    def finish(self) -> None:
        if self.dur is not None:
            return  # idempotent: __exit__ after an explicit finish()
        self.dur = time.perf_counter() - self._t0
        with _inflight_lock:
            _inflight.pop(id(self), None)
        th = threading.current_thread()
        rec: dict[str, Any] = {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "ts": self._wall0,
            "dur": round(self.dur, 6),
            "pid": os.getpid(),
            "tid": th.ident,
            "thread": th.name,
            "status": self.status,
        }
        if self.error is not None:
            rec["error"] = self.error
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.events:
            rec["events"] = [
                {"t": t, "name": n, **({"attrs": a} if a else {})}
                for t, n, a in self.events]
        st = _get_state()
        # the flight recorder sees every finished span (observe tier);
        # the export buffer/JSONL only when full tracing is on AND the
        # root survived head-sampling — sampling is an export-volume
        # knob, never a hole in the always-on surfaces
        st.recorder.add(rec)
        if st.enabled and not self._suppress_export:
            st.export(rec)
        # the tracing→metrics bridge: every named span feeds the per-stage
        # latency histogram + the span summaries on finish, so the scrape
        # shows where pull/serve/restore time goes even with no sink set
        from demodel_tpu_torch.utils import metrics

        metrics.HUB.observe(
            metrics.labeled("stage_duration_seconds", span=self.name),
            self.dur)
        label = metrics.labeled("trace_spans_total", span=self.name)
        metrics.HUB.inc(label)
        metrics.HUB.inc(
            metrics.labeled("trace_span_seconds_total", span=self.name),
            self.dur)
        if self.status == "error" and self.parent_id is None:
            _maybe_autodump(rec)


class _NoopSpan:
    """The disabled-tracing fast path: one shared instance, every method a
    constant-time no-op. ``span()`` returns it after a single module-global
    check — the hot path allocates nothing and never reads a clock."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set_attr(self, key: str, value: Any) -> None:
        return None

    def event(self, name: str, **attrs: Any) -> None:
        return None

    def finish(self) -> None:
        return None


NOOP = _NoopSpan()

#: set while inside a head-UNSAMPLED root: descendants (including across
#: :func:`wrap`-captured thread hops) drop from the EXPORT with it, so a
#: sampling decision drops or keeps whole traces, never mid-trace
#: fragments — the observe-tier surfaces (recorder/statusz/histograms)
#: stay whole regardless
_unsampled: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "demodel_trace_unsampled", default=False)


def span(name: str, remote_parent: str | None = None,
         **attrs: Any) -> "Span | _NoopSpan":
    """Start a span under the ambient parent (or a remote ``traceparent``
    header value). Returns :data:`NOOP` when observability is fully off
    (``DEMODEL_OBS=0``); under the default observe tier the span runs but
    only feeds the flight recorder + histograms + in-flight registry.
    With export tracing on, new ROOT spans are head-sampled per
    ``DEMODEL_TRACE_SAMPLE``: a sampled-out root still RUNS (the
    always-on surfaces must not go dark behind an export knob) but its
    whole subtree skips the export buffer/JSONL; spans with a remote
    parent are always exported (the upstream host already decided)."""
    st = _state
    if st is None:
        st = _get_state()
    if not (st.enabled or st.observing):
        return NOOP
    parent_trace: str | None = None
    parent_id: str | None = None
    from_remote = False
    if remote_parent is not None:
        parsed = parse_traceparent(remote_parent)
        if parsed is not None:
            parent_trace, parent_id = parsed
            from_remote = True
    if parent_trace is None:
        cur = _current.get()
        if cur is not None:
            parent_trace, parent_id = cur.trace_id, cur.span_id
    if parent_trace is None:
        # new root: the one head-sampling decision for the whole trace —
        # export-only, and only worth rolling when export is actually on
        suppress = _unsampled.get() or (
            st.enabled and st.sample < 1.0 and random.random() >= st.sample)
    else:
        suppress = not from_remote and _unsampled.get()
    return Span(name, parent_trace or _hex(16), parent_id, attrs or None,
                suppress_export=suppress)


def current() -> Span | None:
    """The ambient span, or None (disabled or outside any span)."""
    return _current.get()


def event(name: str, **attrs: Any) -> None:
    """Attach a point event to the ambient span (no-op without one) —
    how RetryPolicy attempts and breaker transitions land on whichever
    operation triggered them."""
    cur = _current.get()
    if cur is not None:
        cur.event(name, **attrs)


# ------------------------------------------------------------ propagation


def traceparent() -> str | None:
    """W3C ``traceparent`` value for the ambient span, or None."""
    cur = _current.get()
    if cur is None:
        return None
    return (f"{_TRACEPARENT_VERSION}-{cur.trace_id}-{cur.span_id}-"
            f"{_SAMPLED}")


def subtree_suppressed() -> bool:
    """True inside a head-UNSAMPLED (export-dropped) root. Work fanned
    out from here over channels contextvars cannot cross (queues,
    executors without :func:`wrap`) must carry this flag and skip its
    spans, or an export-dropped trace leaks orphan fragments from the
    far side of the channel (remote-parented spans always export)."""
    return _unsampled.get()


def parse_traceparent(value: str) -> tuple[str, str] | None:
    """``(trace_id, parent_span_id)`` from a traceparent header, or None
    for anything malformed (never raises: header input is peer input)."""
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    _ver, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return trace_id, span_id


def inject_headers(headers: dict[str, str] | None) -> dict[str, str] | None:
    """Return ``headers`` with ``traceparent`` added when a span is
    ambient (copies before mutating; None stays None when no span)."""
    tp = traceparent()
    if tp is None:
        return headers
    out = dict(headers or {})
    out.setdefault("traceparent", tp)
    return out


def wrap(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Capture the ambient trace context NOW for a callable that will run
    on another thread (``contextvars`` does not cross ``threading``).
    Identity when tracing is disabled — executor hot paths pay nothing.
    An unsampled-root context is captured too, so a dropped trace's thread
    fan-out doesn't re-roll the sampling dice per task."""
    if not active() or (_current.get() is None and not _unsampled.get()):
        return fn
    ctx = contextvars.copy_context()

    def run(*a: Any, **kw: Any) -> Any:
        return ctx.run(fn, *a, **kw)

    return run


# -------------------------------------------------------- chrome exporter


def chrome_events(records: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Chrome trace-event objects (Perfetto/chrome://tracing) for finished
    span records: one complete ("X") event per span, one instant ("i")
    event per span event. Spans from different hosts of one pull carry
    different pids, so a stitched multi-host trace lays out per-process."""
    out: list[dict[str, Any]] = []
    for r in records:
        ts_us = r["ts"] * 1e6
        args = dict(r.get("attrs") or {})
        args["trace"] = r["trace"]
        args["span"] = r["span"]
        if r.get("parent"):
            args["parent"] = r["parent"]
        if r.get("error"):
            args["error"] = r["error"]
        out.append({
            "name": r["name"],
            "cat": "demodel",
            "ph": "X",
            "ts": ts_us,
            "dur": max(r.get("dur", 0.0), 0.0) * 1e6,
            "pid": r.get("pid", 0),
            "tid": r.get("tid", 0) or 0,
            "args": args,
        })
        for ev in r.get("events", ()):
            out.append({
                "name": f"{r['name']}:{ev['name']}",
                "cat": "demodel",
                "ph": "i",
                "s": "t",
                "ts": ts_us + ev.get("t", 0.0) * 1e6,
                "pid": r.get("pid", 0),
                "tid": r.get("tid", 0) or 0,
                "args": dict(ev.get("attrs") or {}),
            })
    return out


def dump_chrome(path: str,
                records: list[dict[str, Any]] | None = None) -> int:
    """Write a Chrome trace-event JSON file (records default to the
    process buffer). Returns the event count."""
    recs = records if records is not None else buffer().snapshot()
    events = chrome_events(recs)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


# import usually happens on the main thread — grab the SIGUSR2 slot now,
# before any worker thread can be the one to build the first _State
_install_recorder_signal()
