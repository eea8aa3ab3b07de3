"""Closed-loop adaptive pull tuning fed by live telemetry quantiles (the
port of ``demodel_tpu/sink/tuner.py``, the same decisions on the same
signals).

The pull plane's knobs — per-peer stream concurrency, fetch window size,
prefetch depth — ship as fixed env defaults, and ROADMAP's adaptive-tuning
item asks for them to move with OBSERVED stage times instead. This module
is the first consumer of the telemetry time-series plane
(:mod:`demodel_tpu_torch.utils.metrics`): an AIMD-style controller thread that,
while a pull runs, reads the sliding-window signals the plane already
serves —

- ``stage_duration_seconds{span="window-read"}`` windowed p99 (is the
  wire leg degrading?),
- ``peer_retries_total`` family rate + open circuit breakers (is the
  link faulting?),
- the ``budget-wait`` share of wall time (is admission, i.e. host RAM,
  the bottleneck?),
- ``pull_bytes_total`` rate (the delivery rate the whole loop optimizes)

— and adjusts the knobs between windows, congestion-control style
(BBR-ish probing: raise one knob, keep the raise only if the delivery
rate held; multiplicative back-off on wire faults). Every decision lands
as an event on the tuner's own root span AND as ``tuner_*`` gauges +
``tuner_decisions_total`` on the scrape, so the tuner is itself fully
observable; :func:`current` names the live tuner.

``DEMODEL_TUNER=0`` disables the controller entirely — every knob then
keeps its fixed env/default resolution, byte-for-byte the pre-tuner
behavior. Increases are bounded by the same :class:`~demodel_tpu_torch.sink
.streaming.ByteBudget` charging discipline the pipelined fetch already
enforces: a prefetch raise is only attempted when the budget has
headroom, and even a wrong raise just blocks in ``acquire`` instead of
over-committing host RAM.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from demodel_tpu_torch.utils import metrics, trace
from demodel_tpu_torch.utils.env import (default_peer_streams,
                                         default_pull_window_mb, env_float,
                                         env_int)
from demodel_tpu_torch.utils.env import tuner_enabled as _tuner_enabled
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("sink.tuner")

#: the telemetry families the controller reads (a typo here silently
#: reads an empty window)
_WINDOW_READ = metrics.labeled("stage_duration_seconds", span="window-read")
_BUDGET_WAIT = metrics.labeled("trace_span_seconds_total",
                               span="budget-wait")
#: the device-plane signals (ROADMAP: "read device-side place/stage
#: histograms"): how long placing a landed buffer onto the accelerator
#: takes, end-to-end per sink delivery
_PLACE = metrics.labeled("stage_duration_seconds", span="place")
_SINK_DELIVER = metrics.labeled("stage_duration_seconds",
                                span="sink-deliver")


def tuner_enabled() -> bool:
    """The ``DEMODEL_TUNER`` switch: on unless explicitly disabled —
    ``=0`` restores the fixed env defaults everywhere."""
    return _tuner_enabled()


def _default_window_bytes() -> int:
    """Initial (and untuned-path) fetch window."""
    return default_pull_window_mb() << 20


def fetch_windows(reader: Any, key: str, buf: Any, offset: int,
                  tuner: "PullTuner | None") -> int:
    """Fill ``buf`` from ``reader`` starting at ``offset``, split into
    tuner-sized sub-windows when a tuner is live (each sub-window is one
    ``window-read`` span — the unit the p99 signal and the retry cost
    are both functions of). Without a tuner this is exactly one
    ``pread_into`` — the untuned path stays byte-identical to before."""
    view = memoryview(buf).cast("B")
    nbytes = view.nbytes
    if tuner is None:
        return reader.pread_into(key, view, offset)
    pos = 0
    while pos < nbytes:
        # re-read the live knobs per window: the controller adjusts them
        # BETWEEN windows, never mid-transfer
        if hasattr(reader, "streams"):
            reader.streams = tuner.streams
        step = min(nbytes - pos, max(1, tuner.window_bytes))
        reader.pread_into(key, view[pos:pos + step], offset + pos)
        pos += step
    return nbytes


# ------------------------------------------------------------ controller


class PullTuner:
    """One pull's adaptive controller. Start with :meth:`start`, stop in
    a ``finally`` — the thread is short-lived (the pull's duration) and
    joined on stop. All knob reads are plain attribute loads (ints are
    GIL-atomic), so the fetch hot path pays nothing for adaptivity.

    Test seams: ``telemetry``/``health``/``clock``/``sleep`` injectable;
    :meth:`tick` is callable directly (no thread) with forced signals.
    """

    def __init__(self, budget: Any = None, prefetch_depth: int | None = None,
                 telemetry: "metrics.Telemetry | None" = None,
                 health: Any = None,
                 tick_s: float | None = None,
                 window_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] | None = None):
        self._budget = budget
        self._telemetry = telemetry
        self._health = health
        self.tick_s = tick_s if tick_s is not None else env_int(
            "DEMODEL_TUNER_TICK_MS", 500, minimum=50) / 1000.0
        self.window_s = window_s if window_s is not None else float(env_int(
            "DEMODEL_TUNER_WINDOW_S", 30, minimum=1))
        self._clock = clock
        self._stop = threading.Event()
        self._sleep = sleep if sleep is not None else self._stop.wait

        # knobs start at the exact fixed defaults the untuned path uses
        self.streams = default_peer_streams()
        self.window_bytes = _default_window_bytes()
        init_pref = 0 if prefetch_depth is None else int(prefetch_depth)
        self.prefetch_depth = init_pref

        # bounds: never below the floor a working pull needs, never past
        # the point extra concurrency stops paying (per-peer politeness)
        self.min_streams, self.max_streams = 1, max(8, self.streams)
        self.min_window = 2 << 20
        self.max_window = max(self.window_bytes, 256 << 20)
        # a pull resolved to prefetch 0 (single-core, CPU backend) keeps
        # it: the measured regression there is contention, not tuning
        self.min_prefetch = 0 if init_pref == 0 else 1
        self.max_prefetch = 0 if init_pref == 0 else max(4, init_pref)

        # AIMD state
        self.retry_hi = env_float("DEMODEL_TUNER_RETRY_HI", 0.25)  # /s
        #: device-plane pressure thresholds: a windowed place/sink-deliver
        #: p99 above place_hi seconds, or the ByteBudget charged past
        #: hbm_hi of its cap, sheds prefetch — depth is the knob that
        #: converts device-side latency/HBM pressure into admission relief
        self.place_hi = env_float("DEMODEL_TUNER_PLACE_HI", 1.0)  # seconds
        self.hbm_hi = env_float("DEMODEL_TUNER_HBM_HI", 0.85)  # share
        #: how long a live probe settles before being judged: the
        #: keep/revert test must read a window that POST-DATES the raise
        #: — judged one tick later against the window_s moving average,
        #: a 0.5 s tick can move a 30 s average by at most ~1.7%, so the
        #: revert branch would be arithmetically dead and every probe
        #: would be kept even when the raise hurt
        self.judge_s = max(4 * self.tick_s, 2.0)
        self.decisions = 0
        self._best_thr = 0.0
        self._probe: tuple[str, int] | None = None  # (knob, previous value)
        self._probe_base = 0.0
        self._probe_t = 0.0
        self._hold_until = 0.0
        self._round_robin = 0
        self._thread: threading.Thread | None = None
        self._span: Any = trace.NOOP
        #: serializes the tick thread's knob/bookkeeping WRITES against
        #: snapshot(): without it a reader could see decision N's count
        #: with decision N-1's knob values. The fetch hot path (fetch_windows) deliberately stays lock-free:
        #: its per-window int loads are GIL-atomic and individually
        #: consistent, which is all a window split needs.
        self._knob_lock = threading.Lock()

    # -- wiring ---------------------------------------------------------
    def _tel(self) -> "metrics.Telemetry":
        return self._telemetry if self._telemetry is not None \
            else metrics.HUB.telemetry()

    def _breaker_open(self) -> bool:
        health = self._health
        if health is None:
            from demodel_tpu_torch.utils.faults import PeerHealth

            health = PeerHealth._shared  # noqa: SLF001 — observe, never
            # allocate: a pull that made no wire call has no breakers
            if health is None:
                return False
        return any(b.get("state") != "closed"
                   for b in health.describe().values())

    def snapshot(self) -> dict[str, Any]:
        """Live knob values + controller state — one
        CONSISTENT document: taken under the same lock the tick thread
        writes under, so the decision count always matches the knob
        values it produced."""
        with self._knob_lock:
            return {
                "streams": self.streams,
                "window_bytes": self.window_bytes,
                "window_mb": self.window_bytes >> 20,
                "prefetch_depth": self.prefetch_depth,
                "decisions": self.decisions,
                "best_throughput_bps": round(self._best_thr, 1),
            }

    @property
    def window_mb(self) -> int:
        with self._knob_lock:
            return self.window_bytes >> 20

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "PullTuner":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run,
                                        name="pull-tuner", daemon=True)
        _register(self)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None
        _unregister(self)

    def _run(self) -> None:
        # the tuner's own root span: open for the pull's duration (so a
        # stuck pull shows the controller and its live knobs),
        # every decision an event on it
        with trace.span("tuner", streams=self.streams,
                        window_mb=self.window_mb,
                        prefetch=self.prefetch_depth) as sp:
            self._span = sp
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — the tuner must
                    # never take the pull down; knobs just stop moving
                    log.warning("tuner tick failed: %s", e)
                self._sleep(self.tick_s)
            sp.set_attr("decisions", self.decisions)
            self._span = trace.NOOP

    # -- the control loop ----------------------------------------------
    def _gauges(self, thr: float) -> None:
        metrics.HUB.set_gauge("tuner_streams", self.streams)
        metrics.HUB.set_gauge("tuner_window_bytes", self.window_bytes)
        metrics.HUB.set_gauge("tuner_prefetch_depth", self.prefetch_depth)
        metrics.HUB.set_gauge("tuner_throughput_bps", round(thr, 1))

    def _decide(self, action: str, knob: str, frm: Any, to: Any,
                reason: str) -> None:
        self.decisions += 1
        self._span.event("tune", action=action, knob=knob, frm=frm, to=to,
                         reason=reason)
        metrics.HUB.inc(metrics.labeled("tuner_decisions_total",
                                        action=action))
        log.info("tuner %s %s: %s -> %s (%s)", action, knob, frm, to,
                 reason)

    def _backoff(self, reason: str) -> None:
        """Multiplicative decrease on a wire-fault signal: the link is
        telling us we are over-driving it."""
        if self.streams > self.min_streams:
            new = max(self.min_streams, self.streams // 2)
            self._decide("decrease", "streams", self.streams, new, reason)
            self.streams = new
        if self.window_bytes > self.min_window:
            new = max(self.min_window, self.window_bytes // 2)
            self._decide("decrease", "window_bytes", self.window_bytes,
                         new, reason)
            self.window_bytes = new
        if self.prefetch_depth > max(1, self.min_prefetch):
            new = self.prefetch_depth - 1
            self._decide("decrease", "prefetch_depth",
                         self.prefetch_depth, new, reason)
            self.prefetch_depth = new
        self._probe = None
        self._best_thr *= 0.5  # the old best is stale on a faulting link
        self._hold_until = self._clock() + 4 * self.tick_s

    def _budget_pressure(self) -> float:
        """The live HBM/host-RAM admission pressure: the ByteBudget's
        in-use share of its cap (0.0 without a budget — an unthrottled
        pull has no device-side admission signal to read)."""
        budget = self._budget
        if budget is None:
            return 0.0
        try:
            cap = float(budget.max_bytes)
            if cap <= 0:
                return 0.0
            return float(budget.in_use) / cap
        except Exception:  # noqa: BLE001 — a foreign budget shape
            return 0.0

    def _raise_one(self, thr: float, device_pressure: bool = False) -> None:
        """Additive increase: probe ONE knob upward, remember the
        pre-probe rate — the next tick keeps or reverts the raise."""
        candidates: list[tuple[str, int]] = []
        if self.streams < self.max_streams:
            candidates.append(("streams", self.streams + 1))
        if self.window_bytes < self.max_window:
            candidates.append(("window_bytes",
                               min(self.window_bytes * 2, self.max_window)))
        budget = self._budget
        headroom = True
        if budget is not None:
            try:
                headroom = (budget.max_bytes - budget.in_use
                            > self.window_bytes)
            except Exception:  # noqa: BLE001 — a foreign budget shape
                headroom = True
        # never probe prefetch upward while the device plane is the
        # bottleneck — a deeper queue just converts place latency into
        # pinned host RAM
        if self.prefetch_depth < self.max_prefetch and headroom \
                and not device_pressure:
            candidates.append(("prefetch_depth", self.prefetch_depth + 1))
        if not candidates:
            return
        knob, new = candidates[self._round_robin % len(candidates)]
        self._round_robin += 1
        old = getattr(self, knob)
        self._probe = (knob, old)
        self._probe_base = thr
        self._probe_t = self._clock()
        self._decide("increase", knob, old, new, "probe")
        setattr(self, knob, new)

    def tick(self, *, thr: float | None = None,
             retry_rate: float | None = None,
             breaker_open: bool | None = None,
             budget_wait_share: float | None = None,
             place_p99: float | None = None,
             hbm_pressure: float | None = None) -> None:
        """One control decision. Signals default to the live telemetry
        plane; tests force them via keywords."""
        tel = self._tel()
        forced = thr is not None
        if thr is None:
            thr = tel.rate("pull_bytes_total", self.window_s)
        if retry_rate is None:
            # the fault signal reads a SHORT window (judge_s, ~2 s), not
            # window_s: over a 30 s window one transient burst stays
            # above retry_hi for 30 s while the post-backoff hold is
            # only 4 ticks — the controller would re-trigger
            # multiplicative decrease ~15× off one spike and collapse
            # every knob to its floor. Current faulting, not history.
            retry_rate = tel.family_rate("peer_retries_total",
                                         self.judge_s)
        if breaker_open is None:
            breaker_open = self._breaker_open()
        if budget_wait_share is None:
            budget_wait_share = tel.rate(_BUDGET_WAIT, self.window_s)
        if place_p99 is None:
            # device-side latency: whichever of the two device-plane
            # stages is slower over the window is the pressure signal
            place_p99 = max(
                tel.window_quantile(_PLACE, 0.99, self.window_s),
                tel.window_quantile(_SINK_DELIVER, 0.99, self.window_s))
        if hbm_pressure is None:
            hbm_pressure = self._budget_pressure()
        # the p99 the ROADMAP item names: read every tick so the signal
        # is on the tuner's span when a decision fires
        p99 = tel.window_quantile(_WINDOW_READ, 0.99, self.window_s)
        metrics.HUB.set_gauge("tuner_window_read_p99", p99)
        metrics.HUB.set_gauge("tuner_place_p99", round(place_p99, 6))
        metrics.HUB.set_gauge("tuner_hbm_pressure", round(hbm_pressure, 4))
        try:
            now = self._clock()
            # every knob/bookkeeping WRITE below happens under the knob
            # lock so snapshot() reads one consistent decision state
            with self._knob_lock:
                if retry_rate > self.retry_hi or breaker_open:
                    if now >= self._hold_until:
                        self._backoff("breaker-open" if breaker_open
                                      else f"retry-rate {retry_rate:.2f}/s")
                    return
                if now < self._hold_until:
                    return
                if self._probe is not None:
                    knob, old = self._probe
                    if forced:
                        # the test seams define the post-probe rate directly
                        post = thr
                    elif now - self._probe_t >= self.judge_s:
                        # judge over ONLY the post-raise interval — the
                        # window_s moving average barely moves per tick and
                        # would rubber-stamp every probe
                        post = tel.rate("pull_bytes_total",
                                        max(now - self._probe_t, 1e-9))
                    else:
                        return  # let the raise settle before judging
                    self._probe = None
                    if self._probe_base > 0 \
                            and post < 0.85 * self._probe_base:
                        # the raise cost throughput: revert and hold
                        cur = getattr(self, knob)
                        self._decide(
                            "revert", knob, cur, old,
                            f"thr {post:.0f} < 0.85x {self._probe_base:.0f}")
                        setattr(self, knob, old)
                        self._hold_until = now + 4 * self.tick_s
                        return
                self._best_thr = max(self._best_thr, thr)
                device_pressure = (place_p99 > self.place_hi
                                   or hbm_pressure > self.hbm_hi)
                if device_pressure and \
                        self.prefetch_depth > max(1, self.min_prefetch):
                    # device-bound: the accelerator (or the landing
                    # budget feeding it) can't absorb what prefetch
                    # already committed — trade depth for place latency
                    new = self.prefetch_depth - 1
                    reason = (f"place-p99 {place_p99:.2f}s"
                              if place_p99 > self.place_hi
                              else f"hbm-pressure {hbm_pressure:.2f}")
                    self._decide("decrease", "prefetch_depth",
                                 self.prefetch_depth, new, reason)
                    self.prefetch_depth = new
                    return
                if budget_wait_share > 0.5 and \
                        self.prefetch_depth > max(1, self.min_prefetch):
                    # admission-bound: deeper prefetch pins more host RAM
                    new = self.prefetch_depth - 1
                    self._decide("decrease", "prefetch_depth",
                                 self.prefetch_depth, new,
                                 f"budget-wait share {budget_wait_share:.2f}")
                    self.prefetch_depth = new
                    return
                self._raise_one(thr, device_pressure=device_pressure)
        finally:
            # gauges reflect the POST-decision knob values — the scrape
            # must agree with what the fetch loop will use
            self._gauges(thr)


# ----------------------------------------------------- active-tuner registry

_active_lock = threading.Lock()
_active: list[PullTuner] = []


def _register(t: PullTuner) -> None:
    with _active_lock:
        _active.append(t)


def _unregister(t: PullTuner) -> None:
    with _active_lock:
        if t in _active:
            _active.remove(t)


def current() -> PullTuner | None:
    """The most recently started live tuner (None when no pull is being
    tuned)."""
    with _active_lock:
        return _active[-1] if _active else None
