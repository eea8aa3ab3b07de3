"""Continuous sampling profiler — the "why is it slow" layer: the port
of ``demodel_tpu.utils.profiler`` (stdlib only; the same knobs, record
shapes and collapsed format).

Telemetry says *what* is slow (per-stage p99s) and retention says
*when* it got slow; this module answers *why*: which frames were on-CPU
and which were parked when ``serve.decode-step`` p99 doubled.
Always-on sampling, joined to the span context
:mod:`demodel_tpu_torch.utils.trace` already propagates.

- a daemon **sampler thread** walks ``sys._current_frames()`` at
  ``DEMODEL_PROFILE_HZ`` (default 19 — deliberately off the common
  10/100 Hz beat so round-rate periodic work doesn't alias), folds each
  thread's stack into a collapsed key (``seg;seg;seg``) and bumps a
  bounded aggregate (``DEMODEL_PROFILE_MAX_STACKS``; past the bound
  stacks fold into ``(other)`` and a drop counter).
- **span attribution**: every sample's folded key is rooted at the
  innermost *live* span on that thread (from the trace in-flight
  registry, joined by the span's starting-thread ident) — so a profile
  slices by stage (``serve.decode-step``, ``window-read``, ``place``, …).
- **wall vs on-CPU**: each sampled thread's per-thread CPU clock
  (Linux ``CPUCLOCK_SCHED | CPUCLOCK_PERTHREAD``, fallback
  ``/proc/self/task/<tid>/schedstat``, else wall-only) decides whether
  the tick found it running or parked — a lock convoy shows as wall
  samples with no CPU, a hot loop as both.
- **windows**: the aggregate rolls every ``DEMODEL_PROFILE_WINDOW_S``
  into a bounded pending queue the retention plane drains into the
  ``TelemetryArchive`` (``kind="profile"`` records survive restarts).
- **capture** (the ``/debug/profile`` contract): snapshot the cumulative
  aggregate, sleep, snapshot again, diff — so concurrent captures never
  consume each other's (or the archive's) baseline.

Observability tiers follow :mod:`trace`: the profiler runs under
export/observe and ``DEMODEL_OBS=0`` kills it entirely —
:func:`ensure` then returns ``None`` and no thread ever starts.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any

from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.env import (
    profile_hz,
    profile_max_stacks,
    profile_window_s,
)
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("profiler")

#: frames deeper than this truncate (the aggregate key must stay small)
_MAX_DEPTH = 64
#: stacks kept verbatim per archived window; the tail rolls into (other)
_WINDOW_TOP = 128
#: pending archive windows (retention drains; bounded if it never does)
_PENDING_CAP = 8

# Linux per-thread CPU clockid for another thread, as pthread_getcpuclockid
# would build it: CPUCLOCK_SCHED (2) | CPUCLOCK_PERTHREAD_MASK (4), tid in
# the upper bits. Negative by construction — that is how dynamic clock ids
# are spelled.
_CPUCLOCK_SCHED_PERTHREAD = 6


def _thread_cpu_clockid(native_tid: int) -> int:
    return ((~native_tid) << 3) | _CPUCLOCK_SCHED_PERTHREAD


class Profiler:
    """One sampler thread + bounded folded-stack aggregates.

    Normally a process-wide singleton via :func:`ensure`; tests build
    private instances with small knobs.
    """

    def __init__(self, hz: int | None = None,
                 max_stacks: int | None = None,
                 window_s: float | None = None) -> None:
        self.hz = int(hz) if hz else profile_hz()
        self.max_stacks = int(max_stacks) if max_stacks else (
            profile_max_stacks())
        self.window_s = float(window_s) if window_s else float(
            profile_window_s())
        self._lock = threading.Lock()
        #: folded stack -> [wall_samples, cpu_samples]; never reset
        self._cum: dict[str, list[int]] = {}
        #: same shape, reset every window roll
        self._win: dict[str, list[int]] = {}
        self._samples = 0          # cumulative sampled thread-ticks
        self._win_samples = 0
        self._dropped = 0          # cumulative stacks folded to (other)
        self._win_dropped = 0
        self._errors = 0           # swallowed tick failures
        self._windows_rolled = 0
        self._pending: deque[dict[str, Any]] = deque(maxlen=_PENDING_CAP)
        self._last_window: dict[str, Any] | None = None
        self._win_t0 = 0.0         # monotonic start of current window
        #: temporary rate override (capture ``hz=`` query param); 0 = none
        self._hz_override = 0
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        # -- CPU-clock strategy: resolved here, immutable afterwards ----
        self._cpu_mode = self._resolve_cpu_mode()
        self._native_by_ident: dict[int, int] = {}
        self._cpu_last: dict[int, tuple[float, float]] = {}

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        with self._lock:
            self._win_t0 = time.monotonic()
        self._stop_evt.clear()
        t = threading.Thread(target=self._run, daemon=True,
                             name="demodel-profiler")
        self._thread = t
        t.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout=5.0)
        self._thread = None

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # ------------------------------------------------------------- sampling

    def _resolve_cpu_mode(self) -> str | None:
        """Pick the cheapest per-thread CPU read this kernel offers."""
        try:
            nid = threading.get_native_id()
        except AttributeError:
            return None
        try:
            time.clock_gettime(_thread_cpu_clockid(nid))
            return "clock"
        except (OSError, OverflowError, ValueError):
            pass
        try:
            with open(f"/proc/self/task/{nid}/schedstat", "rb") as f:
                int(f.read().split()[0])
            return "schedstat"
        except (OSError, ValueError, IndexError):
            return None

    def _read_cpu(self, native_tid: int) -> float | None:
        mode = self._cpu_mode
        if mode == "clock":
            try:
                return time.clock_gettime(_thread_cpu_clockid(native_tid))
            except (OSError, OverflowError, ValueError):
                return None
        if mode == "schedstat":
            try:
                path = f"/proc/self/task/{native_tid}/schedstat"
                with open(path, "rb") as f:
                    return int(f.read().split()[0]) / 1e9
            except (OSError, ValueError, IndexError):
                return None
        return None

    def _refresh_native_ids(self) -> None:
        """ident→kernel-tid map from the live thread list; prunes CPU
        bookkeeping for threads that exited (the maps must not grow with
        thread churn)."""
        fresh: dict[int, int] = {}
        for t in threading.enumerate():
            nid = getattr(t, "native_id", None)
            if t.ident is not None and nid is not None:
                fresh[t.ident] = nid
        self._native_by_ident = fresh
        live = set(fresh.values())
        self._cpu_last = {k: v for k, v in self._cpu_last.items()
                          if k in live}

    def _on_cpu(self, ident: int, now: float) -> bool:
        """Did this thread burn CPU since its previous tick? (>= half the
        inter-tick wall time counts as running; the first observation of
        a thread has no baseline and reads as parked.)"""
        nid = self._native_by_ident.get(ident)
        if nid is None:
            self._refresh_native_ids()
            nid = self._native_by_ident.get(ident)
            if nid is None:
                return False
        cpu = self._read_cpu(nid)
        if cpu is None:
            return False
        last = self._cpu_last.get(nid)
        self._cpu_last[nid] = (cpu, now)
        if last is None:
            return False
        wall_d = now - last[1]
        return wall_d > 0 and (cpu - last[0]) >= 0.5 * wall_d

    @staticmethod
    def _fold(frame: Any, span_name: str | None) -> str:
        """Collapsed key, root-first, span segment first: Brendan Gregg's
        fold format with the trace join baked into the hierarchy."""
        segs: list[str] = []
        f = frame
        depth = 0
        while f is not None and depth < _MAX_DEPTH:
            co = f.f_code
            base = co.co_filename.rsplit("/", 1)[-1]
            if base.endswith(".py"):
                base = base[:-3]
            name = getattr(co, "co_qualname", None) or co.co_name
            segs.append(f"{base}:{name}")
            f = f.f_back
            depth += 1
        root = (span_name or "-").replace(";", ",").replace(" ", "_")
        segs.append(root)
        segs.reverse()
        return ";".join(segs)

    def _spans_by_thread(self) -> dict[int, str]:
        """Innermost live span name per starting-thread ident — the
        trace↔profile join. Innermost = the live span with the latest
        start on that thread (children start after parents)."""
        best: dict[int, tuple[float, str]] = {}
        with trace._inflight_lock:
            spans = list(trace._inflight.values())
        for s in spans:
            if s.dur is not None:
                continue
            tid = s._thread_ident
            if tid is None:
                continue
            cur = best.get(tid)
            if cur is None or s._t0 > cur[0]:
                best[tid] = (s._t0, s.name)
        return {tid: name for tid, (_, name) in best.items()}

    def _bump(self, agg: dict[str, list[int]], folded: str,
              on_cpu: bool) -> bool:
        """Returns True when the stack was folded into (other)."""
        ent = agg.get(folded)
        dropped = False
        if ent is None:
            if len(agg) >= self.max_stacks:
                dropped = True
                ent = agg.get("(other)")
                if ent is None:
                    ent = agg["(other)"] = [0, 0]
            else:
                ent = agg[folded] = [0, 0]
        ent[0] += 1
        if on_cpu:
            ent[1] += 1
        return dropped

    def _tick(self) -> None:
        frames = sys._current_frames()
        now = time.perf_counter()
        span_by_tid = self._spans_by_thread()
        me = threading.get_ident()
        samples: list[tuple[str, bool]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue  # the sampler never profiles itself
            folded = self._fold(frame, span_by_tid.get(ident))
            samples.append((folded, self._on_cpu(ident, now)))
        del frames  # drop frame refs promptly — they pin locals alive
        n_dropped = 0
        with self._lock:
            for folded, on_cpu in samples:
                if self._bump(self._cum, folded, on_cpu):
                    n_dropped += 1
                self._bump(self._win, folded, on_cpu)
            self._samples += len(samples)
            self._win_samples += len(samples)
            self._dropped += n_dropped
            self._win_dropped += n_dropped
        from demodel_tpu_torch.utils import metrics

        metrics.HUB.inc("profiler_samples_total", len(samples))
        if n_dropped:
            metrics.HUB.inc("profiler_stacks_dropped_total", n_dropped)

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            with self._lock:
                hz = self._hz_override or self.hz
            period = 1.0 / max(1, hz)
            t0 = time.perf_counter()
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the profiler must
                # never take the plane down; count and keep sampling
                with self._lock:
                    self._errors += 1
                    errors = self._errors
                if errors <= 3:
                    log.warning("profiler tick failed: %s", e)
            self._roll_window()
            elapsed = time.perf_counter() - t0
            self._stop_evt.wait(max(0.001, period - elapsed))

    # -------------------------------------------------------------- windows

    def _roll_window(self, force: bool = False) -> None:
        """Roll the window aggregate into a pending archive record when
        the window elapsed (always, under ``force`` — tests). The
        elapsed check and the swap share one lock hold: checking outside
        would race a concurrent roll and double-emit."""
        now_mono = time.monotonic()
        with self._lock:
            if not force and now_mono - self._win_t0 < self.window_s:
                return
            win, self._win = self._win, {}
            samples, self._win_samples = self._win_samples, 0
            dropped, self._win_dropped = self._win_dropped, 0
            hz = self._hz_override or self.hz
            dur = max(0.0, now_mono - self._win_t0)
            self._win_t0 = now_mono
            self._windows_rolled += 1
        rec = {
            "kind": "profile",
            "plane": "python",
            "ts": time.time(),
            "window_s": round(dur, 3),
            "hz": hz,
            "samples": samples,
            "dropped": dropped,
            "cpu_mode": self._cpu_mode,
            "stacks": _top_stacks(win, _WINDOW_TOP),
        }
        with self._lock:
            self._pending.append(rec)
            self._last_window = rec
        # stale-thread hygiene rides the window cadence
        self._refresh_native_ids()

    def drain_windows(self) -> list[dict[str, Any]]:
        """Pop every pending window record (the retention flush path)."""
        out: list[dict[str, Any]] = []
        while True:
            try:
                out.append(self._pending.popleft())
            except IndexError:
                return out

    def last_window(self) -> dict[str, Any] | None:
        with self._lock:
            return self._last_window

    def partial_window(self) -> dict[str, Any]:
        """The current (un-rolled) window as a record — read-only; the
        archive baseline is untouched. What SIGUSR2 embeds when no full
        window has rolled yet."""
        with self._lock:
            win = {k: list(v) for k, v in self._win.items()}
            samples = self._win_samples
            dropped = self._win_dropped
            hz = self._hz_override or self.hz
            win_t0 = self._win_t0
        return {
            "kind": "profile",
            "plane": "python",
            "ts": time.time(),
            "window_s": round(max(0.0, time.monotonic() - win_t0), 3),
            "hz": hz,
            "samples": samples,
            "dropped": dropped,
            "cpu_mode": self._cpu_mode,
            "partial": True,
            "stacks": _top_stacks(win, _WINDOW_TOP),
        }

    # -------------------------------------------------------------- capture

    def snapshot(self) -> dict[str, list[int]]:
        """Copy of the cumulative aggregate (stack -> [wall, cpu])."""
        with self._lock:
            return {k: list(v) for k, v in self._cum.items()}

    def capture(self, seconds: float = 1.0, hz: int = 0) -> dict[str, Any]:
        """The ``/debug/profile`` semantics: cumulative snapshot, sleep,
        snapshot, diff. ``seconds=0`` returns the whole cumulative
        aggregate without sleeping; ``hz`` temporarily overrides the
        sampling rate for the capture's duration."""
        seconds = max(0.0, min(float(seconds), 60.0))
        with self._lock:
            prev_override = self._hz_override
            if hz > 0:
                self._hz_override = min(int(hz), 1000)
        try:
            if seconds > 0:
                before = self.snapshot()
                time.sleep(seconds)
                after = self.snapshot()
                diff: dict[str, list[int]] = {}
                for k, v in after.items():
                    b = before.get(k)
                    wall = v[0] - (b[0] if b else 0)
                    cpu = v[1] - (b[1] if b else 0)
                    if wall > 0 or cpu > 0:
                        diff[k] = [wall, cpu]
            else:
                diff = self.snapshot()
        finally:
            # demodel: allow(atomic-snapshot) — save/restore of an
            # advisory rate override: concurrent captures race benignly
            # (last restore wins; the sampler just reads whatever is
            # current each tick)
            with self._lock:
                self._hz_override = prev_override
        stacks = _top_stacks(diff, None)
        return {
            "plane": "python",
            "hz": hz or self.hz,
            "seconds": seconds,
            "samples": sum(s["wall"] for s in stacks),
            "cpu_mode": self._cpu_mode,
            "stacks": stacks,
        }

    # ------------------------------------------------------------- statusz

    def describe(self) -> dict[str, Any]:
        with self._lock:
            n_stacks = len(self._cum)
            samples = self._samples
            dropped = self._dropped
            errors = self._errors
            rolled = self._windows_rolled
        return {
            "running": self.alive(),
            "hz": self.hz,
            "cpu_mode": self._cpu_mode,
            "samples": samples,
            "stacks": n_stacks,
            "dropped": dropped,
            "errors": errors,
            "windows_rolled": rolled,
            "window_s": self.window_s,
        }


def _top_stacks(agg: dict[str, list[int]],
                top: int | None) -> list[dict[str, Any]]:
    """Aggregate dict → sorted stack entries, heaviest wall first;
    past ``top`` the tail rolls into one ``(other)`` entry (archive
    records must stay bounded regardless of stack diversity)."""
    rows = sorted(agg.items(), key=lambda kv: (-kv[1][0], kv[0]))
    out = [{"stack": k, "wall": v[0], "cpu": v[1]}
           for k, v in (rows if top is None else rows[:top])]
    if top is not None and len(rows) > top:
        wall = sum(v[0] for _, v in rows[top:])
        cpu = sum(v[1] for _, v in rows[top:])
        out.append({"stack": "(other)", "wall": wall, "cpu": cpu})
    return out


def collapse(profile: dict[str, Any]) -> str:
    """A capture/window record → collapsed text (``stack count`` lines,
    wall samples — the flamegraph.pl / speedscope contract). The CPU
    split stays JSON-only; collapsed is the lowest-common-denominator
    interchange the bench legs and ``profile_report.py`` share."""
    lines = [f"{s['stack']} {s['wall']}" for s in profile.get("stacks", ())
             if s.get("wall", 0) > 0]
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------- process-wide singleton

_glock = threading.Lock()
_profiler: Profiler | None = None


def ensure() -> Profiler | None:
    """Start (or return) the process profiler. ``None`` when the
    observability tier is fully off (``DEMODEL_OBS=0``) — no thread, no
    allocation beyond this check: the zero-cost contract."""
    global _profiler
    if not trace.active():
        return None
    with _glock:
        p = _profiler
        if p is None or not p.alive():
            p = Profiler()  # demodel: allow(no-blocking-io-under-lock) — the CPU-clock probe reads one 2-line /proc schedstat file, once per process, and only on kernels without per-thread clock_gettime
            p.start()  # demodel: allow(no-blocking-io-under-lock) — start() only spawns the daemon sampler; the open() the call-graph walk reaches runs on THAT thread, never under _glock
            _profiler = p
        return p


def current() -> Profiler | None:
    """The running profiler, or None — never starts one (the peek the
    dep-light surfaces use)."""
    return _profiler


def stop() -> None:
    global _profiler
    with _glock:
        p, _profiler = _profiler, None
    if p is not None:
        p.stop()


def _reset_for_tests() -> None:
    stop()


def capture(seconds: float = 1.0, hz: int = 0) -> dict[str, Any] | None:
    """Module-level capture against the singleton (starting it if the
    tier allows); the ``/debug/profile`` handlers call this."""
    p = ensure()
    if p is None:
        return None
    return p.capture(seconds=seconds, hz=hz)


def drain_windows() -> list[dict[str, Any]]:
    """Pending archive windows from the singleton (retention flush glue;
    empty when the profiler never started)."""
    p = _profiler
    return p.drain_windows() if p is not None else []


def recorder_window() -> dict[str, Any] | None:
    """What a flight-recorder dump embeds: the last rolled window, else
    the live partial window — never consumes the archive queue."""
    p = _profiler
    if p is None:
        return None
    return p.last_window() or p.partial_window()


def describe() -> dict[str, Any] | None:
    """Statusz section (None when not running)."""
    p = _profiler
    return p.describe() if p is not None else None
