"""Process-wide counters, gauges, histograms + Prometheus exposition.

The part of ``demodel_tpu.utils.metrics`` the serving and pull planes
use: :data:`HUB` (``inc`` / ``set_gauge`` / ``observe``), :func:`labeled`,
the log-bucketed :class:`Histogram` (×2 per bucket from 100 µs to ~52 s,
the same ``le`` schedule as the JAX plane), :func:`render` for
``/metrics`` (with the native proxy's counters and the store's gauges
when given), and the :class:`Telemetry` ring of snapshots whose
windowed rates and quantiles the pull tuner reads.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Any, Callable, Sequence

from demodel_tpu_torch.utils.env import env_int
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("metrics")

#: shared exponential bucket bounds (seconds): 1e-4 · 2^i, +Inf implicit
BUCKET_BOUNDS: tuple[float, ...] = tuple(1e-4 * 2 ** i for i in range(20))


def le_str(bound: float) -> str:
    """Canonical ``le`` label text for a bucket bound (``+Inf`` safe)."""
    if bound == float("inf"):
        return "+Inf"
    return "%.6g" % bound


class Histogram:
    """Log-bucketed distribution: counts per bucket (last = +Inf
    overflow), running sum and count. Not thread-safe on its own — the
    hub serializes ``observe`` under its lock."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = BUCKET_BOUNDS) -> None:
        self.bounds: tuple[float, ...] = tuple(bounds)
        self.counts: list[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1


def hist_quantile(bounds: Sequence[float], counts: Sequence[int],
                  q: float) -> float:
    """Upper-bound quantile from per-bucket (non-cumulative) counts: the
    bound of the bucket holding the q-th sample; +Inf-bucket hits give
    the largest finite bound; an empty histogram gives 0."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = max(1.0, q * total)
    seen = 0
    for i, n in enumerate(counts):
        seen += n
        if seen >= rank and n:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


class Hub:
    """Thread-safe named counters (monotonic), gauges (point-in-time) and
    histograms. Names may carry a label suffix built by :func:`labeled`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}
        self._telemetry: "Telemetry | None" = None
        self._telemetry_lock = threading.Lock()

    def inc(self, name: str, amount: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """One histogram sample (seconds for latency series)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def get_gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0)

    def get_histogram(self, name: str) -> Histogram | None:
        """Point-in-time copy of one histogram (None when never observed)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            out = Histogram(h.bounds)
            out.counts = list(h.counts)
            out.sum = h.sum
            out.count = h.count
            return out

    def histograms(self) -> dict[str, dict[str, Any]]:
        """``name → {le, counts, sum, count}`` snapshot (counts per
        bucket, non-cumulative; the exposition cumulates)."""
        with self._lock:
            return {
                name: {"le": list(h.bounds), "counts": list(h.counts),
                       "sum": h.sum, "count": h.count}
                for name, h in self._hists.items()
            }

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def telemetry(self) -> "Telemetry":
        """This hub's :class:`Telemetry` ring (created on first use)."""
        with self._telemetry_lock:
            if self._telemetry is None:
                self._telemetry = Telemetry(_hub_source(self))
            return self._telemetry

    def reset(self) -> None:
        """Drop every series and the telemetry ring (tests)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
        with self._telemetry_lock:
            if self._telemetry is not None:
                self._telemetry.clear()


HUB = Hub()


def labeled(name: str, **labels: str | None) -> str:
    """``name{key="value",…}`` — the exposition-format sample name for a
    labeled metric (values escaped per Prometheus text format)."""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in sorted(labels.items()) if v is not None)
    return f"{name}{{{inner}}}" if inner else name


def _fmt(value: float) -> str:
    return str(int(value)) if float(value).is_integer() else repr(value)


def _emit(lines: list[str], items: dict[str, float], mtype: str) -> None:
    """Samples sorted by name, one ``# TYPE`` line per base metric name."""
    last_base = None
    for name, value in sorted(items.items()):
        base = name.split("{", 1)[0]
        if base != last_base:
            lines.append(f"# TYPE demodel_{base} {mtype}")
            last_base = base
        lines.append(f"demodel_{name} {_fmt(value)}")


def _with_label(name: str, key: str, value: str) -> str:
    """Splice one more label into a (possibly already-labeled) name."""
    base, brace, rest = name.partition("{")
    if brace:
        return f'{base}{{{rest[:-1]},{key}="{value}"}}'
    return f'{base}{{{key}="{value}"}}'


#: native proxy counters that are gauges (levels, not running totals)
PROXY_GAUGES = frozenset({"sessions_active", "sessions_queue_depth",
                          "sessions_parked", "conns_writing",
                          "tunnels_spliced", "store_degraded"})


def _emit_hist(lines: list[str], prefix: str, name: str,
               le: Sequence[float], counts: Sequence[int], total_sum: float,
               count: int, typed: set[str]) -> None:
    """One histogram series: cumulative ``_bucket`` samples (one per
    bound, then ``+Inf``), ``_sum`` and ``_count``; one ``# TYPE`` line
    per base name across its labeled series."""
    base = name.split("{", 1)[0]
    labels = name[len(base):]
    if prefix + base not in typed:
        typed.add(prefix + base)
        lines.append(f"# TYPE {prefix}{base} histogram")
    cum = 0
    for bound, n in zip([*le, float("inf")], counts):
        cum += int(n)
        sample = _with_label(f"{base}_bucket{labels}", "le", le_str(bound))
        lines.append(f"{prefix}{sample} {cum}")
    lines.append(f"{prefix}{base}_sum{labels} {_fmt(float(total_sum))}")
    lines.append(f"{prefix}{base}_count{labels} {count}")


def render(proxy: Any = None, store: Any = None) -> str:
    """Prometheus text exposition (0.0.4): :data:`HUB` as
    ``demodel_<name>`` (counters, gauges, then cumulative histograms);
    with ``proxy``, the native plane's counters and per-route histograms
    as ``demodel_proxy_<name>``; with ``store``, the gauges
    ``demodel_store_{objects,bytes}`` and the counter
    ``demodel_store_evictions_total``."""
    lines: list[str] = []
    _emit(lines, HUB.snapshot(), "counter")
    _emit(lines, HUB.gauges(), "gauge")
    typed: set[str] = set()
    for name, h in sorted(HUB.histograms().items()):
        _emit_hist(lines, "demodel_", name, h["le"], h["counts"], h["sum"],
                   h["count"], typed)
    if proxy is not None:
        try:
            native = proxy.metrics()
        except Exception as e:  # noqa: BLE001 — a scrape must not take
            # the node down
            log.debug("native proxy metrics unavailable: %s", e)
            native = {}
        hists = native.pop("hist", None)
        for name, value in sorted(native.items()):
            if not isinstance(value, (int, float)):
                continue  # structured sub-documents are not samples
            mtype = "gauge" if name in PROXY_GAUGES else "counter"
            lines.append(f"# TYPE demodel_proxy_{name} {mtype}")
            lines.append(f"demodel_proxy_{name} {_fmt(value)}")
        if isinstance(hists, dict):
            for family, spec in sorted(hists.items()):
                for route, h in sorted(spec.get("routes", {}).items()):
                    _emit_hist(lines, "demodel_proxy_",
                               labeled(family, route=route),
                               spec.get("le", []), h.get("counts", []),
                               h.get("sum", 0.0), int(h.get("count", 0)),
                               typed)
    if store is not None:
        try:
            idx = store.index().get("keys", [])
            evictions = store.evictions_total()
        except (OSError, ValueError) as e:
            log.debug("store gauges unavailable: %s", e)
        else:
            lines += ["# TYPE demodel_store_objects gauge",
                      f"demodel_store_objects {len(idx)}",
                      "# TYPE demodel_store_bytes gauge",
                      f"demodel_store_bytes "
                      f"{sum(e.get('size', 0) for e in idx)}",
                      "# TYPE demodel_store_evictions_total counter",
                      f"demodel_store_evictions_total {evictions}"]
    return "\n".join(lines) + "\n"


# ------------------------------------------------------- telemetry plane
#
# A bounded ring of periodic snapshots (counters, gauges, histogram
# bucket vectors) with windowed views between ring entries: counter →
# rate, histogram → quantile over the DELTA of the cumulative buckets.
# Sampling is poll-driven: every windowed query freshens the ring first
# (rate-limited), so the tuner's tick is the sampler.


def _hub_source(hub: Hub) -> Callable[[], dict[str, Any]]:
    def scrape() -> dict[str, Any]:
        return {
            "counters": hub.snapshot(),
            "gauges": hub.gauges(),
            "hists": {name: {"le": h["le"], "counts": h["counts"],
                             "sum": h["sum"]}
                      for name, h in hub.histograms().items()},
        }
    return scrape


class Telemetry:
    """Bounded ring of scrape snapshots and windowed views over them.

    ``source`` returns ``{"counters": {...}, "gauges": {...}, "hists":
    {name: {"le": [...], "counts": [...], "sum": s}}}``; a raising source
    skips that sample. ``clock`` is injectable for tests.
    """

    def __init__(self, source: Callable[[], dict[str, Any]],
                 cap: int | None = None, min_gap_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self._source = source
        self.cap = cap if cap is not None else env_int(
            "DEMODEL_TELEMETRY_RING", 360, minimum=4)
        self.min_gap_s = min_gap_s if min_gap_s is not None else env_int(
            "DEMODEL_TELEMETRY_MIN_GAP_MS", 250, minimum=1) / 1000.0
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: list[dict[str, Any]] = []
        #: a freshen() in flight has claimed the next sample
        self._freshening = False

    def sample(self) -> bool:
        """Take one snapshot now (True when it landed)."""
        try:
            scrape = self._source()
        except Exception as e:  # noqa: BLE001 — a dead source must not
            # take its caller down
            log.debug("telemetry scrape failed: %s", e)
            return False
        entry = {
            "ts": self._clock(),
            "counters": dict(scrape.get("counters", {})),
            "gauges": dict(scrape.get("gauges", {})),
            "hists": {
                name: (tuple(h.get("le", ())), tuple(h.get("counts", ())),
                       float(h.get("sum", 0.0)))
                for name, h in scrape.get("hists", {}).items()
            },
        }
        with self._lock:
            self._ring.append(entry)
            if len(self._ring) > self.cap:
                del self._ring[: len(self._ring) - self.cap]
        return True

    def freshen(self, max_age_s: float | None = None) -> None:
        """Sample unless the newest snapshot is younger than the gap; the
        check and the claim happen under one lock hold."""
        gap = max_age_s if max_age_s is not None else self.min_gap_s
        with self._lock:
            newest = self._ring[-1]["ts"] if self._ring else None
            if self._freshening or (newest is not None
                                    and self._clock() - newest < gap):
                return
            self._freshening = True
        try:
            self.sample()
        finally:
            with self._lock:
                self._freshening = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    @staticmethod
    def _pair_in(ring: list[dict],
                 window_s: float) -> tuple[dict, dict] | None:
        """(baseline, newest) about ``window_s`` apart; None with fewer
        than two snapshots."""
        if len(ring) < 2:
            return None
        newest = ring[-1]
        target = newest["ts"] - window_s
        base = min(ring[:-1], key=lambda s: abs(s["ts"] - target))
        return base, newest

    def _pair(self, window_s: float) -> tuple[dict, dict] | None:
        with self._lock:
            ring = list(self._ring)
        return self._pair_in(ring, window_s)

    @staticmethod
    def _rate_between(base: dict, newest: dict, name: str) -> float:
        elapsed = newest["ts"] - base["ts"]
        if elapsed <= 0:
            return 0.0
        now_v = float(newest["counters"].get(name, 0.0))
        old_v = float(base["counters"].get(name, 0.0))
        if now_v < old_v:
            old_v = 0.0  # counter reset: rate from zero
        return (now_v - old_v) / elapsed

    def rate(self, name: str, window_s: float = 30.0,
             **labels: str | None) -> float:
        if labels:
            name = labeled(name, **labels)
        self.freshen()
        pair = self._pair(window_s)
        if pair is None:
            return 0.0
        return self._rate_between(*pair, name)

    def family_rate(self, base_name: str, window_s: float = 30.0) -> float:
        """Sum of :meth:`rate` over every labeled series of one family."""
        self.freshen()
        pair = self._pair(window_s)
        if pair is None:
            return 0.0
        base, newest = pair
        prefix = base_name + "{"
        return sum(self._rate_between(base, newest, name)
                   for name in newest["counters"]
                   if name == base_name or name.startswith(prefix))

    @staticmethod
    def _delta_between(base: dict, newest: dict,
                       name: str) -> dict[str, Any] | None:
        """Histogram delta between two snapshots (a shrunken bucket means
        the source restarted: the baseline is then empty)."""
        now_h = newest["hists"].get(name)
        if now_h is None:
            return None
        le, now_counts, now_sum = now_h
        old_h = base["hists"].get(name)
        if old_h is None or len(old_h[1]) != len(now_counts) \
                or any(n < o for n, o in zip(now_counts, old_h[1])):
            old_counts: Sequence[int] = (0,) * len(now_counts)
            old_sum = 0.0
        else:
            old_counts, old_sum = old_h[1], old_h[2]
        counts = [int(n) - int(o) for n, o in zip(now_counts, old_counts)]
        return {"le": list(le), "counts": counts,
                "sum": max(0.0, now_sum - old_sum), "count": sum(counts),
                "elapsed_s": newest["ts"] - base["ts"]}

    def window_delta(self, name: str, window_s: float = 30.0,
                     **labels: str | None) -> dict[str, Any] | None:
        """Histogram delta over the trailing window (None without one)."""
        if labels:
            name = labeled(name, **labels)
        self.freshen()
        pair = self._pair(window_s)
        if pair is None:
            return None
        return self._delta_between(*pair, name)

    def window_quantile(self, name: str, q: float,
                        window_s: float = 30.0,
                        **labels: str | None) -> float:
        d = self.window_delta(name, window_s, **labels)
        if d is None or d["count"] <= 0:
            return 0.0
        return hist_quantile(d["le"], d["counts"], q)
