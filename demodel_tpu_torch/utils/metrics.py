"""Process-wide counters, gauges, histograms, the telemetry ring, and
the Prometheus exposition: the port of ``demodel_tpu.utils.metrics``
(stdlib only, kept in step with it: the same names, ``le`` schedule,
knobs and JSON shapes).

One ``/metrics`` endpoint merges three sources: the Python-side
counters (:data:`HUB`), the native proxy's atomic counters and
per-route latency histograms (``dm_proxy_metrics`` JSON), and store
gauges computed from the content-addressed index.

Histograms are fixed log-bucketed (×2 per bucket from 100 µs to ~52 s):
``observe()`` is one bisect and three adds under the hub lock, and every
exposition consumer shares one ``le`` schedule, so server-side and
client-side p99s are directly comparable.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
import weakref
from bisect import bisect_left
from typing import Any, Callable, Sequence

#: shared exponential bucket bounds (seconds): 1e-4 · 2^i — 100 µs doubling
#: up to ~52 s, +Inf implicit. One schedule for every duration histogram,
#: Python and native, so cross-surface quantiles line up bucket-for-bucket.
BUCKET_BOUNDS: tuple[float, ...] = tuple(1e-4 * 2 ** i for i in range(20))


def le_str(bound: float) -> str:
    """Canonical ``le`` label text for a bucket bound (``+Inf`` safe)."""
    if bound == float("inf"):
        return "+Inf"
    return "%.6g" % bound


class Histogram:
    """Log-bucketed distribution: counts per bucket (last = +Inf overflow),
    running sum and count. NOT thread-safe on its own — the hub serializes
    ``observe`` under its lock; standalone users bring their own."""

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

    def quantile(self, q: float) -> float:
        return hist_quantile(self.bounds, self.counts, q)


def hist_quantile(bounds: Sequence[float], counts: Sequence[int],
                  q: float) -> float:
    """Upper-bound quantile estimate from per-bucket (non-cumulative)
    counts: the bound of the bucket holding the q-th sample — the honest
    answer a log-bucketed histogram can give (within one ×2 bucket).
    +Inf-bucket hits report the largest finite bound (there is no upper
    bound to quote). Empty histogram → 0."""
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
    histograms (log-bucketed distributions).

    Names may carry a Prometheus label suffix built by :func:`labeled`
    (``peer_retries_total{peer="http://a:8080"}``) — the exposition
    groups samples under one ``# TYPE`` line per base name.
    """

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
        """One histogram sample (seconds for latency series). Creates the
        histogram on first observation — the fixed bucket schedule means
        there is nothing else to configure."""
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

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def histograms(self) -> dict[str, dict[str, Any]]:
        """``name → {le, counts, sum, count}`` snapshot (counts per bucket,
        non-cumulative; the exposition cumulates)."""
        with self._lock:
            return {
                name: {"le": list(h.bounds), "counts": list(h.counts),
                       "sum": h.sum, "count": h.count}
                for name, h in self._hists.items()
            }

    # -- time series (the telemetry plane) -----------------------------
    def telemetry(self) -> "Telemetry":
        """This hub's :class:`Telemetry` ring (created on first use)."""
        with self._telemetry_lock:
            if self._telemetry is None:
                self._telemetry = Telemetry(_hub_source(self))
            return self._telemetry

    def rate(self, name: str, window_s: float = 30.0,
             **labels: str | None) -> float:
        """Per-second increase of counter ``name`` over the trailing
        window (0.0 until two snapshots exist). Label kwargs select one
        labeled series: ``rate("peer_retries_total", peer=url)``."""
        return self.telemetry().rate(name, window_s, **labels)

    def window_quantile(self, name: str, q: float,
                        window_s: float = 30.0,
                        **labels: str | None) -> float:
        """Quantile of histogram ``name`` over ONLY the samples observed
        in the trailing window — the delta of the cumulative buckets
        between two ring snapshots, never the lifetime distribution."""
        return self.telemetry().window_quantile(name, q, window_s, **labels)

    def series(self, name: str, **labels: str | None) -> list[dict[str, Any]]:
        """Per-snapshot dump of one family across the telemetry ring."""
        return self.telemetry().series(name, **labels)

    def label_rates(self, base_name: str,
                    window_s: float = 30.0) -> dict[str, float]:
        """Per-series rates of one labeled family (full sample name →
        rate) — :meth:`family_rate` without the aggregation."""
        return self.telemetry().label_rates(base_name, window_s)

    def reset(self) -> None:  # tests only
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


_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_labels(name: str) -> tuple[str, dict[str, str]]:
    """Inverse of :func:`labeled`: ``(base family, labels)`` for a sample
    name — how consumers (the fleet per-peer table, the history reader)
    attribute a labeled series back to its peer/span/route."""
    base, brace, rest = name.partition("{")
    if not brace:
        return name, {}
    labels = {
        k: v.replace(r"\n", "\n").replace(r"\"", '"').replace(r"\\", "\\")
        for k, v in _LABEL_RE.findall(rest)
    }
    return base, labels


#: native proxy metrics that are point-in-time pool state, not monotonic
#: counters — the session executor's live occupancy, queue depth, the
#: reactor's parked keep-alive connections, and the writer plane's
#: in-flight EPOLLOUT drains / spliced CONNECT tunnels
PROXY_GAUGES = frozenset({"sessions_active", "sessions_queue_depth",
                          "sessions_parked", "conns_writing",
                          "tunnels_spliced", "store_degraded"})


# ------------------------------------------------------- telemetry plane
#
# Point-in-time counters answer "how many ever"; production triage needs
# "how many per second RIGHT NOW" and "what was the p99 over the last 30
# seconds". The telemetry plane is a bounded in-process ring of periodic
# snapshots (counters, gauges, histogram bucket vectors) over ANY scrape
# source — the Python hub, or the native proxy's metrics JSON diffed
# scrape-over-scrape — with windowed views computed between ring entries:
# counter → rate, gauge → last, histogram → quantile over the DELTA of
# the cumulative buckets (never the lifetime distribution, which a
# long-lived process's history would otherwise dominate).
#
# Sampling is poll-driven, not threaded: every windowed query freshens
# the ring first (rate-limited), so the periodic consumers that exist
# anyway — the tuner tick, the retention flusher, a
# ``/debug/telemetry`` poller — ARE the samplers, and an idle process
# pays nothing. Between two distant polls the window simply stretches to
# the nearest older snapshot (rates divide by real elapsed time, so
# accuracy survives irregular cadence).


def _telemetry_ring_cap() -> int:
    from demodel_tpu_torch.utils.env import env_int

    return env_int("DEMODEL_TELEMETRY_RING", 360, minimum=4)


def _telemetry_min_gap_s() -> float:
    from demodel_tpu_torch.utils.env import env_int

    return env_int("DEMODEL_TELEMETRY_MIN_GAP_MS", 250, minimum=1) / 1000.0


def _hub_source(hub: "Hub") -> Callable[[], dict[str, Any]]:
    def scrape() -> dict[str, Any]:
        hists = hub.histograms()
        return {
            "counters": hub.snapshot(),
            "gauges": hub.gauges(),
            "hists": {
                name: {"le": h["le"], "counts": h["counts"],
                       "sum": h["sum"]}
                for name, h in hists.items()
            },
        }
    return scrape


def native_source(proxy: Any) -> Callable[[], dict[str, Any]]:
    """Scrape source over the native proxy's metrics JSON: flat counters
    split from the known pool gauges, and the per-route ``"hist"`` export
    flattened to ``family{route="..."}`` names — the same windowed views
    as the Python hub, built by diffing successive scrapes in Python.
    Holds only a weak reference: a stopped/collected proxy makes the
    scrape raise, which :meth:`Telemetry.sample` degrades to a skipped
    sample (the ring keeps serving its history)."""
    ref = weakref.ref(proxy)

    def scrape() -> dict[str, Any]:
        p = ref()
        if p is None or not getattr(p, "_h", None):
            raise RuntimeError("native proxy stopped")
        native = p.metrics()
        hists_raw = native.pop("hist", None) or {}
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        for name, value in native.items():
            if not isinstance(value, (int, float)):
                continue
            (gauges if name in PROXY_GAUGES else counters)[name] = value
        hists: dict[str, dict[str, Any]] = {}
        if isinstance(hists_raw, dict):
            for family, spec in hists_raw.items():
                le = list(spec.get("le", []))
                for route, h in spec.get("routes", {}).items():
                    hists[labeled(family, route=route)] = {
                        "le": le, "counts": list(h.get("counts", [])),
                        "sum": float(h.get("sum", 0.0))}
        return {"counters": counters, "gauges": gauges, "hists": hists}
    return scrape


class Telemetry:
    """Bounded ring of scrape snapshots + windowed views over them.

    ``source`` returns one scrape: ``{"counters": {name: v}, "gauges":
    {name: v}, "hists": {name: {"le": [...], "counts": [...], "sum": s}}}``.
    A raising source skips that sample (a stopped native proxy must not
    take the telemetry surface down). ``clock`` is injectable for tests.
    """

    def __init__(self, source: Callable[[], dict[str, Any]],
                 cap: int | None = None, min_gap_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self._source = source
        self.cap = cap if cap is not None else _telemetry_ring_cap()
        self.min_gap_s = (min_gap_s if min_gap_s is not None
                          else _telemetry_min_gap_s())
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: list[dict[str, Any]] = []
        #: a freshen() in flight has CLAIMED the next sample — concurrent
        #: freshens return instead of double-sampling (min-gap contract)
        self._freshening = False
        self.samples_taken = 0
        self.samples_failed = 0

    # -- sampling -------------------------------------------------------
    def sample(self) -> bool:
        """Take one snapshot now (True when it landed)."""
        try:
            scrape = self._source()
        except Exception as e:  # noqa: BLE001 — a dead source must not
            # take the telemetry surface (or its caller's plane) down
            with self._lock:
                self.samples_failed += 1
            _log().debug("telemetry scrape failed: %s", e)
            return False
        entry = {
            "ts": self._clock(),
            "wall": time.time(),
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
            self.samples_taken += 1
        return True

    def freshen(self, max_age_s: float | None = None) -> None:
        """Sample unless the newest snapshot is younger than the gap —
        how poll-driven consumers keep the ring current without a
        dedicated thread (and without flooding it under rapid polls).

        The staleness check and the claim to sample happen under ONE
        lock hold (``_freshening`` is the claim): two consumers polling
        the same stale ring would otherwise BOTH pass the check-then-act
        gap test and land two back-to-back snapshots, violating the
        min-gap contract the ring's sizing assumes (the scrape itself
        still runs outside the lock)."""
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

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def latest(self) -> dict[str, Any] | None:
        """Copy of the newest ring snapshot (None when empty) — what the
        retention archive's flusher diffs window-over-window."""
        with self._lock:
            if not self._ring:
                return None
            e = self._ring[-1]
            return {"ts": e["ts"], "wall": e["wall"],
                    "counters": dict(e["counters"]),
                    "gauges": dict(e["gauges"]),
                    "hists": dict(e["hists"])}

    # -- window selection ----------------------------------------------
    @staticmethod
    def _pair_in(ring: list[dict],
                 window_s: float) -> tuple[dict, dict] | None:
        """(baseline, newest) snapshots ~window_s apart within ``ring``:
        the baseline is the entry closest to ``newest.ts - window_s`` —
        a short ring truncates the window honestly (rates divide by real
        elapsed), and fewer than two snapshots means no window at all."""
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

    # -- windowed views -------------------------------------------------
    @staticmethod
    def _rate_between(base: dict, newest: dict, name: str) -> float:
        elapsed = newest["ts"] - base["ts"]
        if elapsed <= 0:
            return 0.0
        now_v = float(newest["counters"].get(name, 0.0))
        old_v = float(base["counters"].get(name, 0.0))
        if now_v < old_v:
            old_v = 0.0  # counter reset (process restart): rate from zero
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
        """Sum of :meth:`rate` over every labeled series of one family
        (``peer_retries_total{peer="..."}`` across all peers)."""
        self.freshen()
        pair = self._pair(window_s)
        if pair is None:
            return 0.0
        base, newest = pair
        prefix = base_name + "{"
        return sum(self._rate_between(base, newest, name)
                   for name in newest["counters"]
                   if name == base_name or name.startswith(prefix))

    def label_rates(self, base_name: str,
                    window_s: float = 30.0) -> dict[str, float]:
        """Per-series rates of one labeled family over the trailing
        window: full sample name → rate, nonzero series only (the
        unlabeled base series included when it exists). The per-peer
        answer :meth:`family_rate`'s sum throws away."""
        self.freshen()
        pair = self._pair(window_s)
        if pair is None:
            return {}
        base, newest = pair
        prefix = base_name + "{"
        out: dict[str, float] = {}
        for name in sorted(newest["counters"]):
            if name == base_name or name.startswith(prefix):
                r = self._rate_between(base, newest, name)
                if r:
                    out[name] = round(r, 6)
        return out

    @staticmethod
    def _delta_between(base: dict, newest: dict,
                       name: str) -> dict[str, Any] | None:
        """Histogram delta between two snapshots: ``{le, counts, sum,
        count, elapsed_s}`` of only the in-between observations,
        reset-safe (a shrunken bucket means the source restarted — the
        baseline is then treated as empty)."""
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
        return {
            "le": list(le), "counts": counts,
            "sum": max(0.0, now_sum - old_sum), "count": sum(counts),
            "elapsed_s": newest["ts"] - base["ts"],
        }

    def window_delta(self, name: str, window_s: float = 30.0,
                     **labels: str | None) -> dict[str, Any] | None:
        """Histogram delta over the trailing window. None when no window
        exists or the family has no snapshots."""
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

    def series(self, name: str, **labels: str | None) -> list[dict[str, Any]]:
        """The raw ring values of one family, oldest first: counters and
        gauges dump ``value``, histograms ``count``/``sum``."""
        if labels:
            name = labeled(name, **labels)
        with self._lock:
            ring = list(self._ring)
        out: list[dict[str, Any]] = []
        for s in ring:
            if name in s["hists"]:
                _le, counts, hsum = s["hists"][name]
                out.append({"ts": s["wall"], "count": int(sum(counts)),
                            "sum": hsum})
            elif name in s["counters"]:
                out.append({"ts": s["wall"],
                            "value": s["counters"][name]})
            elif name in s["gauges"]:
                out.append({"ts": s["wall"], "value": s["gauges"][name]})
        return out

    def summary(self, windows_s: Sequence[float] = (30.0, 300.0)
                ) -> dict[str, Any]:
        """Every family's windowed view — the ``/debug/telemetry``
        document body: histograms get count/rate/p50/p99 per window,
        counters a rate per window, gauges their last value."""
        self.freshen()
        # ONE ring snapshot under ONE lock hold for the whole document:
        # every family's delta, every counter's rate, the gauges, and
        # the name iteration all derive from the same (baseline, newest)
        # snapshots — a concurrent sample() landing mid-build cannot mix
        # two different windows into one JSON document (and the O(ring)
        # baseline scan runs per window, not per family)
        with self._lock:
            ring = list(self._ring)
        newest = ring[-1] if ring else None
        out: dict[str, Any] = {
            "snapshots": len(ring),
            "windows_s": [int(w) for w in windows_s],
            "hist": {}, "rates": {}, "gauges": {},
        }
        if newest is None:
            return out
        out["gauges"] = dict(newest["gauges"])
        pairs = {w: self._pair_in(ring, w) for w in windows_s}
        for name in sorted(newest["hists"]):
            fam: dict[str, Any] = {}
            for w in windows_s:
                d = (self._delta_between(*pairs[w], name)
                     if pairs[w] is not None else None)
                if d is None:
                    continue
                fam[str(int(w))] = {
                    "count": d["count"],
                    "rate": round(d["count"] / d["elapsed_s"], 6)
                    if d["elapsed_s"] > 0 else 0.0,
                    "p50": hist_quantile(d["le"], d["counts"], 0.5)
                    if d["count"] else 0.0,
                    "p99": hist_quantile(d["le"], d["counts"], 0.99)
                    if d["count"] else 0.0,
                    "sum": round(d["sum"], 6),
                }
            if fam:
                out["hist"][name] = fam
        for name in sorted(newest["counters"]):
            rates = {
                str(int(w)): round(
                    self._rate_between(*pairs[w], name), 6)
                for w in windows_s if pairs[w] is not None}
            if any(v for v in rates.values()):
                out["rates"][name] = rates
        return out


#: per-proxy native telemetry rings, weakly keyed — a stopped proxy's
#: ring falls out with the wrapper object
_native_lock = threading.Lock()
_native_rings: "weakref.WeakKeyDictionary[Any, Telemetry]" = \
    weakref.WeakKeyDictionary()


def native_telemetry(proxy: Any) -> Telemetry:
    """The scrape-diff telemetry ring for one native proxy (created on
    first use; one ring per proxy instance)."""
    with _native_lock:
        tel = _native_rings.get(proxy)
        if tel is None:
            tel = _native_rings[proxy] = Telemetry(native_source(proxy))
        return tel


def telemetry_doc(proxy: Any = None,
                  windows_s: Sequence[float] = (30.0, 300.0)
                  ) -> dict[str, Any]:
    """The ``/debug/telemetry`` JSON document: the Python hub's windowed
    view, plus the native proxy's (scrape-diffed) when one is attached —
    serve-leg AND pull-leg p99s as sliding windows, one curl."""
    doc: dict[str, Any] = {
        "telemetry": 1,
        "time": time.time(),
        "pid": os.getpid(),
        "windows": HUB.telemetry().summary(windows_s),
    }
    if proxy is not None:
        doc["native"] = native_telemetry(proxy).summary(windows_s)
    return doc


def _fmt(value: float) -> str:
    return str(int(value)) if float(value).is_integer() else repr(value)


def _emit(lines: list[str], items: dict[str, float], mtype: str) -> None:
    """Samples sorted by name, one ``# TYPE`` line per base metric name
    (labeled samples of one metric sort adjacent and share it)."""
    last_base = None
    for name, value in sorted(items.items()):
        base = name.split("{", 1)[0]
        if base != last_base:
            lines.append(f"# TYPE demodel_{base} {mtype}")
            last_base = base
        lines.append(f"demodel_{name} {_fmt(value)}")


def _with_label(name: str, key: str, value: str) -> str:
    """Splice one more label into a (possibly already-labeled) sample name:
    ``x{a="b"}`` + ``le=0.1`` → ``x{a="b",le="0.1"}``."""
    base, brace, rest = name.partition("{")
    if brace:
        return f'{base}{{{rest[:-1]},{key}="{value}"}}'
    return f'{base}{{{key}="{value}"}}'


def _emit_hist(lines: list[str], prefix: str, name: str,
               le: Sequence[float], counts: Sequence[int], total_sum: float,
               count: int, emitted_types: set[str]) -> None:
    """One histogram series in exposition shape: cumulative ``_bucket``
    samples (one per bound + ``+Inf``), then ``_sum``/``_count``. The
    ``# TYPE`` line is per base name — labeled series of one metric
    (``span=...``, ``route=...``) share it via ``emitted_types``."""
    base = name.split("{", 1)[0]
    metric_base = f"{prefix}{base}"
    if metric_base not in emitted_types:
        emitted_types.add(metric_base)
        lines.append(f"# TYPE {metric_base} histogram")
    cum = 0
    bounds = [*le, float("inf")]
    for bound, n in zip(bounds, counts):
        cum += int(n)
        sample = _with_label(f"{base}_bucket" + name[len(base):],
                             "le", le_str(bound))
        lines.append(f"{prefix}{sample} {cum}")
    labels = name[len(base):]
    lines.append(f"{prefix}{base}_sum{labels} {_fmt(float(total_sum))}")
    lines.append(f"{prefix}{base}_count{labels} {count}")


def render(proxy: Any = None, store: Any = None) -> str:
    """Prometheus text exposition (0.0.4): HUB counters/gauges/histograms
    as ``demodel_<name>``, native proxy counters + per-route histograms as
    ``demodel_proxy_<name>``, store gauges as
    ``demodel_store_{objects,bytes}``."""
    lines: list[str] = []
    _emit(lines, HUB.snapshot(), "counter")
    _emit(lines, HUB.gauges(), "gauge")
    hist_types: set[str] = set()
    for name, h in sorted(HUB.histograms().items()):
        _emit_hist(lines, "demodel_", name, h["le"], h["counts"],
                   h["sum"], h["count"], hist_types)
    if proxy is not None:
        try:
            native = proxy.metrics()
        except Exception:  # noqa: BLE001 — metrics must never take a node down
            native = {}
        hists = native.pop("hist", None)
        for name, value in sorted(native.items()):
            if not isinstance(value, (int, float)):
                continue  # forward-compat: unknown structured sub-objects
            metric = f"demodel_proxy_{name}"
            mtype = "gauge" if name in PROXY_GAUGES else "counter"
            lines.append(f"# TYPE {metric} {mtype}")
            lines.append(f"{metric} {_fmt(value)}")
        if isinstance(hists, dict):
            for family, spec in sorted(hists.items()):
                le = spec.get("le", [])
                for route, h in sorted(spec.get("routes", {}).items()):
                    _emit_hist(lines, "demodel_proxy_",
                               labeled(family, route=route), le,
                               h.get("counts", []), h.get("sum", 0.0),
                               int(h.get("count", 0)), hist_types)
    if store is not None:
        try:
            idx = store.index().get("keys", [])
            lines.append("# TYPE demodel_store_objects gauge")
            lines.append(f"demodel_store_objects {len(idx)}")
            lines.append("# TYPE demodel_store_bytes gauge")
            lines.append(
                f"demodel_store_bytes {sum(e.get('size', 0) for e in idx)}")
            lines.append("# TYPE demodel_store_evictions_total counter")
            lines.append(
                f"demodel_store_evictions_total {store.evictions_total()}")
        except Exception as e:  # noqa: BLE001 — metrics must never take a
            # node down; a scrape missing its store gauges says why here
            _log().debug("store gauges unavailable: %s", e)
    return "\n".join(lines) + "\n"


def _log() -> logging.Logger:
    """Logger, resolved lazily: utils.metrics must stay import-light (it
    is imported by the native store wrapper during early bring-up)."""
    from demodel_tpu_torch.utils.logging import get_logger

    return get_logger("metrics")
