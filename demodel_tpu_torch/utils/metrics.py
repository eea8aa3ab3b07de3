"""Process-wide counters, gauges, histograms + Prometheus exposition.

The part of ``demodel_tpu.utils.metrics`` the serving plane uses:
:data:`HUB` (``inc`` / ``set_gauge`` / ``observe``), :func:`labeled`,
the log-bucketed :class:`Histogram` (×2 per bucket from 100 µs to ~52 s,
the same ``le`` schedule as the JAX plane) and :func:`render` for
``/metrics``.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Sequence

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


class Hub:
    """Thread-safe named counters (monotonic), gauges (point-in-time) and
    histograms. Names may carry a label suffix built by :func:`labeled`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

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


def render() -> str:
    """Prometheus text exposition (0.0.4) of :data:`HUB` as
    ``demodel_<name>``: counters, gauges, then cumulative histogram
    ``_bucket``/``_sum``/``_count`` series."""
    lines: list[str] = []
    _emit(lines, HUB.snapshot(), "counter")
    _emit(lines, HUB.gauges(), "gauge")
    typed: set[str] = set()
    for name, h in sorted(HUB.histograms().items()):
        base = name.split("{", 1)[0]
        labels = name[len(base):]
        if base not in typed:
            typed.add(base)
            lines.append(f"# TYPE demodel_{base} histogram")
        cum = 0
        for bound, n in zip([*h["le"], float("inf")], h["counts"]):
            cum += int(n)
            sample = _with_label(f"{base}_bucket{labels}", "le",
                                 le_str(bound))
            lines.append(f"demodel_{sample} {cum}")
        lines.append(f"demodel_{base}_sum{labels} {_fmt(float(h['sum']))}")
        lines.append(f"demodel_{base}_count{labels} {h['count']}")
    return "\n".join(lines) + "\n"
