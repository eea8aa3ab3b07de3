"""Durable telemetry history: the retention plane, the port of
``demodel_tpu.utils.retention`` (stdlib only). Its segments are the
reference's byte for byte, so each package reads the other's archive.

The ``/debug/telemetry`` ring (:mod:`demodel_tpu_torch.utils.metrics`)
dies with the process. This module gives each window a second life on
disk:

- :class:`TelemetryArchive` owns a directory of **gzipped JSONL
  segments**. Every record is appended as ONE complete gzip member
  (members concatenate into a legal stream), so a crash mid-append
  leaves at most a truncated tail member that the reader tolerates —
  rotation needs no fsync choreography to stay crash-safe.
- A background **flusher** samples each attached
  :class:`~demodel_tpu_torch.utils.metrics.Telemetry` ring (the hub and,
  when a proxy is wired, the native mirror), diffs consecutive snapshots
  reset-safely, and appends one compact *window record* per new
  snapshot: counter deltas, gauge lasts, histogram bucket deltas.
- **Retention budgets**: segments rotate at a byte threshold and the
  oldest are evicted while the directory exceeds
  ``DEMODEL_TELEMETRY_RETAIN_MB`` or ages past
  ``DEMODEL_TELEMETRY_RETAIN_HOURS``.
- Segment names embed wall-clock start, pid, and a sequence number, so
  a **restarted node appends next to its previous incarnation's
  history** and :meth:`TelemetryArchive.history` reads one continuous
  per-family series across both.

The restore server imports this module only when
``DEMODEL_TELEMETRY_ARCHIVE`` is set.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable

from demodel_tpu_torch.utils import metrics
from demodel_tpu_torch.utils.env import (
    env_int,
    telemetry_archive_dir,
    telemetry_retain_hours,
    telemetry_retain_mb,
)
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("retention")

_SEGMENT_PREFIX = "telemetry-"
_SEGMENT_SUFFIX = ".jsonl.gz"

#: the archive's own meta-counters: live on /metrics and /debug/telemetry
#: but excluded from window records — archiving the act of archiving
#: would keep every otherwise-quiet window alive (write → counter inc →
#: next window non-quiet → write → …)
_SELF_FAMILIES = frozenset({
    "telemetry_archive_records_total",
    "telemetry_segments_evicted_total",
})


def _flush_gap_s() -> float:
    return env_int("DEMODEL_TELEMETRY_FLUSH_MS", 1000, minimum=20) / 1000.0


def _default_segment_bytes() -> int:
    return env_int("DEMODEL_TELEMETRY_SEGMENT_KB", 256, minimum=1) << 10


def _segment_start_ms(path: Path) -> int:
    """Wall-clock start embedded in a segment name (0 when unparseable —
    sorts foreign files first so they are evicted before real history)."""
    stem = path.name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
    head = stem.split("-", 1)[0]
    try:
        return int(head)
    except ValueError:
        return 0


def read_segment(path: Path) -> list[dict[str, Any]]:
    """Decode one segment, tolerating a truncated tail member.

    A crash mid-append leaves the final gzip member incomplete; reading
    in small chunks keeps everything decoded before the stream breaks,
    and only complete newline-terminated JSON lines are kept — the torn
    tail is dropped, never raised.
    """
    try:
        data = path.read_bytes()
    except OSError:
        return []
    raw = bytearray()
    pos = 0
    # member-by-member: a torn/garbage tail member must not poison the
    # complete members before it (a single buffered gzip read would —
    # it fills its buffer ACROSS members before surfacing the error)
    while pos < len(data):
        decomp = zlib.decompressobj(wbits=31)
        try:
            raw += decomp.decompress(data[pos:])
        except zlib.error:
            break  # corrupt tail member — keep prior members
        if not decomp.eof:
            break  # truncated tail member — keep its decoded prefix
        if not decomp.unused_data:
            break
        pos = len(data) - len(decomp.unused_data)
    records: list[dict[str, Any]] = []
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn line inside the truncated member
        if isinstance(rec, dict):
            records.append(rec)
    return records


def _base_name(name: str) -> str:
    return name.partition("{")[0]


def _matches(name: str, family: str | None, label: str | None) -> bool:
    if family is not None and _base_name(name) != family:
        return False
    if label:
        key, sep, value = label.partition("=")
        needle = f'{key}="{value}"' if sep else label
        brace = name.partition("{")[2]
        if needle not in brace:
            return False
    return True


class TelemetryArchive:
    """Append-only archive of telemetry windows under one directory
    (usable bare, with no attached rings, through :meth:`append`)."""

    def __init__(self, root: Path, *, retain_mb: int | None = None,
                 retain_hours: float | None = None,
                 segment_bytes: int | None = None,
                 flush_s: float | None = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.retain_bytes = (retain_mb if retain_mb is not None
                             else telemetry_retain_mb()) << 20
        self.retain_s = (retain_hours if retain_hours is not None
                         else float(telemetry_retain_hours())) * 3600.0
        self.segment_bytes = (segment_bytes if segment_bytes is not None
                              else _default_segment_bytes())
        self.flush_s = flush_s if flush_s is not None else _flush_gap_s()
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._active: Path | None = None
        self._sources: dict[str, metrics.Telemetry] = {}
        self._prev: dict[str, dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.records_written = 0
        self.segments_evicted = 0

    # ------------------------------------------------------------ write
    def _next_segment(self) -> Path:
        self._seq += 1
        # seq zero-padded so the (start_ms, name) sort stays correct
        # when many segments share one wall-clock millisecond
        name = (f"{_SEGMENT_PREFIX}{int(self._clock() * 1000):013d}"
                f"-{os.getpid()}-{self._seq:06d}{_SEGMENT_SUFFIX}")
        return self.root / name

    def append(self, record: dict[str, Any]) -> None:
        """Append one record as a complete gzip member (crash-safe unit)."""
        member = gzip.compress(
            (json.dumps(record, separators=(",", ":")) + "\n").encode())
        with self._lock:
            if (self._active is None
                    or not self._active.exists()
                    or self._active.stat().st_size + len(member)
                    > self.segment_bytes):
                self._active = self._next_segment()
                self._enforce_retention_locked()
            with open(self._active, "ab") as f:  # demodel: allow(no-blocking-io-under-lock) — the writer lock IS the file-handle serializer: rotation picks the segment and the append lands in it atomically; contention is one flusher thread plus a rare endpoint flush_once
                f.write(member)
            self.records_written += 1
        metrics.HUB.inc("telemetry_archive_records_total")

    def _enforce_retention_locked(self) -> None:
        """Evict oldest closed segments past the byte/age budgets."""
        segments = self.segments()
        now = self._clock()
        total = 0
        sizes: dict[Path, int] = {}
        for seg in segments:
            try:
                sizes[seg] = seg.stat().st_size
                total += sizes[seg]
            except OSError:
                sizes[seg] = 0
        for seg in segments:
            if seg == self._active:
                continue  # never evict the segment being written
            over_bytes = total > self.retain_bytes
            try:
                over_age = (now - seg.stat().st_mtime) > self.retain_s
            except OSError:
                over_age = True
            if not (over_bytes or over_age):
                break  # oldest-first: the first keeper keeps the rest
            try:
                seg.unlink()
            except OSError:
                continue
            total -= sizes.get(seg, 0)
            self.segments_evicted += 1
            metrics.HUB.inc("telemetry_segments_evicted_total")

    # ---------------------------------------------------------- flusher
    def attach(self, name: str, telemetry: metrics.Telemetry) -> None:
        """Register a telemetry ring whose windows this archive persists."""
        with self._lock:
            self._sources[name] = telemetry

    def attach_native(self, proxy: Any) -> None:
        """Attach the native mirror once (later calls are no-ops)."""
        with self._lock:
            if "native" in self._sources:
                return
        self.attach("native", metrics.native_telemetry(proxy))

    def flush_once(self) -> int:
        """Sample every attached ring once; append a window record per
        ring that produced a NEW snapshot since the last flush. Returns
        how many records were appended."""
        with self._lock:
            sources = dict(self._sources)
        pending: list[dict[str, Any]] = []
        for name, tel in sources.items():
            try:
                tel.freshen()
                cur = tel.latest()
            except Exception:
                log.exception("telemetry flush failed for %s", name)
                continue
            if cur is None:
                continue
            with self._lock:
                prev = self._prev.get(name)
                self._prev[name] = cur
            if prev is None or cur["ts"] <= prev["ts"]:
                continue  # first sighting is the baseline, not a window
            rec = _window_record(name, prev, cur)
            if rec is not None:
                pending.append(rec)
        # the profiler plane rides the same flush cadence: drain any
        # rolled profile windows into the archive (sys.modules peek — the
        # flusher must not be the thing that imports, let alone starts,
        # the sampler). kind="profile" records carry no counters/gauges/
        # hists keys, so history() skips them by design; profiles() reads
        # them back.
        import sys as _sys

        prof = _sys.modules.get("demodel_tpu_torch.utils.profiler")
        if prof is not None:
            try:
                pending.extend(prof.drain_windows())
            except Exception:
                log.exception("profile window drain failed")
        for rec in pending:
            self.append(rec)
        return len(pending)

    def start(self) -> "TelemetryArchive":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="telemetry-archive", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.flush_s):
            try:
                self.flush_once()
            except Exception:
                log.exception("telemetry archive flush crashed")

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)

    def close(self) -> None:
        self.stop()
        try:
            self.flush_once()
        except Exception:
            log.exception("final telemetry flush failed")

    # ------------------------------------------------------------- read
    def segments(self) -> list[Path]:
        """All segments, oldest first (wall-clock start, then pid/seq)."""
        try:
            found = [p for p in self.root.iterdir()
                     if p.name.startswith(_SEGMENT_PREFIX)
                     and p.name.endswith(_SEGMENT_SUFFIX)]
        except OSError:
            return []
        return sorted(found, key=lambda p: (_segment_start_ms(p), p.name))

    def records(self) -> list[dict[str, Any]]:
        """Every decodable record across all segments, in segment order."""
        out: list[dict[str, Any]] = []
        for seg in self.segments():
            out.extend(read_segment(seg))
        return out

    def history(self, family: str | None = None, label: str | None = None,
                since: float | None = None,
                until: float | None = None) -> dict[str, Any]:
        """Reconstruct per-series history from the archived windows.

        Counter families come back as ``{"ts", "rate", "delta"}`` points,
        gauges as ``{"ts", "value"}``, histograms as ``{"ts", "count",
        "rate", "p50", "p99"}`` — one point per archived window, spanning
        every incarnation whose segments survived retention.
        """
        series: dict[str, list[dict[str, Any]]] = {}
        pids: set[int] = set()
        matched = 0
        segs = self.segments()
        for rec in self.records():
            ts = rec.get("ts")
            if not isinstance(ts, (int, float)) or not any(
                    k in rec for k in ("counters", "gauges", "hists")):
                continue  # not a window record (e.g. a shipped fleet tick)
            if (since is not None and ts < since) \
                    or (until is not None and ts > until):
                continue
            elapsed = float(rec.get("elapsed_s") or 0.0)
            matched += 1
            if isinstance(rec.get("pid"), int):
                pids.add(rec["pid"])
            for name, delta in (rec.get("counters") or {}).items():
                if not _matches(name, family, label):
                    continue
                point: dict[str, Any] = {"ts": ts, "delta": delta}
                if elapsed > 0:
                    point["rate"] = round(float(delta) / elapsed, 6)
                series.setdefault(name, []).append(point)
            for name, value in (rec.get("gauges") or {}).items():
                if _matches(name, family, label):
                    series.setdefault(name, []).append(
                        {"ts": ts, "value": value})
            for name, h in (rec.get("hists") or {}).items():
                if not _matches(name, family, label):
                    continue
                le = tuple(float(b) for b in h.get("le", ()))
                counts = tuple(int(c) for c in h.get("counts", ()))
                count = sum(counts)
                point = {"ts": ts, "count": count}
                if elapsed > 0:
                    point["rate"] = round(count / elapsed, 6)
                if count:
                    point["p50"] = metrics.hist_quantile(le, counts, 0.5)
                    point["p99"] = metrics.hist_quantile(le, counts, 0.99)
                series.setdefault(name, []).append(point)
        return {
            "history": 1,
            "archive": str(self.root),
            "segments": len(segs),
            "records": matched,
            "incarnations": len(pids),
            "series": series,
        }

    def profiles(self, since: float | None = None,
                 until: float | None = None,
                 plane: str | None = None) -> list[dict[str, Any]]:
        """The archived profile windows (``kind="profile"`` records the
        flusher drained from the sampler), in segment order — spanning
        every incarnation whose segments survived retention, same as
        :meth:`history`. These records carry ``stacks`` instead of
        counters/gauges/hists, so :meth:`history` skips them and this is
        their dedicated reader."""
        out: list[dict[str, Any]] = []
        for rec in self.records():
            if rec.get("kind") != "profile":
                continue
            ts = rec.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            if (since is not None and ts < since) \
                    or (until is not None and ts > until):
                continue
            if plane is not None and rec.get("plane") != plane:
                continue
            out.append(rec)
        return out

    def describe(self) -> dict[str, Any]:
        segs = self.segments()
        total = 0
        for seg in segs:
            try:
                total += seg.stat().st_size
            except OSError:
                pass
        with self._lock:
            written = self.records_written
            evicted = self.segments_evicted
            sources = sorted(self._sources)
        return {
            "archive": str(self.root),
            "segments": len(segs),
            "bytes": total,
            "retain_bytes": self.retain_bytes,
            "retain_s": self.retain_s,
            "records_written": written,
            "segments_evicted": evicted,
            "sources": sources,
        }


def _window_record(source: str, prev: dict[str, Any],
                   cur: dict[str, Any]) -> dict[str, Any] | None:
    """One compact on-disk record for the window ``prev → cur``.

    Reset-safe the same way the ring's windowed views are: a counter or
    bucket that shrank (process restart behind a stable name) treats the
    old value as zero rather than producing a negative delta.
    """
    elapsed = float(cur["ts"]) - float(prev["ts"])
    if elapsed <= 0:
        return None
    counters: dict[str, float] = {}
    for name, value in cur["counters"].items():
        if name in _SELF_FAMILIES:
            continue
        old = float(prev["counters"].get(name, 0.0))
        if float(value) < old:
            old = 0.0
        delta = float(value) - old
        if delta:
            counters[name] = round(delta, 6)
    hists: dict[str, dict[str, Any]] = {}
    for name, (le, counts, hsum) in cur["hists"].items():
        old_h = prev["hists"].get(name)
        if (old_h is None or len(old_h[1]) != len(counts)
                or any(int(n) < int(o)
                       for n, o in zip(counts, old_h[1]))):
            old_counts: tuple[int, ...] = (0,) * len(counts)
            old_sum = 0.0
        else:
            old_counts, old_sum = tuple(old_h[1]), float(old_h[2])
        deltas = [int(n) - int(o) for n, o in zip(counts, old_counts)]
        if sum(deltas):
            hists[name] = {
                "le": list(le),
                "counts": deltas,
                "sum": round(max(0.0, float(hsum) - old_sum), 6),
            }
    rec: dict[str, Any] = {
        "ts": cur["wall"],
        "elapsed_s": round(elapsed, 3),
        "source": source,
        "pid": os.getpid(),
    }
    # gauges are last-value: record only CHANGES, so a steady gauge does
    # not keep every otherwise-quiet window alive on disk
    gauges = {name: value for name, value in cur["gauges"].items()
              if prev["gauges"].get(name) != value}
    if counters:
        rec["counters"] = counters
    if gauges:
        rec["gauges"] = gauges
    if hists:
        rec["hists"] = hists
    if len(rec) == 4:
        return None  # quiet window — nothing moved, nothing to keep
    return rec


# ------------------------------------------------------------- registry
_registry_lock = threading.Lock()
_archive: TelemetryArchive | None = None


def current() -> TelemetryArchive | None:
    """The process archive, if :func:`ensure` started one (the history
    endpoint's sys.modules peek lands here)."""
    with _registry_lock:
        return _archive


def ensure(proxy: Any | None = None) -> TelemetryArchive | None:
    """Idempotently start the process archive from
    ``DEMODEL_TELEMETRY_ARCHIVE`` (None — and no side effects — when the
    knob is unset). Attaches the hub ring always and the native mirror
    when ``proxy`` is given; a later call with a proxy upgrades an
    archive started without one."""
    global _archive
    root = telemetry_archive_dir()
    if not root:
        with _registry_lock:
            return _archive
    with _registry_lock:
        if _archive is None or str(_archive.root) != str(Path(root)):
            _archive = TelemetryArchive(Path(root))
            _archive.attach("hub", metrics.HUB.telemetry())
            _archive.start()  # demodel: allow(no-blocking-io-under-lock) — start() only spawns the daemon flusher; the open() the chain reaches runs on THAT thread under the archive's own lock, not under _registry_lock
        archive = _archive
    if proxy is not None:
        archive.attach_native(proxy)
    return archive


def _reset_for_tests() -> None:
    """Stop and forget the process archive (test isolation only)."""
    global _archive
    with _registry_lock:
        archive, _archive = _archive, None
    if archive is not None:
        archive.stop()
