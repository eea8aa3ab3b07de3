"""Port parity: ``demodel_tpu_torch.utils.retention`` against
``demodel_tpu.utils.retention`` on the CPU.

The same scripted telemetry source (a fixed sequence of counter,
gauge and histogram scrapes on an injected clock) flushed by each
package's ``TelemetryArchive``: the segments are the same gzip members
(up to each member's mtime field) under the same names, and each
package reads the other's archive into equal series. Then the
archive's own rules, held on both packages: a truncated tail member is
tolerated, segments rotate and are evicted within the byte and age
budgets, and a second archive instance (a restarted node) continues
the first's history.
"""

from __future__ import annotations

import os
import time
import zlib

import pytest

from demodel_tpu.utils import metrics as jmetrics
from demodel_tpu.utils import retention as jret
from demodel_tpu_torch.utils import metrics as tmetrics
from demodel_tpu_torch.utils import retention as tret

PKGS = {"port": (tret, tmetrics), "reference": (jret, jmetrics)}
T0 = 1_700_000_000.0


def _scrape(step: int) -> dict:
    """The ``step``-th scrape of a source whose counter resets at step 4
    (a restarted process behind one name)."""
    n = step if step < 4 else step - 4
    return {
        "counters": {"pulls_total": 3.0 * n,
                     'peer_retries_total{peer="http://a:1"}': float(n * n),
                     "quiet_total": 5.0},
        "gauges": {"sessions_active": float(step % 3), "steady": 1.0},
        "hists": {'stage_duration_seconds{span="window-read"}': {
            "le": list(tmetrics.BUCKET_BOUNDS),
            "counts": [n, 2 * n] + [0] * (len(tmetrics.BUCKET_BOUNDS) - 1),
            "sum": 0.25 * n}},
    }


def _archive(mod, root, **kw):
    kw.setdefault("retain_mb", 64)
    kw.setdefault("retain_hours", 72)
    kw.setdefault("flush_s", 3600.0)
    return mod.TelemetryArchive(root, **kw)


def _flush_steps(pkg: str, root, steps: int = 7):
    """Each package's archive over the scripted source, flushed once per
    step; the wall clock of every snapshot pinned so the records match."""
    ret, met = PKGS[pkg]
    clock = {"t": 0.0, "step": 0}
    tel = met.Telemetry(lambda: _scrape(clock["step"]), cap=16,
                        min_gap_s=0.0, clock=lambda: clock["t"])
    arch = _archive(ret, root, clock=lambda: T0)
    arch.attach("hub", tel)
    real = time.time
    try:
        for step in range(steps):
            clock["t"], clock["step"] = 2.0 * step, step
            met.time.time = lambda s=step: T0 + 2.0 * s  # the wall stamp
            arch.flush_once()
    finally:
        met.time.time = real
    return arch


@pytest.fixture()
def archives(tmp_path, monkeypatch):
    # the metrics modules share the stdlib ``time``; patch it through
    # monkeypatch so a failure cannot leak the pinned clock
    monkeypatch.setattr(time, "time", time.time)
    return {pkg: _flush_steps(pkg, tmp_path / pkg) for pkg in PKGS}


def _members(data: bytes) -> list[bytes]:
    """A segment split into its gzip members, each member's mtime field
    (bytes 4-8 of its header) zeroed."""
    out = []
    while data:
        d = zlib.decompressobj(wbits=31)
        d.decompress(data)
        assert d.eof
        n = len(data) - len(d.unused_data)
        out.append(data[:4] + b"\0\0\0\0" + data[8:n])
        data = data[n:]
    return out


def test_segments_are_the_reference_s_bytes(archives):
    segs = {pkg: a.segments() for pkg, a in archives.items()}
    assert [p.name for p in segs["port"]] == [p.name
                                              for p in segs["reference"]]
    assert segs["port"][0].name == (f"telemetry-{int(T0 * 1000):013d}-"
                                    f"{os.getpid()}-000001.jsonl.gz")
    for t, j in zip(segs["port"], segs["reference"]):
        assert _members(t.read_bytes()) == _members(j.read_bytes())
    recs = archives["port"].records()
    assert len(recs) == 6  # the first flush is the baseline
    # step 4's window (the counter reset) records no pulls_total delta
    assert "pulls_total" not in recs[3].get("counters", {})


@pytest.mark.parametrize("writer", list(PKGS))
@pytest.mark.parametrize("query", [
    {}, {"family": "pulls_total"},
    {"family": "peer_retries_total", "label": "peer=http://a:1"},
    {"family": "stage_duration_seconds", "label": "span=window-read"},
    {"family": "sessions_active"}, {"since": T0 + 5, "until": T0 + 9},
    {"family": "nothing_here"}])
def test_each_package_reads_the_other_s_archive(archives, writer, query):
    root = archives[writer].root
    got = {pkg: _archive(ret, root).history(**query)
           for pkg, (ret, _) in PKGS.items()}
    assert got["port"] == got["reference"]
    doc = got["port"]
    assert doc["history"] == 1 and doc["incarnations"] == 1
    if not query:
        assert set(doc["series"]) == {
            "pulls_total", 'peer_retries_total{peer="http://a:1"}',
            "sessions_active", 'stage_duration_seconds{span="window-read"}'}


def test_history_of_both_writers_is_equal(archives):
    got = [a.history() for a in archives.values()]
    for doc in got:
        doc.pop("archive")
    assert got[0] == got[1]
    points = got[0]["series"]["pulls_total"]
    # the counter reset at step 4 reads as a fresh start, never negative
    assert [p["delta"] for p in points] == [3.0, 3.0, 3.0, 3.0, 3.0]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_truncated_tail_member_is_tolerated(tmp_path, pkg):
    ret, _ = PKGS[pkg]
    arch = _archive(ret, tmp_path / "a")
    for i in range(5):
        arch.append({"ts": float(i), "n": i})
    seg = arch.segments()[0]
    whole = seg.read_bytes()
    member = _members(whole)[-1]
    seg.write_bytes(whole[:-len(member) // 2])
    for mod, _ in PKGS.values():
        assert [r["n"] for r in mod.read_segment(seg)] == [0, 1, 2, 3]
    with open(seg, "ab") as f:
        f.write(b"\x1f\x8b\x08\x00GARBAGE")
    assert [r["n"] for r in ret.read_segment(seg)] == [0, 1, 2, 3]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_rotation_and_eviction_within_the_budgets(tmp_path, pkg):
    ret, _ = PKGS[pkg]
    arch = _archive(ret, tmp_path / "bytes", segment_bytes=256)
    arch.retain_bytes = 600
    for i in range(60):
        arch.append({"ts": float(i), "pad": "x" * 64, "n": i})
    assert len(arch.segments()) > 1 and arch.segments_evicted > 0
    total = sum(s.stat().st_size for s in arch.segments())
    assert total <= 600 + arch.segment_bytes + 256
    kept = [r["n"] for r in arch.records()]
    assert kept[-1] == 59 and kept == sorted(kept)

    aged = _archive(ret, tmp_path / "age", segment_bytes=128)
    aged.retain_s = 3600.0
    aged.append({"ts": 0.0, "pad": os.urandom(200).hex(), "n": 0})
    old = aged.segments()[0]
    stale = time.time() - 7200
    os.utime(old, (stale, stale))
    for i in range(1, 4):
        aged.append({"ts": float(i), "pad": os.urandom(200).hex(), "n": i})
    assert old not in aged.segments()
    assert [r["n"] for r in aged.records()] == [1, 2, 3]
    assert aged.describe()["segments_evicted"] == 1


@pytest.mark.parametrize("first,second", [("port", "reference"),
                                          ("reference", "port"),
                                          ("port", "port")])
def test_a_second_archive_continues_the_first(tmp_path, first, second):
    """A restarted node (a new archive instance, here of either package)
    appends beside its previous incarnation; history reads both."""
    root = tmp_path / "a"
    a = _archive(PKGS[first][0], root, clock=lambda: T0)
    a.append({"ts": T0, "elapsed_s": 1.0, "source": "hub", "pid": 1,
              "counters": {"pulls_total": 2.0}})
    b = _archive(PKGS[second][0], root, clock=lambda: T0 + 60)
    b.append({"ts": T0 + 60, "elapsed_s": 1.0, "source": "hub", "pid": 2,
              "counters": {"pulls_total": 4.0}})
    assert a.segments() == b.segments() and len(b.segments()) == 2
    for ret, _ in PKGS.values():
        doc = _archive(ret, root).history(family="pulls_total")
        assert doc["incarnations"] == 2 and doc["records"] == 2
        assert [p["delta"] for p in doc["series"]["pulls_total"]] == \
            [2.0, 4.0]


def test_ensure_follows_the_knob(tmp_path, monkeypatch):
    """``ensure`` is inert without ``DEMODEL_TELEMETRY_ARCHIVE`` and
    starts one process archive (with the hub attached) with it, as the
    reference's."""
    monkeypatch.delenv("DEMODEL_TELEMETRY_ARCHIVE", raising=False)
    tret._reset_for_tests()
    try:
        assert tret.ensure() is None and tret.current() is None
        monkeypatch.setenv("DEMODEL_TELEMETRY_ARCHIVE", str(tmp_path / "z"))
        arch = tret.ensure()
        assert arch is tret.ensure() is tret.current()
        assert arch.describe()["sources"] == ["hub"]
        assert sorted(arch.describe()) == sorted(
            _archive(jret, tmp_path / "j").describe())
    finally:
        tret._reset_for_tests()


@pytest.mark.parametrize("env", [{}, {"DEMODEL_TELEMETRY_RING": "32",
                                      "DEMODEL_TELEMETRY_MIN_GAP_MS": "40"},
                                 {"DEMODEL_TELEMETRY_RING": "1",
                                  "DEMODEL_TELEMETRY_MIN_GAP_MS": "x"}])
def test_telemetry_ring_knobs_equal_the_reference(monkeypatch, env):
    """The port's ring cap and min gap resolve as the reference's knobs
    (``DEMODEL_TELEMETRY_RING`` 360, ``DEMODEL_TELEMETRY_MIN_GAP_MS``
    250, clamped and degraded alike)."""
    for var in ("DEMODEL_TELEMETRY_RING", "DEMODEL_TELEMETRY_MIN_GAP_MS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    rings = [met.Telemetry(lambda: {}) for _, met in PKGS.values()]
    assert (rings[0].cap, rings[0].min_gap_s) == \
        (rings[1].cap, rings[1].min_gap_s)
    if not env:
        assert (rings[0].cap, rings[0].min_gap_s) == (360, 0.25)


@pytest.mark.parametrize("name", [
    "pulls_total", 'peer_retries_total{peer="http://a:1"}',
    'x{a="1",route="/peer/object/{key}",z="q\\"uote"}', "h{}"])
def test_parse_labels_equals_the_reference(name):
    assert tmetrics.parse_labels(name) == jmetrics.parse_labels(name)
