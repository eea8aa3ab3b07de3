"""Port parity: the adaptive pull tuner of ``demodel_tpu_torch``
(``sink/tuner``: ``PullTuner``, ``fetch_windows``) against
``demodel_tpu``'s on the CPU.

Each scenario of ``tests/test_tuner.py`` drives both packages' tuners
with the same scripted signals (the ``tick`` keyword seams, injected
clocks, or a scripted :class:`Telemetry` ring) and records the knob
state after every step: the two sequences must be equal, and each
scenario also holds the reference test's own expectation. The live
ones (a tick thread reading a charged budget) compare the decisions'
outcome, and the tuned fetch over a real peer runs the port's reader
against the port's proxy.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from demodel_tpu.sink import tuner as jtuner
from demodel_tpu.utils import faults as jfaults
from demodel_tpu.utils import metrics as jmetrics
from demodel_tpu.utils import trace as jtrace
from demodel_tpu_torch.sink import tuner as ttuner
from demodel_tpu_torch.utils import faults as tfaults
from demodel_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

PACKAGES = {"port": (ttuner, tmetrics), "reference": (jtuner, jmetrics)}
KNOBS = ("streams", "window_bytes", "prefetch_depth")


@pytest.fixture(autouse=True)
def _fresh_state():
    def reset():
        jtrace.reset()
        for mod in (tmetrics, jmetrics):
            mod.HUB.reset()
        for mod in (tfaults, jfaults):
            mod.PeerHealth.reset_shared()

    reset()
    yield
    reset()


def _tuner(mod, **kw):
    kw.setdefault("prefetch_depth", 2)
    kw.setdefault("tick_s", 0.01)
    kw.setdefault("window_s", 5)
    return mod.PullTuner(**kw)


def _quiet(**kw):
    return dict(retry_rate=0.0, breaker_open=False, budget_wait_share=0.0,
                **kw)


def _state(t) -> tuple:
    snap = t.snapshot()
    return tuple(snap[k] for k in KNOBS) + (snap["decisions"],)


class _Budget:
    def __init__(self, max_bytes: int, in_use: int):
        self.max_bytes = max_bytes
        self.in_use = in_use


# every scenario: (tuner module, metrics module) → the recorded states;
# each also asserts the reference test's expectation on its own tuner


def _additive_increase(mod, _m):
    t = _tuner(mod)
    start = _state(t)
    t.tick(thr=100.0, **_quiet())
    after = _state(t)
    assert sum(a != b for a, b in zip(start[:3], after[:3])) == 1
    return [start, after]


def _probe_reverts(mod, _m):
    t = _tuner(mod)
    out = [_state(t)]
    for thr in (1000.0, 600.0, 600.0):
        t.tick(thr=thr, **_quiet())
        out.append(_state(t))
    assert out[2][:3] == out[0][:3] == out[3][:3] != out[1][:3]
    return out


def _backoff(mod, _m):
    t = _tuner(mod)
    out = []
    for _ in range(6):
        t.tick(thr=100.0 + t.decisions, **_quiet())
        out.append(_state(t))
    up = t.snapshot()
    t.tick(thr=500.0, retry_rate=2.0, breaker_open=False,
           budget_wait_share=0.0)
    out.append(_state(t))
    assert t.streams <= max(1, up["streams"] // 2)
    assert t.window_bytes <= up["window_bytes"] // 2
    t2 = _tuner(mod, clock=lambda: time.monotonic() + 3600)
    t2.streams = 4
    t2.tick(thr=0.0, retry_rate=0.0, breaker_open=True,
            budget_wait_share=0.0)
    assert t2.streams == 2
    return out + [_state(t2)]


def _bounds(mod, _m):
    t = _tuner(mod)
    t.window_bytes = 48 << 20
    out = []
    for _ in range(200):
        t.tick(thr=1e9, **_quiet())
        out.append(_state(t))
    assert t.streams <= t.max_streams and t.window_bytes <= t.max_window
    assert t.prefetch_depth <= t.max_prefetch
    clock = {"t": 0.0}
    t2 = _tuner(mod, clock=lambda: clock["t"])
    for i in range(50):
        clock["t"] = float(i * 100)
        t2.tick(thr=0.0, retry_rate=9.0, breaker_open=False,
                budget_wait_share=0.0)
        out.append(_state(t2))
    assert (t2.streams, t2.window_bytes, t2.prefetch_depth) == \
        (1, t2.min_window, 1)
    return out


def _prefetch_zero(mod, _m):
    t = _tuner(mod, prefetch_depth=0)
    out = []
    for _ in range(20):
        t.tick(thr=100.0, **_quiet())
        out.append(_state(t))
    assert t.prefetch_depth == 0
    return out


def _live_probe_judged(mod, m):
    """The live path: a probe settles for ``judge_s``, then is judged over
    the post-raise interval only, and a raise that collapsed delivery
    reverts."""
    feed = {"pull_bytes_total": 0.0}
    clock = {"t": 0.0}
    tel = m.Telemetry(
        lambda: {"counters": dict(feed), "gauges": {}, "hists": {}},
        cap=256, min_gap_s=0.0, clock=lambda: clock["t"])
    t = mod.PullTuner(prefetch_depth=2, tick_s=0.5, window_s=30.0,
                      telemetry=tel, clock=lambda: clock["t"])
    out = []

    def advance(rate_bps):
        clock["t"] += t.tick_s
        feed["pull_bytes_total"] += rate_bps * t.tick_s
        t.tick()
        out.append(_state(t) + (t._probe is not None,))

    for _ in range(100):
        if t._probe is not None and t._probe_base > 0:
            break
        advance(100.0)
    knob, old = t._probe
    pending_since = t._probe_t
    while clock["t"] + t.tick_s < pending_since + t.judge_s:
        advance(10.0)
        assert t._probe is not None
    advance(10.0)
    advance(10.0)
    assert t._probe is None and getattr(t, knob) == old
    assert m.HUB.snapshot().get(
        'tuner_decisions_total{action="revert"}', 0) >= 1
    return out


def _budget_pressure(mod, m):
    t = _tuner(mod, prefetch_depth=4, budget=_Budget(1 << 30, 0))
    t.tick(thr=100.0, retry_rate=0.0, breaker_open=False,
           budget_wait_share=0.9)
    assert t.prefetch_depth == 3
    assert m.HUB.snapshot()['tuner_decisions_total{action="decrease"}'] == 1
    return [_state(t)]


def _headroom_gate(mod, _m):
    t = _tuner(mod, prefetch_depth=2, budget=_Budget(1 << 20, 1 << 20))
    t.streams = t.max_streams
    t.window_bytes = t.max_window
    out = []
    for _ in range(10):
        t.tick(thr=100.0, **_quiet(hbm_pressure=0.0))
        out.append(_state(t))
    assert t.prefetch_depth == 2
    return out


def _place_pressure(mod, m):
    t = _tuner(mod, prefetch_depth=4)
    t.tick(thr=100.0, **_quiet(place_p99=5.0))
    assert t.prefetch_depth == 3
    assert m.HUB.gauges()["tuner_place_p99"] == pytest.approx(5.0)
    return [_state(t)]


def _hbm_pressure(mod, m):
    t = _tuner(mod, prefetch_depth=3, budget=_Budget(1 << 30, 0))
    t.tick(thr=100.0, **_quiet(hbm_pressure=0.95))
    out = [_state(t)]
    assert t.prefetch_depth == 2
    assert m.HUB.gauges()["tuner_hbm_pressure"] == pytest.approx(0.95)
    t2 = _tuner(mod, prefetch_depth=1)
    t2.streams = t2.max_streams
    t2.window_bytes = t2.max_window
    for _ in range(10):
        t2.tick(thr=100.0, **_quiet(hbm_pressure=0.95))
        out.append(_state(t2))
    assert t2.prefetch_depth == 1
    return out


def _signals_from_telemetry(mod, m):
    """Unforced ticks read the live planes: the place-stage histogram
    feeds place_p99, the budget's charge feeds hbm_pressure."""
    t = _tuner(mod, prefetch_depth=2,
               budget=_Budget(1 << 20, (1 << 20) - 1024))
    tel = t._tel()
    tel.sample()
    m.HUB.observe(m.labeled("stage_duration_seconds", span="place"), 2.0)
    time.sleep(0.01)
    tel.sample()
    t.tick(retry_rate=0.0, breaker_open=False, budget_wait_share=0.0)
    g = m.HUB.gauges()
    assert g["tuner_place_p99"] > 1.0
    assert g["tuner_hbm_pressure"] == pytest.approx(1023 / 1024, rel=1e-3)
    assert t.prefetch_depth == 1
    return [_state(t), g["tuner_place_p99"], g["tuner_hbm_pressure"]]


def _budget_wait_share_from_spans(mod, m):
    """The budget-wait signal is the rate of
    ``trace_span_seconds_total{span="budget-wait"}``: seconds spent in
    that span per wall second."""
    clock = {"t": 0.0}
    feed: dict = {}
    tel = m.Telemetry(lambda: {"counters": dict(feed), "gauges": {},
                               "hists": {}},
                      cap=64, min_gap_s=0.0, clock=lambda: clock["t"])
    t = mod.PullTuner(prefetch_depth=3, tick_s=0.5, window_s=4.0,
                      telemetry=tel, clock=lambda: clock["t"])
    name = m.labeled("trace_span_seconds_total", span="budget-wait")
    out = []
    for _ in range(6):
        clock["t"] += 1.0
        feed[name] = feed.get(name, 0.0) + 0.8  # 80% of wall in the span
        t.tick(thr=100.0, retry_rate=0.0, breaker_open=False,
               place_p99=0.0, hbm_pressure=0.0)
        out.append(_state(t))
    assert t.prefetch_depth == 1
    return out


def _fetch_windows(mod, _m):
    class Reader:
        def __init__(self):
            self.calls = []
            self.streams = 99

        def pread_into(self, key, view, offset):
            self.calls.append((offset, view.nbytes))
            view[:] = b"\x07" * view.nbytes
            return view.nbytes

    t = _tuner(mod)
    t.window_bytes = 4096
    t.streams = 3
    r = Reader()
    buf = bytearray(10000)
    assert mod.fetch_windows(r, "k", buf, 100, t) == 10000
    assert bytes(buf) == b"\x07" * 10000 and r.streams == 3
    r2 = Reader()
    mod.fetch_windows(r2, "k", bytearray(10000), 0, None)
    assert r2.calls == [(0, 10000)] and r2.streams == 99
    return [r.calls, r2.calls]


SCENARIOS = {
    "additive_increase": _additive_increase,
    "probe_reverts": _probe_reverts,
    "backoff_on_retry_storm_and_breaker": _backoff,
    "knob_bounds": _bounds,
    "prefetch_zero_stays_zero": _prefetch_zero,
    "live_probe_judged_post_raise": _live_probe_judged,
    "budget_pressure_decreases_prefetch": _budget_pressure,
    "headroom_gates_prefetch_raise": _headroom_gate,
    "place_latency_sheds_prefetch": _place_pressure,
    "hbm_pressure_sheds_and_gates": _hbm_pressure,
    "device_signals_from_telemetry": _signals_from_telemetry,
    "budget_wait_share_from_spans": _budget_wait_share_from_spans,
    "fetch_windows_splits": _fetch_windows,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_knob_sequence_matches_reference(scenario):
    fn = SCENARIOS[scenario]
    got = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("value,want", [(None, True), ("0", False),
                                        ("off", False), ("1", True)])
def test_enabled_switch_matches_reference(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("DEMODEL_TUNER", raising=False)
    else:
        monkeypatch.setenv("DEMODEL_TUNER", value)
    assert ttuner.tuner_enabled() is jtuner.tuner_enabled() is want


def _run_live(mod, budget):
    """A tick thread over a charged budget until prefetch reaches its
    floor; (final knobs, decision reasons)."""
    t = _tuner(mod, prefetch_depth=3, budget=budget)
    reasons: list = []
    decide = t._decide

    def spy(action, knob, frm, to, reason):
        reasons.append((action, knob, reason.split(" ")[0]))
        decide(action, knob, frm, to, reason)

    t._decide = spy
    t.start()
    try:
        assert mod.current() is t
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and t.prefetch_depth > 1:
            time.sleep(0.02)
    finally:
        t.stop()
    assert mod.current() is None
    return t.prefetch_depth, reasons


def test_live_device_shed_matches_reference():
    """A live tick thread reading a fully charged budget sheds prefetch to
    its floor, never below, for the same reason in both packages; the
    gauges are on each hub."""
    got = {name: _run_live(mod, _Budget(1 << 20, 1 << 20))
           for name, (mod, _m) in PACKAGES.items()}
    for depth, reasons in got.values():
        assert depth == 1
        sheds = [r for r in reasons if r[1] == "prefetch_depth"]
        assert sheds[:2] == [("decrease", "prefetch_depth",
                              "hbm-pressure")] * 2
    for _mod, m in PACKAGES.values():
        g = m.HUB.gauges()
        assert {"tuner_streams", "tuner_window_bytes",
                "tuner_prefetch_depth", "tuner_throughput_bps"} <= set(g)


def test_snapshot_serializes_with_the_tick_thread():
    """``snapshot()`` reads under the lock the tick thread writes under."""
    t = _tuner(ttuner)
    done = threading.Event()
    out: dict = {}

    def read():
        out.update(t.snapshot())
        done.set()

    with t._knob_lock:
        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        assert not done.wait(0.2)
    assert done.wait(2.0)
    reader.join(timeout=2)
    assert out["streams"] == t.streams
    assert out["window_mb"] == out["window_bytes"] >> 20


def test_snapshot_is_decision_consistent_under_concurrent_ticks():
    t = _tuner(ttuner)
    t.min_streams = t.streams = 1
    t.max_streams = 2
    t.max_window = t.window_bytes
    t.max_prefetch = t.prefetch_depth
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            t.tick(thr=1000.0, **_quiet())
            t.tick(thr=1.0, **_quiet())

    w = threading.Thread(target=churn, daemon=True)
    w.start()
    try:
        for _ in range(400):
            snap = t.snapshot()
            assert snap["streams"] == 1 + (snap["decisions"] % 2), snap
    finally:
        stop.set()
        w.join(timeout=5)


def test_tuned_pull_over_real_peer(tmp_path, monkeypatch):
    """The port's copy of the reference's end-to-end case: a tuned
    windowed fetch off the port's proxy lands bytes-exact while the
    controller runs, and the telemetry records the pull rate and one
    ``window-read`` span a window.

    The reference's copy sets ``window_bytes`` after ``start()``, so the
    tick thread's first probe can read the old 32 MiB and write back
    64 MiB after it: one window, one span (its red under six workers).
    This copy pins the window's bounds before ``start()``, so no probe
    moves it and the fetch is exactly eight windows."""
    monkeypatch.setenv("DEMODEL_TUNER_TICK_MS", "50")
    from demodel_tpu_torch.config import ProxyConfig
    from demodel_tpu_torch.proxy import ProxyServer
    from demodel_tpu_torch.sink.remote import PeerBlobReader
    from demodel_tpu_torch.store import Store

    cfg = ProxyConfig(host="127.0.0.1", port=0, no_mitm=True,
                      cache_dir=tmp_path / "c", data_dir=tmp_path / "d")
    body = np.random.default_rng(3).bytes(2 << 20)
    with Store(cfg.cache_dir / "proxy") as store:
        store.put("tunedobj00000001", body,
                  {"content-type": "application/octet-stream"})
    hub = tmetrics.HUB
    with ProxyServer(cfg, session_threads=2) as node:
        t = ttuner.PullTuner(prefetch_depth=0, tick_s=0.05, window_s=2)
        t.window_bytes = t.min_window = t.max_window = 256 << 10
        t.start()
        try:
            reader = PeerBlobReader(node.url, "tunedobj00000001",
                                    len(body), streams=1)
            out = bytearray(len(body))
            ttuner.fetch_windows(reader, "tunedobj00000001", out, 0, t)
            reader.close()
            assert hashlib.sha256(out).digest() == \
                hashlib.sha256(body).digest()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and \
                    hub.get_gauge("tuner_throughput_bps") == 0:
                time.sleep(0.05)
        finally:
            t.stop()
    assert hub.get("pull_bytes_total") == len(body)
    h = hub.get_histogram(tmetrics.labeled("stage_duration_seconds",
                                           span="window-read"))
    assert h is not None and h.count == 8
    assert hub.get_gauge("tuner_throughput_bps") > 0


def test_tuned_pull_over_real_peer_free_bounds(tmp_path, monkeypatch):
    """The same pull with the window's bounds left free: the controller
    may move the window between windows while the fetch runs. Delivery
    stays bytes-exact, every window the fetch used lies within the
    tuner's bounds, and each one is exactly one ``window-read`` span."""
    monkeypatch.setenv("DEMODEL_TUNER_TICK_MS", "50")
    from demodel_tpu_torch.config import ProxyConfig
    from demodel_tpu_torch.proxy import ProxyServer
    from demodel_tpu_torch.sink.remote import PeerBlobReader
    from demodel_tpu_torch.store import Store

    class CountingReader(PeerBlobReader):
        """Records each window's length; a short pause per window lets
        the tick thread run during the fetch."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.windows: list[int] = []

        def pread_into(self, key, out, offset=0):
            self.windows.append(memoryview(out).nbytes)
            time.sleep(0.02)
            return super().pread_into(key, out, offset)

    cfg = ProxyConfig(host="127.0.0.1", port=0, no_mitm=True,
                      cache_dir=tmp_path / "c", data_dir=tmp_path / "d")
    body = np.random.default_rng(4).bytes(4 << 20)
    with Store(cfg.cache_dir / "proxy") as store:
        store.put("tunedobj00000002", body,
                  {"content-type": "application/octet-stream"})
    hub = tmetrics.HUB
    with ProxyServer(cfg, session_threads=2) as node:
        t = ttuner.PullTuner(prefetch_depth=0, tick_s=0.05, window_s=2)
        t.min_window = 128 << 10
        t.window_bytes = 256 << 10
        t.start()
        try:
            reader = CountingReader(node.url, "tunedobj00000002",
                                    len(body), streams=1)
            out = bytearray(len(body))
            ttuner.fetch_windows(reader, "tunedobj00000002", out, 0, t)
            reader.close()
        finally:
            t.stop()
    assert hashlib.sha256(out).digest() == hashlib.sha256(body).digest()
    assert sum(reader.windows) == len(body)
    # every window but the tail is a size the tuner held
    assert all(t.min_window <= w <= t.max_window
               for w in reader.windows[:-1]), reader.windows
    assert t.min_window <= t.window_bytes <= t.max_window
    assert hub.get("pull_bytes_total") == len(body)
    h = hub.get_histogram(tmetrics.labeled("stage_duration_seconds",
                                           span="window-read"))
    assert h is not None and h.count == len(reader.windows)
