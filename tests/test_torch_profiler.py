"""Port parity: ``demodel_tpu_torch.utils.profiler`` against
``demodel_tpu.utils.profiler`` on the CPU.

``collapse`` and the stack roll-up give the same text and entries on
the same aggregate; the port's sampler roots each sample at the
innermost live span of its thread and tells a busy thread (on-CPU) from
a parked one (wall only) by the per-thread CPU clock; two captures in
flight at once both see samples and neither consumes the other's (or
the archive window's) baseline; and under ``DEMODEL_OBS=0`` neither
package starts a profiler.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from demodel_tpu.utils import profiler as jprof
from demodel_tpu.utils import trace as jtrace
from demodel_tpu_torch.utils import profiler as tprof
from demodel_tpu_torch.utils import trace as ttrace

PKGS = {"port": (tprof, ttrace), "reference": (jprof, jtrace)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("DEMODEL_OBS", "")
    for prof, tr in PKGS.values():
        tr.reset()
        prof._reset_for_tests()
    yield
    for prof, tr in PKGS.values():
        prof._reset_for_tests()
        tr.reset()


def _aggregate(seed: int, n: int = 300) -> dict[str, list[int]]:
    """A seeded folded-stack aggregate (stack -> [wall, cpu])."""
    rng = np.random.default_rng(seed)
    spans = ["-", "serve.decode-step", "window-read", "budget-wait"]
    out = {}
    for i in range(n):
        depth = int(rng.integers(1, 6))
        stack = ";".join([spans[int(rng.integers(0, 4))]] + [
            f"mod{int(rng.integers(0, 5))}:fn{int(rng.integers(0, 9))}"
            for _ in range(depth)])
        wall = int(rng.integers(0, 50))
        out[stack] = [wall, int(rng.integers(0, wall + 1))]
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("top", [None, 5, 128])
def test_collapse_and_top_stacks_equal_the_reference(seed, top):
    agg = _aggregate(seed)
    rows = tprof._top_stacks(agg, top)
    assert rows == jprof._top_stacks(agg, top)
    doc = {"stacks": rows}
    assert tprof.collapse(doc) == jprof.collapse(doc)
    assert tprof.collapse({"stacks": []}) == jprof.collapse({}) == ""
    if top is not None:
        assert len(rows) == top + 1 and rows[-1]["stack"] == "(other)"


def test_fold_equals_the_reference():
    f = sys._getframe()
    assert tprof.Profiler._fold(f, "serve.prefill") == \
        jprof.Profiler._fold(f, "serve.prefill")
    assert tprof.Profiler._fold(f, None).startswith("-;")
    assert tprof.Profiler._fold(f, "a b;c").startswith("a_b,c;")
    assert tprof.Profiler._fold(f, None).endswith(
        "test_torch_profiler:test_fold_equals_the_reference")


def _busy(stop: threading.Event) -> None:
    with ttrace.span("x"):
        while not stop.is_set():
            sum(i * i for i in range(2000))


def _parked(stop: threading.Event) -> None:
    with ttrace.span("y"):
        stop.wait(10)


def test_busy_thread_is_on_cpu_and_parked_is_wall_only():
    p = tprof.Profiler(hz=100, max_stacks=512, window_s=3600)
    assert p._cpu_mode is not None, "no per-thread CPU clock"
    stop = threading.Event()
    threads = [threading.Thread(target=fn, args=(stop,))
               for fn in (_busy, _parked)]
    for t in threads:
        t.start()
    p.start()
    try:
        cap = p.capture(seconds=1.0)
    finally:
        stop.set()
        for t in threads:
            t.join()
        p.stop()
    by_root: dict[str, list[int]] = {}
    for s in cap["stacks"]:
        root = s["stack"].split(";", 1)[0]
        acc = by_root.setdefault(root, [0, 0])
        acc[0] += s["wall"]
        acc[1] += s["cpu"]
    assert by_root["x"][0] > 0 and by_root["x"][1] > 0
    assert by_root["y"][0] > 0 and by_root["y"][1] == 0
    assert any("_busy" in s["stack"] for s in cap["stacks"]
               if s["stack"].startswith("x;"))
    assert sorted(cap) == sorted(
        ["plane", "hz", "seconds", "samples", "cpu_mode", "stacks"])


def test_captures_do_not_consume_each_other():
    p = tprof.Profiler(hz=100, max_stacks=512, window_s=3600)
    stop = threading.Event()
    t = threading.Thread(target=_busy, args=(stop,))
    t.start()
    p.start()
    got = {}
    try:
        side = threading.Thread(
            target=lambda: got.setdefault("b", p.capture(seconds=0.6)))
        side.start()
        got["a"] = p.capture(seconds=0.4)
        side.join()
        got["cum"] = p.capture(seconds=0)
        p._roll_window(force=True)
    finally:
        stop.set()
        t.join()
        p.stop()
    assert got["a"]["samples"] > 0 and got["b"]["samples"] > 0
    assert got["cum"]["samples"] >= max(got["a"]["samples"],
                                        got["b"]["samples"])
    windows = p.drain_windows()
    assert len(windows) == 1 and windows[0]["samples"] >= \
        got["cum"]["samples"]
    assert sorted(windows[0]) == sorted(
        ["kind", "plane", "ts", "window_s", "hz", "samples", "dropped",
         "cpu_mode", "stacks"])


def test_stack_cap_folds_into_other():
    p = tprof.Profiler(hz=50, max_stacks=16, window_s=3600)
    agg: dict[str, list[int]] = {}
    dropped = sum(p._bump(agg, f"s{i}", i % 2 == 0) for i in range(40))
    assert dropped == 24 and len(agg) == 17
    assert agg["(other)"] == [24, 12]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_no_profiler_under_obs_off(monkeypatch, pkg):
    prof, tr = PKGS[pkg]
    monkeypatch.setenv("DEMODEL_OBS", "0")
    tr.reset()
    before = threading.active_count()
    assert prof.ensure() is None and prof.capture(0.1) is None
    assert prof.current() is None and prof.describe() is None
    assert threading.active_count() == before


def test_ensure_starts_one_sampler_and_describes_it():
    p = tprof.ensure()
    assert p is tprof.ensure() is tprof.current() and p.alive()
    d = tprof.describe()
    jp = jprof.Profiler(hz=19)
    assert sorted(d) == sorted(jp.describe())
    assert d["running"] and d["hz"] == 19
