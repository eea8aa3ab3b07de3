"""Port parity: ``demodel_tpu_torch.utils.trace`` against
``demodel_tpu.utils.trace`` on the CPU.

The same inputs through both packages: the W3C ``traceparent`` cases of
``tests/test_trace.py`` (and more), header injection under the same
ambient span (span ids come from the ``random`` module, seeded alike
before each package draws), ``nest_spans`` and ``chrome_events`` over
one seeded list of flat records, the tier each package reports under
the same env, the flight recorder's cap and drop count, the recorder
dump's document, and the JSONL sink's records. The port's no-op span
(``DEMODEL_OBS=0``) allocates nothing.
"""

from __future__ import annotations

import json
import random
import threading
import tracemalloc

import numpy as np
import pytest

from demodel_tpu.utils import trace as jtrace
from demodel_tpu_torch.utils import trace as ttrace

PKGS = {"port": ttrace, "reference": jtrace}
_ENV = ("DEMODEL_TRACE", "DEMODEL_TRACE_BUFFER", "DEMODEL_TRACE_SAMPLE",
        "DEMODEL_OBS", "DEMODEL_RECORDER_CAP", "DEMODEL_RECORDER_AUTODUMP")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    # set empty (which both packages read as unset) rather than deleted,
    # so teardown also undoes what ``enable(path)`` writes to os.environ
    for var in _ENV:
        monkeypatch.setenv(var, "")
    monkeypatch.setenv("DEMODEL_RECORDER_DIR", str(tmp_path))
    for mod in PKGS.values():
        mod.reset()
    yield
    for mod in PKGS.values():
        mod.reset()


def _reset_both() -> None:
    for mod in PKGS.values():
        mod.reset()


# --------------------------------------------------------- traceparent

_T = "4bf92f3577b34da6a3ce929d0e0e4736"
_S = "00f067aa0ba902b7"
HEADERS = {
    "valid": f"00-{_T}-{_S}-01",
    "unsampled-flag": f"00-{_T}-{_S}-00",
    "upper-hex": f"00-{_T.upper()}-{_S.upper()}-01",
    "padded": f"  00-{_T}-{_S}-01 \n",
    "extra-field": f"00-{_T}-{_S}-01-extra",
    "other-version": f"ff-{_T}-{_S}-01",
    "empty": "",
    "junk": "junk",
    "short": "00-short-ffff-01",
    "zero-ids": "xx-" + "0" * 32 + "-" + "0" * 16 + "-01",
    "zero-trace": f"00-{'0' * 32}-{_S}-01",
    "zero-span": f"00-{_T}-{'0' * 16}-01",
    "non-hex": "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "three-fields": f"00-{_T}-{_S}",
    "long-trace": f"00-{_T}0-{_S}-01",
    "long-span": f"00-{_T}-{_S}0-01",
}


@pytest.mark.parametrize("case", list(HEADERS))
def test_parse_traceparent_equals_the_reference(case):
    value = HEADERS[case]
    assert ttrace.parse_traceparent(value) == jtrace.parse_traceparent(value)


def _under_span(mod, seed: int, fn, remote_parent: str | None = None):
    """``fn()`` inside a span of ``mod`` whose ids were drawn after
    ``random.seed(seed)``."""
    random.seed(seed)
    with mod.span("origin", remote_parent=remote_parent):
        return fn()


@pytest.mark.parametrize("headers", [None, {}, {"Range": "bytes=0-1"},
                                     {"traceparent": "caller-set"}])
def test_traceparent_and_inject_headers_equal_the_reference(headers):
    got = {}
    for name, mod in PKGS.items():
        got[name] = _under_span(mod, 7, lambda m=mod: (
            m.traceparent(), m.inject_headers(
                None if headers is None else dict(headers))))
        assert mod.traceparent() is None
        assert mod.inject_headers(headers) is headers  # no ambient span
    assert got["port"] == got["reference"]
    tp, out = got["port"]
    assert ttrace.parse_traceparent(tp) is not None
    assert out["traceparent"] == (headers or {}).get("traceparent", tp)


@pytest.mark.parametrize("case", ["valid", "upper-hex", "junk", "zero-span"])
def test_remote_parent_keeps_the_trace_id(case):
    value = HEADERS[case]
    parsed = jtrace.parse_traceparent(value)
    seen = {}
    for name, mod in PKGS.items():
        random.seed(3)
        with mod.span("server-side", remote_parent=value) as sp:
            seen[name] = (sp.trace_id, sp.parent_id, sp.span_id)
    assert seen["port"] == seen["reference"]
    if parsed is not None:
        assert seen["port"][:2] == parsed
    else:  # malformed: a fresh local root
        assert seen["port"][1] is None


# ------------------------------------------------ nesting and Chrome


def _flat_records(seed: int, n: int = 40) -> list[dict]:
    """Seeded finished-span records: a forest with remote parents, spans
    whose parent finished elsewhere, events, attrs and errors."""
    rng = np.random.default_rng(seed)
    ids = [f"{int(x):016x}" for x in rng.integers(1, 2 ** 62, n)]
    out = []
    for i, sid in enumerate(ids):
        kind = rng.integers(0, 4)
        parent = (None if kind == 0 else
                  ids[int(rng.integers(0, i))] if kind == 1 and i else
                  f"{int(rng.integers(1, 2 ** 62)):016x}")
        rec = {"trace": f"{int(rng.integers(1, 2 ** 62)):032x}",
               "span": sid, "parent": parent, "name": f"s{i % 5}",
               "ts": 1.7e9 + float(rng.random()) * 100,
               "dur": float(rng.random()), "pid": 1000 + i % 3,
               "tid": int(rng.integers(0, 2)) * (i + 1), "status": "ok"}
        if i % 4 == 0:
            rec["attrs"] = {"bytes": int(rng.integers(0, 1 << 20))}
        if i % 6 == 0:
            rec["events"] = [{"t": float(rng.random()), "name": "retry",
                              "attrs": {"attempt": 1}},
                             {"t": float(rng.random()), "name": "done"}]
        if i % 9 == 0:
            rec["status"], rec["error"] = "error", "OSError: boom"
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nest_spans_and_chrome_events_equal_the_reference(seed):
    recs = _flat_records(seed)
    assert ttrace.nest_spans(recs) == jtrace.nest_spans(recs)
    assert ttrace.chrome_events(recs) == jtrace.chrome_events(recs)


def test_dump_chrome_equals_the_reference(tmp_path):
    recs = _flat_records(5)
    for name, mod in PKGS.items():
        n = mod.dump_chrome(str(tmp_path / f"{name}.json"), recs)
        assert n == len(jtrace.chrome_events(recs))
    docs = [json.loads((tmp_path / f"{n}.json").read_text()) for n in PKGS]
    assert docs[0] == docs[1]
    assert sum(e["ph"] == "X" for e in docs[0]["traceEvents"]) == len(recs)


# ---------------------------------------------------------------- tiers


@pytest.mark.parametrize("env", ["default", "obs-off", "trace-file",
                                 "trace-and-obs-off"])
def test_mode_equals_the_reference(env, monkeypatch, tmp_path):
    if env in ("obs-off", "trace-and-obs-off"):
        monkeypatch.setenv("DEMODEL_OBS", "0")
    if env in ("trace-file", "trace-and-obs-off"):
        monkeypatch.setenv("DEMODEL_TRACE", str(tmp_path / "t.jsonl"))
    _reset_both()
    got = {name: (mod.mode(), mod.enabled(), mod.active())
           for name, mod in PKGS.items()}
    assert got["port"] == got["reference"]
    assert got["port"][0] == {"default": "observe", "obs-off": "off",
                              "trace-file": "export",
                              "trace-and-obs-off": "export"}[env]


def test_enable_forces_export_and_reset_clears_it():
    for mod in PKGS.values():
        mod.enable()
    assert ttrace.mode() == jtrace.mode() == "export"
    _reset_both()
    assert ttrace.mode() == jtrace.mode() == "observe"


def test_noop_span_allocates_nothing(monkeypatch):
    """Under ``DEMODEL_OBS=0`` ``span()`` returns the shared no-op after
    one global check: no allocation in the trace module, no clock read,
    no in-flight entry."""
    monkeypatch.setenv("DEMODEL_OBS", "0")
    ttrace.reset()
    assert ttrace.span("x", k=1) is ttrace.NOOP
    assert ttrace.wrap(len) is len
    for _ in range(100):  # warm every code path first
        with ttrace.span("hot", k=1) as sp:
            sp.set_attr("a", 1)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with ttrace.span("hot", k=1) as sp:
                sp.set_attr("a", 1)
                sp.event("e")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only_trace = [tracemalloc.Filter(True, ttrace.__file__)]
    grown = after.filter_traces(only_trace).compare_to(
        before.filter_traces(only_trace), "lineno")
    assert sum(s.size_diff for s in grown) <= 0, grown[:5]
    assert ttrace.inflight() == [] and ttrace.traceparent() is None


# ------------------------------------------------ recorder and in-flight


def test_recorder_cap_and_dropped_equal_the_reference(monkeypatch):
    monkeypatch.setenv("DEMODEL_RECORDER_CAP", "16")
    _reset_both()
    for mod in PKGS.values():
        for i in range(100):
            with mod.span("filler", i=i):
                pass
    rec = {name: mod.recorder() for name, mod in PKGS.items()}
    assert (rec["port"].cap, len(rec["port"]), rec["port"].dropped) == (
        rec["reference"].cap, len(rec["reference"]),
        rec["reference"].dropped) == (16, 16, 84)
    assert [r["attrs"]["i"] for r in rec["port"].snapshot()] == \
        list(range(84, 100))
    assert len(ttrace.buffer()) == 0  # observe tier: nothing exported


def test_inflight_tree_and_dump_recorder_match_the_reference(tmp_path):
    """Open spans on two threads appear in the in-flight tree, and a
    recorder dump holds the same keys as the reference's."""
    docs = {}
    for name, mod in PKGS.items():
        inside, release = threading.Event(), threading.Event()

        def worker(m=mod, i=inside, r=release):
            with m.span("pull", model="m"):
                with m.span("window-read", offset=0):
                    i.set()
                    r.wait(10)

        t = threading.Thread(target=worker, name=f"w-{name}")
        t.start()
        assert inside.wait(10)
        with mod.span("done-before"):
            pass
        tree = mod.inflight_tree()
        path = mod.dump_recorder("smoke", str(tmp_path / f"{name}.json"))
        release.set()
        t.join()
        pulls = [r for r in tree if r["name"] == "pull"]
        assert len(pulls) == 1 and pulls[0]["thread"] == f"w-{name}"
        assert [c["name"] for c in pulls[0]["children"]] == ["window-read"]
        assert pulls[0]["children"][0]["attrs"] == {"offset": 0}
        docs[name] = json.loads(open(path).read())
    assert sorted(docs["port"]) == sorted(docs["reference"])
    for doc in docs.values():
        assert doc["kind"] == "demodel-flight-recorder"
        assert doc["reason"] == "smoke"
        assert [s["name"] for s in doc["spans"]] == ["done-before"]
        assert {s["name"] for s in doc["inflight"]} == {"pull",
                                                        "window-read"}
    assert ttrace._get_state().last_dump == str(tmp_path / "port.json")


def test_error_root_autodumps_as_the_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("DEMODEL_RECORDER_MIN_S", "0")
    dumps = []
    for name, mod in PKGS.items():
        monkeypatch.setenv("DEMODEL_RECORDER_DIR", str(tmp_path / name))
        (tmp_path / name).mkdir()
        mod.reset()
        with pytest.raises(OSError):
            with mod.span("pull"):
                with mod.span("child"):
                    pass
                raise OSError("boom")
        dumps += sorted((tmp_path / name).glob("demodel-flightrec-*.json"))
    assert len(dumps) == 2
    assert dumps[0].name == dumps[1].name  # pid and sequence number
    docs = [json.loads(p.read_text()) for p in dumps]
    assert docs[0]["reason"] == docs[1]["reason"] == "error-root:pull"
    assert [s["name"] for s in docs[0]["spans"]] == \
        [s["name"] for s in docs[1]["spans"]] == ["child", "pull"]
    assert docs[0]["spans"][1]["error"] == "OSError: boom"


# ------------------------------------------------------------- export


def test_jsonl_sink_records_equal_the_reference(tmp_path):
    keys = {}
    for name, mod in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        mod.reset()
        mod.enable(str(path))
        random.seed(11)
        with mod.span("pull", model="m") as sp:
            sp.event("retry", attempt=1)
            with mod.span("window-read", offset=0):
                pass
        mod.reset()
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        keys[name] = [(r["name"], r["trace"], r["span"], r["parent"],
                       sorted(r), r.get("attrs"), [e["name"] for e in
                                                   r.get("events", ())])
                      for r in lines]
    assert keys["port"] == keys["reference"]
    assert [k[0] for k in keys["port"]] == ["window-read", "pull"]
    assert keys["port"][0][3] == keys["port"][1][2]


def test_wrap_carries_the_parent_across_a_thread():
    ttrace.enable()
    out = {}
    with ttrace.span("parent") as sp:
        fn = ttrace.wrap(lambda: ttrace.traceparent())
    t = threading.Thread(target=lambda: out.setdefault("tp", fn()))
    t.start()
    t.join()
    assert ttrace.parse_traceparent(out["tp"]) == (sp.trace_id, sp.span_id)


def test_head_sampling_drops_whole_traces_as_the_reference(monkeypatch):
    monkeypatch.setenv("DEMODEL_TRACE_SAMPLE", "0")
    for mod in PKGS.values():
        mod.reset()
        mod.enable()
        with mod.span("root"):
            with mod.span("child"):
                assert mod.subtree_suppressed()
        with mod.span("served", remote_parent=HEADERS["valid"]):
            pass
    assert [r["name"] for r in ttrace.buffer().snapshot()] == \
        [r["name"] for r in jtrace.buffer().snapshot()] == ["served"]
    assert len(ttrace.recorder()) == len(jtrace.recorder()) == 3


# ------------------------------------------- across the streaming sink


def _sink(pkg: str, monkeypatch, delivered: list):
    """A streaming sink of ``pkg`` whose delivery only records the file."""
    if pkg == "port":
        from demodel_tpu_torch.parallel import make_mesh
        from demodel_tpu_torch.sink import streaming as mod
        from demodel_tpu_torch.sink.hbm import Placement
        kw = {"mesh": make_mesh(device="cpu")}
    else:
        from demodel_tpu.sink import streaming as mod
        from demodel_tpu.sink.hbm import Placement
        kw = {}

    def deliver(store, name, key, mesh, plan, cast_to, buffer=None,
                **_):
        delivered.append(name)
        return Placement(mesh_desc="fake")

    monkeypatch.setattr(mod, "deliver_file", deliver)
    return mod.StreamingSink(store=None, overlap=True, **kw)


class _Art:
    name = "model-00001-of-00002.safetensors"
    key = "k" * 16
    media_type = ""


@pytest.mark.parametrize("sample", ["1", "0"])
def test_sink_deliver_joins_the_submitter_s_trace(monkeypatch, sample):
    """``sink-deliver`` runs on the sink's worker thread under the
    submitting span (its traceparent crosses the queue), and a
    sampled-out pull leaks no ``sink-deliver`` root: in both packages."""
    monkeypatch.setenv("DEMODEL_TRACE_SAMPLE", sample)
    got = {}
    for name, mod in PKGS.items():
        mod.reset()
        mod.enable()
        delivered: list[str] = []
        sink = _sink(name, monkeypatch, delivered)
        with mod.span("pull") as root:
            sink.submit(_Art())
        sink.finish(block=False)
        assert delivered == [_Art.name]
        recs = [r for r in mod.buffer().snapshot()
                if r["name"] == "sink-deliver"]
        got[name] = [(r["trace"] == root.trace_id,
                      r["parent"] == root.span_id, r["attrs"])
                     for r in recs]
    assert got["port"] == got["reference"]
    assert got["port"] == ([(True, True, {"file": _Art.name, "bytes": 0,
                                          "tensors": 0})]
                           if sample == "1" else [])
