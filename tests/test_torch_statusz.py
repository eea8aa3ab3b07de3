"""Port parity: ``demodel_tpu_torch.utils.statusz`` against
``demodel_tpu.utils.statusz`` on the CPU.

Both documents carry schema v4 with the same sections and the same keys
in the sections whose shape is fixed; ``effective_config()`` is equal
under the same env; each data source the port grew for statusz (byte
budgets, tiers, gossip, storage counters) describes itself with the
reference's keys; and a port ``GenEngine`` on the CPU
(``LlamaConfig.tiny()``) fills the ``generation`` section with the
reference engine's ``describe`` keys, its running sequence visible
while it decodes. A scrape imports no ``torch``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from demodel_tpu import serve as jserve
from demodel_tpu import tier as jtier
from demodel_tpu.models import llama as jl
from demodel_tpu.parallel import peer as jpeer
from demodel_tpu.sink import streaming as jstreaming
from demodel_tpu.store import Store as JStore
from demodel_tpu.utils import statusz as jstatusz
from demodel_tpu.utils import trace as jtrace
from demodel_tpu_torch import serve as tserve
from demodel_tpu_torch import tier as ttier
from demodel_tpu_torch.models import convert
from demodel_tpu_torch.models import llama as tl
from demodel_tpu_torch.parallel import peer as tpeer
from demodel_tpu_torch.sink import streaming as tstreaming
from demodel_tpu_torch.store import Store as TStore
from demodel_tpu_torch.utils import statusz as tstatusz
from demodel_tpu_torch.utils import trace as ttrace

from .torch_refnative import reference_native_lib  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (ttrace, jtrace):
        mod.reset()
    yield
    for mod in (ttrace, jtrace):
        mod.reset()


def test_sections_and_schema_equal_the_reference():
    t, j = tstatusz.snapshot(), jstatusz.snapshot()
    assert t["statusz"] == j["statusz"] == tstatusz.SCHEMA_VERSION == 4
    assert sorted(t) == sorted(j)
    for section in ("trace", "telemetry"):
        assert sorted(t[section]) == sorted(j[section])
    extra = tstatusz.snapshot(extra={"server": "restore", "models": []})
    assert extra["server"] == "restore" and extra["models"] == []
    json.dumps(t)


CONFIG_ENVS = {
    "defaults": {},
    "pinned": {"DEMODEL_PEER_STREAMS": "3", "DEMODEL_PULL_WINDOW_MB": "16",
               "DEMODEL_SINK_PREFETCH": "2", "DEMODEL_GEN_BLOCK": "32",
               "DEMODEL_TELEMETRY_ARCHIVE": "/var/lib/demodel/telemetry",
               "DEMODEL_PROFILE_HZ": "97", "DEMODEL_RETRY_DEADLINE": "30"},
    "malformed": {"DEMODEL_PEER_STREAMS": "many", "DEMODEL_GEN_KV_MB": "-4",
                  "DEMODEL_TELEMETRY_RETAIN_MB": "0",
                  "DEMODEL_PROFILE_WINDOW_S": "1"},
}


@pytest.mark.parametrize("env", list(CONFIG_ENVS))
def test_effective_config_equals_the_reference(monkeypatch, env):
    for var in set().union(*CONFIG_ENVS.values()):
        monkeypatch.delenv(var, raising=False)
    for var, value in CONFIG_ENVS[env].items():
        monkeypatch.setenv(var, value)
    got = tstatusz.effective_config()
    assert got == jstatusz.effective_config()
    for var in CONFIG_ENVS[env]:
        assert got[var]["source"] == "env"


def test_data_sources_describe_with_the_reference_keys(tmp_path):
    tb = tstreaming.ByteBudget(1 << 20, name="smoke-budget")
    jb = jstreaming.ByteBudget(1 << 20, name="smoke-budget")
    for b in (tb, jb):
        b.acquire(4096)
    rows = {"port": tstreaming.budgets_snapshot(),
            "reference": jstreaming.budgets_snapshot()}
    mine = [[r for r in v if r["name"] == "smoke-budget"] for v in
            rows.values()]
    assert mine[0] == mine[1] and mine[0][0]["in_use_bytes"] == 4096
    with TStore(tmp_path / "t") as ts, JStore(tmp_path / "j") as js:
        tt, jt = ttier.shared(ts), jtier.shared(js)
        assert (tt.name, jt.name) == ("tier:t", "tier:j")
        td, jd = tt.describe(), jt.describe()
        assert sorted(td) == sorted(jd)
        assert [sorted(r) for r in td["tiers"]] == \
            [sorted(r) for r in jd["tiers"]]
        assert sorted(td["singleflight"]) == sorted(jd["singleflight"])
        assert td["storage"] == jd["storage"]
        assert ts.storage_stats() == js.storage_stats()
        assert any(r["name"] == "tier:t" for r in ttier.tiers_snapshot())
        doc = tstatusz.snapshot()
        assert any(r["name"] == "tier:t" for r in doc["tiers"])
        assert any(r["name"] == "tier:t" for r in doc["storage"]["tiers"])
    assert ts.storage_stats() == {}  # closed: nothing read natively
    gossip = {}
    for name, mod in (("port", tpeer), ("reference", jpeer)):
        g = mod.PeerGossip()
        g.observe("http://a:1", {"k1", "k2"}, True)
        g.observe("http://b:2", None, False)
        d = g.describe()
        for row in d.values():
            row.pop("age_sec")
        gossip[name] = d
    assert gossip["port"] == gossip["reference"]


def test_gossip_section_never_creates_the_shared_instance():
    tpeer.PeerGossip.reset_shared()
    assert tstatusz.snapshot()["gossip"] == {}
    assert tpeer.PeerGossip._shared is None


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jax.jit(jl.init_params, static_argnums=(1,))(
        jax.random.key(2), jcfg)
    tcfg = tl.LlamaConfig.tiny()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


def test_generation_section_from_a_port_engine(tiny):
    """A port engine on the CPU, installed as the process's engine: while
    a request decodes, the section shows it running with KV blocks in
    use, under the reference engine's keys."""
    jparams, jcfg, tparams, tcfg = tiny
    jeng = jserve.GenEngine(jparams, jcfg, max_batch=2, kv_mb=1,
                            max_new_tokens=8)
    want = jeng.describe()
    tserve.install(None)
    assert tstatusz.snapshot()["generation"] == {}
    engine = tserve.boot(tparams, tcfg, device="cpu", max_batch=2, kv_mb=1,
                         max_new_tokens=64)
    seen = []
    try:
        req = engine.submit(list(range(1, 9)), 64)
        for _ in req.iter_tokens(timeout=60):
            if not seen:
                seen.append(tstatusz.snapshot()["generation"])
        req.result(60)
        after = tstatusz.snapshot()["generation"]
    finally:
        engine.stop()
        tserve.install(None)
    running = seen[0]
    assert sorted(running) == sorted(want)
    assert sorted(running["kv"]) == sorted(want["kv"])
    assert sorted(running["admission"]) == sorted(want["admission"])
    assert running["running"] == 1 and running["kv"]["in_use_blocks"] > 0
    assert after["running"] == 0 and after["kv"]["in_use_blocks"] == 0
    assert tstatusz.snapshot()["generation"] == {}


def test_a_scrape_imports_no_torch():
    code = ("import sys, json\n"
            "from demodel_tpu_torch.utils import statusz\n"
            "doc = statusz.snapshot()\n"
            "print(json.dumps({'torch': 'torch' in sys.modules,\n"
            "                  'keys': sorted(doc)}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert not got["torch"] and got["keys"] == sorted(jstatusz.snapshot())


def test_inflight_section_shows_an_open_span():
    inside, release = threading.Event(), threading.Event()

    def worker():
        with ttrace.span("serve.restore", path="/generate"):
            inside.set()
            release.wait(10)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert inside.wait(10)
        doc = tstatusz.snapshot()
    finally:
        release.set()
        t.join()
    assert [s["name"] for s in doc["inflight_spans"]] == ["serve.restore"]
    assert doc["trace"]["mode"] == "observe"
