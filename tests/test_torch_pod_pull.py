"""The pod pull over several ranks in the port: ``sink/remote.py``'s
``pull_manifest_to_hbm`` on gloo ranks against the JAX package's
single-process pull (the cases of ``tests/test_pod_delivery.py``, which
are ``slow`` there).

The warm peer is the port's ``ProxyServer`` (``no_mitm``) over a store
filled by the port's pull of the reference's pod repo
(``test_pod_delivery._build_pod_repo``: two tp-shardable matrices, a
bias, and a large tensor that a ``dp`` mesh replicates) from a fake Hub.
The reference places the same model off the same peer on its 8-device
mesh. Each gloo rank (``tests/torch_mesh_rig.py``) places its own shards
off the peer, with no store. Held: every rank's shard equals its slice
of the reference's array, over 2 and 4 ranks; each rank reads a strict
fraction of the weight bytes over the wire, and the ranks together each
byte about once; ``ici_complete`` on a ``dp`` mesh reads the replicated
tensor 1/N a rank and lands the same bytes as without it; a peer that
dies mid-window makes every rank raise ``OSError`` (none reports a
placement), and the pull then succeeds off a live peer on a new mesh.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from demodel_tpu_torch import delivery as tdelivery
from demodel_tpu_torch.config import ProxyConfig as TConfig
from demodel_tpu_torch.parallel import mesh as tmesh
from demodel_tpu_torch.proxy import ProxyServer as TProxy

from .chaoshttp import ChaosPeer, FaultPlan, FaultSpec
from .fake_registries import make_hf_handler
from .servers import FakeUpstream
from .test_pod_delivery import MODEL, _build_pod_repo
from .torch_mesh_rig import Ranks
from .torch_refnative import reference_native_lib  # noqa: F401

jremote = importlib.import_module("demodel_tpu.sink.remote")
jmesh = importlib.import_module("demodel_tpu.parallel.mesh")

torch.set_num_threads(1)

#: the workers' wire knobs: fast retries, so a dead peer fails in ms
PULL_ENV = {"DEMODEL_RETRY_BASE_MS": "20", "DEMODEL_RETRY_DEADLINE": "30",
            "DEMODEL_BREAKER_COOLDOWN": "1"}
#: a failed rank's siblings wait this long (s) in a collective it skipped
DEATH_TIMEOUT_S = 4


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("two"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    r = Ranks(4, tmp_path_factory.mktemp("four"))
    yield r
    r.close()


class _DyingPeer(ChaosPeer):
    """The warm peer until the first window of ``path`` of at least 64
    KiB: it cuts that window mid-body with an RST, and every request
    after it gets an RST too (a crashed host)."""

    def __init__(self, upstream: str, path: str):
        super().__init__(upstream, FaultPlan(FaultSpec(
            "reset-at-byte", path=path, at_byte=30000, min_body=1 << 16)))

    def _serve_traced(self, h, sp) -> None:
        super()._serve_traced(h, sp)
        if self.plan.fired("reset-at-byte"):
            self.dead = True


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """The port's proxy over a store holding the pod repo: (url, source
    tensors, their bytes, the weight files' bytes, their store keys in
    manifest order)."""
    files, tensors = _build_pod_repo()
    path = tmp_path_factory.mktemp("warm") / "cache"
    cfg = TConfig(host="127.0.0.1", port=0, no_mitm=True, cache_dir=path,
                  data_dir=path.parent / "data")
    mp = pytest.MonkeyPatch()
    mp.setenv("DEMODEL_FETCH_WORKERS", "2")
    mp.setenv("DEMODEL_PROXY_IDLE_TIMEOUT", "1")
    try:
        with FakeUpstream(handler=make_hf_handler({MODEL: files})) as up:
            report = tdelivery.pull(MODEL, cfg,
                                    endpoint=f"http://{up.authority}")
        keys = [f["key"] for f in report["files"]
                if f["name"].endswith(".safetensors")]
        with TProxy(cfg, session_threads=4) as proxy:
            yield (proxy.url, tensors,
                   sum(a.nbytes for a in tensors.values()),
                   sum(len(b) for n, b in files.items()
                       if n.endswith(".safetensors")), keys)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def reference(warm):
    """The reference's single-process pull off the same peer onto its
    8-device mesh: name → the whole array."""
    report, placed = jremote.pull_manifest_to_hbm(
        MODEL, [warm[0]], mesh=jmesh.make_mesh(8))
    return {n: np.asarray(a) for n, a in placed.arrays.items()}


def _slice(spec: list, coords: dict, axes: dict, shape) -> tuple:
    """Rank ``coords``'s index into a tensor of ``shape`` under ``spec``
    on a mesh of ``axes`` (the port's ``shard_index``, held against the
    reference's ``devices_indices_map`` in ``test_torch_mesh.py``)."""
    n = int(np.prod(list(axes.values())))
    sizes = tmesh.axis_sizes(n, **axes)
    rank = int(np.ravel_multi_index([coords[a] for a in sizes],
                                    list(sizes.values())))
    devices = np.empty(n, dtype=object)
    devices[:] = [torch.device("cpu")] * n
    mesh = tmesh.Mesh(devices.reshape(tuple(sizes.values())), tuple(sizes),
                      rank)
    spec = tuple(tuple(p) if isinstance(p, list) else p for p in spec)
    return tmesh.shard_index(mesh, spec, tuple(shape))


def _pull(ranks, warm, axes, **kw):
    args = {"axes": axes, "model": MODEL, "peers": [warm[0]],
            "env": PULL_ENV, **kw}
    return ranks.run("pod_pull", args)


def _assert_shards(out, reference, axes) -> None:
    for arrays, meta in out:
        assert sorted(arrays) == sorted(reference)
        for name, got in arrays.items():
            want = reference[name][_slice(meta["specs"][name],
                                          meta["coords"], axes,
                                          reference[name].shape)]
            assert got.tobytes() == want.tobytes(), (name, meta["coords"])
    for _, meta in out[1:]:
        assert meta["fp"] == out[0][1]["fp"]


@pytest.mark.parametrize("world", [2, 4])
def test_shards_equal_the_reference_pull(request, warm, reference, world):
    ranks = request.getfixturevalue("two" if world == 2 else "four")
    axes = {"tp": world}
    out = _pull(ranks, warm, axes)
    _assert_shards(out, reference, axes)
    # some tensor is split over the ranks, not replicated on each
    specs = out[0][1]["specs"]
    assert any("tp" in str(s) for s in specs.values())


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_reads_a_fraction_of_the_weights(request, warm, world):
    ranks = request.getfixturevalue("two" if world == 2 else "four")
    _, _, weight, files, _ = warm
    out = _pull(ranks, warm, {"tp": world})
    got = [m["network_bytes"] for _, m in out]
    for meta in (m for _, m in out):
        assert meta["weight_bytes"] == files and not meta["pipelined"]
    # its shards, 1/N of the replicated tensor, the small bias whole and
    # the headers: under 0.62 of the weights on 2 ranks (the reference's
    # bound), 0.62 / 2 + slack on 4
    limit = 0.62 if world == 2 else 0.36
    assert all(n < limit * weight for n in got), (got, weight)
    # together about once: headers and the bias are the only re-reads
    assert weight <= sum(got) <= weight * 1.15, (got, weight)


def test_ici_complete_reads_a_replicated_tensor_once(two, warm, reference):
    """A ``dp`` mesh replicates every tensor: with ``ici_complete`` each
    rank reads about half and the all-gather completes the rest; without
    it each reads everything. The same bytes land either way."""
    weight = warm[2]
    axes = {"dp": 2}
    on = _pull(two, warm, axes, ici_complete=True)
    off = _pull(two, warm, axes, ici_complete=False)
    for arrays, meta in on:
        assert all(tuple(s) == (None,) * len(s) or not s
                   for s in meta["specs"].values())
        assert meta["network_bytes"] <= 0.62 * weight
    for arrays, meta in off:
        assert meta["network_bytes"] >= weight
    _assert_shards(on, reference, axes)
    _assert_shards(off, reference, axes)
    assert sum(m["network_bytes"] for _, m in on) <= weight * 1.15


def test_mid_window_death_aborts_every_rank_then_a_retry_succeeds(
        two, warm, reference):
    """The peer dies in the middle of a window of the second weight file,
    after the first file's tensors landed: every rank raises ``OSError``
    within a few group timeouts (none reports a partial placement), and the
    same pull off a live peer on a new mesh lands the reference's
    shards."""
    url, _, weight, _, keys = warm
    axes = {"tp": 2}
    with _DyingPeer(url, keys[1]) as dying:
        out = two.run("pod_pull_dies", {
            "axes": axes, "model": MODEL, "dying": dying.url, "live": url,
            "dying_ranks": [0, 1], "env": PULL_ENV,
            "timeout_s": DEATH_TIMEOUT_S})
        assert dying.dead, "the rigged peer never died mid-window"
    for _, meta in out:
        assert meta["error"] and meta["error"].startswith("OSError"), meta
        assert meta["abort_s"] < 3 * DEATH_TIMEOUT_S, meta
    retried = [(arrays, meta["retry"]) for arrays, meta in out]
    _assert_shards(retried, reference, axes)
    assert weight <= sum(m["network_bytes"] for _, m in retried) \
        <= weight * 1.15


def test_a_death_on_one_ranks_path_fails_every_rank(two, warm, reference):
    """Rank 1's peer dies mid-window while rank 0's serves it all: with
    no collective in the delivery (a ``dp`` mesh, no ``ici_complete``)
    rank 0 lands a whole placement, yet raises ``OSError`` naming rank 1,
    as rank 1 does; the retry off the live peer succeeds."""
    url, _, _, _, keys = warm
    axes = {"dp": 2}
    with _DyingPeer(url, keys[0]) as dying:
        out = two.run("pod_pull_dies", {
            "axes": axes, "model": MODEL, "dying": dying.url, "live": url,
            "dying_ranks": [1], "ici_complete": False, "env": PULL_ENV,
            "timeout_s": DEATH_TIMEOUT_S})
        assert dying.dead
    for _, meta in out:
        assert meta["error"].startswith("OSError") and "[1]" in \
            meta["error"], meta["error"]
        assert meta["abort_s"] < 3 * DEATH_TIMEOUT_S, meta
    _assert_shards([(a, m["retry"]) for a, m in out], reference, axes)
