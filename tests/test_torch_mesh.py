"""The port's mesh and collectives over a torch.distributed world, against
the JAX package's ``parallel/mesh.py`` and ``parallel/collectives.py``.

Four gloo ranks (``tests/torch_mesh_rig.py``, one process each) build
meshes and run the collectives on their local shards; the reference runs
in this process on the first four of its eight virtual CPU devices
(``tests/conftest.py``), at the same axis sizes. Rank ``r`` of the port
is device ``r`` of the reference. Held: axis sizes, each rank's
coordinates and the members of its sub-groups; shard indices against
``devices_indices_map``; ``redistribute`` (all-to-all, gather, slice),
``replicate``, ``allgather_axis``, ``psum_across`` and ``fingerprint``
(equal on every rank). A mesh outside a world is the one-device mesh it
always was.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from demodel_tpu_torch.parallel import collectives as tcol
from demodel_tpu_torch.parallel import mesh as tmesh

from .torch_mesh_rig import Ranks

jmesh = importlib.import_module("demodel_tpu.parallel.mesh")
jcol = importlib.import_module("demodel_tpu.parallel.collectives")

torch.set_num_threads(1)
WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(WORLD, tmp_path_factory.mktemp("ranks"))
    yield r
    r.close()


def _coords(ref, r: int) -> dict:
    """Device ``r``'s position on each axis of the reference mesh."""
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    pos = np.argwhere(ids == r)[0]
    return {a: int(i) for a, i in zip(ref.axis_names, pos)}


MESH_KWARGS = [{}, {"tp": 1}, {"sp": 2}, {"sp": 4, "tp": 1}, {"dp": 2},
               {"ep": 2, "tp": 1}, {"pp": 2}, {"dp": 2, "sp": 2}]


@pytest.mark.parametrize("kw", MESH_KWARGS, ids=str)
def test_world_mesh_matches_the_reference(ranks, kw):
    ref = jmesh.make_mesh(WORLD, **kw)
    out = ranks.run("mesh", {"axes": kw})
    for r, (_, meta) in enumerate(out):
        assert meta["shape"] == dict(ref.shape)
        assert meta["coords"] == _coords(ref, r)
        assert meta["device"] == "cpu"
        assert meta["group_sizes"] == dict(ref.shape)
        for axis, members in meta["members"].items():
            want = [q for q in range(WORLD)
                    if all(_coords(ref, q)[a] == c
                           for a, c in _coords(ref, r).items() if a != axis)]
            assert members == want, (r, axis)


SPECS = [("tp", None), (None, "tp"), ("dp", "tp"), (("dp", "tp"), None),
         (None, ("tp", "dp")), (), (None,)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_shard_index_matches_devices_indices_map(spec):
    ref = jmesh.make_mesh(8, dp=2)
    shape = (8, 16)
    want = NamedSharding(ref, P(*spec)).devices_indices_map(shape)
    devices = np.empty(8, dtype=object)
    devices[:] = [torch.device("cpu")] * 8
    for dev, idx in want.items():
        mesh = tmesh.Mesh(devices.reshape(tuple(ref.shape.values())),
                          ref.axis_names, rank=dev.id)
        got = tmesh.shard_index(mesh, spec, shape)
        x = np.arange(128).reshape(shape)
        assert x[got].shape == x[idx].shape, dev.id
        assert np.array_equal(x[got], x[idx]), dev.id


PAIRS = [(("tp", None), (None, "tp")),     # one all-to-all
         ((None, "tp"), ("tp", None)),
         (("tp", None), ()),               # all-gather
         ((), ("dp", "tp")),               # slice only
         ((("dp", "tp"), None), ()),       # gather innermost first
         (("dp", "tp"), ("tp", "dp")),
         (("dp", None), (None, "tp"))]


def test_collectives_match_the_reference(ranks):
    ref = jmesh.make_mesh(WORLD, dp=2, tp=2)
    x = np.random.default_rng(0).standard_normal((8, 12)).astype(np.float32)
    out = ranks.run("collectives",
                    {"axes": {"dp": 2, "tp": 2}, "pairs": PAIRS,
                     "axis": "tp"}, {"x": x})
    for i, (src, dst) in enumerate(PAIRS):
        arr = jax.device_put(jnp.asarray(x), NamedSharding(ref, P(*src)))
        moved = jcol.redistribute(arr, NamedSharding(ref, P(*dst)))
        want_fp = np.asarray(jcol.fingerprint(arr))
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in moved.addressable_shards}
        for r, (got, _) in enumerate(out):
            assert np.array_equal(got[f"moved{i}"], by_dev[r]), (i, r)
            assert np.array_equal(got[f"replicated{i}"], x)
            np.testing.assert_allclose(got[f"fp{i}"], want_fp, rtol=1e-5)
            assert np.array_equal(got[f"fp{i}"], out[0][0][f"fp{i}"])
    arr = jax.device_put(jnp.asarray(x), NamedSharding(ref, P("tp")))
    gathered = np.asarray(jcol.allgather_axis(arr, ref, "tp"))
    psum = np.asarray(jcol.psum_across(arr, ref, "tp"))
    for got, _ in out:
        assert np.array_equal(got["gathered"], gathered)
        np.testing.assert_allclose(got["psum"], psum, rtol=1e-6)


def test_a_mesh_outside_a_world_is_one_process():
    mesh = tmesh.make_mesh(device="cpu")
    assert not mesh.distributed and mesh.coords == {"dp": 0, "tp": 0}
    assert mesh.device == torch.device("cpu")
    assert tmesh.local_device(mesh, "x") == torch.device("cpu")
    with pytest.raises(ValueError, match="no process groups"):
        mesh.group("tp")
    x = torch.arange(12.0).reshape(3, 4)
    assert tcol.redistribute(x, mesh, ("tp", None), ()) is x
    assert tcol.allgather_axis(x, mesh) is x
    want = jcol.fingerprint(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(tcol.fingerprint(x).numpy(),
                               np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError, match="0-d"):
        tcol.psum_across(torch.tensor(1.0), mesh)


def test_one_process_over_several_devices_raises():
    """The port runs a process per rank: a one-process mesh of several
    devices places nothing; the families of A7's part two still take one
    device only."""
    cpus = np.empty(2, dtype=object)
    cpus[:] = [torch.device("cpu")] * 2
    wide = tmesh.Mesh(cpus.reshape(1, 2), ("dp", "tp"))
    with pytest.raises(NotImplementedError, match="one process per rank"):
        tmesh.local_device(wide, "placement")
    with pytest.raises(NotImplementedError, match="A7"):
        tmesh.one_device(wide, "GPT-2")
