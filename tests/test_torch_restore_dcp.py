"""Port: ``torch.distributed.checkpoint`` over a restore node
(``restore/orbax_http``'s ``HTTPStorageReader`` and ``HTTPStorageWriter``)
and on disk (``restore/orbax_compat``), on the CPU, without a process
group.

The nodes are ``tests/test_torch_restore.py``'s: each package's
``RestoreServer`` over the store its own pull of
``build_hf_repo(n_shards=2)`` filled, with its native plane attached.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from demodel_tpu_torch.parallel import make_mesh
from demodel_tpu_torch.restore import client as tclient
from demodel_tpu_torch.restore.orbax_compat import (load_placement,
                                                    save_placement)
from demodel_tpu_torch.restore.orbax_http import (HTTPStorageReader,
                                                  HTTPStorageWriter,
                                                  restore_state_dict,
                                                  save_state_dict)
from demodel_tpu_torch.sink.hbm import Placement

from .test_torch_restore import (MODEL, _hygiene, _stored_tensors,  # noqa: F401
                                 nodes, pulled)

torch.set_num_threads(1)


@pytest.mark.parametrize("server", ["port", "reference"])
def test_dcp_load_through_a_node(pulled, nodes, server):
    """``dcp.load`` with no process group into ``empty_like`` tensors and
    into a narrower-typed subset: every value equals the stored bytes."""
    n = nodes(server, pulled[server], native="127.0.0.1")
    want = _stored_tensors(pulled[server])
    sd = {k: torch.empty(v.shape, dtype=torch.float32)
          for k, v in want.items()}
    dcp.load(sd, storage_reader=HTTPStorageReader(n.url, MODEL),
             no_dist=True)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    part = {"layer.1.w": torch.empty(want["layer.1.w"].shape,
                                     dtype=torch.float64)}
    dcp.load(part, storage_reader=HTTPStorageReader(n.url, MODEL,
                                                    workers=1),
             no_dist=True)
    np.testing.assert_array_equal(part["layer.1.w"].numpy(),
                                  want["layer.1.w"].astype(np.float64))


def test_dcp_save_dedups_against_save_state_dict(pulled, nodes, tmp_path):
    """``save_state_dict`` pushes every tensor once; ``dcp.save`` through
    ``HTTPStorageWriter`` of the same tensors under another name sends 0
    bytes, and both models restore equal."""
    n = nodes("port", tmp_path / "node")
    sd = {k: torch.from_numpy(v.copy())
          for k, v in _stored_tensors(pulled["port"]).items()}
    sd["extra.h"] = torch.arange(12, dtype=torch.float16).reshape(3, 4)
    first = save_state_dict(n.url, "saved", sd)
    assert (first["tensors"], first["pushed"], first["skipped"]) == (5, 5, 0)
    writer = HTTPStorageWriter(n.url, "saved-dcp")
    dcp.save(sd, storage_writer=writer, no_dist=True)
    assert writer.stats == {"tensors": 5, "pushed": 0, "skipped": 5,
                            "sent_bytes": 0}
    assert n.registry.models() == ["saved", "saved-dcp"]
    for name in ("saved", "saved-dcp"):
        got = restore_state_dict(n.url, name, mesh=make_mesh(device="cpu"))
        assert sorted(got) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(got[k], v), (name, k)
    again = save_state_dict(n.url, "saved", sd)
    assert again == {"tensors": 5, "pushed": 0, "skipped": 5,
                     "sent_bytes": 0}


def test_orbax_compat_twin_round_trips(pulled, nodes, tmp_path):
    """A restored placement (and tensors of other dtypes, a scalar among
    them) through ``save_placement`` / ``load_placement``: value-exact,
    dtypes kept, on the asked device."""
    n = nodes("port", pulled["port"])
    placed = tclient.restore(n.url, MODEL, mesh=make_mesh(device="cpu"))
    arrays = dict(placed.arrays)
    arrays["extra.bf16"] = torch.linspace(-2, 2, 10).to(torch.bfloat16)
    arrays["extra.i64"] = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    arrays["extra.scalar"] = torch.tensor(3.5)
    save_placement(Placement(arrays=arrays), tmp_path / "ckpt")
    back = load_placement(tmp_path / "ckpt", device="cpu")
    assert sorted(back.arrays) == sorted(arrays)
    for k, v in arrays.items():
        got = back.arrays[k]
        assert got.dtype == v.dtype and got.device.type == "cpu", k
        assert torch.equal(got, v), k
