"""Network checkpoints for ``torch.distributed.checkpoint`` (DCP) over a
node's ``/restore`` surface: the PyTorch twin of
``demodel_tpu/restore/orbax_http.py``, whose Orbax handler gives JAX
consumers the same thing (the module keeps its name so the two are found
side by side).

A consumer that speaks only DCP points it at a demodel node instead of a
directory or a bucket; no checkpoint file exists on its side at any
point:

    import torch.distributed.checkpoint as dcp
    from demodel_tpu_torch.restore.orbax_http import (
        HTTPStorageReader, HTTPStorageWriter)

    dcp.load(state_dict, no_dist=True, storage_reader=HTTPStorageReader(
        "http://node:8081", "meta-llama/Llama-2-7b-hf"))
    dcp.save(state_dict, no_dist=True, storage_writer=HTTPStorageWriter(
        "http://node:8081", "my-finetune"))

- :class:`HTTPStorageReader` takes the checkpoint's ``Metadata`` from the
  node's manifest and reads every item as a Range window of
  ``/restore/{model}/tensor/{name}`` straight into the caller's tensor,
  on whatever device it lives.
- :class:`HTTPStorageWriter` pushes each tensor as a single-tensor
  safetensors blob under its sha256, skipping a blob the node already
  holds (``GET /restore/blob/{sha256}``), then commits the ordered
  digests as the model. A blob is byte-identical to the one the JAX
  package pushes for the same tensor, so either package's saves dedup
  against the other's.

:func:`restore_state_dict` and :func:`save_state_dict` are the one-call
forms (the twins of ``restore_pytree`` and ``save_pytree``).
"""

from __future__ import annotations

import hashlib
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.distributed.checkpoint import StorageReader, StorageWriter
from torch.distributed.checkpoint.metadata import (ChunkStorageMetadata,
                                                   Metadata,
                                                   TensorProperties,
                                                   TensorStorageMetadata)
from torch.distributed.checkpoint.planner import (LoadPlan, SavePlan,
                                                  WriteItemType)
from torch.distributed.checkpoint.storage import WriteResult

from demodel_tpu_torch.formats import safetensors as st
from demodel_tpu_torch.restore.client import fetch_manifest, restore
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.env import restore_workers
from demodel_tpu_torch.utils.faults import (HTTPClient, RetryPolicy,
                                            request_with_retry)
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("restore.orbax_http")


def _done(value):
    fut = torch.futures.Future()
    fut.set_result(value)
    return fut


class HTTPStorageReader(StorageReader):
    """A DCP ``StorageReader`` over ``{endpoint}/restore/{model}``."""

    def __init__(self, endpoint: str, model: str, timeout: float = 300.0,
                 workers: int | None = None):
        super().__init__()
        self.endpoint = endpoint.rstrip("/")
        self.model = model
        self.timeout = timeout
        self.workers = workers or restore_workers()
        self._manifest: dict | None = None

    def reset(self, checkpoint_id=None) -> None:
        self._manifest = None

    @classmethod
    def validate_checkpoint_id(cls, checkpoint_id) -> bool:
        return False

    def read_metadata(self, *args, **kwargs) -> Metadata:
        self._manifest = fetch_manifest(self.endpoint, self.model,
                                        self.timeout)
        md = {}
        for name, info in self._manifest["tensors"].items():
            size = torch.Size(info["shape"])
            md[name] = TensorStorageMetadata(
                properties=TensorProperties(
                    dtype=st.torch_dtype(info["dtype"])),
                size=size, chunks=[ChunkStorageMetadata(
                    offsets=torch.Size([0] * len(size)), sizes=size)])
        return Metadata(state_dict_metadata=md)

    def set_up_storage_reader(self, metadata, is_coordinator, *args,
                              **kwargs) -> None:
        pass

    def prepare_local_plan(self, plan: LoadPlan) -> LoadPlan:
        return plan

    def prepare_global_plan(self, plans: list[LoadPlan]) -> list[LoadPlan]:
        return plans

    def _read_item(self, item, planner, data_base: str) -> None:
        from demodel_tpu_torch.sink.remote import PeerBlobReader

        name = item.storage_index.fqn
        info = self._manifest["tensors"][name]
        shape = tuple(info["shape"])
        dtype = st.torch_dtype(info["dtype"])
        # rows [o0, o0 + l0) of a row-major tensor are one byte range;
        # the trailing dims are narrowed on the host
        row_bytes = dtype.itemsize
        for d in shape[1:]:
            row_bytes *= d
        r0, nrows = (item.storage_offsets[0], item.lengths[0]) if shape \
            else (0, 1)
        host = torch.empty(nrows * row_bytes, dtype=torch.uint8)
        reader = PeerBlobReader(
            data_base, name, int(info["nbytes"]),
            path=f"/restore/{self.model}/tensor/{name}",
            timeout=self.timeout)
        try:
            got = reader.pread_into(name, host.numpy(), r0 * row_bytes)
        finally:
            reader.close()
        if got != host.numel():
            raise IOError(f"{name}: short read {got} != {host.numel()}")
        src = host.view(dtype).reshape((nrows,) + shape[1:])
        for dim in range(1, len(shape)):
            src = src.narrow(dim, item.storage_offsets[dim],
                             item.lengths[dim])
        target = planner.resolve_tensor(item)
        target.copy_(src)
        planner.commit_tensor(item, target)

    def read_data(self, plan: LoadPlan, planner):
        data_base = self._manifest.get("data_endpoint",
                                       self.endpoint).rstrip("/")
        with ThreadPoolExecutor(
                max_workers=min(self.workers, max(1, len(plan.items))),
                thread_name_prefix="dcp-read") as ex:
            for fut in [ex.submit(self._read_item, item, planner, data_base)
                        for item in plan.items]:
                fut.result()
        return _done(None)


class HTTPStorageWriter(StorageWriter):
    """A DCP ``StorageWriter`` that pushes to ``{endpoint}/restore``:
    one content-addressed blob a tensor, then a commit as ``model``.
    :attr:`stats` counts ``tensors``, ``pushed``, ``skipped`` and
    ``sent_bytes``."""

    def __init__(self, endpoint: str, model: str, timeout: float = 300.0):
        super().__init__()
        self.endpoint = endpoint.rstrip("/")
        self.model = model
        self.timeout = timeout
        self._client = HTTPClient()
        self._lock = threading.Lock()
        self.stats = {"tensors": 0, "pushed": 0, "skipped": 0,
                      "sent_bytes": 0}

    def reset(self, checkpoint_id=None) -> None:
        self.stats = dict.fromkeys(self.stats, 0)

    def close(self) -> None:
        """Close the connections to the node."""
        self._client.close()

    @classmethod
    def validate_checkpoint_id(cls, checkpoint_id) -> bool:
        return False

    def set_up_storage_writer(self, is_coordinator, *args, **kwargs) -> None:
        pass

    def prepare_local_plan(self, plan: SavePlan) -> SavePlan:
        return plan

    def prepare_global_plan(self, plans: list[SavePlan]) -> list[SavePlan]:
        return plans

    def _request(self, method: str, path: str, **kw):
        return request_with_retry(
            self._client, method, f"{self.endpoint}{path}",
            policy=RetryPolicy(), timeout=self.timeout, **kw)

    def push(self, name: str, tensor: torch.Tensor) -> tuple[str, int]:
        """Push ``tensor`` as the blob ``{name: tensor}`` unless the node
        holds it; returns its sha256 and size. The blob is hashed and sent
        from the tensor's host copy, never assembled."""
        with trace.span("save-serialize", tensor=name):
            parts = st.serialize_parts({name: tensor.detach().cpu()})
        size = sum(memoryview(b).nbytes for b in parts)
        with trace.span("save-digest", tensor=name, bytes=size):
            h = hashlib.sha256()
            for b in parts:
                h.update(b)
            digest = h.hexdigest()
        with trace.span("save-push", tensor=name, bytes=size):
            probe = self._request("GET", f"/restore/blob/{digest}",
                                  ok_statuses=(404,))
            if probe.status_code == 200:
                sent = 0
            else:
                self._request("PUT", f"/restore/blob/{digest}", body=parts,
                              headers={"Content-Type":
                                       "application/octet-stream",
                                       "Content-Length": str(size)})
                sent = size
        with self._lock:
            self.stats["tensors"] += 1
            self.stats["pushed" if sent else "skipped"] += 1
            self.stats["sent_bytes"] += sent
        return digest, size

    def commit(self, digests: list[str]) -> None:
        """Register ``model`` on the node from pushed blobs, in order."""
        self._request("POST", f"/restore/{self.model}/commit",
                      body=json.dumps({"digests": digests}).encode(),
                      headers={"Content-Type": "application/json"})
        log.info("saved %s: %d tensors (%d pushed, %.1f MB sent; %d "
                 "deduped) to %s", self.model, len(digests),
                 self.stats["pushed"], self.stats["sent_bytes"] / 1e6,
                 self.stats["skipped"], self.endpoint)

    def write_data(self, plan: SavePlan, planner):
        results = []
        for item in plan.items:
            if item.type != WriteItemType.TENSOR:
                raise NotImplementedError(
                    f"{item.index.fqn}: only whole tensors are pushed "
                    f"(got a {item.type.name} item)")
            digest, size = self.push(item.index.fqn,
                                     planner.resolve_data(item))
            results.append(WriteResult(index=item.index,
                                       size_in_bytes=size,
                                       storage_data=digest))
        return _done(results)

    def finish(self, metadata, results) -> None:
        try:
            self.commit([r.storage_data for rs in results for r in rs])
        finally:
            self.close()


def restore_state_dict(endpoint: str, model: str, mesh=None, plan=None,
                       cast_to=None) -> dict[str, torch.Tensor]:
    """One-call network restore: name → tensor on the device."""
    return restore(endpoint, model, mesh=mesh, plan=plan,
                   cast_to=cast_to).arrays


def save_state_dict(endpoint: str, model: str,
                    state_dict: dict[str, torch.Tensor]) -> dict:
    """Push a flat state dict (streamed, one tensor at a time, deduped by
    content). Returns ``{tensors, pushed, skipped, sent_bytes}``."""
    w = HTTPStorageWriter(endpoint, model)
    try:
        w.commit([w.push(name, t)[0] for name, t in state_dict.items()])
    finally:
        w.close()
    return dict(w.stats)
