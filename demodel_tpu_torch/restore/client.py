"""Network restore: a node's ``/restore`` endpoint → tensors on the
device (the port of ``demodel_tpu/restore/client.py``).

A serving stack points at a demodel node instead of a bucket and
restores a registered checkpoint straight into device memory. Every
tensor arrives as HTTP Range windows of ``/restore/{model}/tensor/{name}``
(:class:`~demodel_tpu_torch.sink.remote.PeerBlobReader`: native windows
from 4 MiB, resumed at the received offset) and is placed by
:func:`~demodel_tpu_torch.sink.hbm.place_tensor`, reading only its
device's rows. The manifest's ``data_endpoint`` (the node's native
plane), when it names one, serves the bytes.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from demodel_tpu_torch.formats.safetensors import torch_dtype
from demodel_tpu_torch.parallel.mesh import Mesh, make_mesh
from demodel_tpu_torch.sink.hbm import Placement, place_tensor
from demodel_tpu_torch.sink.plan import ShardingPlan
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.env import restore_workers
from demodel_tpu_torch.utils.faults import (HTTPClient, PeerHealth,
                                            RetryPolicy, request_with_retry)
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("restore.client")


@dataclass
class RestoreResult(Placement):
    secs: float = 0.0
    bytes_fetched: int = 0
    manifest: dict = field(default_factory=dict)


def fetch_manifest(endpoint: str, model: str, timeout: float = 300.0
                   ) -> dict:
    """``GET {endpoint}/restore/{model}/manifest``, retried with backoff
    and counted on the endpoint's breaker."""
    endpoint = endpoint.rstrip("/")
    client = HTTPClient()
    try:
        return request_with_retry(
            client, "GET", f"{endpoint}/restore/{model}/manifest",
            policy=RetryPolicy(), health=PeerHealth.shared(), peer=endpoint,
            timeout=timeout, what=f"restore manifest {model}").json()
    finally:
        client.close()


def restore(endpoint: str, model: str, mesh: Mesh | None = None,
            plan: ShardingPlan | None = None, cast_to=None,
            timeout: float = 300.0) -> RestoreResult:
    """Restore ``model`` from the node at ``endpoint`` onto ``mesh``
    (default: the CUDA mesh), ``DEMODEL_RESTORE_WORKERS`` tensors at a
    time; ``cast_to`` casts each tensor on the device."""
    with trace.span("restore", model=model, endpoint=endpoint):
        return _restore(endpoint.rstrip("/"), model, mesh, plan, cast_to,
                        timeout)


def _restore(endpoint, model, mesh, plan, cast_to, timeout) -> RestoreResult:
    if mesh is None:
        mesh = make_mesh()
    if plan is None:
        plan = ShardingPlan(mesh)
    t0 = time.perf_counter()
    manifest = fetch_manifest(endpoint, model, timeout)
    out = RestoreResult(mesh_desc=f"{mesh.shape}", manifest=manifest)
    data_base = manifest.get("data_endpoint", endpoint).rstrip("/")
    fetched = 0
    fetched_lock = threading.Lock()

    def restore_one(item):
        nonlocal fetched
        name, info = item
        with trace.span("tensor-restore", tensor=name,
                        bytes=int(info["nbytes"])):
            from demodel_tpu_torch.sink.remote import PeerBlobReader

            shape = tuple(info["shape"])
            dtype = torch_dtype(info["dtype"])
            reader = PeerBlobReader(
                data_base, name, int(info["nbytes"]),
                path=f"/restore/{model}/tensor/{name}", timeout=timeout)
            try:
                arr = place_tensor(
                    lambda off, ln: reader.pread(name, ln, off), shape,
                    dtype, 0, mesh,
                    plan.sharding_for(name, shape, dtype.itemsize), cast_to,
                    read_into=lambda off, buf: reader.pread_into(name, buf,
                                                                 off))
            finally:
                reader.close()
            with fetched_lock:
                fetched += reader.bytes_fetched
            return name, arr

    items = list(manifest["tensors"].items())
    workers = min(restore_workers(), max(1, len(items)))
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="restore") as ex:
        # one wrapped callable per item: a context cannot be entered by
        # two threads at once
        futs = [ex.submit(trace.wrap(restore_one), item) for item in items]
        for fut in futs:
            name, arr = fut.result()
            out.arrays[name] = arr
    out.secs = time.perf_counter() - t0
    out.bytes_fetched = fetched
    log.info("restored %s: %d tensors, %.1f MB fetched in %.2fs", model,
             len(out.arrays), fetched / 1e6, out.secs)
    return out
