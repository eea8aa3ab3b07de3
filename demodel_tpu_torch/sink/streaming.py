"""Streaming sink: land shards on the device *while* later shards still
download (the port of ``demodel_tpu/sink/streaming.py``).

The registry's fetch workers hand each completed weight file to this
sink (``on_file``); one worker thread turns it into device tensors
(range reads from the store, then one host-to-device copy per tensor,
:func:`~demodel_tpu_torch.sink.hbm.deliver_file`), so a cold pull pays
max(network, host-to-device) instead of their sum. One worker is
deliberate: copies to one card serialize on its copy engine anyway.

Host RAM is bounded: artifacts that carry landing buffers count against
``DEMODEL_SINK_BUFFER_MB`` (:class:`ByteBudget`); ``submit`` blocks a
fetch worker once the admitted-but-undelivered window would exceed it.
Each delivery is timed into ``stage_duration_seconds{span="sink-deliver"}``
and each budget wait into ``span="sink-budget-wait"``.
"""

from __future__ import annotations

import os
import queue
import threading

import torch

from demodel_tpu_torch.parallel.mesh import Mesh, make_mesh
from demodel_tpu_torch.sink.hbm import (
    Placement,
    deliver_file,
    is_weight_file,
    merge_placement,
)
from demodel_tpu_torch.sink.plan import ShardingPlan
from demodel_tpu_torch.store import Store
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.env import env_int
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("sink.streaming")

_DONE = object()


class ByteBudget:
    """Counting semaphore in BYTES for landing buffers.

    Shared between a fetcher (charges at buffer allocation, the moment
    host RAM is committed) and the streaming sink (releases once the
    buffer's tensors are on the device). A single item larger than the
    budget is admitted alone rather than deadlocking.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._in_use = 0
        self.high_water = 0
        self.waiters = 0
        self._cv = threading.Condition()
        self._aborted = False

    @property
    def in_use(self) -> int:
        with self._cv:
            return self._in_use

    def acquire(self, nbytes: int) -> None:
        with self._cv:
            self.waiters += 1
            try:
                while (self._in_use > 0
                       and self._in_use + nbytes > self.max_bytes
                       and not self._aborted):
                    # every change that can unblock this predicate
                    # (release, abort) notifies, so no timeout poll
                    self._cv.wait()
            finally:
                self.waiters -= 1
            self._in_use += nbytes
            if self._in_use > self.high_water:
                self.high_water = self._in_use

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._in_use -= nbytes
            self._cv.notify_all()

    def abort(self) -> None:
        """Unblock all waiters (error path — delivery is being abandoned)."""
        with self._cv:
            self._aborted = True
            self._cv.notify_all()


class _Cancelled(Exception):
    """Internal sentinel: drain the queue without delivering."""


class StreamingSink:
    """Consumes completed FileArtifacts, delivers weight files to the
    device.

    Thread-safe producer side (``submit`` may be called from any fetch
    worker); ``finish()`` drains the queue, joins the worker, re-raises
    the first delivery error, and returns the merged :class:`Placement`.
    The mesh defaults to the CUDA device.
    """

    def __init__(self, store: Store, mesh: Mesh | None = None,
                 plan: ShardingPlan | None = None,
                 cast_to: torch.dtype | None = None,
                 overlap: bool | None = None,
                 max_buffered_bytes: int | None = None,
                 budget: ByteBudget | None = None):
        self.store = store
        self.mesh = mesh if mesh is not None else make_mesh()
        self.plan = plan if plan is not None else ShardingPlan(self.mesh)
        self.cast_to = cast_to
        self.placement = Placement(mesh_desc=f"{self.mesh.shape}")
        self._q: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._err_lock = threading.Lock()  # _err written from worker + caller
        if overlap is None:
            env = os.environ.get("DEMODEL_SINK_OVERLAP", "").strip().lower()
            overlap = env not in ("0", "false", "no", "off")
        self.overlap = overlap
        if max_buffered_bytes is None:
            max_buffered_bytes = env_int("DEMODEL_SINK_BUFFER_MB", 1024,
                                         minimum=1) << 20
        #: shared with a fetcher when delivery wires one (charging then
        #: happens at buffer allocation); standalone sinks charge at submit
        self.budget = budget if budget is not None else ByteBudget(
            max_buffered_bytes)
        self._worker = None
        self._worker_lock = threading.Lock()
        if overlap:
            self._start_worker()

    def _start_worker(self) -> None:
        with self._worker_lock:
            if self._worker is None:
                self._worker = threading.Thread(
                    target=trace.wrap(self._run), daemon=True,
                    name="sink-deliver")
                self._worker.start()

    # ---- producer side (fetch threads)
    def submit(self, artifact) -> None:
        """Queue a completed artifact; non-weight files are ignored. An
        artifact carrying a landing ``buffer`` is delivered from host
        memory without touching the store, and blocks (backpressuring
        the fetch worker) while the admitted buffers exceed the budget."""
        name = artifact.name if hasattr(artifact, "name") else artifact["name"]
        media = (artifact.media_type if hasattr(artifact, "media_type")
                 else artifact.get("media_type", ""))
        if not is_weight_file(name, media):
            # a charged buffer the sink will never consume returns its
            # budget immediately
            skipped = getattr(artifact, "buffer", None)
            if skipped is not None and getattr(artifact, "budget_charged",
                                               False):
                self.budget.release(int(skipped.nbytes))
            return
        key = artifact.key if hasattr(artifact, "key") else artifact["key"]
        buffer = getattr(artifact, "buffer", None)
        nbytes = int(getattr(buffer, "nbytes", 0)) if buffer is not None else 0
        if nbytes:
            # a buffered artifact always needs a live consumer: deferred
            # mode would otherwise hold every landing buffer until finish()
            self._start_worker()
            if not getattr(artifact, "budget_charged", False):
                with trace.span("sink-budget-wait", file=name, bytes=nbytes):
                    self.budget.acquire(nbytes)
        self._q.put((name, key, buffer, nbytes))

    # ---- consumer side
    def _set_err(self, e: BaseException) -> None:
        with self._err_lock:
            if self._err is None:
                self._err = e
        self.budget.abort()  # unblock backpressured producers

    def _get_err(self) -> BaseException | None:
        with self._err_lock:
            return self._err

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _DONE:
                return
            name, key, buffer, nbytes = item
            try:
                if self._get_err() is not None:
                    continue  # drain without working after first failure
                try:
                    with trace.span("sink-deliver", file=name,
                                    bytes=nbytes) as sp:
                        placed = deliver_file(self.store, name, key,
                                              self.mesh, self.plan,
                                              self.cast_to, buffer=buffer)
                        sp.set_attr("tensors", len(placed.arrays))
                    merge_placement(self.placement, placed)
                    log.debug("streamed %s → %d tensors", name,
                              len(placed.arrays))
                except BaseException as e:  # noqa: BLE001 — reported at finish()
                    self._set_err(e)
            finally:
                if nbytes:
                    self.budget.release(nbytes)

    def cancel(self) -> None:
        """Abandon delivery: drain queued files without doing the work.
        Used on the pull-error path, where the placement is discarded."""
        self._set_err(_Cancelled())
        self._q.put(_DONE)
        if self._worker is not None:
            self._worker.join()

    def finish(self, block: bool = True) -> Placement:
        """Wait for every queued file to land; return the merged placement
        (with ``block``, after the card has finished the copies)."""
        self._q.put(_DONE)
        if self._worker is not None:
            self._worker.join()
        else:
            self._run()  # deferred mode: deliver everything now, fetch done
        err = self._get_err()
        if isinstance(err, _Cancelled):
            # the private sentinel must not escape to callers
            raise RuntimeError("sink was cancelled before finish()")
        if err is not None:
            raise err
        devices = {a.device for a in self.placement.arrays.values()
                   if a.device.type == "cuda"}
        if block:
            for dev in devices:
                torch.cuda.synchronize(dev)
        log.info("streamed %d tensors (%.1f MB) onto mesh %s",
                 len(self.placement.arrays),
                 self.placement.total_bytes / 1e6, self.placement.mesh_desc)
        return self.placement
