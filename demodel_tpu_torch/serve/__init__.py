"""Token-serving plane of the port: continuous batching over a paged KV
cache (``demodel_tpu/serve``).

:func:`load_model` makes a cold boot one call: a pull through the
store (:func:`demodel_tpu_torch.delivery.pull_to_hbm`, weights streaming
onto the device as the shards arrive), the model built from the pulled
``config.json``, and a started
:class:`~demodel_tpu_torch.serve.scheduler.GenEngine` installed as the
process-wide engine that :mod:`demodel_tpu_torch.serve.http` serves
``/generate`` from. :func:`boot` does the last step over in-memory
params.

Over a mesh of several ranks (one process each, ``torchrun``) every rank
calls :func:`load_model` or :func:`boot` with the same arguments: each
places and keeps its own shards and runs its engine in lockstep with
rank 0's, and only rank 0's engine is installed, so only rank 0 answers
``/generate``.
"""

from __future__ import annotations

import threading

from demodel_tpu_torch.serve.kvcache import (BlockLease, KVBlockPool,
                                             PoolExhausted)
from demodel_tpu_torch.serve.scheduler import (AdmissionQueue,
                                               AdmissionTicket, GenEngine,
                                               QueueOverflow, Request)
from demodel_tpu_torch.utils import trace

__all__ = [
    "AdmissionQueue", "AdmissionTicket", "BlockLease", "GenEngine",
    "KVBlockPool", "PoolExhausted", "QueueOverflow", "Request",
    "boot", "current", "install", "load_model",
]

#: the process-wide engine the HTTP surface serves from
_current: GenEngine | None = None
_current_lock = threading.Lock()


def install(engine: GenEngine | None) -> None:
    """Make ``engine`` the process-wide serving engine (None clears); a
    replaced engine keeps running — stopping it is the caller's call."""
    global _current
    with _current_lock:
        _current = engine


def current() -> GenEngine | None:
    with _current_lock:
        return _current


def boot(params, cfg, mesh=None, **engine_kw) -> GenEngine:
    """Start an engine over in-memory params and install it. ``device``
    (in ``engine_kw``) defaults to ``cuda``. On a ``mesh`` of several
    ranks ``params`` are this rank's shards and only rank 0 installs its
    engine (:class:`~demodel_tpu_torch.serve.scheduler.GenEngine`)."""
    engine = GenEngine(params, cfg, mesh, **engine_kw).start()
    if engine.leader:
        install(engine)
    return engine


def load_model(model: str, cfg, *, source: str = "hf",
               revision: str = "main", endpoint: str | None = None,
               mesh=None, peers: list[str] | None = None,
               device=None, **engine_kw) -> GenEngine:
    """Cold model boot: pull ``model`` through the store named by ``cfg``
    (a :class:`~demodel_tpu_torch.config.ProxyConfig`), from the peer
    nodes in ``peers`` where they hold it, place its weights on
    ``device`` (default ``cuda``) or on ``mesh``, build it, and start
    serving it. The whole boot is timed into
    ``stage_duration_seconds{span="serve.load-model"}``.

    Over a ``mesh`` of several ranks every rank calls this with the same
    arguments but its own ``cfg`` store: each pulls into its own store,
    keeps its shards of the weights and starts its engine; rank 0's is
    installed and answers ``/generate``, the others follow it and return
    their engine uninstalled (``join()`` waits until rank 0 stops)."""
    from demodel_tpu_torch import delivery
    from demodel_tpu_torch.models import auto, llama
    from demodel_tpu_torch.parallel.mesh import make_mesh

    if mesh is None:
        mesh = make_mesh(device=device)
    dev = mesh.device
    with trace.span("serve.load-model", model=model, source=source):
        report, placed = delivery.pull_to_hbm(
            model, cfg, source=source, revision=revision,
            endpoint=endpoint, mesh=mesh, peers=peers, deliver=True)
        store = delivery.open_store(cfg)
        try:
            _fn, params, mcfg = auto.model_from_pull(
                store, report, mesh=mesh, placement=placed)
        finally:
            store.close()
        if not isinstance(mcfg, llama.LlamaConfig):
            raise ValueError(
                f"serving supports llama-family models; {model!r} resolved "
                f"to {type(mcfg).__name__}")
        engine = GenEngine(params, mcfg, mesh, device=dev, model=model,
                           **engine_kw).start()
    if engine.leader:
        install(engine)
    return engine
