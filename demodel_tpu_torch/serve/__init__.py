"""Token-serving plane of the port: continuous batching over a paged KV
cache (``demodel_tpu/serve``).

:func:`boot` starts a :class:`~demodel_tpu_torch.serve.scheduler.GenEngine`
over in-memory params and installs it as the process-wide engine that
:mod:`demodel_tpu_torch.serve.http` serves ``/generate`` from. Booting
from a pulled checkpoint (``load_model``) needs the pull plane and waits
for a later slice.
"""

from __future__ import annotations

import threading

from demodel_tpu_torch.serve.kvcache import (BlockLease, KVBlockPool,
                                             PoolExhausted)
from demodel_tpu_torch.serve.scheduler import (AdmissionQueue,
                                               AdmissionTicket, GenEngine,
                                               QueueOverflow, Request)

__all__ = [
    "AdmissionQueue", "AdmissionTicket", "BlockLease", "GenEngine",
    "KVBlockPool", "PoolExhausted", "QueueOverflow", "Request",
    "boot", "current", "install",
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


def boot(params, cfg, **engine_kw) -> GenEngine:
    """Start an engine over in-memory params and install it. ``device``
    (in ``engine_kw``) defaults to ``cuda``."""
    engine = GenEngine(params, cfg, **engine_kw).start()
    install(engine)
    return engine
