"""Live-node introspection: the ``/debug/statusz`` JSON document, the
port of ``demodel_tpu.utils.statusz`` (the same schema version, sections
and keys).

A serving node answers "what are you doing RIGHT NOW" from curl, without
a restart and without pre-enabled tracing: which peer the breaker is
punishing, what the ByteBudget is charged with, which spans are open
(and for how long), what the engine is decoding and what the flight
recorder holds. This module assembles that document from where the
state already lives — :mod:`~demodel_tpu_torch.utils.faults`
(breakers), :mod:`~demodel_tpu_torch.utils.trace` (in-flight spans and
the recorder), :mod:`~demodel_tpu_torch.sink.streaming` (budgets),
:mod:`~demodel_tpu_torch.serve` (the generation engine) — and the
restore server serves it at ``GET /debug/statusz``.

Every section peeks ``sys.modules`` instead of importing: a subsystem
that was never imported has no live state worth reporting, and a scrape
never imports ``torch`` or allocates a singleton.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any

from demodel_tpu_torch.utils import metrics, trace

#: process start, for the uptime field (module import is close enough —
#: statusz is assembled lazily, but utils.metrics/trace load at bring-up)
_START_MONOTONIC = time.monotonic()
_START_WALL = time.time()

#: v2 added the ``tiers`` section (RAM/disk occupancy, budgets, in-flight
#: single-flight leaders) on both planes; v3 added the ``storage``
#: section (degraded read-through state, quarantine/scrub counters); v4
#: added the ``generation`` section (the token-serving plane: running/
#: waiting sequences, KV pool occupancy, admission accounting)
SCHEMA_VERSION = 4


def _breakers() -> dict[str, dict[str, Any]]:
    faults = sys.modules.get("demodel_tpu_torch.utils.faults")
    if faults is None:
        return {}
    health = faults.PeerHealth._shared  # noqa: SLF001 — read-only peek:
    # shared() would CREATE the registry; statusz must observe, not allocate
    if health is None:
        return {}
    out: dict[str, dict[str, Any]] = health.describe()
    return out


def _budgets() -> list[dict[str, Any]]:
    streaming = sys.modules.get("demodel_tpu_torch.sink.streaming")
    if streaming is None:
        return []
    out: list[dict[str, Any]] = streaming.budgets_snapshot()
    return out


def _swarm() -> list[dict[str, Any]]:
    """Live swarm chunk progress (boards registered by any in-process
    SwarmScheduler) — the per-host half of the swarm's debugging
    story."""
    placement = sys.modules.get("demodel_tpu_torch.parallel.placement")
    if placement is None:
        return []
    out: list[dict[str, Any]] = placement.boards_snapshot()
    return out


def _tiers() -> list[dict[str, Any]]:
    """Live tiered-store state (RAM/disk occupancy vs budget, in-flight
    single-flight leaders) for every TieredStore this process holds —
    the Python half of the section the native proxy composes from its
    hot_stats."""
    tier = sys.modules.get("demodel_tpu_torch.tier")
    if tier is None:
        return []
    out: list[dict[str, Any]] = tier.tiers_snapshot()
    return out


def _storage() -> dict[str, Any]:
    """Storage-fault plane state: per-TieredStore degraded read-through
    flags and quarantine/scrub counters, plus live background scrubbers
    (``sys.modules`` peeks — a scrape never allocates the singletons;
    the native proxy composes its own twin of this section)."""
    out: dict[str, Any] = {}
    tier = sys.modules.get("demodel_tpu_torch.tier")
    if tier is not None:
        rows = []
        for t in tier.tiers_snapshot():
            storage = t.get("storage")
            if storage:
                rows.append({"name": t.get("name"), **storage})
        if rows:
            out["tiers"] = rows
    scrub = sys.modules.get("demodel_tpu_torch.scrub")
    if scrub is not None:
        out["scrubbers"] = scrub.snapshot()
    return out


def _generation() -> dict[str, Any]:
    """Token-serving plane state: the installed engine's running/waiting
    sequences, token counters, admission accounting, and KV pool
    occupancy next to its budget (``sys.modules`` peek — a node that
    never booted an engine reports an empty section and never pays the
    serve plane's torch import)."""
    serve = sys.modules.get("demodel_tpu_torch.serve")
    if serve is None:
        return {}
    engine = serve.current()
    if engine is None:
        return {}
    out: dict[str, Any] = engine.describe()
    return out


def _gossip() -> dict[str, Any]:
    peer = sys.modules.get("demodel_tpu_torch.parallel.peer")
    if peer is None:
        return {}
    gossip = peer.PeerGossip._shared  # noqa: SLF001 — read-only peek:
    # shared() would CREATE the registry; statusz must observe, not allocate
    if gossip is None:
        return {}
    out: dict[str, Any] = gossip.describe()
    return out


def _active_tuner() -> Any:
    """The live adaptive-pull tuner, if one is running (``sys.modules``
    peek — never allocates; a scrape must observe the tuner registry,
    not create it)."""
    tuner = sys.modules.get("demodel_tpu_torch.sink.tuner")
    if tuner is None:
        return None
    return tuner.current()


#: the tunable knobs every plane reports effectively-resolved — "what is
#: this node actually running with" must never require reading env docs.
#: Every value resolves through the owner's resolver (never a copied
#: literal, which drifts the moment the owner changes) in a module that
#: imports no torch: utils.env and utils.faults.
def _knob_rows() -> list[tuple[str, Any]]:
    from demodel_tpu_torch.utils import env, faults
    from demodel_tpu_torch.utils.env import (
        default_peer_streams,
        default_pull_window_mb,
        env_int,
        tuner_enabled,
    )
    from demodel_tpu_torch.utils.metrics import _telemetry_ring_cap

    return [
        ("DEMODEL_PEER_STREAMS", default_peer_streams()),
        ("DEMODEL_SINK_PREFETCH",
         # the unset default is resolved at pull time in sink.remote:
         # report "auto" instead of importing it here
         env_int("DEMODEL_SINK_PREFETCH", -1, minimum=0)
         if os.environ.get("DEMODEL_SINK_PREFETCH", "").strip()
         else "auto"),
        ("DEMODEL_PULL_WINDOW_MB", default_pull_window_mb()),
        ("DEMODEL_SINK_BUFFER_MB",
         # the one literal left: the owner (sink.streaming) resolves it
         # inline and imports torch — keep the default in sync
         env_int("DEMODEL_SINK_BUFFER_MB", 1024, minimum=1)),
        ("DEMODEL_RETRY_MAX", faults._default_max_attempts()),
        ("DEMODEL_RETRY_DEADLINE", int(faults._default_deadline())),
        ("DEMODEL_BREAKER_THRESHOLD", faults.default_breaker_threshold()),
        ("DEMODEL_BREAKER_COOLDOWN",
         int(faults.default_breaker_cooldown())),
        ("DEMODEL_SWARM_CHUNK_MB", env.default_swarm_chunk_mb()),
        ("DEMODEL_SWARM_FILL_TIMEOUT",
         int(env.default_swarm_fill_timeout())),
        ("DEMODEL_SWARM_ORIGIN_STREAMS",
         env.default_swarm_origin_streams()),
        ("DEMODEL_SWARM_REAP", env.swarm_reap_enabled()),
        ("DEMODEL_TIER_RAM_MB", env.default_tier_ram_mb()),
        ("DEMODEL_CACHE_MAX_GB", env.cache_max_gb()),
        ("DEMODEL_TUNER", tuner_enabled()),
        ("DEMODEL_TELEMETRY_RING", _telemetry_ring_cap()),
        ("DEMODEL_TELEMETRY_ARCHIVE", env.telemetry_archive_dir() or "off"),
        ("DEMODEL_TELEMETRY_RETAIN_MB", env.telemetry_retain_mb()),
        ("DEMODEL_TELEMETRY_RETAIN_HOURS", env.telemetry_retain_hours()),
        ("DEMODEL_PROFILE_HZ", env.profile_hz()),
        ("DEMODEL_PROFILE_MAX_STACKS", env.profile_max_stacks()),
        ("DEMODEL_PROFILE_WINDOW_S", env.profile_window_s()),
        ("DEMODEL_STORE_REPROBE_SECS", env.store_reprobe_secs()),
        ("DEMODEL_SCRUB_INTERVAL_SECS", env.scrub_interval_secs()),
        ("DEMODEL_SCRUB_RATE_MB_S", env.scrub_rate_mb_s()),
        ("DEMODEL_GEN_BLOCK", env.gen_block_tokens()),
        ("DEMODEL_GEN_KV_MB", env.gen_kv_mb()),
        ("DEMODEL_GEN_MAX_BATCH", env.gen_max_batch()),
        ("DEMODEL_GEN_QUEUE", env.gen_queue_limit()),
        ("DEMODEL_GEN_RETRY_AFTER", env.gen_retry_after_s()),
        ("DEMODEL_GEN_MAX_NEW", env.gen_max_new_tokens()),
    ]


#: env knob → the live tuner attribute that may be overriding it
_TUNED_KNOBS = {
    "DEMODEL_PEER_STREAMS": "streams",
    "DEMODEL_PULL_WINDOW_MB": "window_mb",
    "DEMODEL_SINK_PREFETCH": "prefetch_depth",
}


def effective_config() -> dict[str, dict[str, Any]]:
    """Each tunable knob's EFFECTIVE value and where it came from:
    ``tuner`` (a live adaptive tuner is overriding it), ``env`` (the
    operator pinned it), or ``default``."""
    tuner = _active_tuner()
    # ONE consistent read of the live tuner state: snapshot() serializes
    # with the tick thread's writes — per-attribute getattr reads could
    # mix two adjacent decisions' knob values in one config document
    snap: dict[str, Any] = tuner.snapshot() if tuner is not None else {}
    out: dict[str, dict[str, Any]] = {}
    for env_var, resolved in _knob_rows():
        source = "env" if os.environ.get(env_var, "").strip() else "default"
        value: Any = resolved
        attr = _TUNED_KNOBS.get(env_var)
        if attr is not None and attr in snap:
            value, source = snap[attr], "tuner"
        out[env_var] = {"value": value, "source": source}
    return out


def _profiler() -> dict[str, Any] | None:
    """The continuous profiler's live counters (sys.modules peek — a
    scrape must never be what starts the sampler thread)."""
    prof = sys.modules.get("demodel_tpu_torch.utils.profiler")
    if prof is None:
        return None
    out: dict[str, Any] | None = prof.describe()
    return out


def _telemetry_summary() -> dict[str, Any]:
    """The statusz-sized slice of the telemetry plane: windowed p99s per
    histogram family plus per-series counter rates with their labels
    intact — the fleet per-peer table joins breaker states against these
    (the full document lives at ``/debug/telemetry``)."""
    tel = metrics.HUB.telemetry().summary()
    return {
        "snapshots": tel["snapshots"],
        "windows_s": tel["windows_s"],
        "p99": {
            name: {w: windows[w]["p99"] for w in windows}
            for name, windows in tel["hist"].items()
        },
        "rates": tel["rates"],
    }


def snapshot(extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """The statusz document. ``extra`` lets a server add its own section
    (registered models, bind address) without forking the schema."""
    recorder = trace.recorder()
    doc: dict[str, Any] = {
        "statusz": SCHEMA_VERSION,
        "pid": os.getpid(),
        "time": time.time(),
        "uptime_sec": round(time.monotonic() - _START_MONOTONIC, 3),
        "start_time": _START_WALL,
        "trace": {
            "mode": trace.mode(),
            "buffer_spans": len(trace.buffer()),
            "recorder_spans": len(recorder),
            "recorder_dropped": recorder.dropped,
            "last_dump": trace._get_state().last_dump,  # noqa: SLF001 —
            # the one writer of this field is dump_recorder in the same
            # package; exposing a public accessor for one read is noise
        },
        "inflight_spans": trace.inflight_tree(),
        "breakers": _breakers(),
        "budgets": _budgets(),
        "swarm": _swarm(),
        "tiers": _tiers(),
        "storage": _storage(),
        "generation": _generation(),
        "gossip": _gossip(),
        "config": effective_config(),
        "profiler": _profiler(),
        "telemetry": _telemetry_summary(),
        "counters": metrics.HUB.snapshot(),
        "gauges": metrics.HUB.gauges(),
    }
    if extra:
        doc.update(extra)
    return doc
