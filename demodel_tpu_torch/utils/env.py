"""Degrade-not-crash env parsing (the serving and pull knobs of
``demodel_tpu.utils.env``, same names and defaults).

A malformed value logs a warning and yields the default.
"""

from __future__ import annotations

import os

from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("env")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def env_int(name: str, default: int, minimum: int | None = None) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        log.warning("%s=%r is not an integer; using default %d", name, raw,
                    default)
        return default
    if minimum is not None and val < minimum:
        log.warning("%s=%d below minimum %d; clamping", name, val, minimum)
        return minimum
    return val


def env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    log.warning("%s=%r is not a boolean; using default %s", name, raw,
                default)
    return default


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a float; using default %s", name, raw,
                    default)
        return default


def env_flag(name: str) -> bool | None:
    """A tri-state switch: True for 1/true/yes/on, False for
    0/false/no/off, None when unset or unparseable (the default policy
    decides)."""
    raw = os.environ.get(name, "").strip().lower()
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    return None


def flash_attn_env() -> bool | None:
    """``DEMODEL_FLASH_ATTN``: the caller's explicit choice of the fused
    attention kernel (1/true/yes/on) or the einsum path (0/false/no/off);
    None when unset or unparseable — the default policy decides."""
    return env_flag("DEMODEL_FLASH_ATTN")


def gen_block_tokens() -> int:
    """``DEMODEL_GEN_BLOCK``: tokens per KV-cache block in the paged
    generation pool (16, the vLLM default)."""
    return env_int("DEMODEL_GEN_BLOCK", 16, minimum=1)


def gen_kv_mb() -> int:
    """``DEMODEL_GEN_KV_MB``: byte budget (MB) for the paged KV pool."""
    return env_int("DEMODEL_GEN_KV_MB", 256, minimum=1)


def gen_max_batch() -> int:
    """``DEMODEL_GEN_MAX_BATCH``: running-sequence cap — one decode step
    advances at most this many sequences together."""
    return env_int("DEMODEL_GEN_MAX_BATCH", 8, minimum=1)


def gen_queue_limit() -> int:
    """``DEMODEL_GEN_QUEUE``: waiting-queue depth past which admission
    answers 503 + Retry-After."""
    return env_int("DEMODEL_GEN_QUEUE", 64, minimum=1)


def gen_retry_after_s() -> int:
    """``DEMODEL_GEN_RETRY_AFTER``: the Retry-After hint (seconds) a
    queue-overflow 503 carries."""
    return env_int("DEMODEL_GEN_RETRY_AFTER", 1, minimum=1)


def gen_max_new_tokens() -> int:
    """``DEMODEL_GEN_MAX_NEW``: per-request cap on generated tokens —
    admission reserves KV blocks for the worst case (prompt + this cap)."""
    return env_int("DEMODEL_GEN_MAX_NEW", 256, minimum=1)


def cache_max_gb() -> int:
    """``DEMODEL_CACHE_MAX_GB``: the disk tier's byte budget in GB
    (0 = unbounded), enforced after a pull through ``Store.gc``."""
    return env_int("DEMODEL_CACHE_MAX_GB", 0, minimum=0)


def available_cpus() -> int:
    """CPUs this process may run on (affinity-aware: a container pinned
    to 1 CPU of a 64-core host counts 1)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def default_peer_streams() -> int:
    """``DEMODEL_PEER_STREAMS``: connections per large-object peer
    transfer; unset, the core count clamped to 1..8 (extra sockets on a
    1-core host only contend)."""
    return env_int("DEMODEL_PEER_STREAMS", max(1, min(8, available_cpus())),
                   minimum=1)


def default_pull_window_mb() -> int:
    """``DEMODEL_PULL_WINDOW_MB``: fetch window granularity of a sharded
    pull (32: large enough to amortize per-window overhead, small enough
    that one flaky window's retry stays cheap)."""
    return env_int("DEMODEL_PULL_WINDOW_MB", 32, minimum=1)


def tuner_enabled() -> bool:
    """``DEMODEL_TUNER``: the adaptive pull tuner, on unless disabled
    (``=0`` keeps every knob at its fixed default)."""
    return env_bool("DEMODEL_TUNER", True)


def default_swarm_chunk_mb() -> int:
    return env_int("DEMODEL_SWARM_CHUNK_MB", 8, minimum=1)


def default_swarm_fill_timeout() -> float:
    return float(env_int("DEMODEL_SWARM_FILL_TIMEOUT", 60, minimum=1))


def default_swarm_origin_streams() -> int:
    return env_int("DEMODEL_SWARM_ORIGIN_STREAMS", 1, minimum=1)


def swarm_reap_enabled() -> bool:
    """``DEMODEL_SWARM_REAP=0`` keeps every chunk on the board until
    ``close()`` (a warm standby that wants to keep serving)."""
    return env_bool("DEMODEL_SWARM_REAP", True)


def default_tier_ram_mb() -> int:
    """``DEMODEL_TIER_RAM_MB``: the host-RAM tier's byte budget in MB,
    which swarm chunk boards charge."""
    return env_int("DEMODEL_TIER_RAM_MB", 256, minimum=1)


def restore_workers() -> int:
    """``DEMODEL_RESTORE_WORKERS``: tensors a network restore fetches and
    places at once (8)."""
    return env_int("DEMODEL_RESTORE_WORKERS", 8, minimum=1)


def advertise_host() -> str | None:
    """``DEMODEL_ADVERTISE_HOST``: the name (``h``, ``h:p``, an IPv6
    literal bare or bracketed, with or without a port) a restore node
    advertises as its tensor data endpoint; None when unset."""
    return os.environ.get("DEMODEL_ADVERTISE_HOST", "").strip() or None


def scrub_interval_secs() -> int:
    """``DEMODEL_SCRUB_INTERVAL_SECS``: seconds between background
    scrubber slices re-digesting committed objects (0, the default,
    disables the scrubber on both planes)."""
    return env_int("DEMODEL_SCRUB_INTERVAL_SECS", 0, minimum=0)


def scrub_rate_mb_s() -> int:
    """``DEMODEL_SCRUB_RATE_MB_S``: the scrubber's re-digest budget in MB
    per second; each slice reads at most ``rate × interval`` bytes."""
    return env_int("DEMODEL_SCRUB_RATE_MB_S", 8, minimum=1)


def store_reprobe_secs() -> int:
    """``DEMODEL_STORE_REPROBE_SECS``: how often a node in degraded
    read-through mode re-probes the store with a small real write (10)."""
    return env_int("DEMODEL_STORE_REPROBE_SECS", 10, minimum=1)


def telemetry_archive_dir() -> str:
    """``DEMODEL_TELEMETRY_ARCHIVE``: directory of the durable telemetry
    archive (:mod:`demodel_tpu_torch.utils.retention`); unset disables
    the retention plane (no import, no flusher thread)."""
    return os.environ.get("DEMODEL_TELEMETRY_ARCHIVE", "").strip()


def telemetry_retain_mb() -> int:
    """``DEMODEL_TELEMETRY_RETAIN_MB``: byte budget of the archived
    segments; the oldest are evicted past it (64)."""
    return env_int("DEMODEL_TELEMETRY_RETAIN_MB", 64, minimum=1)


def telemetry_retain_hours() -> int:
    """``DEMODEL_TELEMETRY_RETAIN_HOURS``: age budget of the archived
    segments (72)."""
    return env_int("DEMODEL_TELEMETRY_RETAIN_HOURS", 72, minimum=1)


def profile_hz() -> int:
    """``DEMODEL_PROFILE_HZ``: the sampling profiler's rate (19, off the
    10/100 Hz beat of periodic work)."""
    return env_int("DEMODEL_PROFILE_HZ", 19, minimum=1)


def profile_max_stacks() -> int:
    """``DEMODEL_PROFILE_MAX_STACKS``: distinct folded stacks the
    profiler keeps; past it new stacks fold into ``(other)`` (2048)."""
    return env_int("DEMODEL_PROFILE_MAX_STACKS", 2048, minimum=16)


def profile_window_s() -> int:
    """``DEMODEL_PROFILE_WINDOW_S``: seconds per profile window rolled
    into the telemetry archive (60)."""
    return env_int("DEMODEL_PROFILE_WINDOW_S", 60, minimum=5)
