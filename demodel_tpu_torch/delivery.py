"""Pull orchestration: registry → store → device (the port of
``demodel_tpu/delivery.py``, the HuggingFace source on one host).

:func:`pull_to_hbm` pulls a model through the content-addressed store and
streams its weights onto the device as the shards arrive, then records
the pull's manifest in the store. The Ollama source and pulls from peers
come with the next slice of the port (``ROADMAP.md`` A12b and A4) and
raise until then; nothing pulls without the peers it was asked for.
"""

from __future__ import annotations

import errno
import json
import os
import time
from pathlib import Path

from demodel_tpu_torch.config import ProxyConfig
from demodel_tpu_torch.parallel.mesh import Mesh
from demodel_tpu_torch.store import Store, key_for_uri
from demodel_tpu_torch.utils import metrics
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("delivery")

#: the ROADMAP entry that brings what this slice leaves out
NEXT_SLICE = ("the next slice of the port (ROADMAP.md Queue A: A12b's "
              "Ollama registry, A4's peers and swarm)")


def open_store(cfg: ProxyConfig) -> Store:
    """The delivery client and the proxy share one store root, so a model
    pulled by either path is a cache hit for the other."""
    return Store(cfg.cache_dir / "proxy")


def manifest_key(source: str, model: str) -> str:
    """Store key of a pulled model's manifest record."""
    return key_for_uri(f"demodel://models/{source}/{model}")


def _enforce_tier_budgets(store: Store) -> None:
    """Tier-budget-driven eviction after a pull (the disk tier to
    ``DEMODEL_CACHE_MAX_GB``)."""
    from demodel_tpu_torch import tier

    tier.shared(store).enforce()


def _persist_manifest(store: Store, mkey: str, out: dict,
                      failed_keys: set[str]) -> None:
    """Write the model-manifest record, omitting files whose cache commit
    failed (a durable manifest must never reference keys that aren't in
    the store)."""
    rec = out
    if failed_keys:
        rec = dict(out)
        rec["files"] = [f for f in out["files"] if f["key"] not in failed_keys]
        log.warning("manifest omits %d files whose cache commit failed",
                    len(out["files"]) - len(rec["files"]))
    if store.has(mkey):
        store.remove(mkey)
    body = json.dumps(rec).encode()
    meta = {"kind": "model-manifest", "model": rec["name"],
            "source": rec["source"]}
    try:
        store.put(mkey, body, meta)
    except OSError as e:
        if e.errno != errno.ENOSPC:
            raise
        # full disk on the manifest landing: evict to budget and retry
        # once; a second ENOSPC loses only the durable record (the bytes
        # already reached their sink), which a re-pull rebuilds
        _enforce_tier_budgets(store)
        try:
            store.put(mkey, body, meta)
        except OSError as e2:
            if e2.errno != errno.ENOSPC:
                raise
            log.warning("manifest for %s not persisted: disk full even "
                        "after eviction (%s)", rec["name"], e2)


class _ProfileWindow:
    """``DEMODEL_PROFILE_DIR``: a ``torch.profiler`` window around the
    delivery (fetch overlap and the host-to-device copies), written as a
    Chrome trace into that directory. Tracing never breaks a pull: a
    profiler that cannot start or stop logs a warning."""

    def __init__(self, profile_dir: str):
        self.dir = Path(profile_dir)
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts)
            prof.__enter__()
            self.prof = prof
        except Exception as e:  # noqa: BLE001 — tracing must never break a pull
            log.warning("torch.profiler window not started: %s", e)

    def stop(self) -> None:
        if self.prof is None:
            return
        try:
            self.prof.__exit__(None, None, None)
            self.dir.mkdir(parents=True, exist_ok=True)
            path = self.dir / f"delivery-{os.getpid()}-{time.time_ns()}.json"
            self.prof.export_chrome_trace(str(path))
            log.info("delivery trace written to %s", path)
        except Exception as e:  # noqa: BLE001
            log.warning("torch.profiler window not written: %s", e)


def pull_to_hbm(
    model: str,
    cfg: ProxyConfig,
    source: str = "hf",
    revision: str = "main",
    endpoint: str | None = None,
    store: Store | None = None,
    mesh: Mesh | None = None,
    peers: list[str] | None = None,
    deliver: bool = True,
):
    """Pull ``model`` and stream its weights onto the device as shards
    arrive.

    Fetch workers overlap with device landing
    (:mod:`demodel_tpu_torch.sink.streaming`), so the wall-clock is
    max(network, host-to-device), not the sum. Returns ``(report_dict,
    Placement | None)``; the mesh defaults to the CUDA device.
    """
    if source != "hf":
        raise NotImplementedError(
            f"source {source!r} is not ported yet; it comes with "
            f"{NEXT_SLICE}")
    if peers is None:
        peers = [p for p in os.environ.get("DEMODEL_PEERS", "").split(",")
                 if p.strip()]
    if peers:
        raise NotImplementedError(
            f"pulls from peers ({', '.join(peers)}) are not ported yet; "
            f"they come with {NEXT_SLICE}")
    own_store = store is None
    if store is None:
        store = open_store(cfg)
    sink_worker = None
    reg = None
    profile_dir = os.environ.get("DEMODEL_PROFILE_DIR", "").strip()
    window = _ProfileWindow(profile_dir) if profile_dir and deliver else None
    if window is not None:
        window.start()
    t0 = time.perf_counter()
    try:
        on_file = None
        if deliver:
            from demodel_tpu_torch.sink.streaming import StreamingSink

            sink_worker = StreamingSink(store, mesh=mesh)
            on_file = sink_worker.submit

        from demodel_tpu_torch.registry.hf import HFRegistry

        reg = HFRegistry(
            store,
            endpoint=endpoint or os.environ.get("HF_ENDPOINT",
                                                "https://huggingface.co"),
            token=os.environ.get("HF_TOKEN"),
            ca=cfg.upstream_ca,
        )
        report = reg.pull(model, revision=revision, on_file=on_file)

        out = report.to_dict()
        mkey = manifest_key(source, model)
        metrics.HUB.inc("pulls_total")
        metrics.HUB.inc("pull_bytes_total", report.total_bytes)
        metrics.HUB.inc("pull_files_from_cache_total",
                        sum(1 for f in report.files if f.from_cache))
        placed = None
        if sink_worker is not None:
            placed = sink_worker.finish()
            sink_worker = None
            sink_secs = time.perf_counter() - t0
            out["tpu_sink"] = {
                "tensors": len(placed.arrays),
                "bytes": placed.total_bytes,
                "secs": round(sink_secs, 3),
                "mesh": str(placed.mesh_desc),
            }
            metrics.HUB.inc("sink_tensors_total", len(placed.arrays))
            metrics.HUB.inc("sink_bytes_total", placed.total_bytes)
            metrics.HUB.inc("sink_secs_total", sink_secs)
        _persist_manifest(store, mkey, out, set())
        _enforce_tier_budgets(store)
        return out, placed
    finally:
        if window is not None:
            window.stop()
        if sink_worker is not None:  # pull raised — abandon delivery
            sink_worker.cancel()
        if reg is not None:
            reg.fetcher.close()
        if own_store:
            store.close()
