"""Pull orchestration: registry → store → device (the port of
``demodel_tpu/delivery.py``: the HuggingFace and Ollama sources, peers on
one hop).

:func:`pull_to_hbm` pulls a model through the content-addressed store and
streams its weights onto the device as the files arrive, then records
the pull's manifest in the store; :func:`pull` is the same with the
device sink optional. With peers, each file comes from a peer node that
holds it before the upstream registry is asked; it lands in the store,
verified against its digest, and the sink places it from there as any
other file. The swarm (``sink/remote.py``) comes with a later slice.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time
from pathlib import Path

from demodel_tpu_torch.config import ProxyConfig
from demodel_tpu_torch.parallel.mesh import Mesh
from demodel_tpu_torch.store import Store, key_for_uri
from demodel_tpu_torch.utils import metrics
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("delivery")

#: the default Ollama registry (``OLLAMA_REGISTRY`` overrides it)
OLLAMA_REGISTRY = "https://registry.ollama.ai"


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


def pull(
    model: str,
    cfg: ProxyConfig,
    source: str = "hf",
    sink: str = "cache",
    revision: str = "main",
    endpoint: str | None = None,
    store: Store | None = None,
    mesh: Mesh | None = None,
    peers: list[str] | None = None,
) -> dict:
    """Pull ``model`` into the store (``sink="cache"``), and with
    ``sink="tpu"`` also stream its weights onto the device. ``peers``:
    base URLs of peer nodes asked before the upstream registry. Returns
    the pull's report."""
    report, _ = pull_to_hbm(
        model, cfg, source=source, revision=revision, endpoint=endpoint,
        store=store, mesh=mesh, peers=peers, deliver=(sink == "tpu"))
    return report


def _registry(source: str, store: Store, cfg: ProxyConfig,
              endpoint: str | None, **fetch_kw):
    if source == "hf":
        from demodel_tpu_torch.registry.hf import HFRegistry

        return HFRegistry(
            store,
            endpoint=endpoint or os.environ.get("HF_ENDPOINT",
                                                "https://huggingface.co"),
            token=os.environ.get("HF_TOKEN"), ca=cfg.upstream_ca,
            **fetch_kw)
    if source == "ollama":
        from demodel_tpu_torch.registry.ollama import OllamaRegistry

        return OllamaRegistry(
            store,
            endpoint=endpoint or os.environ.get("OLLAMA_REGISTRY",
                                                OLLAMA_REGISTRY),
            ca=cfg.upstream_ca, **fetch_kw)
    raise ValueError(f"unknown source {source!r}")


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
    defer_cache_commit: bool = False,
):
    """Pull ``model`` and stream its weights onto the device as files
    arrive.

    Fetch workers overlap with device landing
    (:mod:`demodel_tpu_torch.sink.streaming`), so the wall-clock is
    max(network, host-to-device), not the sum. Returns ``(report_dict,
    Placement | None)``; the mesh defaults to the CUDA device.

    ``peers`` (default: ``DEMODEL_PEERS``, comma-separated) are asked for
    each file first; what no peer holds, or a peer fails to serve, comes
    from the upstream registry (the report's ``from_peer`` says which).
    ``defer_cache_commit=True`` returns once the placement is on the
    device: the manifest record, the tier budgets and the store close
    (this function must own the store) move to a background thread,
    joined by ``placement.finalize()``.
    """
    own_store = store is None
    if store is None:
        store = open_store(cfg)
    elif defer_cache_commit:
        # the background finalizer would write into a store the caller
        # could close first
        raise ValueError("defer_cache_commit=True requires pull_to_hbm to "
                         "own the store (omit the store= argument)")
    peer_set = None
    if peers is None:
        peers = [p for p in os.environ.get("DEMODEL_PEERS", "").split(",")
                 if p.strip()]
    if peers:
        from demodel_tpu_torch.parallel.peer import PeerGossip, PeerSet

        peer_set = PeerSet(peers)
        # enroll the peers for background index refresh: later locate
        # calls answer from gossip instead of a probe round per pull
        PeerGossip.shared().track(peers)
    sink_worker = None
    reg = None
    handed_off = False  # True once the background finalizer owns the rest
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

        reg = _registry(source, store, cfg, endpoint, peers=peer_set)
        if source == "hf":
            report = reg.pull(model, revision=revision, on_file=on_file)
        else:
            report = reg.pull(model, on_file=on_file)

        out = report.to_dict()
        mkey = manifest_key(source, model)
        metrics.HUB.inc("pulls_total")
        metrics.HUB.inc("pull_bytes_total", report.total_bytes)
        metrics.HUB.inc("pull_files_from_peer_total",
                        sum(1 for f in report.files if f.from_peer))
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
        if defer_cache_commit and placed is not None:
            fetcher = reg.fetcher

            def _finalize():
                try:
                    _persist_manifest(store, mkey, out, set())
                    _enforce_tier_budgets(store)
                except BaseException as e:  # noqa: BLE001 — at finalize()
                    placed.finalize_error = e
                finally:
                    fetcher.close()
                    store.close()

            placed.finalizer = threading.Thread(
                target=_finalize, daemon=True, name="delivery-finalize")
            placed.finalizer.start()
            handed_off = True
        else:
            _persist_manifest(store, mkey, out, set())
            _enforce_tier_budgets(store)
        return out, placed
    finally:
        if window is not None:
            window.stop()
        if sink_worker is not None:  # pull raised — abandon delivery
            sink_worker.cancel()
        if peer_set is not None:
            peer_set.close()
        if not handed_off:
            if reg is not None:
                reg.fetcher.close()
            if own_store:
                store.close()
