"""Pull orchestration: registry → store → device (the port of
``demodel_tpu/delivery.py``: the HuggingFace and Ollama sources, peers on
one hop).

:func:`pull_to_hbm` pulls a model through the content-addressed store and
streams its weights onto the device as the files arrive, then records
the pull's manifest in the store; :func:`pull` is the same with the
device sink optional. With peers, each file comes from a peer node that
holds it before the upstream registry is asked; it lands in the store,
verified against its digest, and the sink places it from there as any
other file. :func:`synthesize_manifest` writes the same record for a
model that foreign clients pulled through the MITM proxy, so such a node
seeds sharded pulls (``sink/remote.py``) too; :func:`materialize` writes
a record's files out under their names.
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


#: file suffixes that hold weights: a synthesized manifest never leaves
#: one of these out silently
_WEIGHT_SUFFIXES = (".safetensors", ".bin", ".pt", ".pth", ".gguf",
                    ".onnx", ".msgpack", ".h5")


def _copy_verified(store: Store, src_key: str, dst_key: str, sha: str,
                   uri: str, mismatch: str) -> None:
    """Copy ``src_key`` to ``dst_key`` (a synthesized entry for ``uri``)
    while hashing; abort and raise ``IOError(mismatch)`` when the bytes do
    not hash to ``sha`` (``sha`` empty: commit under the digest just
    computed)."""
    w = store.begin(dst_key)
    try:
        for chunk in store.stream(src_key):
            w.append(chunk)
        if sha and w.digest() != sha:
            w.abort(keep_partial=False)
            raise IOError(mismatch)
        w.commit({"uri": uri, "sha256": sha or w.digest(),
                  "synthesized": True})
    finally:
        w.abort(keep_partial=False)  # no-op once committed or aborted


def synthesize_manifest(store: Store, model: str, source: str = "hf",
                        persist: bool = True,
                        include_private: bool = False) -> dict:
    """The model-manifest record of a model that clients pulled through
    the MITM proxy: no first-party pull needed.

    The proxy cached each file URL-keyed: small files whole under their
    ``{model}/resolve/{rev}/{name}`` URI, LFS files as a 30x stub whose
    ``x-linked-etag`` names the content digest plus the object under its
    CDN URI. This publishes each LFS object under
    ``demodel://synth/{model}/{name}`` (a hardlink, zero copy) and
    persists the record :func:`pull` writes, so the node can seed a
    sharded pull (``sink/remote.py``) as if it had pulled first-party.

    An auth-scoped (gated-repo) entry is never served on the peer plane,
    so it is republished under a public synth key (a copy that checks its
    digest) only with ``include_private``. Without it, a gated weight
    file, or nothing public at all, raises ``PermissionError``; a gated
    auxiliary file is left out with a warning. Raises
    ``FileNotFoundError`` when no cached file matches ``model``.
    """
    import re

    if source == "ollama":
        return _synthesize_ollama_manifest(store, model, persist=persist)
    pat = re.compile(re.escape(model) + r"/resolve/([^/]+)/(.+)$")
    files: dict[str, dict] = {}  # filename → entry (first revision wins)
    skipped_private: list[str] = []
    for key in store.list():
        meta = store.meta(key) or {}
        uri = meta.get("uri", "")
        m = pat.search(uri.split("?", 1)[0])
        if not m:
            continue
        rev, name = m.group(1), m.group(2)
        status = int(meta.get("status", 200) or 200)
        headers = meta.get("headers", {}) or {}
        if 301 <= status <= 308:
            linked = (headers.get("x-linked-etag", "") or "").strip('"')
            if len(linked) != 64 or not store.has_digest(linked):
                continue
            synth_key = key_for_uri(f"demodel://synth/{model}/{name}")
            if not store.has(synth_key):
                store.materialize(synth_key, linked, {
                    "uri": uri, "sha256": linked, "synthesized": True,
                })
            entry_key, sha = synth_key, linked
        elif status == 200 and store.size(key) > 0:
            entry_key, sha = key, meta.get("sha256", "")
            if store.is_private(key):
                if not include_private:
                    skipped_private.append(name)
                    continue
                entry_key = key_for_uri(f"demodel://synth/{model}/{name}")
                if not store.has(entry_key):
                    _copy_verified(
                        store, key, entry_key, sha, uri,
                        f"cached {name} does not match its recorded digest")
        else:
            continue
        files.setdefault(name, {
            "name": name, "key": entry_key, "size": store.size(entry_key),
            "sha256": sha, "revision": rev, "media_type": "",
        })
    # a gated copy of a file whose public copy is in the record is no loss
    skipped_private = [n for n in skipped_private if n not in files]
    skipped_weights = [n for n in skipped_private
                       if n.endswith(_WEIGHT_SUFFIXES)]
    if skipped_weights or (skipped_private and not files):
        what = (f"including weights: {', '.join(sorted(skipped_weights)[:5])}"
                if skipped_weights else
                f"and nothing public is cached: "
                f"{', '.join(sorted(skipped_private)[:5])}")
        raise PermissionError(
            f"{len(skipped_private)} cached file(s) for {model} are "
            f"auth-scoped, {what} — rerun with include_private=True / "
            "--include-private to explicitly republish them on the "
            "public peer plane. (Note: a logged-in hf client sends its "
            "token on PUBLIC repos too, marking them auth-scoped here; "
            "if this repo is public, --include-private is safe.)")
    if skipped_private:
        log.warning(
            "manifest for %s omits %d auth-scoped (gated-repo) file(s): "
            "%s — pass include_private=True / --include-private to "
            "republish them on the public peer plane", model,
            len(skipped_private), ", ".join(sorted(skipped_private)[:5]))
    if not files:
        raise FileNotFoundError(
            f"no cached objects match {model}/resolve/ — was the model "
            "pulled through this proxy?")
    record = {
        "name": model, "source": source, "synthesized": True,
        "files": sorted(files.values(), key=lambda f: f["name"]),
    }
    if persist:
        _persist_manifest(store, manifest_key(source, model), record, set())
        log.info("synthesized manifest for %s: %d files from the proxy "
                 "cache", model, len(files))
    return record


def _synthesize_ollama_manifest(store: Store, model: str,
                                persist: bool = True) -> dict:
    """:func:`synthesize_manifest` for Ollama: the proxy cached the
    registry-v2 manifest under its ``/v2/{name}/manifests/{tag}`` URI and
    each layer under its ``blobs/{digest}`` URI. Each layer of the
    manifest maps to its cached blob key; a layer cached only under a
    credentialed request is published under a synth key, zero copy where
    the digest is indexed, else as a copy re-hashed against the manifest
    digest. Registry-v2 tokens are mandatory even on public pulls, so
    auth presence carries no gating signal here: a republished
    token-scoped layer logs a warning instead."""
    from demodel_tpu_torch.registry.ollama import normalize_name

    name, tag = normalize_name(model)
    suffix = f"/v2/{name}/manifests/{tag}"
    manifest = manifest_uri = None
    for key in store.list():
        meta = store.meta(key) or {}
        uri = meta.get("uri", "")
        if not uri.split("?", 1)[0].endswith(suffix):
            continue
        try:
            manifest = json.loads(b"".join(store.stream(key)).decode())
            manifest_uri = uri
            break
        except ValueError:
            continue
    if manifest is None:
        raise FileNotFoundError(
            f"no cached registry-v2 manifest matches {suffix} — was "
            "the model pulled through this proxy?")
    base = manifest_uri.split("?", 1)[0][: -len(suffix)]
    by_uri: dict[str, str] = {}
    for key in store.list():
        meta = store.meta(key) or {}
        uri = (meta.get("uri") or "").split("?", 1)[0]
        if f"/v2/{name}/blobs/" in uri:
            by_uri.setdefault(uri, key)
    files = []
    republished_scoped = 0
    layers = list(manifest.get("layers", []))
    if manifest.get("config"):
        layers.append(manifest["config"])
    for layer in layers:
        digest = layer.get("digest", "")
        sha = digest.split(":", 1)[-1]
        blob_uri = f"{base}/v2/{name}/blobs/{digest}"
        blob_key = key_for_uri(blob_uri)
        if not store.has(blob_key):
            src_key = by_uri.get(blob_uri)
            # a digest-indexed copy of the same bytes beats a credentialed
            # one: it publishes zero-copy
            if store.has_digest(sha):
                src_key = None
            elif src_key is None:
                raise FileNotFoundError(
                    f"layer {digest[:19]} of {model} not in the cache")
            blob_key = key_for_uri(f"demodel://synth/{model}/{sha}")
            if not store.has(blob_key):
                if src_key is None:
                    store.materialize(blob_key, sha, {
                        "uri": blob_uri, "sha256": sha, "synthesized": True})
                else:
                    if store.is_private(src_key):
                        republished_scoped += 1
                    _copy_verified(
                        store, src_key, blob_key, sha, blob_uri,
                        f"cached layer {digest[:19]} does not match its "
                        "manifest digest")
        files.append({
            "name": sha,
            "key": blob_key,
            "size": int(layer.get("size") or store.size(blob_key)),
            "sha256": sha,
            "media_type": layer.get("mediaType", ""),
        })
    if republished_scoped:
        log.warning(
            "ollama manifest for %s republished %d token-scoped layer(s) "
            "on the public peer plane (registry-v2 bearer tokens are "
            "protocol-mandatory, so auth presence does not imply a "
            "private registry — do NOT run `manifest` against models "
            "pulled from a credentials-gated registry)",
            model, republished_scoped)
    record = {"name": model, "source": "ollama", "synthesized": True,
              "files": sorted(files, key=lambda f: f["name"])}
    if persist:
        _persist_manifest(store, manifest_key("ollama", model), record,
                          set())
        log.info("synthesized ollama manifest for %s: %d layers", model,
                 len(files))
    return record


def materialize(report: dict, store: Store, dest: Path) -> list[Path]:
    """Write a pulled model's files out of the store into ``dest`` under
    their original names (``/`` and ``:`` as ``_``): what a foreign tool
    such as ``transformers.from_pretrained`` expects on disk. ``report``
    is a pull report or a manifest record."""
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    out = []
    for f in report["files"]:
        path = dest / f["name"].replace(":", "_").replace("/", "_")
        with open(path, "wb") as fh:
            for chunk in store.stream(f["key"]):
                fh.write(chunk)
        out.append(path)
    return out
