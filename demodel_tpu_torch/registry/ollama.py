"""Ollama / Docker-registry-v2 adapter (the port of
``demodel_tpu/registry/ollama.py``).

``ollama pull`` speaks registry-v2: the manifest at
``/v2/{name}/manifests/{tag}`` (schemaVersion 2,
``application/vnd.ollama.image.*`` layer media types, sha256 digests),
blobs by digest at ``/v2/{name}/blobs/{digest}``. This client walks the
same protocol into the content-addressed store, checking every layer's
sha256 and size; the GGUF layer (``application/vnd.ollama.image.model``)
goes on to the device sink through ``on_file``.
"""

from __future__ import annotations

import json
import time

from demodel_tpu_torch.registry.base import (Fetcher, PullReport,
                                             parallel_fetch)
from demodel_tpu_torch.store import Store
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("ollama")

DEFAULT_ENDPOINT = "https://registry.ollama.ai"


def normalize_name(name_tag: str) -> tuple[str, str]:
    """Ollama's name sugar → (repository, tag): bare names live under
    ``library/`` and the tag defaults to ``latest`` — ``llama3:8b`` →
    ``("library/llama3", "8b")``; ``user/model`` → ``("user/model",
    "latest")``."""
    name, _, tag = name_tag.partition(":")
    if "/" not in name:
        name = f"library/{name}"
    return name, tag or "latest"


class OllamaRegistry:
    def __init__(self, store: Store, endpoint: str = DEFAULT_ENDPOINT,
                 ca: str | None = None, peers=None):
        self.endpoint = endpoint.rstrip("/")
        self.fetcher = Fetcher(store, ca=ca,
                               headers={"User-Agent": "demodel-tpu/0.1"},
                               peers=peers)

    # -- registry-v2 URL shapes -----------------------------------------
    def manifest_url(self, name: str, tag: str) -> str:
        return f"{self.endpoint}/v2/{name}/manifests/{tag}"

    def blob_url(self, name: str, digest: str) -> str:
        return f"{self.endpoint}/v2/{name}/blobs/{digest}"

    def manifest(self, name: str, tag: str = "latest") -> dict:
        name, tag = normalize_name(f"{name}:{tag}" if ":" not in name
                                   else name)
        return self.fetcher.get_json(self.manifest_url(name, tag))

    def pull(self, name_tag: str, on_file=None) -> PullReport:
        """Pull the manifest, the config and every layer, each checked
        against its digest and size. ``on_file(artifact)`` fires per
        landed blob (the streaming sink's hook)."""
        t0 = time.perf_counter()
        name, tag = normalize_name(name_tag)
        # the manifest goes through the cache too; a memory-first fetch
        # returns its bytes in the landing buffer (the store commit runs
        # in the background, so reading it back by key would race it)
        m_art = self.fetcher.fetch(self.manifest_url(name, tag),
                                   name=f"{name}:{tag}")
        if m_art.buffer is not None:
            body = bytes(m_art.buffer)
        else:
            body = b"".join(self.fetcher.store.stream(m_art.key))
        manifest = json.loads(body.decode())
        if manifest.get("schemaVersion") != 2:
            raise ValueError(f"unsupported manifest schemaVersion: "
                             f"{manifest.get('schemaVersion')}")

        report = PullReport(source="ollama", name=name, revision=tag)
        report.files.append(m_art)
        blobs = []
        if "config" in manifest:
            blobs.append(manifest["config"])
        blobs.extend(manifest.get("layers", []))

        def fetch_blob(blob):
            digest = blob["digest"]
            algo, _, hexd = digest.partition(":")
            if algo != "sha256":
                raise ValueError(f"unsupported digest algorithm {algo}")
            art = self.fetcher.fetch(self.blob_url(name, digest),
                                     name=digest, expected_digest=hexd,
                                     media_type=blob.get("mediaType", ""))
            if "size" in blob and art.size != blob["size"]:
                raise IOError(f"size mismatch for {digest}: got {art.size}, "
                              f"want {blob['size']}")
            if on_file is not None:
                on_file(art)
            return art

        # layers fetch concurrently (GGUF blob, license, params); dedup by
        # digest first: a repeated layer would race two writers on one key
        unique: dict[str, dict] = {}
        for blob in blobs:
            unique.setdefault(blob["digest"], blob)
        fetched = dict(zip(unique, parallel_fetch(list(unique.values()),
                                                  fetch_blob)))
        report.files.extend(fetched[blob["digest"]] for blob in blobs)
        report.secs = time.perf_counter() - t0
        log.info("pulled %s:%s — %d blobs, %d bytes", name, tag,
                 len(report.files), report.total_bytes)
        return report
