"""HuggingFace Hub adapter (the port of ``demodel_tpu/registry/hf.py``).

The Hub REST API (``/api/models/{repo}/revision/{rev}``), the
``/{repo}/resolve/{rev}/{file}`` fetch path with its 302-to-CDN redirect
for LFS blobs, and the ETag/X-Repo-Commit metadata convention.
"""

from __future__ import annotations

import fnmatch
import time

from demodel_tpu_torch.registry.base import (Fetcher, FileArtifact,
                                             PullReport, parallel_fetch)
from demodel_tpu_torch.store import Store, key_for_uri
from demodel_tpu_torch.utils.logging import get_logger

log = get_logger("hf")

DEFAULT_ENDPOINT = "https://huggingface.co"

#: File classes huggingface-cli pulls for a model snapshot; weights +
#: tokenizer + configs. Binary-format auxiliaries excluded by default.
DEFAULT_PATTERNS = (
    "*.safetensors", "*.safetensors.index.json", "*.json", "*.txt",
    "*.model", "tokenizer*", "*.gguf",
)

#: File classes a dataset snapshot carries (``datasets/`` repos): data
#: shards plus loading metadata.
DATASET_PATTERNS = (
    "*.parquet", "*.arrow", "*.csv", "*.jsonl", "*.json", "*.txt",
    "README.md", "dataset_infos.json",
)


class HFRegistry:
    def __init__(
        self,
        store: Store,
        endpoint: str = DEFAULT_ENDPOINT,
        token: str | None = None,
        ca: str | None = None,
        peers=None,
    ):
        self.endpoint = endpoint.rstrip("/")
        headers = {"User-Agent": "demodel-tpu/0.1"}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        self.fetcher = Fetcher(store, ca=ca, headers=headers, peers=peers)

    # -- API ------------------------------------------------------------
    def repo_info(self, repo_id: str, revision: str = "main") -> dict:
        """``GET /api/models/{repo}/revision/{rev}`` → repo JSON (sha,
        siblings[].rfilename, …). Dataset repos live under a distinct
        namespace — ``/api/datasets/{repo}/revision/{rev}`` and
        ``/datasets/{repo}/resolve/...`` — selected here by the
        ``datasets/`` repo-id prefix, mirroring the Hub's URL shape."""
        if repo_id.startswith("datasets/"):
            api = f"{self.endpoint}/api/{repo_id}/revision/{revision}"
        else:
            api = f"{self.endpoint}/api/models/{repo_id}/revision/{revision}"
        return self.fetcher.get_json(api)

    def list_files(self, repo_id: str, revision: str = "main") -> list[str]:
        info = self.repo_info(repo_id, revision)
        return [s["rfilename"] for s in info.get("siblings", [])]

    def resolve_url(self, repo_id: str, revision: str, filename: str) -> str:
        return f"{self.endpoint}/{repo_id}/resolve/{revision}/{filename}"

    # -- pulls ----------------------------------------------------------
    #: extensions stored as LFS blobs on the Hub — a HEAD of their resolve
    #: URL yields the blob sha256 (X-Linked-Etag) before any bytes move
    LFS_SUFFIXES = (".safetensors", ".gguf", ".bin", ".pt", ".onnx", ".h5",
                    ".parquet", ".arrow")

    def fetch_file(self, repo_id: str, revision: str, filename: str) -> FileArtifact:
        """Fetch one file via the resolve path (redirects followed; LFS
        blobs land via their CDN URL, stored under the canonical resolve
        URI so re-pulls key consistently).

        For LFS files a digest probe runs first, so bytes already held
        locally under another key are reused by content address instead
        of re-transferred, and the transfer is verified."""
        url = self.resolve_url(repo_id, revision, filename)
        expected = None
        if filename.endswith(self.LFS_SUFFIXES) and not self.fetcher.store.has(
            key_for_uri(url)
        ):
            expected = self.fetcher.probe_lfs_digest(url)
        return self.fetcher.fetch(url, name=filename, expected_digest=expected)

    def pull(
        self,
        repo_id: str,
        revision: str = "main",
        allow_patterns: tuple[str, ...] | None = None,
        on_file=None,
    ) -> PullReport:
        """Pull a snapshot. ``on_file(artifact)`` fires from the fetch
        worker as each file completes — the streaming-sink hook.
        ``allow_patterns`` defaults per namespace: model file classes, or
        dataset shards/metadata for ``datasets/`` repos."""
        if allow_patterns is None:
            allow_patterns = (DATASET_PATTERNS
                              if repo_id.startswith("datasets/")
                              else DEFAULT_PATTERNS)
        t0 = time.perf_counter()
        info = self.repo_info(repo_id, revision)
        commit = info.get("sha", revision)
        files = [s["rfilename"] for s in info.get("siblings", [])]
        wanted = [
            f for f in files
            if any(fnmatch.fnmatch(f, p) for p in allow_patterns)
        ]
        log.info("pulling %s@%s: %d/%d files", repo_id, revision, len(wanted), len(files))
        report = PullReport(source="hf", name=repo_id, revision=commit)
        # pin to the resolved commit so the snapshot is immutable; shards
        # fetch concurrently (base.parallel_fetch), report order preserved
        def fetch_one(f):
            art = self.fetch_file(repo_id, commit, f)
            if on_file is not None:
                on_file(art)
            return art

        report.files = parallel_fetch(wanted, fetch_one)
        report.secs = time.perf_counter() - t0
        return report
