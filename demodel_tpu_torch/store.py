"""Python wrapper over the C++ content-addressed chunk store (the port of
``demodel_tpu/store.py``, over the port's own build of the same library,
:mod:`demodel_tpu_torch.native`).

Bodies keyed per request URI under a 16-hex key, stored exactly as
transferred, with a JSON ``.meta`` header sidecar; resumable partial
writes, range reads and a running sha256 digest. A store root written by
either package reads the same through the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
from pathlib import Path
from typing import Iterator

from demodel_tpu_torch import native
from demodel_tpu_torch.utils import metrics as _m


def key_for_uri(uri: str) -> str:
    """16-hex store key: first 8 bytes of sha256(uri) — must match the C++
    ``dm::key_for_uri``."""
    return hashlib.sha256(uri.encode()).hexdigest()[:16]


# Test-only disk fault hook: when installed, store mutations and reads
# consult it before touching the native layer; the hook either returns (no
# fault) or raises OSError(ENOSPC/EIO/...). Production never installs one,
# so the cost is a single module-attribute load.
_fault_hook = None


def set_fault_hook(hook) -> None:
    """Install (or with ``None`` clear) the test-only disk fault hook."""
    global _fault_hook
    _fault_hook = hook


def _fault(op: str, key: str, **info) -> None:
    if _fault_hook is not None:
        _fault_hook(op, key, **info)


class StoreWriter:
    def __init__(self, lib: ctypes.CDLL, handle: int,
                 key: str | None = None):
        self._lib = lib
        self._h = handle
        self._open = True
        self._key = key

    def append(self, data: bytes) -> None:
        if self._key is not None:
            _fault("append", self._key, offset=self.offset, length=len(data))
        rc = self._lib.dm_writer_append(self._h, data, len(data))
        if rc != 0:
            raise OSError(-rc, "store append failed")

    @property
    def offset(self) -> int:
        return self._lib.dm_writer_offset(self._h)

    def digest(self) -> str:
        buf = ctypes.create_string_buffer(65)
        self._lib.dm_writer_digest(self._h, buf)
        return buf.value.decode()

    def commit(self, meta: dict) -> None:
        if self._key is not None:
            _fault("commit", self._key, offset=self.offset)
        rc = self._lib.dm_writer_commit(self._h, json.dumps(meta).encode())
        self._open = False
        if rc != 0:
            raise OSError(-rc, "store commit failed")

    def abort(self, keep_partial: bool = False) -> None:
        if self._open:
            self._lib.dm_writer_abort(self._h, 1 if keep_partial else 0)
            self._open = False


class RangeStoreWriter:
    """Positional writer over a preallocated partial (parallel range fetch).

    Threads call :meth:`pwrite` on disjoint ranges; :meth:`commit` verifies
    full coverage, hashes the assembled file in one pass, optionally checks
    an expected digest, and publishes atomically."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib = lib
        self._h = handle
        self._open = True

    def pwrite(self, data, offset: int) -> None:
        if isinstance(data, bytes):
            rc = self._lib.dm_rw_pwrite(self._h, data, len(data), offset)
        else:
            # numpy landing buffers pass their pointer — no bounce copy of
            # a multi-GB shard just to satisfy ctypes
            view = memoryview(data).cast("B")
            rc = self._lib.dm_rw_pwrite(
                self._h,
                (ctypes.c_char * len(view)).from_buffer(view), len(view), offset,
            )
        if rc != 0:
            raise OSError(-rc, "range write failed")

    @property
    def written(self) -> int:
        return self._lib.dm_rw_written(self._h)

    def commit(self, meta: dict, expected_digest: str | None = None) -> str:
        out = ctypes.create_string_buffer(65)
        rc = self._lib.dm_rw_commit(self._h, json.dumps(meta).encode(),
                                    (expected_digest or "").encode(), out)
        self._open = False
        if rc != 0:
            raise OSError(-rc, "ranged commit failed")
        return out.value.decode()

    def abort(self, keep_partial: bool = False) -> None:
        if self._open:
            self._lib.dm_rw_abort(self._h, 1 if keep_partial else 0)
            self._open = False


class Store:
    """Content-addressed store rooted at ``root`` (``objects/`` + ``partial/``
    + ``digests/`` content-address hardlinks)."""

    def __init__(self, root: Path | str):
        self.root = Path(root)
        self.root.parent.mkdir(parents=True, exist_ok=True)
        self._lib = native.lib()
        err = ctypes.create_string_buffer(512)
        self._h = self._lib.dm_store_open(str(self.root).encode(), err, 512)
        if not self._h:
            raise OSError(f"store open failed: {err.value.decode()}")

    def close(self) -> None:
        if self._h:
            self._lib.dm_store_close(self._h)
            self._h = None

    # -- queries ---------------------------------------------------------
    def has(self, key: str) -> bool:
        return bool(self._lib.dm_store_has(self._h, key.encode()))

    def size(self, key: str) -> int:
        return self._lib.dm_store_size(self._h, key.encode())

    def partial_size(self, key: str) -> int:
        return self._lib.dm_store_partial_size(self._h, key.encode())

    def meta(self, key: str) -> dict | None:
        n = self._lib.dm_store_meta(self._h, key.encode(), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n + 1)
        self._lib.dm_store_meta(self._h, key.encode(), buf, n + 1)
        try:
            return json.loads(buf.value.decode())
        except ValueError:
            return None

    def has_digest(self, digest: str) -> bool:
        return bool(self._lib.dm_store_has_digest(self._h, digest.encode()))

    def list(self) -> list[str]:
        n = self._lib.dm_store_list(self._h, None, 0)
        buf = ctypes.create_string_buffer(n + 1)
        self._lib.dm_store_list(self._h, buf, n + 1)
        return [k for k in buf.value.decode().split("\n") if k]

    # -- reads -----------------------------------------------------------
    def pread(self, key: str, length: int, offset: int) -> bytes:
        _fault("pread", key, length=length, offset=offset)
        buf = ctypes.create_string_buffer(length)
        n = self._lib.dm_store_pread(self._h, key.encode(), buf, length, offset)
        if n < 0:
            raise OSError(-n, f"pread {key} failed")
        return buf.raw[:n]

    def pread_into(self, key: str, out, offset: int = 0) -> int:
        """Range-read straight into a writable buffer (numpy uint8 view) —
        the zero-extra-copy landing path for the HBM sink."""
        view = memoryview(out).cast("B")
        n = self._lib.dm_store_pread(
            self._h, key.encode(),
            (ctypes.c_char * len(view)).from_buffer(view), len(view), offset,
        )
        if n < 0:
            raise OSError(-n, f"pread_into {key} failed")
        return n

    def get(self, key: str) -> bytes:
        size = self.size(key)
        if size < 0:
            raise KeyError(key)
        return self.pread(key, size, 0)

    def stream(self, key: str, chunk: int = 1 << 20) -> Iterator[bytes]:
        size = self.size(key)
        if size < 0:
            raise KeyError(key)
        off = 0
        while off < size:
            part = self.pread(key, min(chunk, size - off), off)
            if not part:
                break
            yield part
            off += len(part)

    # -- writes ----------------------------------------------------------
    def begin(self, key: str, resume: bool = False) -> StoreWriter:
        err = ctypes.create_string_buffer(256)
        h = self._lib.dm_store_begin(self._h, key.encode(),
                                     1 if resume else 0, err, 256)
        if not h:
            raise OSError(f"begin {key}: {err.value.decode()}")
        return StoreWriter(self._lib, h, key=key)

    def begin_ranged(self, key: str, total: int) -> RangeStoreWriter:
        err = ctypes.create_string_buffer(256)
        h = self._lib.dm_store_begin_ranged(self._h, key.encode(), total,
                                            err, 256)
        if not h:
            raise OSError(f"begin_ranged {key}: {err.value.decode()}")
        return RangeStoreWriter(self._lib, h)

    def put(self, key: str, body: bytes, meta: dict | None = None) -> str:
        digest = ctypes.create_string_buffer(65)
        rc = self._lib.dm_store_put(self._h, key.encode(), body, len(body),
                                    json.dumps(meta or {}).encode(), digest)
        if rc != 0:
            raise OSError(-rc, f"put {key} failed")
        return digest.value.decode()

    def remove(self, key: str) -> None:
        rc = self._lib.dm_store_remove(self._h, key.encode())
        if rc != 0:
            raise OSError(-rc, f"remove {key} failed")

    def gc(self, max_bytes: int) -> tuple[int, int, int]:
        """Size-capped LRU eviction over committed objects. Returns
        ``(total_bytes_after, freed_bytes, evicted_count)``. Active
        writers and partials are never touched."""
        freed = ctypes.c_int64(0)
        count = ctypes.c_int(0)
        total = self._lib.dm_store_gc(self._h, max_bytes,
                                      ctypes.byref(freed), ctypes.byref(count))
        if total < 0:
            raise OSError(-total, "store gc failed")
        if count.value:
            _m.HUB.inc("store_evictions_total", count.value)
            _m.HUB.inc("store_evicted_bytes_total", freed.value)
        return total, freed.value, count.value

    def materialize(self, key: str, digest: str, meta: dict) -> None:
        """Publish already-stored bytes (located by content digest) under a
        new key via hardlink — content-address dedup, zero copy."""
        rc = self._lib.dm_store_materialize(self._h, key.encode(),
                                            digest.encode(),
                                            json.dumps(meta).encode())
        if rc != 0:
            raise OSError(-rc, f"materialize {key} from {digest[:12]} failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
