"""Consistent-hash placement and swarm chunk possession (the port of
``demodel_tpu/parallel/placement.py``).

- :class:`HashRing` maps a key to a peer with virtual nodes, so every
  host computes the same owner for a key without any broadcast, and a
  peer's death moves only its own arc to the ring successors.
- :func:`bounded_assign` caps every node's share of a chunk grid, and
  :func:`spread_key` is the swarm's rarest-first tie-break. Both agree
  bit for bit with the reference: a port host and a JAX host in one
  swarm compute the same owners.
- :class:`ChunkBoard` is one pull's chunk possession on one host (which
  fixed-grid chunks have landed, and their bytes), which the restore
  server re-serves to swarm siblings; boards register by
  ``{pull}/{host}`` so the serve surface finds them.
"""

from __future__ import annotations

import hashlib
import threading
from bisect import bisect_right

from demodel_tpu_torch.utils.env import (
    default_swarm_chunk_mb,
    default_swarm_fill_timeout,
    default_swarm_origin_streams,
    env_int,
    swarm_reap_enabled,
)


def _point(token: str) -> int:
    """64-bit ring coordinate of a token (stable across hosts and runs)."""
    return int.from_bytes(hashlib.sha256(token.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with ``vnodes`` points per node
    (``DEMODEL_SWARM_VNODES``, default 256) over an ordered node set."""

    def __init__(self, nodes: list[str], vnodes: int | None = None):
        if vnodes is None:
            vnodes = env_int("DEMODEL_SWARM_VNODES", 256, minimum=1)
        self.nodes = sorted(set(nodes))
        self._points: list[tuple[int, str]] = sorted(
            (_point(f"{n}#{i}"), n)
            for n in self.nodes for i in range(vnodes))
        self._keys = [p for p, _ in self._points]

    def owner(self, key: str) -> str | None:
        """The node owning ``key`` (None on an empty ring)."""
        owners = self.owners(key, 1)
        return owners[0] if owners else None

    def owners(self, key: str, n: int) -> list[str]:
        """Up to ``n`` distinct nodes in ring order from ``key``'s point:
        ``owners(k, 2)[1]`` re-owns the key when the first dies."""
        if not self._points or n <= 0:
            return []
        out: list[str] = []
        i = bisect_right(self._keys, _point(key))
        for step in range(len(self._points)):
            node = self._points[(i + step) % len(self._points)][1]
            if node not in out:
                out.append(node)
                if len(out) >= min(n, len(self.nodes)):
                    break
        return out


def spread_key(token: str) -> int:
    """Stable pseudo-random sort key: the rarest-first tie-break that
    decorrelates swarm hosts' origin request orders."""
    return _point(token)


def bounded_assign(ring: HashRing, items: list[str]) -> dict[str, str]:
    """Consistent hashing with bounded loads: each item goes to the first
    node on its ring succession with capacity left, capacity =
    ceil(len(items)/len(nodes)); items are walked in hash order, so
    every host computes the same assignment."""
    if not ring.nodes:
        return {}
    cap = (len(items) + len(ring.nodes) - 1) // len(ring.nodes)
    load = {n: 0 for n in ring.nodes}
    out: dict[str, str] = {}
    for item in sorted(items, key=spread_key):
        for node in ring.owners(item, len(ring.nodes)):
            if load[node] < cap:
                load[node] += 1
                out[item] = node
                break
    return out


def chunk_count(size: int, chunk_bytes: int) -> int:
    return max(1, (int(size) + chunk_bytes - 1) // chunk_bytes)


def chunk_span(size: int, chunk_bytes: int, index: int) -> tuple[int, int]:
    """``(offset, length)`` of chunk ``index`` in an object of ``size``."""
    off = index * chunk_bytes
    return off, min(chunk_bytes, int(size) - off)


def default_chunk_bytes() -> int:
    return default_swarm_chunk_mb() << 20


def default_fill_timeout() -> float:
    return default_swarm_fill_timeout()


def default_origin_streams() -> int:
    return default_swarm_origin_streams()


def reap_enabled() -> bool:
    return swarm_reap_enabled()


def _bitmap_hex(have: set[int], n: int) -> str:
    bm = bytearray((n + 7) // 8)
    for i in have:
        bm[i >> 3] |= 1 << (i & 7)
    return bm.hex()


def bitmap_indices(hex_str: str, n: int) -> set[int]:
    """Inverse of the summary bitmap: advertised chunk indices < ``n``."""
    try:
        bm = bytes.fromhex(hex_str)
    except ValueError:
        return set()
    return {i for i in range(min(n, len(bm) * 8)) if bm[i >> 3] >> (i & 7) & 1}


def _charge_ram(delta: int) -> None:
    """Charge (or release, negative) chunk-board bytes to the host-RAM
    tier budget, outside the board lock. The port has no RAM hot tier
    yet, so nothing is evicted to make room (``tier`` module docstring)."""
    if not delta:
        return
    from demodel_tpu_torch import tier

    budget = tier.ram_budget()
    if delta > 0:
        budget.charge(delta)
    else:
        budget.release(-delta)


class ChunkBoard:
    """One host's chunk possession and bytes for one swarm pull.

    Thread-safe. ``put`` bumps a monotonic version so a polled summary
    is orderable. Chunks stay until reaped or :meth:`clear`: the board is
    the peer-serve surface. Held bytes are charged to the host-RAM tier
    budget and released on reap or clear.
    """

    def __init__(self, pull_id: str, host_id: str):
        self.pull_id = pull_id
        self.host_id = host_id
        self._lock = threading.Lock()
        self._files: dict[str, int] = {}          # file key → chunk count
        self._chunks: dict[tuple[str, int], bytes] = {}
        #: chunks the reaper freed: they landed once and count as
        #: progress, but the summary no longer advertises them
        self._reaped: set[tuple[str, int]] = set()
        self._bytes_reaped = 0
        self._version = 0

    def add_file(self, key: str, n_chunks: int) -> None:
        with self._lock:
            self._files[key] = int(n_chunks)
            self._version += 1

    def put(self, key: str, index: int, data: bytes) -> None:
        data = bytes(data)
        with self._lock:
            if key not in self._files:
                raise KeyError(f"unknown swarm file {key!r}")
            prev = self._chunks.get((key, index))
            self._chunks[(key, index)] = data
            self._reaped.discard((key, index))  # a re-fetch un-reaps
            self._version += 1
        _charge_ram(len(data) - (len(prev) if prev is not None else 0))

    def get(self, key: str, index: int) -> bytes | None:
        with self._lock:
            return self._chunks.get((key, index))

    def done(self, key: str, index: int) -> bool:
        """Held or reaped: nothing left to fetch."""
        with self._lock:
            return (key, index) in self._chunks \
                or (key, index) in self._reaped

    def reaped(self, key: str, index: int) -> bool:
        with self._lock:
            return (key, index) in self._reaped

    def reap(self, key: str, index: int) -> int:
        """Free one chunk's bytes (how many; 0 when not held)."""
        with self._lock:
            data = self._chunks.pop((key, index), None)
            if data is None:
                return 0
            self._reaped.add((key, index))
            self._bytes_reaped += len(data)
            self._version += 1
        _charge_ram(-len(data))
        return len(data)

    def unreap(self, key: str, index: int) -> None:
        """A local reader needs a reaped chunk after all: clear the flag
        so the acquisition path claims it again."""
        with self._lock:
            self._reaped.discard((key, index))

    def have(self, key: str) -> set[int]:
        with self._lock:
            return {i for (k, i) in self._chunks if k == key}

    def held(self) -> list[tuple[str, int]]:
        """Every chunk currently holding bytes (the reaper's scan set)."""
        with self._lock:
            return list(self._chunks)

    def summary(self) -> dict:
        """Versioned possession advertisement, one bitmap per file:
        ``have`` is what this host can serve now, ``done`` adds the
        reaped chunks (siblings gate their own reaps on ``done``)."""
        with self._lock:
            return {
                "pull": self.pull_id,
                "host": self.host_id,
                "v": self._version,
                "files": {
                    k: {"n": n,
                        "have": _bitmap_hex(
                            {i for (fk, i) in self._chunks if fk == k}, n),
                        "done": _bitmap_hex(
                            {i for (fk, i) in self._chunks if fk == k}
                            | {i for (fk, i) in self._reaped if fk == k},
                            n)}
                    for k, n in self._files.items()
                },
            }

    def stats(self) -> dict:
        with self._lock:
            total = sum(self._files.values())
            return {
                "pull": self.pull_id, "host": self.host_id,
                "files": len(self._files), "chunks_total": total,
                "chunks_have": len(self._chunks) + len(self._reaped),
                "bytes_held": sum(len(b) for b in self._chunks.values()),
                "chunks_reaped": len(self._reaped),
                "bytes_reaped": self._bytes_reaped,
                "v": self._version,
            }

    def clear(self) -> None:
        with self._lock:
            held = sum(len(b) for b in self._chunks.values())
            self._chunks.clear()
            self._files.clear()
            self._reaped.clear()
            self._version += 1
        _charge_ram(-held)


# ----------------------------------------------------- process board registry
#
# The restore server resolves boards here, keyed "{pull_id}/{host_id}",
# so one process can host N boards the way N pod processes host one each.

_boards_lock = threading.Lock()
_boards: dict[str, ChunkBoard] = {}


def board_key(pull_id: str, host_id: str) -> str:
    return f"{pull_id}/{host_id}"


def register_board(b: ChunkBoard) -> None:
    with _boards_lock:
        _boards[board_key(b.pull_id, b.host_id)] = b


def unregister_board(b: ChunkBoard) -> None:
    with _boards_lock:
        key = board_key(b.pull_id, b.host_id)
        if _boards.get(key) is b:
            del _boards[key]


def board(pull_id: str, host_id: str) -> ChunkBoard | None:
    with _boards_lock:
        return _boards.get(board_key(pull_id, host_id))


def boards_snapshot() -> list[dict]:
    """Live swarm progress of every registered board (read-only)."""
    with _boards_lock:
        boards = list(_boards.values())
    return [b.stats() for b in boards]
