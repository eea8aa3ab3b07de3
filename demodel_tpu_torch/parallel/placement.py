"""Consistent-hash placement over a peer set (the part of
``demodel_tpu/parallel/placement.py`` the peer plane uses).

:class:`HashRing` maps a key to a peer with virtual nodes, so every host
computes the same owner for a key without any broadcast, and a peer's
death moves only its own arc to the ring successors.
The swarm's bounded assignment (``bounded_assign``, ``spread_key``) and
chunk possession (``ChunkBoard``) come with the swarm, their caller.
"""

from __future__ import annotations

import hashlib
from bisect import bisect_right

from demodel_tpu_torch.utils.env import env_int


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

