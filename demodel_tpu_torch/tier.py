"""Tier byte accounting: ``TierBudget`` from ``demodel_tpu.tier``, which
the paged KV pool charges so generation KV memory is accounted like the
RAM tier."""

from __future__ import annotations

import threading
from typing import Any


class TierBudget:
    """Byte accounting for one tier: charges and releases, with the high
    water mark (not a blocking semaphore)."""

    def __init__(self, name: str, max_bytes: int):
        self.name = name
        self.max_bytes = int(max_bytes)
        self._in_use = 0
        self.high_water = 0
        self._lock = threading.Lock()

    def charge(self, nbytes: int) -> None:
        with self._lock:
            self._in_use += int(nbytes)
            if self._in_use > self.high_water:
                self.high_water = self._in_use

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._in_use -= int(nbytes)

    def describe(self) -> dict[str, Any]:
        with self._lock:
            return {"name": self.name, "max_bytes": self.max_bytes,
                    "in_use_bytes": self._in_use,
                    "high_water_bytes": self.high_water}
