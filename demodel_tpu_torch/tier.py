"""Tier accounting and single-flight admission: the part of
``demodel_tpu/tier.py`` that the serving plane and a registry pull use.

- :class:`TierBudget` — byte accounting for one tier (the paged KV pool
  charges one, so generation KV memory is accounted like the RAM tier;
  swarm chunk boards charge :func:`ram_budget`).
- :func:`shared` — one :class:`TieredStore` per store root, whose
  :class:`SingleFlight` collapses concurrent fetches of one key into one
  upstream transfer (``Fetcher.fetch``), and whose :meth:`~TieredStore.enforce`
  trims the disk tier to ``DEMODEL_CACHE_MAX_GB`` after a pull.

The host-RAM hot tier and the watermark read path (``TieredStore.read``)
come with the slice that serves from the store; until then nothing is
promoted into RAM, so ``enforce`` has only the disk tier to trim, and a
chunk board's charge to :func:`ram_budget` has no hot object to evict.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable

from demodel_tpu_torch.store import Store
from demodel_tpu_torch.utils.env import cache_max_gb, default_tier_ram_mb
from demodel_tpu_torch.utils.logging import get_logger
from demodel_tpu_torch.utils.metrics import HUB

log = get_logger("tier")

#: pre-register the single-flight counters so a scrape types them before
#: the first event
HUB.inc("singleflight_leaders_total", 0)
HUB.inc("singleflight_waiters_total", 0)
HUB.inc("singleflight_handoffs_total", 0)


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


#: the process-wide host-RAM tier budget (``DEMODEL_TIER_RAM_MB``)
_ram_budget: TierBudget | None = None
_ram_budget_lock = threading.Lock()


def ram_budget() -> TierBudget:
    global _ram_budget
    with _ram_budget_lock:
        if _ram_budget is None:
            _ram_budget = TierBudget("tier-ram",
                                     default_tier_ram_mb() << 20)
        return _ram_budget


# ---------------------------------------------------------- single-flight


class _Flight:
    """One in-flight cohort for one key: a leader running the fetch,
    waiters blocked on its outcome."""

    def __init__(self) -> None:
        self.cv = threading.Condition()
        self.done = False
        self.ok = False
        self.error: BaseException | None = None
        self.leader_needed = False  # the leader died; next waiter claims
        self.waiters = 0
        self.handoffs = 0

    def finish(self, ok: bool, error: BaseException | None = None) -> None:
        with self.cv:
            self.done = True
            self.ok = ok
            self.error = error
            self.cv.notify_all()

    def resign(self, error: BaseException) -> bool:
        """Leader failure: hand the flight to a waiter if any is present
        (returns True), else fail it. A partial stays on disk either way,
        so the successor resumes it instead of starting over."""
        with self.cv:
            if self.waiters > 0:
                self.leader_needed = True
                self.error = error  # surfaced if no waiter can take over
                self.cv.notify_all()
                return True
            self.done = True
            self.ok = False
            self.error = error
            self.cv.notify_all()
            return False


class SingleFlight:
    """Per-key admission registry: the first caller in becomes the
    leader, everyone else a waiter. A finished flight (ok or failed)
    leaves the registry immediately, so failure never poisons the key."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flights: dict[str, _Flight] = {}

    def lease(self, key: str) -> tuple[_Flight, bool]:
        """(flight, is_leader). Waiters are counted in under the registry
        lock so a resigning leader can never miss them."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                return flight, True
            with flight.cv:
                flight.waiters += 1
            return flight, False

    def finish(self, key: str, flight: _Flight) -> None:
        with self._lock:
            if self._flights.get(key) is flight:
                del self._flights[key]

    def do(self, key: str, fn: Callable[[], Any],
           timeout: float | None = None) -> Any:
        """Collapse concurrent ``fn`` calls for one key: the leader runs
        it and gets its result, waiters block on the outcome and get
        None (they re-read the store); a failed leader hands the call to
        the next waiter (each retry is ``fn`` again — resumable work
        resumes itself)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        flight, leader = self.lease(key)
        if not leader:
            HUB.inc("singleflight_waiters_total")
            became_leader = False
            with flight.cv:
                while not flight.done and not flight.leader_needed:
                    if not _wait(flight.cv, deadline):
                        flight.waiters -= 1
                        raise TimeoutError(
                            f"single-flight wait for {key} timed out")
                if flight.leader_needed:
                    flight.leader_needed = False
                    flight.handoffs += 1
                    became_leader = True
                flight.waiters -= 1
                if not became_leader:
                    if flight.ok:
                        return None
                    raise flight.error or OSError(
                        f"single-flight fetch of {key} failed")
            HUB.inc("singleflight_handoffs_total")
        HUB.inc("singleflight_leaders_total")
        try:
            result = fn()
        except BaseException as e:
            if not flight.resign(e):
                self.finish(key, flight)
            raise
        flight.finish(ok=True)
        self.finish(key, flight)
        return result


def _wait(cv: threading.Condition, deadline: float | None) -> bool:
    """One bounded cv wait; False once the deadline passed."""
    if deadline is None:
        cv.wait()
        return True
    left = deadline - time.monotonic()
    if left <= 0:
        return False
    cv.wait(min(left, 1.0))
    return True


class TieredStore:
    """The tier state of one store root: its single-flight registry and
    its budget enforcement."""

    def __init__(self, store: Store):
        self.store = store
        self.flights = SingleFlight()

    def enforce(self) -> None:
        """Budget-driven eviction after a pull: the disk tier to
        ``DEMODEL_CACHE_MAX_GB`` via :meth:`Store.gc` (pinned keys
        shielded, ``store_evictions_total`` counted)."""
        enforce_disk_budget(self.store)


def enforce_disk_budget(store: Store) -> None:
    """Disk-tier budget: ``DEMODEL_CACHE_MAX_GB`` (0 = unbounded) through
    :meth:`Store.gc` — active writers and partials untouched."""
    max_gb = cache_max_gb()
    if max_gb > 0:
        total, freed, evicted = store.gc(max_gb << 30)
        if evicted:
            log.info("disk tier: evicted %d objects (%.1f MB); %.1f MB in "
                     "use", evicted, freed / 1e6, total / 1e6)


#: process-shared tier per store root (every pull of one store must hit
#: ONE flight registry); weak, so a finished pull's tier goes with it
_shared_lock = threading.Lock()
_shared: dict[str, "weakref.ReferenceType[TieredStore]"] = {}


def shared(store: Store) -> TieredStore:
    root = str(store.root)
    with _shared_lock:
        ref = _shared.get(root)
        tier = ref() if ref is not None else None
        if tier is None:
            tier = TieredStore(store)
            _shared[root] = weakref.ref(tier)
        return tier
