"""Background scrubber: a low-rate re-digest of committed store objects
(the port of ``demodel_tpu/scrub.py``).

The store trusts an object's commit-time digest forever, so silent
bit-rot would be served until the key is evicted. The scrubber walks the
committed set in bounded, cursor-resumable slices (the native
``Store::scrub_pass``), re-hashing each object against its recorded
sha256 and quarantining mismatches, so the next read is a clean miss
and fetches again.

Knobs, shared with the native proxy's storage maintenance thread:

- ``DEMODEL_SCRUB_INTERVAL_SECS``: seconds between slices (0, the
  default, is off: scrubbing is an opt-in for long-lived cache nodes);
- ``DEMODEL_SCRUB_RATE_MB_S``: the re-digest budget; a slice reads at
  most ``rate × interval`` bytes, so verification never contends with
  serving.

The restore server starts one scrubber per store root when the interval
is set (:func:`ensure`) and stops them all when it stops.
"""

from __future__ import annotations

import threading

from demodel_tpu_torch.store import Store
from demodel_tpu_torch.utils import trace
from demodel_tpu_torch.utils.env import scrub_interval_secs, scrub_rate_mb_s
from demodel_tpu_torch.utils.logging import get_logger
from demodel_tpu_torch.utils.metrics import HUB

log = get_logger("scrub")

#: pre-registered: a scrape types the families before the first slice
HUB.inc("scrub_objects_total", 0)
HUB.inc("scrub_bytes_total", 0)
HUB.inc("scrub_mismatch_total", 0)
HUB.inc("scrub_passes_total", 0)


class Scrubber:
    """One store's background scrub loop: every interval, one bounded
    re-digest slice through the native cursor (mismatches quarantined in
    the store; counts mirrored into the hub here)."""

    def __init__(self, store: Store):
        self.store = store
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> bool:
        if scrub_interval_secs() <= 0 or self._thread is not None:
            return False
        self._thread = threading.Thread(target=self._run,
                                        name="store-scrub", daemon=True)
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def running(self) -> bool:
        return self._thread is not None

    def _run(self) -> None:
        while not self._stop.wait(scrub_interval_secs()):
            try:
                self.slice()
            except OSError as e:
                # the disk being read is the flaky thing defended against:
                # a failed slice must not end the loop
                log.warning("scrub slice failed: %s", e)

    def slice(self) -> tuple[bool, int, int, int]:
        """One bounded slice now. Returns ``(wrapped, objects, bytes,
        mismatched)``."""
        budget = scrub_rate_mb_s() * max(1, scrub_interval_secs()) << 20
        with trace.span("scrub.slice"):
            wrapped, objs, nbytes, mismatched = self.store.scrub(budget)
        HUB.inc("scrub_objects_total", objs)
        HUB.inc("scrub_bytes_total", nbytes)
        if mismatched:
            HUB.inc("scrub_mismatch_total", mismatched)
            # the native slice quarantines without Store.quarantine, so
            # the quarantine family is counted here
            HUB.inc("store_quarantined_total", mismatched)
            log.warning("scrub slice quarantined %d corrupt object(s)",
                        mismatched)
        if wrapped:
            HUB.inc("scrub_passes_total")
        return wrapped, objs, nbytes, mismatched


_lock = threading.Lock()
_scrubbers: dict[str, Scrubber] = {}


def ensure(store: Store) -> Scrubber | None:
    """Start the background scrubber of ``store``'s root once, when
    ``DEMODEL_SCRUB_INTERVAL_SECS`` > 0; None when disabled."""
    if scrub_interval_secs() <= 0:
        return None
    root = str(store.root)
    with _lock:
        sc = _scrubbers.get(root)
        if sc is None:
            sc = Scrubber(store)
            sc.start()
            _scrubbers[root] = sc
        return sc


def stop_all() -> None:
    with _lock:
        scrubbers = list(_scrubbers.values())
        _scrubbers.clear()
    for sc in scrubbers:
        sc.stop()


def snapshot() -> list[dict]:
    """Each running scrubber's root and settings."""
    with _lock:
        items = sorted(_scrubbers.items())
    return [{"root": root, "running": sc.running(),
             "interval_secs": scrub_interval_secs(),
             "rate_mb_s": scrub_rate_mb_s()} for root, sc in items]
