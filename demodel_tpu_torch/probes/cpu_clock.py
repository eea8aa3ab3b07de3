"""How the sampling profiler tells on-CPU from parked on this machine:
which per-thread CPU clock it resolved (``Profiler._cpu_mode``), and
what that clock reads for a busy thread and a parked one.

    python -m demodel_tpu_torch.probes.cpu_clock

Prints one JSON line: the kernel release, the profiler's ``cpu_mode``,
three readings 0.3 s apart of each thread's clock through the
profiler's own reader, the smallest step the busy thread's clock moved
by (its granularity), and whether ``/proc/self/task/<tid>/schedstat``
(the fallback) exists. A clock that moves in coarse steps still marks a
thread on-CPU at the default 19 Hz as long as a step is under half the
tick's ~52 ms.
"""

from __future__ import annotations

import json
import os
import platform
import threading
import time

from demodel_tpu_torch.utils.profiler import Profiler


def main() -> dict:
    prof = Profiler(hz=19)
    stop = threading.Event()
    ids: dict[str, int] = {}

    def busy() -> None:
        ids["busy"] = threading.get_native_id()
        while not stop.is_set():
            sum(i * i for i in range(1000))

    def parked() -> None:
        ids["parked"] = threading.get_native_id()
        stop.wait(10)

    threads = [threading.Thread(target=busy), threading.Thread(target=parked)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        readings = {name: [] for name in ("busy", "parked")}
        for _ in range(3):
            for name, nid in ids.items():
                readings[name].append(prof._read_cpu(nid))
            time.sleep(0.3)
        # granularity: the smallest nonzero step over a tight loop of reads
        steps = set()
        last = prof._read_cpu(ids["busy"])
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline and last is not None:
            cur = prof._read_cpu(ids["busy"])
            if cur is not None and cur > last:
                steps.add(round(cur - last, 9))
            last = cur
    finally:
        stop.set()
        for t in threads:
            t.join()
    return {"release": platform.release(), "cpu_mode": prof._cpu_mode,
            "readings_s": readings,
            "busy_clock_step_s": min(steps) if steps else None,
            "schedstat": os.path.exists(
                f"/proc/self/task/{threading.get_native_id()}/schedstat")}


if __name__ == "__main__":
    print(json.dumps(main()))
