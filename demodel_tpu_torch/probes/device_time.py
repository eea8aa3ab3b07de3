"""Device time from the CUDA profiler's trace, with one rule for a lost
trace; ``chip_smoke.py`` and :mod:`~demodel_tpu_torch.probes.k1_prefill`
both read it. Imports torch only when called."""

from __future__ import annotations


def device_ms(run, groups, counts_ok=None, tries: int = 5):
    """Summed device time (ms) during ``run()`` of the device activities
    (kernels, copies) whose names each group's predicate accepts, from
    the CUDA profiler's trace, and the activities' count by name.
    ``counts_ok`` maps a group to a check of its activities' counts by
    name: work that launched but is missing from the trace fails it, and
    ``run`` is measured again, up to ``tries`` times. Then this returns
    None: a lost trace is never reported as a fast one. (CUPTI drops
    records now and then on the H100: some of one delivery's 16
    launches, half of 20 SDPA calls, or a whole trace.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        ms = {k: sum(e.device_time_total for e in events if match(e.key))
              / 1e3 for k, match in groups.items()}
        counts = {k: {e.key: e.count for e in events if match(e.key)}
                  for k, match in groups.items()}
        if all(ok(counts[k]) for k, ok in (counts_ok or {}).items()):
            return ms, {e.key: e.count for e in events}
    return None


def every_call(iters: int):
    """A ``counts_ok`` check for ``iters`` calls that launch the same
    work each: every activity a whole number of times a call, and at
    least one that is not a memset or a copy."""
    def ok(c: dict[str, int]) -> bool:
        return (all(n > 0 and n % iters == 0 for n in c.values())
                and any("Memset" not in k and "Memcpy" not in k for k in c))
    return ok
