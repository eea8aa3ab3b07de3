"""Probes: scripts that measure one question about the port on the card
and print what they saw, and ``device_time``, the profiler reading they
share with ``chip_smoke.py``. Nothing in the port imports them."""
