"""device_idle_pct.rescan: 100 x (1 - union of the Runner's device-busy
intervals (uploads, compute and readback, CUDA events) of the window's
batches / the window's wall time)."""

from harness.stats import idle_pct


def read(rec):
    return idle_pct(rec)
