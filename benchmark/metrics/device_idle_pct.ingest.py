"""device_idle_pct.ingest: as device_idle_pct.rescan, over the release-ingest
window."""

from harness.stats import idle_pct


def read(rec):
    return idle_pct(rec)
