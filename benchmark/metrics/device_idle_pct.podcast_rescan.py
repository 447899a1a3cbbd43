"""device_idle_pct.podcast_rescan: as device_idle_pct.rescan, over the
podcast archive's rescan window."""

from harness.registry import reader

read = reader("device_idle_pct.rescan")
