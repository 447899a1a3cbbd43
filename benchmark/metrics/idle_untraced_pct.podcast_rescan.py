"""idle_untraced_pct.podcast_rescan: as idle_untraced_pct.rescan, over the
podcast archive's rescan window."""

from harness.registry import reader

read = reader("idle_untraced_pct.rescan")
