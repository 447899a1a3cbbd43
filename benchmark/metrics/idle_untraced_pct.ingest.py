"""idle_untraced_pct.ingest: as idle_untraced_pct.rescan, over the
release-ingest window."""

from harness.registry import reader

read = reader("idle_untraced_pct.rescan")
