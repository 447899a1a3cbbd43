"""k2_roofline_pct.podcast_rescan: as k2_roofline_pct.rescan, over the
podcast archive's rescan window."""

from harness.registry import reader

read = reader("k2_roofline_pct.rescan")
