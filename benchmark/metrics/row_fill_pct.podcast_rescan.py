"""row_fill_pct.podcast_rescan: as row_fill_pct.rescan, over the
podcast archive's rescan window."""

from harness.registry import reader

read = reader("row_fill_pct.rescan")
