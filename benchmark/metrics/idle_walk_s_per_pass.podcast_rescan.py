"""idle_walk_s_per_pass.podcast_rescan: as idle_walk_s_per_pass.rescan, over the
podcast archive's rescan window."""

from harness.registry import reader

read = reader("idle_walk_s_per_pass.rescan")
