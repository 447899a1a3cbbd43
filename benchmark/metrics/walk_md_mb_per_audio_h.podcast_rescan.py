"""walk_md_mb_per_audio_h.podcast_rescan: as walk_md_mb_per_audio_h.rescan,
over the podcast archive's rescan window."""

from harness.registry import reader

read = reader("walk_md_mb_per_audio_h.rescan")
