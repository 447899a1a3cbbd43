"""prep_s_per_audio_h.podcast_rescan: as prep_s_per_audio_h.rescan, over the
podcast archive's rescan window."""

from harness.registry import reader

read = reader("prep_s_per_audio_h.rescan")
