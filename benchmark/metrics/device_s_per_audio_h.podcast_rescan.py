"""device_s_per_audio_h.podcast_rescan: as device_s_per_audio_h.rescan, over
the podcast archive's rescan window."""

from harness.registry import reader

read = reader("device_s_per_audio_h.rescan")
