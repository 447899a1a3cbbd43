"""upload_s_per_audio_h.podcast_rescan: as upload_s_per_audio_h.rescan, over the
podcast archive's rescan window."""

from harness.registry import reader

read = reader("upload_s_per_audio_h.rescan")
