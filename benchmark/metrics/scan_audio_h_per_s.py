"""scan_audio_h_per_s: audio-hours analysed by the window's whole passes over
their wall time, by the host clock."""


def read(rec):
    passes = rec.get("passes")
    if not passes:
        return None
    return sum(p["audio_s"] for p in passes) / 3600.0 / sum(p["wall_s"] for p in passes)
