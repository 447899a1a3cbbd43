"""device_s_per_audio_h.rescan: the Runner's device milliseconds (CUDA events
around each batch's compute and readback) of the batches collected in the
window, in seconds per audio-hour those batches analysed."""


def read(rec):
    t, a = rec.get("timings"), rec.get("analysed")
    if not t or not a or not a["audio_s"] or not rec.get("busy_ms"):
        return None
    return sum(x["device_ms"] for x in t) / 1000.0 / (a["audio_s"] / 3600.0)
