"""prep_s_per_audio_h.rescan: the Runner's host prep seconds (prep_s of its
timings, thread time summed over its prep threads) of the batches collected
in the window, per audio-hour those batches analysed."""


def read(rec):
    t, a = rec.get("timings"), rec.get("analysed")
    if not t or not a or not a["audio_s"]:
        return None
    return sum(x["prep_s"] for x in t) / (a["audio_s"] / 3600.0)
