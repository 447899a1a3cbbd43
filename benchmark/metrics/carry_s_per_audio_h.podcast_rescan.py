"""carry_s_per_audio_h.podcast_rescan: device seconds of the light path's
"carry" stage (the program's device span around a segment's hand-off of
its decoder and filter state to the next segment of its track, CUDA events
under each segment's upload) per audio-hour the window analysed. None
where the program records no such stage."""

STAGE = "carry"


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    totals = tracing.snapshot()["totals"]
    a = rec.get("analysed")
    if STAGE not in totals or not a or not a["audio_s"]:
        return None
    return totals[STAGE]["wall_s"] / (a["audio_s"] / 3600.0)
