"""walk_s_per_audio_h.rescan: the walk pool's seconds (the program's `walk`
spans, one per file, wall time summed over the walk threads) per audio-hour
the window analysed. None where the program records no spans."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    walk = tracing.snapshot()["totals"].get("walk")
    a = rec.get("analysed")
    if not walk or not a or not a["audio_s"]:
        return None
    return walk["wall_s"] / (a["audio_s"] / 3600.0)
