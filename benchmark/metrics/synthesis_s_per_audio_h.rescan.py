"""synthesis_s_per_audio_h.rescan: device seconds of the light path's
synthesis stages (the program's device spans "hybrid GEMMs" and
"overlap-add + polyphase", CUDA events around each stage of each batch)
per audio-hour the window analysed. None where the program records no
stage spans."""

STAGES = ("hybrid GEMMs", "overlap-add + polyphase")


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    totals = tracing.snapshot()["totals"]
    a = rec.get("analysed")
    if not all(s in totals for s in STAGES) or not a or not a["audio_s"]:
        return None
    return sum(totals[s]["wall_s"] for s in STAGES) / (a["audio_s"] / 3600.0)
