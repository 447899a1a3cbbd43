"""walk_md_mb_per_audio_h.rescan: the MB of main data the light walk emitted
(the program's walk.md_bytes counter: each track's main-data stream with its
offsets and counts) per audio-hour the window analysed. None where the
program counts no such bytes (a walk that writes md rows counts none)."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    emitted = tracing.snapshot()["counters"].get("walk.md_bytes")
    a = rec.get("analysed")
    if not emitted or not a or not a["audio_s"]:
        return None
    return emitted / 1e6 / (a["audio_s"] / 3600.0)
