"""idle_walk_s_per_pass.rescan: device idle (the complement of the Runner's
busy intervals) charged to the walk pool by the program's idle partition
(a `walk` or `detect` span open, and no `upload` or `prep` span), seconds
per pass. None where the program records no spans."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    snap = tracing.snapshot()
    if not snap["spans"] or not rec.get("passes"):
        return None
    return snap["idle"]["classes"]["walk"] / len(rec["passes"])
