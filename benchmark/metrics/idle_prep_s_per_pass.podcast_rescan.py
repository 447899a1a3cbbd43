"""idle_prep_s_per_pass.podcast_rescan: device idle (the complement of the
Runner's busy intervals) charged to the prep pool by the program's idle
partition (a `prep` span open, and no `upload` span), seconds per pass.
None where the program records no spans."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    snap = tracing.snapshot()
    if not snap["spans"] or not rec.get("passes"):
        return None
    return snap["idle"]["classes"]["prep"] / len(rec["passes"])
