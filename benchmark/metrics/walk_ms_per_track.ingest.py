"""walk_ms_per_track.ingest: the album path's host walk per track in
milliseconds: the program's `detect` (the file-type sniff's read) and
`walk` (read and unpack on the caller's thread) spans, summed, over its
`track` spans. None where the program records no spans."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    totals = tracing.snapshot()["totals"]
    tracks = totals.get("track", {}).get("count")
    if not tracks or "walk" not in totals:
        return None
    wall = sum(totals[n]["wall_s"] for n in ("detect", "walk") if n in totals)
    return 1000.0 * wall / tracks
