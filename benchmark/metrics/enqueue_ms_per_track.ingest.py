"""enqueue_ms_per_track.ingest: host milliseconds per track spent enqueueing
the device pipeline of a track's batch (the program's `enqueue` spans,
inside Runner.launch), over its `track` spans. None where the program
records no spans."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    totals = tracing.snapshot()["totals"]
    tracks = totals.get("track", {}).get("count")
    if not tracks or "enqueue" not in totals:
        return None
    return 1000.0 * totals["enqueue"]["wall_s"] / tracks
