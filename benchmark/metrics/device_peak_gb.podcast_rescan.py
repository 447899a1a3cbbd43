"""device_peak_gb.podcast_rescan: the largest device memory the program's
Runners saw allocated (torch.cuda.max_memory_allocated, read as each batch
is enqueued: the program's gauge device.peak_bytes), in GB (1e9 bytes).
None where the program keeps no such gauge."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    peak = tracing.snapshot().get("gauges", {}).get("device.peak_bytes")
    if not peak:
        return None
    return peak / 1e9
