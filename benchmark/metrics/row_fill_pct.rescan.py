"""row_fill_pct.rescan: 100 x the granule-channel rows the window's batches
hold (the program's rows.real counter) / the rows their padded shapes give
the device (rows.padded: batch slots x the padded granule-channel count).
None where the program counts no rows."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    counters = tracing.snapshot()["counters"]
    if not counters.get("rows.padded"):
        return None
    return 100.0 * counters["rows.real"] / counters["rows.padded"]
