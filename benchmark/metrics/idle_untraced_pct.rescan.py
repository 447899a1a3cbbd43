"""idle_untraced_pct.rescan: the share of the window's device idle (as
device_idle_pct takes it: the window's wall less the union of the Runner's
busy intervals) that the program's idle partition charges to no class: 100 x (window idle - idle charged to upload, prep, walk, manifest,
album union, collect and admit spans) / window idle. None where the
program records no spans."""

from harness.stats import idle_pct


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    snap = tracing.snapshot()
    pct = idle_pct(rec)
    if not snap["spans"] or not pct:
        return None
    idle_s = pct / 100.0 * rec["window_s"]
    return 100.0 * (idle_s - sum(snap["idle"]["classes"].values())) / idle_s
