"""k2_roofline_pct.rescan: K2 (requant_stereo.cu) against the bytes-only
bound at 3.35 TB/s: bytes counted from the inputs (harness/roofline.py) over
the kernel's device time in the traced window."""

from harness.roofline import roofline_pct


def read(rec):
    return roofline_pct(rec, "k2")
