"""The yardstick of the kernel metrics: published peaks of one H100 and the
bytes each kernel's work needs, counted from the inputs.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit; the run records the card's own power.limit beside every share.

Bytes are counted from what the streams hold, whatever the program pads
or rereads: each input byte read once, each output byte written once.
- K1, the Huffman decode (entropy_decode.cu): reads the main data and the
  side info of every frame, writes 576 quantized values of 2 bytes
  (|value| <= 8206 fits int16) per granule-channel.
- K2, requantize and stereo (requant_stereo.cu): reads those 576 values and
  the side info, writes 576 float32 values per granule-channel.
"""

from __future__ import annotations

import re
import subprocess

HBM_BYTES_PER_S = 3.35e12

LINES = 576
QUANT_BYTES = 2
FLOAT_BYTES = 4

# Kernel names as the profiler reports them, per kernel's source file.
KERNELS = {
    "k1": ("entropy_decode_rows_kernel", "mark_rows_kernel", "zero_rows_kernel"),
    "k2": ("requant_stereo_kernel",),
}


def k1_bytes(main_data: int, side_info: int, granule_channels: int) -> int:
    return main_data + side_info + QUANT_BYTES * LINES * granule_channels


def k2_bytes(main_data: int, side_info: int, granule_channels: int) -> int:
    return side_info + (QUANT_BYTES + FLOAT_BYTES) * LINES * granule_channels


BYTES = {"k1": k1_bytes, "k2": k2_bytes}


def kernel_seconds(kernels: dict, key: str) -> float:
    """Device seconds of the kernels of one source file, by name."""
    pats = [re.compile(r"(^|[\s:])" + k + r"[(<]") for k in KERNELS[key]]
    return sum(s for name, s in kernels.items() if any(p.search(name) for p in pats))


def roofline_pct(records: dict, key: str) -> float | None:
    """100 x (bytes / peak bandwidth) / kernel time; None where the trace
    holds no time for the kernel."""
    secs = kernel_seconds(records.get("kernels") or {}, key)
    a = records.get("analysed")
    if secs <= 0 or not a:
        return None
    need = BYTES[key](a["main_data_bytes"], a["side_info_bytes"], a["granule_channels"])
    return 100.0 * need / HBM_BYTES_PER_S / secs


def power_limit() -> str:
    """The first card's name and power limit from nvidia-smi ('' where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
        return out.strip().splitlines()[0] if out.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""
