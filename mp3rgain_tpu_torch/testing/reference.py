"""The float64 ReplayGain reference: a track's gain and peak from its PCM.

reference_gain is the acceptance oracle of the JAX package's tier-4 tests
(tests/test_replaygain.py::reference_analyze_pcm) in the port: the
reference-exact float64 equal-loudness filter (ops.iir.equal_loudness_scan),
then 50 ms windows in float64, one window at a time, filed in the
12,000-bin loudness histogram, and PINK_REF minus its 95th-percentile
readout. The routes' gains must lie within 0.05 dB of it (the product's
accuracy budget). It shares no code with the routes but the filter
coefficients, the histogram readout and PINK_REF.

reference_peak is the largest |sample| of the PCM that a route decodes.
"""

from __future__ import annotations

import numpy as np

from ..ops import histogram as hi
from ..ops.iir import equal_loudness_scan
from ..replaygain import PINK_REF


def reference_gain(pcm, sample_rate: int) -> float:
    """Float64 reference-exact gain (dB) for (C, T) PCM normalized to
    [-1, 1]; a third channel and beyond are ignored, as the routes do."""
    x = np.asarray(pcm, dtype=np.float64)[:2] * 32768.0
    filt = equal_loudness_scan(x, sample_rate).numpy()
    c, t = filt.shape
    w = sample_rate * 50 // 1000
    hist = np.zeros(12000, dtype=np.uint64)
    l = filt[0]
    r = filt[1] if c == 2 else filt[0]
    for start in range(0, t, w):
        end = min(start + w, t)
        ms = ((l[start:end] ** 2).sum() + (r[start:end] ** 2).sum()) / (end - start) * 0.5
        idx = int(100 * 10 * np.log10(ms + 1e-37)) + 2000
        if 0 <= idx < 12000:
            hist[idx] += 1
    return PINK_REF - hi.loudness_from_histogram(hist)


def reference_peak(pcm) -> float:
    """The largest |sample| of (C, T) PCM (0.0 when empty)."""
    pcm = np.asarray(pcm)
    return float(np.abs(pcm).max()) if pcm.size else 0.0
