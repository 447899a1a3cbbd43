"""ReplayGain 1.0 analysis of PCM, plainly: the equal-loudness filter, 50 ms
windows, the 12,000-bin loudness histogram, its 95th-percentile readout,
the peak and the album union.

Written from the ReplayGain 1.0 definition (gain_analysis.c) with the
semantics mp3gain's analysis has: samples scaled to 16-bit range; the
Yule-Walker stage, then the Butterworth stage, each adding 1e-10 at every
step, from zero state; windows of sample_rate * 50 // 1000 samples, the
trailing partial window counted with its own length; a mono channel
counted as both; bin = trunc(1000 * log10(mean square + 1e-37)) + 2000,
dropped outside [0, 12000); loudness = (bin - 2000) / 100 at the topmost
bin where the count from the top reaches ceil(total * 0.05); gain =
64.82 - loudness. Runs in float64 by default; `dtype=np.float32` gives the
lower-precision control.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
from scipy.signal import lfilter

_C = json.load(open(os.path.join(os.path.dirname(__file__), "replaygain_coeffs.json")))

PINK_REF = 64.82
HISTOGRAM_SIZE = 12000
OFFSET = 2000


def filter_stages(sample_rate: int, dtype=np.float64):
    """[(b, a), (b, a)]: the Yule-Walker stage, then the Butterworth one."""
    key = str(sample_rate)
    return [(np.asarray(_C["yule_b"][key], dtype), np.asarray(_C["yule_a"][key], dtype)),
            (np.asarray(_C["butter_b"][key], dtype), np.asarray(_C["butter_a"][key], dtype))]


def equal_loudness(x: np.ndarray, sample_rate: int, dtype=np.float64) -> np.ndarray:
    """(C, T) samples at 16-bit scale through both stages, in `dtype`. The
    constant added at every step enters by linearity."""
    out = np.asarray(x, dtype)
    ones = np.ones(out.shape[-1], dtype)
    for b, a in filter_stages(sample_rate, dtype):
        out = (lfilter(b, a, out, axis=-1)
               + dtype(_C["denormal_prevention"]) * lfilter(np.ones(1, dtype), a, ones))
    return out.astype(dtype, copy=False)


def window_sums(squares: np.ndarray, sample_rate: int) -> tuple[np.ndarray, np.ndarray]:
    """Per 50 ms window: (lsum + rsum, samples in the window) of (C, T)
    squared filter output; a mono channel counts twice."""
    w = sample_rate * 50 // 1000
    c, t = squares.shape
    n = -(-t // w)
    padded = np.zeros((c, n * w), squares.dtype)
    padded[:, :t] = squares
    sums = padded.reshape(c, n, w).sum(axis=(0, 2)) * (2 if c == 1 else 1)
    counts = np.full(n, w, np.int64)
    counts[-1] = t - (n - 1) * w
    return sums, counts


def histogram(sums: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The loudness histogram of windows' square sums."""
    ms = sums / counts * 0.5
    val = 100 * 10 * np.log10(ms + 1e-37)
    idx = np.trunc(val).astype(np.int64) + OFFSET
    hist = np.zeros(HISTOGRAM_SIZE, np.int64)
    ok = (idx >= 0) & (idx < HISTOGRAM_SIZE)
    np.add.at(hist, idx[ok], 1)
    return hist


def loudness(hist: np.ndarray) -> float:
    """95th-percentile readout in dB (-20.0 for an empty histogram)."""
    total = int(hist.sum())
    if total == 0:
        return -20.0
    need = math.ceil(total * (1.0 - 0.95))
    top = np.cumsum(hist[::-1])
    k = int(np.argmax(top >= need))
    return ((HISTOGRAM_SIZE - 1 - k) - OFFSET) / 100.0


def gain(hist: np.ndarray) -> float:
    return PINK_REF - loudness(hist)


def track_histogram(pcm: np.ndarray, sample_rate: int, dtype=np.float64) -> np.ndarray:
    """Histogram of (C, T) PCM in [-1, 1] (channels past two ignored)."""
    x = np.asarray(pcm, dtype)[:2] * dtype(32768.0)
    f = equal_loudness(x, sample_rate, dtype)
    return histogram(*window_sums(f * f, sample_rate))


def album(hists, peaks) -> tuple[float, float]:
    """(album gain, album peak) of tracks' histograms and peaks."""
    total = np.sum(np.stack(hists), axis=0)
    return gain(total), max(peaks)
