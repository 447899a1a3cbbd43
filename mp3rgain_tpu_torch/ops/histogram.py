"""50 ms RMS windows, loudness histogram, and the 95th-percentile readout.

Counterpart of mp3rgain_tpu/ops/histogram.py, with the reference
analyzer's semantics (the Rust mp3rgain, src/replaygain.rs:624-771):

- windows of sample_rate*50/1000 samples; the trailing partial window is
  flushed with its own (smaller) sample count;
- mean_square = (lsum + rsum) / totsamp * 0.5 (mono adds the same square
  to both sums);
- bin index = trunc(100 * 10 * log10(ms + 1e-37)) + 2000, truncation
  toward zero, dropped when outside [0, 12000);
- loudness = (i - 2000)/100 for the topmost bin where the top-down
  cumulative count reaches total // 20 + 1 (the reference's
  ceil(total * (1.0 - 0.95)) for every attainable total).

The histogram is an index_add over flattened (track, bin) offsets, with
the windows that count for nothing sent to one dummy bin: no boolean
indexing and no bincount, both of which read a size back to the host and
would stall a pipelined runner. The JAX package's (B, windows, 12000)
compare-reduce was a workaround for TPU scatter lowering.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HISTOGRAM_SIZE = 12000
STEPS_PER_DB = 100.0
HISTOGRAM_OFFSET = 2000
RMS_PERCENTILE = 0.95
RMS_WINDOW_MS = 50


def window_size(sample_rate: int) -> int:
    return (sample_rate * RMS_WINDOW_MS) // 1000


def bin_index(val: torch.Tensor) -> torch.Tensor:
    """int32 bin index of each window's 100 * 10 * log10(ms): XLA's
    float -> int32 convert (truncation toward zero, NaN -> 0, saturating at
    the int32 range) then the int32 add of HISTOGRAM_OFFSET with its wrap,
    as the JAX package computes it. Written out in tensor ops because
    torch's .to(torch.int32) of NaN or of an out-of-range value depends on
    the device (INT_MIN on an x86 CPU, 0 for NaN on the card): a window
    whose mean square is NaN lands in bin 2000 on every device."""
    lim = 2.0 ** 31
    v = torch.where(torch.isnan(val), torch.zeros_like(val), val)
    v = v.clamp(-lim, lim).to(torch.int64).clamp(-(1 << 31), (1 << 31) - 1)
    wrapped = (v + HISTOGRAM_OFFSET + (1 << 31)) % (1 << 32) - (1 << 31)
    return wrapped.to(torch.int32)


def histogram(filtered: torch.Tensor, valid_len: torch.Tensor,
              win: int) -> torch.Tensor:
    """filtered: (B, C, T) equal-loudness output; valid_len: (B,) valid
    samples per channel. Returns (B, HISTOGRAM_SIZE) int32 histograms."""
    b, c, t = filtered.shape
    n_win = -(-t // win)
    f = F.pad(filtered, (0, n_win * win - t))
    sq = (f * f).reshape(b, c, n_win, win)

    idx = torch.arange(n_win * win, device=f.device).reshape(n_win, win)
    mask = (idx[None] < valid_len.view(b, 1, 1)).to(f.dtype)  # (B, n_win, win)

    # lsum + rsum: mono (C == 1) doubles the same square into both sums.
    ch_sum = sq.sum(dim=1) * (2.0 if c == 1 else 1.0)  # (B, n_win, win)
    sums = (ch_sum * mask).sum(dim=-1)  # (B, n_win)
    totsamp = mask.sum(dim=-1)

    ms = sums / torch.clamp(totsamp, min=1.0) * 0.5
    val = STEPS_PER_DB * 10.0 * torch.log10(ms + 1e-37)
    bin_idx = bin_index(val)
    ok = (totsamp > 0) & (bin_idx >= 0) & (bin_idx < HISTOGRAM_SIZE)

    track = torch.arange(b, device=f.device).view(b, 1)
    dummy = b * HISTOGRAM_SIZE  # windows outside the histogram land here
    flat = torch.where(ok, track * HISTOGRAM_SIZE + bin_idx.long(), dummy).reshape(-1)
    hist = torch.zeros(dummy + 1, dtype=torch.int32, device=f.device)
    hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist[:dummy].view(b, HISTOGRAM_SIZE)


def loudness_index(hist: torch.Tensor) -> torch.Tensor:
    """95th-percentile readout, (B, 12000) -> (B,) int32 bin index (-1 for
    an empty histogram)."""
    total = hist.sum(dim=1)
    threshold = total // 20 + 1
    rev = torch.cumsum(hist.flip(1), dim=1)
    k = torch.argmax((rev >= threshold[:, None]).to(torch.int32), dim=1)
    idx = HISTOGRAM_SIZE - 1 - k
    return torch.where(total > 0, idx, -1).to(torch.int32)


def index_to_loudness(idx: int) -> float:
    return -20.0 if idx < 0 else (int(idx) - HISTOGRAM_OFFSET) / STEPS_PER_DB


def loudness_from_histogram(hist: np.ndarray) -> float:
    """95th-percentile loudness readout of one histogram on the host (the
    JAX package's host readout, reference-exact arithmetic); scan's album
    union uses it."""
    hist = np.asarray(hist, dtype=np.uint64)
    total = int(hist.sum())
    if total == 0:
        return -20.0
    threshold = int(np.ceil(total * (1.0 - RMS_PERCENTILE)))
    rev_cum = np.cumsum(hist[::-1])
    k = int(np.argmax(rev_cum >= threshold))
    if rev_cum[k] < threshold:
        return -20.0
    return ((HISTOGRAM_SIZE - 1 - k) - HISTOGRAM_OFFSET) / STEPS_PER_DB
