"""A track file's ReplayGain answers (gain, peak, histogram) from its bytes.

The benchmark's tracks repeat one clip's audio frames N times (its tiler
writes them), and the reference works that out from the bytes rather than
being told: it finds the shortest run of frames whose bytes repeat to the
end of the stream. Where there is one, it decodes the first two copies
only. The second copy's decode is the decode of every later copy: a copy's
first frame borrows no reservoir bytes, and the decoder's state at a copy's
start (the IMDCT overlap and the polyphase FIFO) comes from the previous
copy's last granule, which is the same bytes each time. The filter is run
over the first three copies; the third must equal the second to 1e-6 at
16-bit scale (the filter has forgotten the first copy's start), which is
checked, and the filtered track is then the first copy followed by the
second repeated. Where the check fails or no period exists, the whole
stream is decoded and filtered.

Tracks cut from one clip at other levels differ only in global_gain, by
the same step s on every granule that carries audio. The decode is linear
in the requantized values, which scale by 2^(s/4), so such a track's PCM
is the first one's times 2^(s/4): the analyzer keeps one decode per run of
frames whose bytes agree once global_gain is masked out, and checks the
step is one number.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from . import mp3dec
from . import replaygain as rg


@dataclass
class TrackAnswer:
    gain: float
    peak: float
    histogram: np.ndarray
    sample_rate: int
    samples: int


def _frame_bytes(data, f):
    return bytes(data[f.offset:f.offset + f.size])


def period(data, frames) -> int | None:
    """Frames per copy where the stream is two or more copies of one run
    of frames, else None."""
    n = len(frames)
    fb = [_frame_bytes(data, f) for f in frames]
    for p in range(1, n // 2 + 1):
        if n % p or fb[p] != fb[0]:
            continue
        if all(fb[i] == fb[i + p] for i in range(n - p)):
            return p
    return None


def _gains(frames) -> np.ndarray:
    """global_gain of every granule-channel that carries audio bits (-1 for
    the others)."""
    return np.array([g["global_gain"] if g["part2_3_length"] else -1
                     for f in frames for row in f.gc for g in row])


def _masked_key(data, frames) -> bytes:
    """A digest of the frames' bytes with every global_gain zeroed."""
    start = frames[0].offset
    buf = bytearray(data[start:frames[-1].offset + frames[-1].size])
    for f in frames:
        for row in f.gc:
            for g in row:
                bit = (f.side_offset - start) * 8 + g["global_gain_bit"]
                for k in range(8):
                    b = bit + k
                    buf[b >> 3] &= ~(0x80 >> (b & 7)) & 0xFF
    return hashlib.sha1(bytes(buf)).digest()


class Analyzer:
    """Track answers in float64 on the CPU, or in a lower precision for the
    control: `dtype` torch.float32 on a CUDA device with TF32 allowed."""

    def __init__(self, dtype=torch.float64, device="cpu"):
        self.dtype = dtype
        self.device = device
        self.np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self._decoded: dict[bytes, tuple[np.ndarray, np.ndarray]] = {}

    def _pcm(self, data, frames) -> np.ndarray:
        key = _masked_key(data, frames)
        gains = _gains(frames)
        if key in self._decoded:
            base, base_gains = self._decoded[key]
            carried = gains >= 0
            steps = np.unique(gains[carried] - base_gains[carried])
            if len(steps) == 1:
                return base * self.np_dtype(2.0 ** (int(steps[0]) / 4.0))
        pcm = mp3dec.pcm_from(mp3dec.quantize_stream(data, frames), self.dtype,
                              self.device).cpu().numpy()
        self._decoded.setdefault(key, (pcm, gains))
        return pcm

    def _filtered_squares(self, d0, d1, reps, sr) -> np.ndarray:
        if reps >= 3:
            f = rg.equal_loudness(np.concatenate([d0, d1, d1], axis=1) * 32768.0, sr,
                                  self.np_dtype)
            n = d0.shape[1]
            f0, f1, f2 = f[:, :n], f[:, n:2 * n], f[:, 2 * n:]
            if np.abs(f2 - f1).max() <= 1e-6:
                sq0, sq1 = f0 * f0, f1 * f1
                return np.concatenate([sq0] + [sq1] * (reps - 1), axis=1)
        full = np.concatenate([d0] + [d1] * (reps - 1), axis=1) * 32768.0
        f = rg.equal_loudness(full, sr, self.np_dtype)
        return f * f

    def track(self, data: bytes) -> TrackAnswer:
        frames = mp3dec.walk(data, side_info=False)
        if not frames:
            raise ValueError("no Layer III audio frame")
        sr = frames[0].sample_rate
        p = period(data, frames)
        if p is None:
            pcm = self._pcm(data, mp3dec.parse_side(data, frames))
            d0, d1, reps = pcm, pcm[:, :0], 1
        else:
            pcm = self._pcm(data, mp3dec.parse_side(data, frames[:2 * p]))
            half = pcm.shape[1] // 2
            d0, d1, reps = pcm[:, :half], pcm[:, half:], len(frames) // p
        d0, d1 = d0[:2], d1[:2]
        peak = float(max(np.abs(d0).max(), np.abs(d1).max() if reps > 1 else 0.0))
        sq = self._filtered_squares(d0, d1, reps, sr)
        hist = rg.histogram(*rg.window_sums(sq, sr))
        return TrackAnswer(rg.gain(hist), peak, hist, sr, sq.shape[1])
