"""AAC device back-end: IMDCT, windowing and overlap-add as torch ops.

Counterpart of mp3rgain_tpu/decode/aac_synthesis.py. Consumes the native
front-end's natural-order requantized spectra (or aac_prep.prep_spectra's)
and produces PCM, for a batch of tracks at once:

- long sequences (ONLY_LONG / LONG_START / LONG_STOP): one unwindowed
  2048x1024 IMDCT GEMM over every row, then one multiply by the row's
  window, gathered from a 13-row table by (sequence, previous shape,
  current shape); row 12 is all zero and takes the EIGHT_SHORT rows;
- EIGHT_SHORT: four pre-windowed 2048x1024 matrices (the eight 256-point
  sub-IMDCTs overlap-add each other inside the matrix, so the window is
  folded in), one per (previous shape, current shape). Only the
  EIGHT_SHORT rows of each pair go through its GEMM: short_rows() lists
  them on the host, where the window sequences are, so nothing on the
  device reads a size back;
- overlap-add across frames is a shift (out = z[:1024] + previous
  z[1024:]), per track and per channel.

The JAX package multiplies every row by all five matrices and selects;
the values here equal its up to f32 rounding. Windows are sine or
Kaiser-Bessel-derived (alpha 4 long / 6 short), computed in float64 at
table-build time. GEMMs run in full f32 (device.apply_precision_policy).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy.special import i0 as _bessel_i0
from torch import nn

from ..device import mark_stage, resolve_device
from . import aac_frontend as af

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)
_ZERO_WINDOW = 12  # w_table's all-zero row


def _sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def _kbd_window(n: int, alpha: float) -> np.ndarray:
    m = n // 2
    t = (np.arange(m + 1) / m - 0.5) * 2.0
    w = _bessel_i0(np.pi * alpha * np.sqrt(np.clip(1.0 - t * t, 0.0, 1.0)))
    c = np.cumsum(w[:-1])
    half = np.sqrt(c / (c[-1] + w[-1]))
    # full window (rising half + mirrored falling half)
    return np.concatenate([half, half[::-1]])


def _half_windows(n: int):
    """(2, n/2) rising halves for shape 0 (sine) and 1 (KBD)."""
    alpha = 4.0 if n == 2048 else 6.0
    return np.stack([_sine_window(n)[: n // 2], _kbd_window(n, alpha)[: n // 2]])


def _imdct_matrix(n: int) -> np.ndarray:
    """Unwindowed IMDCT: out (n,) from (n/2,) coefficients."""
    n0 = (n / 2 + 1) / 2
    t = np.arange(n)[:, None]
    k = np.arange(n // 2)[None, :]
    return (2.0 / n) * np.cos(2.0 * np.pi / n * (t + n0) * (k + 0.5))


@lru_cache(maxsize=1)
def _tables():
    """(m_long (2048, 1024), w_long (3, 2, 2, 2048) by [sequence 0/1/3,
    previous shape, current shape], m_short (2, 2, 2048, 1024) by
    [previous shape, current shape]), float64: the JAX package's tables."""
    rise_long = _half_windows(2048)  # (2, 1024)
    rise_short = _half_windows(256)  # (2, 128)
    fall_long = rise_long[:, ::-1]
    fall_short = rise_short[:, ::-1]

    m_long = _imdct_matrix(2048)  # (2048, 1024)

    w_long = np.zeros((3, 2, 2, 2048))
    for prev in range(2):
        for cur in range(2):
            left_ol = rise_long[prev]
            right_ol = fall_long[cur]
            # ONLY_LONG
            w_long[0, prev, cur] = np.concatenate([left_ol, right_ol])
            # LONG_START: right = 448 ones + short fall + 448 zeros
            w_long[1, prev, cur] = np.concatenate(
                [left_ol, np.ones(448), fall_short[cur], np.zeros(448)]
            )
            # LONG_STOP: left = 448 zeros + short rise + 448 ones
            w_long[2, prev, cur] = np.concatenate(
                [np.zeros(448), rise_short[prev], np.ones(448), right_ol]
            )

    # EIGHT_SHORT pre-windowed matrices per (prev, cur).
    m256 = _imdct_matrix(256)  # (256, 128)
    m_short = np.zeros((2, 2, 2048, 1024))
    for prev in range(2):
        for cur in range(2):
            for w in range(8):
                wl = rise_short[prev] if w == 0 else rise_short[cur]
                win = np.concatenate([wl, fall_short[cur]])  # (256,)
                block = m256 * win[:, None]
                m_short[prev, cur, 448 + 128 * w : 448 + 128 * w + 256,
                        128 * w : 128 * (w + 1)] += block
    return m_long, w_long, m_short


def previous_shape(window_shape, n_channels: int):
    """Each frame-channel's previous frame's window shape: the (B, F)
    shapes shifted by one frame (n_channels lanes) along F, zero for a
    track's first frame. Works on numpy arrays and on tensors."""
    prev = window_shape.copy() if isinstance(window_shape, np.ndarray) \
        else window_shape.clone()
    prev[:, n_channels:] = window_shape[:, :-n_channels]
    prev[:, :n_channels] = 0
    return prev


def short_rows(window_seq: np.ndarray, window_shape: np.ndarray,
               n_channels: int) -> tuple[np.ndarray, tuple]:
    """The EIGHT_SHORT rows of a (B, F) batch, on the host: (rows (n,)
    int32 flat row indices b*F + f, grouped by (previous shape, current
    shape) pair in the order (0,0), (0,1), (1,0), (1,1); counts, the four
    group sizes)."""
    seq = np.asarray(window_seq)
    shape = np.asarray(window_shape)
    short = (seq == EIGHT_SHORT).reshape(-1)
    if not short.any():
        return np.zeros(0, np.int32), (0, 0, 0, 0)
    pair = (previous_shape(shape, n_channels).astype(np.int32) * 2
            + shape).reshape(-1)
    groups = [np.nonzero(short & (pair == k))[0] for k in range(4)]
    return (np.concatenate(groups).astype(np.int32),
            tuple(len(g) for g in groups))


class AacSynthesis(nn.Module):
    """The IMDCT tables as buffers (f32): m_long_t (1024, 2048), m_short_t
    (4, 1024, 2048) by 2*previous + current shape, w_table (13, 2048) by
    4*sequence index + 2*previous + current (row 12 zero), seq_index (4,)
    mapping a window sequence to its sequence index (EIGHT_SHORT to 3)."""

    def __init__(self):
        super().__init__()
        m_long, w_long, m_short = _tables()
        self.register_buffer(
            "m_long_t", torch.from_numpy(np.ascontiguousarray(m_long.T, np.float32)))
        self.register_buffer("m_short_t", torch.from_numpy(np.ascontiguousarray(
            m_short.reshape(4, 2048, 1024).transpose(0, 2, 1), np.float32)))
        w = np.concatenate([w_long.reshape(12, 2048), np.zeros((1, 2048))])
        self.register_buffer("w_table", torch.from_numpy(w.astype(np.float32)))
        self.register_buffer("seq_index", torch.tensor([0, 1, 3, 2]))

    def decode(self, spec, window_seq, window_shape, rows, counts, *,
               n_channels: int, on_stage=None):
        """spec (B, F, 1024) f32, window_seq and window_shape (B, F)
        integer tensors (F lanes are channel-paired frames, frame-major),
        rows and counts from short_rows() of the same windows (rows on
        spec's device) → PCM (B, C, F/C * 1024) f32."""
        bsz, fl, _ = spec.shape
        x = spec.reshape(bsz * fl, 1024)
        seq = window_seq.long()
        shape = window_shape.long()
        prev = previous_shape(shape, n_channels)
        widx = self.seq_index[seq] * 4 + prev * 2 + shape
        widx = torch.where(seq == EIGHT_SHORT, _ZERO_WINDOW, widx).reshape(-1)

        z = torch.matmul(x, self.m_long_t)  # (R, 2048)
        z *= self.w_table[widx]
        mark_stage(on_stage, "long GEMM + windows")
        off = 0
        for k, n in enumerate(counts):
            if n:
                r = rows[off : off + n].long()
                z.index_copy_(0, r, torch.matmul(x.index_select(0, r),
                                                 self.m_short_t[k]))
                off += n
        mark_stage(on_stage, "short GEMMs")

        # Overlap-add across frames, per track and channel.
        t = fl // n_channels
        z = z.view(bsz, t, n_channels, 2048)
        out = z[..., :1024].clone()
        out[:, 1:] += z[:, :-1, :, 1024:]
        del z
        pcm = out.permute(0, 2, 1, 3).reshape(bsz, n_channels, t * 1024)
        mark_stage(on_stage, "overlap-add")
        return pcm


def decode_unpacked(u: af.UnpackedAac, *, device="cuda",
                    synthesis: AacSynthesis | None = None):
    """One host-decoded track → (pcm (C, N) tensor on `device`, sample
    rate)."""
    if u.n == 0:
        return torch.zeros((1, 0)), 0
    dev = resolve_device(device)
    nch = u.n_channels or 1
    n = (u.n // nch) * nch
    syn = synthesis or AacSynthesis().to(dev)
    wseq = u.info[None, :n, af.WINDOW_SEQ]
    wshape = u.info[None, :n, af.WINDOW_SHAPE]
    rows, counts = short_rows(wseq, wshape, nch)
    pcm = syn.decode(
        torch.from_numpy(u.spec[None, :n]).to(dev),
        torch.from_numpy(wseq).to(dev), torch.from_numpy(wshape).to(dev),
        torch.from_numpy(rows).to(dev), counts, n_channels=nch)
    return pcm[0], u.sample_rate


def decode_file(path, track_index=None, *, device="cuda",
                synthesis: AacSynthesis | None = None):
    """Full-file AAC decode of one track (an MP4's first audio track by
    default); returns (pcm (C, N) np array, sample_rate)."""
    u = af.unpack_file(path, track_index=track_index)
    pcm, sr = decode_unpacked(u, device=device, synthesis=synthesis)
    return pcm.cpu().numpy(), sr
