"""Device-side AAC spectral prep: requantize + PNS + stereo as torch ops.

Counterpart of mp3rgain_tpu/decode/aac_prep.py. The host ships QUANTIZED
integer coefficients plus per-band metadata
(decode/aac_frontend.unpack_adts_q, aac.prepare_batch_arrays_aac_q), and
prep_spectra replays ISO 14496-3 requantization (|q|^(4/3) *
2^(0.25(sf-100)), 4.6.3), perceptual noise substitution (4.6.13) and M/S +
intensity stereo (4.6.8) over the whole batch. Per-band values reach
their coefficients through one index gather (band_index: the long-window
scalefactor band of each of the 1024 coefficients); the JAX package's
one-hot (bands -> 1024) expansion products existed for its matrix unit.
The per-band noise energy stays one matrix product.

The transfer form is the JAX package's: two signed 4-bit coefficients per
byte with every |q| > 7 coefficient in a sparse escape sideband (flat
index row*1024+pos, exact int16 value) that an index_add reconstructs
exactly; one uint16 of metadata per band — bits 0-11 the scalefactor /
PNS energy / intensity position biased by +2048, bits 12-14 the band
type, bit 15 ms_used — over n_bands(sr) slots. Frames this path cannot
express (EIGHT_SHORT windows, TNS, |q| > int16) arrive as fully
host-decoded block-scaled f16 fallback rows and overwrite their rows at
the end (frame-granular, so a computed lane never reads a fallback lane
through the stereo coupling).

PNS noise is decoder-specific by design (energies must match, values need
not); this path uses the JAX package's counter-hash LCG keyed by (row,
position), bit for bit, energy-normalized per band exactly like the host
(_native/aacdec.cpp apply_pns).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..device import mark_stage as _stage
from .aac_format_tables import SWB_1024_MAP, SWB_LONG_TABLES
from .aac_frontend import ADTS_SR_INDEX

N_BANDS = 64  # host-side band slots (num_swb <= 51 for all rates)


@lru_cache(maxsize=None)
def n_bands(sample_rate: int) -> int:
    """Transfer band-slot count for one sample rate: the long-window
    num_swb rounded up to a multiple of 4. The host decoder's fixed
    64-slot form is trimmed to this before transfer (slots past num_swb
    are always zero)."""
    swb = SWB_LONG_TABLES[SWB_1024_MAP[ADTS_SR_INDEX[sample_rate]]]
    return -(-(len(swb) - 1) // 4) * 4


@lru_cache(maxsize=None)
def band_index(sample_rate: int) -> np.ndarray:
    """(1024,) int64: each coefficient's long-window scalefactor band (the
    device path never sees EIGHT_SHORT frames)."""
    swb = SWB_LONG_TABLES[SWB_1024_MAP[ADTS_SR_INDEX[sample_rate]]]
    idx = np.zeros(1024, np.int64)
    for k in range(len(swb) - 1):
        idx[swb[k] : swb[k + 1]] = k
    return idx


def fallback_rows(fbmap: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The packer's row-gather map (identity, or R + j for a fallback
    lane) as (dst, src): fallback row src[i] overwrites spectrum row
    dst[i]. On the host, so the device needs no search."""
    fbmap = np.asarray(fbmap)
    dst = np.nonzero(fbmap >= len(fbmap))[0]
    return dst.astype(np.int64), (fbmap[dst] - len(fbmap)).astype(np.int64)


def unpack_nibbles(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 bytes → (low, high) signed 4-bit values, int8 (int8 shifts
    wrap and sign-extend)."""
    return (b << 4) >> 4, b >> 4


def unpack_quantized(spec_q4, esc_idx, esc_val) -> torch.Tensor:
    """The transfer form → the quantized coefficients (R, 1024) as exact
    integers in f32: spec_q4 (B, F, EXT/2) int8 nibble pairs over the
    coded extent, zero past it, then the escape sideband added at its flat
    indices (each position holds at most one nonzero escape and its
    nibble is 0; padding entries add 0 at index 0)."""
    bsz, fl, exth = spec_q4.shape
    rows = bsz * fl
    lo, hi = unpack_nibbles(spec_q4.reshape(rows, exth))
    q = torch.zeros((rows, 1024), dtype=torch.float32, device=spec_q4.device)
    q[:, 0 : 2 * exth : 2] = lo
    q[:, 1 : 2 * exth : 2] = hi
    q.view(-1).index_add_(0, esc_idx, esc_val.to(torch.float32))
    return q


class AacPrep(nn.Module):
    """One sample rate's constants as buffers: band (1024,) int64, the
    coefficient → band gather index; band_sum (1024, n_bands) f32, its
    one-hot form for the per-band noise energy; lcg (3,) int32, the noise
    hash's multiplier constants (int32 tensors, so every product wraps in
    int32); col (1024,) int32."""

    def __init__(self, sample_rate: int):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_bands = n_bands(sample_rate)
        idx = band_index(sample_rate)
        self.register_buffer("band", torch.from_numpy(idx.copy()))
        onehot = np.zeros((1024, self.n_bands), np.float32)
        onehot[np.arange(1024), idx] = 1.0
        self.register_buffer("band_sum", torch.from_numpy(onehot))
        self.register_buffer("lcg", torch.tensor(
            [-1640531527, 1664525, 1013904223], dtype=torch.int32))
        self.register_buffer("col", torch.arange(1024, dtype=torch.int32))

    def noise_uniform(self, rows: int) -> torch.Tensor:
        """(rows, 1024) deterministic white noise in [-1, 1): an LCG-style
        integer hash keyed by (row, column). int32 products wrap (two's
        complement) and >> is arithmetic, which is exactly the JAX
        package's _noise_uniform."""
        knuth, mul, inc = self.lcg  # 2654435761 as int32 (Knuth hash)
        row = torch.arange(rows, dtype=torch.int32, device=self.col.device)
        s = (row[:, None] * 1024 + self.col[None, :]) * knuth
        s ^= s >> 16
        s = s.mul_(mul).add_(inc)
        s ^= s >> 13
        s = s.mul_(mul).add_(inc)
        return s.to(torch.float32).mul_(1.0 / 2147483648.0)

    def prep_spectra(self, spec_q4, meta, esc_idx, esc_val, fb16, fbexp,
                     fb_dst, *, n_channels: int, on_stage=None):
        """Quantized batch → requantized natural-order spectra (B, F,
        1024) f32.

        spec_q4 (B, F, EXT/2) int8, two signed nibbles per byte (low
        nibble = even coefficient), trimmed to the batch's coded-band
        extent; esc_idx/esc_val the escape sideband (padding entries add
        0 at index 0); meta (B, F, n_bands) uint16 bits (as int16 or
        wider) = (lvl + 2048) | btype << 12 | ms_used << 15; fb16 (n_fb,
        1024) f16 and fbexp (n_fb,) int8 the fallback rows and fb_dst
        (n_fb,) int64 the flat rows they overwrite (fallback_rows).
        on_stage, if given, is called with a stage's name as each stage
        has been enqueued."""
        bsz, fl, _ = spec_q4.shape
        rows = bsz * fl
        nb = self.n_bands
        band = self.band

        q = unpack_quantized(spec_q4, esc_idx, esc_val)
        _stage(on_stage, "nibble unpack + escapes")

        m = meta.reshape(rows, nb).to(torch.int32) & 0xFFFF
        btype = (m >> 12) & 7
        msb = (m >> 15) & 1
        lvlf = (m & 0xFFF).to(torch.float32) - 2048.0

        # Requantize: sign(q) * |q|^(4/3) * 2^(0.25 (sf - 100) - 15), the -15
        # mapping int16 full scale to 1.0 (host parse_scale_factor_data).
        gain_b = torch.exp2(0.25 * (lvlf - 100.0) - 15.0)
        gain_c = torch.where(btype == 1, gain_b, 0.0)[:, band]  # (R, 1024)
        spec = torch.pow(q.abs(), 4.0 / 3.0).mul_(torch.sign(q)).mul_(gain_c)
        del q, gain_c
        _stage(on_stage, "requantize")

        # PNS: energy-normalized white noise per band (host apply_pns).
        r = self.noise_uniform(rows)
        e_band = torch.matmul(r * r, self.band_sum)  # (R, nb) raw noise energy
        scale_b = (btype == 2) * gain_b * torch.rsqrt(e_band + 1e-30)
        spec.addcmul_(r, scale_b[:, band])
        del r
        _stage(on_stage, "PNS")

        if n_channels == 2:
            # M/S + intensity, replaying _native/aacdec.cpp apply_stereo:
            # per band (flags from the RIGHT channel): intensity bands
            # reconstruct right from (post-PNS, pre-M/S) left; else ms_used
            # bands that are not noise get l,r = l+r, l-r.
            t = fl // 2
            sp = spec.view(bsz, t, 2, 1024)
            bt_r = btype.view(bsz, t, 2, nb)[:, :, 1]
            ms_r = msb.view(bsz, t, 2, nb)[:, :, 1]
            isp_r = lvlf.view(bsz, t, 2, nb)[:, :, 1]
            left = sp[:, :, 0]
            right = sp[:, :, 1]

            is_b = (bt_r == 3) | (bt_r == 4)
            sgn_b = torch.where(bt_r == 3, 1.0, -1.0)
            sgn_b = torch.where(ms_r > 0, -sgn_b, sgn_b)  # ms_used inverts
            is_scale_b = torch.where(is_b, sgn_b * torch.exp2(-0.25 * isp_r), 0.0)
            ms_b = (ms_r > 0) & (~is_b) & (bt_r != 2)

            is_c = is_b[..., band]
            ms_c = ms_b[..., band]
            l2 = torch.where(ms_c, left + right, left)
            r2 = torch.where(is_c, is_scale_b[..., band] * left,
                             torch.where(ms_c, left - right, right))
            spec = torch.stack([l2, r2], dim=2).view(rows, 1024)
            del l2, r2, sp, left, right
        _stage(on_stage, "stereo")

        # Fallback merge: host-decoded rows overwrite their rows entirely.
        if fb16.shape[0]:
            fb = fb16.to(torch.float32) * torch.exp2(fbexp.to(torch.float32))[:, None]
            spec.index_copy_(0, fb_dst, fb)
        _stage(on_stage, "fallback merge")
        return spec.view(bsz, fl, 1024)
