"""Batched ReplayGain analysis on one device or several, over both MP3 routes.

Counterpart of mp3rgain_tpu/parallel/runner.py: Runner is its MeshRunner on
one device, RunnerGroup its MeshRunner over several (one Runner per
device, independent launches instead of shard_map), and analyze_library
deals a library's batches across the Runners it is given.

The raw-bits ("light") route, the main path: host light walk → host lane
plan and each row's used words in walk order
(prepare_batch_arrays_light_compact) → host-to-device upload (Runner:
pinned staging and a copy stream on CUDA) → the lane pack (K0, CUDA) into
the decode's lane-major input → the row map (dest_rows) → Huffman decode
(K1, CUDA) straight into K2's channel-major rows → scalefactor and info gathers →
requantize + stereo (K2, CUDA) → hybrid synthesis (K4, CUDA) →
overlap-add and polyphase synthesis (K5, CUDA) → equal-loudness IIR → RMS-window histogram → 95th-percentile index.

The host-decoded ("heavy") route: host full decode (frontend.unpack_data)
→ padded compact manifest (prepare_batch_arrays) → the same upload →
spectrum unpack → analysis_tail: the decode back-end of decode.synthesis
(requantize, stereo, class-core GEMMs in K3, polyphase GEMMs) → the same
IIR, histogram and index. light_tail(fused=False) feeds the light
route's decode (K1 into track-major rows) into that same analysis_tail,
so the two routes agree exactly.

The two AAC routes (aac.py: device prep over quantized coefficients, and
the host-requant f16 oracle) ride the same Runner: prepare_aac_q /
prepare_aac, then launch and collect as for MP3.

The host packers are copies of the JAX package's, held bit-identical by
the tests; the copied lane pack (prepare_batch_arrays_light, then
analysis_core_light on its buf and meta) is the oracle the lane plan and
K0 are held to. The per-track histograms, indices and peaks come back to the
host. Tracks in one batch share a sample rate and channel count; their
constant tables live as buffers of one LightTail module.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import threading
import time
from collections import deque
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..decode import entropy_kernel as ek
from ..decode import frontend as fe
from ..decode import hybrid_kernel as hk
from ..decode.format_tables import SR_ROW
from ..decode.synthesis import (DecodeTables, GranuleBatch, _derive_fields, decode_batch,
                                overlap_polyphase)
from ..device import mark_stage as _stage
from ..device import require_cuda, resolve_device
from ..native import _lib
from ..ops import histogram as hi
from ..ops.iir import EqualLoudness
from ..replaygain import PINK_REF, ReplayGainResult
from ..utils import bufpool

SAMPLE_SCALE_16BIT = 32768.0

_B_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _quantize_up(value: int, unit: int, base: int, ratio: float) -> int:
    """Smallest ladder step >= value (geometric, unit-aligned)."""
    v = base
    while v < value:
        v = int(v * ratio)
        v = -(-v // unit) * unit
    return max(v, -(-value // unit) * unit)


def _light_shapes(unpacked: list, n_channels: int, pad_batch_to: int,
                  force_shapes: tuple | None):
    """(bpad, g_max, force_nb, force_g_pad, force_s, force_h) of a light
    batch: the padded batch size and row-map width, and the pinned
    shapes (None where free)."""
    if force_shapes is not None:
        return tuple(force_shapes)
    g_max = _quantize_up(max(u.n for u in unpacked), 2 * n_channels, base=512, ratio=1.3)
    bpad = next((b for b in _B_LADDER if b >= len(unpacked)), len(unpacked))
    bpad = -(-bpad // pad_batch_to) * pad_batch_to
    return bpad, g_max, None, None, None, None


def prepare_batch_arrays_light(
    unpacked: list, n_channels: int,
    pad_batch_to: int = 1,
    force_shapes: tuple | None = None,
):
    """Pack light-unpacked tracks for analysis_core_light: the copied
    host lane pack, a reference the tests (and the lane plan and K0) are
    held to, not the main path (prepare_batch_arrays_light_compact).

    Returns (prep: PreparedEntropy,
    (counts, scf, srow, sdata, hrow, hdata, info, valid_samples),
    g_max). counts[b] is track b's granule-channel record count (tracks
    pack back-to-back in input order, so the counts carry the whole
    (B, G) row map). scf and info are FLAT in the same back-to-back row
    order — (npad, 12) uint8 nibbles / (npad, 2) uint16 words for
    npad = nb*LANES. srow/sdata + hrow/hdata are the split-scf sidebands
    (fe.pack_scf_rows; padding entries point at the dummy row npad).
    g_max (quantized) sizes the row map. force_shapes = (bpad, g_max,
    nb, g_pad, s_pad, h_pad) pins all shapes. The big arrays (buf, meta,
    scf, info) come from the shared buffer pool: hand them back once the
    device copy has completed."""
    bpad, g_max, force_nb, force_g, force_s, force_h = _light_shapes(
        unpacked, n_channels, pad_batch_to, force_shapes)
    prep = ek.prepare_batch(
        [u.md for u in unpacked], [u.meta for u in unpacked],
        quantize_nb=True, force_nb=force_nb, force_g_pad=force_g,
    )
    rows = _light_rows(unpacked, n_channels, prep.nb * ek.LANES, bpad, force_s, force_h)
    return prep, rows, g_max


def prepare_batch_arrays_light_compact(unpacked: list, n_channels: int):
    """prepare_batch_arrays_light with ek.prepare_batch_compact's plan in
    place of ek.prepare_batch's packed blocks: (prep: CompactEntropy, the
    same rows, g_max), for analysis_core_light_compact. The shapes are
    free (the ladders'). The big arrays (prep.pooled, scf, info) come from
    the shared buffer pool: hand them back once the device copy has
    completed."""
    bpad, g_max, *_ = _light_shapes(unpacked, n_channels, 1, None)
    prep = ek.prepare_batch_compact(
        [u.md for u in unpacked], [u.meta for u in unpacked], quantize_nb=True)
    rows = _light_rows(unpacked, n_channels, prep.nb * ek.LANES, bpad, None, None)
    return prep, rows, g_max


def _light_rows(unpacked: list, n_channels: int, npad: int, bpad: int,
                force_s: int | None, force_h: int | None):
    """The light batch's rows beside its entropy input: (counts, scf, srow,
    sdata, hrow, hdata, info, valid_samples), prepare_batch_arrays_light's."""
    bsz = len(unpacked)
    counts = np.zeros(bpad, np.int32)
    counts[:bsz] = [u.n for u in unpacked]
    info = bufpool.take_zeroed((npad, fe.IP_N), np.uint16)
    scf = bufpool.take_zeroed((npad, fe.SCF_MAIN_BYTES), np.uint8)

    side_rows: list = []
    side_data: list = []
    hi_rows: list = []
    hi_data: list = []
    cap = max((u.n for u in unpacked), default=1) or 1
    srow_t = np.empty(cap, np.int32)
    sdata_t = np.empty((cap, fe.SCF_SIDE_BYTES), np.uint8)
    hrow_t = np.empty(cap, np.int32)
    hmask_t = np.empty((cap, fe.SCF_HI_BYTES), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ns_c = ctypes.c_int64()
    nh_c = ctypes.c_int64()
    off = 0
    for u in unpacked:
        if not u.n:
            continue
        if hasattr(u, "ip"):
            # Packed or stream walk (fe.unpack_data_light_packed /
            # _stream): the rows ARE the transfer form — plain row copies.
            info[off : off + u.n] = u.ip
            scf[off : off + u.n] = u.scf_main
            if len(u.srows):
                side_rows.append(u.srows + off)
                side_data.append(u.sdata)
            if len(u.hrows):
                hi_rows.append(u.hrows + off)
                hi_data.append(u.hmask)
            off += u.n
            continue
        tinfo = np.ascontiguousarray(u.info, dtype=np.int32)
        tscf = np.ascontiguousarray(u.scf, dtype=np.int32)
        rc = _lib.mg_pack_light_track(
            tinfo.ctypes.data_as(i32p), tscf.ctypes.data_as(i32p),
            ctypes.c_int64(u.n),
            info[off:].ctypes.data_as(u16p),
            scf[off:].ctypes.data_as(u8p),
            srow_t.ctypes.data_as(i32p), sdata_t.ctypes.data_as(u8p),
            hrow_t.ctypes.data_as(i32p), hmask_t.ctypes.data_as(u8p),
            ctypes.c_int64(off), ctypes.byref(ns_c), ctypes.byref(nh_c),
        )
        if rc != 0:
            raise ValueError("scalefactor slot exceeds 5 bits")
        if ns_c.value:
            side_rows.append(srow_t[: ns_c.value].copy())
            side_data.append(sdata_t[: ns_c.value].copy())
        if nh_c.value:
            hi_rows.append(hrow_t[: nh_c.value].copy())
            hi_data.append(hmask_t[: nh_c.value].copy())
        off += u.n

    def _sideband(rows_l, data_l, width, force, base):
        n = int(sum(len(r) for r in rows_l))
        pad = _quantize_up(max(n, 1), 8, base=base, ratio=4.0)
        if force is not None:
            assert force >= pad or force >= n, (force, n)
            pad = max(force, pad) if force < pad else force
        # Padding entries scatter zero rows into the dummy slot npad.
        rows = np.full(pad, npad, np.int32)
        data = np.zeros((pad, width), np.uint8)
        if n:
            rows[:n] = np.concatenate(rows_l)
            data[:n] = np.concatenate(data_l)
        return rows, data

    srow, sdata = _sideband(
        side_rows, side_data, fe.SCF_SIDE_BYTES, force_s, base=256
    )
    hrow, hdata = _sideband(
        hi_rows, hi_data, fe.SCF_HI_BYTES, force_h, base=64
    )
    valid_samples = np.array(
        [u.n // n_channels * 576 for u in unpacked] + [0] * (bpad - bsz),
        dtype=np.int32,
    )
    return counts, scf, srow, sdata, hrow, hdata, info, valid_samples


def prepare_batch_arrays(unpacked: list, n_channels: int,
                         pad_batch_to: int = 1):
    """Pack host-decoded tracks into padded arrays for analysis_core.

    Uses narrow transfer dtypes: huffman values fit int16 (|x| <= 15 +
    2^13), scalefactors fit int8. Returns the positional arg tuple of
    analysis_core (spec_i8, esc_idx, esc_val, scf, info, valid_samples).
    G pads to the light route's shape ladder, so equal batches give
    equal shapes on both routes."""
    bsz = len(unpacked)
    g_max = max(u.n for u in unpacked)
    unit = 2 * n_channels
    g_max = _quantize_up(g_max, unit, base=512, ratio=1.3)
    bpad = next((b for b in _B_LADDER if b >= bsz), bsz)
    bpad = -(-bpad // pad_batch_to) * pad_batch_to

    def pad_tracks(get, shape_tail, dtype=np.int32):
        out = np.zeros((bpad, g_max) + shape_tail, dtype=dtype)
        for i, u in enumerate(unpacked):
            a = get(u)
            out[i, : a.shape[0]] = a
        return out

    info = pad_tracks(lambda u: u.info, (fe.INFO_N,))
    spectrum = pad_tracks(lambda u: u.spectrum, (576,), dtype=np.int16)
    scf = pad_tracks(lambda u: u.scf, (64,), dtype=np.int8)
    valid_samples = np.array(
        [u.n // n_channels * 576 for u in unpacked] + [0] * (bpad - bsz),
        dtype=np.int32,
    )

    # Compact transfer form: trim to the nonzero spectral extent (rounded
    # to keep the shape population small), clip to int8, and ship the
    # rare |v| > 127 escapes as a sparse sideband.
    rzero = np.maximum(info[:, :, fe.BIG_END], info[:, :, fe.COUNT1_END])
    ext = min(576, max(96, int(-(-int(rzero.max()) // 96) * 96)))
    spec_t = spectrum[:, :, :ext]
    flat = spec_t.reshape(-1, ext)
    mask = np.abs(flat) > 127
    counts = mask.sum(axis=1)
    n_esc = max(4, int(-(-max(int(counts.max()), 1) // 4) * 4))
    esc_idx = np.full((flat.shape[0], n_esc), 576, dtype=np.int16)
    esc_val = np.zeros((flat.shape[0], n_esc), dtype=np.int16)
    rows, cols = np.nonzero(mask)
    if len(rows):
        pos = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
        esc_idx[rows, pos] = cols
        esc_val[rows, pos] = flat[rows, cols]
    spec_i8 = np.clip(spec_t, -127, 127).astype(np.int8)
    g_max = spectrum.shape[1]
    esc_idx = esc_idx.reshape(bpad, g_max, n_esc)
    esc_val = esc_val.reshape(bpad, g_max, n_esc)
    return (spec_i8, esc_idx, esc_val, scf, info, valid_samples)


# ---------------------------------------------------------------------------
# Device pipeline.
# ---------------------------------------------------------------------------


class LightTail(nn.Module):
    """The constant tables of both routes for one (sample rate, channel
    count), as buffers: the Huffman tables (luts), the K2 gather tables,
    the hybrid cores and K4's compact maps (hybrid), the decode back-end's
    tables, K3 cores, polyphase maps and K5's taps (decode) and the
    equal-loudness solve
    (iir). constants.from_jax_arrays builds the same state from the JAX
    package's builders."""

    def __init__(self, sample_rate: int, n_channels: int):
        super().__init__()
        if n_channels not in (1, 2):
            raise ValueError(f"n_channels {n_channels}")
        self.sample_rate = sample_rate
        self.n_channels = n_channels
        self.luts = ek.EntropyLuts()
        self.hybrid = hk.HybridTables(SR_ROW[sample_rate])
        self.decode = DecodeTables(SR_ROW[sample_rate])
        self.iir = EqualLoudness(sample_rate)


def _rowmap_from_counts(counts: torch.Tensor, g_max: int, npad: int):
    """(B,) per-track granule-channel counts → (B, g_max) int64 row map.

    Track b's records occupy decoded rows [offs_b, offs_b + n_b) in input
    order; empty padding slots map to npad (the dummy zero row)."""
    counts = counts.long()
    offs = torch.cumsum(counts, 0) - counts
    g_idx = torch.arange(g_max, device=counts.device)
    return torch.where(
        g_idx[None, :] < counts[:, None],
        offs[:, None] + g_idx[None, :],
        npad,
    )


def _expand_scf_flat(scf, srow, sdata, hrow, hdata):
    """Expand the flat split scalefactor transfer form (fe.pack_scf_rows)
    into the (npad + 1, 64) int32 slot tensor: dense (npad, 12) uint8
    nibbles of slots 0..23, a sparse short-window sideband (srow flat row
    index, sdata (S, 20) nibbles of slots 24..63) and a sparse high-bit
    sideband (hrow, hdata (H, 8) bitmasks adding 16 to flagged slots).
    Row npad is the zero dummy the row map's padding slots gather."""
    npad = scf.shape[0]
    dev = scf.device
    s = scf.to(torch.int32)
    lo = torch.stack([(s >> 4) & 15, s & 15], dim=-1).reshape(npad, 24)
    d = sdata.to(torch.int32)
    hi_nib = torch.stack([(d >> 4) & 15, d & 15], dim=-1).reshape(
        d.shape[0], fe.SCF_SLOTS - 24
    )
    full = torch.zeros((npad + 1, fe.SCF_SLOTS), dtype=torch.int32, device=dev)
    full[:npad, :24] = lo
    full[srow.long(), 24:] = hi_nib
    m = hdata.to(torch.int32)
    bits = (m[:, :, None] >> torch.arange(8, dtype=torch.int32, device=dev)) & 1
    full.index_put_((hrow.long(),),
                    16 * bits.reshape(m.shape[0], fe.SCF_SLOTS),
                    accumulate=True)
    return full


def _unpack_spectrum(spec_i8, esc_idx, esc_val):
    """Compact transfer form → (B, G, 576) int32 spectra: the int8 values
    over the trimmed extent, then the (index, value) escape sideband
    scattered into a 577-column buffer whose column 576 takes the
    padding escapes, then dropped."""
    b, g, ext = spec_i8.shape
    spec = torch.zeros((b, g, 577), dtype=torch.int32, device=spec_i8.device)
    spec[..., :ext] = spec_i8
    spec.scatter_(2, esc_idx.long(), esc_val.to(torch.int32))
    return spec[..., :576].contiguous()


def _expand_info_light(packed):
    """The light manifest's 2×uint16 info words (fe.pack_info_light) →
    the (..., INFO_N) int32 info tensor analysis_tail reads."""
    w0 = packed[..., 0].to(torch.int32)
    w1 = packed[..., 1].to(torch.int32)
    zero = torch.zeros_like(w0)
    cols = [zero] * fe.INFO_N
    cols[fe.GLOBAL_GAIN] = w0 & 255
    cols[fe.BLOCK_TYPE] = (w0 >> 8) & 3
    cols[fe.MIXED] = (w0 >> 10) & 1
    cols[fe.SCALEFAC_SCALE] = (w0 >> 11) & 1
    cols[fe.PREFLAG] = (w0 >> 12) & 1
    cols[fe.INTENSITY_SCALE] = (w0 >> 13) & 1
    cols[fe.CHANNEL_MODE] = (w0 >> 14) & 1  # joint flag; 1 == joint
    cols[fe.VERSION] = 1 + ((w0 >> 15) & 1)  # lsf bit -> version 2, else 1
    cols[fe.SBG0] = w1 & 7
    cols[fe.SBG1] = (w1 >> 3) & 7
    cols[fe.SBG2] = (w1 >> 6) & 7
    cols[fe.MODE_EXT] = (w1 >> 9) & 3
    cols[fe.SR_ROW] = (w1 >> 11) & 15
    return torch.stack(cols, dim=-1)


def analysis_tail(tail: LightTail, spectrum, scf, info, valid_samples):
    """Full (B, G, 576) spectra, (B, G, 64) scalefactors and (B, G,
    INFO_N) info → (hist (B, 12000) int32, loud_idx (B,) int32, peak (B,)
    f32): decode_batch, then the IIR, histogram and index. The JAX
    package's _analysis_tail, with its vmap over tracks as the batch
    dimension."""
    nch = tail.n_channels
    fields = _derive_fields(spectrum, scf, info.to(torch.int32), n_channels=nch)
    pcm = decode_batch(GranuleBatch(*fields, n_channels=nch), tail.decode)
    del fields
    bsz, c, n = pcm.shape
    sample_idx = torch.arange(n, device=pcm.device)
    peak_mask = sample_idx[None, None, :] < valid_samples[:, None, None]
    peak = (pcm.abs() * peak_mask).amax(dim=(1, 2))  # (B,)
    x = pcm.reshape(bsz * c, n) * SAMPLE_SCALE_16BIT
    del pcm
    filtered = tail.iir(x)[0].reshape(bsz, c, n)
    hist = hi.histogram(filtered, valid_samples,
                        hi.window_size(tail.sample_rate))
    return hist, hi.loudness_index(hist), peak


def analysis_core(tail: LightTail, spec_i8, esc_idx, esc_val, scf, info,
                  valid_samples, *, on_stage=None):
    """Host-decoded batched pipeline: prepare_batch_arrays' compact
    manifest → spectrum unpack → analysis_tail. It marks no stage:
    on_stage is accepted, as every core accepts it, and not called."""
    spectrum = _unpack_spectrum(spec_i8, esc_idx, esc_val)
    return analysis_tail(tail, spectrum, scf, info, valid_samples)


def dest_rows(inv, counts, *, g_max: int, n_channels: int,
              channel_major: bool):
    """decode_rows' map for a light batch: (dest (npad,) int32, n_rows).

    Unsorted row i of track b (counts-derived row map: i = offs_b + g)
    goes to row c·(B·T) + b·T + t of K2's channel-major (C, B·T) rows
    when channel_major (g = t·C + c, T = g_max // C), else to row
    b·g_max + g of the track-major (B, g_max) rows analysis_tail reads;
    sorted lane inv[i] takes that row. Lanes of padding rows get -1, and
    the rows of the map's padding slots (g >= counts_b) stay unwritten."""
    npad = inv.shape[0]
    dev = inv.device
    rowmap = _rowmap_from_counts(counts, g_max, npad)  # (B, G), npad = none
    bsz = rowmap.shape[0]
    g = torch.arange(g_max, device=dev)
    b = torch.arange(bsz, device=dev)[:, None]
    if channel_major:
        t = g_max // n_channels
        target = (g % n_channels) * (bsz * t) + b * t + g // n_channels
    else:
        target = b * g_max + g
    lane = torch.cat([inv.long(), torch.full((1,), npad, device=dev)])[rowmap]
    dest = torch.full((npad + 1,), -1, dtype=torch.int32, device=dev)
    dest[lane.reshape(-1)] = target.reshape(-1).to(torch.int32)
    return dest[:npad], bsz * g_max


def channel_major_inputs(spec_rows, big_end, c1end, counts, scf, srow,
                         sdata, hrow, hdata, info, *, nb: int, g_max: int,
                         n_channels: int):
    """K1's channel-major rows + flat manifest → K2's inputs: (spec (C, R,
    576) int16, scf (C, R, 64) int8, gmeta (C, R, GM_N) int32) with R =
    B * T granule-times, track-major. The spectra and ends are K1's rows
    as they are; the scalefactors and info words are gathered through the
    counts-derived row map (padding slots read a zero dummy row) and the
    info words unpacked into the gmeta fields."""
    nch = n_channels
    dev = spec_rows.device
    npad = nb * ek.LANES
    rowmap = _rowmap_from_counts(counts, g_max, npad)
    scf_full = _expand_scf_flat(scf, srow, sdata, hrow, hdata)
    info = torch.cat([info.to(torch.int32) & 0xFFFF,
                      torch.zeros((1, fe.IP_N), dtype=torch.int32, device=dev)])

    bsz, g = rowmap.shape
    t = g // nch
    r = bsz * t
    rowmap_cm = rowmap.reshape(bsz, t, nch).permute(2, 0, 1).contiguous()
    spec_cm = spec_rows.view(nch, r, 576)
    rzero_cm = torch.maximum(big_end, c1end).view(nch, bsz, t)
    wp = info[rowmap_cm]  # (C, B, T, IP_N) packed info words
    w0 = wp[..., 0]
    w1 = wp[..., 1]
    scf_cm = scf_full[rowmap_cm].reshape(nch, r, fe.SCF_SLOTS).to(torch.int8)

    bt = (w0 >> 8) & 3
    mixed = (w0 >> 10) & 1
    joint = (w0 >> 14) & 1
    fields = [torch.zeros_like(bt)] * hk.GM_N
    fields[hk.GM_GG] = w0 & 255
    fields[hk.GM_SFS] = (w0 >> 11) & 1
    fields[hk.GM_PRE] = (w0 >> 12) & 1
    fields[hk.GM_SBG0] = w1 & 7
    fields[hk.GM_SBG1] = (w1 >> 3) & 7
    fields[hk.GM_SBG2] = (w1 >> 6) & 7
    fields[hk.GM_BT] = bt
    fields[hk.GM_CLS] = torch.where(bt == 2, 1 + mixed, 0)
    fields[hk.GM_MS] = joint * ((w1 >> 10) & 1)
    fields[hk.GM_IS] = joint * ((w1 >> 9) & 1)
    fields[hk.GM_LSF] = (w0 >> 15) & 1
    fields[hk.GM_ISC] = (w0 >> 13) & 1
    fields[hk.GM_RZO] = rzero_cm.flip(0) if nch == 2 else rzero_cm
    gmeta = torch.stack(fields, dim=-1).to(torch.int32).reshape(nch, r, hk.GM_N)
    return spec_cm, scf_cm, gmeta


def _light_tail_unfused(tail: LightTail, spec_rows, big_end, c1end, counts,
                        scf, srow, sdata, hrow, hdata, info, valid_samples, *,
                        nb: int, g_max: int):
    """K1's track-major rows as the host-decoded route's (B, G, ...) form,
    BIG_END/COUNT1_END taken from K1's outputs, the scalefactors and info
    gathered through the row map, then analysis_tail: light_tail(fused=False),
    a reference the tests compare the fused path against, not the main
    path."""
    npad = nb * ek.LANES
    dev = spec_rows.device
    rowmap = _rowmap_from_counts(counts, g_max, npad)
    bsz = rowmap.shape[0]
    scf = _expand_scf_flat(scf, srow, sdata, hrow, hdata)[rowmap]
    info = torch.cat([info.to(torch.int32) & 0xFFFF,
                      torch.zeros((1, fe.IP_N), dtype=torch.int32, device=dev)])
    info = _expand_info_light(info[rowmap])
    info[..., fe.BIG_END] = big_end.view(bsz, g_max)
    info[..., fe.COUNT1_END] = c1end.view(bsz, g_max)
    return analysis_tail(tail, spec_rows.view(bsz, g_max, 576), scf, info,
                         valid_samples)


def light_tail(tail: LightTail, spec_rows, big_end, c1end, counts, scf,
               srow, sdata, hrow, hdata, info, valid_samples, *, nb: int,
               g_max: int, fused: bool = True, on_stage=None, segment=None):
    """K1's rows (dest_rows' layout for `fused`) → (hist
    (B, 12000) int32, loud_idx (B,) int32, peak (B,) f32) — the JAX
    package's _light_tail after its unsort and row gathers. fused=True
    (the main path): channel-major inputs, requantize + stereo (K2),
    hybrid synthesis (alias butterflies and IMDCT), overlap-add and
    polyphase synthesis, IIR, histogram.
    fused=False: the host-decoded route's analysis_tail on the same
    decode, which equals that route exactly; a reference the tests compare
    against, not the main path. on_stage, if given, is
    called with a stage's name as each stage of the fused path has been
    enqueued (for per-stage device timing).

    segment (a Segment, the batch's one track): its first segment.halo
    granule-times feed only the decode and their PCM is dropped; the IIR
    starts from the filter state the segment before it left (raises
    CarryMissing where that one has not run), and, unless the segment is
    its track's last, leaves its own end state for the next in the
    "carry" stage."""
    if not fused:
        if segment is not None:
            raise ValueError("a segment runs on the fused path")
        return _light_tail_unfused(
            tail, spec_rows, big_end, c1end, counts, scf, srow, sdata, hrow,
            hdata, info, valid_samples, nb=nb, g_max=g_max)
    nch = tail.n_channels
    dev = spec_rows.device
    bsz = counts.shape[0]
    t = g_max // nch
    spec_cm, scf_cm, gmeta = channel_major_inputs(
        spec_rows, big_end, c1end, counts, scf, srow, sdata, hrow, hdata,
        info, nb=nb, g_max=g_max, n_channels=nch)
    _stage(on_stage, "gathers")
    xr = hk.fused_requant_stereo(spec_cm, scf_cm, gmeta, tail.hybrid)
    del spec_cm, scf_cm
    _stage(on_stage, "K2")
    # The two synthesis stages keep their names, which the benchmark's
    # synthesis metric reads, though no GEMM is left on the card.
    z = hk.hybrid_synthesis(xr, gmeta, tail.hybrid).reshape(nch, bsz, t, 1152)
    del xr
    _stage(on_stage, "hybrid GEMMs")

    pcm = overlap_polyphase(z, tail.decode)  # (C, B, T·576)
    del z
    _stage(on_stage, "overlap-add + polyphase")

    n = t * 576
    if segment is not None:
        pcm = pcm[:, :, segment.halo * 576:]
        n -= segment.halo * 576
    sample_idx = torch.arange(n, device=dev)
    peak_mask = sample_idx[None, None, :] < valid_samples[None, :, None]
    peak = (pcm.abs() * peak_mask).amax(dim=(0, 2))  # (B,)
    _stage(on_stage, "peak")

    x = (pcm * SAMPLE_SCALE_16BIT).reshape(nch * bsz, n)
    del pcm
    state, end = None, None
    if segment is not None:
        state = segment.carry.state_before(segment.index)
        end = None if segment.last else segment.samples
    filtered, ends = tail.iir(x, state, end)
    filtered = filtered.reshape(nch, bsz, n).transpose(0, 1)  # (B, C, N)
    _stage(on_stage, "IIR")
    if end is not None:
        segment.carry.states[segment.index] = torch.cat(ends, dim=1) if ends else None
        _stage(on_stage, "carry")
    hist = hi.histogram(filtered, valid_samples,
                        hi.window_size(tail.sample_rate))
    loud_idx = hi.loudness_index(hist)
    _stage(on_stage, "histogram + index")
    return hist, loud_idx, peak


def analysis_core_light(tail: LightTail, scalars, buf, metab, inv, counts,
                        scf, srow, sdata, hrow, hdata, info, valid_samples,
                        *, nb: int, g_max: int, fused: bool = True,
                        on_stage=None, segment=None):
    """Raw-bits batched pipeline: the row map, Huffman decode (K1) into
    the rows light_tail reads, then light_tail (on_stage: light_tail's;
    also called after "row map" and "K1"; segment: light_tail's)."""
    dest, n_rows = dest_rows(inv, counts, g_max=g_max,
                             n_channels=tail.n_channels, channel_major=fused)
    _stage(on_stage, "row map")
    spec_rows, big_end, c1end = ek.decode_rows(
        scalars, buf, metab, tail.luts, dest, n_rows)
    _stage(on_stage, "K1")
    return light_tail(
        tail, spec_rows, big_end, c1end, counts, scf, srow, sdata, hrow,
        hdata, info, valid_samples, nb=nb, g_max=g_max, fused=fused,
        on_stage=on_stage, segment=segment,
    )


def analysis_core_light_compact(tail: LightTail, scalars, words, word_off, meta,
                                order, inv, counts, scf, srow, sdata, hrow, hdata,
                                info, valid_samples, *, nb: int, g_max: int,
                                g_real: int, g_pad: int, fused: bool = True,
                                on_stage=None, segment=None):
    """analysis_core_light on prepare_batch_arrays_light_compact's arrays:
    the lane pack (K0) builds the entropy decode's buf and meta on the
    device, then analysis_core_light runs on them (on_stage: also called
    after "lane pack")."""
    buf, metab = ek.lane_pack(scalars, words, word_off, meta, order,
                              g_real=g_real, g_pad=g_pad)
    _stage(on_stage, "lane pack")
    return analysis_core_light(
        tail, scalars, buf, metab, inv, counts, scf, srow, sdata, hrow, hdata,
        info, valid_samples, nb=nb, g_max=g_max, fused=fused, on_stage=on_stage,
        segment=segment)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Blocking copy of a host array to `device`; never aliases `arr`
    (pooled host buffers are reused as soon as this returns)."""
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)  # same bits; widened with & 0xFFFF on device
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t.clone()
    return t.to(device)


# ---------------------------------------------------------------------------
# The pipelined runner.
# ---------------------------------------------------------------------------

_ALIGN = 256  # byte alignment of each array inside a staged upload
_GROW_UNIT = 1 << 20
_STAGING_SLOTS = 2  # pinned slots: one being copied while the next fills
# Collected batches a Runner keeps timings of: a 64,000-track scan's worth.
TIMINGS_KEPT = 1024


def _count_rows(unpacked: list, padded: int, per: int = 1) -> None:
    """rows.real (each track's granule-channel or frame-channel rows, n
    cut to whole multiples of `per`) and rows.padded (the batch's padded
    rows) of one prepared batch, while tracing records."""
    if tracing.on():
        tracing.count("rows.real", sum(u.n // per * per for u in unpacked))
        tracing.count("rows.padded", padded)


# ---------------------------------------------------------------------------
# Tracks over the rows cap: segments that carry decoder and filter state.
# ---------------------------------------------------------------------------

# Padded granule-channel rows of an MP3 batch (bpad x padded rows). The 64
# x 60 s batch is 589,824 rows; a batch at the cap peaks near 8 GB on the
# H100 with K4 and K5 (PERF.md).
ROWS_CAP = 640_000
# Granule-times a segment reads before its first: the IMDCT overlap of its
# first granule comes from the one before, and the polyphase FIFO from
# that one's overlap-add, which needs the one before it.
HALO = 2


def cut_granules(sample_rate: int) -> int:
    """Granules from one cut to the next that keep the 50 ms windows'
    phase: lcm(576, window) samples (245 at 44.1 kHz, 551 at 22.05 kHz,
    25 at 48 kHz)."""
    return math.lcm(576, hi.window_size(sample_rate)) // 576


def segment_plan(n_rows: int, sample_rate: int, n_channels: int,
                 rows_cap: int) -> list[tuple[int, int]] | None:
    """The granule-time ranges [g0, g1) of a track's segments, in order,
    where its padded rows exceed the budget, rows_cap rows and rows_cap / 2
    granule-times: each a whole number of cut units whose rows, with its
    halo's, pad to at most the budget, the last taking what is left. The
    granule-times bound the length of a one-row batch: its peak mask and
    its windows' masks hold int64 and float tensors along the row, so a
    mono track is cut where a stereo track of its length is. None where
    the track fits the budget, or where not even one cut unit fits (the
    track is then one batch of its own, as before)."""
    unit = 2 * n_channels
    budget = rows_cap * n_channels // 2
    if _quantize_up(n_rows, unit, base=512, ratio=1.3) <= budget:
        return None
    per = cut_granules(sample_rate)
    k = (budget // n_channels - HALO) // per
    while k > 0 and _quantize_up((k * per + HALO) * n_channels, unit,
                                 base=512, ratio=1.3) > budget:
        k -= 1
    if k <= 0:
        return None
    size, total = k * per, n_rows // n_channels
    return [(g0, min(g0 + size, total)) for g0 in range(0, total, size)]


class CarryMissing(RuntimeError):
    """A segment launched before the one ahead of it had left its state
    (that one failed to launch): it is launched again once it has."""


class TrackCarry:
    """What the segments of one track hand on and answer: each segment's
    filter state at its end (a (C, state_width) tensor on the device), by
    segment index; the histograms and peaks of the segments collected so
    far, how many are still out and the first failure. The segments run in
    order on one Runner, so a state is read on the stream that wrote it."""

    def __init__(self, n_segments: int):
        self.states: dict[int, torch.Tensor | None] = {}
        self.hists: list[np.ndarray] = []
        self.peaks: list[float] = []
        self.left = n_segments
        self.error: BaseException | None = None

    def state_before(self, index: int):
        if index == 0:
            return None
        try:
            return self.states[index - 1]
        except KeyError:
            raise CarryMissing(f"segment {index} has no state from segment {index - 1}") from None

    def take(self, collected):
        """Take in one segment's collected (hist, loudness, peak) host
        arrays, or the exception it ended in. None while segments are still
        out; then the track's (hist (1, 12000) int32, loudness (1,) dB, peak
        (1,)), a batch of one as Runner.collect gives it, from
        combine_segments, or the first failure."""
        self.left -= 1
        if isinstance(collected, BaseException):
            self.error = self.error or collected
        else:
            self.hists.append(collected[0][0])
            self.peaks.append(collected[2][0])
        if self.left:
            return None
        if self.error is not None:
            return self.error
        hist, loud, peak = combine_segments(self.hists, self.peaks)
        return hist[None], np.array([loud]), np.array([peak], np.float32)


@dataclass(eq=False)
class Segment:
    """Granule-times [g0 - halo, g1) of a light-unpacked track, as a track
    of its own (the rows are views of the track's, and md windows share its
    main-data stream), for a batch of one: its index in the track, its
    halo, the samples it answers for and whether it is the last."""

    ip: np.ndarray
    scf_main: np.ndarray
    srows: np.ndarray
    sdata: np.ndarray
    hrows: np.ndarray
    hmask: np.ndarray
    md: np.ndarray | fe.MdWindows
    meta: np.ndarray
    sample_rate: int
    n_channels: int
    carry: TrackCarry
    index: int
    halo: int
    samples: int
    last: bool

    @property
    def n(self) -> int:
        return self.ip.shape[0]


def split_track(u, plan: list[tuple[int, int]]) -> list[Segment]:
    """The segments of a light-unpacked track (fe.UnpackedMp3LightStream or
    fe.UnpackedMp3LightPacked) for segment_plan's ranges, each starting
    HALO granule-times early (fewer at the track's start); they share one
    TrackCarry."""
    carry = TrackCarry(len(plan))
    nch = u.n_channels
    out = []
    for k, (g0, g1) in enumerate(plan):
        with tracing.span("segment"):
            halo = min(HALO, g0)
            a, b = (g0 - halo) * nch, g1 * nch
            s = (u.srows >= a) & (u.srows < b)
            h = (u.hrows >= a) & (u.hrows < b)
            out.append(Segment(
                u.ip[a:b], u.scf_main[a:b], u.srows[s] - a, u.sdata[s], u.hrows[h] - a,
                u.hmask[h], u.md[a:b], u.meta[a:b], u.sample_rate, nch, carry, k, halo,
                (g1 - g0) * 576, k == len(plan) - 1))
        tracing.count("segments")
    tracing.count("tracks.segmented")
    return out


def combine_segments(hists, peaks):
    """One track's (hist (12000,) int32, loudness dB, peak) from its
    segments' histograms and peaks: the histograms add, the peak is the
    largest (NaN wins, as in one batch), the loudness is the device
    readout's (hi.loudness_index) of the sum."""
    hist = np.sum(np.asarray(hists, np.int64), axis=0)
    idx = int(hi.loudness_index(torch.from_numpy(hist)[None])[0])
    return hist.astype(np.int32), hi.index_to_loudness(idx), np.max(np.asarray(peaks, np.float32))


# The index of the per-track counts in a light batch's Prepared.arrays.
LIGHT_COUNTS = 6


@dataclass
class Prepared:
    """A batch's host half (Runner.prepare_light / prepare_heavy /
    prepare_aac_q / prepare_aac): its route ("light", "heavy", "aac_q" or
    "aac", a label for timings and the peak gauge), the device pipeline
    to run (core, called as core(tables, *uploaded arrays, **shapes,
    on_stage=...)), the Runner method that gives the constant tables of
    the Runner that launches it (tail_of(runner, sample_rate,
    n_channels)), the arrays to upload, the pooled host buffers to hand
    back to the pool once those are staged and core's keyword arguments."""

    route: str
    core: Callable
    tail_of: Callable
    sample_rate: int
    n_channels: int
    bsz: int
    arrays: tuple
    pooled: tuple
    shapes: dict
    prep_s: float


def _batch_name(p: Prepared) -> str:
    """A batch as the device.peak_bytes gauge names it."""
    seg = p.shapes.get("segment")
    return (f"{p.route} {p.sample_rate} Hz {p.n_channels} ch, batch of {p.bsz}"
            + (f", {len(p.arrays[LIGHT_COUNTS]) * p.shapes['g_max']} padded rows"
               if p.route == "light" else "")
            + (f", segment {seg.index} ({seg.n // seg.n_channels} granule-times)"
               if seg is not None else ""))


@dataclass
class _Batch:
    """A dispatched batch, for Runner.collect. On the CPU `result` holds
    the (hist, loud_idx, peak) tensors; on a CUDA device `hist` and
    `stats` are the pinned host buffers the batch's readback lands in and
    `events` (copy start, copy end, compute start, readback end) time it.
    While tracing records, `stages` holds the batch's stage marks (None,
    then each stage's name, with a CUDA event or a host-clock time in ns)
    and `span` its upload span, which the stages' device spans hang under."""

    bsz: int
    route: str
    prep_s: float
    h2d_s: float
    device_ms: float = 0.0
    result: tuple | None = None
    hist: torch.Tensor | None = None
    stats: torch.Tensor | None = None
    events: tuple | None = None
    stages: list | None = None
    span: object = None


class Runner:
    """Batched analysis on one device, over the MP3 light route
    (dispatch_light / analyze_unpacked_light), the host-decoded one
    (dispatch_heavy / analyze_unpacked) or the two AAC routes
    (prepare_aac_q / prepare_aac, then launch).

    On a CUDA device a batch is pipelined: the host prep writes the pooled
    numpy buffers, which are copied into a pinned staging slot the runner
    owns (a ring of _STAGING_SLOTS, each grown to the largest upload seen)
    and handed back to the pool at once; one non_blocking copy on the
    runner's copy stream moves the slot to the device and records an
    event; the compute stream waits on that event, runs the batch, and
    enqueues a non_blocking readback of the histograms, indices and peaks
    into pinned memory. A staging slot is refilled only after the copy
    that read it has completed. collect() waits on the batch's own
    readback event only, so batches dispatched after it keep running. On
    the CPU every step is synchronous.

    dispatch_* = launch(prepare_*(...)): the host half (prepare_*, no
    device work) may run on any thread; all device work is enqueued by
    launch under one lock, so launches from two threads cannot interleave.
    analyze_library prepares on a small pool and launches from a single
    uploader thread in batch order."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._tails: dict[tuple, LightTail] = {}
        self._aac_tails: dict[tuple, nn.Module] = {}
        self._aac_synthesis: nn.Module | None = None
        self._lock = threading.RLock()
        # route, prep_s / h2d_s (host clock) and device_ms of the last
        # TIMINGS_KEPT collected batches in collect order (a shared Runner
        # lives as long as the process).
        self.timings: deque[dict] = deque(maxlen=TIMINGS_KEPT)
        # CUDA only: each of those batches' device-busy intervals (its
        # upload, then its compute + readback), ms on the runner's clock.
        self.busy_ms: deque[tuple[float, float]] = deque(maxlen=2 * TIMINGS_KEPT)
        if self.device.type == "cuda":
            self._compute = torch.cuda.current_stream(self.device)
            self._copy = torch.cuda.Stream(self.device)
            self._ring = [[None, None] for _ in range(_STAGING_SLOTS)]
            self._slot = 0
            self._origin = torch.cuda.Event(enable_timing=True)
            self._origin.record(self._compute)
        # _origin on the tracing (profiler) clock, taken when the first
        # traced batch is collected (_anchor): origin_ns + ms * 1e6 puts a
        # busy_ms entry on that clock.
        self.origin_ns: int | None = None

    def tail(self, sample_rate: int, n_channels: int) -> LightTail:
        key = (sample_rate, n_channels)
        with self._lock:
            if key not in self._tails:
                self._tails[key] = LightTail(sample_rate, n_channels).to(self.device)
            return self._tails[key]

    def aac_synthesis(self):
        """The IMDCT tables (42 MB), built once per Runner."""
        from ..decode.aac_synthesis import AacSynthesis

        with self._lock:
            if self._aac_synthesis is None:
                self._aac_synthesis = AacSynthesis().to(self.device)
            return self._aac_synthesis

    def aac_tail(self, sample_rate: int, n_channels: int):
        from ..aac import AacTail

        key = (sample_rate, n_channels)
        with self._lock:
            if key not in self._aac_tails:
                self._aac_tails[key] = AacTail(
                    sample_rate, n_channels, self.aac_synthesis()).to(self.device)
            return self._aac_tails[key]

    def _upload(self, arrays):
        """Host arrays → device tensors of the same shapes (uint16 as
        int16) and the copy's (start, end) events (None on the CPU)."""
        views = [np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16 else a)
                 for a in arrays]
        if self.device.type == "cpu":
            return [torch.from_numpy(a).clone() for a in views], None
        offs, total = [], 0
        for a in views:
            offs.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        staged, last_copy = slot
        if last_copy is not None:
            with tracing.span("slot_wait"):
                last_copy.synchronize()  # the copy that read this slot is done
        if staged is None or staged.numel() < total:
            size = -(-(total + total // 4) // _GROW_UNIT) * _GROW_UNIT
            staged = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        host = staged.numpy()
        for a, off in zip(views, offs):
            host[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy):
            start.record()
            flat = torch.empty(total, dtype=torch.uint8, device=self.device)
            flat.copy_(staged[:total], non_blocking=True)
            end.record()
        # Allocated on the copy stream, read on the compute stream: keep the
        # allocator from handing the block to a later upload before the
        # compute stream is done with it.
        flat.record_stream(self._compute)
        slot[0], slot[1] = staged, end
        out = []
        for a, off in zip(views, offs):
            dt = torch.from_numpy(np.empty(0, a.dtype)).dtype
            out.append(flat[off : off + a.nbytes].view(dt).view(a.shape))
        return out, (start, end)

    def _launch(self, run, prepared: Prepared, h2d_s: float, copy,
                stages: list | None) -> _Batch:
        """Enqueue run() → (hist, loud_idx, peak) after the upload, then
        the readback. stages, while tracing records, gets the batch's start
        mark ahead of run()'s stage marks."""
        bsz, route, prep_s = prepared.bsz, prepared.route, prepared.prep_s
        if copy is None:
            t = time.perf_counter()
            if stages is not None:
                stages.append((None, time.time_ns()))
            with tracing.span("enqueue"):
                hist, loud_idx, peak = run()
            return _Batch(bsz, route, prep_s, h2d_s, (time.perf_counter() - t) * 1e3,
                          result=(hist, loud_idx, peak), stages=stages)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._compute):
            self._compute.wait_event(copy[1])
            start.record()
            if stages is not None:
                stages.append((None, start))
            with tracing.span("enqueue"):
                hist, loud_idx, peak = run()
            hist = hist[:bsz]
            stats = torch.stack([loud_idx[:bsz].to(torch.float32),
                                 peak[:bsz].to(torch.float32)])
            h_host = torch.empty(hist.shape, dtype=hist.dtype, pin_memory=True)
            s_host = torch.empty(stats.shape, dtype=stats.dtype, pin_memory=True)
            h_host.copy_(hist, non_blocking=True)
            s_host.copy_(stats, non_blocking=True)
            end.record()
        return _Batch(bsz, route, prep_s, h2d_s, hist=h_host, stats=s_host,
                      events=(copy[0], copy[1], start, end), stages=stages)

    def prepare_light(self, unpacked: list, sample_rate: int,
                      n_channels: int) -> Prepared:
        """Host prep of a batch of same-format light-unpacked tracks: the
        lane plan and the rows copied in walk order, which the device
        packs (analysis_core_light_compact)."""
        segments = [u for u in unpacked if isinstance(u, Segment)]
        if segments and len(unpacked) != 1:
            raise ValueError("a segment is a batch of its own")
        with tracing.span("prep"):
            t0 = time.perf_counter()
            prep, rest, g_max = prepare_batch_arrays_light_compact(unpacked, n_channels)
            _count_rows(unpacked, len(rest[0]) * g_max)
            shapes = {"nb": prep.nb, "g_max": g_max, "g_real": prep.g_real,
                      "g_pad": prep.g_pad}
            if segments:
                rest[7][0] = segments[0].samples  # the halo's samples are not its own
                shapes["segment"] = segments[0]
            return Prepared("light", analysis_core_light_compact, Runner.tail,
                            sample_rate, n_channels, len(unpacked),
                            (prep.scalars, prep.words, prep.word_off, prep.meta,
                             prep.order, prep.inv) + tuple(rest),
                            prep.pooled + (rest[1], rest[6]),
                            shapes, time.perf_counter() - t0)

    def prepare_heavy(self, unpacked: list, sample_rate: int,
                      n_channels: int) -> Prepared:
        """Host prep of a batch of same-format host-decoded tracks
        (frontend.unpack_data) for the heavy route (analysis_core): a
        reference the tests compare the light route against, not the main
        path."""
        with tracing.span("prep"):
            t0 = time.perf_counter()
            args = prepare_batch_arrays(unpacked, n_channels, 1)
            _count_rows(unpacked, args[0].shape[0] * args[0].shape[1])
            return Prepared("heavy", analysis_core, Runner.tail, sample_rate, n_channels,
                            len(unpacked), args, (), {}, time.perf_counter() - t0)

    def prepare_aac_q(self, unpacked: list, sample_rate: int,
                      n_channels: int) -> Prepared:
        """Host prep of a batch of same-format quantized-unpacked AAC
        tracks (aac_frontend.unpack_file_q) for the device-prep route. The
        fallback rows' destinations and the EIGHT_SHORT row lists are
        worked out here, where the window sequences are, so the device
        reads no size back; the packer's fallback ladder padding and its
        row-gather map are not uploaded."""
        from .. import aac
        from ..decode import aac_prep
        from ..decode.aac_synthesis import short_rows

        with tracing.span("prep"):
            t0 = time.perf_counter()
            (spec_q4, meta, esc_idx, esc_val, fb16, fbexp, fbmap, wseq, wshape,
             valid) = aac.prepare_batch_arrays_aac_q(unpacked, n_channels)
            fb_dst, fb_src = aac_prep.fallback_rows(fbmap)
            rows, counts = short_rows(wseq, wshape, n_channels)
            _count_rows(unpacked, wseq.shape[0] * wseq.shape[1], n_channels)
            return Prepared(
                "aac_q", aac.analysis_core_q, Runner.aac_tail, sample_rate, n_channels,
                len(unpacked),
                (spec_q4, meta, esc_idx, esc_val, fb16[fb_src], fbexp[fb_src],
                 fb_dst, wseq, wshape, valid, rows),
                (spec_q4, meta, fbmap, wseq, wshape), {"short_counts": counts},
                time.perf_counter() - t0)

    def prepare_aac(self, unpacked: list, sample_rate: int,
                    n_channels: int) -> Prepared:
        """Host prep of a batch of same-format host-decoded AAC tracks
        (aac_frontend.unpack_file) for the host-requant route."""
        from .. import aac
        from ..decode.aac_synthesis import short_rows

        with tracing.span("prep"):
            t0 = time.perf_counter()
            spec, sexp, wseq, wshape, valid = aac.prepare_batch_arrays_aac(
                unpacked, n_channels)
            rows, counts = short_rows(wseq, wshape, n_channels)
            _count_rows(unpacked, wseq.shape[0] * wseq.shape[1], n_channels)
            return Prepared(
                "aac", aac.analysis_core, Runner.aac_tail, sample_rate, n_channels,
                len(unpacked),
                (spec, sexp, wseq, wshape, valid, rows), (spec, sexp, wseq, wshape),
                {"short_counts": counts}, time.perf_counter() - t0)

    def launch(self, prepared: Prepared):
        """Stage, upload and enqueue a prepared batch (its core on this
        Runner's tables); returns a handle for collect()."""
        with tracing.span("upload") as up, self._lock, _on(self.device):
            tail = prepared.tail_of(self, prepared.sample_rate, prepared.n_channels)
            t1 = time.perf_counter()
            try:
                dev, copy = self._upload(prepared.arrays)
            finally:
                # Staged (pinned copy or CPU clone): the pool may reuse them.
                bufpool.give(*prepared.pooled)
            h2d_s = time.perf_counter() - t1
            kwargs, stages = prepared.shapes, None
            if up is not None:
                stages = []
                kwargs = dict(kwargs, on_stage=self._stage_marker(stages))

            def run():
                return prepared.core(tail, *dev, **kwargs)

            batch = self._launch(run, prepared, h2d_s, copy, stages)
            batch.span = up
            if up is not None and copy is not None:
                # The allocator hands a batch its memory as it is enqueued,
                # so the batch that raised the peak is this one.
                tracing.gauge("device.peak_bytes",
                              torch.cuda.max_memory_allocated(self.device),
                              at=_batch_name(prepared))
            return batch

    def _stage_marker(self, stages: list):
        """on_stage for a traced batch: each stage's name with a CUDA event
        recorded on the current stream (on the CPU, where a stage has run
        when it is marked, the host clock)."""
        if self.device.type == "cpu":
            return lambda name: stages.append((name, time.time_ns()))

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stages.append((name, ev))

        return mark

    def _anchor(self) -> None:
        """Set origin_ns once. With the device drained and launches held
        off (the lock), a new event completes between the two host
        readings; its time after _origin places _origin on the host's clock."""
        with self._lock:
            if self.origin_ns is not None:
                return
            torch.cuda.synchronize(self.device)
            ev = torch.cuda.Event(enable_timing=True)
            before = time.time_ns()
            ev.record(self._compute)
            ev.synchronize()
            mid = (before + time.time_ns()) // 2
            self.origin_ns = mid - int(self._origin.elapsed_time(ev) * 1e6)

    def _ns(self, ms: float) -> int:
        """A time on the runner's clock (ms after _origin) on the tracing clock."""
        return self.origin_ns + int(ms * 1e6)

    def _trace_stages(self, handle: _Batch, clock) -> None:
        """The device spans of a traced batch's stages, each from the mark
        before it to its own (clock: a mark's time on the tracing clock)."""
        if not handle.stages or handle.span is None:
            return
        marks = [(name, clock(t)) for name, t in handle.stages]
        tracing.device_spans(str(self.device), handle.span.id, handle.span.root,
                             [(name, a, b) for (_, a), (name, b) in zip(marks, marks[1:])])

    def dispatch_light(self, unpacked: list, sample_rate: int, n_channels: int):
        """prepare_light, then launch."""
        return self.launch(self.prepare_light(unpacked, sample_rate, n_channels))

    def dispatch_heavy(self, unpacked: list, sample_rate: int, n_channels: int):
        """prepare_heavy, then launch: the heavy route, a reference the
        tests compare against, not the main path."""
        return self.launch(self.prepare_heavy(unpacked, sample_rate, n_channels))

    def collect(self, handle: _Batch):
        """Wait for a dispatched batch (on a CUDA device, for its readback
        event only); returns host arrays (hist (B, 12000) int32, loudness
        (B,) dB, peak (B,))."""
        bsz = handle.bsz
        with tracing.span("collect") as span:
            if handle.events is None:
                hist_t, loud_idx, peak = handle.result
                hist = hist_t[:bsz].numpy()
                idx = loud_idx[:bsz].numpy()
                peaks = peak[:bsz].to(torch.float32).numpy()
                device_ms = handle.device_ms
                if span is not None:
                    self._trace_stages(handle, lambda t: t)
            else:
                copy_start, copy_end, start, end = handle.events
                with _on(self.device):  # the caller's thread may sit on another card
                    end.synchronize()
                    hist = np.array(handle.hist.numpy())  # off the pinned block
                    stats = handle.stats.numpy()
                    idx, peaks = stats[0], stats[1].copy()
                    device_ms = start.elapsed_time(end)
                    busy = [(self._origin.elapsed_time(a), self._origin.elapsed_time(b))
                            for a, b in ((copy_start, copy_end), (start, end))]
                    self.busy_ms += busy
                    if span is not None:
                        self._anchor()
                        for a, b in busy:
                            tracing.busy(self._ns(a), self._ns(b))
                        self._trace_stages(
                            handle, lambda ev: self._ns(self._origin.elapsed_time(ev)))
        self.timings.append({"route": handle.route, "prep_s": handle.prep_s,
                             "h2d_s": handle.h2d_s, "device_ms": device_ms})
        louds = np.array([hi.index_to_loudness(i) for i in idx])
        return hist, louds, peaks

    def analyze_unpacked_light(self, unpacked: list, sample_rate: int,
                               n_channels: int):
        """Analyze same-format light-unpacked tracks (one batch)."""
        return self.collect(
            self.dispatch_light(unpacked, sample_rate, n_channels)
        )

    def analyze_track_light(self, u):
        """Analyze one light-unpacked track (fe.unpack_data_light_stream):
        one batch, or, where it is over segment_plan's budget at ROWS_CAP,
        its segments in order, each dispatched before the one ahead of
        it is collected; the same host arrays as analyze_unpacked_light
        gives for one track. A segment that fails raises."""
        sr, nch = u.sample_rate, u.n_channels
        plan = segment_plan(u.n, sr, nch, ROWS_CAP)
        if plan is None:
            return self.analyze_unpacked_light([u], sr, nch)
        segments = split_track(u, plan)
        carry, ahead = segments[0].carry, deque()
        for seg in segments:
            ahead.append(self.dispatch_light([seg], sr, nch))
            if len(ahead) > 1:
                carry.take(self.collect(ahead.popleft()))
        return carry.take(self.collect(ahead.popleft()))

    def analyze_unpacked(self, unpacked: list, sample_rate: int,
                         n_channels: int):
        """Analyze same-format host-decoded tracks (one batch); the same
        results as analyze_unpacked_light, through the host-decoded (heavy)
        route: a reference the tests compare against, not the main path."""
        return self.collect(
            self.dispatch_heavy(unpacked, sample_rate, n_channels)
        )


def _on(device: torch.device):
    """The device's context for CUDA, nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


_shared: dict[str, Runner] = {}
_shared_lock = threading.Lock()


def shared_runner(device="cuda") -> Runner:
    """The process's one Runner for `device`, built at first use: the
    entry points that are given no runner share it, so the tables of a
    format, the copy stream and the pinned ring are built once per
    device, not once per call (launches from several threads serialise
    under the Runner's lock)."""
    key = str(resolve_device(device))
    with _shared_lock:
        if key not in _shared:
            _shared[key] = Runner(key)
        return _shared[key]


def runners_for(device="cuda") -> list[Runner]:
    """The Runners of a device argument. "cuda" (no index) means every
    visible GPU, one Runner each; "cuda:0" or "cpu" means that device; a
    list names the devices one by one. Distinct devices get the process's
    shared Runner; a device named a second time gets a Runner of its own
    (two Runners on one device share its compute stream and nothing
    else). Asking for CUDA without a card raises."""
    if isinstance(device, (str, torch.device)):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            require_cuda()
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
    else:
        devices = list(device)
    if not devices:
        raise ValueError("no device named")
    out, seen = [], set()
    for d in devices:
        key = str(resolve_device(d))
        out.append(Runner(key) if key in seen else shared_runner(key))
        seen.add(key)
    return out


@dataclass
class _Sharded:
    """One batch dispatched over a RunnerGroup: a handle per Runner and
    shard_index[d][j], the original index of Runner d's j-th track."""

    handles: list
    shard_index: list
    total: int


class RunnerGroup:
    """Several devices in one process, one Runner each (its own copy
    stream, pinned ring and tables): the counterpart of the JAX package's
    MeshRunner over more than one device. The Runners run independent
    launches, so the shards of a batch need no common shape.

    RunnerGroup("cuda") takes every visible GPU, RunnerGroup(["cuda:0",
    "cuda:1"]) those two, RunnerGroup(runners=[...]) the Runners given
    (runners_for says how a device argument becomes Runners).
    analyze_library(paths, runners=group.runners) deals a library's
    batches across them."""

    def __init__(self, devices="cuda", *, runners: list[Runner] | None = None):
        self.runners = list(runners) if runners is not None else runners_for(devices)
        if not self.runners:
            raise ValueError("a RunnerGroup needs at least one Runner")
        if len({r.device.type for r in self.runners}) != 1:
            raise ValueError("a RunnerGroup's devices are all CUDA or all CPU")

    @property
    def n_devices(self) -> int:
        return len(self.runners)

    @property
    def devices(self) -> list[torch.device]:
        return [r.device for r in self.runners]

    def dispatch_sharded(self, prepare: str, unpacked: list, sample_rate: int,
                         n_channels: int):
        """Split one batch across the Runners (tracks sorted by descending
        length, Runner d takes every n-th from d on, as the JAX package's
        prepare_batch_arrays_light_sharded deals them), prepare each shard
        with the Runner method named `prepare` and launch it on its
        Runner; returns a handle for collect(). Fewer tracks than Runners:
        the whole batch on the first Runner."""
        n = len(self.runners)
        if n == 1 or len(unpacked) < n:
            first = self.runners[0]
            return _Sharded(
                [first.launch(getattr(first, prepare)(unpacked, sample_rate, n_channels))],
                [list(range(len(unpacked)))], len(unpacked))
        order = sorted(range(len(unpacked)), key=lambda i: unpacked[i].n, reverse=True)
        shard_index = [order[d::n] for d in range(n)]
        handles = [
            r.launch(getattr(r, prepare)([unpacked[i] for i in idxs], sample_rate,
                                         n_channels))
            for r, idxs in zip(self.runners, shard_index)]
        return _Sharded(handles, shard_index, len(unpacked))

    def dispatch_light_sharded(self, unpacked: list, sample_rate: int,
                               n_channels: int):
        """Enqueue a raw-bits MP3 batch sharded over the Runners."""
        return self.dispatch_sharded("prepare_light", unpacked, sample_rate, n_channels)

    def collect(self, handle: _Sharded):
        """Wait for every shard; host arrays (hist (B, 12000) int32,
        loudness (B,) dB, peak (B,)) in the original track order."""
        hist = np.empty((handle.total, hi.HISTOGRAM_SIZE), np.int32)
        louds = np.empty(handle.total, np.float64)
        peaks = np.empty(handle.total, np.float32)
        for r, h, idxs in zip(self.runners, handle.handles, handle.shard_index):
            hist[idxs], louds[idxs], peaks[idxs] = r.collect(h)
        return hist, louds, peaks

    def album_reduce_device(self, hist: np.ndarray, peak: np.ndarray):
        """Album histogram and peak of (B, 12000) per-track histograms and
        (B,) peaks: each device sums its contiguous share of the rows in
        int64 and takes its share's peak, the partial results go to the
        first device and are added there. Returns (hist (12000,) int64,
        peak float), equal to the host sum exactly. A NaN peak wins within
        a device's share (torch's max, like jnp.max) and loses across the
        shares (np.fmax; NaN only when every share's is), as the JAX
        package's pmax over its CPU mesh treats it."""
        n = len(self.runners)
        parts, tops = [], []
        for r, rows, pk in zip(self.runners, np.array_split(np.asarray(hist), n),
                               np.array_split(np.asarray(peak, np.float32), n)):
            if len(rows):
                with _on(r.device):
                    parts.append(_to_device(rows, r.device).sum(dim=0, dtype=torch.int64))
                    tops.append(_to_device(pk, r.device).max())
        first = self.runners[0].device
        total = torch.zeros(hi.HISTOGRAM_SIZE, dtype=torch.int64, device=first)
        for part in parts:
            total += part.to(first)
        return total.cpu().numpy(), float(np.fmax.reduce([float(t) for t in tops])) if tops else 0.0


# ---------------------------------------------------------------------------
# Library scans: bucketed, streamed batches with fault isolation.
# ---------------------------------------------------------------------------

MAX_INFLIGHT = 4  # batches dispatched and not yet collected
# Host prep threads. Prep is mostly native code that leaves the GIL free;
# one thread could not keep up with the device (PERF.md, §6).
PREP_THREADS = 2
# Admission budget for the batches in flight, in _est_resident_bytes'
# units (inputs and the decode's int16 spectra, x1.3). Four full 64 x 60 s
# batches estimate 5.3 GB; on an 80 GB H100 the scan's peak is one
# batch's working set (11.4 GB) plus the queued uploads (PERF.md).
INFLIGHT_BYTES = 8_000_000_000


def _result_of(fn, *args):
    """(value, None) on success, (None, the exception) on failure."""
    try:
        return fn(*args), None
    except Exception as e:  # per-file isolation
        return None, e


@dataclass
class TrackOutcome:
    path: str
    ok: bool
    error: str | None = None
    result: ReplayGainResult | None = None
    histogram: np.ndarray | None = None  # (12000,) int32, on the host
    exception: BaseException | None = None  # what a failed file raised


@dataclass
class BatchResult:
    tracks: list[TrackOutcome]
    audio_seconds: float
    wall_seconds: float
    album_histogram: np.ndarray | None = None
    album_peak: float = 0.0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9)


def _retryable(e: BaseException) -> bool:
    """Device memory pressure that halving a batch can relieve: the
    caching allocator's out-of-memory error; and a segment launched before
    the one ahead of it had left its state, which is launched again after
    that one. A CUDA error a kernel launch reported (_build.check) is not:
    an illegal address is sticky."""
    return isinstance(e, (torch.cuda.OutOfMemoryError, CarryMissing))


def _est_resident_bytes(ups) -> int:
    """Approximate device bytes a queued batch stands for: its input
    manifest plus the decode's int16 spectra; 1.3x covers ladder and
    ragged padding."""
    n = sum(u.n for u in ups)
    # A light track's md windows count as the md rows they stand for.
    inputs = sum(a.nbytes for u in ups for a in vars(u).values()
                 if isinstance(a, (np.ndarray, fe.MdWindows)))
    return int(1.3 * inputs + 1.3 * n * 576 * 2)


@dataclass
class _Codec:
    """What analyze_library needs to know of a file type: its unpack of
    one path (raises when nothing decodes), the Runner's host prep, a
    track's padded row count in a batch (_chunk_size), its seconds of
    audio and its queued batch's device bytes (admission)."""

    file_type: str
    unpack: object
    prepare: object
    padded_rows: object
    seconds: object
    est_bytes: object


def _mp3_codec(runner: Runner, device_entropy: bool) -> _Codec:
    def unpack(path):
        if device_entropy:
            with open(path, "rb") as f:
                u = fe.unpack_data_light_stream(f.read())
        else:
            u = fe.unpack_file(path)
        if u.n == 0:
            raise RuntimeError("No valid MP3 frames found")
        return u

    return _Codec(
        "mp3", unpack,
        runner.prepare_light if device_entropy else runner.prepare_heavy,
        lambda u: _quantize_up(u.n, 2 * u.n_channels, base=512, ratio=1.3),
        lambda u: (u.n // u.n_channels) * 576 / u.sample_rate,
        _est_resident_bytes)


def _aac_codec(runner: Runner, device_prep: bool | None) -> _Codec:
    from .. import aac

    device_prep = aac.use_device_prep(runner.device, device_prep)

    def padded_rows(u):
        nch = u.n_channels or 1
        if device_prep:
            return aac._f_max_q(u.n // nch * nch, nch)
        return _quantize_up(max(u.n // nch * nch, nch), nch, base=128, ratio=1.3)

    def est_bytes(ups):
        # The upload: 4-bit spectra and band words (q), f16 spectra (f16).
        per_row = 1024 // 2 + 2 * 52 if device_prep else 1024 * 2
        return int(1.3 * per_row * sum(u.n for u in ups))

    return _Codec(
        "aac", lambda path: aac.unpack_for(path, None, device_prep),
        runner.prepare_aac_q if device_prep else runner.prepare_aac,
        padded_rows, aac.audio_seconds, est_bytes)


class _Lane:
    """One Runner's queue in analyze_library: its single uploader thread
    (launch order is the order batches were dealt to it) and its batches in
    flight as (future, idxs, sr, nch, ups, est)."""

    def __init__(self, runner: Runner):
        self.runner = runner
        self.uploader = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"mp3rgain-upload-{runner.device}")
        self.inflight: deque = deque()

    def queued_bytes(self) -> int:
        return sum(entry[5] for entry in self.inflight)


# Rows cap of an AAC batch, in padded frame-channel lanes (bpad x f_max):
# an H100 held 28.6 KB per lane at the q route's peak (9.9 GB at the 64 x
# 60 s batch's 346,112 lanes, PERF.md), so this bounds a batch near 19 GB
# whatever the tracks' lengths.
AAC_ROWS_CAP = 660_000


def _chunk_size(members, max_batch: int, rows_cap: int, padded_rows) -> int:
    """Largest prefix of the length-sorted members whose padded
    (bpad x padded_rows) row footprint stays under rows_cap: every batch's
    device memory is bounded by construction (the 64 x 60 s MP3 batch is
    589,824 rows and peaks at 11.4 GB on the H100, PERF.md)."""
    c = min(len(members), max_batch)
    while c > 1:
        g = padded_rows(members[c - 1][1])
        bpad = next((b for b in _B_LADDER if b >= c), c)
        if bpad * g <= rows_cap:
            break
        lower = [b for b in _B_LADDER if b < bpad]
        c = min(c - 1, lower[-1] if lower else 1)
    return c


def analyze_library(
    paths,
    runner: Runner | None = None,
    album: bool = False,
    device_entropy: bool = True,
    wave_size: int | None = None,
    batch_cb=None,
    *,
    runners: list[Runner] | None = None,
    max_batch: int = 64,
    rows_cap: int | None = None,
    file_type: str = "mp3",
    device_prep: bool | None = None,
    inflight_bytes: int = INFLIGHT_BYTES,
    pressure_backoff_s: float = 10.0,
) -> BatchResult:
    """Analyze many tracks with bucketed batching and fault isolation, on
    `runner`, or dealt across `runners` (one per device; a RunnerGroup's),
    or by default on every visible GPU (runners_for("cuda")).

    The library streams in waves of `wave_size` files (4 x max_batch by
    default; the first wave is max_batch files, so the device starts after
    one batch's walk), walked by a thread pool of min(n, cpu_count - prep
    threads, 16) (the native walk releases the GIL), so a 10k-track scan
    never holds more than a wave of unpacked audio plus one partial batch
    per (sample rate, channels) bucket. Full buckets are cut into
    length-sorted, rows_cap-bounded batches and prepared on a shared pool
    of PREP_THREADS threads per Runner. Each batch goes to the Runner with
    the fewest estimated bytes in flight; every Runner has its own
    uploader thread, which launches (stages, uploads, enqueues) its
    batches in the order they were dealt, while the main thread walks the
    next wave. Results are collected one batch behind, with at most
    MAX_INFLIGHT batches in flight on a Runner and, beyond two, only while
    their estimated bytes stay under inflight_bytes. device_entropy=False
    runs the host-decoded route (Runner.prepare_heavy). file_type="aac"
    scans AAC/M4A files the same way (buckets, batches, admission,
    halving), on the route device_prep names (aac.use_device_prep);
    rows_cap defaults to ROWS_CAP granule-channel rows for MP3 and
    AAC_ROWS_CAP lanes for AAC. An MP3 track on the light route over
    rows_cap rows or rows_cap / 2 granule-times is cut into segments
    (segment_plan), each a batch of its own, dealt in order to one Runner,
    which carries the decoder and filter state from one to the next; the
    track's TrackCarry takes their answers in and gives the track's (their
    histograms add, their peaks give the largest). A track's result depends neither on
    the batch it rode in nor on the Runner that batch went to.

    A file that fails to read or walk becomes a failed TrackOutcome and
    the scan goes on. A batch whose dispatch runs out of device memory
    is retried in halves on the Runner that failed; a single track that
    still fails after a pressure_backoff_s pause is isolated as failed.
    Any other error raises. With album=True the result's album_histogram
    is the int64 sum of the ok tracks' histograms (on the host) and
    album_peak their largest peak. batch_cb, if given, is called with the
    TrackOutcomes of each collected batch, a segmented track once it is
    whole (scan checkpointing)."""
    if runners is None:
        runners = [runner] if runner is not None else runners_for("cuda")
    elif runner is not None:
        raise ValueError("give runner or runners, not both")
    group = RunnerGroup(runners=runners)  # checks the devices are of one kind
    # The host prep (Runner.prepare_*) touches no device: any Runner's will do.
    codec = (_aac_codec(group.runners[0], device_prep) if file_type == "aac"
             else _mp3_codec(group.runners[0], device_entropy))
    if rows_cap is None:
        rows_cap = AAC_ROWS_CAP if file_type == "aac" else ROWS_CAP
    t0 = time.monotonic()
    if wave_size is None:
        wave_size = 4 * max_batch
    paths = list(paths)

    outcomes: dict[int, TrackOutcome] = {}
    buckets: dict[tuple[int, int], list] = {}
    audio_seconds = 0.0
    lanes = [_Lane(r) for r in group.runners]

    _unpack, prepare = codec.unpack, codec.prepare

    def _dispatch(lane, ups, sr, nch):
        return lane.runner.launch(prepare(ups, sr, nch))

    def _launch(lane, prepared):
        return lane.runner.launch(prepared.result())

    def _dispatch_collect_halving(lane, ups, idxs, sr, nch):
        """Runs on the lane's uploader thread after an out-of-memory
        dispatch: dispatch and collect at once on the same Runner, halving
        the batch until it fits; at one track, retry once after the
        backoff, then isolate it."""
        runner = lane.runner
        try:
            return [(idxs, runner.collect(_dispatch(lane, ups, sr, nch)))]
        except Exception as e:
            if not _retryable(e):
                raise
            tracing.count("oom.retries")
            if runner.device.type == "cuda":
                with _on(runner.device):
                    torch.cuda.empty_cache()
            if len(ups) == 1:
                time.sleep(pressure_backoff_s)
                try:
                    return [(idxs, runner.collect(_dispatch(lane, ups, sr, nch)))]
                except Exception as e2:
                    if not _retryable(e2):
                        raise
                    tracing.count("tracks.isolated")
                    return [(idxs, e2)]
            mid = len(ups) // 2
            return (_dispatch_collect_halving(lane, ups[:mid], idxs[:mid], sr, nch)
                    + _dispatch_collect_halving(lane, ups[mid:], idxs[mid:], sr, nch))

    def _finish_batch(idxs, sr, collected, carry):
        """Record a collected batch's outcomes; a segment's answer goes to
        its track's carry, and the track is recorded once it is whole."""
        if carry is not None:
            collected = carry.take(collected)
            if collected is None:
                return
        if isinstance(collected, Exception):
            # One track that failed even after halving and the backoff: an
            # isolated failure (no result, no checkpoint), not a dead scan.
            for i in idxs:
                outcomes[i] = TrackOutcome(
                    path=str(paths[i]), ok=False,
                    error=f"device dispatch failed under pressure: {collected}")
            return
        hist, louds, peaks = collected
        done = []
        for j, i in enumerate(idxs):
            loud = float(louds[j])
            outcomes[i] = TrackOutcome(
                path=str(paths[i]), ok=True,
                result=ReplayGainResult(
                    loudness_db=loud, gain_db=PINK_REF - loud,
                    peak=float(peaks[j]), sample_rate=sr, file_type=codec.file_type),
                histogram=hist[j],
            )
            done.append(outcomes[i])
        if batch_cb:
            batch_cb(done)

    prep_threads = PREP_THREADS * len(lanes)
    preppers = ThreadPoolExecutor(max_workers=prep_threads,
                                  thread_name_prefix="mp3rgain-prep")

    def collect_one(lane):
        fut, idxs, sr, nch, ups, _est = lane.inflight.popleft()
        carry = ups[0].carry if isinstance(ups[0], Segment) else None
        try:
            with tracing.span("collect"):
                handle = fut.result()
        except Exception as e:
            if not _retryable(e):
                raise
            if carry is not None and carry.error is not None:
                # A segment after one that failed: its track has no answer.
                _finish_batch(idxs, sr, carry.error, carry)
                return
            if not isinstance(e, CarryMissing):
                tracing.count("oom.retries")
            retried = lane.uploader.submit(tracing.carry(_dispatch_collect_halving),
                                            lane, ups, idxs, sr, nch)
            with tracing.span("collect"):
                halves = retried.result()
            for idxs2, collected in halves:
                _finish_batch(idxs2, sr, collected, carry)
            return
        _finish_batch(idxs, sr, lane.runner.collect(handle), carry)

    def must_wait(lane, est):
        """Admission: at most MAX_INFLIGHT batches in flight on a Runner
        and, beyond two, only while their estimated bytes fit."""
        return bool(lane.inflight) and (
            len(lane.inflight) >= MAX_INFLIGHT
            or (len(lane.inflight) >= 2
                and lane.queued_bytes() + est > inflight_bytes))

    def flush_bucket(key, members, lane=None):
        sr, nch = key
        idxs = [i for i, _ in members]
        ups = [u for _, u in members]
        est = codec.est_bytes(ups)
        if lane is None:
            lane = min(lanes, key=_Lane.queued_bytes)  # ties go to the first
        if must_wait(lane, est):
            with tracing.span("admit"):
                while must_wait(lane, est):
                    collect_one(lane)
        prepared = preppers.submit(tracing.carry(prepare), ups, sr, nch)
        lane.inflight.append((lane.uploader.submit(tracing.carry(_launch), lane, prepared),
                              idxs, sr, nch, ups, est))

    def flush_segments(i, u, plan):
        """A track over the rows cap: its segments in order, each a batch
        of its own, all on one Runner."""
        lane = min(lanes, key=_Lane.queued_bytes)
        for seg in split_track(u, plan):
            flush_bucket((u.sample_rate, u.n_channels), [(i, seg)], lane)

    def flush_ready(key, members, final=False):
        """Cut length-sorted, rows-capped batches off a bucket: whole
        max_batch batches at a wave's end, everything at the scan's end."""
        if not final and len(members) < max_batch:
            return
        members.sort(key=lambda iu: iu[1].n)
        while members and (final or len(members) >= max_batch):
            c = _chunk_size(members, max_batch, rows_cap, codec.padded_rows)
            flush_bucket(key, members[:c])
            del members[:c]

    # The walk leaves the prep threads their cores.
    workers = min(max(len(paths), 1), max((os.cpu_count() or 1) - prep_threads, 1), 16)
    walkers = (ThreadPoolExecutor(max_workers=workers, thread_name_prefix="mp3rgain-walk")
               if workers > 1 else None)

    def walk(path):
        with tracing.span("walk"):
            return _result_of(_unpack, path)

    first = min(wave_size, max_batch)
    bounds = [0, *range(first, len(paths), wave_size), len(paths)]
    try:
        for wstart, wend in zip(bounds, bounds[1:]):
            widx = list(range(wstart, wend))
            wave = [paths[i] for i in widx]
            # Taken in order as each walk ends: a track over the rows cap
            # starts its segments while the wave's later files are walked.
            if walkers is not None and len(wave) > 1:
                unpacked = walkers.map(tracing.carry(walk), wave)
            else:
                unpacked = map(walk, wave)
            for i, path, (u, err) in zip(widx, wave, unpacked):
                if err is not None:
                    outcomes[i] = TrackOutcome(path=str(path), ok=False,
                                               error=str(err), exception=err)
                    continue
                sr, nch = u.sample_rate, u.n_channels or 1
                audio_seconds += codec.seconds(u)
                plan = (segment_plan(u.n, sr, nch, rows_cap)
                        if codec.file_type == "mp3" and device_entropy else None)
                if plan is None:
                    buckets.setdefault((sr, nch), []).append((i, u))
                else:
                    flush_segments(i, u, plan)
            for key, members in buckets.items():
                flush_ready(key, members)
        for key, members in buckets.items():
            flush_ready(key, members, final=True)
        with tracing.span("drain"):
            while any(lane.inflight for lane in lanes):
                for lane in lanes:
                    if lane.inflight:
                        collect_one(lane)
    finally:
        for lane in lanes:
            lane.uploader.shutdown(wait=True, cancel_futures=True)
        preppers.shutdown(wait=True, cancel_futures=True)
        if walkers is not None:
            walkers.shutdown(wait=True)

    tracks = [outcomes[i] for i in range(len(paths))]
    result = BatchResult(tracks=tracks, audio_seconds=audio_seconds,
                         wall_seconds=time.monotonic() - t0)
    ok = [t for t in tracks if t.ok]
    if album and ok:
        result.album_histogram = np.zeros(hi.HISTOGRAM_SIZE, np.int64)
        for t in ok:
            result.album_histogram += t.histogram
        result.album_peak = max(t.result.peak for t in ok)
    return result
