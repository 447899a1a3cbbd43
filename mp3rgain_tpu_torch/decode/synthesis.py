"""The host-decoded ("heavy") decode back-end: quantized spectra → PCM.

Counterpart of mp3rgain_tpu/decode/synthesis.py. The numpy builders
(_alias_matrices, _fused_hybrid_cores, _synth_kernel, _tail_matrices,
_tail_matrices_fused) are copies, so that the port never imports that
module (it imports jax at the top); the tests hold every copy
bit-identical to the original. The device side is the JAX package's
_decode_jit with the vmap over tracks written out as a leading batch
dimension: every tensor is (B, G, ...) with records g = t·nch + ch:

  requantize (layout order) → M/S and intensity stereo → class-core
  GEMMs and class select (K3, decode.class_core, in bf16x3 as the JAX
  package ran them under matmul precision "high") → long windows →
  overlap-add → polyphase GEMMs (torch.matmul, full f32).

The TPU's one-hot HIGH dots (reorder, scalefactor and subblock-gain
expansion) become index selects, exact like the dots they replace. The
per-sample-rate-row tables are the buffers of DecodeTables.

The light route's last synthesis step is here too: overlap_polyphase
(overlap-add and polyphase synthesis of the hybrid outputs) launches the
hand-written kernel csrc/overlap_polyphase.cu on CUDA tensors and runs
its plain version, overlap_polyphase_reference (two GEMMs over the
folded maps of _tail_matrices_fused), on CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from .. import _build, tracing
from ..device import check_tensor, resolve_device
from . import frontend as fe
from .class_core import class_core_gemm
from .hybrid_kernel import _is_ratios
from .tables import _window_long, build_tables

# Alias-reduction butterfly coefficients (derived from the ISO ci values).
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
_CS = (1.0 / np.sqrt(1.0 + _CI**2)).astype(np.float64)
_CA = (_CI / np.sqrt(1.0 + _CI**2)).astype(np.float64)


@lru_cache(maxsize=None)
def _alias_matrices():
    """Alias reduction as (576, 576) linear maps: identity plus, at each
    subband boundary sb, 8 butterflies pairing line 18*sb+17-i with
    18*sb+18+i (ISO 11172-3 2.4.3.4.10.1). A_long applies all 31
    boundaries; A_mixed boundary 0 only."""
    a_long = np.eye(576, dtype=np.float64)
    a_mixed = np.eye(576, dtype=np.float64)
    for sb in range(31):
        targets = (a_long, a_mixed) if sb == 0 else (a_long,)
        for i in range(8):
            a = 18 * sb + 17 - i
            b2 = 18 * sb + 18 + i
            for mat in targets:
                mat[a, a] = _CS[i]
                mat[b2, a] = -_CA[i]
                mat[b2, b2] = _CS[i]
                mat[a, b2] = _CA[i]
    return a_long, a_mixed


@lru_cache(maxsize=None)
def _fused_hybrid_cores():
    """Alias reduction ∘ IMDCT ∘ window as THREE (576, 1152) maps, one
    per layout class, with output columns ordered [head(576) | tail(576)]
    in hybrid line layout (col 18*sb + i). The 36-point long core is
    unwindowed (the long window is applied per granule afterwards); the
    short composite and the mixed splice bake their windows. Built in
    f64."""
    t = build_tables()
    i = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    core36 = np.cos(np.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))
    short_m = t.imdct[2]  # windowed short composite (36, 18)
    long_m0 = t.imdct[0]  # windowed long (mixed blocks, sb < 2)

    def blockdiag(mat_of_sb):
        c = np.zeros((576, 1152))
        for sb in range(32):
            m = mat_of_sb(sb)  # (36, 18): [out line w, input line mm]
            sl = slice(18 * sb, 18 * sb + 18)
            c[sl, sl] = m[:18].T
            c[sl, slice(576 + 18 * sb, 576 + 18 * sb + 18)] = m[18:].T
        return c

    a_long, a_mixed = _alias_matrices()
    core_long = a_long @ blockdiag(lambda sb: core36)  # unwindowed
    core_short = blockdiag(lambda sb: short_m)  # window baked
    core_mixed = a_mixed @ blockdiag(
        lambda sb: long_m0 if sb < 2 else short_m
    )

    wins = np.zeros((4, 1152))
    for bt in (0, 1, 3):
        w = _window_long(bt)
        for sb in range(32):
            wins[bt, 18 * sb : 18 * sb + 18] = w[:18]
            wins[bt, 576 + 18 * sb : 576 + 18 * sb + 18] = w[18:]
    return core_long, core_short, core_mixed, wins


def _synth_kernel() -> np.ndarray:
    """Combined synthesis kernel W (16 taps, 64 in, 32 out):
    PCM_t[j] = sum_k sum_u V[t-k, u] * W[k, u, j]."""
    t = build_tables()
    w = np.zeros((16, 64, 32))
    j = np.arange(32)
    for k in range(16):
        cols = j if k % 2 == 0 else 32 + j
        w[k, cols, j] = t.synth_d[k]
    return w


@lru_cache(maxsize=None)
def _tail_matrices():
    """Polyphase synthesis as three GEMM constants over 576/1152 columns.

    V-row layout per granule-time t: column 64*i + u = V value u of slot
    ts = 18*t + i. N18 does the DCT matrixing from hybrid columns
    (18*sb + i); A/B do the 16-tap dewindowing — a tap reaches at most
    17 slots back, so PCM_t = V_t @ A + V_{t-1} @ B exactly."""
    tbs = build_tables()
    n = tbs.synth_n  # (64, 32)
    n18 = np.zeros((576, 1152))
    for sb in range(32):
        for i in range(18):
            n18[18 * sb + i, 64 * i : 64 * i + 64] = n[:, sb]

    w = _synth_kernel()  # (16, 64, 32)
    a = np.zeros((1152, 576))
    b = np.zeros((1152, 576))
    for i in range(18):
        for ip in range(18):
            k = ip - i
            if 0 <= k <= 15:
                a[64 * i : 64 * i + 64, 32 * ip : 32 * ip + 32] = w[k]
            k2 = 18 + ip - i
            if 0 <= k2 <= 15:
                b[64 * i : 64 * i + 64, 32 * ip : 32 * ip + 32] = w[k2]
    return n18, a, b


@lru_cache(maxsize=None)
def _tail_matrices_fused():
    """Polyphase synthesis folded to TWO (576, 576) maps:
    PCM_t = out18_t @ (N18 @ A) + out18_{t-1} @ (N18 @ B), with the
    frequency-inversion sign pattern (odd subbands, odd samples) folded
    into the rows."""
    n18, a, b = _tail_matrices()
    col = np.arange(576)
    sign = np.where(((col // 18) % 2 == 1) & ((col % 18) % 2 == 1), -1.0, 1.0)
    return sign[:, None] * (n18 @ a), sign[:, None] * (n18 @ b)


# ---------------------------------------------------------------------------
# Decode inputs.
# ---------------------------------------------------------------------------


@dataclass
class GranuleBatch:
    """Decode inputs for a batch of tracks of one format. Every field is
    indexed (B, G) or (B, G, k), g running over granule-channel records
    in (time, channel) order: g = t * n_channels + ch. Field order is
    _decode_jit's, which _derive_fields returns."""

    spectrum: torch.Tensor  # (B, G, 576) int
    scf: torch.Tensor  # (B, G, 64) int
    kind: torch.Tensor  # 0 long, 1 start, 2 short, 3 stop, 4 mixed
    sr_row: torch.Tensor  # uniform; DecodeTables' row is authoritative
    global_gain: torch.Tensor
    scalefac_scale: torch.Tensor
    preflag: torch.Tensor
    subblock_gain: torch.Tensor  # (B, G, 3)
    block_type: torch.Tensor
    mixed: torch.Tensor
    ms_flag: torch.Tensor
    is_flag: torch.Tensor
    lsf: torch.Tensor
    intensity_scale: torch.Tensor
    rzero_other: torch.Tensor  # the partner channel's nonzero bound
    n_channels: int


def _derive_fields(spectrum, scf, info, *, n_channels: int):
    """The (..., INFO_N) int32 info tensor → GranuleBatch fields, in
    _decode_jit's argument order."""
    kind = info[..., fe.BLOCK_TYPE]
    kind = torch.where((kind == 2) & (info[..., fe.MIXED] == 1), 4, kind)
    rzero = torch.maximum(info[..., fe.BIG_END], info[..., fe.COUNT1_END])
    if n_channels == 2:
        # The partner channel's bound: records are channel-paired.
        shape = rzero.shape
        rz = rzero.reshape(shape[:-1] + (-1, 2)).flip(-1).reshape(shape)
    else:
        rz = rzero
    joint = (info[..., fe.CHANNEL_MODE] == 1).to(torch.int32)
    ms = joint * ((info[..., fe.MODE_EXT] & 2) >> 1)
    istereo = joint * (info[..., fe.MODE_EXT] & 1)
    sbg = torch.stack(
        [info[..., fe.SBG0], info[..., fe.SBG1], info[..., fe.SBG2]], dim=-1
    )
    return (
        spectrum, scf, kind, info[..., fe.SR_ROW], info[..., fe.GLOBAL_GAIN],
        info[..., fe.SCALEFAC_SCALE], info[..., fe.PREFLAG], sbg,
        info[..., fe.BLOCK_TYPE], info[..., fe.MIXED], ms, istereo,
        (info[..., fe.VERSION] != 1).to(torch.int32),
        info[..., fe.INTENSITY_SCALE], rz,
    )


def batch_from_unpacked(u: fe.UnpackedMp3, device) -> GranuleBatch:
    """One host-decoded track as a GranuleBatch of B = 1 on `device`."""
    dev = resolve_device(device)
    spectrum, scf, info = (torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
                           for a in (u.spectrum, u.scf, u.info))
    nch = u.n_channels or 1
    return GranuleBatch(*_derive_fields(spectrum, scf, info, n_channels=nch),
                        n_channels=nch)


class DecodeTables(nn.Module):
    """Per-sample-rate-row constants of the decode back-end, as buffers
    (constants.decode_state lists them): layout index tables, per-class
    sample constants, the bf16 hi/lo class cores K3 reads, the long
    windows and the polyphase maps."""

    def __init__(self, sr_row: int):
        super().__init__()
        from ..constants import decode_state

        self.sr_row = sr_row
        state = decode_state(sr_row, *_fused_hybrid_cores(), *_tail_matrices_fused())
        for name, t in state.items():
            self.register_buffer(name, t)


# ---------------------------------------------------------------------------
# Device decode, batched over tracks.
# ---------------------------------------------------------------------------


def _classes(kind: torch.Tensor, t: DecodeTables) -> torch.Tensor:
    """(B, G) layout class per record: 0 long, 1 short, 2 mixed."""
    return t.class_of_kind[kind.long()]


def _select_by_class(cls: torch.Tensor, variants):
    """Per-record pick among the long / short / mixed variants; cls is
    (..., 1) to broadcast over samples."""
    out = torch.where(cls == 0, variants[0], variants[1])
    return torch.where(cls == 2, variants[2], out)


def _expand(vals: torch.Tensor, idx: torch.Tensor) -> list[torch.Tensor]:
    """(..., K) values at each class's row of the (3, 576) index table
    `idx` (-1 reads 0): the one-hot dots vals @ onehot[c], exactly."""
    padded = torch.cat([vals, torch.zeros_like(vals[..., :1])], dim=-1)
    idx = torch.where(idx < 0, vals.shape[-1], idx).long()
    return [padded[..., idx[c]] for c in range(idx.shape[0])]


def _reorder(x, cls, t: DecodeTables):
    """Layout permutation: identity (long), short, or mixed (identity
    below sample 36, short above)."""
    x_perm = x[..., t.perm_short.long()]
    lt36 = torch.arange(576, device=x.device) < 36
    x_mixed = torch.where(lt36, x, x_perm)
    return _select_by_class(cls, [x, x_perm, x_mixed])


def _requantize(b: GranuleBatch, cls, t: DecodeTables):
    """(B, G, 576) layout-ordered requantized spectra."""
    spec = _reorder(b.spectrum.to(torch.float32), cls, t)
    scf = b.scf.to(torch.float32)
    scf_s = _select_by_class(cls, _expand(scf, t.slot_idx))
    sbg_s = _select_by_class(cls, _expand(b.subblock_gain.to(torch.float32), t.win_idx))
    c2 = cls[..., 0]
    scf_mult = 0.5 * (1.0 + b.scalefac_scale.to(torch.float32))[..., None]
    pre_term = torch.where(b.preflag[..., None] == 1, t.pretab[c2], 0.0)
    exponent = (
        0.25 * (b.global_gain.to(torch.float32) - 210.0)[..., None]
        - scf_mult * (scf_s + pre_term)
        - 2.0 * t.is_short[c2] * sbg_s
    )
    del scf_s, sbg_s, pre_term
    mag = spec.abs()
    return torch.sign(spec) * mag ** (4.0 / 3.0) * torch.exp2(exponent)


_SQRT2_INV = np.float32(1.0 / np.sqrt(2.0))


def _stereo(b: GranuleBatch, xr, cls, t: DecodeTables):
    """M/S and intensity stereo on channel-paired records (xr[:, 0::2]
    left, xr[:, 1::2] right); mono passes through."""
    if b.n_channels != 2:
        return xr
    x0 = xr[:, 0::2]
    x1 = xr[:, 1::2]
    cls0 = cls[:, 0::2]

    ms = b.ms_flag[:, 0::2, None] == 1
    left = torch.where(ms, (x0 + x1) * _SQRT2_INV, x0)
    right = torch.where(ms, (x0 - x1) * _SQRT2_INV, x1)

    # Intensity stereo above the right channel's nonzero bound, with the
    # right channel's scalefactors read through the left one's layout.
    isf = b.is_flag[:, 0::2, None] == 1
    in_band = isf & (t.band_start[cls0[..., 0]] >= b.rzero_other[:, 0::2, None])
    scf1 = b.scf[:, 1::2].to(torch.float32)
    is_pos = _select_by_class(cls0, _expand(scf1, t.slot_idx))
    lsf = b.lsf[:, 0::2, None] == 1
    kl, kr = _is_ratios(is_pos, lsf, b.intensity_scale[:, 1::2, None] == 1)
    apply_i = in_band & ~(~lsf & (is_pos == 7.0))
    left = torch.where(apply_i, kl * x0, left)
    right = torch.where(apply_i, kr * x0, right)
    bsz, g, s = xr.shape
    return torch.stack([left, right], dim=2).reshape(bsz, g, s)


def _imdct_overlap_fused(b: GranuleBatch, xr, cls, t: DecodeTables):
    """(B, G, 576) → (B, T, nch, 576) windowed hybrid outputs: one K3
    launch does the three class-core GEMMs and the class select (one
    (B·G, 1152) output, not three), long rows take their block type's
    window, then the overlap-add shift along each track's time axis
    (t = 0 takes zeros)."""
    bsz, g, _ = xr.shape
    nch = b.n_channels
    z = class_core_gemm(xr.reshape(1, bsz * g, 576), t.chi, t.clo,
                        row_core=cls.reshape(1, bsz * g).to(torch.int32))
    z = z.view(bsz, g, 1152)
    bt = b.block_type
    wsel = torch.where(bt == 1, 1, torch.where(bt == 3, 3, 0))
    wsel = torch.where(cls[..., 0] == 0, wsel, 4)  # row 4: ones (no window)
    wtab = torch.cat([t.wins, torch.ones_like(t.wins[:1])])
    z *= wtab[wsel]
    tt = g // nch
    head = z[..., :576].reshape(bsz, tt, nch, 576)
    tail = z[..., 576:].reshape(bsz, tt, nch, 576)
    out18 = head.clone()
    out18[:, 1:] += tail[:, :-1]
    return out18


def _synthesis(out18, t: DecodeTables):
    """(B, T, nch, 576) hybrid outputs → (B, nch, T·576) PCM, two GEMMs
    (the previous granule-time's rows are zero at t = 0)."""
    bsz, tt, nch, _ = out18.shape
    prev = torch.cat([torch.zeros_like(out18[:, :1]), out18[:, :-1]], dim=1)
    pcm = torch.matmul(out18, t.synth_na)
    pcm += torch.matmul(prev, t.synth_nb)
    del prev
    return pcm.permute(0, 2, 1, 3).reshape(bsz, nch, tt * 576)


def overlap_polyphase(z: torch.Tensor, tables: DecodeTables) -> torch.Tensor:
    """(C, B, T, 1152) hybrid outputs (head|tail of each granule-time, as
    hybrid_kernel.hybrid_synthesis returns them) → (C, B, T·576) f32 PCM:
    out18[t] = head[t] + tail[t − 1] (zeros before t = 0), then the
    polyphase synthesis of each (channel, track) along its time axis.

    CUDA tensors launch the CUDA kernel (csrc/overlap_polyphase.cu) on the
    current stream without synchronising; CPU tensors run
    overlap_polyphase_reference."""
    if z.dim() != 4 or z.shape[0] not in (1, 2):
        raise ValueError(f"z: shape {tuple(z.shape)}, expected (C, B, T, 1152)")
    c, bsz, tt = z.shape[:3]
    dev = z.device
    check_tensor("z", z, torch.float32, (c, bsz, tt, 1152), dev)
    if dev.type == "cpu":
        return overlap_polyphase_reference(z, tables)
    if dev.type != "cuda":
        raise ValueError(f"overlap_polyphase: unsupported device {dev}")
    check_tensor("synth_n", tables.synth_n, torch.float32, (64, 32), dev)
    check_tensor("synth_d", tables.synth_d, torch.float32, (16, 32), dev)
    pcm = torch.empty((c, bsz, tt * 576), dtype=torch.float32, device=dev)
    if pcm.numel() == 0:
        return pcm
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.mg_cuda_overlap_polyphase(
            z.data_ptr(), tables.synth_n.data_ptr(), tables.synth_d.data_ptr(),
            pcm.data_ptr(), c * bsz, tt, stream)
    tracing.count("launches.overlap_polyphase")
    _build.check(rc, "overlap_polyphase launch")
    return pcm


def overlap_polyphase_reference(z: torch.Tensor, tables: DecodeTables) -> torch.Tensor:
    """Plain torch version of overlap_polyphase (same contract): the
    overlap-add by shifted copies, then two GEMMs over the folded maps
    synth_na, synth_nb."""
    tracing.count("plain.overlap_polyphase")
    c, bsz, tt, _ = z.shape
    head = z[..., :576]
    tl_ = z[..., 576:]
    prev_tail = torch.cat([torch.zeros_like(tl_[:, :, :1]), tl_[:, :, :-1]], dim=2)
    out18 = head + prev_tail  # (C, B, T, 576)
    del prev_tail
    prev18 = torch.cat([torch.zeros_like(out18[:, :, :1]), out18[:, :, :-1]], dim=2)
    pcm = torch.matmul(out18, tables.synth_na)
    pcm += torch.matmul(prev18, tables.synth_nb)
    return pcm.reshape(c, bsz, tt * 576)


def decode_batch(b: GranuleBatch, tables: DecodeTables) -> torch.Tensor:
    """Decode a GranuleBatch to PCM, (B, n_channels, T·576) float32, on
    the device its tensors and `tables` share."""
    cls = _classes(b.kind, tables)[..., None]
    xr = _requantize(b, cls, tables)
    xr = _stereo(b, xr, cls, tables)
    out18 = _imdct_overlap_fused(b, xr, cls, tables)
    del xr
    return _synthesis(out18, tables)


def decode_file(path, *, device="cuda") -> tuple[np.ndarray, int]:
    """Full-file decode; returns (pcm (C, N) float32, sample_rate)."""
    u = fe.unpack_file(path)
    if u.n == 0:
        return np.zeros((1, 0), dtype=np.float32), 0
    dev = resolve_device(device)
    tables = DecodeTables(int(u.info[0, fe.SR_ROW])).to(dev)
    pcm = decode_batch(batch_from_unpacked(u, dev), tables)
    return pcm[0].cpu().numpy(), u.sample_rate
