"""Fused requantize + stereo (K2, CUDA) and the natural-order hybrid GEMMs.

Counterpart of mp3rgain_tpu/decode/hybrid_kernel.py. The numpy builders
(_perms, _consts, natural_cores, the GM_* indices) are copies of the JAX
module's, held bit-identical by the tests. The device side is:

  - fused_requant_stereo: on CUDA tensors, launches the hand-written
    kernel csrc/requant_stereo.cu, which replaces the Pallas kernel
    hybrid_kernel._kernel_body; on CPU tensors, runs
    fused_requant_stereo_reference (torch ops mirroring
    hybrid_kernel.py:171-246, same exp2(log2|x|·4/3) form).
  - hybrid_gemm: hybrid_xla on torch.matmul — plain large products that
    XLA computed outside any kernel.

What K2 computes, per granule-channel row r and natural-order sample i
of its layout class c (long / short / mixed):
  x = sign(s)·|s|^(4/3)·2^(0.25(gg−210) − ½(1+sfs)(scf[slot_c(i)] +
      preflag·pretab_c(i)) − 2·short_c(i)·sbg[win_c(i)])
then M/S and intensity stereo across the two channels' rows. The TPU's
one-hot dots that expanded scalefactors and subblock gains become
per-class index tables (constants.onehot_to_index); the kernel reads
them, with pretab, the short flag and the intensity band start, packed
into one 32-bit word per (class, sample) (pack_class_words). The
intensity ratios tan(min(is_pos·π/12, 1.55)) and io^n depend only on the
integer is_pos and two flag bits, so they come from a small f32 table of
the plain formula (is_ratio_table). Rows need no padding (the JAX
package's 256-row tiles were a TPU tile artifact). The source note of
csrc/requant_stereo.cu says what bounds the kernel and how it is laid
out for the card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from .. import _build
from ..device import LaunchCount, check_tensor
from .tables import KIND_MIXED, build_tables, row_tables

# gmeta field indices (int32, one row per granule-channel).
GM_GG = 0  # global_gain
GM_SFS = 1  # scalefac_scale
GM_PRE = 2  # preflag
GM_SBG0 = 3
GM_SBG1 = 4
GM_SBG2 = 5
GM_BT = 6  # block_type
GM_CLS = 7  # layout class 0 long / 1 short / 2 mixed
GM_MS = 8
GM_IS = 9
GM_LSF = 10
GM_ISC = 11  # intensity_scale (parsed from ch1, stored per row)
GM_RZO = 12  # partner channel's rzero bound
GM_N = 16

_SQRT2_INV = float(1.0 / np.sqrt(2.0))

# is_pos values the ratio table covers (scalefactor slots are <= 31).
IS_POS_N = 64

# One 32-bit class word per (layout class, natural sample): (shift, bits)
# of each field. slot and win are stored plus one (0 = none).
CW_SLOT = (0, 7)  # scalefactor slot + 1, 0..64
CW_WIN = (7, 2)  # subblock window + 1, 0..3
CW_PRETAB = (9, 2)  # pretab, 0..3
CW_SHORT = (11, 1)  # short-block flag
CW_BAND_START = (12, 10)  # intensity band start, 0..576

# Kernel launches and plain-version calls of fused_requant_stereo.
COUNT = LaunchCount()


@lru_cache(maxsize=None)
def _perms(sr_row: int):
    t = build_tables()
    rt = row_tables(sr_row)
    return [
        np.arange(576),
        rt.perm_short.copy(),
        t.reorder[sr_row, KIND_MIXED].astype(np.int32),
    ]


@lru_cache(maxsize=None)
def _consts(sr_row: int):
    """Per-class requant/stereo tables re-indexed to natural order."""
    rt = row_tables(sr_row)
    perms = _perms(sr_row)

    slot_nat = np.zeros((3, 64, 576), np.float32)
    win_nat = np.zeros((3, 3, 576), np.float32)
    pretab_nat = np.zeros((3, 576), np.float32)
    bs_nat = np.zeros((3, 576), np.float32)
    short_nat = np.zeros((3, 576), np.float32)
    for c in range(3):
        perm = perms[c]
        # Layout table value at layout sample j belongs to natural
        # sample perm[j] (dst[j] = src[perm[j]]).
        slot_nat[c][:, perm] = rt.slot_onehot[c]
        win_nat[c][:, perm] = rt.win_onehot[c]
        pretab_nat[c][perm] = rt.pretab[c]
        bs_nat[c][perm] = rt.band_start[c].astype(np.float32)
        short_nat[c][perm] = rt.is_short[c].astype(np.float32)
    return slot_nat, win_nat, pretab_nat, bs_nat, short_nat


@lru_cache(maxsize=None)
def natural_cores(sr_row: int):
    """Fused hybrid class cores in NATURAL spectral-input order, in the
    2-core + mixed-head decomposition used by hybrid_gemm.

    Returns (cores2 (2, 576, 1152) f32 [long, short], head (P, 1152)
    f32, P, wins (4, 1152) f32). In natural order the mixed core's rows
    P..575 equal the short core's exactly, so mixed rows decompose as
    z = (x·tail) @ C_short + x[:, :P] @ head; P is detected per
    sample-rate row (36 for MPEG-1 rows, wider for LSF rows)."""
    from .synthesis import _fused_hybrid_cores

    core_l, core_s, core_m, wins = _fused_hybrid_cores()
    cores_layout = [core_l, core_s, core_m]
    perms = _perms(sr_row)

    cores_nat = np.zeros((3, 576, 1152), np.float64)
    for c in range(3):
        perm = perms[c]
        # xr_layout = xr_natural[perm] = xr_natural @ Q with
        # Q[perm[j], j] = 1, so the natural-order core is Q @ core.
        q = np.zeros((576, 576))
        q[perm, np.arange(576)] = 1.0
        cores_nat[c] = q @ cores_layout[c]

    row_diff = np.abs(cores_nat[2] - cores_nat[1]).max(axis=1)
    nz = np.nonzero(row_diff > 1e-9)[0]
    p = int(nz.max()) + 1 if nz.size else 0
    assert p <= 288, (sr_row, p)  # long region never reaches half a granule
    cores2 = np.ascontiguousarray(cores_nat[:2]).astype(np.float32)
    head = np.ascontiguousarray(cores_nat[2][:p]).astype(np.float32)
    return cores2, head, p, wins.astype(np.float32)


def _is_ratios(is_pos, lsf, isc):
    """Intensity-stereo (kl, kr) for float is_pos under the lsf and
    intensity_scale masks: MPEG-1 tan(is_pos·π/12) ratios (is_pos 6 is
    the full-left case) or LSF io^n with io = 2^-1/2 (isc) or 2^-1/4,
    exponents through exact log2 values (hybrid_kernel.py:215-240)."""
    angle = is_pos * np.float32(np.pi / 12.0)
    tan = torch.tan(torch.clamp(angle, max=1.55))
    kl1 = torch.where(is_pos == 6.0, 1.0, tan / (1.0 + tan))
    kr1 = torch.where(is_pos == 6.0, 0.0, 1.0 / (1.0 + tan))
    log2_io = torch.where(isc, -0.5, -0.25).to(is_pos.dtype)
    half_up = torch.floor((is_pos + 1.0) * 0.5)
    k_odd = torch.exp2(half_up * log2_io)
    is_odd = torch.floor(is_pos * 0.5) * 2.0 != is_pos
    kl2 = torch.where(is_odd, k_odd, 1.0)
    kr2 = torch.where(
        is_odd, 1.0,
        torch.where(is_pos == 0.0, 1.0,
                    torch.exp2(torch.floor(is_pos * 0.5) * log2_io)),
    )
    return torch.where(lsf, kl2, kl1), torch.where(lsf, kr2, kr1)


@lru_cache(maxsize=None)
def is_ratio_table() -> np.ndarray:
    """(2 lsf, 2 intensity_scale, IS_POS_N, 2) f32 [kl, kr] for integer
    is_pos: the CUDA kernel's form of _is_ratios."""
    is_pos = torch.arange(IS_POS_N, dtype=torch.float32).view(1, 1, -1)
    lsf = torch.tensor([False, True]).view(2, 1, 1)
    isc = torch.tensor([False, True]).view(1, 2, 1)
    kl, kr = _is_ratios(is_pos, lsf, isc)
    return torch.stack([kl, kr], dim=-1).numpy().astype(np.float32)


def pack_class_words(slot_idx, win_idx, pretab, band_start, short) -> np.ndarray:
    """The K2 tables of one sample-rate row, (3, 576) each (slot and win
    indices with -1 for none, pretab, band start and short flag as
    integral values), as (3, 576) int32 class words with the CW_* fields.
    Raises if a value does not fit its field."""
    fields = ((CW_SLOT, np.asarray(slot_idx) + 1), (CW_WIN, np.asarray(win_idx) + 1),
              (CW_PRETAB, pretab), (CW_SHORT, short), (CW_BAND_START, band_start))
    word = np.zeros((3, 576), np.int64)
    for (shift, bits), vals in fields:
        v = np.asarray(vals, dtype=np.float64)
        iv = v.astype(np.int64)
        if not (np.array_equal(iv, v) and iv.min() >= 0 and iv.max() < (1 << bits)):
            raise ValueError(f"class word field at bit {shift} does not fit {bits} bits")
        word |= iv << shift
    return word.astype(np.int32)


class HybridTables(nn.Module):
    """Per-sample-rate-row constants of the requantize → hybrid span:
    the K2 tables (slot_idx, win_idx: (3, 576) int32, -1 = none;
    pretab, band_start, short: (3, 576) f32, read by the plain version;
    class_words: (3, 576) int32, the same five packed for the kernel;
    is_ratio) and the GEMM cores (cores2, head, wins) of natural_cores."""

    def __init__(self, sr_row: int):
        super().__init__()
        from ..constants import hybrid_state

        arrays = {}
        arrays["slot"], arrays["win"], arrays["pretab"], \
            arrays["band_start"], arrays["short"] = _consts(sr_row)
        arrays["cores2"], arrays["head"], _, arrays["wins"] = \
            natural_cores(sr_row)
        for name, t in hybrid_state(arrays).items():
            self.register_buffer(name, t)

    @property
    def p(self) -> int:
        return self.head.shape[0]


def _check_inputs(spec, scf, gmeta):
    if spec.dim() != 3 or spec.shape[0] not in (1, 2):
        raise ValueError(f"spec: shape {tuple(spec.shape)}, expected (C, R, 576)")
    c, r = spec.shape[:2]
    dev = spec.device
    check_tensor("spec", spec, torch.int16, (c, r, 576), dev)
    check_tensor("scf", scf, torch.int8, (c, r, 64), dev)
    check_tensor("gmeta", gmeta, torch.int32, (c, r, GM_N), dev)
    return dev, c, r


# The kernel indexes (row, 8-sample chunk) pairs with 32-bit ints.
MAX_ROWS = (1 << 30) // 72


def fused_requant_stereo(spec: torch.Tensor, scf: torch.Tensor,
                         gmeta: torch.Tensor, tables: HybridTables):
    """(C, R, 576) int16 spectra + (C, R, 64) int8 scf + (C, R, GM_N)
    int32 gmeta → (C, R, 576) f32 requantized, stereo-processed spectra
    in natural spectral order. Rows are granule-times, channel-major.

    CUDA tensors launch the CUDA kernel (csrc/requant_stereo.cu) on the
    current stream without synchronising; CPU tensors run
    fused_requant_stereo_reference."""
    dev, c, r = _check_inputs(spec, scf, gmeta)
    if dev.type == "cpu":
        return fused_requant_stereo_reference(spec, scf, gmeta, tables)
    if dev.type != "cuda":
        raise ValueError(f"fused_requant_stereo: unsupported device {dev}")
    if r > MAX_ROWS:
        raise ValueError(f"fused_requant_stereo: {r} rows, at most {MAX_ROWS}")
    check_tensor("class_words", tables.class_words, torch.int32, (3, 576), dev)
    check_tensor("is_ratio", tables.is_ratio, torch.float32,
                 (2, 2, IS_POS_N, 2), dev)
    out = torch.empty((c, r, 576), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.mg_cuda_requant_stereo(
            spec.data_ptr(), scf.data_ptr(), gmeta.data_ptr(),
            tables.class_words.data_ptr(), tables.is_ratio.data_ptr(),
            out.data_ptr(), c, r, stream)
    COUNT.kernel += 1
    _build.check(rc, "requant_stereo launch")
    return out


def _requant_reference(spec, scf, gm, tables):
    s = spec.to(torch.float32)  # (R, 576)
    cls = gm[:, GM_CLS].long()
    slot = tables.slot_idx[cls].long()  # (R, 576)
    scf_s = torch.where(
        slot >= 0,
        torch.gather(scf.to(torch.float32), 1, slot.clamp(min=0)), 0.0)
    widx = tables.win_idx[cls].long()
    sbg = gm[:, GM_SBG0 : GM_SBG0 + 3].to(torch.float32)
    sbg_s = torch.where(
        widx >= 0, torch.gather(sbg, 1, widx.clamp(min=0)), 0.0)
    pre = tables.pretab[cls]
    short = tables.short[cls]

    gg = gm[:, GM_GG : GM_GG + 1].to(torch.float32)
    sfs = gm[:, GM_SFS : GM_SFS + 1].to(torch.float32)
    preflag = gm[:, GM_PRE : GM_PRE + 1].to(torch.float32)
    scf_mult = 0.5 * (1.0 + sfs)
    exponent = (
        0.25 * (gg - 210.0)
        - scf_mult * (scf_s + preflag * pre)
        - 2.0 * short * sbg_s
    )
    xm = torch.exp2(torch.log2(s.abs()) * np.float32(4.0 / 3.0))
    return torch.sign(s) * xm * torch.exp2(exponent), scf_s, cls


def fused_requant_stereo_reference(spec, scf, gmeta, tables: HybridTables):
    """Plain torch version of fused_requant_stereo (same contract)."""
    _, c, _ = _check_inputs(spec, scf, gmeta)
    COUNT.plain += 1
    x0, _, cls0 = _requant_reference(spec[0], scf[0], gmeta[0], tables)
    if c == 1:
        return x0[None]
    x1, scf_s1, _ = _requant_reference(spec[1], scf[1], gmeta[1], tables)
    gm0, gm1 = gmeta[0], gmeta[1]
    ms = gm0[:, GM_MS : GM_MS + 1] == 1
    left = torch.where(ms, (x0 + x1) * np.float32(_SQRT2_INV), x0)
    right = torch.where(ms, (x0 - x1) * np.float32(_SQRT2_INV), x1)

    isf = gm0[:, GM_IS : GM_IS + 1] == 1
    band_start = tables.band_start[cls0]
    rzero = gm0[:, GM_RZO : GM_RZO + 1].to(torch.float32)
    in_band = isf & (band_start >= rzero)

    is_pos = scf_s1  # ch1 scalefactors in natural sample layout
    lsf = gm0[:, GM_LSF : GM_LSF + 1] == 1
    kl, kr = _is_ratios(is_pos, lsf, gm1[:, GM_ISC : GM_ISC + 1] == 1)
    illegal = (~lsf) & (is_pos == 7.0)
    apply_i = in_band & ~illegal
    left = torch.where(apply_i, kl * x0, left)
    right = torch.where(apply_i, kr * x0, right)
    return torch.stack([left, right])


def hybrid_gemm(xr: torch.Tensor, gmeta: torch.Tensor,
                tables: HybridTables) -> torch.Tensor:
    """Natural-order spectra → windowed hybrid outputs via the 2-core
    masked decomposition (hybrid_kernel.hybrid_xla): xr (C, R, 576) f32,
    gmeta (C, R, GM_N) int32 → (C, R, 1152) head|tail, full f32."""
    p = tables.p
    cls = gmeta[..., GM_CLS : GM_CLS + 1]
    lane = torch.arange(576, device=xr.device)
    z = torch.matmul(torch.where(cls == 0, xr, 0.0), tables.cores2[0])
    bt = gmeta[..., GM_BT : GM_BT + 1]
    wins = tables.wins
    z *= torch.where(bt == 1, wins[1], torch.where(bt == 3, wins[3], wins[0]))
    xb = torch.where((cls == 1) | ((cls == 2) & (lane >= p)), xr, 0.0)
    z += torch.matmul(xb, tables.cores2[1])
    del xb
    z += torch.matmul(torch.where(cls == 2, xr[..., :p], 0.0), tables.head)
    return z
