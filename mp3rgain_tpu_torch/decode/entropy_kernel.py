"""Device MP3 entropy decode: the CUDA Huffman kernel and its plain version.

Counterpart of mp3rgain_tpu/decode/entropy_kernel.py. The host side
(prepare_batch and the helpers it needs) is a copy of the JAX module's,
held bit-identical to it by the tests: the port never imports that module
because it imports jax at the top. The device side is:

  - decode_rows: on CUDA tensors, launches the hand-written kernel
    csrc/entropy_decode.cu, which replaces the Pallas kernel
    entropy_kernel._kernel and the unsort and row gathers after it: each
    lane's spectrum goes straight into the output row a map (dest) gives
    it; on CPU tensors, runs decode_rows_reference.
  - decode_rows_reference: the plain composition decode_blocks_reference
    → unsort_blocks' mask → scatter through dest.
  - decode_blocks_reference: a lockstep, lane-vectorised torch decode of
    (scalars, buf, meta) into the Pallas kernel's lane-major (spec_b,
    mout), with gathers for the word fetches and table lookups.
  - unsort_blocks: masks bad lanes and restores input row order.

The Huffman tables are plain per-window tables built from
entropy_tables.build_luts: (groups, windows, 2) int32 [ab, field], the
fields of the JAX package's packs without its int8 one-hot encoding.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from .. import _build, tracing
from ..device import check_tensor
from ..native import _lib
from ..utils import bufpool
from . import frontend as fe
from .entropy_tables import F2_L3, GROUP_COUNT1_A, build_luts


# Granule-channels per sorted block (the JAX package's shipped value).
LANES = 2048
# Per-lane decode metadata: 5 packed uint16 rows (layout in the JAX
# module, mirrored by _native/mp3dec.cpp mg_entropy_pack4):
#   w0: p23[0:12]  | p0[12:15] | count1_table_bit[15]  (gcnt = bit + 16)
#   w1: bvp[0:9]   | g0[9:13]
#   w2: r0p[0:9]   | g1[9:13]
#   w3: r1p[0:9]   | g2[9:13]
#   w4: l0[0:4] | l1[4:8] | l2[8:12]
META_ROWS = 5
MOUT_ROWS = 8
MAX_STEPS = 288  # >= bvp + (576-2*bvp)/4 for all legal streams
# Word-groups (8 int32 words) a lane may read: covers the maximum legal
# window (part2_3_length <= 4095 bits + lead bits + 64 bits of slack).
W8_MAX = 17
SUBG = 128
SUBG_N = LANES // SUBG


def _cap(value, caps):
    for c in caps:
        if value <= c:
            return c
    return caps[-1]


def _quantize_g(groups: int) -> int:
    """Ragged buffer length in word-groups, quantized to 1/32 of its
    magnitude (bounds the population of distinct buffer shapes)."""
    v = max(int(groups), 32)
    unit = max(32, 1 << max((v - 1).bit_length() - 5, 5))
    return -(-v // unit) * unit


@lru_cache(maxsize=None)
def _luts_packed():
    """Pack LUT fields into bytes: 2 rows per group (the JAX package's
    int8 one-hot MXU form; the port converts it to plain tables in
    constants.luts_from_packed).

    LUT_A row pair (256-wide):  [ab (or the L2 group id for long
                                 prefixes), adv + 16*flag]
    LUT_B row pair (32-wide):   [ab, f2] (f2: 0 invalid, 1..5 rem, 6 L3)
    LUT_C row pair (64-wide):   [ab, rem3] (0 invalid)
    LUT_CT row pair (64-wide):  [v, adv + 16*flag] (count1 A/B)
    All values <= 255 so the int8 offset trick below is exact.
    """
    lut_a, lut_b, lut_c, lut_ct, n_l2, n_l3 = build_luts()
    lutA_T = np.ascontiguousarray(lut_a.T).astype(np.float32)
    lutB_T = np.ascontiguousarray(lut_b.T).astype(np.float32)
    lutC_T = np.ascontiguousarray(lut_c.T).astype(np.float32)
    lutCT_T = np.ascontiguousarray(lut_ct.T).astype(np.float32)

    gA = np.zeros((2, lutA_T.shape[0]), np.float32)
    gB = np.zeros((2, lutB_T.shape[0]), np.float32)
    gC = np.zeros((2, lutC_T.shape[0]), np.float32)
    gCT = np.zeros((2, lutCT_T.shape[0]), np.float32)
    for f in range(2):
        gA[f, f::2] = 1
        gB[f, f::2] = 1
        gC[f, f::2] = 1
        gCT[f, f::2] = 1
    return (
        (lutA_T - 128).astype(np.int8),
        (lutB_T - 128).astype(np.int8),
        (lutC_T - 128).astype(np.int8),
        (lutCT_T - 128).astype(np.int8),
        gA.astype(np.int8),
        gB.astype(np.int8),
        gC.astype(np.int8),
        gCT.astype(np.int8),
        n_l2,
        n_l3,
    )


LUT_NAMES = ("lut_a", "lut_b", "lut_c", "lut_ct")


@lru_cache(maxsize=None)
def plain_luts() -> dict[str, np.ndarray]:
    """The four Huffman tables as (groups, windows, 2) int32 [ab, field]
    arrays, straight from entropy_tables.build_luts (whose (windows,
    2*groups) layout packs group g's fields in columns 2g, 2g+1)."""
    out = {}
    for name, lut in zip(LUT_NAMES, build_luts()[:4]):
        win, cols = lut.shape
        out[name] = np.ascontiguousarray(
            lut.reshape(win, cols // 2, 2).transpose(1, 0, 2)
        ).astype(np.int32)
    return out


class EntropyLuts(nn.Module):
    """The Huffman tables as buffers on one device."""

    def __init__(self):
        super().__init__()
        for name, arr in plain_luts().items():
            self.register_buffer(name, torch.from_numpy(arr.copy()))
        self._packed = None  # (key of the tables it was built from, tensor)

    @property
    def n_l2(self) -> int:
        return self.lut_b.shape[0]

    @property
    def n_l3(self) -> int:
        return self.lut_c.shape[0]

    def packed(self) -> torch.Tensor:
        """All four tables back to back, one int32 entry ab | field << 8
        per (group, window): the CUDA kernel's shared-memory form. Built
        once and reused until a table is moved or changed in place."""
        tables = (self.lut_a, self.lut_b, self.lut_c, self.lut_ct)
        key = tuple((t.data_ptr(), t._version) for t in tables)
        if self._packed is None or self._packed[0] != key:
            parts = [(t[..., 0] | (t[..., 1] << 8)).reshape(-1) for t in tables]
            self._packed = (key, torch.cat(parts).contiguous())
        return self._packed[1]


# ---------------------------------------------------------------------------
# Host batch preparation (copied from the JAX module, bit-identical).
# ---------------------------------------------------------------------------


def _estimate_steps(meta: np.ndarray) -> np.ndarray:
    """Per-gch upper bound on lockstep steps (exact for big, bound for
    count1: quads only run after all big pairs complete)."""
    bvp = meta[:, fe.LM_BVP].astype(np.int64)
    p23 = meta[:, fe.LM_P23].astype(np.int64)
    quads = np.clip(np.minimum((576 - 2 * bvp) // 4, p23), 0, None)
    return np.minimum(bvp + quads, MAX_STEPS).astype(np.int32)


@dataclass
class PreparedEntropy:
    """Host-prepped kernel inputs for one batch of granule-channels.

    The numpy arrays are the exact device transfer payload. buf and meta
    come from the shared buffer pool: hand them back
    (utils.bufpool.give) once the device copy has completed.
    """

    scalars: np.ndarray  # (nb, 3 + SUBG_N) int32 [nbig, ncnt, nw8, off…]
    buf: np.ndarray  # (g_pad, 8, SUBG) int32 subgroup-ragged words
    meta: np.ndarray  # (nb, META_ROWS, LANES) uint16
    inv: np.ndarray  # (npad,) unsort permutation back to input order
    w8_cap: int  # scratch capacity (constant W8_MAX)
    nb: int
    n: int  # real (unpadded) row count

    @property
    def npad(self) -> int:
        return self.nb * LANES

    @property
    def g_pad(self) -> int:
        return self.buf.shape[0]


# nb quantization keeps the population of batch shapes small; padding
# blocks carry zero meta, so their loop bounds are zero.
NB_CAPS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384,
           512, 768, 1024)


def prepare_batch(md, meta, quantize_nb: bool = False,
                  force_nb: int | None = None,
                  force_g_pad: int | None = None) -> PreparedEntropy:
    """Pack per-gch Huffman windows into sorted, blocked kernel inputs.

    md: (N, >=bytes) uint8 main-data windows (from unpack_data_light), or
    a list of such arrays (one per track); meta: matching (N,
    LIGHT_META_N) int32 array or list. force_nb / force_g_pad pin the
    shapes (>= the data's requirements).
    """
    md_list = list(md) if isinstance(md, (list, tuple)) else [md]
    meta_list = list(meta) if isinstance(meta, (list, tuple)) else [meta]
    md_list = [np.ascontiguousarray(m) for m in md_list]
    meta_list = [np.ascontiguousarray(m, dtype=np.int32) for m in meta_list]
    counts = [m.shape[0] for m in md_list]
    n = int(sum(counts))
    md_stride = md_list[0].shape[1] if md_list else fe.MD_STRIDE

    nb = max(1, -(-n // LANES))
    if quantize_nb:
        nb = _cap(nb, NB_CAPS) if nb <= NB_CAPS[-1] else nb
    if force_nb is not None:
        assert force_nb >= nb, (force_nb, nb)
        nb = force_nb
    npad = nb * LANES

    est = np.zeros(npad, np.int32)
    bvp = np.zeros(npad, np.int32)
    quads = np.zeros(npad, np.int32)
    bits = np.zeros(npad, np.int64)
    off = 0
    for m, c in zip(meta_list, counts):
        b = m[:, fe.LM_BVP].astype(np.int64)
        p23 = m[:, fe.LM_P23].astype(np.int64)
        qd = np.clip(np.minimum((576 - 2 * b) // 4, p23), 0, None)
        bvp[off : off + c] = b
        quads[off : off + c] = qd
        est[off : off + c] = np.minimum(b + qd, MAX_STEPS)
        bits[off : off + c] = m[:, fe.LM_P0].astype(np.int64) + p23
        off += c
    # Sort lanes by estimated steps (tight per-block loop bounds; on the
    # GPU also similar lengths within a warp), tie-broken by window bits
    # (tight ragged capacity). Native stable counting sort.
    order = np.empty(npad, dtype=np.int32)
    inv = np.empty(npad, dtype=np.int32)
    i32p_ = ctypes.POINTER(ctypes.c_int32)
    _lib.mg_sort_est_bits(
        est.ctypes.data_as(i32p_),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(npad),
        order.ctypes.data_as(i32p_), inv.ctypes.data_as(i32p_),
    )

    bvp_s = bvp[order].reshape(nb, LANES)
    quads_s = quads[order].reshape(nb, LANES)
    bits_s = bits[order].reshape(nb, LANES)
    # Phase bounds: big pairs (multiple of 4), count1 quads (multiple of 2).
    nbig_b = (bvp_s.max(axis=1) + 3) // 4 * 4
    ncnt_b = (quads_s.max(axis=1) + 1) // 2 * 2
    # Words needed: window bits + 64 slack for mid-symbol overreach;
    # capacity is per 128-lane subgroup, and all-padding subgroups carry
    # zero groups. nw8 is the max over the block's subgroups.
    bits_sg = bits_s.reshape(nb, SUBG_N, SUBG)
    real_sg = (order < n).reshape(nb, SUBG_N, SUBG).any(axis=2)
    w8_sg = np.where(
        real_sg, np.maximum((bits_sg.max(axis=2) + 64 + 255) // 256, 1), 0
    ).astype(np.int64)
    sg_off = np.concatenate(
        [[0], np.cumsum(w8_sg.ravel())[:-1]]
    ).astype(np.int32).reshape(nb, SUBG_N)
    w8_b = w8_sg.max(axis=1)
    g_real = int(w8_sg.sum())
    g_pad = _quantize_g(g_real + W8_MAX)
    if force_g_pad is not None:
        assert force_g_pad >= g_pad, (force_g_pad, g_pad)
        g_pad = force_g_pad

    md_rows = np.empty(max(n, 1), dtype=np.uint64)
    meta_rows = np.empty(max(n, 1), dtype=np.uint64)
    off = 0
    for m, mm, c in zip(md_list, meta_list, counts):
        if c == 0:
            continue
        md_rows[off : off + c] = (
            m.ctypes.data + np.arange(c, dtype=np.uint64) * m.strides[0]
        )
        meta_rows[off : off + c] = (
            mm.ctypes.data + np.arange(c, dtype=np.uint64) * mm.strides[0]
        )
        off += c

    # Pooled output buffers. The packer fully overwrites every in-use
    # region; the unwritten tail pad is never consumed by a decode.
    buf = bufpool.take((g_pad, 8, SUBG), np.int32)
    metab = bufpool.take((nb, META_ROWS, LANES), np.uint16)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    sg_w8_flat = np.ascontiguousarray(w8_sg.ravel().astype(np.int32))
    sg_off_flat = np.ascontiguousarray(sg_off.ravel())
    _lib.mg_entropy_pack4(
        md_rows.ctypes.data_as(u64p), meta_rows.ctypes.data_as(u64p),
        ctypes.c_int64(n), ctypes.c_int64(fe.LIGHT_META_N),
        order.ctypes.data_as(i32p), ctypes.c_int64(npad),
        ctypes.c_int64(LANES), ctypes.c_int64(SUBG),
        sg_off_flat.ctypes.data_as(i32p), sg_w8_flat.ctypes.data_as(i32p),
        ctypes.c_int64(md_stride), ctypes.c_int64(META_ROWS),
        buf.ctypes.data_as(i32p), metab.ctypes.data_as(u16p),
    )

    scalars = np.concatenate(
        [np.stack([nbig_b.astype(np.int32), ncnt_b.astype(np.int32),
                   w8_b.astype(np.int32)], axis=1),
         sg_off], axis=1
    )
    return PreparedEntropy(
        scalars=scalars, buf=buf, meta=metab, inv=inv,
        w8_cap=W8_MAX, nb=nb, n=n,
    )


# ---------------------------------------------------------------------------
# Device decode.
# ---------------------------------------------------------------------------


def _check_inputs(scalars, buf, meta):
    dev = buf.device
    nb = scalars.shape[0] if scalars.dim() == 2 else -1
    check_tensor("scalars", scalars, torch.int32, (nb, 3 + SUBG_N), dev)
    check_tensor("buf", buf, torch.int32, (None, 8, SUBG), dev)
    check_tensor("meta", meta, torch.int16, (nb, META_ROWS, LANES), dev)
    return dev, nb


def _check_row_inputs(scalars, buf, meta, dest, n_rows):
    dev, nb = _check_inputs(scalars, buf, meta)
    check_tensor("dest", dest, torch.int32, (nb * LANES,), dev)
    if not 0 <= n_rows < 2**31:
        raise ValueError(f"n_rows {n_rows}: expected 0 <= n_rows < 2**31")
    return dev, nb


def decode_rows(scalars: torch.Tensor, buf: torch.Tensor, meta: torch.Tensor,
                luts: EntropyLuts, dest: torch.Tensor, n_rows: int):
    """Huffman-decode prepared blocks straight into output rows.

    scalars (nb, 3 + SUBG_N) int32, buf (g_pad, 8, SUBG) int32, meta
    (nb, META_ROWS, LANES) int16 holding prepare_batch's uint16 bits, as
    prepare_batch made them (its offsets keep every read inside buf), and
    dest (nb * LANES,) int32: the output row of each SORTED lane, -1 (or
    any value outside [0, n_rows)) for none; rows are distinct. Returns
    (spec_rows (n_rows, 576) int16, big_end (n_rows,) int32, count1_end
    (n_rows,) int32): lane dest[l]'s decode in row dest[l], a lane that
    went bad as an all-zero row with both ends 0 (unsort_blocks' mask),
    and rows no lane writes all zero.

    CUDA tensors launch the CUDA kernel (csrc/entropy_decode.cu) on the
    current stream without synchronising; CPU tensors run
    decode_rows_reference."""
    dev, nb = _check_row_inputs(scalars, buf, meta, dest, n_rows)
    if dev.type == "cpu":
        return decode_rows_reference(scalars, buf, meta, luts, dest, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"decode_rows: unsupported device {dev}")
    table = luts.packed()
    check_tensor("luts", table, torch.int32, None, dev)
    spec = torch.empty((n_rows, 576), dtype=torch.int16, device=dev)
    big_end = torch.empty((n_rows,), dtype=torch.int32, device=dev)
    count1_end = torch.empty((n_rows,), dtype=torch.int32, device=dev)
    covered = torch.empty((n_rows,), dtype=torch.uint8, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.mg_cuda_entropy_decode_rows(
            scalars.data_ptr(), scalars.shape[1], buf.data_ptr(),
            meta.data_ptr(), table.data_ptr(), luts.n_l2, luts.n_l3,
            dest.data_ptr(), nb, LANES, spec.data_ptr(), big_end.data_ptr(),
            count1_end.data_ptr(), covered.data_ptr(), n_rows, stream,
        )
    tracing.count("launches.entropy_decode_rows")
    _build.check(rc, "entropy_decode_rows launch")
    return spec, big_end, count1_end


def decode_rows_reference(scalars: torch.Tensor, buf: torch.Tensor,
                          meta: torch.Tensor, luts: EntropyLuts,
                          dest: torch.Tensor, n_rows: int):
    """Plain torch version of decode_rows (same contract): the lockstep
    decode_blocks_reference, unsort_blocks' bad-lane mask (in sorted lane
    order), then a scatter of each lane's row through dest into zeros."""
    dev, nb = _check_row_inputs(scalars, buf, meta, dest, n_rows)
    tracing.count("plain.entropy_decode_rows")
    spec_b, mout = decode_blocks_reference(scalars, buf, meta, luts)
    lanes = torch.arange(nb * LANES, device=dev)
    spec, big_end, count1_end, _ok = unsort_blocks(spec_b, mout, lanes, nb=nb)
    d = dest.long()
    d = torch.where((d >= 0) & (d < n_rows), d, n_rows)  # row n_rows: dropped
    rows = torch.zeros((n_rows + 1, 576), dtype=torch.int16, device=dev)
    rows[d] = spec
    ends = torch.zeros((2, n_rows + 1), dtype=torch.int32, device=dev)
    ends[:, d] = torch.stack([big_end, count1_end])
    return rows[:n_rows], ends[0, :n_rows], ends[1, :n_rows]


def input_order_dest(inv: torch.Tensor, n: int) -> torch.Tensor:
    """dest that puts the decode of input row i (i < n) in row i: the
    unsort of prepare_batch's lane order as a decode_rows map (padding
    rows, i >= n, get -1)."""
    dest = torch.full_like(inv, -1)
    dest[inv[:n].long()] = torch.arange(n, dtype=inv.dtype, device=inv.device)
    return dest


def _extract(u0, u1, u2, rel, nbits: int):
    """Top `nbits` bits at bit `rel` of the 96-bit window u0:u1:u2 (int64
    words in [0, 2**32)), with the lockstep kernel's word selection."""
    j = rel >> 5
    r = rel & 31
    wa = torch.where(j == 0, u0, torch.where(j == 1, u1, u2))
    wb = torch.where(j == 0, u1, torch.where(j == 1, u2, 0))
    cat = ((wa << r) & 0xFFFFFFFF) | (wb >> (32 - r))
    return cat >> (32 - nbits)


def _lookup(table, gid, win):
    """[ab, field] of (groups, windows, 2) `table` at (gid, win) per lane.
    Out-of-range group ids only occur on lanes whose result is unused."""
    g, w, _ = table.shape
    idx = gid.clamp(0, g - 1) * w + win
    vals = table.reshape(g * w, 2)[idx]
    return vals[:, 0], vals[:, 1]


def decode_blocks_reference(scalars: torch.Tensor, buf: torch.Tensor,
                            meta: torch.Tensor, luts: EntropyLuts):
    """The Pallas kernel's decode in plain torch: every lane steps in
    lockstep, as in mp3rgain_tpu/decode/entropy_kernel.py:154-571, with
    the per-lane word fetch and table lookups as gathers. Returns its
    outputs, (spec_b (nb, 576, LANES) int16, mout (nb, 8, LANES) int32),
    both in sorted lane order; mout's rows are big_end, count1_end, bad,
    p, n, q, alive, 0."""
    dev, nb = _check_inputs(scalars, buf, meta)
    i64 = torch.int64
    L = LANES
    lut_a = luts.lut_a.to(i64)
    lut_b = luts.lut_b.to(i64)
    lut_c = luts.lut_c.to(i64)
    lut_ct = luts.lut_ct.to(i64)

    sc = scalars.to(i64)
    m = meta.to(i64) & 0xFFFF
    w0, w1, w2, w3, w4 = (m[:, r, :].reshape(-1) for r in range(META_ROWS))
    p0 = (w0 >> 12) & 7
    pend = p0 + (w0 & 0xFFF)
    gcnt = ((w0 >> 15) & 1) + 16
    bvp = w1 & 511
    g0, g1, g2 = (w1 >> 9) & 15, (w2 >> 9) & 15, (w3 >> 9) & 15
    r0p, r1p = w2 & 511, w3 & 511
    l0, l1, l2 = w4 & 15, (w4 >> 4) & 15, (w4 >> 8) & 15

    blk = torch.arange(nb, device=dev).repeat_interleave(L)
    lane = torch.arange(L, device=dev).repeat(nb)
    nbig_l = sc[blk, 0]
    ncnt_l = sc[blk, 1]
    nw8_l = sc[blk, 2]
    off_l = sc[blk, 3 + lane // SUBG]
    lane_sg = lane % SUBG
    words = buf.reshape(-1).to(i64) & 0xFFFFFFFF
    g_pad = buf.shape[0]

    def word(w):
        g = w >> 3
        ok = (w >= 0) & (g < nw8_l) & (g < W8_MAX)
        grp = (off_l + g.clamp(0, W8_MAX - 1)).clamp(0, g_pad - 1)
        return torch.where(ok, words[(grp * 8 + (w & 7)) * SUBG + lane_sg], 0)

    def window(p):
        wi = p >> 5
        return word(wi), word(wi + 1), word(wi + 2), wi << 5

    out = torch.zeros((nb, 577, L), dtype=torch.int16, device=dev)
    zero = torch.zeros(nb * L, dtype=i64, device=dev)
    p = p0.clone()
    n = zero.clone()
    alive = torch.ones_like(zero)
    bad_ever = zero.clone()

    # --- phase 1: big values; pair k lands at rows (2k, 2k+1) ------------
    for k in range(int(sc[:, 0].max())):
        can_big = (k < bvp) & (k < nbig_l) & (p < pend) & (alive == 1)
        if not bool(can_big.any()):
            break
        u0, u1, u2, base = window(p)

        def ext(qbit, nbits, u0=u0, u1=u1, u2=u2, base=base):
            return _extract(u0, u1, u2, qbit - base, nbits)

        gbig = torch.where(n < r0p, g0, torch.where(n < r1p, g1, g2))
        linb = torch.where(n < r0p, l0, torch.where(n < r1p, l1, l2))
        ab1, af = _lookup(lut_a, gbig, ext(p, 8))
        adv1, flag1 = af & 15, af >> 4
        cont = (flag1 == 1) & can_big
        bad = (flag1 == 3) & can_big
        ab2, f2 = _lookup(lut_b, ab1, ext(p + 8, 5))
        ab3, rem3 = _lookup(lut_c, ab2, ext(p + 13, 6))
        cont3 = cont & (f2 == F2_L3)
        bad = bad | (cont & (f2 == 0)) | (cont3 & (rem3 == 0))

        abf = torch.where(cont3, ab3, torch.where(cont, ab2, ab1))
        x = abf & 15
        y = abf >> 4
        clen = torch.where(cont3, 13 + rem3, torch.where(cont, 8 + f2, adv1))
        qq = p + clen
        e = ext(qq, 28)  # linbits_x + sign_x + linbits_y + sign_y
        ex = (x == 15) & (linb > 0)
        xv = x + torch.where(ex, e >> (28 - linb), 0)
        lx = torch.where(ex, linb, 0)
        sx = (xv != 0) & can_big
        xv = torch.where(sx & (((e >> (27 - lx)) & 1) == 1), -xv, xv)
        o = lx + sx.to(i64)
        ey = (y == 15) & (linb > 0)
        mask_y = (torch.ones_like(linb) << linb) - 1
        yv = y + torch.where(ey, (e >> (28 - o - linb)) & mask_y, 0)
        ly = torch.where(ey, linb, 0)
        sy = (yv != 0) & can_big
        yv = torch.where(sy & (((e >> (27 - o - ly)) & 1) == 1), -yv, yv)
        p_big = qq + o + ly + sy.to(i64)

        emit = can_big & ~bad
        out[:, 2 * k, :] = torch.where(emit, xv, 0).view(nb, L)
        out[:, 2 * k + 1, :] = torch.where(emit, yv, 0).view(nb, L)
        p = torch.where(emit, p_big, p)
        n = n + emit.to(i64)
        alive = torch.where(bad, 0, alive)
        bad_ever = torch.where(bad, 1, bad_ever)

    # --- phase 2: count1 quads at rows 2*bvp + 4j + m ---------------------
    q = zero.clone()
    out_flat = out.view(-1)
    for j in range(int(sc[:, 1].max())):
        can_cnt = ((j < ncnt_l) & (p < pend) & (alive == 1)
                   & (2 * n + 4 * q + 4 <= 576))
        if not bool(can_cnt.any()):
            break
        u0, u1, u2, base = window(p)
        ab1, af = _lookup(lut_ct, gcnt - GROUP_COUNT1_A,
                          _extract(u0, u1, u2, p - base, 6))
        adv1, flag1 = af & 15, af >> 4
        bad = (flag1 == 3) & can_cnt
        qq = p + adv1
        sb = _extract(u0, u1, u2, qq - base, 14) >> 10  # 4 sign bits at qq
        v = ab1 & 15
        v3, v2, v1, v0 = (v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1
        o1 = v3
        o2 = v3 + v2
        o3 = o2 + v1
        vals = [
            torch.where(v3 == 1, 1 - 2 * ((sb >> 3) & 1), 0),
            torch.where(v2 == 1, 1 - 2 * ((sb >> (3 - o1)) & 1), 0),
            torch.where(v1 == 1, 1 - 2 * ((sb >> (3 - o2)) & 1), 0),
            torch.where(v0 == 1, 1 - 2 * ((sb >> (3 - o3)) & 1), 0),
        ]
        p_cnt = qq + o3 + v0
        over = can_cnt & (p_cnt > pend)
        emit = can_cnt & ~over & ~bad
        for r, val in enumerate(vals):
            row = torch.where(emit, 2 * bvp + 4 * j + r, 576)
            out_flat[(blk * 577 + row) * L + lane] = torch.where(
                emit, val, 0).to(torch.int16)
        p = torch.where(emit, p_cnt, p)
        q = q + emit.to(i64)
        alive = torch.where(bad | over, 0, alive)
        bad_ever = torch.where(bad, 1, bad_ever)

    bad_b = bad_ever == 1
    mout = torch.stack([
        torch.where(bad_b, 0, 2 * n),          # big_end
        torch.where(bad_b, 0, 2 * n + 4 * q),  # count1_end
        bad_ever, p, n, q, alive, zero,
    ]).view(MOUT_ROWS, nb, L).transpose(0, 1)
    return (out[:, :576, :].contiguous(),
            mout.to(torch.int32).contiguous())


def unsort_blocks(spec_b: torch.Tensor, mout: torch.Tensor,
                  inv: torch.Tensor, *, nb: int):
    """Mask bad lanes and unsort to input row order.

    Returns (spec (npad, 576) int16, big_end, count1_end, ok (npad,))."""
    npad = nb * LANES
    # Bad lanes report count1_end 0 and must read as all-zero spectra
    # (values emitted before the stream went bad stay in spec_b).
    ce_b = mout[:, 1:2, :]
    i = torch.arange(576, device=spec_b.device).view(1, 576, 1)
    spec_b = torch.where(i < ce_b, spec_b, torch.zeros((), dtype=spec_b.dtype,
                                                       device=spec_b.device))
    inv = inv.long()
    spec = spec_b.transpose(1, 2).reshape(npad, 576)[inv]
    mout_n = mout.transpose(1, 2).reshape(npad, MOUT_ROWS)[inv]
    return spec, mout_n[:, 0], mout_n[:, 1], mout_n[:, 2] == 0
