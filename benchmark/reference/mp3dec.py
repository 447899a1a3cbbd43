"""A plain MPEG-1/2 Layer III decoder: bytes in, PCM in [-1, 1] out.

The benchmark's own decoder, written from the format (ISO/IEC 11172-3 and
13818-3) and the constants in mp3_tables.json. It shares no code with the
program under test. The integer part (frame walk, side info, the bit
reservoir, scalefactors, Huffman decode) runs in numpy; the Huffman decode
runs every granule-channel of the stream as one lane, a codeword per lane
per step. The arithmetic part (requantize, joint stereo, reorder, alias
reduction, IMDCT, overlap-add, polyphase synthesis) runs in torch in the
dtype and on the device it is given: float64 on the CPU for the reference.

Semantics, as mp3gain's decoder has them: every audio frame is decoded
(no encoder-delay trimming); a Xing/Info frame is skipped; big values stop
where the granule's part2_3 bits run out; a count1 quadruple that reads
past them is discarded. Intensity stereo and mixed blocks raise
Unsupported: the benchmark's inputs have neither (its tests check).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

_TABLES = json.load(open(os.path.join(os.path.dirname(__file__), "mp3_tables.json")))

_MPEG1, _MPEG2, _MPEG25 = 3, 2, 0
_RATES = {_MPEG1: (44100, 48000, 32000), _MPEG2: (22050, 24000, 16000),
          _MPEG25: (11025, 12000, 8000)}
_KBPS = {True: (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320),
         False: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)}


class Unsupported(ValueError):
    """A stream feature this decoder does not implement."""


@dataclass
class Frame:
    """One audio frame: where it lies and its side info."""

    offset: int
    size: int
    mpeg1: bool
    sample_rate: int
    channels: int
    mode: int
    mode_ext: int
    crc: bool
    side_offset: int  # byte offset of the side info in the file
    side_len: int
    main_data_begin: int = 0
    scfsi: list = field(default_factory=list)
    # per granule, per channel: dict of the side-info fields, and the bit
    # offset of global_gain from the start of the side info
    gc: list = field(default_factory=list)

    @property
    def granules(self) -> int:
        return 2 if self.mpeg1 else 1

    @property
    def body_offset(self) -> int:
        return self.side_offset + self.side_len


def _header(data, pos):
    """Frame fields at `pos`, or None where no Layer III header is."""
    if pos + 4 > len(data) or data[pos] != 0xFF or (data[pos + 1] & 0xE0) != 0xE0:
        return None
    b1, b2, b3 = data[pos + 1], data[pos + 2], data[pos + 3]
    version, layer = (b1 >> 3) & 3, (b1 >> 1) & 3
    br_idx, sr_idx, pad = b2 >> 4, (b2 >> 2) & 3, (b2 >> 1) & 1
    if version == 1 or layer != 1 or br_idx in (0, 15) or sr_idx == 3:
        return None
    mpeg1 = version == _MPEG1
    sr = _RATES[version][sr_idx]
    size = (144000 if mpeg1 else 72000) * _KBPS[mpeg1][br_idx] // sr + pad
    mode = b3 >> 6
    nch = 1 if mode == 3 else 2
    crc = not (b1 & 1)
    side_len = (17 if nch == 1 else 32) if mpeg1 else (9 if nch == 1 else 17)
    return Frame(pos, size, mpeg1, sr, nch, mode, (b3 >> 4) & 3, crc,
                 pos + (6 if crc else 4), side_len)


def _id3v2_end(data) -> int:
    if len(data) < 10 or data[:3] != b"ID3":
        return 0
    size = 0
    for b in data[6:10]:
        size = (size << 7) | (b & 0x7F)
    return 10 + size + (10 if data[5] & 0x10 else 0)


class _Bits:
    """MSB-first reads from an int holding `nbits` bits."""

    def __init__(self, value: int, nbits: int):
        self.v, self.n, self.pos = value, nbits, 0

    def get(self, k: int) -> int:
        if k == 0:
            return 0
        self.pos += k
        return (self.v >> (self.n - self.pos)) & ((1 << k) - 1)


def _parse_side(data, f: Frame) -> None:
    raw = bytes(data[f.side_offset:f.side_offset + f.side_len])
    b = _Bits(int.from_bytes(raw, "big"), 8 * f.side_len)
    if f.mpeg1:
        f.main_data_begin = b.get(9)
        b.get(5 if f.channels == 1 else 3)
        f.scfsi = [[b.get(1) for _ in range(4)] for _ in range(f.channels)]
    else:
        f.main_data_begin = b.get(8)
        b.get(1 if f.channels == 1 else 2)
        f.scfsi = [[0] * 4 for _ in range(f.channels)]
    for _ in range(f.granules):
        row = []
        for _ in range(f.channels):
            g = {"part2_3_length": b.get(12), "big_values": b.get(9),
                 "global_gain_bit": b.pos}
            g["global_gain"] = b.get(8)
            g["scalefac_compress"] = b.get(4 if f.mpeg1 else 9)
            g["window_switching"] = b.get(1)
            if g["window_switching"]:
                g["block_type"] = b.get(2)
                g["mixed"] = b.get(1)
                g["table_select"] = [b.get(5), b.get(5), 0]
                g["subblock_gain"] = [b.get(3), b.get(3), b.get(3)]
                g["region0_count"] = 7 if g["block_type"] != 2 else 8
                g["region1_count"] = 20 - g["region0_count"]
            else:
                g["block_type"] = 0
                g["mixed"] = 0
                g["table_select"] = [b.get(5), b.get(5), b.get(5)]
                g["subblock_gain"] = [0, 0, 0]
                g["region0_count"] = b.get(4)
                g["region1_count"] = b.get(3)
            g["preflag"] = b.get(1) if f.mpeg1 else 0
            g["scalefac_scale"] = b.get(1)
            g["count1table_select"] = b.get(1)
            row.append(g)
        f.gc.append(row)


def is_info_frame(data, f: Frame) -> bool:
    """A Xing/LAME info frame: side info of zeros, then the tag."""
    return bytes(data[f.body_offset:f.body_offset + 4]) in (b"Xing", b"Info")


def walk(data, side_info: bool = True) -> list[Frame]:
    """The stream's audio frames from after any ID3v2 tag up to the first
    byte that does not start a frame, the info frame left out; their side
    info parsed unless side_info is False (parse_side then does it)."""
    pos = _id3v2_end(data)
    frames = []
    while True:
        f = _header(data, pos)
        if f is None or pos + f.size > len(data):
            break
        if not is_info_frame(data, f):
            if side_info:
                _parse_side(data, f)
            frames.append(f)
        pos += f.size
    return frames


def parse_side(data, frames: list[Frame]) -> list[Frame]:
    """Parse the side info of frames that walk(side_info=False) found."""
    for f in frames:
        if not f.gc:
            _parse_side(data, f)
    return frames


# ---------------------------------------------------------------------------
# Scalefactors
# ---------------------------------------------------------------------------

def _lsf_slen(sfc: int):
    """(slen[4], partition-table row, preflag) for MPEG-2 without
    intensity stereo."""
    if sfc < 400:
        return [(sfc >> 4) // 5, (sfc >> 4) % 5, (sfc & 15) >> 2, sfc & 3], 0, 0
    if sfc < 500:
        s = sfc - 400
        return [(s >> 2) // 5, (s >> 2) % 5, s & 3, 0], 1, 0
    s = sfc - 500
    return [s // 3, s % 3, 0, 0], 2, 1


def _read_scalefactors(md: bytes, bit: int, f: Frame, gr: int, ch: int, g: dict,
                       prev_long):
    """(long scalefactors (22,), short (13, 3), bits read) at bit offset
    `bit` of the main data."""
    n = 0
    bitpos = bit

    def get(k):
        nonlocal bitpos, n
        if k == 0:
            return 0
        byte = bitpos >> 3
        chunk = int.from_bytes(md[byte:byte + 4].ljust(4, b"\0"), "big")
        v = (chunk >> (32 - (bitpos & 7) - k)) & ((1 << k) - 1)
        bitpos += k
        n += k
        return v

    sf_l = [0] * 22
    sf_s = [[0, 0, 0] for _ in range(13)]
    short = g["window_switching"] and g["block_type"] == 2
    if g["mixed"]:
        raise Unsupported("mixed blocks")
    if f.mpeg1:
        slen1 = _TABLES["slen1"][g["scalefac_compress"]]
        slen2 = _TABLES["slen2"][g["scalefac_compress"]]
        if short:
            for sfb in range(12):
                k = slen1 if sfb < 6 else slen2
                for w in range(3):
                    sf_s[sfb][w] = get(k)
        else:
            groups = ((0, 6), (6, 11), (11, 16), (16, 21))
            for gi, (a, b) in enumerate(groups):
                k = slen1 if gi < 2 else slen2
                if gr == 1 and f.scfsi[ch][gi] and prev_long is not None:
                    sf_l[a:b] = prev_long[a:b]
                else:
                    for sfb in range(a, b):
                        sf_l[sfb] = get(k)
        g["_preflag"] = g["preflag"]
    else:
        if f.mode == 1 and (f.mode_ext & 1) and ch == 1:
            raise Unsupported("intensity stereo")
        slen, row, preflag = _lsf_slen(g["scalefac_compress"])
        g["_preflag"] = preflag
        nsf = _TABLES["lsf_nsf"][row][1 if short else 0]
        vals = []
        for p in range(4):
            for _ in range(nsf[p]):
                vals.append(get(slen[p]))
        if short:
            for k, v in enumerate(vals):
                sf_s[k // 3][k % 3] = v
        else:
            sf_l[:len(vals)] = vals
    return sf_l, sf_s, n


# ---------------------------------------------------------------------------
# Huffman decode, every granule-channel a lane
# ---------------------------------------------------------------------------

_PEEK = 19


def _build_luts():
    ids = sorted(int(k) for k in _TABLES["huffman"])
    offsets, lens, chunks = {}, {}, []
    total = 0
    for tid in ids:
        ents = _TABLES["huffman"][str(tid)]
        maxlen = max(e[3] for e in ents)
        lut = np.zeros((1 << maxlen, 3), np.int32)  # x, y, len (0: no code)
        for x, y, code, ln in ents:
            lo = code << (maxlen - ln)
            lut[lo:lo + (1 << (maxlen - ln))] = (x, y, ln)
        offsets[tid], lens[tid] = total, maxlen
        total += len(lut)
        chunks.append(lut)
    lut = np.concatenate(chunks)
    sel = _TABLES["select"]
    sel_off = np.array([offsets.get(t, -1) for t, _ in sel], np.int64)
    sel_len = np.array([lens.get(t, 0) for t, _ in sel], np.int64)
    sel_lin = np.array([lb for _, lb in sel], np.int64)
    sel_id = np.array([t for t, _ in sel], np.int64)
    quad = np.zeros((64, 2), np.int32)
    for v, (code, ln) in enumerate(zip(_TABLES["quad_a_code"], _TABLES["quad_a_len"])):
        lo = code << (6 - ln)
        quad[lo:lo + (1 << (6 - ln))] = (v, ln)
    return lut, sel_off, sel_len, sel_lin, sel_id, quad


_LUT = None


def _peek(buf: np.ndarray, pos: np.ndarray, n) -> np.ndarray:
    """n bits (n <= 25, scalar or per lane) at bit offsets pos."""
    byte = pos >> 3
    w = np.zeros(len(pos), np.int64)
    for k in range(5):
        w = (w << 8) | buf[byte + k]
    return (w >> (40 - (pos & 7) - n)) & ((np.int64(1) << n) - 1)


def _huffman(buf: np.ndarray, lanes: dict) -> np.ndarray:
    """(L, 576) int32 quantized values of L lanes."""
    global _LUT
    if _LUT is None:
        _LUT = _build_luts()
    lut, sel_off, sel_len, sel_lin, sel_id, quad = _LUT
    pos = lanes["start"].copy()
    end = lanes["end"]
    big_end = lanes["big_end"]
    r1, r2 = lanes["region1"], lanes["region2"]
    tsel = lanes["table_select"]
    n = len(pos)
    out = np.zeros((n, 576), np.int32)
    stop = np.zeros(n, np.int64)  # value index where big values stopped
    overrun = np.zeros(n, bool)
    alive = np.ones(n, bool)
    for i in range(0, 576, 2):
        act = alive & (i < big_end) & (pos < end)
        stop[alive & ~act] = i
        alive = act
        if not act.any():
            break
        idx = np.nonzero(act)[0]
        p = pos[idx].copy()
        region = np.where(i < r1[idx], 0, np.where(i < r2[idx], 1, 2))
        ts = tsel[idx, region]
        x = np.zeros(len(idx), np.int64)
        y = np.zeros(len(idx), np.int64)
        good = np.ones(len(idx), bool)
        c = np.nonzero(sel_id[ts] != 0)[0]
        if len(c):
            pc, tsc = p[c], ts[c]
            ent = lut[sel_off[tsc] + (_peek(buf, pc, _PEEK) >> (_PEEK - sel_len[tsc]))]
            good[c[ent[:, 2] == 0]] = False  # no codeword: the lane overruns
            pc = pc + ent[:, 2]
            lb = sel_lin[tsc]
            vals = []
            for val in (ent[:, 0].astype(np.int64), ent[:, 1].astype(np.int64)):
                m = (val == 15) & (lb > 0)
                if m.any():
                    val[m] += _peek(buf, pc[m], lb[m])
                    pc[m] += lb[m]
                s = val != 0
                if s.any():
                    neg = np.zeros(len(val), bool)
                    neg[s] = _peek(buf, pc[s], 1) == 1
                    val[neg] = -val[neg]
                    pc[s] += 1
                vals.append(val)
            x[c], y[c], p[c] = vals[0], vals[1], pc
        lost = idx[~good]
        alive[lost] = False
        stop[lost] = i
        overrun[lost] = True
        idx, p, x, y = idx[good], p[good], x[good], y[good]
        pos[idx] = p
        out[idx, i] = x
        out[idx, i + 1] = y
    else:
        stop[alive] = 576
    # count1 quadruples
    vi = np.minimum(stop, 576)
    c1sel = lanes["count1sel"]
    alive = lanes["huff_ok"] & ~overrun & (vi + 4 <= 576) & (pos < end)
    while alive.any():
        idx = np.nonzero(alive)[0]
        p = pos[idx]
        before = p.copy()
        b_tab = c1sel[idx] == 1
        v = np.empty(len(idx), np.int64)
        if b_tab.any():
            v[b_tab] = 15 - _peek(buf, p[b_tab], 4)
            p[b_tab] += 4
        a_tab = ~b_tab
        if a_tab.any():
            e = quad[_peek(buf, p[a_tab], 6)]
            v[a_tab] = e[:, 0]
            p[a_tab] += e[:, 1]
        q = np.zeros((len(idx), 4), np.int64)
        for k in range(4):
            bitset = ((v >> (3 - k)) & 1) == 1
            q[bitset, k] = 1
            if bitset.any():
                neg = _peek(buf, p[bitset], 1) == 1
                col = q[bitset, k]
                col[neg] = -1
                q[bitset, k] = col
                p[bitset] += 1
        over = p > end[idx]
        ok = ~over
        li = idx[ok]
        for k in range(4):
            out[li, vi[li] + k] = q[ok, k]
        vi[li] += 4
        pos[li] = p[ok]
        pos[idx[over]] = before[over]
        alive[idx[over]] = False
        alive[li] = (vi[li] + 4 <= 576) & (pos[li] < end[li])
    return out


# ---------------------------------------------------------------------------
# The stream's integer decode
# ---------------------------------------------------------------------------

@dataclass
class Quantized:
    """Everything the arithmetic stages need, granule-channel by row, rows
    in stream order (frame, granule, channel)."""

    sample_rate: int
    channels: int
    values: np.ndarray  # (R, 576) int32
    global_gain: np.ndarray  # (R,)
    scalefac_scale: np.ndarray  # (R,)
    preflag: np.ndarray  # (R,)
    block_type: np.ndarray  # (R,)
    subblock_gain: np.ndarray  # (R, 3)
    sf_long: np.ndarray  # (R, 22)
    sf_short: np.ndarray  # (R, 13, 3)
    ms: np.ndarray  # (R,) joint stereo mid/side on this row's granule
    valid: np.ndarray  # (R,) the main data was there


def _sr_row(sr: int) -> int:
    return _TABLES["sr_rows"].index(sr)


def quantize_stream(data, frames: list[Frame] | None = None) -> Quantized:
    """Side info, scalefactors and Huffman values of every granule-channel
    of the stream (the integer half of the decode)."""
    frames = walk(data) if frames is None else frames
    if not frames:
        raise ValueError("no Layer III audio frame")
    f0 = frames[0]
    sr, nch = f0.sample_rate, f0.channels
    for f in frames:
        if (f.sample_rate, f.channels) != (sr, nch):
            raise Unsupported("the stream changes format")
        if f.mode == 1 and f.mode_ext & 1:
            raise Unsupported("intensity stereo")
    row = _sr_row(sr)
    bl = np.cumsum([0] + _TABLES["band_long"][row])
    bs = _TABLES["band_short"][row]
    md = bytearray()
    rows = []
    for f in frames:
        start = len(md) - f.main_data_begin
        md += data[f.body_offset:f.offset + f.size]
        bit = start * 8
        for gr in range(f.granules):
            for ch in range(f.channels):
                g = f.gc[gr][ch]
                rows.append((f, gr, ch, g, bit, start >= 0))
                bit += g["part2_3_length"]
    md = bytes(md)
    n = len(rows)
    lanes = {k: np.zeros(n, np.int64) for k in
             ("start", "end", "big_end", "region1", "region2", "count1sel")}
    lanes["table_select"] = np.zeros((n, 3), np.int64)
    lanes["huff_ok"] = np.ones(n, bool)
    q = Quantized(sr, nch, None, np.zeros(n, np.int64), np.zeros(n, np.int64),
                  np.zeros(n, np.int64), np.zeros(n, np.int64), np.zeros((n, 3), np.int64),
                  np.zeros((n, 22), np.int64), np.zeros((n, 13, 3), np.int64),
                  np.zeros(n, bool), np.zeros(n, bool))
    prev_long = {}
    for r, (f, gr, ch, g, bit, ok) in enumerate(rows):
        q.valid[r] = ok
        q.global_gain[r] = g["global_gain"]
        q.scalefac_scale[r] = g["scalefac_scale"]
        short = g["window_switching"] and g["block_type"] == 2
        q.block_type[r] = g["block_type"] if g["window_switching"] else 0
        q.subblock_gain[r] = g["subblock_gain"]
        q.ms[r] = f.mode == 1 and bool(f.mode_ext & 2)
        if not ok or g["part2_3_length"] == 0:
            lanes["huff_ok"][r] = False
            lanes["start"][r] = lanes["end"][r] = 0
            prev_long[ch] = [0] * 22
            continue
        sf_l, sf_s, used = _read_scalefactors(md, bit, f, gr, ch, g,
                                              prev_long.get(ch) if gr == 1 else None)
        prev_long[ch] = sf_l
        q.preflag[r] = g["_preflag"]
        q.sf_long[r] = sf_l
        q.sf_short[r] = sf_s
        lanes["start"][r] = bit + used
        lanes["end"][r] = bit + g["part2_3_length"]
        lanes["big_end"][r] = min(2 * g["big_values"], 576)
        if short:
            r1, r2 = 3 * (bs[0] + bs[1] + bs[2]), 576
        elif g["window_switching"]:
            r1, r2 = int(bl[8]), 576
        else:
            r1 = int(bl[min(g["region0_count"] + 1, 22)])
            r2 = int(bl[min(g["region0_count"] + g["region1_count"] + 2, 22)])
        lanes["region1"][r], lanes["region2"][r] = r1, r2
        lanes["table_select"][r] = g["table_select"]
        lanes["count1sel"][r] = g["count1table_select"]
    buf = np.frombuffer(md + bytes(16), np.uint8).astype(np.int64)
    lanes["big_end"] = np.where(lanes["huff_ok"], lanes["big_end"], 0)
    q.values = _huffman(buf, lanes)
    q.values[~lanes["huff_ok"]] = 0
    return q


# ---------------------------------------------------------------------------
# Arithmetic: requantize to PCM
# ---------------------------------------------------------------------------

def _line_maps(sr: int):
    """Per line of 576: long band, short band, short window, and the
    permutation that reorders a short granule to (subband, window, line)."""
    row = _sr_row(sr)
    l_map = np.repeat(np.arange(22), _TABLES["band_long"][row])[:576]
    s_band, s_win, perm = np.zeros(576, int), np.zeros(576, int), np.zeros(576, int)
    start = 0
    for sfb, width in enumerate(_TABLES["band_short"][row]):
        for w in range(3):
            for i in range(width):
                src = 3 * start + w * width + i
                s_band[src], s_win[src] = sfb, w
                perm[3 * (start + i) + w] = src
        start += width
    return l_map, s_band, s_win, perm


def _imdct_matrices() -> np.ndarray:
    """(4, 18, 36) windowed IMDCT of each block type; type 2 holds the three
    12-point transforms of the reordered (3k + window) inputs."""
    m = np.zeros((4, 18, 36))
    i36 = np.arange(36)
    k18 = np.arange(18)
    cos36 = np.cos(np.pi / 72 * np.outer(2 * k18 + 1, 2 * i36 + 1 + 18))
    sin36 = np.sin(np.pi / 36 * (i36 + 0.5))
    sin12 = np.sin(np.pi / 12 * (np.arange(12) + 0.5))
    w0 = sin36
    w1 = np.concatenate([sin36[:18], np.ones(6), sin12[6:], np.zeros(6)])
    w3 = np.concatenate([np.zeros(6), sin12[:6], np.ones(6), sin36[18:]])
    for bt, w in ((0, w0), (1, w1), (3, w3)):
        m[bt] = cos36 * w[None, :]
    i12 = np.arange(12)
    cos12 = np.cos(np.pi / 24 * np.outer(2 * np.arange(6) + 1, 2 * i12 + 1 + 6))
    for w in range(3):
        for k in range(6):
            m[2, 3 * k + w, 6 + 6 * w:18 + 6 * w] += cos12[k] * sin12
    return m


_CS = None


def pcm_from(q: Quantized, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """(C, T) PCM of the quantized stream, computed in `dtype` on `device`
    (T = 576 samples per granule)."""
    dev = torch.device(device)
    n = len(q.values)
    l_map, s_band, s_win, perm = _line_maps(q.sample_rate)
    vals = torch.from_numpy(q.values.astype(np.float64)).to(dev, dtype)
    short = torch.from_numpy(q.block_type == 2).to(dev)
    scale = 0.5 * (1 + torch.from_numpy(q.scalefac_scale).to(dev, dtype))
    gg = torch.from_numpy(q.global_gain).to(dev, dtype)
    pretab = np.asarray(_TABLES["pretab"])
    sf_l = q.sf_long + q.preflag[:, None] * pretab[None, :]
    e_long = torch.from_numpy(sf_l[:, l_map]).to(dev, dtype)
    e_short = torch.from_numpy(q.sf_short[:, s_band, s_win]).to(dev, dtype)
    sbg = torch.from_numpy(q.subblock_gain[:, s_win]).to(dev, dtype)
    expo = 0.25 * (gg[:, None] - 210.0) - scale[:, None] * torch.where(
        short[:, None], e_short, e_long) - torch.where(short[:, None], 2.0 * sbg,
                                                      torch.zeros_like(sbg))
    xr = torch.sign(vals) * vals.abs() ** (4.0 / 3.0) * torch.exp2(expo)

    c = q.channels
    g = n // c
    xr = xr.view(g, c, 576)
    ms = torch.from_numpy(q.ms.reshape(g, c)[:, 0]).to(dev)
    if c == 2 and bool(ms.any()):
        mid, side = xr[:, 0], xr[:, 1]
        r2 = math.sqrt(0.5)
        left = torch.where(ms[:, None], (mid + side) * r2, mid)
        right = torch.where(ms[:, None], (mid - side) * r2, side)
        xr = torch.stack([left, right], dim=1)
    xr = xr.reshape(n, 576)
    # reorder short granules to (subband, 3 * line + window)
    perm_t = torch.from_numpy(perm).to(dev)
    xr = torch.where(short[:, None], xr[:, perm_t], xr)
    # alias reduction between the subbands of long granules
    ci = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
    cs = torch.tensor(1.0 / np.sqrt(1.0 + ci ** 2), dtype=dtype, device=dev)
    ca = torch.tensor(ci / np.sqrt(1.0 + ci ** 2), dtype=dtype, device=dev)
    x = xr.view(n, 32, 18).clone()
    lo = x[:, :31, 17 - torch.arange(8, device=dev)]  # (n, 31, 8) upper ends
    hi = x[:, 1:, :8]
    new_lo = lo * cs - hi * ca
    new_hi = hi * cs + lo * ca
    long_rows = ~short
    y = x.clone()
    y[:, :31, 17 - torch.arange(8, device=dev)] = torch.where(
        long_rows[:, None, None], new_lo, lo)
    y[:, 1:, :8] = torch.where(long_rows[:, None, None], new_hi, hi)
    # windowed IMDCT by block type
    mats = torch.from_numpy(_imdct_matrices()).to(dev, dtype)
    bt = torch.from_numpy(q.block_type).to(dev)
    out = torch.zeros(n, 32, 36, dtype=dtype, device=dev)
    for t in (0, 1, 2, 3):
        sel = bt == t
        if bool(sel.any()):
            out[sel] = y[sel] @ mats[t]
    # overlap-add along each channel's granules
    out = out.view(g, c, 32, 36)
    prev = torch.zeros_like(out[..., 18:])
    prev[1:] = out[:-1, ..., 18:]
    sub = out[..., :18] + prev  # (g, c, 32, 18)
    inv = torch.ones(32, 18, dtype=dtype, device=dev)
    inv[1::2, 1::2] = -1.0
    sub = sub * inv
    # polyphase synthesis: slot t of channel ch is sub[t // 18, ch, :, t % 18]
    s = sub.permute(1, 0, 3, 2).reshape(c, g * 18, 32)
    kk = np.arange(32)
    ii = np.arange(64)
    nmat = torch.from_numpy(np.cos((16 + ii)[:, None] * (2 * kk + 1)[None, :] * np.pi / 64)
                            ).to(dev, dtype)
    v = s @ nmat.T  # (c, T, 64)
    d = torch.tensor(_TABLES["synth_window_num"], dtype=torch.float64).div(65536.0).to(dev, dtype)
    slots = v.shape[1]
    vp = torch.cat([torch.zeros(c, 16, 64, dtype=dtype, device=dev), v], dim=1)
    pcm = torch.zeros(c, slots, 32, dtype=dtype, device=dev)
    for m in range(8):
        a = vp[:, 16 - 2 * m:16 - 2 * m + slots, :32]
        b = vp[:, 15 - 2 * m:15 - 2 * m + slots, 32:]
        pcm += a * d[64 * m:64 * m + 32] + b * d[64 * m + 32:64 * m + 64]
    return pcm.reshape(c, slots * 32)


def decode(data, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """(C, T) PCM of an MP3 stream."""
    return pcm_from(quantize_stream(data), dtype, device)
