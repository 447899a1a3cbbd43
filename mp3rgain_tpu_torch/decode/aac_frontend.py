"""The torch port's copy of mp3rgain_tpu/decode/aac_frontend.py, bound to
the port's native.py (whose loader declares the three mg_aac_unpack_adts
entry points, so nothing here builds or loads the library at import),
held equal to it by tests/test_torch_host_copies.py.

AAC decode front-end wrapper: MP4/ADTS demux + native entropy stage.

MP4 (M4A) files are demuxed in Python (sample tables → raw AAC frames →
ADTS); the native C++ stage (_native/aacdec.cpp) handles all AAC-LC
entropy decode and spectral prep. Output: natural-order requantized
spectra + window metadata for the device back-end.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import numpy as np

from ..native import _inbuf, _lib, _u8p

# Info field indices (keep in sync with _native/aacdec.cpp).
FRAME = 0
CHANNEL = 1
WINDOW_SEQ = 2
WINDOW_SHAPE = 3
NCH = 4
SR = 5
VALID = 6
INFO_N = 8

# info[7] flag bits (diagnostics + routing), kept in sync with aacdec.cpp.
FLAG_TNS = 1
FLAG_PNS = 2
FLAG_INTENSITY = 4
FLAG_ESC = 8
FLAG_PULSE = 16
FLAG_FALLBACK = 32

ADTS_SR_INDEX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
                 24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}
SR_FROM_INDEX = {v: k for k, v in ADTS_SR_INDEX.items()}


@dataclass
class UnpackedAac:
    spec: np.ndarray | None  # (n, 1024) float32, natural window order
    info: np.ndarray  # (n, INFO_N) int32
    # Block-scaled half-precision form (f16=True): true spectrum is
    # spec16 * 2^sexp[:, None]. Halves the host->device payload; the
    # f32 form remains the decoder-oracle path.
    spec16: np.ndarray | None = None  # (n, 1024) float16
    sexp: np.ndarray | None = None  # (n,) int8 per-frame exponent

    @property
    def n(self) -> int:
        return self.info.shape[0]

    @property
    def sample_rate(self) -> int:
        return int(self.info[0, SR]) if self.n else 0

    @property
    def n_channels(self) -> int:
        return int(self.info[0, NCH]) if self.n else 0


@dataclass
class UnpackedAacQ:
    """Device-requant unpack: quantized coefficients + band metadata.

    The spectral prep (requantize -> PNS -> M/S + intensity stereo) runs
    on device (decode/aac_prep.py); frames the device path cannot
    express (EIGHT_SHORT windows, TNS, |q| > int16) arrive as COMPACTED
    block-scaled f16 fallback rows (full host decode) with their lane
    indices in fbrows. Coefficients outside int8 (|q| > 127, rare) ship
    sparsely: qspec holds 0 there and esc_idx/esc_val carry
    (lane*1024+pos, exact int16 value) for a device scatter-add.
    """

    qspec: np.ndarray  # (n, 1024) int8, natural order; zero on fb lanes
    lvl: np.ndarray  # (n, 64) int16: sf / PNS energy / intensity position
    btype: np.ndarray  # (n, 64) uint8: 0 zero, 1 normal, 2 noise, 3 is+, 4 is-
    msf: np.ndarray  # (n, 64) uint8 ms_used flags
    info: np.ndarray  # (n, INFO_N) int32
    fb16: np.ndarray  # (n_fb, 1024) uint16 f16 bits, block-scaled
    fbexp: np.ndarray  # (n_fb,) int8 per-row exponents
    fbrows: np.ndarray  # (n_fb,) int32 lane indices of the fallback rows
    esc_idx: np.ndarray  # (n_esc,) int32 lane*1024 + position
    esc_val: np.ndarray  # (n_esc,) int16 exact quantized values

    @property
    def n(self) -> int:
        return self.info.shape[0]

    @property
    def sample_rate(self) -> int:
        return int(self.info[0, SR]) if self.n else 0

    @property
    def n_channels(self) -> int:
        return int(self.info[0, NCH]) if self.n else 0


def _count_adts_channel_frames(data: bytes) -> int:
    """Exact output-lane count from a cheap ADTS header walk (avoids the
    4x-oversized len//64 capacity guess — these buffers are the unpack
    stage's biggest allocation)."""
    n = 0
    pos = 0
    ln = len(data)
    while pos + 7 <= ln:
        if data[pos] != 0xFF or (data[pos + 1] & 0xF0) != 0xF0:
            pos += 1
            continue
        sr_index = (data[pos + 2] >> 2) & 0xF
        full_len = (((data[pos + 3] & 0x3) << 11) | (data[pos + 4] << 3)
                    | (data[pos + 5] >> 5))
        if full_len < 7 or pos + full_len > ln or sr_index >= 12:
            pos += 1
            continue
        ch_conf = ((data[pos + 2] & 1) << 2) | ((data[pos + 3] >> 6) & 3)
        n += 1 if ch_conf == 1 else 2
        pos += full_len
    return n


def unpack_adts_q(data: bytes) -> UnpackedAacQ:
    cap = max(4, _count_adts_channel_frames(data))
    # Escape entries cost 6 bytes; size the sideband generously (16 per
    # channel-frame covers even noise-dense encodes) so the full-stream
    # re-decode retry below is reserved for pathological content. The
    # fallback rows ship compacted (in lane order, matching the info
    # flag); most streams have none, so start that cap small.
    esc_cap = max(4096, cap * 16)
    fb_cap = max(64, cap // 8)
    while True:
        qspec = np.zeros((cap, 1024), dtype=np.int8)
        lvl = np.zeros((cap, 64), dtype=np.int16)
        btype = np.zeros((cap, 64), dtype=np.uint8)
        msf = np.zeros((cap, 64), dtype=np.uint8)
        fb16 = np.zeros((fb_cap, 1024), dtype=np.uint16)
        fbexp = np.zeros(fb_cap, dtype=np.int8)
        fb_n = ctypes.c_int64(0)
        esc_idx = np.zeros(esc_cap, dtype=np.int32)
        esc_val = np.zeros(esc_cap, dtype=np.int16)
        esc_n = ctypes.c_int64(0)
        info = np.zeros((cap, INFO_N), dtype=np.int32)
        n = _lib.mg_aac_unpack_adts_q(
            _inbuf(data), len(data),
            qspec.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            lvl.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            btype.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            msf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            fb16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            fbexp.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            fb_cap, ctypes.byref(fb_n),
            esc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            esc_val.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            esc_cap, ctypes.byref(esc_n),
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        if (n <= cap and esc_n.value <= esc_cap
                and fb_n.value <= fb_cap):
            ne = int(esc_n.value)
            nfb = int(fb_n.value)
            info = info[:n]
            fbrows = np.nonzero(info[:, 7] & FLAG_FALLBACK)[0].astype(
                np.int32
            )
            assert len(fbrows) == nfb, (len(fbrows), nfb)
            return UnpackedAacQ(
                qspec=qspec[:n], lvl=lvl[:n], btype=btype[:n], msf=msf[:n],
                info=info, fb16=fb16[:nfb], fbexp=fbexp[:nfb],
                fbrows=fbrows,
                esc_idx=esc_idx[:ne].copy(), esc_val=esc_val[:ne].copy(),
            )
        cap = max(cap, int(n))
        esc_cap = max(esc_cap, int(esc_n.value))
        fb_cap = max(fb_cap, int(fb_n.value))


def unpack_adts(data: bytes, f16: bool = False) -> UnpackedAac:
    cap = max(64, len(data) // 64)
    while True:
        info = np.zeros((cap, INFO_N), dtype=np.int32)
        if f16:
            spec16 = np.zeros((cap, 1024), dtype=np.float16)
            sexp = np.zeros(cap, dtype=np.int8)
            n = _lib.mg_aac_unpack_adts_f16(
                _inbuf(data), len(data),
                spec16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                sexp.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            )
            if n <= cap:
                return UnpackedAac(spec=None, info=info[:n],
                                   spec16=spec16[:n], sexp=sexp[:n])
        else:
            spec = np.zeros((cap, 1024), dtype=np.float32)
            n = _lib.mg_aac_unpack_adts(
                _inbuf(data), len(data),
                spec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            )
            if n <= cap:
                return UnpackedAac(spec=spec[:n], info=info[:n])
        cap = int(n)


# ---------------------------------------------------------------------------
# MP4 demux: extract raw AAC samples + AudioSpecificConfig, re-frame as ADTS.
# ---------------------------------------------------------------------------


def _walk_boxes(data, start, end):
    pos = start
    while pos + 8 <= end:
        size = struct.unpack_from(">I", data, pos)[0]
        btype = data[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        yield btype, pos + hdr, pos + size
        pos += size


def _find(data, start, end, *path):
    if not path:
        return start, end
    for btype, cs, ce in _walk_boxes(data, start, end):
        if btype == path[0]:
            if path[0] == b"meta":
                cs += 4  # version/flags
            return _find(data, cs, ce, *path[1:])
    return None


class Mp4DemuxError(RuntimeError):
    pass


def mp4_to_adts(data: bytes, track_index: int | None = None) -> bytes:
    """Extract an AAC track from an M4A/MP4 file as an ADTS stream.

    track_index selects among the file's audio (mp4a) tracks in trak
    order; None means the first. Out-of-range indices raise with the
    reference's message (src/replaygain.rs:838-851).
    """
    moov = _find(data, 0, len(data), b"moov")
    if moov is None:
        raise Mp4DemuxError("No moov box")

    # Enumerate audio traks (mp4a sample entries) in file order.
    audio_tracks = []  # (entry_pos, entry_size, stbl)
    for btype, cs, ce in _walk_boxes(data, *moov):
        if btype != b"trak":
            continue
        stbl = _find(data, cs, ce, b"mdia", b"minf", b"stbl")
        if stbl is None:
            continue
        stsd = _find(data, *stbl, b"stsd")
        if stsd is None:
            continue
        # stsd: version/flags(4) entry_count(4) then sample entries.
        entry_pos = stsd[0] + 8
        size, fmt = struct.unpack_from(">I4s", data, entry_pos)
        if fmt != b"mp4a":
            continue
        audio_tracks.append((entry_pos, size, stbl))

    if not audio_tracks:
        raise Mp4DemuxError("No AAC audio track found")
    idx = 0 if track_index is None else int(track_index)
    if idx < 0 or idx >= len(audio_tracks):
        raise Mp4DemuxError(
            f"Track index {idx} out of range "
            f"(file has {len(audio_tracks)} audio track(s))"
        )
    entry_pos, size, stbl = audio_tracks[idx]
    # mp4a box: 8 hdr + 6 reserved + 2 data_ref + 8 reserved +
    # 2 ch + 2 bits + 4 reserved + 4 rate, then child boxes (esds).
    esds = _find(data, entry_pos + 8 + 28, entry_pos + size, b"esds")
    if esds is None:
        raise Mp4DemuxError("mp4a without esds")
    asc = _parse_esds(data[esds[0] : esds[1]])
    sizes, offsets = _sample_tables(data, stbl)
    return _build_adts(data, sizes, offsets, asc)


def _parse_esds(esds: bytes) -> tuple[int, int, int]:
    """Return (object_type, sr_index, channels) from the DecoderSpecificInfo."""
    pos = 4  # version/flags

    def read_desc(pos):
        tag = esds[pos]
        pos += 1
        size = 0
        for _ in range(4):
            b = esds[pos]
            pos += 1
            size = (size << 7) | (b & 0x7F)
            if not (b & 0x80):
                break
        return tag, size, pos

    while pos < len(esds):
        tag, size, pos = read_desc(pos)
        if tag == 0x03:  # ES_Descriptor: es_id(2) + flags(1)
            pos += 3
        elif tag == 0x04:  # DecoderConfig: objtype(1)+stream(1)+buf(3)+rates(8)
            pos += 13
        elif tag == 0x05:  # DecoderSpecificInfo = AudioSpecificConfig
            asc = esds[pos : pos + size]
            obj = asc[0] >> 3
            sr_index = ((asc[0] & 7) << 1) | (asc[1] >> 7)
            channels = (asc[1] >> 3) & 0xF
            return obj, sr_index, channels
        else:
            pos += size
    raise Mp4DemuxError("AudioSpecificConfig not found")


def _sample_tables(data: bytes, stbl) -> tuple[list[int], list[int]]:
    stsz = _find(data, *stbl, b"stsz")
    stsc = _find(data, *stbl, b"stsc")
    stco = _find(data, *stbl, b"stco")
    co64 = _find(data, *stbl, b"co64")
    if stsz is None or stsc is None or (stco is None and co64 is None):
        raise Mp4DemuxError("missing sample tables")

    p = stsz[0]
    sample_size, count = struct.unpack_from(">II", data, p + 4)
    if sample_size:
        sizes = [sample_size] * count
    else:
        sizes = list(struct.unpack_from(f">{count}I", data, p + 12))

    p = stsc[0]
    n_stsc = struct.unpack_from(">I", data, p + 4)[0]
    stsc_entries = [
        struct.unpack_from(">III", data, p + 8 + 12 * i) for i in range(n_stsc)
    ]

    if stco is not None:
        p = stco[0]
        n_chunks = struct.unpack_from(">I", data, p + 4)[0]
        chunk_offsets = list(struct.unpack_from(f">{n_chunks}I", data, p + 8))
    else:
        p = co64[0]
        n_chunks = struct.unpack_from(">I", data, p + 4)[0]
        chunk_offsets = list(struct.unpack_from(f">{n_chunks}Q", data, p + 8))

    # Expand stsc runs into per-sample offsets.
    offsets = []
    si = 0
    for run_idx, (first_chunk, samples_per_chunk, _) in enumerate(stsc_entries):
        last_chunk = (
            stsc_entries[run_idx + 1][0] - 1
            if run_idx + 1 < len(stsc_entries)
            else len(chunk_offsets)
        )
        for chunk in range(first_chunk, last_chunk + 1):
            if chunk - 1 >= len(chunk_offsets):
                break
            off = chunk_offsets[chunk - 1]
            for _ in range(samples_per_chunk):
                if si >= len(sizes):
                    break
                offsets.append(off)
                off += sizes[si]
                si += 1
    return sizes[: len(offsets)], offsets


def _build_adts(data: bytes, sizes, offsets, asc) -> bytes:
    obj, sr_index, channels = asc
    out = bytearray()
    for size, off in zip(sizes, offsets):
        if off + size > len(data):
            break
        full = size + 7
        h = bytearray(7)
        h[0] = 0xFF
        h[1] = 0xF1
        h[2] = ((obj - 1) << 6) | (sr_index << 2) | ((channels >> 2) & 1)
        h[3] = ((channels & 3) << 6) | ((full >> 11) & 0x3)
        h[4] = (full >> 3) & 0xFF
        h[5] = ((full & 7) << 5) | 0x1F
        h[6] = 0xFC
        out += h
        out += data[off : off + size]
    return bytes(out)


def _file_adts(path, track_index):
    with open(path, "rb") as f:
        data = f.read()
    if data[4:8] == b"ftyp":
        data = mp4_to_adts(data, track_index=track_index)
    elif track_index not in (None, 0):
        # Raw ADTS streams carry exactly one audio track.
        raise Mp4DemuxError(
            f"Track index {track_index} out of range (file has 1 audio track(s))"
        )
    return data


def unpack_file(path, track_index: int | None = None,
                f16: bool = False) -> UnpackedAac:
    return unpack_adts(_file_adts(path, track_index), f16=f16)


def unpack_file_q(path, track_index: int | None = None) -> UnpackedAacQ:
    return unpack_adts_q(_file_adts(path, track_index))
