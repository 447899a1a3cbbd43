"""The torch port's copy of mp3rgain_tpu/decode/frontend.py, bound to the
port's native.py (whose loader declares the entry points, so nothing
here builds or loads the library at import), held equal to it by
tests/test_torch_host_copies.py. Its last section, the light walk into a
main-data stream (unpack_data_light_stream), is the port's own.

Python wrapper for the native MP3 decode front-end.

Produces the host→device manifest: dense per-granule-channel tensors
(side-info fields, scalefactors, Huffman-decoded spectra) ready for the
JAX decode back-end.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ..native import _inbuf, _lib, _u8p

# Info field indices (keep in sync with _native/mp3dec.cpp).
FRAME = 0
GRANULE = 1
CHANNEL = 2
GLOBAL_GAIN = 3
SCALEFAC_SCALE = 4
PREFLAG = 5
BLOCK_TYPE = 6
MIXED = 7
SBG0 = 8
SBG1 = 9
SBG2 = 10
VERSION = 11
SR_ROW = 12
CHANNEL_MODE = 13
MODE_EXT = 14
SAMPLE_RATE = 15
BIG_END = 16
COUNT1_END = 17
VALID = 18
INTENSITY_SCALE = 19
NCHANNELS = 20
INFO_N = 24

SCF_SLOTS = 64
SCF_LONG = 0  # slots 0..22
SCF_SHORT = 23  # slots 23..61, sfb-major (sfb * 3 + window)

# ---------------------------------------------------------------------------
# Packed transfer form of the device-read info fields (light path).
#
# The analysis tail reads only ~30 bits of the 24-column info tensor per
# granule-channel; under the host→device bandwidth bottleneck the batch
# arrays ship those bits packed into TWO uint16 words (28 MB → 2.4 MB on
# a 64×60 s batch). Layout (keep pack_info_light and the device-side
# unpack in parallel.runner in sync):
#   word 0: global_gain[0:8] | block_type[8:10] | mixed[10] |
#           scalefac_scale[11] | preflag[12] | intensity_scale[13] |
#           joint (channel_mode==1)[14] | lsf (version!=1)[15]
#   word 1: sbg0[0:3] | sbg1[3:6] | sbg2[6:9] | mode_ext[9:11] |
#           sr_row[11:15]
# BIG_END/COUNT1_END are zero in the light manifest (set on device from
# the entropy kernel's outputs); FRAME/GRANULE/CHANNEL/SAMPLE_RATE/
# NCHANNELS/VALID are host-only fields and do not travel.
# ---------------------------------------------------------------------------
IP_N = 2


def pack_info_light(info: np.ndarray) -> np.ndarray:
    """Pack (n, INFO_N) int32 info rows into (n, IP_N) uint16 words."""
    gg = info[:, GLOBAL_GAIN] & 255
    w0 = (
        gg
        | ((info[:, BLOCK_TYPE] & 3) << 8)
        | ((info[:, MIXED] & 1) << 10)
        | ((info[:, SCALEFAC_SCALE] & 1) << 11)
        | ((info[:, PREFLAG] & 1) << 12)
        | ((info[:, INTENSITY_SCALE] & 1) << 13)
        | ((info[:, CHANNEL_MODE] == 1).astype(np.int32) << 14)
        | ((info[:, VERSION] != 1).astype(np.int32) << 15)
    )
    w1 = (
        (info[:, SBG0] & 7)
        | ((info[:, SBG1] & 7) << 3)
        | ((info[:, SBG2] & 7) << 6)
        | ((info[:, MODE_EXT] & 3) << 9)
        | ((info[:, SR_ROW] & 15) << 11)
    )
    return np.stack([w0, w1], axis=1).astype(np.uint16)


# Split scalefactor transfer form (light path, MPEG-1 AND LSF): long-
# block scalefactors occupy slots 0..22 only (SCF_LONG layout above),
# so the dense per-gch payload carries just slots 0..23 as low nibbles
# (12 bytes instead of 64); the short-window slots 24..63 — nonzero
# only for block_type 2 granules, a small minority of real content —
# travel as a sparse sideband of (flat row index, 20 packed bytes).
# Slot values >= 16 (reachable only through the LSF intensity-channel
# sf < 360 case, where slen is 5 bits — everything else in both
# MPEG-1 and LSF fits a nibble) set a bit in a second, rarer sideband
# of 8-byte row bitmasks (bit s%8 of byte s//8 adds 16 to slot s).
# Device expansion: parallel.runner._expand_scf_flat.
SCF_MAIN_BYTES = 12
SCF_SIDE_BYTES = 20
SCF_HI_BYTES = 8


def pack_scf_rows(scf: np.ndarray):
    """(n, 64) int scalefactor slots → flat split transfer form.

    Returns (main (n, 12) uint8 low nibbles of slots 0..23,
    srows (k,) int32, sdata (k, 20) uint8 low nibbles of slots 24..63,
    hrows (m,) int32, hmask (m, 8) uint8 bit-4 row bitmasks)."""
    if scf.size and int(scf.max()) > 31:
        raise ValueError("scalefactor slot exceeds 5 bits")
    lo = (scf & 15).astype(np.uint8)
    sc = lo[:, :24]
    main = (sc[:, 0::2] << 4) | sc[:, 1::2]
    short = lo[:, 24:]
    srows = np.nonzero(short.any(axis=1))[0].astype(np.int32)
    hr = short[srows]
    sdata = (hr[:, 0::2] << 4) | hr[:, 1::2]
    hb = scf >= 16
    hrows = np.nonzero(hb.any(axis=1))[0].astype(np.int32)
    bits = hb[hrows].reshape(-1, SCF_HI_BYTES, 8).astype(np.uint8)
    hmask = (bits << np.arange(8, dtype=np.uint8)).sum(
        axis=2, dtype=np.uint8
    )
    return main, srows, sdata, hrows, hmask


@dataclass
class UnpackedMp3:
    """Dense granule-channel tensors for the device decode back-end.

    n = number of granule-channel records, ordered (frame, granule, channel).
    """

    info: np.ndarray  # (n, INFO_N) int32
    scf: np.ndarray  # (n, 64) int32
    spectrum: np.ndarray  # (n, 576) int32

    @property
    def n(self) -> int:
        return self.info.shape[0]

    @property
    def sample_rate(self) -> int:
        return int(self.info[0, SAMPLE_RATE]) if self.n else 0

    @property
    def n_channels(self) -> int:
        return int(self.info[0, NCHANNELS]) if self.n else 0


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def unpack_data(data: bytes) -> UnpackedMp3:
    cap = max(64, len(data) // 40)
    while True:
        # np.empty is safe: the native stage fully writes every record <= n.
        info = np.empty((cap, INFO_N), dtype=np.int32)
        scf = np.empty((cap, SCF_SLOTS), dtype=np.int32)
        spectrum = np.empty((cap, 576), dtype=np.int32)
        n = _lib.mg_mp3_unpack(
            _inbuf(data), len(data), _i32p(info), _i32p(scf), _i32p(spectrum), cap
        )
        if n <= cap:
            return UnpackedMp3(info=info[:n], scf=scf[:n], spectrum=spectrum[:n])
        cap = int(n)


def unpack_file(path) -> UnpackedMp3:
    with open(path, "rb") as f:
        return unpack_data(f.read())


# ---------------------------------------------------------------------------
# Light unpack: host does byte walk + side info + scalefactors only; the
# Huffman spectral decode runs on device (decode/entropy_kernel.py).
# ---------------------------------------------------------------------------

# Meta field indices (keep in sync with _native/mp3dec.cpp LM_*).
LM_P0 = 0
LM_P23 = 1
LM_BVP = 2
LM_R0P = 3
LM_R1P = 4
LM_G0 = 5
LM_G1 = 6
LM_G2 = 7
LM_L0 = 8
LM_L1 = 9
LM_L2 = 10
LM_GCNT = 11
LIGHT_META_N = 12

# Max bytes per gch window: 4095 part3 bits + 7 lead bits + 8 pad bytes.
MD_STRIDE = 528


@dataclass
class UnpackedMp3Light:
    """Raw-bits manifest: per-gch Huffman windows + decode metadata.

    The spectral decode happens on device, so the host→device payload is
    the raw main-data bytes (~4x smaller than decoded int16 spectra).
    """

    info: np.ndarray  # (n, INFO_N) int32 (BIG_END/COUNT1_END zero)
    scf: np.ndarray  # (n, 64) int32
    md: np.ndarray  # (n, MD_STRIDE) uint8 Huffman windows
    meta: np.ndarray  # (n, LIGHT_META_N) int32

    @property
    def n(self) -> int:
        return self.info.shape[0]

    @property
    def sample_rate(self) -> int:
        return int(self.info[0, SAMPLE_RATE]) if self.n else 0

    @property
    def n_channels(self) -> int:
        return int(self.info[0, NCHANNELS]) if self.n else 0


@dataclass
class UnpackedMp3LightPacked:
    """Raw-bits manifest in the TRANSFER form: the batch prep copies
    these rows into the device payload verbatim (no per-track repack).
    Emitting this form straight from the native walk cuts the walk's
    write traffic ~4x vs the dense int32 info/scf rows — the light walk
    is write-bound (measured ~3 ms -> ~1.5 ms per 60 s track).

    Duck-compatible with UnpackedMp3Light where the batch/scan paths
    care: n, sample_rate, n_channels, md, meta."""

    ip: np.ndarray  # (n, IP_N) uint16 packed info words
    scf_main: np.ndarray  # (n, SCF_MAIN_BYTES) uint8 low nibbles
    srows: np.ndarray  # (ns,) int32 track-local short-window rows
    sdata: np.ndarray  # (ns, SCF_SIDE_BYTES) uint8
    hrows: np.ndarray  # (nh,) int32 track-local high-bit rows
    hmask: np.ndarray  # (nh, SCF_HI_BYTES) uint8
    md: np.ndarray  # (n, MD_STRIDE) uint8 Huffman windows
    meta: np.ndarray  # (n, LIGHT_META_N) int32
    sample_rate: int
    n_channels: int

    @property
    def n(self) -> int:
        return self.ip.shape[0]


def unpack_data_light_packed(data: bytes) -> UnpackedMp3LightPacked:
    """Native light walk emitting the transfer-packed manifest directly
    (mg_mp3_unpack_light2); bit-identical to pack_info_light +
    pack_scf_rows over unpack_data_light's dense output.

    Buffers are EXACT-size via a native count pre-pass
    (mg_mp3_count_gch, same frame-acceptance walk): the len/40
    worst-case guess over-allocated ~4x on typical content, and a
    64-track scan wave of those fresh multi-MB mmaps was the dominant
    walk cost on page-fault-slow hosts."""
    cap = max(1, int(_lib.mg_mp3_count_gch(_inbuf(data), len(data))))
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ip = np.empty((cap, IP_N), dtype=np.uint16)
    scf_main = np.empty((cap, SCF_MAIN_BYTES), dtype=np.uint8)
    srows = np.empty(cap, dtype=np.int32)
    sdata = np.empty((cap, SCF_SIDE_BYTES), dtype=np.uint8)
    hrows = np.empty(cap, dtype=np.int32)
    hmask = np.empty((cap, SCF_HI_BYTES), dtype=np.uint8)
    md = np.empty((cap, MD_STRIDE), dtype=np.uint8)
    meta = np.empty((cap, LIGHT_META_N), dtype=np.int32)
    hdr = np.zeros(4, dtype=np.int32)
    n = _lib.mg_mp3_unpack_light2(
        _inbuf(data), len(data),
        ip.ctypes.data_as(u16p), scf_main.ctypes.data_as(_u8p),
        srows.ctypes.data_as(i32p), sdata.ctypes.data_as(_u8p),
        hrows.ctypes.data_as(i32p), hmask.ctypes.data_as(_u8p),
        md.ctypes.data_as(_u8p), MD_STRIDE,
        meta.ctypes.data_as(i32p), cap, hdr.ctypes.data_as(i32p),
    )
    assert n <= cap, (n, cap)  # count walks the same acceptance logic
    ns, nh = int(hdr[2]), int(hdr[3])
    return UnpackedMp3LightPacked(
        ip=ip[:n], scf_main=scf_main[:n],
        srows=srows[:ns].copy(), sdata=sdata[:ns].copy(),
        hrows=hrows[:nh].copy(), hmask=hmask[:nh].copy(),
        md=md[:n], meta=meta[:n],
        sample_rate=int(hdr[0]), n_channels=int(hdr[1]),
    )


def unpack_data_light(data: bytes) -> UnpackedMp3Light:
    cap = max(64, len(data) // 40)
    while True:
        info = np.empty((cap, INFO_N), dtype=np.int32)
        scf = np.empty((cap, SCF_SLOTS), dtype=np.int32)
        md = np.empty((cap, MD_STRIDE), dtype=np.uint8)
        meta = np.empty((cap, LIGHT_META_N), dtype=np.int32)
        n = _lib.mg_mp3_unpack_light(
            _inbuf(data), len(data), _i32p(info), _i32p(scf),
            md.ctypes.data_as(_u8p), MD_STRIDE, _i32p(meta), cap,
        )
        if n <= cap:
            return UnpackedMp3Light(
                info=info[:n], scf=scf[:n], md=md[:n], meta=meta[:n]
            )
        cap = int(n)


def unpack_file_light(path) -> UnpackedMp3Light:
    with open(path, "rb") as f:
        return unpack_data_light(f.read())


# ---------------------------------------------------------------------------
# The port's own: the light walk into a main-data stream (_host/light_walk.cpp,
# built by light_walk.py), the light route's walk. The packed walk above
# copies each row's Huffman window into MD_STRIDE bytes, of which typical
# content fills a quarter; this one writes the track's main data once and
# gives each row's window as a byte range of it.
# ---------------------------------------------------------------------------

# Zero bytes after a stream's main data (at least 16: the rows the packed
# walk zeroes point here).
STREAM_TAIL = 16


@dataclass
class MdWindows:
    """Each row's Huffman window as a byte range of its track's main-data
    stream: the rows of the packed form's md without the rows. Row i's md
    row holds stream[off[i] : off[i] + count[i]] and zeros after it. Slices
    share the stream (a segment's rows). Admission counts it as the rows it
    stands for (nbytes), so batches are cut as for the packed form."""

    stream: np.ndarray  # (main-data bytes + STREAM_TAIL,) uint8
    off: np.ndarray  # (n,) int64 each window's first byte in stream
    count: np.ndarray  # (n,) uint16 its bytes before the md row's zeros

    def __getitem__(self, rows: slice) -> MdWindows:
        return MdWindows(self.stream, self.off[rows], self.count[rows])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.off.shape[0], MD_STRIDE)

    @property
    def nbytes(self) -> int:
        return self.off.shape[0] * MD_STRIDE

    @property
    def emitted_bytes(self) -> int:
        """What the walk wrote for it: the stream, the offsets, the counts."""
        return self.stream.nbytes + self.off.nbytes + self.count.nbytes


@dataclass
class UnpackedMp3LightStream:
    """UnpackedMp3LightPacked with md as MdWindows: the same rows, fields
    and shapes, each track's main data held once."""

    ip: np.ndarray  # (n, IP_N) uint16 packed info words
    scf_main: np.ndarray  # (n, SCF_MAIN_BYTES) uint8 low nibbles
    srows: np.ndarray  # (ns,) int32 track-local short-window rows
    sdata: np.ndarray  # (ns, SCF_SIDE_BYTES) uint8
    hrows: np.ndarray  # (nh,) int32 track-local high-bit rows
    hmask: np.ndarray  # (nh, SCF_HI_BYTES) uint8
    md: MdWindows
    meta: np.ndarray  # (n, LIGHT_META_N) int32
    sample_rate: int
    n_channels: int

    @property
    def n(self) -> int:
        return self.ip.shape[0]


def unpack_data_light_stream(data: bytes) -> UnpackedMp3LightStream:
    """The light walk into a main-data stream (mg_light_stream_walk): the
    same rows as unpack_data_light_packed (ip, scf_main, the sidebands,
    meta, sample rate and channels byte for byte), with each row's md row
    as a byte range of the track's main data, which an exact count
    pre-pass (mg_light_stream_count) sizes. Counts what it emitted in the
    walk.md_bytes counter."""
    from .. import tracing
    from ..light_walk import _lib as walk_lib

    buf = _inbuf(data)
    md_bytes = ctypes.c_int64()
    cap = max(1, int(walk_lib.mg_light_stream_count(buf, len(data), ctypes.byref(md_bytes))))
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ip = np.empty((cap, IP_N), dtype=np.uint16)
    scf_main = np.empty((cap, SCF_MAIN_BYTES), dtype=np.uint8)
    srows = np.empty(cap, dtype=np.int32)
    sdata = np.empty((cap, SCF_SIDE_BYTES), dtype=np.uint8)
    hrows = np.empty(cap, dtype=np.int32)
    hmask = np.empty((cap, SCF_HI_BYTES), dtype=np.uint8)
    meta = np.empty((cap, LIGHT_META_N), dtype=np.int32)
    stream = np.empty(md_bytes.value + STREAM_TAIL, dtype=np.uint8)
    off = np.empty(cap, dtype=np.int64)
    count = np.empty(cap, dtype=np.uint16)
    hdr = np.zeros(4, dtype=np.int32)
    n = walk_lib.mg_light_stream_walk(
        buf, len(data),
        ip.ctypes.data_as(u16p), scf_main.ctypes.data_as(_u8p),
        srows.ctypes.data_as(i32p), sdata.ctypes.data_as(_u8p),
        hrows.ctypes.data_as(i32p), hmask.ctypes.data_as(_u8p),
        meta.ctypes.data_as(i32p), stream.ctypes.data_as(_u8p),
        md_bytes.value, stream.shape[0],
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count.ctypes.data_as(u16p),
        cap, hdr.ctypes.data_as(i32p),
    )
    if not 0 <= n <= cap:  # the count walks the same frames: never, unless it is broken
        raise RuntimeError(f"light stream walk: {n} rows against a count of {cap}")
    ns, nh = int(hdr[2]), int(hdr[3])
    md = MdWindows(stream, off[:n], count[:n])
    tracing.count("walk.md_bytes", md.emitted_bytes)
    return UnpackedMp3LightStream(
        ip=ip[:n], scf_main=scf_main[:n],
        srows=srows[:ns].copy(), sdata=sdata[:ns].copy(),
        hrows=hrows[:nh].copy(), hmask=hmask[:nh].copy(),
        md=md, meta=meta[:n],
        sample_rate=int(hdr[0]), n_channels=int(hdr[1]),
    )
