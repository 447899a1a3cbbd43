"""AAC test oracle + fixture encoder via the system libavcodec (ctypes).

Test-only utility (the port's own AAC path is the native C++ front-end
plus the device route). libavcodec ships as a bare shared object (no
headers), so this module uses the stable public C API plus the
long-stable layouts of AVPacket/AVFrame, and discovers the few needed
AVCodecContext field offsets empirically through the AVOption API.

A copy of the JAX package's mp3rgain_tpu/testing/avcodec.py whose three
libraries are opened and declared on first use (_load), not at import;
every function and class is the original's. tests/test_torch_host_copies.py
holds the two to the same code, the same decoded arrays and the same
encoded bytes.
"""

from __future__ import annotations

import ctypes
import struct
from functools import lru_cache

import numpy as np

from .lazylib import LazyLibrary


@lru_cache(maxsize=None)
def _load():
    _avu = ctypes.CDLL("libavutil.so.57", mode=ctypes.RTLD_GLOBAL)
    _swr = ctypes.CDLL("libswresample.so.4", mode=ctypes.RTLD_GLOBAL)
    _avc = ctypes.CDLL("libavcodec.so.59", mode=ctypes.RTLD_GLOBAL)

    for name, restype, argtypes in [
        ("avcodec_find_decoder", ctypes.c_void_p, [ctypes.c_int]),
        ("avcodec_find_encoder", ctypes.c_void_p, [ctypes.c_int]),
        ("avcodec_alloc_context3", ctypes.c_void_p, [ctypes.c_void_p]),
        ("avcodec_open2", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
        ("avcodec_send_packet", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        ("avcodec_receive_frame", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        ("avcodec_send_frame", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        ("avcodec_receive_packet", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        ("av_packet_alloc", ctypes.c_void_p, []),
        ("av_new_packet", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
        ("av_packet_unref", None, [ctypes.c_void_p]),
        ("av_frame_alloc", ctypes.c_void_p, []),
        ("av_frame_unref", None, [ctypes.c_void_p]),
        ("av_frame_get_buffer", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
    ]:
        fn = getattr(_avc if name.startswith("avcodec") else _avu, name, None) or getattr(_avc, name)
        fn.restype = restype
        fn.argtypes = argtypes

    _avu.av_opt_set.restype = ctypes.c_int
    _avu.av_opt_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    return _avu, _swr, _avc


_avu = LazyLibrary(lambda: _load()[0])
_swr = LazyLibrary(lambda: _load()[1])
_avc = LazyLibrary(lambda: _load()[2])

AV_CODEC_ID_AAC = 86018
AV_SAMPLE_FMT_FLTP = 8
AV_SAMPLE_FMT_FLT = 3

# AVPacket field offsets (stable since ffmpeg 4.x):
#   AVBufferRef* buf @0, int64 pts @8, int64 dts @16, uint8* data @24,
#   int size @32, int stream_index @36.
_PKT_DATA = 24
_PKT_SIZE = 32

# AVFrame field offsets (stable since ffmpeg 4.x):
#   uint8* data[8] @0, int linesize[8] @64, uint8** extended_data @96,
#   width @104, height @108, nb_samples @112, format @116.
_FRM_DATA = 0
_FRM_EXT_DATA = 96
_FRM_NB_SAMPLES = 112
_FRM_FORMAT = 116

AV_OPT_SEARCH_CHILDREN = 1


def _read_i32(ptr, off):
    return struct.unpack_from("<i", ctypes.string_at(ptr + off, 4))[0]


def _read_ptr(ptr, off):
    return struct.unpack_from("<Q", ctypes.string_at(ptr + off, 8))[0]


class _CtxOffsets:
    """Empirically discovered AVCodecContext offsets for this build."""

    _cached = None

    @classmethod
    def get(cls):
        if cls._cached is not None:
            return cls._cached
        codec = _avc.avcodec_find_encoder(AV_CODEC_ID_AAC)
        ctx = _avc.avcodec_alloc_context3(codec)
        # Set distinctive values through AVOptions and scan for them.
        _avu.av_opt_set(ctx, b"ar", b"39313", AV_OPT_SEARCH_CHILDREN)
        _avu.av_opt_set(ctx, b"ac", b"7", AV_OPT_SEARCH_CHILDREN)
        _avu.av_opt_set(ctx, b"b", b"191001", AV_OPT_SEARCH_CHILDREN)
        blob = ctypes.string_at(ctx, 2048)
        sr_off = blob.find(struct.pack("<i", 39313))
        ch_off = blob.find(struct.pack("<i", 7))
        assert sr_off > 0 and ch_off > 0, "AVCodecContext offset discovery failed"
        # sample_fmt sits in the audio block near sample_rate; find the
        # AV_SAMPLE_FMT_NONE (-1) int closest after sample_rate.
        fmt_off = None
        for off in range(sr_off, sr_off + 64, 4):
            if struct.unpack_from("<i", blob, off)[0] == -1:
                fmt_off = off
                break
        assert fmt_off is not None, "sample_fmt offset not found"
        cls._cached = {"sample_rate": sr_off, "channels": ch_off, "sample_fmt": fmt_off}
        return cls._cached


def _write_i32(ptr, off, value):
    ctypes.memmove(ptr + off, struct.pack("<i", value), 4)


_FRM_CHLAYOUT = None


def _frame_chlayout_offset() -> int:
    """Find AVFrame.ch_layout by probing av_frame_get_buffer: with
    nb_samples/format set, the call succeeds only once a valid
    AVChannelLayout {order=NATIVE, nb=2, mask=3} sits at the right spot."""
    global _FRM_CHLAYOUT
    if _FRM_CHLAYOUT is not None:
        return _FRM_CHLAYOUT
    probe = struct.pack("<iiQ", 1, 2, 3)  # native order, 2 ch, stereo mask
    for off in range(120, 760, 4):
        frame = _avu.av_frame_alloc()
        _write_i32(frame, _FRM_NB_SAMPLES, 256)
        _write_i32(frame, _FRM_FORMAT, AV_SAMPLE_FMT_FLTP)
        ctypes.memmove(frame + off, probe, len(probe))
        rc = _avu.av_frame_get_buffer(frame, 0)
        ok = rc == 0 and _read_ptr(frame, _FRM_DATA) != 0 and _read_ptr(frame, _FRM_DATA + 8) != 0
        if ok:
            _FRM_CHLAYOUT = off
            return off
    raise RuntimeError("AVFrame.ch_layout offset not found")


def encode_adts(pcm: np.ndarray, sample_rate: int, bitrate: int = 128000) -> bytes:
    """Encode float PCM (n, channels) to an ADTS .aac byte stream using the
    native ffmpeg AAC-LC encoder."""
    pcm = np.asarray(pcm, dtype=np.float32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, channels = pcm.shape

    codec = _avc.avcodec_find_encoder(AV_CODEC_ID_AAC)
    assert codec, "ffmpeg AAC encoder not found"
    ctx = _avc.avcodec_alloc_context3(codec)
    offs = _CtxOffsets.get()
    _avu.av_opt_set(ctx, b"ar", str(sample_rate).encode(), AV_OPT_SEARCH_CHILDREN)
    layout = b"mono" if channels == 1 else b"stereo"
    rc = _avu.av_opt_set(ctx, b"ch_layout", layout, AV_OPT_SEARCH_CHILDREN)
    if rc != 0:  # older option name
        _avu.av_opt_set(ctx, b"channel_layout", layout, AV_OPT_SEARCH_CHILDREN)
        _avu.av_opt_set(ctx, b"ac", str(channels).encode(), AV_OPT_SEARCH_CHILDREN)
    _avu.av_opt_set(ctx, b"b", str(bitrate).encode(), AV_OPT_SEARCH_CHILDREN)
    _write_i32(ctx, offs["sample_fmt"], AV_SAMPLE_FMT_FLTP)
    rc = _avc.avcodec_open2(ctx, codec, None)
    assert rc == 0, f"encoder open failed: {rc}"

    frame = _avu.av_frame_alloc()
    pkt = _avc.av_packet_alloc()
    out = bytearray()
    frame_len = 1024

    def drain():
        while True:
            rc = _avc.avcodec_receive_packet(ctx, pkt)
            if rc != 0:
                break
            data = _read_ptr(pkt, _PKT_DATA)
            size = _read_i32(pkt, _PKT_SIZE)
            raw = ctypes.string_at(data, size)
            out.extend(_adts_header(len(raw), sample_rate, channels))
            out.extend(raw)
            _avc.av_packet_unref(pkt)

    for start in range(0, n, frame_len):
        chunk = pcm[start : start + frame_len]
        if chunk.shape[0] < frame_len:
            chunk = np.pad(chunk, ((0, frame_len - chunk.shape[0]), (0, 0)))
        _avu.av_frame_unref(frame)
        _write_i32(frame, _FRM_NB_SAMPLES, frame_len)
        _write_i32(frame, _FRM_FORMAT, AV_SAMPLE_FMT_FLTP)
        ch_off = _frame_chlayout_offset()
        mask = 4 if channels == 1 else 3
        ctypes.memmove(frame + ch_off, struct.pack("<iiQ", 1, channels, mask), 16)
        rc = _avu.av_frame_get_buffer(frame, 0)
        assert rc == 0, f"frame buffer alloc failed: {rc}"
        ext = _read_ptr(frame, _FRM_EXT_DATA)
        for c in range(channels):
            arr = np.ascontiguousarray(chunk[:, c])
            dst = struct.unpack_from("<Q", ctypes.string_at(ext + 8 * c, 8))[0]
            ctypes.memmove(dst, arr.ctypes.data, frame_len * 4)
        rc = _avc.avcodec_send_frame(ctx, frame)
        if rc != 0:
            raise RuntimeError(f"send_frame failed: {rc}")
        drain()
    _avc.avcodec_send_frame(ctx, None)  # flush
    drain()
    return bytes(out)


_ADTS_SR_INDEX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
                  24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}


def _adts_header(payload_len: int, sample_rate: int, channels: int) -> bytes:
    full = payload_len + 7
    sr = _ADTS_SR_INDEX[sample_rate]
    profile = 1  # AAC-LC = object type 2 - 1
    h = bytearray(7)
    h[0] = 0xFF
    h[1] = 0xF1  # MPEG-4, no CRC
    h[2] = (profile << 6) | (sr << 2) | ((channels >> 2) & 1)
    h[3] = ((channels & 3) << 6) | ((full >> 11) & 0x3)
    h[4] = (full >> 3) & 0xFF
    h[5] = ((full & 7) << 5) | 0x1F
    h[6] = 0xFC
    return bytes(h)


def decode_adts(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an ADTS .aac stream to float PCM (n, channels) + sample rate.

    Golden oracle for validating the framework's own AAC decode path."""
    codec = _avc.avcodec_find_decoder(AV_CODEC_ID_AAC)
    assert codec, "ffmpeg AAC decoder not found"
    ctx = _avc.avcodec_alloc_context3(codec)
    rc = _avc.avcodec_open2(ctx, codec, None)
    assert rc == 0

    frame = _avu.av_frame_alloc()
    pkt = _avc.av_packet_alloc()
    chunks = []
    channels = None
    offs = _CtxOffsets.get()

    pos = 0
    while pos + 7 <= len(data):
        if data[pos] != 0xFF or (data[pos + 1] & 0xF0) != 0xF0:
            pos += 1
            continue
        full = ((data[pos + 3] & 0x3) << 11) | (data[pos + 4] << 3) | (data[pos + 5] >> 5)
        if full < 7 or pos + full > len(data):
            break
        packet = data[pos : pos + full]
        pos += full
        rc = _avc.av_new_packet(pkt, len(packet))
        assert rc == 0
        ctypes.memmove(_read_ptr(pkt, _PKT_DATA), packet, len(packet))
        rc = _avc.avcodec_send_packet(ctx, pkt)
        _avc.av_packet_unref(pkt)
        if rc != 0:
            continue
        while _avc.avcodec_receive_frame(ctx, frame) == 0:
            nb = _read_i32(frame, _FRM_NB_SAMPLES)
            fmt = _read_i32(frame, _FRM_FORMAT)
            if channels is None:
                channels = _read_i32(ctx, offs["channels"])
            assert fmt == AV_SAMPLE_FMT_FLTP, fmt
            ext = _read_ptr(frame, _FRM_EXT_DATA)
            chans = []
            for c in range(channels):
                p = struct.unpack_from("<Q", ctypes.string_at(ext + 8 * c, 8))[0]
                chans.append(np.frombuffer(ctypes.string_at(p, nb * 4), dtype=np.float32))
            chunks.append(np.stack(chans, axis=1))
            _avu.av_frame_unref(frame)

    sr = _read_i32(ctx, offs["sample_rate"])
    if not chunks:
        return np.zeros((0, 1), np.float32), sr
    return np.concatenate(chunks, axis=0), sr
