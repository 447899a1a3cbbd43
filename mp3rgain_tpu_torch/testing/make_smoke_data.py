"""Generate the MP3 and AAC inputs that chip_smoke.py reads.

The machine that runs chip_smoke.py on the GPU has no MP3 or AAC encoder,
so its inputs are committed under mp3rgain_tpu_torch/testing/data/. This
script regenerates them with libmp3lame, through encode_mp3 below (a copy
of the JAX package's mp3rgain_tpu/testing/fixtures.py::encode_mp3), and
with libavcodec's AAC-LC encoder, through encode_adts, encode_m4a and
encode_m4a_multi below (copies of mp3rgain_tpu/testing/avcodec.py's and
fixtures.py's, loading the libraries on first use), all held
byte-identical to the originals by tests/test_torch_host_copies.py,
deterministically from fixed seeds:

  bench_60s_44k_joint_192k.mp3  the bench.py track: 60 s, 44.1 kHz joint
                                stereo, 192 kbps (440 Hz + 1870 Hz tones
                                plus noise, seed 7)
  mono_3s_22k_48k.mp3           3 s, 22.05 kHz mono MPEG-2, 48 kbps
  transient_3s_44k_128k.mp3     3 s, 44.1 kHz stereo, 128 kbps, decaying
                                3 kHz bursts that force short blocks
  bench_60s_44k_192k.m4a        bench.py's AAC track: 60 s, 44.1 kHz
                                stereo, 192 kbps AAC-LC in MP4 (523 Hz +
                                2093 Hz tones plus noise, seed 11)
  transient_3s_44k_128k.m4a     the transient signal above as 128 kbps
                                AAC: EIGHT_SHORT windows, so host-decoded
                                fallback rows and the short IMDCT
  pns_4s_44k_96k.m4a            4 s, 44.1 kHz stereo, 96 kbps: a tone
                                over noise, coded with perceptual noise
                                substitution bands
  mono_3s_22k_48k.aac           3 s, 22.05 kHz mono, 48 kbps, a raw ADTS
                                stream
  two_tracks_3s.m4a             one MP4 with two audio tracks (a 44.1 kHz
                                stereo tone and a 32 kHz mono tone) for
                                track selection

Run: python -m mp3rgain_tpu_torch.testing.make_smoke_data
"""

from __future__ import annotations

import ctypes
import os
import struct
from functools import lru_cache

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

BENCH_TRACK = "bench_60s_44k_joint_192k.mp3"
MONO_TRACK = "mono_3s_22k_48k.mp3"
TRANSIENT_TRACK = "transient_3s_44k_128k.mp3"
AAC_BENCH_TRACK = "bench_60s_44k_192k.m4a"
AAC_TRANSIENT_TRACK = "transient_3s_44k_128k.m4a"
AAC_PNS_TRACK = "pns_4s_44k_96k.m4a"
AAC_ADTS_TRACK = "mono_3s_22k_48k.aac"
AAC_TWO_TRACKS = "two_tracks_3s.m4a"

# LAME MPEG_mode and vbr_mode values.
MODE_STEREO = 0
MODE_JOINT = 1
MODE_MONO = 3
VBR_OFF = 0
VBR_DEFAULT = 4


@lru_cache(maxsize=None)
def _lame() -> ctypes.CDLL:
    """libmp3lame with the signatures encode_mp3 calls, loaded on first
    use (the GPU machine that reads the committed clips has none)."""
    lame = ctypes.CDLL("libmp3lame.so.0")
    lame.lame_init.restype = ctypes.c_void_p
    for name in ("lame_set_in_samplerate", "lame_set_out_samplerate",
                 "lame_set_num_channels", "lame_set_brate", "lame_set_mode",
                 "lame_set_VBR", "lame_set_VBR_q", "lame_set_quality",
                 "lame_set_bWriteVbrTag"):
        fn = getattr(lame, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    ubp = ctypes.POINTER(ctypes.c_ubyte)
    shp = ctypes.POINTER(ctypes.c_short)
    for name, restype, argtypes in (
        ("lame_init_params", ctypes.c_int, [ctypes.c_void_p]),
        ("lame_encode_buffer", ctypes.c_int,
         [ctypes.c_void_p, shp, shp, ctypes.c_int, ubp, ctypes.c_int]),
        ("lame_encode_flush", ctypes.c_int, [ctypes.c_void_p, ubp, ctypes.c_int]),
        ("lame_get_lametag_frame", ctypes.c_size_t,
         [ctypes.c_void_p, ubp, ctypes.c_size_t]),
        ("lame_close", ctypes.c_int, [ctypes.c_void_p]),
    ):
        fn = getattr(lame, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lame


def encode_mp3(
    pcm: np.ndarray,
    sample_rate: int,
    bitrate: int = 128,
    mode: int = MODE_STEREO,
    vbr: bool = False,
    vbr_quality: int = 4,
    write_vbr_tag: bool = True,
) -> bytes:
    """Encode int16 PCM (shape (n,) mono or (n, 2) stereo) to an MP3 buffer.

    When write_vbr_tag is set, the leading placeholder frame is patched with
    the final LAME Xing/Info tag, like lame's file writer does."""
    lame = _lame()
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        raise ValueError("pcm must be int16")
    if pcm.ndim == 1:
        channels = 1
        left = np.ascontiguousarray(pcm)
        right = left
    else:
        channels = 2
        left = np.ascontiguousarray(pcm[:, 0])
        right = np.ascontiguousarray(pcm[:, 1])

    gf = lame.lame_init()
    try:
        lame.lame_set_in_samplerate(gf, sample_rate)
        lame.lame_set_out_samplerate(gf, sample_rate)
        lame.lame_set_num_channels(gf, channels)
        lame.lame_set_mode(gf, MODE_MONO if channels == 1 else mode)
        lame.lame_set_quality(gf, 2)
        lame.lame_set_bWriteVbrTag(gf, 1 if write_vbr_tag else 0)
        if vbr:
            lame.lame_set_VBR(gf, VBR_DEFAULT)
            lame.lame_set_VBR_q(gf, vbr_quality)
        else:
            lame.lame_set_VBR(gf, VBR_OFF)
            lame.lame_set_brate(gf, bitrate)
        if lame.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed")

        n = len(left)
        out_cap = int(1.25 * n * channels * 2 + 7200) + 7200
        out = (ctypes.c_ubyte * out_cap)()
        nbytes = lame.lame_encode_buffer(
            gf,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            n,
            out,
            out_cap,
        )
        if nbytes < 0:
            raise RuntimeError(f"lame_encode_buffer failed: {nbytes}")
        flush = (ctypes.c_ubyte * 16384)()
        fbytes = lame.lame_encode_flush(gf, flush, 16384)
        if fbytes < 0:
            raise RuntimeError(f"lame_encode_flush failed: {fbytes}")
        data = bytearray(bytes(out[:nbytes]) + bytes(flush[:fbytes]))

        if write_vbr_tag:
            tag = (ctypes.c_ubyte * 8192)()
            tag_len = lame.lame_get_lametag_frame(gf, tag, 8192)
            if 0 < tag_len <= len(data):
                data[:tag_len] = bytes(tag[:tag_len])
        return bytes(data)
    finally:
        lame.lame_close(gf)


# ---------------------------------------------------------------------------
# AAC-LC encoding through the system libavcodec (ctypes, no headers): the
# stable public C API plus the long-stable layouts of AVPacket and AVFrame;
# the few AVCodecContext offsets needed are found through the AVOption API.
# ---------------------------------------------------------------------------

AV_CODEC_ID_AAC = 86018
AV_SAMPLE_FMT_FLTP = 8
AV_OPT_SEARCH_CHILDREN = 1

# AVPacket: uint8* data @24, int size @32. AVFrame: uint8* data[8] @0,
# uint8** extended_data @96, nb_samples @112, format @116.
_PKT_DATA = 24
_PKT_SIZE = 32
_FRM_DATA = 0
_FRM_EXT_DATA = 96
_FRM_NB_SAMPLES = 112
_FRM_FORMAT = 116


@lru_cache(maxsize=None)
def _av() -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """(libavutil, libavcodec) with the signatures encode_adts calls,
    loaded on first use."""
    avu = ctypes.CDLL("libavutil.so.57", mode=ctypes.RTLD_GLOBAL)
    ctypes.CDLL("libswresample.so.4", mode=ctypes.RTLD_GLOBAL)
    avc = ctypes.CDLL("libavcodec.so.59", mode=ctypes.RTLD_GLOBAL)
    for name, restype, argtypes in [
        ("avcodec_find_encoder", ctypes.c_void_p, [ctypes.c_int]),
        ("avcodec_alloc_context3", ctypes.c_void_p, [ctypes.c_void_p]),
        ("avcodec_open2", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
        ("avcodec_send_frame", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        ("avcodec_receive_packet", ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
        ("av_packet_alloc", ctypes.c_void_p, []),
        ("av_packet_unref", None, [ctypes.c_void_p]),
        ("av_frame_alloc", ctypes.c_void_p, []),
        ("av_frame_unref", None, [ctypes.c_void_p]),
        ("av_frame_get_buffer", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
    ]:
        fn = (getattr(avc if name.startswith("avcodec") else avu, name, None)
              or getattr(avc, name))
        fn.restype = restype
        fn.argtypes = argtypes
    avu.av_opt_set.restype = ctypes.c_int
    avu.av_opt_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int]
    return avu, avc


def _read_i32(ptr, off):
    return struct.unpack_from("<i", ctypes.string_at(ptr + off, 4))[0]


def _read_ptr(ptr, off):
    return struct.unpack_from("<Q", ctypes.string_at(ptr + off, 8))[0]


def _write_i32(ptr, off, value):
    ctypes.memmove(ptr + off, struct.pack("<i", value), 4)


@lru_cache(maxsize=None)
def _sample_fmt_offset() -> int:
    """AVCodecContext.sample_fmt's offset in this build: set a distinctive
    sample rate through AVOptions, find it, and take the first
    AV_SAMPLE_FMT_NONE (-1) int after it."""
    avu, avc = _av()
    ctx = avc.avcodec_alloc_context3(avc.avcodec_find_encoder(AV_CODEC_ID_AAC))
    avu.av_opt_set(ctx, b"ar", b"39313", AV_OPT_SEARCH_CHILDREN)
    blob = ctypes.string_at(ctx, 2048)
    sr_off = blob.find(struct.pack("<i", 39313))
    assert sr_off > 0, "AVCodecContext offset discovery failed"
    for off in range(sr_off, sr_off + 64, 4):
        if struct.unpack_from("<i", blob, off)[0] == -1:
            return off
    raise RuntimeError("sample_fmt offset not found")


@lru_cache(maxsize=None)
def _frame_chlayout_offset() -> int:
    """AVFrame.ch_layout's offset, by probing av_frame_get_buffer: with
    nb_samples and format set, the call succeeds only once a valid
    AVChannelLayout {order=NATIVE, nb=2, mask=3} sits at the right spot."""
    avu, _ = _av()
    probe = struct.pack("<iiQ", 1, 2, 3)
    for off in range(120, 760, 4):
        frame = avu.av_frame_alloc()
        _write_i32(frame, _FRM_NB_SAMPLES, 256)
        _write_i32(frame, _FRM_FORMAT, AV_SAMPLE_FMT_FLTP)
        ctypes.memmove(frame + off, probe, len(probe))
        rc = avu.av_frame_get_buffer(frame, 0)
        if (rc == 0 and _read_ptr(frame, _FRM_DATA) != 0
                and _read_ptr(frame, _FRM_DATA + 8) != 0):
            return off
    raise RuntimeError("AVFrame.ch_layout offset not found")


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


def encode_adts(pcm: np.ndarray, sample_rate: int, bitrate: int = 128000) -> bytes:
    """Encode float PCM (n, channels) to an ADTS .aac byte stream with
    libavcodec's native AAC-LC encoder."""
    avu, avc = _av()
    pcm = np.asarray(pcm, dtype=np.float32)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, channels = pcm.shape

    codec = avc.avcodec_find_encoder(AV_CODEC_ID_AAC)
    assert codec, "libavcodec AAC encoder not found"
    ctx = avc.avcodec_alloc_context3(codec)
    avu.av_opt_set(ctx, b"ar", str(sample_rate).encode(), AV_OPT_SEARCH_CHILDREN)
    layout = b"mono" if channels == 1 else b"stereo"
    rc = avu.av_opt_set(ctx, b"ch_layout", layout, AV_OPT_SEARCH_CHILDREN)
    if rc != 0:  # older option name
        avu.av_opt_set(ctx, b"channel_layout", layout, AV_OPT_SEARCH_CHILDREN)
        avu.av_opt_set(ctx, b"ac", str(channels).encode(), AV_OPT_SEARCH_CHILDREN)
    avu.av_opt_set(ctx, b"b", str(bitrate).encode(), AV_OPT_SEARCH_CHILDREN)
    _write_i32(ctx, _sample_fmt_offset(), AV_SAMPLE_FMT_FLTP)
    rc = avc.avcodec_open2(ctx, codec, None)
    assert rc == 0, f"encoder open failed: {rc}"

    frame = avu.av_frame_alloc()
    pkt = avc.av_packet_alloc()
    out = bytearray()
    frame_len = 1024

    def drain():
        while avc.avcodec_receive_packet(ctx, pkt) == 0:
            raw = ctypes.string_at(_read_ptr(pkt, _PKT_DATA), _read_i32(pkt, _PKT_SIZE))
            out.extend(_adts_header(len(raw), sample_rate, channels))
            out.extend(raw)
            avc.av_packet_unref(pkt)

    ch_off = _frame_chlayout_offset()
    for start in range(0, n, frame_len):
        chunk = pcm[start : start + frame_len]
        if chunk.shape[0] < frame_len:
            chunk = np.pad(chunk, ((0, frame_len - chunk.shape[0]), (0, 0)))
        avu.av_frame_unref(frame)
        _write_i32(frame, _FRM_NB_SAMPLES, frame_len)
        _write_i32(frame, _FRM_FORMAT, AV_SAMPLE_FMT_FLTP)
        mask = 4 if channels == 1 else 3
        ctypes.memmove(frame + ch_off, struct.pack("<iiQ", 1, channels, mask), 16)
        rc = avu.av_frame_get_buffer(frame, 0)
        assert rc == 0, f"frame buffer alloc failed: {rc}"
        ext = _read_ptr(frame, _FRM_EXT_DATA)
        for c in range(channels):
            arr = np.ascontiguousarray(chunk[:, c])
            ctypes.memmove(_read_ptr(ext, 8 * c), arr.ctypes.data, frame_len * 4)
        rc = avc.avcodec_send_frame(ctx, frame)
        if rc != 0:
            raise RuntimeError(f"send_frame failed: {rc}")
        drain()
    avc.avcodec_send_frame(ctx, None)  # flush
    drain()
    return bytes(out)


def encode_m4a(pcm: np.ndarray, sample_rate: int, bitrate: int = 128000) -> bytes:
    """Encode float PCM (n, ch) to a minimal M4A file (AAC-LC in MP4)."""
    return encode_m4a_multi([(pcm, sample_rate)], bitrate=bitrate)


def encode_m4a_multi(tracks: "list[tuple[np.ndarray, int]]",
                     bitrate: int = 128000) -> bytes:
    """Encode one or more (pcm, sample_rate) pairs as the audio tracks of
    one M4A file (AAC-LC in MP4); several tracks exercise track selection."""
    st = struct

    def box(t, payload):
        return st.pack(">I", 8 + len(payload)) + t + payload

    def full_box(t, payload, version=0, flags=0):
        return box(t, st.pack(">I", (version << 24) | flags) + payload)

    def desc(tag, payload):
        return bytes([tag, len(payload)]) + payload

    track_frames = []
    traks = []
    for track_id, (pcm, sample_rate) in enumerate(tracks, start=1):
        adts = encode_adts(np.asarray(pcm, np.float32), sample_rate, bitrate)
        # Split the ADTS stream back into raw AAC frames.
        frames = []
        pos = 0
        while pos + 7 <= len(adts):
            full = ((adts[pos + 3] & 0x3) << 11) | (adts[pos + 4] << 3) | (adts[pos + 5] >> 5)
            frames.append(adts[pos + 7 : pos + full])
            pos += full
        channels = 1 if np.asarray(pcm).ndim == 1 else np.asarray(pcm).shape[1]

        sr_index = _ADTS_SR_INDEX[sample_rate]
        asc = bytes([(2 << 3) | (sr_index >> 1), ((sr_index & 1) << 7) | (channels << 3)])

        dsi = desc(0x05, asc)
        dec_conf = desc(0x04, bytes([0x40, 0x15, 0, 0, 0]) + st.pack(">II", 0, 0) + dsi)
        sl = desc(0x06, b"\x02")
        es = desc(0x03, st.pack(">HB", track_id, 0) + dec_conf + sl)
        esds = full_box(b"esds", es)

        mp4a = box(
            b"mp4a",
            bytes(6) + st.pack(">H", 1) + bytes(8)
            + st.pack(">HHI", channels, 16, 0) + st.pack(">I", sample_rate << 16)
            + esds,
        )
        stsd = full_box(b"stsd", st.pack(">I", 1) + mp4a)
        n = len(frames)
        stts = full_box(b"stts", st.pack(">III", 1, n, 1024))
        stsc = full_box(b"stsc", st.pack(">IIII", 1, 1, n, 1))
        stsz = full_box(b"stsz", st.pack(">II", 0, n)
                        + b"".join(st.pack(">I", len(f)) for f in frames))
        stco = full_box(b"stco", st.pack(">II", 1, 0))  # offset patched below
        stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
        dref = full_box(b"dref", st.pack(">I", 1) + full_box(b"url ", b"", flags=1))
        minf = box(b"minf", full_box(b"smhd", bytes(4)) + box(b"dinf", dref) + stbl)
        duration = n * 1024
        mdhd = full_box(b"mdhd", st.pack(">IIIIHH", 0, 0, sample_rate, duration, 0x55C4, 0))
        hdlr = full_box(b"hdlr", bytes(4) + b"soun" + bytes(12) + b"\x00")
        mdia = box(b"mdia", mdhd + hdlr + minf)
        tkhd = full_box(
            b"tkhd", st.pack(">IIIII", 0, 0, track_id, 0, duration) + bytes(60), flags=7
        )
        traks.append(box(b"trak", tkhd + mdia))
        track_frames.append(frames)

    sr0 = tracks[0][1]
    dur0 = len(track_frames[0]) * 1024
    mvhd = full_box(
        b"mvhd",
        st.pack(">IIII", 0, 0, sr0, dur0) + st.pack(">I", 0x00010000)
        + st.pack(">H", 0x0100) + bytes(10)
        + st.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + bytes(24) + st.pack(">I", len(tracks) + 1),
    )
    moov = box(b"moov", mvhd + b"".join(traks))
    ftyp = box(b"ftyp", b"M4A " + st.pack(">I", 0) + b"M4A mp42isom")
    payloads = [b"".join(frames) for frames in track_frames]
    mdat = box(b"mdat", b"".join(payloads))

    out = bytearray(ftyp + moov + mdat)
    # Patch each trak's single chunk offset to its payload position in mdat
    # (trak order == payload order).
    offset = len(ftyp) + len(moov) + 8
    pos = 0
    for payload in payloads:
        stco_pos = out.find(b"stco", pos)
        st.pack_into(">I", out, stco_pos + 12, offset)
        offset += len(payload)
        pos = stco_pos + 4
    return bytes(out)


def _int16(wave: np.ndarray) -> np.ndarray:
    return np.clip(wave * 32767, -32768, 32767).astype(np.int16)


def bench_pcm(seconds: int = 60, sr: int = 44100) -> np.ndarray:
    """bench.py's signal (_make_track_mp3), (n, 2) int16."""
    rng = np.random.default_rng(7)
    t = np.arange(sr * seconds) / sr
    wave = 0.35 * np.sin(2 * np.pi * 440.0 * t)
    wave += 0.15 * np.sin(2 * np.pi * 1870.0 * t)
    wave += 0.08 * rng.standard_normal(len(t))
    pcm = _int16(wave)
    return np.stack([pcm, np.roll(pcm, 11)], axis=1)


def mono_pcm(seconds: int = 3, sr: int = 22050) -> np.ndarray:
    rng = np.random.default_rng(3)
    t = np.arange(sr * seconds) / sr
    return _int16(0.4 * np.sin(2 * np.pi * 510.0 * t)
                  + 0.12 * rng.standard_normal(len(t)))


def transient_pcm(seconds: int = 3, sr: int = 44100) -> np.ndarray:
    rng = np.random.default_rng(9)
    n = sr * seconds
    wave = 0.02 * rng.standard_normal(n)
    burst = 0.8 * np.sin(2 * np.pi * 3000 * np.arange(300) / sr) * np.exp(
        -np.arange(300) / 60.0)
    for pos in range(800, n - 900, 2500):
        wave[pos : pos + 300] += burst
    pcm = _int16(wave)
    return np.stack([pcm, np.roll(pcm, 3)], axis=1)


def _float(pcm: np.ndarray) -> np.ndarray:
    return pcm.astype(np.float32) / 32768.0


def aac_bench_pcm(seconds: int = 60, sr: int = 44100) -> np.ndarray:
    """bench.py's AAC signal (_prep_aac), (n, 2) float32."""
    rng = np.random.default_rng(11)
    t = np.arange(sr * seconds) / sr
    wave = 0.3 * np.sin(2 * np.pi * 523.0 * t)
    wave += 0.1 * np.sin(2 * np.pi * 2093.0 * t)
    wave += 0.06 * rng.standard_normal(len(t))
    pcm = _int16(wave)
    return _float(np.stack([pcm, np.roll(pcm, 17)], axis=1))


def pns_pcm(seconds: int = 4, sr: int = 44100) -> np.ndarray:
    """A tone over noise; at 96 kbps the encoder codes noise bands."""
    rng = np.random.default_rng(3)
    t = np.arange(sr * seconds) / sr
    wave = 0.3 * np.sin(2 * np.pi * 523.0 * t)
    wave += 0.05 * rng.standard_normal(len(t))
    return np.stack([wave, np.roll(wave, 13)], axis=1).astype(np.float32)


def tone_pcm(freq: float, seconds: int, sr: int, channels: int) -> np.ndarray:
    t = np.arange(sr * seconds) / sr
    wave = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    return wave if channels == 1 else np.stack([wave, np.roll(wave, 5)], axis=1)


def aac_tracks() -> list[tuple[str, bytes]]:
    """(name, bytes) of every AAC clip, encoded now."""
    return [
        (AAC_BENCH_TRACK, encode_m4a(aac_bench_pcm(), 44100, bitrate=192000)),
        (AAC_TRANSIENT_TRACK,
         encode_m4a(_float(transient_pcm()), 44100, bitrate=128000)),
        (AAC_PNS_TRACK, encode_m4a(pns_pcm(), 44100, bitrate=96000)),
        (AAC_ADTS_TRACK, encode_adts(_float(mono_pcm()), 22050, bitrate=48000)),
        (AAC_TWO_TRACKS, encode_m4a_multi(
            [(tone_pcm(440.0, 3, 44100, 2), 44100),
             (tone_pcm(880.0, 3, 32000, 1), 32000)], bitrate=96000)),
    ]


def main(out_dir: str = DATA_DIR) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    tracks = [
        (BENCH_TRACK, bench_pcm(), 44100,
         dict(bitrate=192, mode=MODE_JOINT)),
        (MONO_TRACK, mono_pcm(), 22050,
         dict(bitrate=48, mode=MODE_MONO)),
        (TRANSIENT_TRACK, transient_pcm(), 44100,
         dict(bitrate=128, mode=MODE_STEREO)),
    ]
    paths = []
    for name, pcm, sr, kw in tracks:
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(encode_mp3(pcm, sr, **kw))
        paths.append(path)
    for name, data in aac_tracks():
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
    return paths


if __name__ == "__main__":
    for p in main():
        print(p, os.path.getsize(p))
