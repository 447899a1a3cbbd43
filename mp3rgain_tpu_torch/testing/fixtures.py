"""MP3 fixture generation via libmp3lame (ctypes).

Mirrors the reference CI's ffmpeg-generated 1-second 440 Hz sine fixtures
(reference .github/workflows/ci.yml, docs/compatibility-report.md:159-164):
stereo CBR 128k, mono CBR 64k, joint stereo, and VBR, plus extra rates and
MPEG-2/2.5 variants for decoder branch coverage. encode_m4a and
encode_m4a_multi wrap avcodec.encode_adts's AAC-LC frames in MP4.

A copy of the JAX package's mp3rgain_tpu/testing/fixtures.py whose
library is opened and declared on first use (_load), not at import; every
function is the original's. tests/test_torch_host_copies.py holds the two
to the same code and the same bytes.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from .lazylib import LazyLibrary


def _load():
    _lame = ctypes.CDLL("libmp3lame.so.0")
    _lame.lame_init.restype = ctypes.c_void_p
    for name in [
        "lame_set_in_samplerate",
        "lame_set_out_samplerate",
        "lame_set_num_channels",
        "lame_set_brate",
        "lame_set_mode",
        "lame_set_VBR",
        "lame_set_VBR_q",
        "lame_set_quality",
        "lame_set_bWriteVbrTag",
    ]:
        fn = getattr(_lame, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lame.lame_init_params.restype = ctypes.c_int
    _lame.lame_init_params.argtypes = [ctypes.c_void_p]
    _lame.lame_encode_buffer.restype = ctypes.c_int
    _lame.lame_encode_buffer.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_short),
        ctypes.POINTER(ctypes.c_short),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
    ]
    _lame.lame_encode_flush.restype = ctypes.c_int
    _lame.lame_encode_flush.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
    ]
    _lame.lame_get_lametag_frame.restype = ctypes.c_size_t
    _lame.lame_get_lametag_frame.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_size_t,
    ]
    _lame.lame_close.restype = ctypes.c_int
    _lame.lame_close.argtypes = [ctypes.c_void_p]
    return _lame


_lame = LazyLibrary(_load)

# LAME MPEG_mode values.
MODE_STEREO = 0
MODE_JOINT = 1
MODE_MONO = 3

# LAME vbr_mode values.
VBR_OFF = 0
VBR_DEFAULT = 4


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
    the final LAME Xing/Info tag, like lame's file writer does — this gives
    fixtures a realistic VBR-header frame to exercise the Xing-skip logic.
    """
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

    gf = _lame.lame_init()
    try:
        _lame.lame_set_in_samplerate(gf, sample_rate)
        _lame.lame_set_out_samplerate(gf, sample_rate)
        _lame.lame_set_num_channels(gf, channels)
        _lame.lame_set_mode(gf, MODE_MONO if channels == 1 else mode)
        _lame.lame_set_quality(gf, 2)
        _lame.lame_set_bWriteVbrTag(gf, 1 if write_vbr_tag else 0)
        if vbr:
            _lame.lame_set_VBR(gf, VBR_DEFAULT)
            _lame.lame_set_VBR_q(gf, vbr_quality)
        else:
            _lame.lame_set_VBR(gf, VBR_OFF)
            _lame.lame_set_brate(gf, bitrate)
        if _lame.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed")

        n = len(left)
        out_cap = int(1.25 * n * channels * 2 + 7200) + 7200
        out = (ctypes.c_ubyte * out_cap)()
        nbytes = _lame.lame_encode_buffer(
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
        fbytes = _lame.lame_encode_flush(gf, flush, 16384)
        if fbytes < 0:
            raise RuntimeError(f"lame_encode_flush failed: {fbytes}")
        data = bytearray(bytes(out[:nbytes]) + bytes(flush[:fbytes]))

        if write_vbr_tag:
            tag = (ctypes.c_ubyte * 8192)()
            tag_len = _lame.lame_get_lametag_frame(gf, tag, 8192)
            if 0 < tag_len <= len(data):
                data[:tag_len] = bytes(tag[:tag_len])
        return bytes(data)
    finally:
        _lame.lame_close(gf)


def sine_pcm(
    sample_rate: int,
    seconds: float = 1.0,
    freq: float = 440.0,
    amplitude: float = 0.5,
    channels: int = 2,
) -> np.ndarray:
    n = int(sample_rate * seconds)
    t = np.arange(n, dtype=np.float64) / sample_rate
    wave = amplitude * np.sin(2 * np.pi * freq * t)
    samples = np.clip(wave * 32767.0, -32768, 32767).astype(np.int16)
    if channels == 2:
        return np.stack([samples, samples], axis=1)
    return samples


def encode_m4a(pcm: np.ndarray, sample_rate: int, bitrate: int = 128000) -> bytes:
    """Encode float PCM (n, ch) to a minimal M4A file (AAC-LC in MP4)."""
    return encode_m4a_multi([(pcm, sample_rate)], bitrate=bitrate)


def encode_m4a_multi(
    tracks: "list[tuple[np.ndarray, int]]", bitrate: int = 128000
) -> bytes:
    """Encode one or more (pcm, sample_rate) pairs as audio tracks of a
    single M4A file (AAC-LC in MP4). Multi-track files exercise the CLI's
    `-i` track selection (reference src/replaygain.rs:838-851)."""
    import struct as st

    from . import avcodec

    def box(t, payload):
        return st.pack(">I", 8 + len(payload)) + t + payload

    def full_box(t, payload, version=0, flags=0):
        return box(t, st.pack(">I", (version << 24) | flags) + payload)

    def desc(tag, payload):
        return bytes([tag, len(payload)]) + payload

    track_frames = []
    traks = []
    for track_id, (pcm, sample_rate) in enumerate(tracks, start=1):
        adts = avcodec.encode_adts(np.asarray(pcm, np.float32), sample_rate, bitrate)
        # Split the ADTS stream back into raw AAC frames.
        frames = []
        pos = 0
        while pos + 7 <= len(adts):
            full = ((adts[pos + 3] & 0x3) << 11) | (adts[pos + 4] << 3) | (adts[pos + 5] >> 5)
            frames.append(adts[pos + 7 : pos + full])
            pos += full
        channels = 1 if np.asarray(pcm).ndim == 1 else np.asarray(pcm).shape[1]

        sr_index = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
                    24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}[sample_rate]
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
        stsz = full_box(b"stsz", st.pack(">II", 0, n) + b"".join(st.pack(">I", len(f)) for f in frames))
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


def generate_standard_fixtures(out_dir: os.PathLike | str) -> Path:
    """Generate the standard fixture set; returns the directory."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    specs = {
        # Mirrors the reference fixture set (1 s, 440 Hz sine).
        "test_stereo.mp3": dict(sr=44100, mode=MODE_STEREO, bitrate=128, ch=2),
        "test_mono.mp3": dict(sr=44100, mode=MODE_MONO, bitrate=64, ch=1),
        "test_joint_stereo.mp3": dict(sr=44100, mode=MODE_JOINT, bitrate=128, ch=2),
        "test_vbr.mp3": dict(sr=44100, mode=MODE_JOINT, vbr=True, ch=2),
        # Decoder branch coverage: MPEG-2 and MPEG-2.5 rates.
        "test_mpeg2_22050.mp3": dict(sr=22050, mode=MODE_JOINT, bitrate=64, ch=2),
        "test_mpeg25_11025.mp3": dict(sr=11025, mode=MODE_MONO, bitrate=32, ch=1),
        "test_48000.mp3": dict(sr=48000, mode=MODE_STEREO, bitrate=192, ch=2),
        "test_32000.mp3": dict(sr=32000, mode=MODE_JOINT, bitrate=96, ch=2),
        "test_mpeg2_24000.mp3": dict(sr=24000, mode=MODE_JOINT, bitrate=64, ch=2),
        "test_mpeg2_16000.mp3": dict(sr=16000, mode=MODE_MONO, bitrate=32, ch=1),
        "test_mpeg25_12000.mp3": dict(sr=12000, mode=MODE_JOINT, bitrate=40, ch=2),
        "test_mpeg25_8000.mp3": dict(sr=8000, mode=MODE_MONO, bitrate=16, ch=1),
    }
    for name, s in specs.items():
        path = out / name
        if path.exists():
            continue
        pcm = sine_pcm(s["sr"], seconds=1.0, channels=s["ch"])
        data = encode_mp3(
            pcm,
            s["sr"],
            bitrate=s.get("bitrate", 128),
            mode=s["mode"],
            vbr=s.get("vbr", False),
        )
        path.write_bytes(data)
    return out
