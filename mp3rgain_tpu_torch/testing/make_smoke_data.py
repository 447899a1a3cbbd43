"""Generate the MP3 inputs that chip_smoke.py reads.

The machine that runs chip_smoke.py on the GPU has no MP3 encoder, so
its inputs are committed under mp3rgain_tpu_torch/testing/data/. This
script regenerates them with libmp3lame, through encode_mp3 below (a copy
of the JAX package's mp3rgain_tpu/testing/fixtures.py::encode_mp3, held
byte-identical to it by tests/test_torch_host_copies.py),
deterministically from fixed seeds:

  bench_60s_44k_joint_192k.mp3  the bench.py track: 60 s, 44.1 kHz joint
                                stereo, 192 kbps (440 Hz + 1870 Hz tones
                                plus noise, seed 7)
  mono_3s_22k_48k.mp3           3 s, 22.05 kHz mono MPEG-2, 48 kbps
  transient_3s_44k_128k.mp3     3 s, 44.1 kHz stereo, 128 kbps, decaying
                                3 kHz bursts that force short blocks

Run: python -m mp3rgain_tpu_torch.testing.make_smoke_data
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

BENCH_TRACK = "bench_60s_44k_joint_192k.mp3"
MONO_TRACK = "mono_3s_22k_48k.mp3"
TRANSIENT_TRACK = "transient_3s_44k_128k.mp3"

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
    return paths


if __name__ == "__main__":
    for p in main():
        print(p, os.path.getsize(p))
