"""Generate the MP3 and AAC inputs that chip_smoke.py reads.

The machine that runs chip_smoke.py on the GPU has no MP3 or AAC encoder,
so its inputs are committed under mp3rgain_tpu_torch/testing/data/. This
script regenerates them with libmp3lame (fixtures.encode_mp3) and with
libavcodec's AAC-LC encoder (avcodec.encode_adts, fixtures.encode_m4a and
encode_m4a_multi), the port's copies of the JAX package's test oracles,
which load each library on first use, deterministically from fixed seeds:

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
  hot_5s_44k_128k.mp3           5 s, 44.1 kHz stereo, 128 kbps: a quiet
                                440 Hz bed (0.01 FS) with a 0.15 s 0.8 FS
                                burst, the peak contract's clip
                                (tests/test_peak_contract.py::_burst_pcm);
                                +4 gain steps take its peak above 1.0
  standard/*.mp3                the JAX package's 12 standard fixtures
                                (fixtures.generate_standard_fixtures):
                                1 s 440 Hz sines at every MPEG rate, mono,
                                stereo, joint stereo and VBR (122 KB)
  adts/*.aac                    3 s ADTS clips at the ten AAC rates the
                                clips above lack (adts_rate_clips), tones
                                over noise, mono and stereo (290 KB)

Run: python -m mp3rgain_tpu_torch.testing.make_smoke_data
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from .avcodec import encode_adts
from .fixtures import (MODE_JOINT, MODE_MONO, MODE_STEREO, encode_m4a, encode_m4a_multi,
                       encode_mp3, generate_standard_fixtures)

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
STANDARD_DIR = os.path.join(DATA_DIR, "standard")
ADTS_DIR = os.path.join(DATA_DIR, "adts")

BENCH_TRACK = "bench_60s_44k_joint_192k.mp3"
MONO_TRACK = "mono_3s_22k_48k.mp3"
TRANSIENT_TRACK = "transient_3s_44k_128k.mp3"
AAC_BENCH_TRACK = "bench_60s_44k_192k.m4a"
AAC_TRANSIENT_TRACK = "transient_3s_44k_128k.m4a"
AAC_PNS_TRACK = "pns_4s_44k_96k.m4a"
AAC_ADTS_TRACK = "mono_3s_22k_48k.aac"
AAC_TWO_TRACKS = "two_tracks_3s.m4a"
HOT_TRACK = "hot_5s_44k_128k.mp3"


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


def hot_pcm(bed_amp: float = 0.01, burst_amp: float = 0.8, sr: int = 44100,
            seconds: float = 5.0) -> np.ndarray:
    """Quiet sine bed with a 0.15 s loud burst, (n, 2) int16: low loudness
    (the 95th-percentile window sits in the bed) but a peak set by the
    burst (tests/test_peak_contract.py::_burst_pcm)."""
    n = int(sr * seconds)
    t = np.arange(n, dtype=np.float64) / sr
    wave = bed_amp * np.sin(2 * np.pi * 440.0 * t)
    b0, b1 = int(2.0 * sr), int(2.15 * sr)
    wave[b0:b1] = burst_amp * np.sin(2 * np.pi * 440.0 * t[b0:b1])
    samples = np.clip(wave * 32767.0, -32768, 32767).astype(np.int16)
    return np.stack([samples, samples], axis=1)


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


# (sample rate, channels, bitrate) of the ADTS clips at the AAC rates the
# other clips lack: every ADTS sampling-frequency index but 44.1 and 22.05 kHz.
ADTS_RATES = ((8000, 1, 16000), (11025, 2, 32000), (12000, 1, 24000),
              (16000, 2, 48000), (24000, 1, 48000), (32000, 2, 96000),
              (48000, 2, 128000), (64000, 1, 96000), (88200, 2, 128000),
              (96000, 2, 128000))


def adts_rate_name(sr: int, channels: int) -> str:
    return f"rate_{sr}_{'mono' if channels == 1 else 'stereo'}.aac"


def rate_pcm(sr: int, channels: int, seconds: int = 3) -> np.ndarray:
    """A 440 Hz tone, a second tone at min(3 kHz, sr/5) and noise (seeded
    by the rate), (n,) or (n, 2) float32."""
    rng = np.random.default_rng(sr)
    t = np.arange(sr * seconds) / sr
    wave = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    wave += 0.1 * np.sin(2 * np.pi * min(3000.0, sr / 5) * t)
    wave += 0.05 * rng.standard_normal(len(t))
    wave = wave.astype(np.float32)
    return wave if channels == 1 else np.stack([wave, np.roll(wave, 9)], axis=1)


def adts_rate_clips() -> list[tuple[str, bytes]]:
    """(name, bytes) of every ADTS rate clip, encoded now."""
    return [(adts_rate_name(sr, ch), encode_adts(rate_pcm(sr, ch), sr, bitrate=br))
            for sr, ch, br in ADTS_RATES]


def standard_paths() -> list[str]:
    """The committed standard fixtures, sorted by name."""
    return [os.path.join(STANDARD_DIR, n) for n in sorted(os.listdir(STANDARD_DIR))
            if n.endswith(".mp3")]


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
        (HOT_TRACK, hot_pcm(), 44100, dict(bitrate=128)),
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
    # generate_standard_fixtures keeps files that exist: encode afresh.
    standard = os.path.join(out_dir, "standard")
    os.makedirs(standard, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name in sorted(os.listdir(generate_standard_fixtures(tmp))):
            shutil.copyfile(os.path.join(tmp, name), os.path.join(standard, name))
            paths.append(os.path.join(standard, name))
    adts = os.path.join(out_dir, "adts")
    os.makedirs(adts, exist_ok=True)
    for name, data in adts_rate_clips():
        path = os.path.join(adts, name)
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
    return paths


if __name__ == "__main__":
    for p in main():
        print(p, os.path.getsize(p))
