"""Generate the MP3 inputs that chip_smoke.py reads.

The machine that runs chip_smoke.py on the GPU has no MP3 encoder, so
its inputs are committed under mp3rgain_tpu_torch/testing/data/. This
script regenerates them with the JAX package's libmp3lame fixtures
(mp3rgain_tpu.testing.fixtures.encode_mp3), deterministically from fixed
seeds:

  bench_60s_44k_joint_192k.mp3  the bench.py track: 60 s, 44.1 kHz joint
                                stereo, 192 kbps (440 Hz + 1870 Hz tones
                                plus noise, seed 7)
  mono_3s_22k_48k.mp3           3 s, 22.05 kHz mono MPEG-2, 48 kbps
  transient_3s_44k_128k.mp3     3 s, 44.1 kHz stereo, 128 kbps, decaying
                                3 kHz bursts that force short blocks

Run: python -m mp3rgain_tpu_torch.testing.make_smoke_data
"""

from __future__ import annotations

import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

BENCH_TRACK = "bench_60s_44k_joint_192k.mp3"
MONO_TRACK = "mono_3s_22k_48k.mp3"
TRANSIENT_TRACK = "transient_3s_44k_128k.mp3"


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
    from mp3rgain_tpu.testing import fixtures

    os.makedirs(out_dir, exist_ok=True)
    tracks = [
        (BENCH_TRACK, bench_pcm(), 44100,
         dict(bitrate=192, mode=fixtures.MODE_JOINT)),
        (MONO_TRACK, mono_pcm(), 22050,
         dict(bitrate=48, mode=fixtures.MODE_MONO)),
        (TRANSIENT_TRACK, transient_pcm(), 44100,
         dict(bitrate=128, mode=fixtures.MODE_STEREO)),
    ]
    paths = []
    for name, pcm, sr, kw in tracks:
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(fixtures.encode_mp3(pcm, sr, **kw))
        paths.append(path)
    return paths


if __name__ == "__main__":
    for p in main():
        print(p, os.path.getsize(p))
