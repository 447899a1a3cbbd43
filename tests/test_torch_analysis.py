"""Torch port: entry points, import hygiene and the no-fallback rule.

analyze_track_internal / analyze_album / find_peak_amplitude of the port
(plain kernels on the CPU) against the JAX package's own entry points:
gain within 0.02 dB and peak within rtol 2e-4. The port package must
never import jax: a subprocess imports every port module (K3's
decode/class_core.py, its probe tools/hk_dotprobe.py and the decode
back-end decode/synthesis.py among them), runs a CPU slice on both MP3
routes and both AAC routes and finds no jax in sys.modules.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mp3rgain_tpu import analysis as jan  # noqa: E402
from mp3rgain_tpu.testing import fixtures  # noqa: E402
from mp3rgain_tpu_torch import analysis, device  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mp3rgain_tpu_torch"


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three 0.5 s clips: 44.1 kHz joint stereo, 22.05 kHz mono MPEG-2,
    and a transient track that forces short blocks."""
    out = tmp_path_factory.mktemp("torch_clips")
    rng = np.random.default_rng(21)
    paths = []

    def write(name, pcm, sr, **kw):
        p = out / name
        p.write_bytes(fixtures.encode_mp3(pcm, sr, **kw))
        paths.append(p)

    sr = 44100
    t = np.arange(sr // 2) / sr
    wave = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.size)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    write("joint.mp3", np.stack([pcm, np.roll(pcm, 9)], axis=1), sr,
          bitrate=160, mode=fixtures.MODE_JOINT)
    sr2 = 22050
    t2 = np.arange(sr2 // 2) / sr2
    wave2 = 0.5 * np.sin(2 * np.pi * 700 * t2) + 0.1 * rng.standard_normal(t2.size)
    write("mono22.mp3", np.clip(wave2 * 32767, -32768, 32767).astype(np.int16),
          sr2, bitrate=48, mode=fixtures.MODE_MONO)
    wave3 = 0.02 * rng.standard_normal(sr // 2)
    for pos in range(800, sr // 2 - 900, 2500):
        wave3[pos : pos + 300] += 0.8 * np.sin(
            2 * np.pi * 3000 * np.arange(300) / sr) * np.exp(-np.arange(300) / 60.0)
    pcm3 = np.clip(wave3 * 32767, -32768, 32767).astype(np.int16)
    write("transient.mp3", np.stack([pcm3, np.roll(pcm3, 3)], axis=1), sr,
          bitrate=128, mode=fixtures.MODE_STEREO)
    return paths


def test_track_gain_and_peak_match_jax(clips):
    for path in clips:
        mine = analysis.analyze_track_internal(path, device="cpu")
        ref = jan.analyze_track_internal(path).result
        assert abs(mine.result.gain_db - ref.gain_db) <= 0.02, path.name
        np.testing.assert_allclose(mine.result.peak, ref.peak, rtol=2e-4)
        assert mine.result.sample_rate == ref.sample_rate
        assert mine.result.file_type == "mp3"
        assert mine.histogram.shape == (12000,)
        peak = analysis.find_peak_amplitude(path, device="cpu")
        np.testing.assert_allclose(peak.peak, ref.peak, rtol=2e-4)
        assert peak.peak_pcm == pytest.approx(peak.peak * 32768.0)


def test_album_matches_jax(clips):
    files = clips[::2]  # the two 44.1 kHz stereo clips
    mine = analysis.analyze_album(files, device="cpu")
    ref = jan.analyze_album(files)
    assert len(mine.tracks) == len(ref.tracks) == 2
    assert abs(mine.album_gain_db - ref.album_gain_db) <= 0.02
    np.testing.assert_allclose(mine.album_peak, ref.album_peak, rtol=2e-4)
    for a, b in zip(mine.tracks, ref.tracks):
        assert abs(a.gain_db - b.gain_db) <= 0.02


def test_track_index_and_aac_are_refused(clips, tmp_path):
    """An MP3 has one track, so an index past it is refused. Two minimal
    ADTS headers are routed as AAC and analysed as the JAX package
    analyses them: two silent frames, an empty histogram, peak 0."""
    with pytest.raises(analysis.AnalysisError):
        analysis.analyze_track_internal(clips[0], 2, device="cpu")
    adts = tmp_path / "x.aac"
    adts.write_bytes(bytes([0xFF, 0xF1, 0x50, 0x80, 0x00, 0xE0, 0xFC]) * 2)
    mine = analysis.analyze_track_internal(adts, device="cpu")
    ref = jan.analyze_track_internal(adts)
    assert dataclasses.astuple(mine.result) == dataclasses.astuple(ref.result)
    assert mine.result.file_type == "aac"
    assert mine.result.peak == 0.0 and not mine.histogram.any()
    assert mine.audio_seconds == ref.audio_seconds
    assert (dataclasses.astuple(analysis.find_peak_amplitude(adts, device="cpu"))
            == dataclasses.astuple(jan.find_peak_amplitude(adts)))
    with pytest.raises(Exception, match="Track index 1 out of range") as err:
        analysis.analyze_track_internal(adts, 1, device="cpu")
    with pytest.raises(Exception) as j_err:
        jan.analyze_track_internal(adts, 1)
    assert str(err.value) == str(j_err.value)


def test_cuda_request_without_cuda_raises(clips, monkeypatch):
    """Asking for the GPU where there is none raises; nothing continues
    on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        device.require_cuda()
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        analysis.analyze_track_internal(clips[0], device="cuda")
    with pytest.raises(ValueError):
        device.resolve_device("meta")


def test_entry_points_default_to_the_card(clips, monkeypatch):
    """Without a device argument the entry points ask for the card: on a
    machine without one they raise require_cuda's error instead of
    running on the CPU."""
    from mp3rgain_tpu_torch.decode import synthesis
    from mp3rgain_tpu_torch.parallel import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: analysis.analyze_track_internal(clips[0]),
             lambda: analysis.analyze_album(clips[:2]),
             lambda: analysis.find_peak_amplitude(clips[1]),
             lambda: synthesis.decode_file(clips[0]),
             lambda: runner.Runner()]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device is required"):
            call()


def test_precision_policy():
    device.resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_sources_never_import_jax():
    offenders = []
    for path in PORT.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import jax", "from jax")):
                offenders.append(f"{path.relative_to(REPO)}: {s}")
    assert not offenders, offenders


_NO_JAX_SCRIPT = r"""
import importlib, pkgutil, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax imported by the torch port: " + name)
        return None

for m in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
    del sys.modules[m]
sys.meta_path.insert(0, _NoJax())

import mp3rgain_tpu_torch
for info in pkgutil.walk_packages(mp3rgain_tpu_torch.__path__, "mp3rgain_tpu_torch."):
    importlib.import_module(info.name)
for name in ("decode.class_core", "decode.synthesis", "tools.hk_dotprobe",
             "parallel.runner", "aac", "decode.aac_frontend", "decode.aac_prep",
             "decode.aac_synthesis"):
    assert "mp3rgain_tpu_torch." + name in sys.modules, name

from mp3rgain_tpu.decode import frontend as fe
from mp3rgain_tpu.testing import craft
from mp3rgain_tpu_torch import tracing
from mp3rgain_tpu_torch.decode import synthesis
from mp3rgain_tpu_torch.parallel.runner import Runner

data = craft.craft_count1b_stream(n_frames=12)
u = fe.unpack_data_light_packed(data)
hist, louds, peaks = Runner("cpu").analyze_unpacked_light([u], u.sample_rate, u.n_channels)
assert hist.shape == (1, 12000) and peaks.shape == (1,)
full = fe.unpack_data(data)
with tracing.recording():
    h_hist, h_louds, h_peaks = Runner("cpu").analyze_unpacked([full], u.sample_rate,
                                                              u.n_channels)
assert h_hist.shape == (1, 12000) and h_peaks.shape == (1,)
assert tracing.counter("plain.class_core_gemm") >= 1
pcm = synthesis.decode_batch(synthesis.batch_from_unpacked(full, "cpu"),
                             synthesis.DecodeTables(int(full.info[0, fe.SR_ROW])))
assert pcm.shape == (1, full.n_channels, full.n // full.n_channels * 576)

import os
from mp3rgain_tpu_torch import aac
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke
clip = os.path.join(smoke.DATA_DIR, smoke.AAC_ADTS_TRACK)
for device_prep in (True, False):
    r = aac.analyze_track_internal(clip, device="cpu", device_prep=device_prep)
    assert r.result.file_type == "aac" and r.histogram.sum() > 0
print("JAX_LOADED", any(m == "jax" or m.startswith("jax.") for m in sys.modules))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED False" in proc.stdout, proc.stdout
