"""Torch port: the JAX package's oracle tests, run on the port's own oracles.

The port carries copies of the JAX package's test oracles
(mp3rgain_tpu_torch/testing: mpg123, avcodec, fixtures) and the float64
ReplayGain reference (testing/reference.py, ops/iir.equal_loudness_scan).
These tests are the JAX package's, pointed at the port (decode and
analysis on the CPU, through each entry point's device="cpu"):

- test_decoder.py: decode_file against libmpg123 on the 12 standard
  fixture classes at max(3e-5, 3e-5·rms), and on 4 short-block stress
  clips at 5e-3;
- test_replaygain.py, tier 4: the light and the heavy route's gain within
  0.05 dB of reference_gain, on the port's PCM and on libmpg123's; and the
  AAC q route on the committed clips against reference_gain on the PCM it
  analyses (aac.decode_file_q: its PNS noise is keyed by batch row) and,
  but for the PNS clip, on the host decoder's;
- test_peak_contract.py: its 7 cases on cli.main(..., device="cpu");
- test_gain_oracle.py: the decoder scale oracle (libmpg123 decodes a file
  after +s gain steps to its PCM times 2^(s/4)) and the from-spec bit
  confinement of the byte surgery, on the port's bitstream;
- test_graft_entry.py: entry() returns a callable whose result on the CPU
  equals the JAX entry()'s on the same batch (windows exact, loudness
  index within 2 bins, peak within rtol 2e-4);
- the build entry point `python -m mp3rgain_tpu_torch.native` builds the
  host library. tests/test_torch_cuda.py runs entry() and
  `python -m mp3rgain_tpu_torch._build` on a card.
"""

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_gain_oracle import _read_bits8, _spec_walk  # noqa: E402
from test_peak_contract import _burst_pcm  # noqa: E402

from mp3rgain_tpu_torch import aac, analysis, cli, entry  # noqa: E402
from mp3rgain_tpu_torch.bitstream import (  # noqa: E402
    Channel,
    analyze,
    apply_gain,
    apply_gain_channel,
    db_to_steps,
)
from mp3rgain_tpu_torch.decode import class_core as cc  # noqa: E402
from mp3rgain_tpu_torch.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu_torch.decode import synthesis as syn  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402
from mp3rgain_tpu_torch.testing import fixtures, mpg123  # noqa: E402
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke  # noqa: E402
from mp3rgain_tpu_torch.testing.reference import reference_gain, reference_peak  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIXTURES = [
    "test_stereo.mp3",
    "test_mono.mp3",
    "test_joint_stereo.mp3",
    "test_vbr.mp3",
    "test_mpeg2_22050.mp3",
    "test_mpeg25_11025.mp3",
    "test_48000.mp3",
    "test_32000.mp3",
    "test_mpeg2_24000.mp3",
    "test_mpeg2_16000.mp3",
    "test_mpeg25_12000.mp3",
    "test_mpeg25_8000.mp3",
]
GAIN_FIXTURES = FIXTURES[:6]  # the JAX tier-4 and gain-oracle sets


@pytest.fixture(scope="module")
def port_fixtures(tmp_path_factory):
    """The standard fixture set, encoded by the port's own copy."""
    return fixtures.generate_standard_fixtures(tmp_path_factory.mktemp("port_fx"))


# --- test_decoder.py ------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_decode_matches_mpg123(port_fixtures, name):
    path = port_fixtures / name
    mine, sr = syn.decode_file(path, device="cpu")
    ref, sr_ref = mpg123.decode_file(path)
    ref = ref.T
    assert sr == sr_ref
    assert mine.shape == ref.shape  # frame-for-frame alignment
    err = np.abs(mine - ref)
    rms_ref = np.sqrt((ref ** 2).mean())
    # The oracle emits float32; the port's CPU decode (the plain split-bf16
    # class-core products) adds noise of the same order.
    bound = max(3e-5, 3e-5 * rms_ref)
    assert err.max() < bound, (err.max(), rms_ref)


@pytest.mark.parametrize("sr,bitrate", [(8000, 16), (24000, 32), (22050, 32), (44100, 64)])
def test_decode_short_block_stress(sr, bitrate, tmp_path):
    """Impulsive content forcing short blocks with real scalefactors and
    subblock gains at LSF rates; libmpg123 itself deviates by ~2e-3 at
    24 kHz in this regime, hence the looser bound."""
    rng = np.random.default_rng(3)
    n = sr
    t = np.arange(n) / sr
    x = 0.02 * rng.standard_normal(n)
    for k in range(8):
        s = int(k * n / 8)
        x[s : s + 200] += 0.8 * np.sin(2 * np.pi * 1000 * t[:200]) * np.hanning(200)
    pcm = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    p = tmp_path / "stress.mp3"
    p.write_bytes(fixtures.encode_mp3(pcm, sr, bitrate=bitrate, mode=fixtures.MODE_MONO))
    mine, _ = syn.decode_file(p, device="cpu")
    ref = mpg123.decode_file(p)[0].T
    nn = min(mine.shape[1], ref.shape[1])
    err = np.abs(mine[:, :nn] - ref[:, :nn]).max()
    assert err < 5e-3, err


# --- test_replaygain.py, tier 4 ---------------------------------------------------


def _route_gain(path, route: str) -> tuple[float, float]:
    """(gain dB, peak) of one track on the CPU through `route`."""
    if route == "light":
        r = analysis.analyze_track_internal(path, device="cpu").result
        return r.gain_db, r.peak
    u = fe.unpack_file(path)
    _, louds, peaks = pr.Runner("cpu").analyze_unpacked([u], u.sample_rate, u.n_channels)
    return 64.82 - float(louds[0]), float(peaks[0])


@pytest.mark.parametrize("route", ["light", "heavy"])
@pytest.mark.parametrize("name", GAIN_FIXTURES)
def test_track_gain_matches_reference_oracle(port_fixtures, name, route):
    path = port_fixtures / name
    gain, peak = _route_gain(path, route)

    pcm, sr = syn.decode_file(path, device="cpu")
    oracle = reference_gain(pcm, sr)
    assert abs(gain - oracle) <= 0.05, (gain, oracle)
    np.testing.assert_allclose(peak, reference_peak(pcm), rtol=2e-4)

    ref_pcm, sr2 = mpg123.decode_file(path)
    oracle_mpg = reference_gain(ref_pcm.T, sr2)
    assert abs(gain - oracle_mpg) <= 0.05, (gain, oracle_mpg)


AAC_TRACKS = [(smoke.AAC_TRANSIENT_TRACK, None), (smoke.AAC_PNS_TRACK, None),
              (smoke.AAC_ADTS_TRACK, None), (smoke.AAC_TWO_TRACKS, 0),
              (smoke.AAC_TWO_TRACKS, 1)]


@pytest.mark.parametrize("name,track", AAC_TRACKS)
def test_aac_q_route_matches_reference_oracle(name, track):
    path = os.path.join(smoke.DATA_DIR, name)
    r = aac.analyze_track_internal(path, track, device="cpu", device_prep=True).result
    pcm, sr = aac.decode_file_q(path, track, device="cpu")
    assert sr == r.sample_rate and pcm.shape[1] > sr
    assert np.abs(pcm).max() <= aac.AAC_CLIP
    assert abs(r.gain_db - reference_gain(pcm, sr)) <= 0.05
    np.testing.assert_allclose(r.peak, reference_peak(pcm), rtol=2e-4)
    if name != smoke.AAC_PNS_TRACK:
        host, sr_h = aac.decode_file(path, track, device="cpu")
        host = np.clip(host, -aac.AAC_CLIP, aac.AAC_CLIP)
        assert sr_h == sr and host.shape == pcm.shape
        assert abs(r.gain_db - reference_gain(host, sr)) <= 0.05


# --- test_peak_contract.py ----------------------------------------------------------


@pytest.fixture(scope="module")
def hot_mp3(tmp_path_factory):
    """Quiet bed + 0.8 FS burst, boosted +4 steps (+6 dB) by gain surgery:
    peak ~1.6, track gain still positive."""
    p = tmp_path_factory.mktemp("hot") / "hot.mp3"
    p.write_bytes(fixtures.encode_mp3(_burst_pcm(0.01, 0.8), 44100, bitrate=128))
    apply_gain(p, 4)
    return p


def _cli_json(argv, capsys):
    rc = cli.main(argv, device="cpu")
    return rc, json.loads(capsys.readouterr().out)["files"][0]


def test_unclipped_peak_above_one(hot_mp3):
    r = analysis.find_peak_amplitude(hot_mp3, device="cpu")
    assert 1.2 < r.peak < 2.0  # a clipping decoder would report exactly 1.0
    assert r.peak_pcm == pytest.approx(r.peak * 32768.0)


def test_max_amplitude_warns_may_be_clipped(hot_mp3, tmp_path, capsys):
    p = tmp_path / "hot.mp3"
    shutil.copy(hot_mp3, p)
    rc, f = _cli_json(["-x", "-o", "json", str(p)], capsys)
    assert rc == 0
    assert f["max_amplitude"] > 32768.0
    assert "may be clipped" in f["warning"]


def test_no_clip_warning_below_threshold(port_fixtures, tmp_path, capsys):
    p = tmp_path / "quiet.mp3"
    shutil.copy(port_fixtures / "test_stereo.mp3", p)
    rc, f = _cli_json(["-x", "-o", "json", str(p)], capsys)
    assert rc == 0
    assert f["max_amplitude"] < 0.9999 * 32768.0
    assert f.get("warning") is None


def test_k_caps_gain_using_unclipped_peak(hot_mp3, tmp_path, capsys):
    p = tmp_path / "hot.mp3"
    shutil.copy(hot_mp3, p)
    peak = analysis.find_peak_amplitude(hot_mp3, device="cpu").peak
    assert peak > 1.0
    rc, f = _cli_json(["-n", "-k", "-r", "-o", "json", str(p)], capsys)
    assert rc == 0
    assert max(db_to_steps(-20.0 * math.log10(peak)), 0) == 0
    assert f["gain_applied_steps"] == 0
    assert "prevent clipping" in f["warning"]


def test_k_caps_gain_partial(tmp_path, capsys):
    p = tmp_path / "mid.mp3"
    p.write_bytes(fixtures.encode_mp3(_burst_pcm(0.01, 0.5), 44100, bitrate=128))
    peak = analysis.find_peak_amplitude(p, device="cpu").peak
    assert 0.4 < peak < 0.6
    rc, f = _cli_json(["-n", "-k", "-r", "-o", "json", str(p)], capsys)
    assert rc == 0
    expected_cap = max(db_to_steps(-20.0 * math.log10(peak)), 0)
    assert expected_cap > 0
    assert f["gain_applied_steps"] == expected_cap
    assert peak * 10 ** (1.5 * expected_cap / 20) <= 1.0
    assert "prevent clipping" in f["warning"]


def test_clip_peak_compat_mode(hot_mp3, tmp_path, capsys, monkeypatch):
    p = tmp_path / "hot.mp3"
    shutil.copy(hot_mp3, p)
    rc, base = _cli_json(["-x", "-o", "json", str(p)], capsys)
    rc2, compat = _cli_json(["--clip-peak-compat", "-x", "-o", "json", str(p)], capsys)
    assert rc == 0 and rc2 == 0
    assert base["max_amplitude"] > 32768.0
    assert compat["max_amplitude"] == pytest.approx(32768.0)
    assert "may be clipped" in compat["warning"]

    rc = cli.main(["--clip-peak-compat", "-o", "tsv", str(p)], device="cpu")
    tsv = [ln for ln in capsys.readouterr().out.splitlines() if "hot.mp3" in ln]
    assert rc == 0 and tsv
    assert float(tsv[0].split("\t")[3]) == pytest.approx(32768.0)

    rc, out = _cli_json(["--clip-peak-compat", "-n", "-k", "-r", "-o", "json", str(p)],
                        capsys)
    assert rc == 0
    assert out["peak"] == pytest.approx(1.0)
    assert out["gain_applied_steps"] == 0

    monkeypatch.setenv("MP3RGAIN_CLIP_PEAK_COMPAT", "1")
    rc, envout = _cli_json(["-x", "-o", "json", str(p)], capsys)
    assert rc == 0
    assert envout["max_amplitude"] == pytest.approx(32768.0)


def test_clipping_warning_without_k(tmp_path, capsys):
    p = tmp_path / "mid.mp3"
    p.write_bytes(fixtures.encode_mp3(_burst_pcm(0.01, 0.5), 44100, bitrate=128))
    rc, f = _cli_json(["-n", "-r", "-o", "json", str(p)], capsys)
    assert rc == 0
    assert "clipping warning: peak would be" in f["warning"]
    assert f["gain_applied_steps"] > 0  # a warning only


# --- test_gain_oracle.py ----------------------------------------------------------------


def _copy(port_fixtures, name, tmp_path):
    dst = tmp_path / name
    shutil.copy(port_fixtures / name, dst)
    return dst


@pytest.mark.parametrize("name", GAIN_FIXTURES)
@pytest.mark.parametrize("steps", [2, -3])
def test_decoder_scale_oracle(port_fixtures, tmp_path, name, steps):
    src = _copy(port_fixtures, name, tmp_path)
    info = analyze(src)
    assert info.max_gain + max(steps, 0) <= 255  # no saturation in play
    assert info.min_gain + min(steps, 0) >= 0

    pcm0, sr0 = mpg123.decode_file(src)
    assert apply_gain(src, steps) == info.frame_count
    pcm1, sr1 = mpg123.decode_file(src)

    assert sr0 == sr1 and pcm0.shape == pcm1.shape
    ref = pcm0.astype(np.float64) * 2.0 ** (steps / 4.0)
    err = np.max(np.abs(pcm1.astype(np.float64) - ref))
    assert err < 1e-5, f"decoder disagrees with 2^(steps/4) scaling: {err}"


@pytest.mark.parametrize("name", GAIN_FIXTURES)
def test_bit_confinement(port_fixtures, tmp_path, name):
    src = _copy(port_fixtures, name, tmp_path)
    orig = src.read_bytes()
    steps = 2
    apply_gain(src, steps)
    mod = src.read_bytes()
    assert len(orig) == len(mod)

    frames = list(_spec_walk(orig))
    assert frames, "spec walker found no frames"
    allowed = set()
    for _, gains in frames:
        for g in gains:
            allowed.add(g // 8)
            allowed.add((g + 7) // 8)
            assert _read_bits8(mod, g) == min(max(_read_bits8(orig, g) + steps, 0), 255)
    diff = {i for i in range(len(orig)) if orig[i] != mod[i]}
    assert diff, "apply changed nothing"
    assert not diff - allowed, f"bytes changed outside gain fields: {sorted(diff - allowed)[:10]}"


def test_bit_confinement_channel(port_fixtures, tmp_path):
    """Channel gain touches only that channel's fields (gch order gr0ch0,
    gr0ch1, gr1ch0, gr1ch1)."""
    src = _copy(port_fixtures, "test_stereo.mp3", tmp_path)
    orig = src.read_bytes()
    apply_gain_channel(src, Channel.LEFT, 2)
    mod = src.read_bytes()
    allowed, checked = set(), 0
    for _, gains in _spec_walk(orig):
        for k, g in enumerate(gains):
            old, new = _read_bits8(orig, g), _read_bits8(mod, g)
            if k % 2 == 0:  # left channel fields
                assert new == min(old + 2, 255)
                allowed.add(g // 8)
                allowed.add((g + 7) // 8)
                checked += 1
            else:
                assert new == old
    assert checked > 0
    assert not {i for i in range(len(orig)) if orig[i] != mod[i]} - allowed


# --- test_graft_entry.py ----------------------------------------------------------------


def _jax_entry_module():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_returns_a_callable():
    fn, args = entry.entry(device="cpu")
    assert callable(fn) and len(args) == 6
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in args)
    assert args[0].shape == (4, 6 * 2 * 2, 192)
    assert entry.dryrun_multichip.__module__.endswith("parallel.dryrun")
    assert entry.dryrun_multihost.__module__.endswith("parallel.dryrun")
    if not torch.cuda.is_available():
        from mp3rgain_tpu_torch.replaygain import DeviceUnavailable

        with pytest.raises(DeviceUnavailable):
            entry.entry()


def test_entry_matches_the_jax_entry():
    """The same batch through both entries: windows exact, loudness index
    within 2 bins, peak within rtol 2e-4 (bf16x3 and f32 products differ)."""
    import jax

    jfn, jargs = _jax_entry_module().entry()
    j_hist, j_idx, j_peak = (np.asarray(a) for a in jax.jit(jfn)(*jargs))
    fn, args = entry.entry(device="cpu")
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), b)
    before = cc.COUNT.plain
    hist, idx, peak = (t.numpy() for t in fn(*args))
    assert cc.COUNT.plain > before  # the CPU runs K3's plain version
    assert hist.shape == j_hist.shape == (4, 12000)
    assert np.array_equal(hist.sum(axis=1), j_hist.sum(axis=1))
    assert np.abs(idx.astype(int) - j_idx.astype(int)).max() <= 2
    np.testing.assert_allclose(peak, j_peak, rtol=2e-4)


# --- the build entry points ----------------------------------------------------------------


def _run_module(name: str, *args: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", name, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_native_build_entry_point():
    from mp3rgain_tpu_torch import native

    proc = _run_module("mp3rgain_tpu_torch.native")
    assert proc.returncode == 0, proc.stderr
    path, seconds, unit = proc.stdout.split()
    assert path == native.SO_PATH and os.path.exists(path)
    assert float(seconds) >= 0 and unit == "s"
