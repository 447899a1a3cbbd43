"""Torch port: real track lengths, every rate's committed inputs, the
package root.

- The whole length, not the head: past the dense level-2 limit
  (NB2_DENSE_MAX superblocks of 128 x 128 samples, 3,342,336 samples) the
  IIR's cross-superblock solve is the log-step doubling scan. At 1.1x that
  limit, the port's float64 equal_loudness equals the scipy float64
  equal_loudness_scan over every sample (rtol 1e-9, atol 1e-9 x peak, the
  blocked solve's float64 rounding); float32 stays within 1e-3 of the peak
  at <= 48 kHz and 1e-2 at 96 kHz (the biquad cascade; 1.5x what this
  float32 path shows on the CPU); the loudness index of the float32 output
  equals the reference's (within 1 bin at 96 kHz). At 44.1 kHz (the
  grouped solve), 96 kHz (the cascade) and 8 kHz.
- testing/tile.py: a tiled MP3 (and ADTS) stream decodes to N copies of
  the clip's frames; a stream whose first audio frame borrows from a bit
  reservoir is refused. The port's light and host-decoded routes on a
  tiled 8 kHz MPEG-2.5 track 3,000 samples past the dense limit equal the
  JAX package's host-decoded route on the CPU (plain XLA): windows exact,
  loudness within 2 bins, peak rtol 2e-4 (the routes' tolerances).
- The committed inputs of chip_smoke.py's real_library phase: the 12
  standard fixtures and an ADTS clip at every AAC rate.
- The package root: mp3rgain_tpu_torch.__all__ equals mp3rgain_tpu's name
  for name, analyze() agrees, and parallel exports analyze_library.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import mp3rgain_tpu  # noqa: E402
import mp3rgain_tpu_torch  # noqa: E402
from mp3rgain_tpu.decode import frontend as jfe  # noqa: E402
from mp3rgain_tpu.parallel import runner as jpr  # noqa: E402
from mp3rgain_tpu_torch.decode import aac_frontend as af  # noqa: E402
from mp3rgain_tpu_torch.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu_torch.ops import histogram as hi  # noqa: E402
from mp3rgain_tpu_torch.ops import iir  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke  # noqa: E402
from mp3rgain_tpu_torch.testing import tile  # noqa: E402

torch.set_num_threads(2)

DENSE_LIMIT = iir.NB2_DENSE_MAX * iir.L2 * iir.DEFAULT_BLOCK  # samples


def _nb2(n: int) -> int:
    return -(-(-(-n // iir.DEFAULT_BLOCK)) // iir.L2)


def _index(filtered: np.ndarray, sr: int) -> int:
    """Loudness index of (C, T) filtered audio, through the port's
    histogram (exact against the JAX package's, test_torch_iir_histogram)."""
    f = torch.from_numpy(np.ascontiguousarray(filtered))[None]
    hist = hi.histogram(f, torch.tensor([f.shape[-1]]), hi.window_size(sr))
    return int(hi.loudness_index(hist)[0])


# (rate, float32 budget as a share of the peak, index bins allowed)
WHOLE_LENGTH = [(44100, 1e-3, 0), (96000, 1e-2, 1), (8000, 1e-3, 0)]


@pytest.mark.parametrize("sr,f32_tol,bins", WHOLE_LENGTH)
def test_whole_length_past_the_dense_limit_matches_float64_scan(sr, f32_tol, bins):
    n = int(1.1 * DENSE_LIMIT)
    assert _nb2(n) > iir.NB2_DENSE_MAX  # the doubling scan runs
    rng = np.random.default_rng(sr)
    t = np.arange(n) / sr
    wave = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.standard_normal(n)
    x = np.stack([wave, np.roll(wave, 11)]) * 32768.0
    ref = iir.equal_loudness_scan(x, sr).numpy()
    peak = np.abs(ref).max()

    got = iir.equal_loudness(torch.from_numpy(x), sr).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9 * peak)

    got32 = iir.equal_loudness(torch.from_numpy(x.astype(np.float32)), sr).numpy()
    err = np.abs(got32.astype(np.float64) - ref)
    assert err.max() <= f32_tol * peak, err.max() / peak
    # No drift: the tail is no worse than the head (the doubling scan's
    # powers of M^(l2*d) carry the state across the whole track).
    tenth = n // 10
    assert err[:, -tenth:].max() <= max(2 * err[:, :tenth].max(), 1e-5 * peak)
    assert abs(_index(got32, sr) - _index(ref, sr)) <= bins


# --- the tile helper --------------------------------------------------------------


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["test_joint_stereo.mp3", "test_mpeg2_16000.mp3",
                                  "test_vbr.mp3"])
def test_tiled_mp3_decodes_to_copies(tmp_path, name):
    src = _read(os.path.join(smoke.STANDARD_DIR, name))
    dst = tmp_path / "tiled.mp3"
    layout = tile.tile_mp3(src, dst, 3)
    one, three = fe.unpack_data(src), fe.unpack_data(_read(dst))
    assert three.n == 3 * one.n and one.n == layout.frames * layout.channels * (
        2 if layout.samples_per_frame == 1152 else 1)
    for k in range(3):
        rows = slice(k * one.n, (k + 1) * one.n)
        assert np.array_equal(three.spectrum[rows], one.spectrum)
        assert np.array_equal(three.scf[rows], one.scf)
        assert np.array_equal(np.delete(three.info[rows], fe.FRAME, axis=1),
                              np.delete(one.info, fe.FRAME, axis=1))
    light = fe.unpack_data_light_packed(_read(dst))
    assert light.n == three.n
    assert _read(dst) == layout.head + layout.audio * 3 + layout.tail
    assert len(layout.head) < len(src) and layout.tail == b""


def test_tile_refuses_a_stream_that_borrows_from_the_reservoir():
    bench = _read(os.path.join(smoke.DATA_DIR, smoke.BENCH_TRACK))
    layout = tile.mp3_layout(bench)
    pos = 0
    for _ in range(5):  # the sixth audio frame borrows from the reservoir
        pos += tile._mp3_header(layout.audio, pos)[0]
    with pytest.raises(ValueError, match="main_data_begin"):
        tile.mp3_layout(layout.audio[pos:])


@pytest.mark.parametrize("name", ["rate_96000_stereo.aac", "rate_8000_mono.aac"])
def test_tiled_adts_decodes_to_copies(tmp_path, name):
    src = _read(os.path.join(smoke.ADTS_DIR, name))
    layout = tile.tile_adts(src, tmp_path / "tiled.aac", 4)
    one, four = af.unpack_adts_q(src), af.unpack_adts_q(_read(tmp_path / "tiled.aac"))
    assert four.n == 4 * one.n == 4 * layout.frames * layout.channels
    assert np.array_equal(four.qspec, np.tile(one.qspec, (4, 1)))
    assert np.array_equal(four.lvl, np.tile(one.lvl, (4, 1)))
    assert np.array_equal(four.btype, np.tile(one.btype, (4, 1)))
    assert (layout.sample_rate, layout.channels) == (one.sample_rate, one.n_channels)
    with pytest.raises(ValueError):
        tile.adts_layout(src[:-3])


@pytest.fixture(scope="module")
def tiled_8k(tmp_path_factory):
    """The 8 kHz MPEG-2.5 fixture tiled to 3,000 samples past the dense
    limit, and the JAX package's host-decoded route on it (CPU, XLA)."""
    src = _read(os.path.join(smoke.STANDARD_DIR, "test_mpeg25_8000.mp3"))
    path = tmp_path_factory.mktemp("tiled") / "tiled_8k.mp3"
    layout = tile.mp3_layout(src)
    copies = tile.copies_for(layout, DENSE_LIMIT + 3000)
    tile.tile_mp3(src, path, copies)
    data = _read(path)
    ju = jfe.unpack_data(data)
    run = jpr._single_device_pipeline(1, 8000, jnp.float32)
    want = tuple(np.asarray(a) for a in run(*jpr.prepare_batch_arrays([ju], 1)))
    return data, copies * layout.samples, want


def _assert_close_to_jax(hist, loud_idx, peak, want):
    h, li, pk = want
    assert int(hist[0].sum()) == int(h[0].sum())
    assert abs(int(loud_idx[0]) - int(li[0])) <= 2, (loud_idx[0], li[0])
    np.testing.assert_allclose(peak[0], pk[0], rtol=2e-4, atol=1e-6)


def test_tiled_8k_track_past_the_dense_limit_matches_jax(tiled_8k):
    data, samples, want = tiled_8k
    assert DENSE_LIMIT < samples <= DENSE_LIMIT + 3000 + 9216
    runner = pr.Runner("cpu")
    light = fe.unpack_data_light_packed(data)
    hist, louds, peaks = runner.analyze_unpacked_light([light], 8000, 1)
    _assert_close_to_jax(hist, [round(louds[0] * 100) + 2000], peaks, want)
    full = fe.unpack_data(data)
    h_hist, h_louds, h_peaks = runner.analyze_unpacked([full], 8000, 1)
    _assert_close_to_jax(h_hist, [round(h_louds[0] * 100) + 2000], h_peaks, want)
    assert int(hist[0].sum()) == int(h_hist[0].sum()) == -(-samples // 400)


# --- the committed inputs -------------------------------------------------------------


def test_committed_inputs_cover_every_rate():
    mp3 = {}
    for p in smoke.standard_paths():
        layout = tile.mp3_layout(_read(p))
        mp3[os.path.basename(p)] = (layout.sample_rate, layout.channels)
    assert len(mp3) == 12
    assert {sr for sr, _ in mp3.values()} == {8000, 11025, 12000, 16000, 22050, 24000,
                                              32000, 44100, 48000}
    adts = {}
    for sr, ch, _ in smoke.ADTS_RATES:
        layout = tile.adts_layout(_read(os.path.join(smoke.ADTS_DIR,
                                                     smoke.adts_rate_name(sr, ch))))
        adts[sr] = (layout.sample_rate, layout.channels)
        assert adts[sr] == (sr, ch) and 3.0 <= layout.samples / sr < 3.5  # + codec delay
    committed = {22050, 44100}  # mono_3s_22k_48k.aac and the M4A clips
    assert set(adts) | committed == set(af.ADTS_SR_INDEX)
    assert set(adts) & committed == set()


# --- the package root ---------------------------------------------------------------


def test_package_root_exports_the_reference_api():
    assert mp3rgain_tpu_torch.__all__ == mp3rgain_tpu.__all__
    for name in mp3rgain_tpu_torch.__all__:
        assert hasattr(mp3rgain_tpu_torch, name), name
    assert mp3rgain_tpu_torch.__version__ == mp3rgain_tpu.__version__
    assert mp3rgain_tpu_torch.TAG_REPLAYGAIN_TRACK_GAIN == mp3rgain_tpu.TAG_REPLAYGAIN_TRACK_GAIN
    assert mp3rgain_tpu_torch.apply_gain.__module__ == "mp3rgain_tpu_torch.bitstream"
    assert mp3rgain_tpu_torch.read_ape_tag.__module__ == "mp3rgain_tpu_torch.ape"


@pytest.mark.parametrize("name", ["test_vbr.mp3", "test_mpeg25_12000.mp3"])
def test_package_root_analyze_equals_the_jax_package(name):
    p = os.path.join(smoke.STANDARD_DIR, name)
    assert (dataclasses.asdict(mp3rgain_tpu_torch.analyze(p))
            == dataclasses.asdict(mp3rgain_tpu.analyze(p)))


def test_parallel_exports_the_runner_api():
    from mp3rgain_tpu_torch.parallel import BatchResult, Runner, RunnerGroup, analyze_library

    assert (BatchResult, Runner, RunnerGroup, analyze_library) == (
        pr.BatchResult, pr.Runner, pr.RunnerGroup, pr.analyze_library)
    import mp3rgain_tpu_torch.parallel as par

    assert sorted(par.__all__) == ["BatchResult", "Runner", "RunnerGroup",
                                   "analyze_library"]
    with pytest.raises(AttributeError):
        par.MeshRunner  # noqa: B018
