"""Torch port: the host-decoded ("heavy") route against the JAX package.

- Host packer and device unpacking, bit-identical: prepare_batch_arrays,
  _unpack_spectrum (also equal to the host decoder's spectra),
  _derive_fields, _expand_info_light and batch_from_unpacked's fields.
- decode_file (plain kernels on the CPU, K3 in bf16x3) against the JAX
  package's decode_file and libmpg123 on LSF, short-block, intensity and
  mixed-block content: max|err| < 5e-4·rms_ref + 1e-5, the bound
  tests/test_decoder.py holds the JAX package's own bf16x3 device decode
  to (JAX on the CPU runs these products in f32).
- analysis_core / Runner.analyze_unpacked against the JAX package's
  _analysis_core on a 44.1 kHz joint-stereo batch and a 22.05 kHz mono
  MPEG-2 batch: window counts equal, loudness index within 2 bins, peak
  within rtol 2e-4 (bf16x3 and transcendental rounding differ).
- light_tail(fused=False) equals the heavy route exactly in the port,
  as tests/test_light_pipeline.py holds the JAX package's two routes.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mp3rgain_tpu.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu.decode import synthesis as jsyn  # noqa: E402
from mp3rgain_tpu.parallel import runner as jpr  # noqa: E402
from mp3rgain_tpu.testing import craft, fixtures, mpg123  # noqa: E402
from mp3rgain_tpu.utils import bufpool  # noqa: E402
from mp3rgain_tpu_torch.decode import class_core as cc  # noqa: E402
from mp3rgain_tpu_torch.decode import synthesis as syn  # noqa: E402
from mp3rgain_tpu_torch.ops import histogram as hi  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _mp3(sr, mode, bitrate, ch, seed, seconds=0.5):
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    wave = 0.4 * np.sin(2 * np.pi * (330 + 60 * seed) * np.arange(n) / sr)
    wave += 0.12 * rng.standard_normal(n)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    if ch == 2:
        pcm = np.stack([pcm, np.roll(pcm, 7)], axis=1)
    return fixtures.encode_mp3(pcm, sr, bitrate=bitrate, mode=mode)


def _transient(sr=44100, seconds=0.5):
    """Decaying 3 kHz bursts in noise: the encoder switches to short blocks."""
    rng = np.random.default_rng(21)
    n = int(sr * seconds)
    wave = 0.02 * rng.standard_normal(n)
    for pos in range(800, n - 900, 2500):
        wave[pos : pos + 300] += 0.8 * np.sin(
            2 * np.pi * 3000 * np.arange(300) / sr) * np.exp(-np.arange(300) / 60.0)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    return fixtures.encode_mp3(np.stack([pcm, np.roll(pcm, 3)], axis=1), sr,
                               bitrate=128, mode=fixtures.MODE_STEREO)


BATCHES = {
    "stereo_joint_44k": ([(44100, fixtures.MODE_JOINT, 128, 2, 1),
                          (44100, fixtures.MODE_JOINT, 192, 2, 2)], 44100, 2),
    "mono_mpeg2_22k": ([(22050, fixtures.MODE_MONO, 48, 1, 3)], 22050, 1),
}

CLIPS = {
    "joint_44k": lambda: _mp3(44100, fixtures.MODE_JOINT, 160, 2, 4),
    "mono_lsf_22k": lambda: _mp3(22050, fixtures.MODE_MONO, 48, 1, 5),
    "transient_short_44k": _transient,
    "craft_intensity": craft.craft_intensity_stream,
    "craft_mixed_block": craft.craft_mixed_block_stream,
    "craft_lsf_intensity": craft.craft_lsf_intensity_stream,
}


@pytest.fixture(scope="module")
def batches():
    """Per batch: the MP3 bytes and the JAX package's heavy-route
    (hist, loud_idx, peak)."""
    out = {}
    for name, (specs, sr, nch) in BATCHES.items():
        datas = [_mp3(*s) for s in specs]
        args = jpr.prepare_batch_arrays([fe.unpack_data(d) for d in datas], nch)
        run = jpr._single_device_pipeline(nch, sr, jnp.float32)
        out[name] = (datas, sr, nch, tuple(np.asarray(a) for a in run(*args)))
    return out


@pytest.fixture(scope="module")
def clip_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("heavy_clips")
    paths = {}
    for name, make in CLIPS.items():
        paths[name] = root / f"{name}.mp3"
        paths[name].write_bytes(make())
    return paths


def test_prepare_batch_arrays_bit_identical(batches):
    for datas, _, nch, _ in batches.values():
        ups = [fe.unpack_data(d) for d in datas]
        for pad in (1, 4):
            mine = pr.prepare_batch_arrays(ups, nch, pad)
            want = jpr.prepare_batch_arrays(ups, nch, pad)
            assert len(mine) == len(want)
            for a, b in zip(mine, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_unpack_spectrum_matches_jax_and_host(batches):
    datas = batches["stereo_joint_44k"][0] + [_mp3(44100, fixtures.MODE_STEREO, 320, 2, 9)]
    ups = [fe.unpack_data(d) for d in datas]
    spec_i8, esc_idx, esc_val = pr.prepare_batch_arrays(ups, 2)[:3]
    assert (esc_idx < 576).any(), "the batch carries escapes"
    got = pr._unpack_spectrum(*(torch.from_numpy(a) for a in (spec_i8, esc_idx, esc_val)))
    want = np.asarray(jpr._unpack_spectrum(spec_i8, esc_idx, esc_val))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for b, u in enumerate(ups):
        assert np.array_equal(got[b, : u.n].numpy(), u.spectrum)
        assert not got[b, u.n :].any()
    # A dense synthetic sideband: several escapes per row, padded slots.
    rng = np.random.default_rng(2)
    spec_i8 = rng.integers(-127, 128, (2, 6, 192)).astype(np.int8)
    esc_idx = np.full((2, 6, 8), 576, np.int16)
    esc_val = np.zeros((2, 6, 8), np.int16)
    for b in range(2):
        for g in range(6):
            k = rng.integers(0, 9)
            esc_idx[b, g, :k] = rng.choice(192, k, replace=False)
            esc_val[b, g, :k] = rng.integers(128, 8207, k) * rng.choice([-1, 1], k)
    got = pr._unpack_spectrum(*(torch.from_numpy(a) for a in (spec_i8, esc_idx, esc_val)))
    want = np.asarray(jpr._unpack_spectrum(spec_i8, esc_idx, esc_val))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_channels", [1, 2])
def test_derive_fields_and_info_expansion_match_jax(n_channels):
    rng = np.random.default_rng(n_channels)
    info = rng.integers(0, 4, (2, 12, fe.INFO_N)).astype(np.int32)
    info[..., fe.BIG_END] = rng.integers(0, 577, (2, 12))
    info[..., fe.COUNT1_END] = rng.integers(0, 577, (2, 12))
    info[..., fe.GLOBAL_GAIN] = rng.integers(0, 256, (2, 12))
    spec = rng.integers(-5, 5, (2, 12, 576)).astype(np.int32)
    scf = rng.integers(0, 16, (2, 12, 64)).astype(np.int8)
    want = jpr._derive_fields(jnp.asarray(spec), jnp.asarray(scf), jnp.asarray(info),
                              n_channels=n_channels)
    got = pr._derive_fields(torch.from_numpy(spec), torch.from_numpy(scf),
                            torch.from_numpy(info), n_channels=n_channels)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    packed = fe.pack_info_light(info.reshape(-1, fe.INFO_N)).reshape(2, 12, fe.IP_N)
    want = np.asarray(jpr._expand_info_light(jnp.asarray(packed)))
    got = pr._expand_info_light(torch.from_numpy(packed.view(np.int16)).to(torch.int32) & 0xFFFF)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["joint_44k", "mono_lsf_22k", "craft_intensity"])
def test_batch_from_unpacked_fields_match_jax(clip_paths, name):
    u = fe.unpack_file(clip_paths[name])
    mine = syn.batch_from_unpacked(u, "cpu")
    want = jsyn.batch_from_unpacked(u)
    assert mine.n_channels == want.n_channels
    for field in jsyn.GranuleBatch.__dataclass_fields__:
        if field == "n_channels":
            continue
        a, b = getattr(mine, field), np.asarray(getattr(want, field))
        assert a.shape == (1,) + b.shape, field
        assert a.numpy().dtype == b.dtype and np.array_equal(a[0].numpy(), b), field


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_decode_file_matches_jax_and_mpg123(clip_paths, name):
    path = clip_paths[name]
    before = cc.COUNT.plain
    mine, sr = syn.decode_file(path, device="cpu")
    assert cc.COUNT.plain == before + 1
    ref, sr_ref = jsyn.decode_file(path)
    oracle, sr_m = mpg123.decode_file(path)
    oracle = oracle.T
    assert sr == sr_ref == sr_m
    assert mine.dtype == np.float32 and mine.shape == ref.shape == oracle.shape
    for want in (ref, oracle):
        bound = 5e-4 * np.sqrt((want ** 2).mean()) + 1e-5
        assert np.abs(mine - want).max() < bound, (name, np.abs(mine - want).max(), bound)


def test_decode_batch_keeps_tracks_apart(clip_paths):
    """Two tracks decoded as one batch equal each decoded alone: the
    overlap-add and polyphase shifts start every track from zeros."""
    u = fe.unpack_file(clip_paths["joint_44k"])
    full = syn.batch_from_unpacked(u, "cpu")
    # A loud middle segment as the track, so its last granule-time hands
    # a large overlap tail to whatever follows it.
    t = u.n // 2
    seg = slice(2 * (t // 4), 2 * (3 * t // 4))
    fields = [getattr(full, k)[:, seg] for k in syn.GranuleBatch.__dataclass_fields__
              if k != "n_channels"]
    one = syn.GranuleBatch(*fields, n_channels=2)
    two = syn.GranuleBatch(*(torch.cat([f, f]) for f in fields), n_channels=2)
    tables = syn.DecodeTables(int(u.info[0, fe.SR_ROW]))
    alone = syn.decode_batch(one, tables)
    both = syn.decode_batch(two, tables)
    assert both.shape == (2,) + alone.shape[1:]
    scale = alone.abs().max().item()
    assert alone[..., -576:].abs().max().item() > 0.1 * scale
    for b in range(2):
        torch.testing.assert_close(both[b : b + 1], alone, rtol=1e-5, atol=1e-6 * scale)


def _assert_close_to_jax(hist, loud_idx, peak, want, bsz):
    h, li, pk = want
    assert np.array_equal(hist[:bsz].sum(axis=1), h[:bsz].sum(axis=1))
    assert np.all(np.abs(loud_idx[:bsz].astype(np.int64) - li[:bsz]) <= 2), (
        loud_idx[:bsz], li[:bsz])
    np.testing.assert_allclose(peak[:bsz], pk[:bsz], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_analysis_core_matches_jax(batches, name):
    datas, sr, nch, want = batches[name]
    ups = [fe.unpack_data(d) for d in datas]
    args = [pr._to_device(a, CPU) for a in pr.prepare_batch_arrays(ups, nch)]
    tail = pr.LightTail(sr, nch)
    before = cc.COUNT.plain
    hist, loud_idx, peak = pr.analysis_core(tail, *args)
    assert cc.COUNT.plain == before + 1
    assert hist.dtype == torch.int32 and loud_idx.dtype == torch.int32
    assert hist.shape == (len(args[-1]), hi.HISTOGRAM_SIZE)
    _assert_close_to_jax(hist.numpy(), loud_idx.numpy(), peak.numpy(), want, len(ups))

    runner = pr.Runner("cpu")
    r_hist, louds, peaks = runner.analyze_unpacked(ups, sr, nch)
    assert isinstance(r_hist, np.ndarray)  # read back to the host
    assert np.array_equal(r_hist, hist[: len(ups)].numpy())
    assert np.array_equal(np.array([round(v * 100) + 2000 for v in louds]),
                          loud_idx[: len(ups)].numpy())
    assert np.array_equal(peaks, peak[: len(ups)].numpy())
    assert set(runner.last_timings) == {"route", "prep_s", "h2d_s", "device_ms"}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_light_unfused_equals_heavy_exactly(batches, name):
    datas, sr, nch, _ = batches[name]
    tail = pr.LightTail(sr, nch)
    ups = [fe.unpack_data_light_packed(d) for d in datas]
    prep, rest, g_max = pr.prepare_batch_arrays_light(ups, nch, 1)
    host = (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest)
    args = [pr._to_device(a, CPU) for a in host]
    bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
    light = pr.analysis_core_light(tail, *args, nb=prep.nb, g_max=g_max, fused=False)
    heavy_args = pr.prepare_batch_arrays([fe.unpack_data(d) for d in datas], nch)
    heavy = pr.analysis_core(tail, *(pr._to_device(a, CPU) for a in heavy_args))
    for a, b in zip(light, heavy):
        assert a.shape == b.shape and torch.equal(a, b)
