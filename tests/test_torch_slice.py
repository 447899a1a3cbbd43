"""Torch port: the light-path slice end to end against the JAX package.

The port's light_tail and Runner.analyze_unpacked_light (plain kernels on
the CPU) against the JAX package's _light_tail with fused=True and with
fused=False, on the same prepared batches: per-track window counts
exactly equal, loudness index within 2 histogram bins and peak within
rtol 2e-4 — the tolerances of tests/test_hybrid_kernel.py (GEMM
summation order and transcendental rounding differ). The port's unfused
light tail (fused=False, the host-decoded route's analysis_tail) is held
to the JAX package's fused=False tail the same way. Batches: 44.1 kHz
joint stereo (2 tracks) and 22.05 kHz mono MPEG-2.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mp3rgain_tpu.decode import entropy_kernel as jek  # noqa: E402
from mp3rgain_tpu.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu.parallel import runner as jpr  # noqa: E402
from mp3rgain_tpu.testing import fixtures  # noqa: E402
from mp3rgain_tpu.utils import bufpool  # noqa: E402
from mp3rgain_tpu_torch import tracing  # noqa: E402
from mp3rgain_tpu_torch.decode import entropy_kernel as ek  # noqa: E402
from mp3rgain_tpu_torch.decode import hybrid_kernel as hk  # noqa: E402
from mp3rgain_tpu_torch.ops import histogram as hi  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402

torch.set_num_threads(2)


def _mp3(sr, mode, bitrate, ch, seed, seconds=0.5):
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    wave = 0.4 * np.sin(2 * np.pi * (330 + 60 * seed) * np.arange(n) / sr)
    wave += 0.12 * rng.standard_normal(n)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    if ch == 2:
        pcm = np.stack([pcm, np.roll(pcm, 7)], axis=1)
    return fixtures.encode_mp3(pcm, sr, bitrate=bitrate, mode=mode)


BATCHES = {
    "stereo_joint_44k": lambda: [_mp3(44100, fixtures.MODE_JOINT, 128, 2, 1),
                                 _mp3(44100, fixtures.MODE_JOINT, 192, 2, 2)],
    "mono_mpeg2_22k": lambda: [_mp3(22050, fixtures.MODE_MONO, 48, 1, 3)],
}


@pytest.fixture(scope="module")
def batches():
    """Per batch: the light-unpacked tracks and the JAX package's
    (hist, loud_idx, peak) for fused=False and fused=True."""
    out = {}
    for name, make in BATCHES.items():
        ups = [fe.unpack_data_light_packed(d) for d in make()]
        sr, nch = ups[0].sample_rate, ups[0].n_channels
        prep, rest, g_max = jpr.prepare_batch_arrays_light(ups, nch, 1)
        spec_b, mout = jek.decode_blocks(
            jnp.asarray(prep.scalars), jnp.asarray(prep.buf),
            jnp.asarray(prep.meta), nb=prep.nb, interpret=True)
        jax_out = {}
        for fused in (False, True):
            hist, loud_idx, peak = jpr._light_tail(
                spec_b, mout, jnp.asarray(prep.inv),
                *(jnp.asarray(a) for a in rest),
                nb=prep.nb, g_max=g_max, n_channels=nch, sample_rate=sr,
                dtype=jnp.float32, fused=fused, interpret=True)
            jax_out[fused] = (np.asarray(hist), np.asarray(loud_idx),
                              np.asarray(peak))
        bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
        out[name] = (ups, sr, nch, jax_out)
    return out


def _assert_close_to_jax(hist, loud_idx, peak, want, bsz):
    h, li, pk = want
    assert np.array_equal(hist[:bsz].sum(axis=1), h[:bsz].sum(axis=1))
    assert np.all(np.abs(loud_idx[:bsz].astype(np.int64) - li[:bsz]) <= 2), (
        loud_idx[:bsz], li[:bsz])
    np.testing.assert_allclose(peak[:bsz], pk[:bsz], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_light_tail_matches_jax(batches, name, fused):
    ups, sr, nch, jax_out = batches[name]
    cpu = torch.device("cpu")
    prep, rest, g_max = pr.prepare_batch_arrays_light(ups, nch, 1)
    host = (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest)
    args = [pr._to_device(a, cpu) for a in host]
    bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
    tail = pr.LightTail(sr, nch)
    with tracing.recording():
        hist, loud_idx, peak = pr.analysis_core_light(
            tail, *args, nb=prep.nb, g_max=g_max)
    assert (tracing.counter("plain.entropy_decode_rows"),
            tracing.counter("plain.requant_stereo")) == (1, 1)
    assert hist.dtype == torch.int32 and loud_idx.dtype == torch.int32
    assert hist.shape == (len(rest[0]), hi.HISTOGRAM_SIZE)
    _assert_close_to_jax(hist.numpy(), loud_idx.numpy(), peak.numpy(),
                         jax_out[fused], len(ups))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_light_tail_unfused_matches_jax(batches, name):
    ups, sr, nch, jax_out = batches[name]
    cpu = torch.device("cpu")
    prep, rest, g_max = pr.prepare_batch_arrays_light(ups, nch, 1)
    host = (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest)
    args = [pr._to_device(a, cpu) for a in host]
    bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
    tail = pr.LightTail(sr, nch)
    dest, n_rows = pr.dest_rows(args[3], args[4], g_max=g_max, n_channels=nch,
                                channel_major=False)
    rows = ek.decode_rows(*args[:3], tail.luts, dest, n_rows)
    with tracing.recording():
        hist, loud_idx, peak = pr.light_tail(tail, *rows, *args[4:],
                                             nb=prep.nb, g_max=g_max, fused=False)
    assert (tracing.counter("plain.requant_stereo"),
            tracing.counter("plain.class_core_gemm")) == (0, 1)
    _assert_close_to_jax(hist.numpy(), loud_idx.numpy(), peak.numpy(),
                         jax_out[False], len(ups))


def test_main_path_stages_and_no_unsort_after_k1(batches, monkeypatch):
    """After K1 (decode_rows) the main path never unsorts or re-gathers
    the spectra: K1's channel-major rows go to K2 as they are. Also the
    stage names analysis_core_light reports, in order."""
    ups, sr, nch, _ = batches["stereo_joint_44k"]
    prep, rest, g_max = pr.prepare_batch_arrays_light(ups, nch, 1)
    args = [pr._to_device(a, torch.device("cpu"))
            for a in (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest)]
    bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
    tail = pr.LightTail(sr, nch)
    seen = {}
    real_decode, real_k2 = ek.decode_rows, hk.fused_requant_stereo

    def decode_rows(*a):
        out = real_decode(*a)  # the plain version unsorts inside K1's contract

        def boom(*_a, **_k):
            raise AssertionError("unsort after K1")

        monkeypatch.setattr(ek, "unsort_blocks", boom)
        monkeypatch.setattr(ek, "decode_blocks_reference", boom)
        seen["rows"] = out[0]
        return out

    def k2(spec, *rest_):
        seen["k2_spec"] = spec
        return real_k2(spec, *rest_)

    monkeypatch.setattr(ek, "decode_rows", decode_rows)
    monkeypatch.setattr(hk, "fused_requant_stereo", k2)
    stages = []
    pr.analysis_core_light(tail, *args, nb=prep.nb, g_max=g_max, on_stage=stages.append)
    assert stages == ["row map", "K1", "gathers", "K2", "hybrid GEMMs",
                      "overlap-add + polyphase", "peak", "IIR", "histogram + index"]
    # K2 reads K1's rows in place: a view of the same storage.
    assert seen["k2_spec"].data_ptr() == seen["rows"].data_ptr()
    assert seen["k2_spec"].shape == (nch, seen["rows"].shape[0] // nch, 576)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_runner_matches_jax(batches, name):
    ups, sr, nch, jax_out = batches[name]
    runner = pr.Runner("cpu")
    hist, louds, peaks = runner.analyze_unpacked_light(ups, sr, nch)
    bsz = len(ups)
    assert hist.shape == (bsz, hi.HISTOGRAM_SIZE)
    idx = np.array([round(v * 100) + 2000 for v in louds])
    for fused in (False, True):
        _assert_close_to_jax(hist, idx, peaks, jax_out[fused], bsz)
    t = runner.timings[-1]
    assert set(t) == {"route", "prep_s", "h2d_s", "device_ms"} and t["route"] == "light"
    assert list(runner.timings) == [t]
    assert all(t[k] >= 0 for k in ("prep_s", "h2d_s", "device_ms"))
    # The Runner reuses one LightTail per format.
    assert runner.tail(sr, nch) is runner.tail(sr, nch)


def test_rowmap_and_scf_expansion_match_jax():
    rng = np.random.default_rng(0)
    counts = np.array([5, 0, 3, 7], np.int32)
    want = np.asarray(jpr._rowmap_from_counts(jnp.asarray(counts), 9, 40))
    got = pr._rowmap_from_counts(torch.from_numpy(counts), 9, 40)
    assert np.array_equal(got.numpy(), want)
    npad = 32
    scf = rng.integers(0, 256, (npad, fe.SCF_MAIN_BYTES)).astype(np.uint8)
    srow = np.array([3, 9, 30, npad, npad], np.int32)
    sdata = rng.integers(0, 256, (5, fe.SCF_SIDE_BYTES)).astype(np.uint8)
    sdata[3:] = 0
    hrow = np.array([9, npad], np.int32)
    hdata = np.zeros((2, fe.SCF_HI_BYTES), np.uint8)
    hdata[0] = rng.integers(0, 256, fe.SCF_HI_BYTES)
    want = np.asarray(jpr._expand_scf_flat(*(jnp.asarray(a) for a in (
        scf, srow, sdata, hrow, hdata))))
    got = pr._expand_scf_flat(*(torch.from_numpy(a) for a in (
        scf, srow, sdata, hrow, hdata)))
    assert np.array_equal(got.numpy(), want)
