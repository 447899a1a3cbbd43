"""Torch port: fused requantize + stereo (K2) and the hybrid GEMMs.

On the CPU, fused_requant_stereo runs its plain torch version; it must
equal the JAX Pallas kernel (interpret mode) on the same channel-major
inputs within rtol 1e-5 and atol 1e-6·max|ref| — XLA's and ATen's
exp2/log2/tan differ by ulps. Inputs come from real streams (joint
stereo, mono MPEG-2, short/mixed blocks, MPEG-1 and LSF intensity)
through the port's decode and gathers. tests/test_torch_cuda.py holds
the CUDA kernel to its plain version on a card.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mp3rgain_tpu.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu.decode import hybrid_kernel as jhk  # noqa: E402
from mp3rgain_tpu.decode.format_tables import SR_ROW  # noqa: E402
from mp3rgain_tpu.testing import craft, fixtures  # noqa: E402
from mp3rgain_tpu.utils import bufpool  # noqa: E402
from mp3rgain_tpu_torch import tracing  # noqa: E402
from mp3rgain_tpu_torch.decode import entropy_kernel as ek  # noqa: E402
from mp3rgain_tpu_torch.decode import hybrid_kernel as hk  # noqa: E402
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


def _short_blocks():
    sr = 44100
    rng = np.random.default_rng(9)
    n = int(sr * 0.5)
    wave = 0.02 * rng.standard_normal(n)
    for pos in range(800, n - 900, 2500):
        wave[pos : pos + 300] += 0.8 * np.sin(
            2 * np.pi * 3000 * np.arange(300) / sr
        ) * np.exp(-np.arange(300) / 60.0)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    pcm = np.stack([pcm, np.roll(pcm, 3)], axis=1)
    return fixtures.encode_mp3(pcm, sr, bitrate=128, mode=fixtures.MODE_STEREO)


def k2_inputs(datas):
    """K2's channel-major inputs for a batch of same-format streams, via
    the port's prep, plain decode and gathers (CPU)."""
    ups = [fe.unpack_data_light_packed(d) for d in datas]
    sr, nch = ups[0].sample_rate, ups[0].n_channels
    prep, rest, g_max = pr.prepare_batch_arrays_light(ups, nch)
    host = (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest)
    dev = [pr._to_device(a, torch.device("cpu")) for a in host]
    bufpool.give(prep.buf, prep.meta, rest[1], rest[6])
    dest, n_rows = pr.dest_rows(dev[3], dev[4], g_max=g_max, n_channels=nch,
                                channel_major=True)
    rows = ek.decode_rows(*dev[:3], ek.EntropyLuts(), dest, n_rows)
    spec, scf, gmeta = pr.channel_major_inputs(
        *rows, *dev[4:11], nb=prep.nb, g_max=g_max, n_channels=nch)
    return spec, scf, gmeta, SR_ROW[sr]


CASES = {
    "stereo_joint": lambda: [_mp3(44100, fixtures.MODE_JOINT, 128, 2, 1),
                             _mp3(44100, fixtures.MODE_JOINT, 192, 2, 2)],
    "mono_mpeg2": lambda: [_mp3(22050, fixtures.MODE_MONO, 48, 1, 3)],
    "short_blocks": lambda: [_short_blocks()],
    "mixed_blocks": lambda: [craft.craft_mixed_block_stream()],
    "intensity": lambda: [craft.craft_intensity_stream()],
    "lsf_intensity": lambda: [craft.craft_lsf_intensity_stream()],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_requant_stereo_matches_jax(case):
    spec, scf, gmeta, sr_row = k2_inputs(CASES[case]())
    nch, r, _ = spec.shape
    with tracing.recording():
        got = hk.fused_requant_stereo(spec, scf, gmeta, hk.HybridTables(sr_row))
    assert tracing.counter("plain.requant_stereo") == 1
    # The JAX kernel takes 256-row tiles: pad with zero rows (zero output).
    rp = -(-r // jhk.TILE) * jhk.TILE
    pad = ((0, 0), (0, rp - r), (0, 0))
    want = np.asarray(jhk.fused_requant_stereo(
        jnp.asarray(np.pad(spec.numpy(), pad)),
        jnp.asarray(np.pad(scf.numpy(), pad)),
        jnp.asarray(np.pad(gmeta.numpy(), pad)),
        n_channels=nch, sr_row=sr_row, interpret=True))[:, :r]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_inputs_cover_classes_and_stereo_modes():
    """The cases above reach every layout class and stereo mode."""
    seen = {}
    for case, make in CASES.items():
        _, _, gmeta, _ = k2_inputs(make())
        g = gmeta.reshape(-1, hk.GM_N)
        seen[case] = {
            "cls": set(g[:, hk.GM_CLS].unique().tolist()),
            "ms": bool((g[:, hk.GM_MS] == 1).any()),
            "is": bool((g[:, hk.GM_IS] == 1).any()),
            "lsf": bool((g[:, hk.GM_LSF] == 1).any()),
        }
    assert set().union(*(s["cls"] for s in seen.values())) == {0, 1, 2}
    assert seen["stereo_joint"]["ms"]
    assert seen["intensity"]["is"] and not seen["intensity"]["lsf"]
    assert seen["lsf_intensity"]["is"] and seen["lsf_intensity"]["lsf"]


def test_hybrid_gemm_matches_jax():
    spec, scf, gmeta, sr_row = k2_inputs(CASES["short_blocks"]())
    tables = hk.HybridTables(sr_row)
    xr = hk.fused_requant_stereo_reference(spec, scf, gmeta, tables)
    got = hk.hybrid_gemm(xr, gmeta, tables).numpy()
    want = np.asarray(jhk.hybrid_xla(jnp.asarray(xr.numpy()),
                                     jnp.asarray(gmeta.numpy()),
                                     sr_row=sr_row))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_ratio_table_matches_formula():
    """The CUDA kernel's intensity-ratio table holds the plain version's
    per-element formula at every integer is_pos."""
    table = torch.from_numpy(hk.is_ratio_table())
    for lsf in (0, 1):
        for isc in (0, 1):
            is_pos = torch.arange(hk.IS_POS_N, dtype=torch.float32)
            kl, kr = hk._is_ratios(is_pos, torch.tensor(bool(lsf)),
                                   torch.tensor(bool(isc)))
            assert torch.equal(table[lsf, isc, :, 0], kl)
            assert torch.equal(table[lsf, isc, :, 1], kr)


def _field(words: np.ndarray, field) -> np.ndarray:
    shift, bits = field
    return (words >> shift) & ((1 << bits) - 1)


@pytest.mark.parametrize("sr_row", range(9))
def test_class_words_unpack_to_jax_consts(sr_row):
    """The kernel's one word per (class, sample) unpacks bit-exactly to the
    JAX package's per-class tables: slot and window of the one-hot
    expansions (none = all-zero column), pretab, band start, short flag."""
    words = hk.HybridTables(sr_row).class_words.numpy()
    assert words.shape == (3, 576) and words.dtype == np.int32
    assert 0 <= words.min() and words.max() < (1 << 22)
    slot, win, pretab, band_start, short = jhk._consts(sr_row)
    for c in range(3):
        for field, onehot in ((hk.CW_SLOT, slot[c]), (hk.CW_WIN, win[c])):
            idx = _field(words[c], field)  # index + 1, 0 = none
            rebuilt = np.zeros_like(onehot)
            has = idx > 0
            rebuilt[idx[has] - 1, np.nonzero(has)[0]] = 1
            assert np.array_equal(rebuilt, onehot), (sr_row, c, field)
        for field, want in ((hk.CW_PRETAB, pretab[c]),
                            (hk.CW_BAND_START, band_start[c]),
                            (hk.CW_SHORT, short[c])):
            assert np.array_equal(_field(words[c], field).astype(want.dtype), want), (
                sr_row, c, field)


def test_class_words_reject_values_that_do_not_fit():
    slot, win, pretab, band_start, short = hk._consts(0)
    args = [np.full((3, 576), -1), np.full((3, 576), -1), pretab, band_start, short]
    hk.pack_class_words(*args)
    for i, bad in ((0, 127), (1, 3), (2, 4.0), (3, 1024.0), (4, 0.5)):
        wrong = list(args)
        wrong[i] = np.full((3, 576), bad)
        with pytest.raises(ValueError, match="does not fit"):
            hk.pack_class_words(*wrong)


def test_wrapper_rejects_bad_inputs():
    spec, scf, gmeta, sr_row = k2_inputs(CASES["mono_mpeg2"]())
    tables = hk.HybridTables(sr_row)
    with pytest.raises(ValueError, match="scf"):
        hk.fused_requant_stereo(spec, scf.to(torch.int32), gmeta, tables)
    with pytest.raises(ValueError, match="gmeta"):
        hk.fused_requant_stereo(spec, scf, gmeta[:, :-1], tables)
    with tracing.recording(), pytest.raises(ValueError, match="unsupported device"):
        hk.fused_requant_stereo(spec.to("meta"), scf.to("meta"),
                                gmeta.to("meta"), tables)
    assert tracing.counter("plain.requant_stereo") == 0
