"""Torch port: the Huffman decode (K1) against the JAX package.

The plain lockstep decode (decode_blocks_reference): spec_b and all 8
mout rows must equal the JAX Pallas kernel's (interpret mode) exactly, on
the same prepared inputs. After unsort_blocks the spectra must equal the
host decoder (mg_mp3_unpack) exactly, as tests/test_entropy_kernel.py
holds the JAX kernel. decode_rows (on the CPU, decode_rows_reference)
must equal the JAX package's own composition exactly: its kernel, its
unsort_blocks, its row-map gather, and for the fused tail the
channel-major reshape. The CUDA kernel is held to the plain version on a
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mp3rgain_tpu.decode import entropy_kernel as jek  # noqa: E402
from mp3rgain_tpu.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu.parallel import runner as jpr  # noqa: E402
from mp3rgain_tpu.testing import craft, fixtures  # noqa: E402
from mp3rgain_tpu_torch import _build, tracing  # noqa: E402
from mp3rgain_tpu_torch.decode import entropy_kernel as ek  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402

torch.set_num_threads(2)

# One ragged-buffer length for every case (enough for any nb=1 batch), so
# the JAX interpret-mode kernel compiles once for the whole module.
G_PAD = 320


@pytest.fixture(scope="module")
def luts():
    return ek.EntropyLuts()


def _prep(data: bytes):
    light = fe.unpack_data_light(data)
    return light, ek.prepare_batch(light.md, light.meta, force_g_pad=G_PAD)


def _tensors(p):
    return (torch.from_numpy(p.scalars), torch.from_numpy(p.buf),
            torch.from_numpy(p.meta.view(np.int16)))


def _check(data: bytes, label: str, luts, host: bool = True):
    light, p = _prep(data)
    if light.n == 0:
        return
    assert p.nb == 1
    js, jm = jek.decode_blocks(jnp.asarray(p.scalars), jnp.asarray(p.buf),
                               jnp.asarray(p.meta), nb=p.nb, interpret=True)
    spec_b, mout = ek.decode_blocks_reference(*_tensors(p), luts)
    assert spec_b.dtype == torch.int16 and mout.dtype == torch.int32
    js, jm = np.asarray(js), np.asarray(jm)
    bad = np.nonzero((spec_b.numpy() != js).any(axis=1))
    assert bad[0].size == 0, f"{label}: spec_b differs at lanes {bad[1][:5]}"
    for r in range(ek.MOUT_ROWS):
        assert np.array_equal(mout.numpy()[:, r], jm[:, r]), (label, r)
    if not host:
        return
    spec, big_end, c1end, ok = ek.unsort_blocks(
        spec_b, mout, torch.from_numpy(p.inv), nb=p.nb)
    full = fe.unpack_data(data)
    assert full.n == light.n
    valid = full.info[:, fe.VALID] == 1
    got = spec[: p.n].numpy().astype(np.int32)
    diff = np.nonzero((got != full.spectrum).any(axis=1) & valid)[0]
    assert diff.size == 0, f"{label}: {diff.size} spectra differ from host"
    assert np.array_equal(big_end[: p.n].numpy()[valid],
                          full.info[valid, fe.BIG_END]), label
    assert np.array_equal(c1end[: p.n].numpy()[valid],
                          full.info[valid, fe.COUNT1_END]), label


SINE_SPECS = [
    ("stereo_cbr", 44100, fixtures.MODE_STEREO, 128, 2, False),
    ("mono", 44100, fixtures.MODE_MONO, 64, 1, False),
    ("joint", 44100, fixtures.MODE_JOINT, 128, 2, False),
    ("vbr", 44100, fixtures.MODE_JOINT, 128, 2, True),
    ("mpeg2", 22050, fixtures.MODE_JOINT, 64, 2, False),
    ("mpeg25", 11025, fixtures.MODE_MONO, 32, 1, False),
    ("high_rate", 48000, fixtures.MODE_STEREO, 320, 2, False),
    ("low_rate", 8000, fixtures.MODE_MONO, 16, 1, False),
]


@pytest.mark.parametrize("label,sr,mode,bitrate,ch,vbr", SINE_SPECS)
def test_plain_decode_matches_jax_sine(label, sr, mode, bitrate, ch, vbr, luts):
    pcm = fixtures.sine_pcm(sr, seconds=0.3, channels=ch)
    data = fixtures.encode_mp3(pcm, sr, bitrate=bitrate, mode=mode, vbr=vbr)
    _check(data, label, luts)


@pytest.mark.parametrize("label,sr,mode,bitrate,ch,vbr", SINE_SPECS[:4])
def test_plain_decode_matches_jax_noise(label, sr, mode, bitrate, ch, vbr, luts):
    """Loud noise: escape codes, long codewords, tables 13-24."""
    rng = np.random.default_rng(42)
    wave = np.clip(rng.standard_normal(int(sr * 0.5)) * 0.5, -1, 1)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    if ch == 2:
        pcm = np.stack([pcm, np.roll(pcm, 3)], axis=1)
    data = fixtures.encode_mp3(pcm, sr, bitrate=bitrate, mode=mode, vbr=vbr)
    _check(data, label, luts)


def test_plain_decode_matches_jax_loud_tonal(luts):
    """Full-scale multitone at 320 kbps: large values, linbits paths."""
    sr = 44100
    t = np.arange(int(sr * 0.5)) / sr
    wave = sum(np.sin(2 * np.pi * f * t) / 6.0
               for f in (60, 440, 1870, 6100, 12000, 17000))
    pcm = np.clip(wave * 6 * 0.99 * 32767, -32768, 32767).astype(np.int16)
    pcm = np.stack([pcm, -pcm], axis=1)
    _check(fixtures.encode_mp3(pcm, sr, bitrate=320,
                               mode=fixtures.MODE_STEREO), "loud_tonal", luts)


def _transients(sr=44100, seconds=0.5, seed=9):
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    wave = 0.02 * rng.standard_normal(n)
    for pos in range(800, n - 900, 2500):
        wave[pos : pos + 300] += 0.8 * np.sin(
            2 * np.pi * 3000 * np.arange(300) / sr
        ) * np.exp(-np.arange(300) / 60.0)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    return np.stack([pcm, np.roll(pcm, 3)], axis=1)


def test_plain_decode_matches_jax_short_blocks(luts):
    data = fixtures.encode_mp3(_transients(), 44100, bitrate=128,
                               mode=fixtures.MODE_STEREO)
    _check(data, "short_blocks", luts)


CRAFTED = [
    ("craft_intensity_stream", {}),
    ("craft_mixed_block_stream", {}),
    ("craft_count1b_stream", {}),
    ("craft_scalefactor_stream",
     dict(scf=[3, 2, 1, 4, 5, 6, 7, 0, 1, 2, 3] + [1, 2, 3, 0, 1, 2, 3, 0, 1, 2],
          preflag=1, scfsi=0b1010)),
    ("craft_lsf_intensity_stream", {}),
]


@pytest.mark.parametrize("name,kw", CRAFTED)
def test_plain_decode_matches_jax_crafted(name, kw, luts):
    _check(getattr(craft, name)(**kw), name, luts)


def test_plain_decode_matches_jax_truncated(luts):
    pcm = fixtures.sine_pcm(44100, seconds=0.3, channels=2)
    data = fixtures.encode_mp3(pcm, 44100, bitrate=128)
    _check(data[: len(data) // 2], "truncated", luts)


def test_plain_decode_matches_jax_corrupted(luts):
    """Corrupted main data drives lanes into count1 overshoots and early
    stops: their partial spectra and every mout row must still match the
    lockstep kernel exactly."""
    rng = np.random.default_rng(5)
    wave = np.clip(rng.standard_normal(int(44100 * 0.5)) * 0.4, -1, 1)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    data = bytearray(fixtures.encode_mp3(np.stack([pcm, pcm[::-1]], axis=1),
                                         44100, bitrate=192))
    for pos in rng.integers(600, len(data), 400):
        data[pos] ^= int(rng.integers(1, 256))
    light, p = _prep(bytes(data))
    assert light.n > 0
    _check(bytes(data), "corrupted", luts, host=False)
    spec_b, mout = ek.decode_blocks_reference(*_tensors(p), luts)
    assert int((mout[:, 6] == 0).sum()) > 0, "no lane stopped early"


def _corrupted() -> bytes:
    rng = np.random.default_rng(5)
    wave = np.clip(rng.standard_normal(int(44100 * 0.5)) * 0.4, -1, 1)
    pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
    data = bytearray(fixtures.encode_mp3(np.stack([pcm, pcm[::-1]], axis=1),
                                         44100, bitrate=192))
    for pos in rng.integers(600, len(data), 400):
        data[pos] ^= int(rng.integers(1, 256))
    return bytes(data)


def _stereo(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(44100 * seconds)
    wave = 0.4 * np.sin(2 * np.pi * 440 * np.arange(n) / 44100)
    pcm = np.clip((wave + 0.1 * rng.standard_normal(n)) * 32767,
                  -32768, 32767).astype(np.int16)
    return fixtures.encode_mp3(np.stack([pcm, np.roll(pcm, 5)], axis=1), 44100,
                               bitrate=160, mode=fixtures.MODE_JOINT)


# Batches of same-format streams for decode_rows; every batch pads its
# tracks to the runner's g_max, so the row maps have padding slots.
ROW_BATCHES = {
    "mono": lambda: [fixtures.encode_mp3(fixtures.sine_pcm(22050, 0.4, 1), 22050,
                                         bitrate=48, mode=fixtures.MODE_MONO)],
    "transient": lambda: [fixtures.encode_mp3(_transients(), 44100, bitrate=128,
                                              mode=fixtures.MODE_STEREO)],
    "truncated": lambda: [_stereo(0.4, 1)[:2500]],
    "corrupted": lambda: [_corrupted()],
    "craft_intensity": lambda: [craft.craft_intensity_stream()],
    "craft_mixed_block": lambda: [craft.craft_mixed_block_stream()],
    "craft_lsf_intensity": lambda: [craft.craft_lsf_intensity_stream()],
    "unequal_tracks": lambda: [_stereo(0.3, 2), _stereo(0.1, 3), _stereo(0.5, 4)],
}
_JAX_ROWS: dict = {}


def _jax_rows(name):
    """The JAX package's composition on one batch: its kernel (interpret
    mode), unsort_blocks, the counts-derived row map with a zero dummy
    row, gathered track-major ((B·G, 576), as _light_tail's fused=False
    branch) and channel-major ((C·B·T, 576), as _analysis_tail_fused)."""
    if name in _JAX_ROWS:
        return _JAX_ROWS[name]
    ups = [fe.unpack_data_light(d) for d in ROW_BATCHES[name]()]
    nch = ups[0].n_channels
    counts = np.array([u.n for u in ups], np.int32)
    g_max = pr._quantize_up(int(counts.max()), 2 * nch, base=512, ratio=1.3)
    md, meta = [u.md for u in ups], [u.meta for u in ups]
    jp = jek.prepare_batch(md, meta, quantize_nb=True, force_g_pad=G_PAD)
    js, jm = jek.decode_blocks(jnp.asarray(jp.scalars), jnp.asarray(jp.buf),
                               jnp.asarray(jp.meta), nb=jp.nb, interpret=True)
    spec, big_end, c1end, _ = jek.unsort_blocks(js, jm, jnp.asarray(jp.inv), nb=jp.nb)
    rowmap = jpr._rowmap_from_counts(jnp.asarray(counts), g_max, jp.nb * jek.LANES)
    spec = jnp.concatenate([spec, jnp.zeros((1, 576), spec.dtype)])
    ends = [jnp.concatenate([e, jnp.zeros((1,), e.dtype)]) for e in (big_end, c1end)]
    bsz = len(ups)
    rowmap_cm = rowmap.reshape(bsz, g_max // nch, nch).transpose(2, 0, 1)
    out = {}
    for cm, rm in ((False, rowmap), (True, rowmap_cm)):
        out[cm] = [np.asarray(a[rm]).reshape(-1, *a.shape[1:]) for a in [spec] + ends]
    _JAX_ROWS[name] = (md, meta, counts, g_max, nch, out)
    return _JAX_ROWS[name]


@pytest.mark.parametrize("channel_major", [False, True])
@pytest.mark.parametrize("name", sorted(ROW_BATCHES))
def test_decode_rows_matches_jax_composition(name, channel_major, luts):
    md, meta, counts, g_max, nch, want = _jax_rows(name)
    p = ek.prepare_batch(md, meta, quantize_nb=True, force_g_pad=G_PAD)
    dest, n_rows = pr.dest_rows(torch.from_numpy(p.inv), torch.from_numpy(counts),
                                g_max=g_max, n_channels=nch,
                                channel_major=channel_major)
    assert n_rows == len(counts) * g_max > counts.sum()  # padding slots exist
    with tracing.recording():
        got = ek.decode_rows(*_tensors(p), luts, dest, n_rows)
    assert tracing.counter("plain.entropy_decode_rows") == 1
    assert [t.dtype for t in got] == [torch.int16, torch.int32, torch.int32]
    for g, w, what in zip(got, want[channel_major], ("spec", "big_end", "count1_end")):
        assert g.shape == w.shape, (name, what)
        bad = np.nonzero(g.numpy() != w)[0]
        assert bad.size == 0, f"{name} {what}: rows {np.unique(bad)[:5]} differ"
    assert got[0].abs().sum() > 0


def _invalidating_luts(window: int) -> ek.EntropyLuts:
    """Huffman tables in which the 8-bit big-value window `window` and
    the 6-bit count1 window `window >> 2` are invalid codewords (the ISO
    tables are complete, so no real stream makes a lane go bad)."""
    luts = ek.EntropyLuts()
    luts.lut_a[1:, window, 1] |= 3 << 4
    luts.lut_ct[:, window >> 2, 1] |= 3 << 4
    return luts


def test_decode_rows_masks_bad_lanes():
    """Lanes that went bad leave an all-zero row with both ends 0, though
    the lockstep decode emitted values before they went bad."""
    md, meta, counts, g_max, nch, _ = _jax_rows("transient")
    p = ek.prepare_batch(md, meta, force_g_pad=G_PAD)
    luts = _invalidating_luts(0b10110011)
    spec_b, mout = ek.decode_blocks_reference(*_tensors(p), luts)
    bad = (mout[:, 2] == 1).reshape(-1)
    lanes = spec_b.transpose(1, 2).reshape(-1, 576)
    assert int(bad.sum()) > 10 and lanes[bad].abs().sum() > 0
    dest = ek.input_order_dest(torch.from_numpy(p.inv), p.n)
    rows, big_end, c1end = ek.decode_rows(*_tensors(p), luts, dest, p.n)
    bad_rows = dest[bad.nonzero()[:, 0]].long()
    assert not rows[bad_rows].any()
    assert not big_end[bad_rows].any() and not c1end[bad_rows].any()
    good = torch.ones(p.n, dtype=torch.bool)
    good[bad_rows] = False
    assert rows[good].abs().sum() > 0


def test_wrapper_rejects_bad_inputs(luts):
    pcm = fixtures.sine_pcm(44100, seconds=0.2, channels=2)
    _, p = _prep(fixtures.encode_mp3(pcm, 44100, bitrate=128))
    scalars, buf, meta = _tensors(p)
    dest = ek.input_order_dest(torch.from_numpy(p.inv), p.n)
    with pytest.raises(ValueError, match="meta"):
        ek.decode_rows(scalars, buf, meta.to(torch.int32), luts, dest, p.n)
    with pytest.raises(ValueError, match="buf"):
        ek.decode_rows(scalars, buf[:, :4], meta, luts, dest, p.n)
    with pytest.raises(ValueError, match="contiguous"):
        ek.decode_rows(scalars, buf.transpose(1, 2).contiguous()
                       .transpose(1, 2), meta, luts, dest, p.n)
    with pytest.raises(ValueError, match="dest"):
        ek.decode_rows(scalars, buf, meta, luts, dest[:-1], p.n)
    with pytest.raises(ValueError, match="dest"):
        ek.decode_rows(scalars, buf, meta, luts, dest.long(), p.n)
    with pytest.raises(ValueError, match="n_rows"):
        ek.decode_rows(scalars, buf, meta, luts, dest, -1)
    # A device that is neither CPU nor CUDA raises; nothing falls back.
    with tracing.recording(), pytest.raises(ValueError, match="unsupported device"):
        ek.decode_rows(*(t.to("meta") for t in (scalars, buf, meta)), luts,
                       dest.to("meta"), p.n)
    assert tracing.counter("plain.entropy_decode_rows") == 0


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel build that cannot run raises; the library is not loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises((RuntimeError, OSError)):
        _build.library()
    assert _build._lib is None
