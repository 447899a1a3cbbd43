"""Torch port: the AAC/M4A analysis path against the JAX package.

The same inputs (numpy seeds, crafted streams, clips encoded here with
libavcodec) go through the JAX function and its counterpart in the port,
on the CPU, each with its tolerance stated:

- the PNS noise hash bit for bit; the nibble unpack over all 256 bytes
  and the escape scatter exactly; both host packers array for array;
- prep_spectra against the JAX prep_spectra on the same arrays (rel 1e-5
  of the row maximum, PNS noise included: the hash is copied) and against
  the host decoder's spectra at the JAX package's own tolerances (2e-5 of
  the maximum on crafted streams, 3e-5 per band on encoded content, 2e-3
  on f16 fallback rows, PNS band energy within 2%);
- AacSynthesis.decode against _decode_jit on seeded spectra holding every
  (sequence, previous shape, current shape) class, mono and stereo, two
  tracks in one batch (abs 1e-5 on unit-scale spectra);
- the device-prep route against the host-requant route (0.02 dB, peak rel
  1e-3), and the slice as a whole (analyze_track_internal,
  find_peak_amplitude, decode_file, analyze_album, an M4A's second track,
  raw ADTS) against the JAX entry points: index within 2 bins, peak rtol
  2e-4, PCM abs 1e-5;
- one Runner per device shared by the entry points.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mp3rgain_tpu import aac as jaac  # noqa: E402
from mp3rgain_tpu import analysis as jan  # noqa: E402
from mp3rgain_tpu.decode import aac_frontend as jaf  # noqa: E402
from mp3rgain_tpu.decode import aac_prep as jprep  # noqa: E402
from mp3rgain_tpu.decode import aac_synthesis as jsyn  # noqa: E402
from mp3rgain_tpu.testing import avcodec, craft_aac, fixtures  # noqa: E402
from mp3rgain_tpu_torch import aac, analysis  # noqa: E402
from mp3rgain_tpu_torch.decode import aac_frontend as af  # noqa: E402
from mp3rgain_tpu_torch.decode import aac_prep, aac_synthesis  # noqa: E402
from mp3rgain_tpu_torch.decode.aac_format_tables import (  # noqa: E402
    SWB_1024_MAP,
    SWB_LONG_TABLES,
)
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402
from mp3rgain_tpu_torch.utils import bufpool  # noqa: E402

torch.set_num_threads(2)


def _idx(loudness_db: float) -> int:
    return round(loudness_db * 100) + 2000


def _pcm(seconds, sr, channels, seed, noise=0.05, freq=523.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    wave = 0.3 * np.sin(2 * np.pi * freq * t) + noise * rng.standard_normal(len(t))
    wave = wave.astype(np.float32)
    return wave if channels == 1 else np.stack([wave, np.roll(wave, 13)], axis=1)


def _transient(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    wave = 0.02 * rng.standard_normal(n)
    burst = 0.8 * np.sin(2 * np.pi * 3000 * np.arange(300) / sr) * np.exp(
        -np.arange(300) / 60.0)
    for pos in range(800, n - 900, 2500):
        wave[pos : pos + 300] += burst
    wave = wave.astype(np.float32)
    return np.stack([wave, np.roll(wave, 3)], axis=1)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Encoded here: a 96 kbps stereo M4A (PNS, intensity and M/S bands),
    a stereo M4A of bursts (EIGHT_SHORT frames), a mono 22.05 kHz raw ADTS
    stream, a loud 256 kbps M4A (escapes past int8) and a two-track M4A."""
    out = tmp_path_factory.mktemp("torch_aac")
    files = {
        "pns.m4a": fixtures.encode_m4a(_pcm(2.0, 44100, 2, 3), 44100, bitrate=96000),
        "transient.m4a": fixtures.encode_m4a(_transient(1.5, 44100, 9), 44100,
                                             bitrate=128000),
        "mono.aac": avcodec.encode_adts(_pcm(1.5, 22050, 1, 4, noise=0.1), 22050,
                                        bitrate=48000),
        "two.m4a": fixtures.encode_m4a_multi(
            [(_pcm(1.0, 44100, 2, 5, noise=0.0, freq=440.0), 44100),
             (_pcm(1.2, 32000, 1, 6, noise=0.02, freq=880.0), 32000)],
            bitrate=96000),
    }
    t = np.arange(44100 * 2) / 44100
    wave = 0.95 * np.sin(2 * np.pi * 220.0 * t) * np.sign(np.sin(2 * np.pi * 0.5 * t))
    files["loud.m4a"] = fixtures.encode_m4a(
        np.stack([wave, wave], axis=1).astype(np.float32), 44100, bitrate=256000)
    paths = {}
    for name, data in files.items():
        paths[name] = out / name
        paths[name].write_bytes(data)
    return paths


def _adts(path) -> bytes:
    data = path.read_bytes()
    return jaf.mp4_to_adts(data) if data[4:8] == b"ftyp" else data


QUADS = [(1, 0, -1, 0), (0, 1, 0, 0), (-1, -1, 1, 0), (1, 1, 1, 1)]
ENERGY = {b: (1, -1, 1, 0) for b in range(0, 12)}
CRAFTED = {
    "sce-plain": lambda: craft_aac.craft_sce_stream(8, global_gain=140, band_quads=QUADS),
    "sce-multi-pulse": lambda: craft_aac.craft_sce_stream(
        8, global_gain=140, band_quads=QUADS,
        pulses=[(0, 2), (3, 7), (2, 1), (5, 4)], pulse_start_sfb=1),
    "cpe-ms-only": lambda: craft_aac.craft_cpe_stream(
        8, global_gain=140, n_bands=20, left_energy=ENERGY,
        right_energy={b: (0, 1, -1, 1) for b in range(0, 8)}, ms_used={1, 3, 5, 7, 9}),
    "cpe-is-plus-minus": lambda: craft_aac.craft_cpe_stream(
        8, global_gain=140, n_bands=20, left_energy=ENERGY,
        is_bands={12: (15, 4), 13: (14, -2), 14: (15, 0)}),
    "cpe-is-under-ms": lambda: craft_aac.craft_cpe_stream(
        8, global_gain=140, n_bands=20, left_energy=ENERGY,
        is_bands={12: (15, 4), 13: (14, 3)}, ms_used={12, 13, 2, 4}),
    "cpe-ms-on-zero-right": lambda: craft_aac.craft_cpe_stream(
        8, global_gain=140, n_bands=20, left_energy=ENERGY, ms_used=set(range(16))),
}


def _tns_stream(frames=6):
    return craft_aac.craft_sce_stream(
        frames, n_bands=40, global_gain=140,
        energy={b: (1, -1, 1, 0) for b in range(0, 30)},
        tns=dict(length=40, order=3, coefs=[5, 2, 7]))


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """As Runner._upload hands an array to the device code: uint16 bits
    as int16."""
    a = a.view(np.int16) if a.dtype == np.uint16 else a
    return torch.from_numpy(np.ascontiguousarray(a)).clone()


def _port_prep(args, sr, nch):
    """The port's prep_spectra on the packer's ten arrays → (B, F, 1024)."""
    spec_q4, meta, esc_idx, esc_val, fb16, fbexp, fbmap = args[:7]
    dst, src = aac_prep.fallback_rows(fbmap)
    t = [_to_torch(a) for a in (spec_q4, meta, esc_idx, esc_val, fb16[src],
                                fbexp[src], dst)]
    return aac_prep.AacPrep(sr).prep_spectra(*t, n_channels=nch).numpy()


def _prep(data):
    """(port spectra (n, 1024), JAX spectra (n, 1024), quantized unpack)."""
    uq = af.unpack_adts_q(data)
    nch = uq.n_channels or 1
    args = aac.prepare_batch_arrays_aac_q([uq], nch)
    mine = _port_prep(args, uq.sample_rate, nch)
    theirs = np.asarray(jprep.prep_spectra(
        *args[:7], sample_rate=uq.sample_rate, n_channels=nch))
    n = (uq.n // nch) * nch
    return mine[0, :n], theirs[0, :n], uq


# --- bit-exact pieces ----------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 7, 64, 300])
def test_noise_uniform_is_bit_equal(rows):
    mine = aac_prep.AacPrep(44100).noise_uniform(rows).numpy()
    theirs = np.asarray(jprep._noise_uniform(rows, 1024))
    assert mine.dtype == theirs.dtype == np.float32 and mine.shape == (rows, 1024)
    assert np.array_equal(mine.view(np.int32), theirs.view(np.int32))


def test_nibble_unpack_over_all_bytes():
    b = np.arange(256, dtype=np.uint8).view(np.int8)
    lo, hi = aac_prep.unpack_nibbles(torch.from_numpy(b.copy()))
    assert lo.dtype == hi.dtype == torch.int8
    want_lo = ((b.astype(np.int32) & 15) ^ 8) - 8  # two's-complement nibbles
    want_hi = (((b.astype(np.int32) >> 4) & 15) ^ 8) - 8
    assert np.array_equal(lo.numpy(), want_lo) and np.array_equal(hi.numpy(), want_hi)
    j_lo = np.asarray((jnp.asarray(b) << 4) >> 4)
    assert np.array_equal(lo.numpy(), j_lo)


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_escape_scatter_reconstructs_the_integers_exactly(idx_dtype):
    """Nibbles over a trimmed extent plus the escape sideband (with padding
    entries) give back the int16 coefficients exactly."""
    rng = np.random.default_rng(17)
    bsz, fl, ext = 2, 6, 256
    q = rng.integers(-7, 8, (bsz, fl, ext)).astype(np.int16)
    big = rng.random((bsz, fl, ext)) < 0.03
    q[big] = rng.integers(-8191, 8192, int(big.sum()))
    small = np.where(np.abs(q) > 7, 0, q).astype(np.int8)
    spec_q4 = (small[..., 0::2] & np.int8(15)) | (small[..., 1::2] << 4)
    b, f, p = np.nonzero(np.abs(q) > 7)
    n = len(b)
    esc_idx = np.zeros(n + 9, idx_dtype)
    esc_val = np.zeros(n + 9, np.int16)
    esc_idx[:n] = ((b * fl + f).astype(idx_dtype) << 10) | p
    esc_val[:n] = q[b, f, p]
    got = aac_prep.unpack_quantized(*(torch.from_numpy(a) for a in
                                      (spec_q4, esc_idx, esc_val))).numpy()
    assert got.shape == (bsz * fl, 1024) and got.dtype == np.float32
    assert np.array_equal(got[:, :ext], q.reshape(-1, ext).astype(np.float32))
    assert not got[:, ext:].any() and n > 10


# --- the host packers, array for array -------------------------------------------

def _same_arrays(mine, theirs):
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype, a.shape)
        assert np.array_equal(a.view(np.uint16) if a.dtype == np.float16 else a,
                              b.view(np.uint16) if b.dtype == np.float16 else b), i


@pytest.mark.parametrize("names", [("pns.m4a",), ("pns.m4a", "transient.m4a", "loud.m4a"),
                                   ("mono.aac",)])
def test_q_packer_equals_the_original(clips, names):
    data = [_adts(clips[n]) for n in names]
    mine = [af.unpack_adts_q(d) for d in data]
    theirs = [jaf.unpack_adts_q(d) for d in data]
    nch = mine[0].n_channels
    _same_arrays(aac.prepare_batch_arrays_aac_q(mine, nch),
                 jaac.prepare_batch_arrays_aac_q(theirs, nch))
    bufpool.clear()


def test_q_packer_forced_shapes_and_int64_escape_indices(clips):
    """force_shapes pins every shape; past 2^31 flat coefficients the
    escape indices are int64."""
    data = _adts(clips["loud.m4a"])
    mine, theirs = af.unpack_adts_q(data), jaf.unpack_adts_q(data)
    small = (3, 256, 1024, 131072, 64)
    _same_arrays(aac.prepare_batch_arrays_aac_q([mine], 2, force_shapes=small),
                 jaac.prepare_batch_arrays_aac_q([theirs], 2, force_shapes=small))
    bufpool.clear()
    wide = (128, 16384, 128, 512, 16)  # 128 * 16384 * 1024 == 2^31
    mono = af.unpack_adts_q(CRAFTED["sce-plain"]())
    a = aac.prepare_batch_arrays_aac_q([mono], 1, force_shapes=wide)
    b = jaac.prepare_batch_arrays_aac_q([jaf.unpack_adts_q(CRAFTED["sce-plain"]())], 1,
                                        force_shapes=wide)
    assert a[2].dtype == np.int64
    _same_arrays(a, b)
    del a, b
    bufpool.clear()


@pytest.mark.parametrize("f16", [True, False, "mixed"])
def test_f16_packer_equals_the_original(clips, f16):
    data = [_adts(clips[n]) for n in ("pns.m4a", "transient.m4a")]
    flags = [True, False] if f16 == "mixed" else [f16, f16]
    mine = [af.unpack_adts(d, f16=f) for d, f in zip(data, flags)]
    theirs = [jaf.unpack_adts(d, f16=f) for d, f in zip(data, flags)]
    _same_arrays(aac.prepare_batch_arrays_aac(mine, 2),
                 jaac.prepare_batch_arrays_aac(theirs, 2))
    bufpool.clear()


# --- prep_spectra ------------------------------------------------------------------

def _assert_rows_close(mine, theirs, rel):
    scale = np.abs(theirs).max(axis=1, keepdims=True)
    assert (np.abs(mine - theirs) <= rel * scale + 1e-30).all()


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_prep_spectra_on_crafted_streams(name):
    """Against the JAX prep on the same arrays (rel 1e-5 of the row
    maximum) and against the host decoder (2e-5 of the maximum)."""
    data = CRAFTED[name]()
    mine, theirs, uq = _prep(data)
    assert not len(uq.fbrows), "pulses must not trigger fallback"
    _assert_rows_close(mine, theirs, 1e-5)
    ref = af.unpack_adts(data)
    assert uq.n == ref.n
    assert np.abs(mine - ref.spec).max() < 2e-5 * (np.abs(ref.spec).max() + 1e-12)


def test_prep_spectra_tns_frames_fall_back():
    data = _tns_stream()
    mine, theirs, uq = _prep(data)
    assert len(uq.fbrows) == uq.n and np.all(uq.info[:, 7] & af.FLAG_FALLBACK)
    assert np.array_equal(mine, theirs)  # both copy the same f16 rows
    ref = af.unpack_adts(data)
    assert np.abs(mine - ref.spec).max() < 2e-3 * (np.abs(ref.spec).max() + 1e-12)


@pytest.mark.parametrize("name", ["pns.m4a", "transient.m4a", "mono.aac", "loud.m4a"])
def test_prep_spectra_on_encoded_content_matches_jax(clips, name):
    """PNS noise included, since the hash is copied: rel 1e-5 of the row
    maximum, over noise, intensity, M/S, escape and fallback rows."""
    mine, theirs, uq = _prep(_adts(clips[name]))
    _assert_rows_close(mine, theirs, 1e-5)
    if name == "pns.m4a":
        assert (uq.btype == 2).any() and (uq.btype >= 3).any() and uq.msf.any()
    if name == "transient.m4a":
        assert (uq.info[:, af.WINDOW_SEQ] == aac_synthesis.EIGHT_SHORT).any()
        assert len(uq.fbrows) > 0
    if name == "loud.m4a":
        assert len(uq.esc_idx) > 100 and int(np.abs(uq.esc_val).max()) > 127


def test_prep_spectra_against_the_host_decoder(clips):
    """The JAX package's own check of its device prep, on the port: bands
    noise does not touch within 3e-5 per band, fallback rows at f16
    precision (2e-3), PNS band energy within 2% of the host's."""
    spec_q, _, uq = _prep(_adts(clips["pns.m4a"]))
    ref = af.unpack_adts(_adts(clips["pns.m4a"]))
    swb = SWB_LONG_TABLES[SWB_1024_MAP[af.ADTS_SR_INDEX[uq.sample_rate]]]
    nch = uq.n_channels
    fb_lanes = set(int(r) for r in uq.fbrows)
    checked_noise = 0
    for lane in range(uq.n):
        if lane in fb_lanes:
            d = np.abs(spec_q[lane] - ref.spec[lane]).max()
            assert d < 2e-3 * (np.abs(ref.spec[lane]).max() + 1e-9), lane
            continue
        bt = uq.btype[lane]
        noisy_left = uq.btype[lane - (lane % nch)] == 2
        own_noise = bt == 2
        coupled = own_noise | ((uq.msf[lane] == 1) & noisy_left)
        if lane % nch == 1:
            coupled |= ((bt == 3) | (bt == 4)) & noisy_left
        for k in range(len(swb) - 1):
            a, b = swb[k], swb[k + 1]
            if coupled[k]:
                if own_noise[k]:
                    eq = float((spec_q[lane, a:b] ** 2).sum())
                    eh = float((ref.spec[lane, a:b] ** 2).sum())
                    assert eq == pytest.approx(eh, rel=2e-2, abs=1e-20)
                    checked_noise += 1
            else:
                d = np.abs(spec_q[lane, a:b] - ref.spec[lane, a:b]).max()
                s = np.abs(ref.spec[lane, a:b]).max() + 1e-9
                assert d < 3e-5 * s + 1e-9, (lane, k)
    assert checked_noise > 0


# --- the IMDCT back-end ---------------------------------------------------------------

def _windows(rng, frames, nch):
    """(frames * nch,) window sequences and shapes: every (sequence,
    previous shape, current shape) class appears, channels of a frame
    share its sequence."""
    seq = np.tile(np.repeat(np.arange(4), 4), -(-frames // 16))[:frames]
    shape = np.tile(np.array([0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0]),
                    -(-frames // 17))[:frames]
    perm = rng.permutation(frames)
    seq, shape = seq[perm], shape[rng.permutation(frames)]
    return np.repeat(seq, nch).astype(np.int32), np.repeat(shape, nch).astype(np.int32)


@pytest.mark.parametrize("nch", [1, 2])
def test_synthesis_decode_matches_jax(nch):
    """Two tracks in one batch, the second starting on KBD windows after
    the first ends on them: a previous shape leaking across tracks (or
    channels) would show. abs 1e-5 on unit-scale spectra."""
    rng = np.random.default_rng(23 + nch)
    frames = 80
    fl = frames * nch
    spec = rng.uniform(-1, 1, (2, fl, 1024)).astype(np.float32)
    wins = [_windows(rng, frames, nch) for _ in range(2)]
    wins[0][1][-nch:] = 1  # track 0 ends on shape 1
    if nch == 2:  # channels of one frame with different shapes
        wins[0][1][2:40:4] ^= 1
    wseq = np.stack([w[0] for w in wins])
    wshape = np.stack([w[1] for w in wins])
    rows, counts = aac_synthesis.short_rows(wseq, wshape, nch)
    prev = aac_synthesis.previous_shape(wshape, nch)
    classes = {(int(s), int(p), int(c)) for s, p, c in
               zip(wseq.reshape(-1), prev.reshape(-1), wshape.reshape(-1))}
    assert len(classes) == 16 and all(counts) and sum(counts) == len(rows)

    syn = aac_synthesis.AacSynthesis()
    got = syn.decode(torch.from_numpy(spec), torch.from_numpy(wseq),
                     torch.from_numpy(wshape), torch.from_numpy(rows), counts,
                     n_channels=nch).numpy()
    assert got.shape == (2, nch, frames * 1024)
    for b in range(2):
        want = np.asarray(jsyn._decode_jit(
            jnp.asarray(spec[b]), jnp.asarray(wseq[b]), jnp.asarray(wshape[b]),
            n_channels=nch, dtype=jnp.float32))
        assert np.abs(got[b] - want).max() < 1e-5, b


def test_synthesis_tables_equal_the_original():
    for mine, theirs in zip(aac_synthesis._tables(), jsyn._tables()):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)


# --- the two routes and the slice as a whole ----------------------------------------------

@pytest.fixture(scope="module")
def runner():
    return pr.Runner("cpu")


@pytest.mark.parametrize("name", ["pns.m4a", "transient.m4a", "mono.aac"])
def test_q_route_matches_f16_route(clips, runner, name):
    data = _adts(clips[name])
    uq, uf = af.unpack_adts_q(data), af.unpack_adts(data, f16=True)
    nch = uq.n_channels
    h_q, l_q, p_q = aac.analyze_batch_q([uq], uq.sample_rate, nch, runner=runner)
    h_f, l_f, p_f = aac.analyze_batch([uf], uf.sample_rate, nch, runner=runner)
    assert h_q.shape == h_f.shape == (1, 12000) and h_q.sum() == h_f.sum() > 0
    assert abs(float(l_q[0]) - float(l_f[0])) <= 0.02 + 1e-9
    assert float(p_q[0]) == pytest.approx(float(p_f[0]), rel=1e-3)


def test_q_route_matches_f16_route_on_fallback_frames(runner):
    """A clean crafted track and a TNS one (all fallback rows) in turn."""
    clean = craft_aac.craft_sce_stream(20, global_gain=140, band_quads=QUADS)
    for data in (clean, _tns_stream(20)):
        uq, uf = af.unpack_adts_q(data), af.unpack_adts(data, f16=True)
        _, l_q, p_q = aac.analyze_batch_q([uq], uq.sample_rate, 1, runner=runner)
        _, l_f, p_f = aac.analyze_batch([uf], uf.sample_rate, 1, runner=runner)
        assert abs(float(l_q[0]) - float(l_f[0])) <= 0.02 + 1e-9
        assert float(p_q[0]) == pytest.approx(float(p_f[0]), rel=2e-3)


@pytest.mark.parametrize("route", ["q", "f16"])
def test_a_batch_equals_its_tracks_alone(clips, runner, route):
    """Tracks of different lengths in one batch (padding frames, row
    lists and fallback rows offset per track) against each alone."""
    data = [_adts(clips[n]) for n in ("pns.m4a", "transient.m4a", "loud.m4a")]
    if route == "q":
        ups, batch = [af.unpack_adts_q(d) for d in data], aac.analyze_batch_q
    else:
        ups, batch = [af.unpack_adts(d, f16=True) for d in data], aac.analyze_batch
    hist, louds, peaks = batch(ups, 44100, 2, runner=runner)
    for i, u in enumerate(ups):
        h1, l1, p1 = batch([u], 44100, 2, runner=runner)
        assert int(hist[i].sum()) == int(h1[0].sum())
        assert abs(_idx(louds[i]) - _idx(l1[0])) <= 1
        np.testing.assert_allclose(peaks[i], p1[0], rtol=1e-5)


CASES = [("pns.m4a", None), ("transient.m4a", None), ("mono.aac", None),
         ("two.m4a", None), ("two.m4a", 1)]


@pytest.mark.parametrize("device_prep", [None, True])
@pytest.mark.parametrize("name,track", CASES)
def test_analyze_track_internal_matches_jax(clips, runner, name, track, device_prep):
    """The JAX package on the CPU takes its host-requant route; the port's
    CPU default is the same route, and its device-prep route must agree
    too. Index within 2 bins, peak rtol 2e-4 (rel 1e-3 across routes, the
    JAX package's own tolerance between them)."""
    ref = jan.analyze_track_internal(clips[name], track)
    mine = analysis.analyze_track_internal(clips[name], track, runner=runner) \
        if device_prep is None else aac.analyze_track_internal(
            clips[name], track, runner=runner, device_prep=True)
    assert mine.result.file_type == ref.result.file_type == "aac"
    assert mine.result.sample_rate == ref.result.sample_rate
    assert mine.audio_seconds == ref.audio_seconds > 0
    assert int(mine.histogram.sum()) == int(np.asarray(ref.histogram).sum())
    assert abs(_idx(mine.result.loudness_db) - _idx(ref.result.loudness_db)) <= 2
    assert mine.result.gain_db == pytest.approx(64.82 - mine.result.loudness_db)
    np.testing.assert_allclose(mine.result.peak, ref.result.peak,
                               rtol=2e-4 if device_prep is None else 1e-3)


@pytest.mark.parametrize("name", ["pns.m4a", "mono.aac"])
def test_find_peak_amplitude_matches_jax(clips, runner, name):
    mine = analysis.find_peak_amplitude(clips[name], runner=runner)
    ref = jan.find_peak_amplitude(clips[name])
    np.testing.assert_allclose(mine.peak, ref.peak, rtol=2e-4)
    assert mine.peak <= aac.AAC_CLIP and mine.sample_rate == ref.sample_rate
    assert mine.peak_pcm == pytest.approx(mine.peak * 32768.0)


@pytest.mark.parametrize("name", ["pns.m4a", "transient.m4a", "mono.aac"])
def test_decode_file_matches_jax(clips, name):
    pcm, sr = aac.decode_file(clips[name], device="cpu")
    want, j_sr = jaac.decode_file(clips[name])
    assert sr == j_sr and pcm.shape == want.shape and pcm.dtype == np.float32
    assert np.abs(pcm - want).max() < 1e-5


def test_analyze_album_over_aac_and_mp3_matches_jax(clips, runner, fixtures_dir):
    files = [clips["pns.m4a"], fixtures_dir / "test_stereo.mp3", clips["mono.aac"]]
    mine = analysis.analyze_album(files, runner=runner)
    ref = jan.analyze_album(files)
    assert [t.file_type for t in mine.tracks] == ["aac", "mp3", "aac"]
    assert abs(_idx(mine.album_loudness_db) - _idx(ref.album_loudness_db)) <= 2
    np.testing.assert_allclose(mine.album_peak, ref.album_peak, rtol=2e-4)
    for a, b in zip(mine.tracks, ref.tracks):
        assert abs(_idx(a.loudness_db) - _idx(b.loudness_db)) <= 2


def test_track_index_errors_match_jax(clips, runner):
    for path, track in ((clips["two.m4a"], 2), (clips["mono.aac"], 1)):
        with pytest.raises(jaf.Mp4DemuxError) as theirs:
            jan.analyze_track_internal(path, track)
        with pytest.raises(af.Mp4DemuxError) as mine:
            analysis.analyze_track_internal(path, track, runner=runner)
        assert str(mine.value) == str(theirs.value)


def test_route_is_an_argument_not_an_environment_switch(clips, runner, monkeypatch):
    """device prep is the CUDA default and the host-requant route the CPU
    default; MP3RGAIN_AAC_DEVICE_PREP changes nothing."""
    assert aac.use_device_prep(torch.device("cuda"), None) is True
    assert aac.use_device_prep(torch.device("cpu"), None) is False
    assert aac.use_device_prep(torch.device("cpu"), True) is True
    assert aac.use_device_prep(torch.device("cuda"), False) is False
    seen = []
    real = runner.prepare_aac
    monkeypatch.setattr(runner, "prepare_aac", lambda *a: seen.append(1) or real(*a))
    monkeypatch.setenv("MP3RGAIN_AAC_DEVICE_PREP", "1")
    analysis.analyze_track_internal(clips["mono.aac"], runner=runner)
    assert seen == [1]


def test_aac_entry_points_default_to_the_card(clips, monkeypatch):
    """Without a device argument the AAC entry points ask for the card;
    where there is none they raise instead of running on the CPU or on the
    other route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pr, "_shared", {})
    uq = af.unpack_file_q(clips["mono.aac"])
    calls = [lambda: analysis.analyze_track_internal(clips["pns.m4a"]),
             lambda: analysis.find_peak_amplitude(clips["mono.aac"]),
             lambda: aac.analyze_track_internal(clips["two.m4a"], 1, device_prep=False),
             lambda: aac.decode_file(clips["mono.aac"]),
             lambda: aac.analyze_batch_q([uq], 22050, 1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device is required"):
            call()
    assert pr._shared == {}


# --- one Runner per device -------------------------------------------------------------------

def test_entry_points_share_one_runner_per_device(clips, fixtures_dir, monkeypatch):
    """Two analyze_track_internal and two find_peak_amplitude calls on one
    format, given no runner, build its tables once."""
    built = {"light": 0, "aac": 0, "imdct": 0}

    class CountingLightTail(pr.LightTail):
        def __init__(self, *a):
            built["light"] += 1
            super().__init__(*a)

    class CountingAacTail(aac.AacTail):
        def __init__(self, *a):
            built["aac"] += 1
            super().__init__(*a)

    class CountingSynthesis(aac_synthesis.AacSynthesis):
        def __init__(self):
            built["imdct"] += 1
            super().__init__()

    monkeypatch.setattr(pr, "_shared", {})
    monkeypatch.setattr(pr, "LightTail", CountingLightTail)
    monkeypatch.setattr(aac, "AacTail", CountingAacTail)
    monkeypatch.setattr(aac_synthesis, "AacSynthesis", CountingSynthesis)
    mp3 = fixtures_dir / "test_stereo.mp3"
    for path in (mp3, clips["pns.m4a"]):
        for _ in range(2):
            analysis.analyze_track_internal(path, device="cpu")
            analysis.find_peak_amplitude(path, device="cpu")
    aac.decode_file(clips["mono.aac"], device="cpu")
    assert built == {"light": 1, "aac": 1, "imdct": 1}
    assert pr.shared_runner("cpu") is pr.shared_runner(torch.device("cpu"))
    assert list(pr._shared) == ["cpu"]


def test_shared_runner_under_concurrent_callers(clips, fixtures_dir, monkeypatch):
    """More threads than cores ask for the shared Runner and analyse
    through it at once: one Runner is built, and every result equals the
    serial one (launches serialise under the Runner's lock)."""
    import os
    import sys
    import threading

    built = []
    real_init = pr.Runner.__init__

    def counting_init(self, *a, **kw):
        built.append(1)
        real_init(self, *a, **kw)

    monkeypatch.setattr(pr, "_shared", {})
    monkeypatch.setattr(pr.Runner, "__init__", counting_init)
    paths = [clips["mono.aac"], fixtures_dir / "test_mono.mp3", clips["two.m4a"]]
    n_threads = 2 * (os.cpu_count() or 4) + 1
    results, errors = {}, []
    start = threading.Barrier(n_threads)

    def work(i):
        try:
            start.wait(timeout=60)
            r = analysis.analyze_track_internal(paths[i % len(paths)], device="cpu")
            results[i] = (r.result.loudness_db, r.result.peak, r.histogram.tobytes())
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(built) == 1 and len(results) == n_threads
    for i, got in results.items():
        r = analysis.analyze_track_internal(paths[i % len(paths)], device="cpu")
        assert got == (r.result.loudness_db, r.result.peak, r.histogram.tobytes()), i
