"""Torch port: hostile input, the counterpart of tests/test_fuzz.py.

Three parts:

- The seven tests of tests/test_fuzz.py with the same seeds, on the
  port's own modules (native, the light front-end's bounds, ape,
  mp4meta, aac_frontend, bitstream.analyze_data, and
  entropy_kernel.decode_rows_reference in place of the interpreted Pallas
  decode, which is kept beside it on the small crafted streams).
- Route against route: the same mutated streams through each port route
  and its JAX counterpart (MP3 raw-bits against the JAX light tail with
  the interpreted Pallas decode, MP3 host-decoded against the JAX
  host-decoded pipeline, AAC q and f16 against the JAX package's two AAC
  routes). Window counts and loudness index exactly equal, K1's rows
  equal the JAX decode exactly on valid granules, peak within rtol 2e-4
  (the AAC f16 route: rel 1e-3, the JAX package's own AAC tolerance); a
  NaN peak counts as equal where both are NaN. Where both sides fail,
  they fail with exceptions of the same class name.
- The PNS-overflow stream (testing/hostile.py): the JAX package's 0.00 dB
  with 58 windows in bin 2000 and a NaN peak; and scan isolation:
  scan_files over good and mutated files, each good file exactly as in a
  scan without the mutated ones, each mutated file's outcome the JAX
  package's.
"""

import math
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mp3rgain_tpu import aac as jaac  # noqa: E402
from mp3rgain_tpu import scan as jscan  # noqa: E402
from mp3rgain_tpu.decode import aac_frontend as jaf  # noqa: E402
from mp3rgain_tpu.decode import entropy_kernel as jek  # noqa: E402
from mp3rgain_tpu.decode import frontend as jfe  # noqa: E402
from mp3rgain_tpu.parallel import runner as jpr  # noqa: E402
from mp3rgain_tpu_torch import aac, analysis, bitstream, mp4meta, native, scan  # noqa: E402
from mp3rgain_tpu_torch import ape as tape  # noqa: E402
from mp3rgain_tpu_torch.decode import aac_frontend as af  # noqa: E402
from mp3rgain_tpu_torch.decode import entropy_kernel as ek  # noqa: E402
from mp3rgain_tpu_torch.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu_torch.ops import histogram as hi  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402
from mp3rgain_tpu_torch.testing import craft, craft_aac, hostile  # noqa: E402
from mp3rgain_tpu_torch.testing import fixtures as tfixtures  # noqa: E402
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _check_light(mutated: bytes, full=None):
    """Structural bounds of the port's raw-bits front-end on hostile
    input (test_fuzz.py's _check_light): the light walk agrees with the
    full unpack on record count, and the meta K1 trusts stays within the
    bounds its loops assume."""
    lt = fe.unpack_data_light(mutated)
    if full is None:
        full = fe.unpack_data(mutated)
    assert lt.n == full.n
    if lt.n:
        assert (lt.meta[:, fe.LM_P0] >= 0).all()
        assert (lt.meta[:, fe.LM_P0] <= 7).all()
        assert (lt.meta[:, fe.LM_P23] >= 0).all()
        assert (lt.meta[:, fe.LM_BVP] >= 0).all()
        assert (lt.meta[:, fe.LM_BVP] <= 288).all()
        bits = lt.meta[:, fe.LM_P0].astype(np.int64) + lt.meta[:, fe.LM_P23]
        assert (bits <= 8 * fe.MD_STRIDE).all()
    return lt


# ---------------------------------------------------------------------------
# The seven tests of tests/test_fuzz.py, on the port's modules.
# ---------------------------------------------------------------------------


def test_mutations_equal_the_jax_generator():
    """One seed gives the same bytes as tests/test_fuzz.py's generator."""
    from tests.test_fuzz import _mutations

    data = craft.craft_mixed_block_stream(4, subblock_gain=(7, 3, 1))
    mine = list(hostile.mutations(data, np.random.default_rng(7), 30))
    theirs = list(_mutations(data, np.random.default_rng(7), 30))
    assert mine == theirs and len(set(mine)) > 20


def test_fuzz_mp3_paths(fixtures_dir):
    rng = np.random.default_rng(42)
    data = (fixtures_dir / "test_joint_stereo.mp3").read_bytes()
    for mutated in hostile.mutations(data, rng, 60):
        try:
            bitstream.analyze_data(mutated)
        except bitstream.Mp3Error:
            pass
        buf = bytearray(mutated)
        native.apply_gain(buf, 3)
        native.apply_gain_channel(buf, 1, -2)
        native.read_gains(mutated)
        native.frame_index(mutated)
        native.find_audio_end(mutated)
        u = fe.unpack_data(mutated)
        assert u.n >= 0
        if u.n:
            assert (np.abs(u.spectrum) <= 8206 + 8191).all()
        _check_light(mutated, u)


def test_fuzz_ape_paths():
    rng = np.random.default_rng(43)
    tag = tape.ApeTag()
    tag.set_undo_gain(2, 2, False)
    tag.set("REPLAYGAIN_TRACK_GAIN", "-3.00 dB")
    base = bytes(512) + tape.serialize_ape_tag(tag) + b"TAG" + bytes(125)
    for mutated in hostile.mutations(base, rng, 60):
        native.ape_find_footer(mutated)
        native.ape_parse(mutated)
        native.ape_remove_region(mutated)
        tape.remove_ape_tag(mutated)
        tape.write_ape_tag_to_data(mutated, tag)


def test_fuzz_mp4_paths(tmp_path):
    rng = np.random.default_rng(44)
    t = np.arange(4410) / 44100
    m4a = tfixtures.encode_m4a(np.stack([np.sin(880 * t, dtype=np.float32)] * 2, 1), 44100)
    tags = mp4meta.ReplayGainTags()
    tags.set_track(1.0, 0.9)
    for mutated in hostile.mutations(m4a, rng, 60):
        p = tmp_path / "fuzz.m4a"
        p.write_bytes(mutated)
        mp4meta.is_mp4_file(p)
        try:
            mp4meta.read_replaygain_tags(p)
            mp4meta.write_replaygain_tags_to_data(mutated, tags)
        except mp4meta.Mp4Error:
            pass
        try:
            adts = af.mp4_to_adts(mutated)
            af.unpack_adts(adts)
        except Exception:  # noqa: BLE001 - any Python error is fine, a crash is not
            pass


def test_fuzz_pure_garbage():
    rng = np.random.default_rng(45)
    for size in (0, 1, 7, 32, 127, 1024, 65536):
        blob = bytes(rng.integers(0, 256, size=size).tolist())
        with pytest.raises(bitstream.Mp3Error):
            bitstream.analyze_data(blob)
        native.read_gains(blob)
        native.ape_parse(blob)
        fe.unpack_data(blob)
        _check_light(blob)
        af.unpack_adts(blob)


def test_fuzz_crafted_stream_paths():
    rng = np.random.default_rng(11)
    mp3_seeds = [
        craft.craft_intensity_stream(4, mode_extension=3, ch1_bands=[0, 1]),
        craft.craft_lsf_intensity_stream(8, intensity_scale=1),
        craft.craft_mixed_block_stream(4, subblock_gain=(7, 3, 1)),
        craft.craft_count1b_stream(4),
        craft.craft_scalefactor_stream(
            4, scf=[3] * 21, scfsi=0b1010, preflag=1, scalefac_scale=1
        ),
    ]
    for seed in mp3_seeds:
        for mutated in hostile.mutations(seed, rng, 25):
            try:
                bitstream.analyze_data(mutated)
            except bitstream.Mp3Error:
                pass
            native.frame_index(mutated)
            u = fe.unpack_data(mutated)
            assert u.n >= 0
            _check_light(mutated, u)


LUTS = ek.EntropyLuts()


def _k1_rows(lt):
    """The port's K1 (its plain version here) on one light-unpacked
    stream, rows in input order."""
    p = ek.prepare_batch(lt.md, lt.meta)
    t = [pr._to_device(a, CPU) for a in (p.scalars, p.buf, p.meta, p.inv)]
    spec, big_end, c1end = ek.decode_rows(*t[:3], LUTS,
                                          ek.input_order_dest(t[3], p.n), p.n)
    return spec.numpy().astype(np.int32), big_end.numpy(), c1end.numpy()


def test_fuzz_device_entropy_path():
    """Mutated crafted streams through the port's raw-bits pack and K1's
    plain version: it terminates, its rows equal the host decoder's
    spectra on every valid granule, and its rows, big_end and count1_end
    equal the JAX package's interpreted Pallas decode there."""
    rng = np.random.default_rng(12)
    seed = craft.craft_mixed_block_stream(4, subblock_gain=(7, 3, 1))
    for mutated in hostile.mutations(seed, rng, 6):
        full = fe.unpack_data(mutated)
        lt = _check_light(mutated, full)
        if lt.n == 0:
            continue
        spec, big_end, c1end = _k1_rows(lt)
        valid = full.info[:, fe.VALID] == 1
        assert np.array_equal(spec[valid], full.spectrum[valid])
        j_lt = jfe.unpack_data_light(mutated)
        j_spec, j_big, j_c1, _ = jek.decode_spectra(j_lt.md, j_lt.meta, interpret=True)
        assert np.array_equal(spec[valid], np.asarray(j_spec)[valid])
        assert np.array_equal(big_end[valid], np.asarray(j_big)[valid])
        assert np.array_equal(c1end[valid], np.asarray(j_c1)[valid])


def test_fuzz_crafted_aac_paths():
    rng = np.random.default_rng(13)
    aac_seeds = [
        craft_aac.craft_sce_stream(
            4, n_bands=45, energy={40: (1, -1, 1, 0)}, pulses=[(0, 4)],
            tns=dict(length=45, order=3, coefs=[5, 2, 7]),
        ),
        craft_aac.craft_cpe_stream(
            4, n_bands=10, left_energy={b: (1, 0, -1, 0) for b in range(10)},
            is_bands={7: (15, 2), 8: (14, -1), 9: (15, 4)}, ms_used={0, 7},
        ),
    ]
    for seed in aac_seeds:
        for mutated in hostile.mutations(seed, rng, 25):
            u = af.unpack_adts(mutated)
            assert u.n >= 0


# ---------------------------------------------------------------------------
# Route against route: each port route against its JAX counterpart on the
# same mutated streams.
# ---------------------------------------------------------------------------

MUTATIONS_PER_SEED = 3


@pytest.fixture(scope="module")
def cpu_runner():
    """One CPU Runner for the module: its tables are built once."""
    return pr.Runner("cpu")


def _read_clip(name: str) -> bytes:
    with open(os.path.join(smoke.DATA_DIR, name), "rb") as f:
        return f.read()


def _mutated(seeds, seed: int):
    rng = np.random.default_rng(seed)
    return [m for s in seeds for m in hostile.mutations(s, rng, MUTATIONS_PER_SEED)]


@pytest.fixture(scope="module")
def mp3_streams():
    """Mutated 44.1 kHz stereo MP3s (the head of a lame clip, crafted
    intensity and mixed-block streams): the ones that still hold granules
    of the seeds' format, and the ones that hold none."""
    seeds = [_read_clip(smoke.TRANSIENT_TRACK)[:12000], craft.craft_intensity_stream(20),
             craft.craft_mixed_block_stream(20)]
    keep, empty = [], []
    for m in _mutated(seeds, 24):
        u = fe.unpack_data_light_packed(m)
        if u.n == 0:
            empty.append(m)
        elif (u.sample_rate, u.n_channels) == (44100, 2):
            keep.append(m)
    assert len(keep) >= 5
    return keep, empty


@pytest.fixture(scope="module")
def aac_streams():
    """Mutated 44.1 kHz stereo ADTS streams (an encoded M4A's frames, a
    crafted CPE stream with intensity and M/S bands), as mp3_streams."""
    seeds = [af.mp4_to_adts(_read_clip(smoke.AAC_PNS_TRACK)),
             craft_aac.craft_cpe_stream(
                 8, n_bands=10, left_energy={b: (1, 0, -1, 0) for b in range(10)},
                 is_bands={7: (15, 2), 8: (14, -1), 9: (15, 4)}, ms_used={0, 7},
                 global_gain=150)]
    keep, empty = [], []
    for m in _mutated(seeds, 22):
        u = af.unpack_adts_q(m)
        if u.n == 0:
            empty.append(m)
        elif (u.sample_rate, u.n_channels) == (44100, 2):
            keep.append(m)
    assert len(keep) >= 4
    return keep, empty


def _assert_same(mine, theirs, rtol):
    """(hist, loudness dB, peak) of a batch against the JAX package's:
    window counts and loudness exactly equal, peak within rtol (NaN where
    the other is NaN)."""
    hist, louds, peaks = (np.asarray(a) for a in mine)
    j_hist, j_louds, j_peaks = (np.asarray(a) for a in theirs)
    n = len(louds)
    assert np.array_equal(hist.sum(axis=1), j_hist[:n].sum(axis=1))
    assert np.array_equal(louds, j_louds[:n]), (louds, j_louds[:n])
    np.testing.assert_allclose(peaks, j_peaks[:n], rtol=rtol, atol=1e-6)


def _louds(loud_idx) -> np.ndarray:
    return np.array([hi.index_to_loudness(int(i)) for i in np.asarray(loud_idx)])


def _jax_light(datas, sr, nch):
    """The JAX package's raw-bits route on the CPU, as
    MP3RGAIN_DEVICE_ENTROPY=1 runs it there: the interpreted Pallas
    decode, then its light tail with the XLA requantize and hybrid span
    (fused=False, use_fused_hybrid's CPU default)."""
    ups = [jfe.unpack_data_light_packed(d) for d in datas]
    prep, rest, g_max = jpr.prepare_batch_arrays_light(ups, nch, 1)
    spec_b, mout = jek.decode_blocks(
        jnp.asarray(prep.scalars), jnp.asarray(prep.buf), jnp.asarray(prep.meta),
        nb=prep.nb, interpret=True)
    hist, loud_idx, peak = jpr._light_tail(
        spec_b, mout, jnp.asarray(prep.inv), *(jnp.asarray(a) for a in rest),
        nb=prep.nb, g_max=g_max, n_channels=nch, sample_rate=sr,
        dtype=jnp.float32, fused=False, interpret=True)
    return np.asarray(hist), _louds(loud_idx), np.asarray(peak)


def _jax_heavy(datas, sr, nch):
    args = jpr.prepare_batch_arrays([jfe.unpack_data(d) for d in datas], nch)
    hist, loud_idx, peak = jpr._single_device_pipeline(nch, sr, jnp.float32)(*args)
    return np.asarray(hist), _louds(loud_idx), np.asarray(peak)


ROUTES = {
    # route: (streams fixture, port batch, JAX batch, peak rtol)
    "mp3_raw_bits": ("mp3_streams",
                     lambda ds, r: r.analyze_unpacked_light(
                         [fe.unpack_data_light_packed(d) for d in ds], 44100, 2),
                     lambda ds: _jax_light(ds, 44100, 2), 2e-4),
    "mp3_host_decoded": ("mp3_streams",
                         lambda ds, r: r.analyze_unpacked(
                             [fe.unpack_data(d) for d in ds], 44100, 2),
                         lambda ds: _jax_heavy(ds, 44100, 2), 2e-4),
    "aac_q": ("aac_streams",
              lambda ds, r: aac.analyze_batch_q([af.unpack_adts_q(d) for d in ds], 44100, 2,
                                                runner=r),
              lambda ds: jaac.analyze_batch_q([jaf.unpack_adts_q(d) for d in ds], 44100, 2),
              2e-4),
    "aac_f16": ("aac_streams",
                lambda ds, r: aac.analyze_batch([af.unpack_adts(d, f16=True) for d in ds],
                                                44100, 2, runner=r),
                lambda ds: jaac.analyze_batch([jaf.unpack_adts(d, f16=True) for d in ds],
                                              44100, 2),
                1e-3),
}


def _fails_alike(tmp_path, data: bytes, ext: str):
    """Both packages' entry points fail on `data`, with exceptions of the
    same class name and message."""
    from mp3rgain_tpu import analysis as jan

    path = tmp_path / f"hostile{ext}"
    path.write_bytes(data)
    errors = []
    for fn in (lambda: analysis.analyze_track_internal(path, device="cpu"),
               lambda: jan.analyze_track_internal(path)):
        with pytest.raises(Exception) as e:
            fn()
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1], errors


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax_on_mutated_streams(request, tmp_path, cpu_runner, route):
    fixture, mine, theirs, rtol = ROUTES[route]
    keep, empty = request.getfixturevalue(fixture)
    _assert_same(mine(keep, cpu_runner), theirs(keep), rtol)
    for data in empty:
        _fails_alike(tmp_path, data, ".mp3" if fixture == "mp3_streams" else ".aac")


def test_k1_rows_equal_the_host_decoders_on_mutated_streams(mp3_streams):
    """K1 (its plain version) against the port's and the JAX package's
    host decoders, exactly, on every valid granule of the route test's
    MP3 streams."""
    keep, _ = mp3_streams
    for data in keep:
        full, j_full = fe.unpack_data(data), jfe.unpack_data(data)
        valid = full.info[:, fe.VALID] == 1
        assert np.array_equal(valid, j_full.info[:, jfe.VALID] == 1) and valid.any()
        spec, big_end, c1end = _k1_rows(fe.unpack_data_light(data))
        assert np.array_equal(spec[valid], j_full.spectrum[valid])
        assert np.array_equal(big_end[valid], j_full.info[valid, jfe.BIG_END])
        assert np.array_equal(c1end[valid], j_full.info[valid, jfe.COUNT1_END])


# ---------------------------------------------------------------------------
# Non-finite windows: the PNS-overflow stream.
# ---------------------------------------------------------------------------


def test_bin_index_is_xlas_convert():
    """The histogram's bin index equals XLA's float32 -> int32 convert plus
    the int32 add of the offset, on finite, out-of-range and non-finite
    values alike (torch's own cast gives INT_MIN for NaN on an x86 CPU)."""
    v = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0, -2147483648.0,
                  2147481600.0, 1e38, -1e38, 1.5, -1.5, -0.0, -2000.9, -1999.5,
                  9999.9, 10000.0, -37000.0, 385000.0], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int32) + hi.HISTOGRAM_OFFSET)
    got = hi.bin_index(torch.from_numpy(v))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_nan_windows_land_in_bin_2000():
    """A window whose mean square is NaN is counted in bin 2000, as the
    JAX package counts it; an inf one is dropped."""
    sr, win = 44100, hi.window_size(44100)
    x = torch.full((2, 1, 4 * win), 0.1)
    x[0, 0, win + 3] = float("nan")  # window 1 of track 0
    x[1, 0, 2 * win] = float("inf")  # window 2 of track 1
    hist = hi.histogram(x, torch.tensor([4 * win, 4 * win]), win)
    assert hist[0, 2000] == 1 and hist[0].sum() == 4
    assert hist[1].sum() == 3 and hist[1, 2000] == 0


@pytest.mark.parametrize("device_prep", [None, True])
def test_pns_overflow_stream_matches_jax(tmp_path, device_prep):
    """The PNS-overflow stream through the port's entry point on the
    CPU, f16 route (the default) and q route: the JAX package's result,
    loudness 0.00 dB from 58 windows all in bin 2000, peak NaN."""
    path = tmp_path / "pns_overflow.aac"
    path.write_bytes(hostile.pns_overflow_stream())
    r = aac.analyze_track_internal(path, device="cpu", device_prep=device_prep)
    assert r.result.loudness_db == 0.0 and r.result.gain_db == pytest.approx(64.82)
    assert math.isnan(r.result.peak)
    assert r.histogram.sum() == 58 and r.histogram[2000] == 58
    assert r.audio_seconds == pytest.approx(123 * 1024 / 44100)


# ---------------------------------------------------------------------------
# Scan isolation.
# ---------------------------------------------------------------------------


def _same_outcome(a, b) -> bool:
    """Two scan outcomes agree: both exceptions of one class name and
    message, or results with equal loudness, gain, rate and type and
    peaks within rtol 2e-4 (NaN where the other is NaN)."""
    if isinstance(a, Exception) or isinstance(b, Exception):
        return (type(a).__name__, str(a)) == (type(b).__name__, str(b))
    same_peak = (math.isnan(a.peak) and math.isnan(b.peak)) or math.isclose(
        a.peak, b.peak, rel_tol=2e-4, abs_tol=1e-6)
    return same_peak and (a.loudness_db, a.gain_db, a.sample_rate, a.file_type) == (
        b.loudness_db, b.gain_db, b.sample_rate, b.file_type)


def test_scan_isolates_hostile_files(tmp_path, cpu_runner):
    """scan_files on the CPU over good files and mutated ones (an MP3
    that keeps no frame, random bytes, the PNS-overflow stream among
    them), which share the good files' batches: every good file as in a
    scan of the good files alone (histogram exactly, peak within rtol
    1e-6),
    every file's outcome the JAX package's scan_files', the manifest
    holding the analysed files as the JAX package's does, and a resume
    taking those from it and trying the failed ones again, as the JAX
    package's resume does."""
    good = {"intensity.mp3": craft.craft_intensity_stream(20),
            "sane.aac": hostile.sane_sce_frame() * 20}
    rng = np.random.default_rng(48)
    bad = {f"mut{i}.mp3": m
           for i, m in enumerate(hostile.mutations(good["intensity.mp3"], rng, 3))}
    bad.update({f"mut{i}.aac": m
                for i, m in enumerate(hostile.mutations(good["sane.aac"], rng, 2))})
    bad["pns_overflow.aac"] = hostile.pns_overflow_stream()
    bad["noise.mp3"] = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    paths = {}
    for name, data in {**good, **bad}.items():
        paths[name] = str(tmp_path / name)
        with open(paths[name], "wb") as f:
            f.write(data)
    every = list(paths.values())
    runner = cpu_runner
    clean = scan.scan_files([paths[n] for n in good], runner=runner)
    mine = scan.scan_files(every, manifest_path=tmp_path / "torch.json", runner=runner)
    theirs = jscan.scan_files(every, manifest_path=tmp_path / "jax.json")

    for name in good:
        p = paths[name]
        a, b = mine.results[p], clean.results[p]
        assert np.array_equal(mine.histograms[p], clean.histograms[p])
        assert (a.loudness_db, a.gain_db, a.sample_rate, a.file_type) == (
            b.loudness_db, b.gain_db, b.sample_rate, b.file_type)
        # The IMDCT and synthesis GEMMs' rows depend on the batch's row
        # count in the CPU's BLAS (one ulp of the peak for a track batched
        # with others): the peak is held to rtol 1e-6.
        assert a.peak == pytest.approx(b.peak, rel=1e-6)
    failed = [p for p in every if isinstance(mine.results[p], Exception)]
    assert paths["noise.mp3"] in failed and paths["mut1.mp3"] in failed
    assert math.isnan(mine.results[paths["pns_overflow.aac"]].peak)
    for p in every:
        assert _same_outcome(mine.results[p], theirs.results[p]), (
            p, mine.results[p], theirs.results[p])
        if p not in failed:
            assert np.array_equal(mine.histograms[p].sum(), np.asarray(theirs.histograms[p]).sum())

    stored = scan.Manifest(tmp_path / "torch.json").data
    assert set(stored) == set(jscan.Manifest(tmp_path / "jax.json").data) == (
        set(every) - set(failed))
    again = scan.scan_files(every, manifest_path=tmp_path / "torch.json", runner=runner)
    j_again = jscan.scan_files(every, manifest_path=tmp_path / "jax.json")
    assert again.resumed == j_again.resumed == len(every) - len(failed)
    for p in every:
        assert _same_outcome(again.results[p], mine.results[p])
        assert _same_outcome(again.results[p], j_again.results[p])
