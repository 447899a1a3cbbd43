"""Torch port on a CUDA card: each hand-written kernel against its plain
version, both MP3 routes and both AAC routes on the card against the CPU.

Every test carries the `cuda` marker and skips where
torch.cuda.is_available() is false. The file needs neither jax nor an MP3
encoder, so it runs on a GPU machine that has neither: its inputs are
crafted streams (mp3rgain_tpu_torch.testing.craft) and the committed
clips of mp3rgain_tpu_torch/testing/data, and it imports nothing of the
JAX package. Run there with
`python -m pytest tests/test_torch_cuda.py -q -m cuda`.
"""

import os

import numpy as np
import pytest
import torch

from mp3rgain_tpu_torch import _build, aac, scan
from mp3rgain_tpu_torch.decode import aac_frontend as af
from mp3rgain_tpu_torch.decode import aac_prep, aac_synthesis
from mp3rgain_tpu_torch.decode import class_core as cc
from mp3rgain_tpu_torch.decode import entropy_kernel as ek
from mp3rgain_tpu_torch.decode import frontend as fe
from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
from mp3rgain_tpu_torch.decode import synthesis as syn
from mp3rgain_tpu_torch import tracing
from mp3rgain_tpu_torch.parallel import runner as pr
from mp3rgain_tpu_torch.testing import craft
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _clip(name: str) -> bytes:
    with open(os.path.join(smoke.DATA_DIR, name), "rb") as f:
        return f.read()


STREAMS = {
    "mono_22k": lambda: _clip(smoke.MONO_TRACK),
    "transient": lambda: _clip(smoke.TRANSIENT_TRACK),
    "truncated": lambda: _clip(smoke.TRANSIENT_TRACK)[:20000],
    "craft_intensity": craft.craft_intensity_stream,
    "craft_mixed_block": craft.craft_mixed_block_stream,
    "craft_count1b": craft.craft_count1b_stream,
    "craft_lsf_intensity": craft.craft_lsf_intensity_stream,
}


def _on(dev, arrays):
    return [pr._to_device(a, dev) for a in arrays]


def _counts(kernel: str) -> tuple[int, int]:
    """(launches, plain-version calls) of a kernel in the tracing record."""
    return tracing.counter("launches." + kernel), tracing.counter("plain." + kernel)


def _k1_equal(args, luts, dest, n_rows):
    """decode_rows on the card equals its plain version exactly, and a
    second call gives the same bits; returns the rows."""
    with tracing.recording():
        got = ek.decode_rows(*args, luts, dest, n_rows)
        again = ek.decode_rows(*args, luts, dest, n_rows)
        torch.cuda.synchronize()
    assert _counts("entropy_decode_rows") == (2, 0)
    want = ek.decode_rows_reference(*args, luts, dest, n_rows)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(g, a)
    return got


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k1_kernel_matches_plain_and_host(name, dev):
    data = STREAMS[name]()
    light = fe.unpack_data_light(data)
    p = ek.prepare_batch(light.md, light.meta)
    scalars, buf, meta, inv = _on(dev, (p.scalars, p.buf, p.meta, p.inv))
    luts = ek.EntropyLuts().to(dev)
    spec, big_end, c1end = _k1_equal((scalars, buf, meta), luts,
                                     ek.input_order_dest(inv, p.n), p.n)
    full = fe.unpack_data(data)
    valid = full.info[:, fe.VALID] == 1
    got = spec.cpu().numpy().astype(np.int32)
    assert not ((got != full.spectrum).any(axis=1) & valid).any()
    assert np.array_equal(big_end.cpu().numpy()[valid], full.info[valid, fe.BIG_END])
    assert np.array_equal(c1end.cpu().numpy()[valid], full.info[valid, fe.COUNT1_END])


@pytest.mark.parametrize("channel_major", [False, True])
def test_k1_rows_of_a_batch_with_padding_slots(channel_major, dev):
    """Unequal tracks: the row map has padding slots, which read zero."""
    datas = [STREAMS["transient"](), STREAMS["truncated"](), STREAMS["transient"]()]
    ups = [fe.unpack_data_light_packed(d) for d in datas]
    prep, rest, g_max = pr.prepare_batch_arrays_light(ups, 2)
    args = _on(dev, (prep.scalars, prep.buf, prep.meta, prep.inv, rest[0]))
    dest, n_rows = pr.dest_rows(args[3], args[4], g_max=g_max, n_channels=2,
                                channel_major=channel_major)
    # Stale bytes in the allocator's cache must not show through.
    torch.full((n_rows * 576,), 7, dtype=torch.int16, device=dev)
    spec, big_end, c1end = _k1_equal(args[:3], ek.EntropyLuts().to(dev), dest, n_rows)
    covered = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    covered[dest[dest >= 0].long()] = True
    assert int((~covered).sum()) == n_rows - sum(u.n for u in ups) > 0
    assert not spec[~covered].any() and not big_end[~covered].any()
    assert not c1end[~covered].any() and spec[covered].any()


def test_k1_bad_lanes_leave_zero_rows(dev):
    """Tables with one invalid 8-bit window (and one count1 window) make
    lanes go bad mid-row; the kernel must zero what they had written."""
    light = fe.unpack_data_light(STREAMS["transient"]())
    p = ek.prepare_batch(light.md, light.meta)
    scalars, buf, meta, inv = _on(dev, (p.scalars, p.buf, p.meta, p.inv))
    luts = ek.EntropyLuts()
    luts.lut_a[1:, 0b10110011, 1] |= 3 << 4
    luts.lut_ct[:, 0b101100, 1] |= 3 << 4
    luts = luts.to(dev)
    _, mout = ek.decode_blocks_reference(scalars, buf, meta, luts)
    assert int(mout[:, 2].sum()) > 0
    spec, big_end, c1end = _k1_equal((scalars, buf, meta), luts,
                                     ek.input_order_dest(inv, p.n), p.n)
    bad = mout[:, 2].reshape(-1)[inv[: p.n].long()] == 1
    assert not spec[bad].any() and not c1end[bad].any() and spec[~bad].any()


@pytest.mark.parametrize("name", ["mono_22k", "transient", "craft_intensity",
                                  "craft_lsf_intensity", "craft_mixed_block"])
def test_k2_kernel_matches_plain(name, dev):
    u = fe.unpack_data_light_packed(STREAMS[name]())
    prep, rest, g_max = pr.prepare_batch_arrays_light([u], u.n_channels)
    args = _on(dev, (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
    tail = pr.LightTail(u.sample_rate, u.n_channels).to(dev)
    dest, n_rows = pr.dest_rows(args[3], args[4], g_max=g_max,
                                n_channels=u.n_channels, channel_major=True)
    rows = ek.decode_rows(*args[:3], tail.luts, dest, n_rows)
    cm = pr.channel_major_inputs(*rows, *args[4:11], nb=prep.nb,
                                 g_max=g_max, n_channels=u.n_channels)
    with tracing.recording():
        got = hk.fused_requant_stereo(*cm, tail.hybrid)
        torch.cuda.synchronize()
    assert _counts("requant_stereo")[0] == 1
    want = hk.fused_requant_stereo_reference(*cm, tail.hybrid)
    scale = want.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("nch,rows,sr_row", [(1, 1, 4), (1, 1001, 8), (2, 1, 0),
                                             (2, 37, 3), (2, 1001, 5)])
def test_k2_kernel_matches_plain_on_random_rows(nch, rows, sr_row, dev):
    """Random fields cover every class, M/S, MPEG-1 and LSF intensity
    (with both intensity scales and is_pos 7) at row counts that fill no
    whole block; LSF tables for the LSF rates."""
    rng = np.random.default_rng(rows * 10 + nch)
    spec = rng.integers(-40, 41, (nch, rows, 576))
    spec[..., :4] = rng.integers(-8206, 8207, (nch, rows, 4))
    spec[..., 400:] = 0
    scf = rng.integers(0, 16, (nch, rows, 64))
    scf[..., 5] = 7
    gm = np.zeros((nch, rows, hk.GM_N), np.int64)
    gm[..., hk.GM_GG] = rng.integers(100, 256, (nch, rows))
    for f, hi_ in ((hk.GM_SFS, 2), (hk.GM_PRE, 2), (hk.GM_SBG0, 8), (hk.GM_SBG1, 8),
                   (hk.GM_SBG2, 8), (hk.GM_BT, 4), (hk.GM_CLS, 3), (hk.GM_MS, 2),
                   (hk.GM_IS, 2), (hk.GM_LSF, 2), (hk.GM_ISC, 2)):
        gm[..., f] = rng.integers(0, hi_, (nch, rows))
    gm[..., hk.GM_RZO] = rng.integers(0, 577, (nch, rows))
    t = [torch.from_numpy(a.astype(d)).to(dev)
         for a, d in ((spec, np.int16), (scf, np.int8), (gm, np.int32))]
    tables = hk.HybridTables(sr_row).to(dev)
    got = hk.fused_requant_stereo(*t, tables)
    want = hk.fused_requant_stereo_reference(*t, tables)
    scale = want.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
    empty = hk.fused_requant_stereo(*(x[:, :0] for x in t), tables)
    assert empty.shape == (nch, 0, 576)


def _close(got, want):
    """The kernel tests' tolerance (K2's): rtol 1e-5, atol 1e-6 x the
    rows' scale."""
    scale = want.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("nch,rows,sr_row", [(1, 1, 4), (1, 1001, 8), (2, 1, 0),
                                             (2, 37, 3), (2, 1001, 5), (2, 1001, 1),
                                             (1, 333, 6)])
def test_k4_hybrid_synthesis_matches_plain_on_random_rows(nch, rows, sr_row, dev):
    """Random spectra in rows of every class and block type (long bt
    0/1/3, short, mixed; the same class with each block type), rows of no
    class and all-zero padding rows; MPEG-1, LSF and MPEG-2.5 tables."""
    rng = np.random.default_rng(rows * 10 + sr_row)
    xr = rng.standard_normal((nch, rows, 576)) * rng.uniform(0.01, 100.0, (nch, rows, 1))
    gm = np.zeros((nch, rows, hk.GM_N), np.int32)
    gm[..., hk.GM_BT] = rng.integers(0, 4, (nch, rows))
    gm[..., hk.GM_CLS] = np.where(gm[..., hk.GM_BT] == 2, rng.integers(1, 3, (nch, rows)),
                                  rng.integers(0, 3, (nch, rows)))
    if rows > 10:
        gm[:, 3, hk.GM_CLS] = 3  # no class: zeros, as the masked products give
        xr[:, 5:9] = 0.0
        gm[:, 5:9] = 0  # padding rows
    xr_t = torch.from_numpy(xr.astype(np.float32)).to(dev)
    gm_t = torch.from_numpy(gm).to(dev)
    tables = hk.HybridTables(sr_row).to(dev)
    with tracing.recording():
        got = hk.hybrid_synthesis(xr_t, gm_t, tables)
        torch.cuda.synchronize()
        assert _counts("hybrid_synthesis") == (1, 0)
    _close(got, hk.hybrid_gemm(xr_t, gm_t, tables))
    if rows > 10:
        assert not got[:, 3].any() and not got[:, 5:9].any()
    empty = hk.hybrid_synthesis(xr_t[:, :0], gm_t[:, :0], tables)
    assert empty.shape == (nch, 0, 1152)


# T: runs of 64 granule-times walked 4 at a time, so 1, 3 and 5 end inside
# a step, 64 fills a run, 65 and 150 start runs mid-track (halo).
@pytest.mark.parametrize("nch,bsz,tt", [(1, 1, 1), (2, 3, 3), (1, 2, 5), (2, 1, 64),
                                        (2, 2, 65), (1, 3, 150), (2, 5, 129)])
def test_k5_overlap_polyphase_matches_plain(nch, bsz, tt, dev):
    rng = np.random.default_rng(nch * 1000 + bsz * 100 + tt)
    z = rng.standard_normal((nch, bsz, tt, 1152)).astype(np.float32)
    z *= rng.uniform(0.01, 10.0, (nch, bsz, 1, 1)).astype(np.float32)
    z_t = torch.from_numpy(z).to(dev)
    tables = syn.DecodeTables(0).to(dev)
    with tracing.recording():
        got = syn.overlap_polyphase(z_t, tables)
        torch.cuda.synchronize()
        assert _counts("overlap_polyphase") == (1, 0)
    assert got.shape == (nch, bsz, tt * 576)
    _close(got, syn.overlap_polyphase_reference(z_t, tables))
    assert syn.overlap_polyphase(z_t[:, :, :0], tables).shape == (nch, bsz, 0)


@pytest.mark.parametrize("name", ["mono_22k", "transient", "craft_intensity",
                                  "craft_lsf_intensity", "craft_mixed_block"])
def test_k4_k5_match_plain_on_decoded_streams(name, dev):
    """K2's output of real streams (long, short and mixed blocks, MPEG-1 and
    LSF, mono and stereo) through K4 and K5 against the plain versions."""
    u = fe.unpack_data_light_packed(STREAMS[name]())
    prep, rest, g_max = pr.prepare_batch_arrays_light([u, u], u.n_channels)
    args = _on(dev, (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
    tail = pr.LightTail(u.sample_rate, u.n_channels).to(dev)
    dest, n_rows = pr.dest_rows(args[3], args[4], g_max=g_max,
                                n_channels=u.n_channels, channel_major=True)
    rows = ek.decode_rows(*args[:3], tail.luts, dest, n_rows)
    cm = pr.channel_major_inputs(*rows, *args[4:11], nb=prep.nb,
                                 g_max=g_max, n_channels=u.n_channels)
    xr = hk.fused_requant_stereo(*cm, tail.hybrid)
    got = hk.hybrid_synthesis(xr, cm[2], tail.hybrid)
    want = hk.hybrid_gemm(xr, cm[2], tail.hybrid)
    _close(got, want)
    z = want.reshape(u.n_channels, -1, g_max // u.n_channels, 1152)
    _close(syn.overlap_polyphase(z, tail.decode),
           syn.overlap_polyphase_reference(z, tail.decode))


def test_light_scan_launches_k4_and_k5_once_per_batch(dev, tmp_path):
    """analyze_library over 3 light batches launches each synthesis kernel
    once a batch and never its plain version."""
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"t{i}.mp3"))
        with open(paths[-1], "wb") as f:
            f.write(_clip(smoke.MONO_TRACK))
    runner = pr.Runner(dev)
    with tracing.recording():
        res = pr.analyze_library(paths, runner=runner, max_batch=2)
        assert len(runner.timings) == 3
        assert _counts("hybrid_synthesis") == _counts("overlap_polyphase") == (3, 0)
    u = fe.unpack_data_light_packed(_clip(smoke.MONO_TRACK))
    c_hist, c_louds, c_peaks = pr.Runner("cpu").analyze_unpacked_light(
        [u], u.sample_rate, u.n_channels)
    for t in res.tracks:
        assert t.ok and int(t.histogram.sum()) == int(c_hist.sum())
        assert abs(t.result.loudness_db - c_louds[0]) <= 0.02 + 1e-9
        np.testing.assert_allclose(t.result.peak, c_peaks[0], rtol=2e-4, atol=1e-6)


def test_light_path_on_card_matches_cpu(dev):
    u = fe.unpack_data_light_packed(_clip(smoke.TRANSIENT_TRACK))
    with tracing.recording():
        hist, louds, peaks = pr.Runner(dev).analyze_unpacked_light(
            [u, u], u.sample_rate, u.n_channels)
    assert _counts("entropy_decode_rows") == _counts("requant_stereo") == (1, 0)
    c_hist, c_louds, c_peaks = pr.Runner("cpu").analyze_unpacked_light(
        [u], u.sample_rate, u.n_channels)
    assert np.array_equal(hist.sum(axis=1), np.repeat(c_hist.sum(axis=1), 2))
    assert np.all(np.abs(louds - c_louds[0]) <= 0.02 + 1e-9)
    np.testing.assert_allclose(peaks, c_peaks[0], rtol=2e-4, atol=1e-6)


def test_library_on_card_matches_runner_batches(dev, tmp_path):
    """analyze_library over 3 pipelined batches (6 copies of a clip, two
    to a batch) equals Runner(dev) on one such batch, with K1 and K2
    launched once per batch and the album summed on the card."""
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"t{i}.mp3"))
        with open(paths[-1], "wb") as f:
            f.write(_clip(smoke.TRANSIENT_TRACK))
    runner = pr.Runner(dev)
    with tracing.recording():
        res = pr.analyze_library(paths, runner=runner, album=True, max_batch=2)
    assert len(runner.timings) == 3
    assert _counts("entropy_decode_rows") == _counts("requant_stereo") == (3, 0)
    u = fe.unpack_data_light_packed(_clip(smoke.TRANSIENT_TRACK))
    hist, louds, peaks = pr.Runner(dev).analyze_unpacked_light(
        [u, u], u.sample_rate, u.n_channels)
    for t in res.tracks:
        assert t.ok and isinstance(t.histogram, np.ndarray)
        assert int(t.histogram.sum()) == int(hist[0].sum())
        assert abs(t.result.loudness_db - louds[0]) <= 0.02 + 1e-9
        np.testing.assert_allclose(t.result.peak, peaks[0], rtol=2e-4, atol=1e-6)
    assert np.array_equal(res.album_histogram,
                          np.sum([t.histogram for t in res.tracks], axis=0))
    assert all(t["device_ms"] > 0 for t in runner.timings)


def test_failed_kernel_library_raises(dev, monkeypatch):
    def broken():
        raise RuntimeError("build failed")

    monkeypatch.setattr(_build, "library", broken)
    p = ek.prepare_batch(*(lambda lt: (lt.md, lt.meta))(
        fe.unpack_data_light(craft.craft_count1b_stream())))
    args = _on(dev, (p.scalars, p.buf, p.meta, p.inv))
    with tracing.recording(), pytest.raises(RuntimeError, match="build failed"):
        ek.decode_rows(*args[:3], ek.EntropyLuts().to(dev),
                       ek.input_order_dest(args[3], p.n), p.n)
    assert _counts("entropy_decode_rows")[1] == 0


# rows: 1000 is 7 full row tiles of 128 and a partial one of 104; 300 is
# 3 tiles (18 output tiles, fewer than the card's SMs); 40 is one partial
# tile.
@pytest.mark.parametrize("ncore,npass,select,rows", [
    (1, 1, False, 1000), (2, 2, False, 1000), (3, 3, False, 1000), (3, 3, True, 1000),
    (3, 2, True, 1000), (3, 1, True, 1000), (1, 3, True, 1000), (1, 3, False, 1000),
    (3, 3, True, 300), (2, 1, False, 300), (3, 3, False, 40)])
def test_k3_kernel_matches_plain(ncore, npass, select, rows, dev):
    rng = np.random.default_rng(ncore * 10 + npass)
    x = torch.from_numpy(rng.standard_normal((2, rows, 576)).astype(np.float32)).to(dev)
    cores = torch.from_numpy(rng.standard_normal((ncore, 576, 1152)).astype(np.float32))
    chi, clo = (t.to(dev) for t in cc.split_bf16(cores))
    row_core = None
    if select:
        rc = rng.integers(0, ncore, (2, rows)).astype(np.int32)
        rc[0, :256] = 0  # tiles of one class skip the other cores
        rc[1, rows // 3 : rows // 3 + 10] = -1  # rows of no class come out zero
        row_core = torch.from_numpy(rc).to(dev)
    with tracing.recording():
        got = cc.class_core_gemm(x, chi, clo, npass=npass, row_core=row_core)
        torch.cuda.synchronize()
    assert _counts("class_core_gemm") == (1, 0)
    want = cc.class_core_gemm_reference(x, chi, clo, npass=npass, row_core=row_core)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    if select:
        assert not got[1, rows // 3 : rows // 3 + 10].any()
    # No split-K and no atomics: a second call gives the same bits.
    again = cc.class_core_gemm(x, chi, clo, npass=npass, row_core=row_core)
    assert torch.equal(got, again)


def test_k3_rejects_misaligned_input(dev):
    """TMA takes 16-byte aligned tensors; the wrapper raises before a launch."""
    x = torch.zeros(4 * 576 + 1, device=dev)[1:].view(1, 4, 576)
    chi = torch.zeros((1, 576, 1152), dtype=torch.bfloat16, device=dev)
    with tracing.recording(), pytest.raises(ValueError, match="16-byte aligned"):
        cc.class_core_gemm(x, chi, chi)
    assert _counts("class_core_gemm")[0] == 0


def test_k3_failed_library_raises(dev, monkeypatch):
    def broken():
        raise RuntimeError("build failed")

    monkeypatch.setattr(_build, "library", broken)
    x = torch.zeros((1, 4, 576), device=dev)
    chi = torch.zeros((1, 576, 1152), dtype=torch.bfloat16, device=dev)
    with tracing.recording(), pytest.raises(RuntimeError, match="build failed"):
        cc.class_core_gemm(x, chi, chi)
    assert _counts("class_core_gemm")[1] == 0


def test_heavy_route_on_card_matches_cpu_and_light(dev):
    data = _clip(smoke.TRANSIENT_TRACK)
    full = fe.unpack_data(data)
    with tracing.recording():
        hist, louds, peaks = pr.Runner(dev).analyze_unpacked(
            [full, full], full.sample_rate, full.n_channels)
    assert _counts("class_core_gemm") == (1, 0)
    c_hist, c_louds, c_peaks = pr.Runner("cpu").analyze_unpacked(
        [full], full.sample_rate, full.n_channels)
    assert np.array_equal(hist.sum(axis=1), np.repeat(c_hist.sum(axis=1), 2))
    assert np.all(np.abs(louds - c_louds[0]) <= 0.02 + 1e-9)
    np.testing.assert_allclose(peaks, c_peaks[0], rtol=2e-4, atol=1e-6)

    # light_tail(fused=False) on the card equals the heavy route exactly.
    u = fe.unpack_data_light_packed(data)
    prep, rest, g_max = pr.prepare_batch_arrays_light([u, u], u.n_channels)
    args = _on(dev, (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
    tail = pr.LightTail(u.sample_rate, u.n_channels).to(dev)
    light = pr.analysis_core_light(tail, *args, nb=prep.nb, g_max=g_max, fused=False)
    heavy_args = _on(dev, pr.prepare_batch_arrays([full, full], full.n_channels))
    heavy = pr.analysis_core(tail, *heavy_args)
    for a, b in zip(light, heavy):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", [smoke.MONO_TRACK, smoke.TRANSIENT_TRACK])
def test_decode_file_on_card_matches_cpu(name, dev):
    path = os.path.join(smoke.DATA_DIR, name)
    got, sr = syn.decode_file(path, device=dev)
    want, sr_cpu = syn.decode_file(path, device="cpu")
    assert sr == sr_cpu and got.shape == want.shape
    bound = 5e-4 * np.sqrt((want ** 2).mean()) + 1e-5
    assert np.abs(got - want).max() < bound


# --- the AAC/M4A path (torch ops; no kernel of this port lies on it) -------------

AAC_CLIPS = [smoke.AAC_TRANSIENT_TRACK, smoke.AAC_PNS_TRACK, smoke.AAC_ADTS_TRACK,
             smoke.AAC_TWO_TRACKS]


def test_aac_bit_exact_pieces_on_card(dev):
    """The noise hash (int32 wraparound, arithmetic shifts), the nibble
    unpack over all 256 bytes and the escape scatter with int32 and int64
    indices give the CPU's bits."""
    cpu, card = aac_prep.AacPrep(22050), aac_prep.AacPrep(22050).to(dev)
    for rows in (1, 300, 5000):
        assert torch.equal(card.noise_uniform(rows).cpu(), cpu.noise_uniform(rows))
    b = torch.arange(-128, 128, dtype=torch.int8)
    for got, want in zip(aac_prep.unpack_nibbles(b.to(dev)), aac_prep.unpack_nibbles(b)):
        assert torch.equal(got.cpu(), want)
    rng = np.random.default_rng(3)
    spec_q4 = torch.from_numpy(rng.integers(-128, 128, (2, 40, 64), dtype=np.int8))
    idx = rng.choice(2 * 40 * 1024, 500, replace=False)
    val = torch.from_numpy(rng.integers(-8000, 8000, 500).astype(np.int16))
    for dt in (np.int32, np.int64):
        esc = torch.from_numpy(idx.astype(dt))
        want = aac_prep.unpack_quantized(spec_q4, esc, val)
        got = aac_prep.unpack_quantized(spec_q4.to(dev), esc.to(dev), val.to(dev))
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", AAC_CLIPS)
def test_aac_prep_and_synthesis_on_card_match_cpu(name, dev):
    """prep_spectra within rel 1e-5 of the row maximum and the decoded PCM
    within abs 1e-5 of the CPU's, on the same uploaded arrays."""
    uq = af.unpack_file_q(os.path.join(smoke.DATA_DIR, name))
    nch = uq.n_channels
    p = pr.Runner("cpu").prepare_aac_q([uq], uq.sample_rate, nch)
    out = {}
    for d in ("cpu", dev):
        tail = aac.AacTail(uq.sample_rate, nch).to(d)
        args = _on(torch.device(d), p.arrays)
        spec = tail.prep.prep_spectra(*args[:7], n_channels=nch)
        pcm = tail.synthesis.decode(spec, args[7], args[8], args[10],
                                    p.shapes["short_counts"], n_channels=nch)
        out[str(d)] = (spec.cpu().numpy()[0], pcm.cpu().numpy()[0])
    (s_c, p_c), (s_g, p_g) = out["cpu"], out[str(dev)]
    scale = np.abs(s_c).max(axis=1, keepdims=True)
    assert (np.abs(s_g - s_c) <= 1e-5 * scale + 1e-30).all()
    assert np.abs(p_g - p_c).max() < 1e-5


@pytest.mark.parametrize("device_prep", [True, False])
def test_aac_routes_on_card_match_cpu(device_prep, dev):
    """A batch of tracks of different lengths on each route: window
    counts equal, index within 2 bins, peak rtol 2e-4 of the CPU's."""
    paths = [os.path.join(smoke.DATA_DIR, n)
             for n in (smoke.AAC_PNS_TRACK, smoke.AAC_TRANSIENT_TRACK, smoke.AAC_TWO_TRACKS)]
    ups = [aac.unpack_for(p, None, device_prep) for p in paths]
    batch = aac.analyze_batch_q if device_prep else aac.analyze_batch
    g_hist, g_louds, g_peaks = batch(ups, 44100, 2, runner=pr.Runner(dev))
    c_hist, c_louds, c_peaks = batch(ups, 44100, 2, runner=pr.Runner("cpu"))
    assert np.array_equal(g_hist.sum(axis=1), c_hist.sum(axis=1))
    assert np.abs(np.round(g_louds * 100) - np.round(c_louds * 100)).max() <= 2
    np.testing.assert_allclose(g_peaks, c_peaks, rtol=2e-4)


def test_aac_scan_on_card_matches_single_tracks(dev, tmp_path):
    """scan_files over AAC and MP3 files on the card (device prep by
    default), two batches per bucket, against each file alone; the resume
    covers the AAC records."""
    from mp3rgain_tpu_torch import analysis

    names = AAC_CLIPS + [smoke.TRANSIENT_TRACK, smoke.AAC_PNS_TRACK]
    paths = []
    for i, name in enumerate(names):
        paths.append(str(tmp_path / f"{i}_{name}"))
        os.symlink(os.path.join(smoke.DATA_DIR, name), paths[-1])
    runner = pr.Runner(dev)
    manifest = tmp_path / "scan.json"
    res = scan.scan_files(paths, manifest_path=manifest, runner=runner)
    assert {t["route"] for t in runner.timings} == {"light", "aac_q"}
    for p in paths:
        alone = analysis.analyze_track_internal(p, runner=runner)
        got = res.results[p]
        assert got.file_type == alone.result.file_type
        assert int(res.histograms[p].sum()) == int(alone.histogram.sum())
        assert abs(round(got.loudness_db * 100) - round(alone.result.loudness_db * 100)) <= 1
        np.testing.assert_allclose(got.peak, alone.result.peak, rtol=1e-5)
    n = len(runner.timings)
    again = scan.scan_files(paths, manifest_path=manifest, runner=runner)
    assert again.resumed == len(paths) and len(runner.timings) == n


def test_aac_decode_file_on_card_matches_cpu(dev):
    path = os.path.join(smoke.DATA_DIR, smoke.AAC_TRANSIENT_TRACK)
    got, sr = aac.decode_file(path, device=dev)
    want, sr_c = aac.decode_file(path, device="cpu")
    assert sr == sr_c == 44100 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    assert aac_synthesis.EIGHT_SHORT in af.unpack_file(path).info[:, af.WINDOW_SEQ]


def test_two_runners_on_the_card_equal_one(dev, tmp_path):
    """analyze_library dealt across two Runners on the card gives every
    track the one-Runner result exactly, K1 and K2 launch once per MP3
    batch, and a batch split over the two equals the single dispatch."""
    paths = []
    for i in range(12):
        name = (smoke.TRANSIENT_TRACK, smoke.MONO_TRACK)[i % 2]
        paths.append(str(tmp_path / f"t{i:02d}.mp3"))
        os.symlink(os.path.join(smoke.DATA_DIR, name), paths[-1])
    one = pr.analyze_library(paths, runner=pr.Runner(dev), album=True, max_batch=2)
    runners = [pr.Runner(dev), pr.Runner(dev)]
    with tracing.recording():
        two = pr.analyze_library(paths, runners=runners, album=True, max_batch=2)
    batches = [len(r.timings) for r in runners]
    assert min(batches) >= 1 and sum(batches) == 6
    assert _counts("entropy_decode_rows") == _counts("requant_stereo") == (6, 0)
    for a, b in zip(two.tracks, one.tracks):
        assert a.ok and a.result == b.result and np.array_equal(a.histogram, b.histogram)
    assert np.array_equal(two.album_histogram, one.album_histogram)
    assert np.array_equal(two.album_histogram,
                          np.sum([t.histogram for t in two.tracks], axis=0))

    group = pr.RunnerGroup(runners=runners)
    ups = [fe.unpack_data_light_packed(_clip(smoke.TRANSIENT_TRACK)) for _ in range(4)]
    single = runners[0].analyze_unpacked_light(ups, 44100, 2)
    sharded = group.collect(group.dispatch_light_sharded(ups, 44100, 2))
    for a, b in zip(single, sharded):
        assert np.array_equal(a, b)
    total, top = group.album_reduce_device(single[0], single[2])
    assert np.array_equal(total, single[0].sum(axis=0, dtype=np.int64))
    assert top == float(single[2].max())


def test_dryruns_on_the_card(dev, capfd):
    from mp3rgain_tpu_torch.parallel import dryrun

    with tracing.recording():
        dryrun.dryrun_multichip(2)
    assert _counts("class_core_gemm") == (3, 0)
    dryrun.dryrun_multihost(2, timeout_s=300)
    assert capfd.readouterr().out.count("album union bit-equal over gloo") == 2


def test_bin_index_and_nan_windows_on_card_match_cpu(dev):
    """The histogram's bin index on the card equals the CPU's on NaN,
    infinite and out-of-range values (XLA's convert: NaN -> 0,
    saturating, then the int32 add of the offset with its wrap), and a
    NaN window lands in bin 2000 on the card as on the CPU."""
    from mp3rgain_tpu_torch.ops import histogram as hi

    v = torch.tensor([float("nan"), float("inf"), float("-inf"), 3e9, -3e9, 1e38,
                      -2000.9, 1.5, -1.5, 9999.9])
    assert torch.equal(hi.bin_index(v.to(dev)).cpu(), hi.bin_index(v))
    win = hi.window_size(44100)
    x = torch.full((1, 2, 3 * win), 0.1)
    x[0, 1, win + 5] = float("nan")
    lens = torch.tensor([3 * win])
    got = hi.histogram(x.to(dev), lens.to(dev), win).cpu()
    assert torch.equal(got, hi.histogram(x, lens, win)) and got[0, 2000] == 1


def test_pns_overflow_stream_on_card_matches_cpu(dev, tmp_path):
    """The PNS-overflow ADTS stream (testing/hostile.py) on the card's q
    route and on the CPU: 0.00 dB from 58 windows in bin 2000, peak NaN."""
    from mp3rgain_tpu_torch.testing import hostile

    path = tmp_path / "pns_overflow.aac"
    path.write_bytes(hostile.pns_overflow_stream())
    for device in (dev, "cpu"):
        r = aac.analyze_track_internal(path, device=device, device_prep=True)
        assert r.result.loudness_db == 0.0 and np.isnan(r.result.peak)
        assert r.histogram.sum() == r.histogram[2000] == 58


def test_entry_on_the_card_matches_the_cpu(dev):
    """entry() on the card: K3 launched, no plain call; windows exact,
    loudness index within 2 bins and peak within rtol 2e-4 of the CPU."""
    from mp3rgain_tpu_torch import entry

    fn, args = entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    with tracing.recording():
        hist, idx, peak = (t.cpu().numpy() for t in fn(*args))
    launches, plain = _counts("class_core_gemm")
    assert launches >= 1 and plain == 0
    c_fn, c_args = entry.entry(device="cpu")
    c_hist, c_idx, c_peak = (t.numpy() for t in c_fn(*c_args))
    assert np.array_equal(hist.sum(axis=1), c_hist.sum(axis=1))
    assert np.abs(idx.astype(int) - c_idx.astype(int)).max() <= 2
    np.testing.assert_allclose(peak, c_peak, rtol=2e-4)


def test_kernel_build_entry_point(dev):
    """`python -m mp3rgain_tpu_torch._build --force` builds the kernel
    library and prints its path and the seconds spent."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "mp3rgain_tpu_torch._build", "--force"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    path, seconds, unit = proc.stdout.split()
    assert path == _build.LIB_PATH and os.path.exists(path)
    assert float(seconds) > 0 and unit == "s"
