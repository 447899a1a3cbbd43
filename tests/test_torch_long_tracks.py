"""Torch port: tracks over the rows cap, cut into segments that carry the
decoder and filter state (parallel.runner.segment_plan, split_track).

On the CPU with a small rows cap, so that a tiled 44.1 kHz stereo track
and a tiled 22.05 kHz mono MPEG-2 track each run as three or more
segments: the plan (every segment under the cap, cuts on whole 50 ms
windows, a mono track cut where a stereo one of its length is), the
filter carried over chunks against one pass in float64 at every rate, the
segmented path's filtered samples and the bins of the windows after each
cut against one batch's, the segmented path against one batch through
analyze_library,
analyze_track_internal and analyze_album (window count and loudness
index exact, peak within rtol 2e-4, histograms within the batch-shape
caveat: a few windows one bin away), against the float64 reference
(testing/reference.py, 0.005 dB), a track under the cap bit-equal to the
one-batch path, out-of-memory retry and isolation of a segment (and
its failure raised in the per-file path), the
spans and counters of a traced run, and the peak gauge naming its batch.
"""

import os

import numpy as np
import pytest
import torch

from mp3rgain_tpu_torch import analysis, tracing
from mp3rgain_tpu_torch.decode import frontend as fe
from mp3rgain_tpu_torch.decode.synthesis import decode_file
from mp3rgain_tpu_torch.ops import coeffs, iir
from mp3rgain_tpu_torch.ops import histogram as hi
from mp3rgain_tpu_torch.parallel import runner as pr
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke
from mp3rgain_tpu_torch.testing import reference, tile

torch.set_num_threads(2)

# 1,400 padded rows: 490-granule segments of the stereo track (two cut
# units, 984 rows with the halo, padded to 1,136), 551-granule segments of
# the mono one (one cut unit, 553 rows padded to 666, under half the cap).
CAP = 1400
TRACKS = {"stereo_44k": (smoke.HOT_TRACK, 3),  # 1,149 granules: 3 segments
          "mono_22k": (smoke.MONO_TRACK, 12)}  # 1,378 granules: 3 segments


def _idx(loudness_db: float) -> int:
    return round(loudness_db * 100) + hi.HISTOGRAM_OFFSET


@pytest.fixture(scope="module")
def long_tracks(tmp_path_factory):
    out = tmp_path_factory.mktemp("long_tracks")
    paths = []
    for name, (clip, copies) in TRACKS.items():
        with open(os.path.join(smoke.DATA_DIR, clip), "rb") as f:
            src = f.read()
        path = str(out / f"{name}.mp3")
        tile.tile_mp3(src, path, copies)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def whole(long_tracks):
    """One batch per track (the default cap is far above these tracks)."""
    return pr.analyze_library(long_tracks, runner=pr.Runner("cpu"), album=True)


@pytest.fixture(scope="module")
def segmented(long_tracks):
    """analyze_library at CAP, traced, with every prepared batch kept:
    (result, snapshot, [(padded rows, segment or None)])."""
    runner = pr.Runner("cpu")
    batches = []
    real = runner.prepare_light

    def keep(ups, sr, nch):
        p = real(ups, sr, nch)
        rows = len(p.arrays[pr.LIGHT_COUNTS]) * p.shapes["g_max"]
        batches.append((rows, p.shapes.get("segment")))
        return p

    runner.prepare_light = keep
    with tracing.recording():
        res = pr.analyze_library(long_tracks, runner=runner, album=True, rows_cap=CAP)
        snap = tracing.snapshot()
    return res, snap, batches


def assert_close(a, b, what):
    """Window count and loudness index exact, peak within rtol 2e-4, at
    most 3 windows one bin away."""
    assert a.ok and b.ok, what
    assert int(a.histogram.sum()) == int(b.histogram.sum()), what
    assert _idx(a.result.loudness_db) == _idx(b.result.loudness_db), what
    np.testing.assert_allclose(a.result.peak, b.result.peak, rtol=2e-4, err_msg=what)
    assert int(np.abs(a.histogram.astype(np.int64) - b.histogram).sum()) <= 6, what
    assert a.result.sample_rate == b.result.sample_rate, what


@pytest.mark.parametrize("sample_rate,n_channels,unit", [
    (44100, 2, 245), (48000, 2, 25), (22050, 1, 551), (44100, 1, 245), (24000, 1, 25)])
@pytest.mark.parametrize("rows_cap", [1024, 5000, 77_777, pr.ROWS_CAP])
def test_segment_plan_keeps_the_cap_and_cuts_on_whole_windows(sample_rate, n_channels,
                                                              unit, rows_cap):
    assert pr.cut_granules(sample_rate) == unit
    win = hi.window_size(sample_rate)
    total = 3 * rows_cap // n_channels + 17  # granule-times: over the cap, ragged end
    plan = pr.segment_plan(total * n_channels, sample_rate, n_channels, rows_cap)
    budget = rows_cap * n_channels // 2  # a mono segment: half the cap's rows
    if (unit + pr.HALO) * n_channels > budget:
        assert plan is None  # not even one cut unit fits: one batch, as before
        return
    assert len(plan) >= 3
    assert plan[0][0] == 0 and plan[-1][1] == total
    for (a, b), (c, _) in zip(plan, plan[1:]):
        assert b == c and (b - a) % unit == 0 and (b - a) * 576 % win == 0
    for k, (a, b) in enumerate(plan):
        halo = min(pr.HALO, a)
        padded = pr._quantize_up((b - a + halo) * n_channels, 2 * n_channels,
                                 base=512, ratio=1.3)
        assert padded <= budget <= rows_cap, (k, padded)
    # A track that fits is not cut; nor is one where no cut unit fits. A
    # mono track over half the cap's rows is cut: its row is as long as a
    # stereo track's over the cap.
    assert pr.segment_plan(400, sample_rate, n_channels, rows_cap) is None
    half = pr.segment_plan(rows_cap // 2 + 4, sample_rate, n_channels, rows_cap)
    assert (half is None) == (n_channels == 2)
    assert pr.segment_plan(10**6, sample_rate, n_channels, 1) is None


@pytest.mark.parametrize("sample_rate", sorted(coeffs.YULE_A))
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "doubling"])
def test_the_filter_carried_over_chunks_equals_one_pass(sample_rate, dense, monkeypatch):
    """EqualLoudness over three ragged chunks, each from the state the one
    before it left, against one pass, in float64: grouped rates (Yule and
    Butterworth), the biquad cascades (64 and 96 kHz), the degenerate 88.2
    kHz; the dense level-2 solve and the doubling scan."""
    if not dense:
        monkeypatch.setattr(iir, "NB2_DENSE_MAX", 1)
    n = 3 * iir.L2 * iir.DEFAULT_BLOCK + 4321  # four superblocks
    x = torch.from_numpy(np.random.default_rng(sample_rate).normal(0, 3000, (2, n)))
    eq = iir.EqualLoudness(sample_rate)
    want, _ = eq(x)
    cuts = [0, 20_011, 20_011 + iir.L2 * iir.DEFAULT_BLOCK + 77, n]
    got, state = [], None
    for a, b in zip(cuts, cuts[1:]):
        y, ends = eq(x[:, a:b], state, None if b == n else b - a)
        got.append(y)
        assert len(ends) == (2 * len(eq.plan) if b != n else 0)
        state = torch.cat(ends, dim=1) if ends else None
        assert state is None or state.shape == (2, eq.state_width)
    torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=1e-9,
                               atol=1e-9 * float(want.abs().max()))


def test_segments_filter_and_window_as_the_whole_track_after_each_cut(long_tracks,
                                                                      monkeypatch):
    """The segmented path's filtered samples equal the one-batch path's
    across each cut, and the windows that follow each cut fall in the same
    bins (a zero-state restart or a misordered state would not)."""
    calls = []
    real = hi.histogram

    def keep(filtered, valid, win):
        calls.append((filtered[0].clone(), int(valid[0])))
        return real(filtered, valid, win)

    monkeypatch.setattr(hi, "histogram", keep)
    monkeypatch.setattr(pr, "ROWS_CAP", CAP)
    runner = pr.Runner("cpu")
    for path in long_tracks:
        with open(path, "rb") as f:
            u = fe.unpack_data_light_packed(f.read())
        win = hi.window_size(u.sample_rate)
        calls.clear()
        runner.analyze_unpacked_light([u], u.sample_rate, u.n_channels)
        whole, n = calls.pop()
        whole = whole[:, :n]
        runner.analyze_track_light(u)
        assert len(calls) == 3, path
        cat = torch.cat([f[:, :v] for f, v in calls], dim=1)
        assert cat.shape == whole.shape
        torch.testing.assert_close(cat, whole, rtol=0, atol=1e-4 * float(whole.abs().max()))
        start = 0
        for f, v in calls[:-1]:
            start += v
            assert v % win == 0  # a cut on a whole window
            after = slice(start, start + 4 * win)

            def bins(y):
                w = y.reshape(y.shape[0], 4, win).transpose(0, 1)  # (window, C, win)
                return real(w, torch.full((4,), win), win).argmax(dim=1)

            assert torch.equal(bins(cat[:, after]), bins(whole[:, after])), (path, start)


def test_segmented_scan_matches_one_batch(long_tracks, whole, segmented):
    res, _, batches = segmented
    for a, b in zip(res.tracks, whole.tracks):
        assert_close(a, b, a.path)
    assert int(res.album_histogram.sum()) == int(whole.album_histogram.sum())
    assert np.array_equal(res.album_histogram,
                          np.sum([t.histogram for t in res.tracks], axis=0))
    assert res.album_peak == max(t.result.peak for t in res.tracks)
    assert res.audio_seconds == whole.audio_seconds
    # Every batch, segments included, keeps to the cap; 3 + 3 segments.
    assert all(rows <= CAP for rows, _ in batches)
    segs = sorted((s for _, s in batches if s is not None), key=lambda s: s.index)
    assert len(segs) == 6 and len(batches) == 6  # prepared on a pool, in any order
    assert [s.index for s in segs if s.n_channels == 2] == [0, 1, 2]
    assert [s.halo for s in segs if s.n_channels == 1] == [0, 2, 2]
    assert [s.last for s in segs if s.n_channels == 1] == [False, False, True]


def test_segments_equal_the_unsegmented_gain_within_the_float64_reference(
        long_tracks, segmented):
    res, _, _ = segmented
    for path, t in zip(long_tracks, res.tracks):
        pcm, sr = decode_file(path, device="cpu")
        assert abs(t.result.gain_db - reference.reference_gain(pcm, sr)) <= 0.005, path
        np.testing.assert_allclose(t.result.peak, reference.reference_peak(pcm), rtol=2e-4)


def test_per_file_and_album_entry_points_run_segments(long_tracks, whole, monkeypatch):
    monkeypatch.setattr(pr, "ROWS_CAP", CAP)
    runner = pr.Runner("cpu")
    with tracing.recording():
        tracks = [analysis.analyze_track_internal(p, device="cpu", runner=runner)
                  for p in long_tracks]
        album = analysis.analyze_album(long_tracks, device="cpu", runner=runner)
        n_segments = tracing.counter("segments")
    assert n_segments == 2 * 6
    for got, want in zip(tracks, whole.tracks):
        assert_close(pr.TrackOutcome(want.path, True, result=got.result,
                                     histogram=got.histogram), want, want.path)
    for got, t in zip(album.tracks, tracks):
        assert got == t.result
    want_album = hi.loudness_from_histogram(whole.album_histogram)
    assert _idx(album.album_loudness_db) == _idx(want_album)
    assert album.album_peak == max(t.result.peak for t in tracks)


def test_a_track_under_the_cap_takes_the_one_batch_path_bit_for_bit(long_tracks, whole):
    runner = pr.Runner("cpu")
    for path, t in zip(long_tracks, whole.tracks):
        with open(path, "rb") as f:
            u = fe.unpack_data_light_packed(f.read())
        for hist, louds, peaks in (runner.analyze_unpacked_light([u], u.sample_rate,
                                                                 u.n_channels),
                                   runner.analyze_track_light(u)):
            assert np.array_equal(hist[0], t.histogram)
            assert float(louds[0]) == t.result.loudness_db
            assert float(peaks[0]) == t.result.peak


def _flaky_segments(runner, fails):
    """runner.launch raising an out-of-memory error for a stereo segment of
    index 1 (`fails` times, forever for None)."""
    real = runner.launch
    left = [fails]

    def flaky(prepared, **kw):
        seg = prepared.shapes.get("segment")
        if seg is not None and seg.n_channels == 2 and seg.index == 1 and left[0] != 0:
            if left[0] is not None:
                left[0] -= 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(prepared, **kw)

    runner.launch = flaky


def test_a_segment_out_of_memory_is_retried_with_its_state(long_tracks, segmented):
    want, _, _ = segmented
    runner = pr.Runner("cpu")
    _flaky_segments(runner, 1)
    with tracing.recording():
        res = pr.analyze_library(long_tracks, runner=runner, album=True, rows_cap=CAP,
                                 pressure_backoff_s=0)
        counts = (tracing.counter("oom.retries"), tracing.counter("tracks.isolated"))
    # Segment 1 is retried once; the segments after it, which found no
    # state, launch again after it.
    assert counts == (1, 0)
    for a, b in zip(res.tracks, want.tracks):
        assert a.ok and a.result == b.result and np.array_equal(a.histogram, b.histogram)
    assert np.array_equal(res.album_histogram, want.album_histogram)


def test_a_segment_that_always_runs_out_of_memory_isolates_its_track(long_tracks,
                                                                      segmented):
    want, _, _ = segmented
    runner = pr.Runner("cpu")
    _flaky_segments(runner, None)
    with tracing.recording():
        res = pr.analyze_library(long_tracks, runner=runner, album=True, rows_cap=CAP,
                                 pressure_backoff_s=0)
        counts = (tracing.counter("oom.retries"), tracing.counter("tracks.isolated"))
    assert counts == (2, 1)
    bad, good = res.tracks
    assert not bad.ok and "under pressure" in bad.error and "out of memory" in bad.error
    assert good.ok and good.result == want.tracks[1].result
    # The album holds the tracks that have an answer, whole.
    assert np.array_equal(res.album_histogram, good.histogram)


def test_a_segment_that_always_runs_out_of_memory_raises_per_file(long_tracks, monkeypatch):
    """The per-file path (Runner.analyze_track_light) has no isolation: a
    segment whose launch keeps failing raises, and the track gets no
    partial answer."""
    monkeypatch.setattr(pr, "ROWS_CAP", CAP)
    runner = pr.Runner("cpu")
    _flaky_segments(runner, None)
    with open(long_tracks[0], "rb") as f:  # the stereo track: segment 1 fails
        u = fe.unpack_data_light_packed(f.read())
    with pytest.raises(torch.cuda.OutOfMemoryError):
        runner.analyze_track_light(u)


def test_segment_spans_and_counters_in_a_traced_run(segmented):
    _, snap, _ = segmented
    c, totals = snap["counters"], snap["totals"]
    assert c["segments"] == 6 and c["tracks.segmented"] == 2
    assert totals["segment"]["count"] == 6
    # One carry stage per segment that hands its state on (all but the last).
    assert totals["carry"]["count"] == 4
    spans = [s for s in snap["spans"] if s["name"] == "carry"]
    uploads = {s["id"] for s in snap["spans"] if s["name"] == "upload"}
    assert all(s["device"] and s["parent"] in uploads for s in spans)
    assert c["rows.padded"] <= CAP * 6


def test_the_peak_gauge_names_the_batch_that_raised_it(long_tracks):
    with tracing.recording():
        for value, at in ((5, "a"), (7, "b"), (7, "c"), (3, "d")):
            tracing.gauge("device.peak_bytes", value, at=at)
        snap = tracing.snapshot()
    assert snap["gauges"]["device.peak_bytes"] == 7
    assert snap["gauge_at"]["device.peak_bytes"] == "b"  # the first report of the largest
    with open(long_tracks[1], "rb") as f:
        u = fe.unpack_data_light_packed(f.read())
    seg = pr.split_track(u, pr.segment_plan(u.n, u.sample_rate, 1, CAP))[1]
    prepared = pr.Runner("cpu").prepare_light([seg], u.sample_rate, 1)
    rows = len(prepared.arrays[pr.LIGHT_COUNTS]) * prepared.shapes["g_max"]
    assert pr._batch_name(prepared) == (f"light 22050 Hz 1 ch, batch of 1, {rows} padded "
                                        f"rows, segment 1 (553 granule-times)")
