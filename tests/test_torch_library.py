"""Torch port: the streamed library runner, parallel.runner.analyze_library.

The port's analyze_library on the CPU (Runner("cpu"), the kernels' plain
versions) against the JAX package's analyze_library on the same
lame-encoded fixtures, in three (sample rate, channels) buckets: per track
the window counts are equal, the loudness index is within 2 bins (0.02 dB)
and the peak within rtol 2e-4; the album index within 2 bins and the album
peak within rtol 2e-4. Then the port against itself: the light route
against the host-decoded one (the same tolerances), small waves and
batches against one pass (exactly equal on the CPU), per-file fault
isolation, and the out-of-memory halving and retry.
"""

import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mp3rgain_tpu.parallel import runner as jpr  # noqa: E402
from mp3rgain_tpu_torch import tracing  # noqa: E402
from mp3rgain_tpu_torch.ops import histogram as hi  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402

torch.set_num_threads(2)

NAMES = ["test_vbr.mp3", "test_joint_stereo.mp3", "test_mono.mp3",
         "test_mpeg2_22050.mp3", "test_stereo.mp3", "test_vbr.mp3"]


@pytest.fixture(scope="module")
def library(fixtures_dir, tmp_path_factory):
    """Six files in three buckets: 44.1 kHz stereo (4), 44.1 kHz mono and
    22.05 kHz stereo."""
    out = tmp_path_factory.mktemp("torch_library")
    paths = []
    for i, name in enumerate(NAMES):
        dst = out / f"track{i:02d}_{name}"
        shutil.copy(fixtures_dir / name, dst)
        paths.append(str(dst))
    return paths


@pytest.fixture(scope="module")
def port_album(library):
    return pr.analyze_library(library, runner=pr.Runner("cpu"), album=True)


def _idx(loudness_db: float) -> int:
    return round(loudness_db * 100) + hi.HISTOGRAM_OFFSET


def assert_close(a, b, what=""):
    """Two TrackOutcomes: window counts equal, index within 2 bins, peak
    within rtol 2e-4."""
    assert a.ok and b.ok, what
    assert int(np.sum(a.histogram)) == int(np.sum(b.histogram)), what
    assert abs(_idx(a.result.loudness_db) - _idx(b.result.loudness_db)) <= 2, what
    np.testing.assert_allclose(a.result.peak, b.result.peak, rtol=2e-4, err_msg=what)
    assert a.result.sample_rate == b.result.sample_rate, what


def assert_equal(a, b, what=""):
    """Two results, exactly."""
    assert len(a.tracks) == len(b.tracks)
    for x, y in zip(a.tracks, b.tracks):
        assert (x.path, x.ok, x.error) == (y.path, y.ok, y.error), what
        if x.ok:
            assert x.result == y.result, (what, x.path)
            assert np.array_equal(x.histogram, y.histogram), (what, x.path)
    assert a.audio_seconds == b.audio_seconds


def test_library_matches_jax(library, port_album):
    ref = jpr.analyze_library(library, album=True)
    assert len(port_album.tracks) == len(ref.tracks) == len(library)
    for mine, theirs in zip(port_album.tracks, ref.tracks):
        assert mine.path == theirs.path
        assert isinstance(mine.histogram, np.ndarray)
        assert mine.histogram.shape == (hi.HISTOGRAM_SIZE,)
        assert mine.result.file_type == "mp3"
        assert_close(mine, theirs, mine.path)
    assert port_album.audio_seconds == pytest.approx(ref.audio_seconds, rel=1e-9)
    ref_hist = np.asarray(ref.album_histogram)
    assert int(port_album.album_histogram.sum()) == int(ref_hist.sum())
    got = hi.loudness_index(torch.from_numpy(port_album.album_histogram)[None])
    want = hi.loudness_index(torch.from_numpy(ref_hist.astype(np.int64))[None])
    assert abs(int(got[0]) - int(want[0])) <= 2
    np.testing.assert_allclose(port_album.album_peak, ref.album_peak, rtol=2e-4)


def test_album_is_the_sum_of_the_tracks(port_album):
    tracks = port_album.tracks
    assert port_album.album_histogram.dtype == np.int64
    assert np.array_equal(port_album.album_histogram,
                          np.sum([t.histogram for t in tracks], axis=0))
    assert port_album.album_peak == max(t.result.peak for t in tracks)
    assert port_album.realtime_factor > 0


def test_light_and_heavy_routes_agree(library, port_album):
    heavy = pr.analyze_library(library, runner=pr.Runner("cpu"),
                               device_entropy=False)
    for a, b in zip(port_album.tracks, heavy.tracks):
        assert_close(a, b, a.path)
    assert heavy.album_histogram is None


def test_waves_and_small_batches_equal_one_pass(library, port_album):
    runner = pr.Runner("cpu")
    waved = pr.analyze_library(library, runner=runner, album=True, max_batch=2,
                               wave_size=3)
    assert_equal(waved, port_album, "max_batch=2, wave_size=3")
    assert np.array_equal(waved.album_histogram, port_album.album_histogram)
    assert waved.album_peak == port_album.album_peak
    # Six tracks in three buckets, at most two to a batch.
    assert len(runner.timings) >= 4
    assert all(set(t) == {"route", "prep_s", "h2d_s", "device_ms"} for t in runner.timings)


def test_rows_cap_cuts_batches_and_changes_no_result(library, port_album):
    runner = pr.Runner("cpu")
    capped = pr.analyze_library(library, runner=runner, rows_cap=1)
    assert_equal(capped, port_album, "rows_cap=1")
    assert len(runner.timings) == len(library)  # every batch one track


def test_fault_isolation(library, port_album, tmp_path):
    corrupt = tmp_path / "corrupt.mp3"
    corrupt.write_bytes(b"corrupt" * 64)
    empty = tmp_path / "empty.mp3"
    empty.write_bytes(b"")
    missing = tmp_path / "missing.mp3"
    paths = [str(corrupt), *library[:3], str(empty), *library[3:], str(missing)]
    res = pr.analyze_library(paths, runner=pr.Runner("cpu"), album=True)
    by_path = {t.path: t for t in res.tracks}
    for bad in (corrupt, empty, missing):
        t = by_path[str(bad)]
        assert not t.ok and t.result is None and t.histogram is None and t.error
    assert "No valid MP3 frames" in by_path[str(corrupt)].error
    good = pr.BatchResult([by_path[p] for p in library], res.audio_seconds, 0.0)
    assert_equal(good, port_album, "with bad files beside them")
    assert np.array_equal(res.album_histogram, port_album.album_histogram)


def _flaky(runner, fails_above: int, error=None):
    """Replace runner.launch by one that raises an out-of-memory error (or
    `error`) for batches larger than fails_above; returns the list of
    launched batch sizes."""
    real = runner.launch
    sizes = []

    def flaky(prepared, **kw):
        sizes.append(prepared.bsz)
        if prepared.bsz > fails_above:
            raise error or torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(prepared, **kw)

    runner.launch = flaky
    return sizes


def test_oom_halves_and_retries_with_identical_results(library, port_album):
    runner = pr.Runner("cpu")
    sizes = _flaky(runner, fails_above=2)
    with tracing.recording():
        res = pr.analyze_library(library, runner=runner, album=True,
                                 pressure_backoff_s=0)
    # The batch of 4 fails, is tried once more whole, then runs as 2 + 2.
    assert sorted(sizes) == [1, 1, 2, 2, 4, 4]
    assert (tracing.counter("oom.retries"), tracing.counter("tracks.isolated")) == (2, 0)
    assert_equal(res, port_album, "halved after out-of-memory")
    assert np.array_equal(res.album_histogram, port_album.album_histogram)


def test_a_generic_error_is_not_retried(library):
    runner = pr.Runner("cpu")
    sizes = _flaky(runner, fails_above=0, error=RuntimeError("CUDA error: an illegal "
                                                              "memory access"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pr.analyze_library(library, runner=runner, pressure_backoff_s=0)
    assert 2 not in sizes  # the batch of 4 was not halved
    assert not pr._retryable(RuntimeError("CUDA error: an illegal memory access"))
    assert pr._retryable(torch.cuda.OutOfMemoryError("out of memory"))


def test_a_track_that_always_runs_out_of_memory_is_isolated(library, port_album):
    runner = pr.Runner("cpu")
    real = runner.launch

    def flaky(prepared, **kw):
        if prepared.n_channels == 1:  # the mono track, alone in its bucket
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(prepared, **kw)

    runner.launch = flaky
    with tracing.recording():
        res = pr.analyze_library(library, runner=runner, album=True,
                                 pressure_backoff_s=0)
    # Out of memory as dealt and once more alone: two retries, then isolated.
    assert (tracing.counter("oom.retries"), tracing.counter("tracks.isolated")) == (2, 1)
    bad = res.tracks[2]
    assert not bad.ok and "under pressure" in bad.error and "out of memory" in bad.error
    rest = [i for i in range(len(library)) if i != 2]
    for i in rest:
        a, b = res.tracks[i], port_album.tracks[i]
        assert a.ok and a.result == b.result and np.array_equal(a.histogram, b.histogram)
    want = np.sum([port_album.tracks[i].histogram for i in rest], axis=0)
    assert np.array_equal(res.album_histogram, want)


def test_prepare_on_many_threads_then_launch_in_order(library):
    """Many threads preparing at once (more than the cores, with a short
    switch interval), then launches from two threads, equal the serial
    dispatches; the runner builds one LightTail per format."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from mp3rgain_tpu_torch.decode import frontend as fe

    ups = [fe.unpack_data_light_packed(open(p, "rb").read()) for p in library]
    batches = [[ups[i], ups[j]] for i, j in ((0, 1), (1, 4), (4, 5), (5, 0), (0, 4), (1, 5))]
    runner = pr.Runner("cpu")
    want = [runner.analyze_unpacked_light(b, 44100, 2) for b in batches]
    fresh = pr.Runner("cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(12) as ex:
            futs = [ex.submit(fresh.prepare_light, b, 44100, 2) for b in batches]
            prepared = [f.result(timeout=300) for f in futs]
            tails = list(ex.map(lambda _: fresh.tail(44100, 2), range(12)))
        with ThreadPoolExecutor(2) as ex:
            handles = [f.result(timeout=300) for f in
                       [ex.submit(fresh.launch, p) for p in prepared]]
    finally:
        sys.setswitchinterval(old)
    assert all(t is tails[0] for t in tails) and len(fresh._tails) == 1
    for h, (w_hist, w_louds, w_peaks) in zip(handles, want):
        hist, louds, peaks = fresh.collect(h)
        assert np.array_equal(hist, w_hist)
        assert np.array_equal(louds, w_louds) and np.array_equal(peaks, w_peaks)
