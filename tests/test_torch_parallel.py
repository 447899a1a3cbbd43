"""Torch port: several Runners in one process (parallel.runner.RunnerGroup,
analyze_library(runners=...), aac.analyze_batch_q_sharded) against one
Runner and against the JAX package's MeshRunner.

All on the CPU, with two Runners on "cpu" (the kernels' plain versions):

- analyze_library and scan_files over two Runners give every track the
  result one Runner gives, exactly, MP3 and AAC (both AAC routes), with a
  failing file in the list, with a forced out-of-memory error on one of
  the Runners, and both Runners take batches; the album histogram is the
  sum of the tracks';
- RunnerGroup.dispatch_light_sharded and aac.analyze_batch_q_sharded equal
  the single dispatch exactly, and lie within 2 bins (0.02 dB) and peak
  rtol 2e-4 of the JAX MeshRunner's sharded results (a 2-device CPU mesh,
  Pallas in interpret mode) on the same streams: lame-encoded fixtures cut
  at seeded lengths, crafted AAC streams with seeded coefficients;
- album_reduce_device equals the host sum and the JAX album_reduce_device
  exactly;
- parallel.dryrun.dryrun_multichip(2) and (3);
- Runner.timings and Runner.busy_ms are bounded;
- runners_for: "cpu" is the shared Runner, a device named twice gets a
  second Runner, and asking for CUDA without a card raises.
"""

import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import Mesh  # noqa: E402

from mp3rgain_tpu import aac as jaac  # noqa: E402
from mp3rgain_tpu.decode import aac_frontend as jaf  # noqa: E402
from mp3rgain_tpu.decode import frontend as jfe  # noqa: E402
from mp3rgain_tpu.parallel import runner as jpr  # noqa: E402
from mp3rgain_tpu.testing import craft_aac  # noqa: E402
from mp3rgain_tpu_torch import aac, scan  # noqa: E402
from mp3rgain_tpu_torch.decode import aac_frontend as af  # noqa: E402
from mp3rgain_tpu_torch.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu_torch.ops import histogram as hi  # noqa: E402
from mp3rgain_tpu_torch.parallel import dryrun  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402
from mp3rgain_tpu_torch.replaygain import DeviceUnavailable  # noqa: E402

torch.set_num_threads(2)

SEED = 17
NAMES = ["test_vbr.mp3", "test_joint_stereo.mp3", "test_mono.mp3",
         "test_mpeg2_22050.mp3", "test_stereo.mp3", "test_vbr.mp3",
         "test_joint_stereo.mp3", "test_stereo.mp3"]


def _idx(loudness_db: float) -> int:
    return round(float(loudness_db) * 100) + hi.HISTOGRAM_OFFSET


@pytest.fixture(scope="module")
def library(fixtures_dir, tmp_path_factory):
    """Eight files in three buckets, one corrupt file among them."""
    out = tmp_path_factory.mktemp("torch_parallel")
    paths = []
    for i, name in enumerate(NAMES):
        dst = out / f"track{i:02d}_{name}"
        shutil.copy(fixtures_dir / name, dst)
        paths.append(str(dst))
    bad = out / "corrupt.mp3"
    bad.write_bytes(b"corrupt" * 64)
    paths.insert(3, str(bad))
    return paths


def _crafted_aac(rng, frames: int) -> bytes:
    quads = [tuple(int(v) for v in rng.integers(-1, 2, 4)) for _ in range(4)]
    return craft_aac.craft_sce_stream(frames, global_gain=int(rng.integers(130, 150)),
                                      band_quads=quads)


@pytest.fixture(scope="module")
def aac_streams():
    """Six crafted mono AAC streams of seeded lengths and coefficients."""
    rng = np.random.default_rng(SEED)
    return [_crafted_aac(rng, int(n)) for n in rng.integers(3, 12, 6)]


@pytest.fixture(scope="module")
def aac_library(aac_streams, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_parallel_aac")
    paths = []
    for i, data in enumerate(aac_streams):
        (out / f"s{i}.aac").write_bytes(data)
        paths.append(str(out / f"s{i}.aac"))
    (out / "broken.m4a").write_bytes(b"\x00\x00\x00\x18ftypM4A " + bytes(64))
    paths.insert(2, str(out / "broken.m4a"))
    return paths


def _two() -> list:
    return [pr.Runner("cpu"), pr.Runner("cpu")]


def assert_equal(a, b, what=""):
    """Two BatchResults, exactly."""
    assert len(a.tracks) == len(b.tracks)
    for x, y in zip(a.tracks, b.tracks):
        assert (x.path, x.ok, x.error) == (y.path, y.ok, y.error), what
        if x.ok:
            assert x.result == y.result, (what, x.path)
            assert np.array_equal(x.histogram, y.histogram), (what, x.path)
    assert a.audio_seconds == b.audio_seconds
    if a.album_histogram is not None or b.album_histogram is not None:
        assert np.array_equal(a.album_histogram, b.album_histogram), what
        assert a.album_peak == b.album_peak


@pytest.fixture(scope="module")
def one_runner(library):
    return pr.analyze_library(library, runner=pr.Runner("cpu"), album=True, max_batch=2)


def test_library_over_two_runners_equals_one(library, one_runner):
    runners = _two()
    seen = []
    res = pr.analyze_library(library, runners=runners, album=True, max_batch=2,
                             wave_size=3,
                             batch_cb=lambda done: seen.extend(t.path for t in done))
    assert_equal(res, one_runner, "two Runners")
    assert [t.ok for t in res.tracks].count(False) == 1 and not res.tracks[3].ok
    assert "No valid MP3 frames" in res.tracks[3].error
    ok = [t for t in res.tracks if t.ok]
    assert sorted(seen) == sorted(t.path for t in ok)
    assert res.album_histogram.dtype == np.int64
    assert np.array_equal(res.album_histogram, np.sum([t.histogram for t in ok], axis=0))
    # Both Runners took batches, and together all of them.
    taken = [len(r.timings) for r in runners]
    assert min(taken) >= 1 and sum(taken) >= 5, taken


def test_library_with_an_out_of_memory_runner_equals_one(library, one_runner):
    """The second Runner runs out of memory on every batch of two: each is
    retried on that Runner in halves, and no result changes."""
    runners = _two()
    real = runners[1].launch
    sizes = []

    def flaky(prepared, **kw):
        sizes.append(prepared.bsz)
        if prepared.bsz > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(prepared, **kw)

    runners[1].launch = flaky
    res = pr.analyze_library(library, runners=runners, album=True, max_batch=2,
                             pressure_backoff_s=0)
    assert_equal(res, one_runner, "out of memory on Runner 1")
    assert 2 in sizes and sizes.count(1) >= 2
    assert len(runners[0].timings) >= 1


def test_runner_and_runners_together_are_refused(library):
    with pytest.raises(ValueError, match="not both"):
        pr.analyze_library(library, runner=pr.Runner("cpu"), runners=_two())


@pytest.mark.parametrize("device_prep", [True, False])
def test_aac_library_over_two_runners_equals_one(aac_library, device_prep):
    kw = dict(file_type="aac", device_prep=device_prep, album=True, max_batch=2)
    one = pr.analyze_library(aac_library, runner=pr.Runner("cpu"), **kw)
    runners = _two()
    two = pr.analyze_library(aac_library, runners=runners, **kw)
    assert_equal(two, one, f"AAC, device_prep={device_prep}")
    assert [t.ok for t in two.tracks].count(False) == 1 and not two.tracks[2].ok
    assert all(t.result.file_type == "aac" for t in two.tracks if t.ok)
    assert min(len(r.timings) for r in runners) >= 1
    assert {t["route"] for r in runners for t in r.timings} == {
        "aac_q" if device_prep else "aac"}


def test_scan_files_over_two_runners_equals_one(library, aac_library, tmp_path):
    paths = library + aac_library
    one = scan.scan_files(paths, runner=pr.Runner("cpu"))
    runners = _two()
    manifest = tmp_path / "scan.json"
    two = scan.scan_files(paths, manifest_path=manifest, runners=runners)
    assert sorted(two.results) == sorted(one.results) == sorted(paths)
    for p in paths:
        a, b = two.results[p], one.results[p]
        if isinstance(b, Exception):
            assert type(a) is type(b) and str(a) == str(b), p
        else:
            assert a == b and np.array_equal(two.histograms[p], one.histograms[p]), p
    assert scan.album_union(two, paths) == scan.album_union(one, paths)
    assert min(len(r.timings) for r in runners) >= 1
    again = scan.scan_files(paths, manifest_path=manifest, runners=_two())
    assert again.resumed == len(one.histograms)


@pytest.fixture(scope="module")
def mp3_streams(fixtures_dir):
    """Four 44.1 kHz stereo streams: three fixtures, each cut at a seeded
    length, and one whole."""
    rng = np.random.default_rng(SEED)
    out = []
    for name in ("test_stereo.mp3", "test_joint_stereo.mp3", "test_vbr.mp3"):
        data = (fixtures_dir / name).read_bytes()
        out.append(data[: int(rng.integers(len(data) // 2, len(data)))])
    out.append((fixtures_dir / "test_stereo.mp3").read_bytes())
    return out


def _jax_mesh(n: int = 2) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), axis_names=("dp",))


def test_sharded_light_dispatch_equals_single_and_matches_jax(mp3_streams):
    ups = [fe.unpack_data_light_packed(d) for d in mp3_streams]
    assert {(u.sample_rate, u.n_channels) for u in ups} == {(44100, 2)}
    assert len({u.n for u in ups}) == len(ups)  # four lengths
    group = pr.RunnerGroup(runners=_two())
    single = group.runners[0].analyze_unpacked_light(ups, 44100, 2)
    handle = group.dispatch_light_sharded(ups, 44100, 2)
    order = sorted(range(4), key=lambda i: ups[i].n, reverse=True)
    assert handle.shard_index == [order[0::2], order[1::2]]
    sharded = group.collect(handle)
    for a, b in zip(single, sharded):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [len(r.timings) for r in group.runners] == [2, 1]
    # Fewer tracks than Runners: the single dispatch on the first Runner.
    three = pr.RunnerGroup(runners=[*group.runners, pr.Runner("cpu")])
    h2, l2, p2 = three.collect(three.dispatch_light_sharded(ups[:2], 44100, 2))
    assert np.array_equal(h2, single[0][:2]) and np.array_equal(l2, single[1][:2])
    assert [len(r.timings) for r in three.runners] == [3, 1, 0]

    jrunner = jpr.MeshRunner(mesh=_jax_mesh())
    jups = [jfe.unpack_data_light(d) for d in mp3_streams]
    jh, jl, jp = jrunner.collect(jrunner.dispatch_light_sharded(jups, 44100, 2))
    hist, louds, peaks = sharded
    assert np.array_equal(hist.sum(axis=1), np.asarray(jh).sum(axis=1))
    assert max(abs(_idx(a) - _idx(b)) for a, b in zip(louds, jl)) <= 2
    np.testing.assert_allclose(peaks, np.asarray(jp), rtol=2e-4)


def test_sharded_aac_dispatch_equals_single_and_matches_jax(aac_streams):
    ups = [af.unpack_adts_q(d) for d in aac_streams]
    sr, nch = ups[0].sample_rate, ups[0].n_channels or 1
    group = pr.RunnerGroup(runners=_two())
    single = aac.analyze_batch_q(ups, sr, nch, runner=group.runners[0])
    sharded = aac.analyze_batch_q_sharded(ups, sr, nch, group=group)
    for a, b in zip(single, sharded):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [len(r.timings) for r in group.runners] == [2, 1]
    assert group.runners[1].last_timings["route"] == "aac_q"
    by_devices = aac.analyze_batch_q_sharded(ups, sr, nch, devices=["cpu", "cpu"])
    for a, b in zip(single, by_devices):
        assert np.array_equal(a, b)

    jups = [jaf.unpack_adts_q(d) for d in aac_streams]
    jh, jl, jp = jaac.analyze_batch_q_sharded(jups, sr, nch, mesh=_jax_mesh())
    hist, louds, peaks = sharded
    assert np.array_equal(hist.sum(axis=1), np.asarray(jh).sum(axis=1))
    assert max(abs(_idx(a) - _idx(b)) for a, b in zip(louds, jl)) <= 2
    np.testing.assert_allclose(peaks, np.asarray(jp), rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("n_runners,rows", [(2, 5), (3, 2), (2, 8)])
def test_album_reduce_device_equals_host_sum_and_jax(n_runners, rows):
    rng = np.random.default_rng(SEED + rows)
    hists = np.zeros((rows, hi.HISTOGRAM_SIZE), np.int32)
    for r in range(rows):
        np.add.at(hists[r], rng.integers(1000, 9000, 400), 1)
    peaks = rng.random(rows).astype(np.float32)
    group = pr.RunnerGroup(runners=[pr.Runner("cpu") for _ in range(n_runners)])
    total_h, total_p = group.album_reduce_device(hists, peaks)
    assert total_h.dtype == np.int64 and total_h.shape == (hi.HISTOGRAM_SIZE,)
    assert np.array_equal(total_h, hists.sum(axis=0, dtype=np.int64))
    assert total_p == float(peaks.max())
    jh, jp = jpr.MeshRunner(mesh=_jax_mesh(2)).album_reduce_device(hists, peaks)
    assert np.array_equal(total_h, np.asarray(jh).astype(np.int64))
    assert total_p == jp


@pytest.mark.parametrize("nan_row", [0, 3, 4])
def test_album_reduce_device_treats_a_nan_peak_like_jax(nan_row):
    """A track whose peak is NaN (non-finite decoded samples), in the
    first share or a later one: the album peak equals the JAX package's,
    whose pmax over the CPU mesh drops a share's NaN (Python's max over
    the shares kept it when it came first)."""
    rng = np.random.default_rng(SEED)
    hists = np.zeros((5, hi.HISTOGRAM_SIZE), np.int32)
    peaks = rng.random(5).astype(np.float32)
    peaks[nan_row] = np.nan
    group = pr.RunnerGroup(runners=[pr.Runner("cpu") for _ in range(2)])
    _, total_p = group.album_reduce_device(hists, peaks)
    _, jp = jpr.MeshRunner(mesh=_jax_mesh(2)).album_reduce_device(hists, peaks)
    assert not np.isnan(jp) and total_p == jp


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip(n, capsys):
    dryrun.dryrun_multichip(n, device="cpu")
    assert f"dryrun_multichip ok: {n} Runners" in capsys.readouterr().out


def test_runner_records_are_bounded(mp3_streams, monkeypatch):
    """A Runner that lives as long as the process keeps the newest
    TIMINGS_KEPT batches' records, no more."""
    monkeypatch.setattr(pr, "TIMINGS_KEPT", 3)
    runner = pr.Runner("cpu")
    assert runner.timings.maxlen == 3 and runner.busy_ms.maxlen == 6
    u = fe.unpack_data_light_packed(mp3_streams[0])
    for _ in range(5):
        runner.analyze_unpacked_light([u], 44100, 2)
    assert len(runner.timings) == 3 and runner.timings[-1] is runner.last_timings
    runner.busy_ms.extend((float(i), float(i + 1)) for i in range(20))
    assert len(runner.busy_ms) == 6
    assert pr.Runner("cpu").timings.maxlen == 3
    monkeypatch.undo()
    assert pr.Runner("cpu").timings.maxlen == pr.TIMINGS_KEPT >= 1024


def test_runners_for(monkeypatch):
    monkeypatch.setattr(pr, "_shared", {})
    shared = pr.shared_runner("cpu")
    assert pr.runners_for("cpu") == [shared]
    assert pr.runners_for(torch.device("cpu")) == [shared]
    two = pr.runners_for(["cpu", "cpu"])
    assert two[0] is shared and two[1] is not shared and two[1].device == shared.device
    group = pr.RunnerGroup(["cpu", "cpu", "cpu"])
    assert group.n_devices == 3 and len({id(r) for r in group.runners}) == 3
    assert group.devices == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        pr.runners_for([])
    with pytest.raises(ValueError):
        pr.RunnerGroup(runners=[])


def test_a_group_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pr, "_shared", {})
    for make in (lambda: pr.RunnerGroup("cuda"), lambda: pr.RunnerGroup(["cuda:0", "cuda:0"]),
                 lambda: pr.runners_for("cuda"),
                 lambda: dryrun.dryrun_multichip(2),
                 lambda: dryrun.dryrun_multihost(2),
                 lambda: pr.analyze_library(["a.mp3"])):
        with pytest.raises(DeviceUnavailable, match="CUDA device is required"):
            make()
