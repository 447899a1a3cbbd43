"""Torch port: scan.scan_files, its resumable manifest and album_union.

The port's scan_files on the CPU against the JAX package's scan_files on
the same lame-encoded fixtures (per track: window counts equal, loudness
index within 2 bins, peak within rtol 2e-4); a second run resuming every
track from the manifest with identical results; a scan killed after its
first collected batch resuming that batch; manifests written by either
package resumed in full by the other; album_union against the JAX
package's; a degenerate AAC file and a corrupt MP3 in the list each
treated as the JAX package treats them while the MP3s are analysed; and a
mixed MP3 + AAC library (an M4A, a raw ADTS stream, a crafted stream)
against the JAX package's scan, resumed from a manifest written by
either package, AAC records included.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mp3rgain_tpu import scan as jscan  # noqa: E402
from mp3rgain_tpu.testing import avcodec, craft_aac, fixtures  # noqa: E402
from mp3rgain_tpu_torch import scan  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402

torch.set_num_threads(2)

NAMES = ["test_vbr.mp3", "test_joint_stereo.mp3", "test_mono.mp3",
         "test_mpeg2_22050.mp3", "test_stereo.mp3"]


def _adts_stream(frames: int = 3, payload: int = 200) -> bytes:
    """ADTS frames (AAC-LC, 44.1 kHz, stereo headers, zero payloads)."""
    n = 7 + payload
    head = bytes([0xFF, 0xF1, 0x50, 0x80 | ((n >> 11) & 3), (n >> 3) & 0xFF,
                  ((n & 7) << 5) | 0x1F, 0xFC])
    return (head + bytes(payload)) * frames


@pytest.fixture(scope="module")
def library(fixtures_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_scan")
    paths = []
    for i, name in enumerate(NAMES):
        dst = out / f"track{i:02d}_{name}"
        shutil.copy(fixtures_dir / name, dst)
        paths.append(str(dst))
    return paths


@pytest.fixture(scope="module")
def jax_scan(library):
    return jscan.scan_files(library)


@pytest.fixture(scope="module")
def port_scan(library):
    return scan.scan_files(library, device="cpu")


def _idx(loudness_db: float) -> int:
    return round(loudness_db * 100) + 2000


def _assert_close(mine, theirs, paths):
    for p in paths:
        a, b = mine.results[p], theirs.results[p]
        assert not isinstance(a, Exception) and not isinstance(b, Exception), p
        assert int(mine.histograms[p].sum()) == int(np.asarray(theirs.histograms[p]).sum())
        assert abs(_idx(a.loudness_db) - _idx(b.loudness_db)) <= 2, p
        np.testing.assert_allclose(a.peak, b.peak, rtol=2e-4)
        assert (a.sample_rate, a.file_type) == (b.sample_rate, b.file_type)


def _assert_identical(a, b, paths):
    for p in paths:
        assert a.results[p] == b.results[p], p
        assert np.array_equal(a.histograms[p], b.histograms[p]), p


def test_scan_files_matches_jax(library, port_scan, jax_scan):
    _assert_close(port_scan, jax_scan, library)
    assert port_scan.audio_seconds == pytest.approx(jax_scan.audio_seconds, rel=1e-9)
    assert port_scan.resumed == 0 and port_scan.realtime_factor > 0
    assert port_scan.audio_hours_per_sec == pytest.approx(
        port_scan.realtime_factor / 3600.0)


def test_second_run_resumes_every_track(library, tmp_path):
    manifest = tmp_path / "scan.json"
    first = scan.scan_files(library, manifest_path=manifest, device="cpu")
    assert first.resumed == 0 and manifest.exists()
    assert not os.path.exists(str(manifest) + ".journal")  # compacted
    runner = pr.Runner("cpu")
    again = scan.scan_files(library, manifest_path=manifest, runner=runner)
    assert again.resumed == len(library)
    assert len(runner.timings) == 0  # no batch ran
    _assert_identical(again, first, library)


def test_killed_scan_resumes_every_collected_batch(library, tmp_path, monkeypatch):
    manifest = tmp_path / "scan.json"
    real = pr.analyze_library

    def killed_after_first_batch(paths, runner=None, batch_cb=None, **kw):
        def cb(done):
            batch_cb(done)
            raise KeyboardInterrupt

        return real(paths, runner=runner, batch_cb=cb, max_batch=2, **kw)

    monkeypatch.setattr(pr, "analyze_library", killed_after_first_batch)
    with pytest.raises(KeyboardInterrupt):
        scan.scan_files(library, manifest_path=manifest, device="cpu")
    # Only the journal holds the first batch: the snapshot is written at
    # the scan's end.
    assert not manifest.exists() and os.path.exists(str(manifest) + ".journal")
    saved = scan.Manifest(manifest).data
    assert len(saved) == 2
    monkeypatch.setattr(pr, "analyze_library", real)
    resumed = scan.scan_files(library, manifest_path=manifest, device="cpu")
    assert resumed.resumed == 2
    assert all(not isinstance(r, Exception) for r in resumed.results.values())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_resumes_across_the_packages(library, tmp_path, writer):
    """A manifest written by either package's scan_files is resumed in
    full by the other's, with the writer's results."""
    manifest = tmp_path / "scan.json"
    if writer == "jax":
        first = jscan.scan_files(library, manifest_path=manifest)
        second = scan.scan_files(library, manifest_path=manifest, device="cpu")
    else:
        first = scan.scan_files(library, manifest_path=manifest, device="cpu")
        second = jscan.scan_files(library, manifest_path=manifest)
    assert second.resumed == len(library)
    for p in library:
        assert (dataclasses.astuple(second.results[p])
                == dataclasses.astuple(first.results[p])), p
        assert np.array_equal(second.histograms[p], np.asarray(first.histograms[p]))
    # The journal form too: the reader folds a journal into the snapshot.
    m = scan.Manifest(manifest)
    jm = jscan.Manifest(manifest)
    assert m.data == jm.data


def test_journal_records_read_by_both_packages(library, port_scan, tmp_path):
    manifest = tmp_path / "scan.json"
    m = scan.Manifest(manifest)
    for p in library[:3]:
        m.store(p, port_scan.results[p], port_scan.histograms[p])
    m.save(force=False)
    assert not manifest.exists()
    for reader in (scan.Manifest, jscan.Manifest):
        got = reader(manifest)
        for p in library[:3]:
            res, hist = got.lookup(p)
            assert dataclasses.astuple(res) == dataclasses.astuple(port_scan.results[p])
            assert np.array_equal(hist, port_scan.histograms[p])
        assert got.lookup(library[3]) is None


def test_album_union_matches_jax(library, port_scan, jax_scan):
    loud, gain, peak = scan.album_union(port_scan, library)
    j_loud, j_gain, j_peak = jscan.album_union(jax_scan, library)
    assert abs(_idx(loud) - _idx(j_loud)) <= 2
    assert gain == pytest.approx(64.82 - loud)
    np.testing.assert_allclose(peak, j_peak, rtol=2e-4)
    # On the same histograms the two unions agree exactly.
    assert scan.album_union(port_scan, library) == jscan.album_union(port_scan, library)
    sub = library[:2]
    assert scan.album_union(port_scan, sub) == jscan.album_union(port_scan, sub)


def test_album_union_refuses_a_multi_host_group(port_scan, library, monkeypatch):
    """In a group whose coordinator cannot be reached album_union raises
    with the coordinator's address inside the time limit: it never
    answers with the process-local album. A coordinator alone names no
    group, and the union is the local one."""
    from mp3rgain_tpu_torch.parallel import multihost

    local = scan.album_union(port_scan, library)
    monkeypatch.setattr(multihost, "_config", None)
    monkeypatch.setenv("MP3RGAIN_COORDINATOR", "localhost:1")
    assert not multihost.is_multihost()
    assert scan.album_union(port_scan, library) == local
    monkeypatch.setenv("MP3RGAIN_NUM_PROCESSES", "2")
    monkeypatch.setenv("MP3RGAIN_PROCESS_ID", "1")
    monkeypatch.setenv("MP3RGAIN_GROUP_TIMEOUT_S", "2")
    assert multihost.is_multihost()
    with pytest.raises(RuntimeError, match="could not join its group at localhost:1"):
        scan.album_union(port_scan, library)


def test_an_aac_file_fails_alone(library, port_scan, tmp_path):
    """Zero-payload ADTS frames go down the AAC path and come back as the
    JAX package returns them (three silent frames: an empty histogram,
    peak 0); an M4A without a moov box and a corrupt MP3 each fail alone
    with the JAX package's error; the MP3s are analysed as without
    them."""
    adts = tmp_path / "stream.aac"
    adts.write_bytes(_adts_stream())
    broken = tmp_path / "broken.m4a"
    broken.write_bytes(b"\x00\x00\x00\x18ftypM4A " + bytes(64))
    corrupt = tmp_path / "corrupt.mp3"
    corrupt.write_bytes(b"corrupt" * 64)
    paths = [library[0], str(adts), *library[1:], str(broken), str(corrupt)]
    seen = []
    res = scan.scan_files(paths, progress_cb=seen.append, device="cpu")
    ref = jscan.scan_files([str(adts), str(broken), str(corrupt)])
    assert (dataclasses.astuple(res.results[str(adts)])
            == dataclasses.astuple(ref.results[str(adts)]))
    assert res.results[str(adts)].file_type == "aac"
    assert not res.histograms[str(adts)].any()
    for bad in (str(broken), str(corrupt)):
        mine, theirs = res.results[bad], ref.results[bad]
        assert isinstance(mine, RuntimeError) and isinstance(theirs, RuntimeError)
        assert type(mine).__name__ == type(theirs).__name__ and str(mine) == str(theirs)
        assert bad not in res.histograms
    assert sorted(seen) == sorted(paths)
    _assert_identical(res, port_scan, library)


@pytest.fixture(scope="module")
def mixed_library(library, tmp_path_factory):
    """The MP3s plus four AAC files in three (rate, channels) buckets."""
    out = tmp_path_factory.mktemp("torch_scan_aac")
    rng = np.random.default_rng(31)

    def pcm(seconds, sr, channels, freq):
        t = np.arange(int(sr * seconds)) / sr
        wave = (0.3 * np.sin(2 * np.pi * freq * t)
                + 0.04 * rng.standard_normal(len(t))).astype(np.float32)
        return wave if channels == 1 else np.stack([wave, np.roll(wave, 11)], axis=1)

    files = {
        "a.m4a": fixtures.encode_m4a(pcm(1.5, 44100, 2, 523.0), 44100, bitrate=96000),
        "b.m4a": fixtures.encode_m4a(pcm(0.8, 44100, 2, 330.0), 44100, bitrate=128000),
        "c.aac": avcodec.encode_adts(pcm(1.0, 22050, 1, 700.0), 22050, bitrate=48000),
        "d.aac": craft_aac.craft_sce_stream(
            30, global_gain=140,
            band_quads=[(1, 0, -1, 0), (0, 1, 0, 0), (-1, -1, 1, 0), (1, 1, 1, 1)]),
    }
    paths = []
    for name, data in files.items():
        (out / name).write_bytes(data)
        paths.append(str(out / name))
    return [library[0], paths[0], *library[1:3], *paths[1:], *library[3:]]


@pytest.mark.parametrize("device_prep", [None, True])
def test_mixed_mp3_and_aac_scan_matches_jax(mixed_library, device_prep):
    seen = []
    mine = scan.scan_files(mixed_library, progress_cb=seen.append, device="cpu",
                           device_prep=device_prep)
    ref = jscan.scan_files(mixed_library)
    assert sorted(seen) == sorted(mixed_library)
    assert [mine.results[p].file_type for p in mixed_library] == \
        [ref.results[p].file_type for p in mixed_library]
    assert sum(r.file_type == "aac" for r in mine.results.values()) == 4
    for p in mixed_library:
        a, b = mine.results[p], ref.results[p]
        assert int(mine.histograms[p].sum()) == int(np.asarray(ref.histograms[p]).sum())
        assert abs(_idx(a.loudness_db) - _idx(b.loudness_db)) <= 2, p
        # Across the AAC routes the JAX package's own tolerance is rel 1e-3.
        rtol = 1e-3 if device_prep and a.file_type == "aac" else 2e-4
        np.testing.assert_allclose(a.peak, b.peak, rtol=rtol)
        assert a.sample_rate == b.sample_rate
    assert mine.audio_seconds == pytest.approx(ref.audio_seconds, rel=1e-9)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mixed_manifest_resumes_across_the_packages(mixed_library, tmp_path, writer):
    """AAC records included: a manifest written by either package is
    resumed in full by the other, and a scan killed after its first AAC
    batch resumes the MP3s and that batch."""
    manifest = tmp_path / "scan.json"
    if writer == "jax":
        first = jscan.scan_files(mixed_library, manifest_path=manifest)
        runner = pr.Runner("cpu")
        second = scan.scan_files(mixed_library, manifest_path=manifest, runner=runner)
        assert len(runner.timings) == 0  # no batch ran
    else:
        first = scan.scan_files(mixed_library, manifest_path=manifest, device="cpu")
        second = jscan.scan_files(mixed_library, manifest_path=manifest)
    assert second.resumed == len(mixed_library)
    for p in mixed_library:
        assert (dataclasses.astuple(second.results[p])
                == dataclasses.astuple(first.results[p])), p
        assert np.array_equal(second.histograms[p], np.asarray(first.histograms[p]))
    assert scan.Manifest(manifest).data == jscan.Manifest(manifest).data


def test_killed_aac_scan_resumes_every_collected_batch(mixed_library, tmp_path,
                                                       monkeypatch):
    manifest = tmp_path / "scan.json"
    real = pr.analyze_library

    def killed_after_first_aac_batch(paths, runner=None, batch_cb=None, **kw):
        if kw.get("file_type") != "aac":
            return real(paths, runner=runner, batch_cb=batch_cb, **kw)

        def cb(done):
            batch_cb(done)
            raise KeyboardInterrupt

        return real(paths, runner=runner, batch_cb=cb, **kw)

    monkeypatch.setattr(pr, "analyze_library", killed_after_first_aac_batch)
    with pytest.raises(KeyboardInterrupt):
        scan.scan_files(mixed_library, manifest_path=manifest, device="cpu")
    saved = scan.Manifest(manifest).data
    n_mp3 = len(mixed_library) - 4
    aac_saved = [p for p, r in saved.items() if r["file_type"] == "aac"]
    assert len(saved) - len(aac_saved) == n_mp3 and 1 <= len(aac_saved) < 4
    monkeypatch.setattr(pr, "analyze_library", real)
    resumed = scan.scan_files(mixed_library, manifest_path=manifest, device="cpu")
    assert resumed.resumed == len(saved)
    assert all(not isinstance(r, Exception) for r in resumed.results.values())


def test_scan_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        scan.scan_files([__file__])
