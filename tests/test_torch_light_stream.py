"""Torch port: the light walk into a main-data stream
(frontend.unpack_data_light_stream, _host/light_walk.cpp) against the
copied packed walk (frontend.unpack_data_light_packed).

The stream walk must give every row the copied walk gives (ip, scf_main,
the sidebands, meta, sample rate and channels, byte for byte) and, for
every row, the md row's bytes as a byte range of the stream followed by
zeros. Prep (prepare_batch_compact) must make the same arrays from either
form, alone or mixed in one batch, for segments and at the rows cap; a
scan must give the same answers, and admission the same estimate. Inputs:
every committed MP3 clip, the 60 s clip tiled to 30 min, hostile
mutations, an ID3v2-prefixed file, a file cut mid-frame, a file with no
frames, and a crafted stream whose windows run past their frame's end.
"""

import os

import numpy as np
import pytest
import torch

from mp3rgain_tpu_torch import tracing
from mp3rgain_tpu_torch.decode import entropy_kernel as ek
from mp3rgain_tpu_torch.decode import frontend as fe
from mp3rgain_tpu_torch.parallel import runner as pr
from mp3rgain_tpu_torch.testing import craft, hostile, tile
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke

torch.set_num_threads(2)

STANDARD = os.path.join(smoke.DATA_DIR, "standard")
CLIPS = sorted(
    [os.path.join(smoke.DATA_DIR, n) for n in os.listdir(smoke.DATA_DIR) if n.endswith(".mp3")]
    + [os.path.join(STANDARD, n) for n in os.listdir(STANDARD) if n.endswith(".mp3")])
ROW_FIELDS = ("ip", "scf_main", "srows", "sdata", "hrows", "hmask", "meta")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _clip(name: str) -> bytes:
    return _read(os.path.join(smoke.DATA_DIR, name))


def _id3v2(payload: bytes) -> bytes:
    """An ID3v2.3 tag of `payload` (its size in syncsafe bytes)."""
    n = len(payload)
    return b"ID3\x03\x00\x00" + bytes((n >> s) & 0x7F for s in (21, 14, 7, 0)) + payload


def _get_bits(frame: bytes, bit: int, n: int) -> int:
    return sum(((frame[(bit + i) >> 3] >> (7 - ((bit + i) & 7))) & 1) << (n - 1 - i)
               for i in range(n))


def _set_bits(frame: bytearray, bit: int, n: int, value: int) -> None:
    for i in range(n):
        b = bit + i
        mask = 0x80 >> (b & 7)
        v = (value >> (n - 1 - i)) & 1
        frame[b >> 3] = (frame[b >> 3] | mask) if v else (frame[b >> 3] & ~mask)


def _windows_past_the_frame() -> bytes:
    """Mono 128 kbps frames (craft_count1b_frame: main_data_begin 0, 396
    bytes of main data) whose second granule's part2_3_length ends 3 bits
    before the frame's main data does: its window and 8 pad bytes run past
    the frame, into the next frame's main data, where the copied walk's
    reservoir (and so its md row) still ends."""
    frame = bytearray(craft.craft_count1b_frame([(1, 0, 1, 0), (0, -1, 0, 1)]))
    side = 4 * 8  # no CRC: the side info follows the header
    # part2_3_length: side info bits 18..29 (granule 0), 77..88 (granule 1).
    first = _get_bits(frame, side + 18, 12)
    _set_bits(frame, side + 18 + 59, 12, 396 * 8 - first - 3)
    return bytes(frame) * 12


def _tiled(copies: int) -> bytes:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tiled.mp3")
        tile.tile_mp3(_clip(smoke.BENCH_TRACK), path, copies)
        return _read(path)


STREAMS = {os.path.basename(p): (lambda p=p: _read(p)) for p in CLIPS}
STREAMS.update({
    "bench_tiled_30min": lambda: _tiled(30),
    "id3v2_prefixed": lambda: _id3v2(b"TIT2" + bytes(300)) + _clip(smoke.TRANSIENT_TRACK),
    "cut_mid_frame": lambda: _clip(smoke.HOT_TRACK)[:23456],
    "no_frames": lambda: bytes(range(256)) * 20,
    "windows_past_the_frame": _windows_past_the_frame,
    "craft_mixed_block": craft.craft_mixed_block_stream,
    "craft_lsf_intensity": craft.craft_lsf_intensity_stream,
})


def _written(meta: np.ndarray) -> np.ndarray:
    """(n,) the md row bytes the copied walk writes: the window's
    ceil((p0 + p23) / 8) + 8 bytes and 8 zeros, within the row (16 zeros
    where a row has no window)."""
    p0 = meta[:, fe.LM_P0].astype(np.int64)
    p23 = meta[:, fe.LM_P23].astype(np.int64)
    return np.minimum((p0 + p23 + 7) // 8 + 16, fe.MD_STRIDE)


def assert_same_rows(packed: fe.UnpackedMp3LightPacked, streamed: fe.UnpackedMp3LightStream):
    """Every field but md equal; each md row's written bytes are its
    window's bytes in the stream, then zeros; rows without a window point
    at the stream's zero tail."""
    assert (streamed.n, streamed.sample_rate, streamed.n_channels) == (
        packed.n, packed.sample_rate, packed.n_channels)
    for k in ROW_FIELDS:
        a, b = getattr(packed, k), getattr(streamed, k)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
    md = streamed.md
    assert isinstance(md, fe.MdWindows) and md.shape == (packed.n, fe.MD_STRIDE)
    assert md.off.dtype == np.int64 and md.count.dtype == np.uint16
    end = md.stream.shape[0] - fe.STREAM_TAIL
    assert not md.stream[end:].any()
    assert np.all(md.off >= 0) and np.all(md.off + md.count <= end)
    bare = ~packed.meta.any(axis=1)
    assert np.all(md.off[bare] == end) and not md.count[bare].any()
    written = _written(packed.meta)
    j = np.arange(fe.MD_STRIDE)
    for a in range(0, packed.n, 8192):  # in chunks: a 30 min track is 275k rows
        off, count = md.off[a:a + 8192, None], md.count[a:a + 8192, None].astype(np.int64)
        rows = np.where(j < count, md.stream[np.minimum(off + j, end + fe.STREAM_TAIL - 1)], 0)
        mask = j < written[a:a + 8192, None]
        assert np.array_equal(rows[mask], packed.md[a:a + 8192][mask]), a


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_walk_gives_the_copied_walks_rows(name):
    data = STREAMS[name]()
    packed, streamed = fe.unpack_data_light_packed(data), fe.unpack_data_light_stream(data)
    assert_same_rows(packed, streamed)
    assert (streamed.n == 0) == (name == "no_frames")
    # The main data once: no more than the file, and far less than the rows.
    assert streamed.md.stream.nbytes <= len(data) + fe.STREAM_TAIL
    if streamed.n > 1000:
        assert streamed.md.emitted_bytes < packed.md.nbytes / 3


def test_windows_past_their_frame_are_cut_where_the_copied_walk_cuts_them():
    """The crafted stream's second granules: the window and its pad bytes
    run into the next frame's main data, which the stream holds but the
    copied walk's reservoir did not yet; the count stops at the frame."""
    data = _windows_past_the_frame()
    streamed = fe.unpack_data_light_stream(data)
    meta = streamed.meta
    full = np.minimum((meta[:, fe.LM_P0] + meta[:, fe.LM_P23] + 7) // 8 + 8, fe.MD_STRIDE)
    cut = (meta[:, fe.LM_P23] > 0) & (streamed.md.count < full)
    assert cut[1::2].all() and not cut[0::2].any()
    # ...while the stream goes on past the frame for all but the last.
    end = streamed.md.stream.shape[0] - fe.STREAM_TAIL
    assert np.all(streamed.md.off[1:-1:2] + full[1:-1:2] < end)


@pytest.mark.parametrize("seed", [3, 11])
def test_stream_walk_on_hostile_mutations(seed):
    """30 mutations of the bench clip per seed (byte flips, truncations,
    splices): the same rows as the copied walk, and the same prep."""
    rng = np.random.default_rng(seed)
    for i, data in enumerate(hostile.mutations(_clip(smoke.BENCH_TRACK), rng, 30)):
        packed, streamed = fe.unpack_data_light_packed(data), fe.unpack_data_light_stream(data)
        assert_same_rows(packed, streamed)
        if packed.n:
            assert_same_prep([packed.md], [streamed.md], [packed.meta])


def assert_same_prep(md_a, md_b, meta, **kw):
    a = ek.prepare_batch_compact(md_a, meta, **kw)
    b = ek.prepare_batch_compact(md_b, meta, **kw)
    assert (a.nb, a.n, a.g_real, a.g_pad) == (b.nb, b.n, b.g_real, b.g_pad)
    for k in ("words", "word_off", "order", "inv", "meta", "scalars"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _both(name: str):
    data = STREAMS[name]()
    return fe.unpack_data_light_packed(data), fe.unpack_data_light_stream(data)


def _batch_of(names):
    pairs = [_both(n) for n in names]
    return [p.md for p, _ in pairs], [s.md for _, s in pairs], [p.meta for p, _ in pairs]


def _segments(halo: bool):
    p, s = _both(smoke.BENCH_TRACK)
    plan = pr.segment_plan(p.n, p.sample_rate, p.n_channels, 4000)
    a, b = pr.split_track(p, plan)[int(halo)], pr.split_track(s, plan)[int(halo)]
    assert a.halo == b.halo == (pr.HALO if halo else 0)
    assert b.md.stream is s.md.stream  # the track's stream, not a copy
    return [a.md], [b.md], [a.meta]


def _at_the_cap():
    p, s = _both(smoke.BENCH_TRACK)
    k = pr.ROWS_CAP // p.n
    return [p.md] * k, [s.md] * k, [p.meta] * k


PREP_CASES = {
    "one_track": (lambda: _batch_of([smoke.TRANSIENT_TRACK]), {}),
    "three_tracks_quantized": (
        lambda: _batch_of([smoke.TRANSIENT_TRACK, smoke.HOT_TRACK, smoke.TRANSIENT_TRACK]),
        {"quantize_nb": True}),
    "mono_mpeg2": (lambda: _batch_of([smoke.MONO_TRACK, smoke.MONO_TRACK]), {}),
    "windows_past_the_frame": (lambda: _batch_of(["windows_past_the_frame"]), {}),
    "segment_without_halo": (lambda: _segments(False), {}),
    "segment_with_halo": (lambda: _segments(True), {"quantize_nb": True}),
    "forced_shapes": (lambda: _batch_of([smoke.TRANSIENT_TRACK]),
                      {"force_nb": 3, "force_g_pad": 1024}),
    "rows_cap": (_at_the_cap, {"quantize_nb": True}),
}


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_prep_of_the_stream_equals_prep_of_the_rows(case):
    (md_rows, md_windows, meta), kw = PREP_CASES[case][0](), PREP_CASES[case][1]
    assert_same_prep(md_rows, md_windows, meta, **kw)
    # A batch that mixes the two forms, track by track.
    mixed = [w if i % 2 else r for i, (r, w) in enumerate(zip(md_rows, md_windows))]
    assert_same_prep(md_rows, mixed, meta, **kw)


def test_admission_counts_the_stream_as_the_rows():
    """_est_resident_bytes of a stream-walked track, of its segments and of
    a batch of them is the packed form's: md counts as n x MD_STRIDE."""
    p, s = _both(smoke.HOT_TRACK)
    assert pr._est_resident_bytes([s]) == pr._est_resident_bytes([p])
    assert pr._est_resident_bytes([s, s, s]) == pr._est_resident_bytes([p, p, p])
    plan = pr.segment_plan(p.n, p.sample_rate, p.n_channels, 600)
    assert len(plan) >= 2
    for a, b in zip(pr.split_track(p, plan), pr.split_track(s, plan)):
        assert pr._est_resident_bytes([b]) == pr._est_resident_bytes([a])


def test_the_walk_counts_what_it_emits():
    data = _clip(smoke.TRANSIENT_TRACK)
    with tracing.recording():
        u = fe.unpack_data_light_stream(data)
        fe.unpack_data_light_stream(data)
    fe.unpack_data_light_stream(data)  # not recording: not counted
    assert tracing.counter("walk.md_bytes") == 2 * u.md.emitted_bytes
    assert u.md.emitted_bytes == u.md.stream.nbytes + 10 * u.n


def _library(tmp_path):
    """Two 3 s clips, a 22.05 kHz mono one, and the 5 s clip tiled to 15 s,
    which runs as segments at a rows cap of 1,400."""
    names = [smoke.TRANSIENT_TRACK, smoke.MONO_TRACK, smoke.HOT_TRACK]
    paths = []
    for i, n in enumerate(names):
        paths.append(str(tmp_path / f"{i}.mp3"))
        with open(paths[-1], "wb") as f:
            f.write(_clip(n))
    paths.append(str(tmp_path / "tiled.mp3"))
    tile.tile_mp3(_clip(smoke.HOT_TRACK), paths[-1], 3)
    return paths


def test_a_scan_of_the_stream_walk_equals_one_of_the_copied_walk(tmp_path, monkeypatch):
    paths = _library(tmp_path)

    def scan():
        with tracing.recording():
            res = pr.analyze_library(paths, runner=pr.Runner("cpu"), album=True,
                                     max_batch=2, rows_cap=1400)
            return res, tracing.snapshot()["counters"]

    streamed, counters = scan()
    assert counters["walk.md_bytes"] > 0 and counters["tracks.segmented"] == 1
    monkeypatch.setattr(fe, "unpack_data_light_stream", fe.unpack_data_light_packed)
    packed, counters = scan()
    assert "walk.md_bytes" not in counters
    for a, b in zip(streamed.tracks, packed.tracks):
        assert a.ok and b.ok, (a.error, b.error)
        assert (a.result.loudness_db, a.result.peak) == (b.result.loudness_db, b.result.peak)
        assert np.array_equal(a.histogram, b.histogram)
    assert np.array_equal(streamed.album_histogram, packed.album_histogram)
