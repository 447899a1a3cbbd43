"""Torch port: the lane plan and the lane pack against prepare_batch.

prepare_batch_compact (decode/entropy_kernel.py, over _host/lane_plan.cpp)
plans a light batch and copies its rows in walk order; lane_pack (K0 on
the card, lane_pack_reference here) builds the entropy decode's inputs
from them. Both together must give exactly what the copied prepare_batch
gives, and what the JAX package's gives: the same lane order, unsort
permutation, block scalars and shapes, the same word buffer (every word,
its unowned tail zero) and the same packed meta. The batches cover every
committed MP3 clip's rate and channel count, empty tracks, one-track
batches, segments with and without a halo, pinned shapes, whole padding
blocks and a batch at the rows cap.
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mp3rgain_tpu.decode import entropy_kernel as jek  # noqa: E402
from mp3rgain_tpu.utils import bufpool as jbufpool  # noqa: E402
from mp3rgain_tpu_torch import tracing  # noqa: E402
from mp3rgain_tpu_torch.decode import entropy_kernel as ek  # noqa: E402
from mp3rgain_tpu_torch.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke  # noqa: E402
from mp3rgain_tpu_torch.utils import bufpool  # noqa: E402

torch.set_num_threads(2)

STANDARD = os.path.join(smoke.DATA_DIR, "standard")
CLIPS = sorted(
    [os.path.join(smoke.DATA_DIR, n) for n in os.listdir(smoke.DATA_DIR) if n.endswith(".mp3")]
    + [os.path.join(STANDARD, n) for n in os.listdir(STANDARD) if n.endswith(".mp3")])


def _walk(path):
    with open(path, "rb") as f:
        return fe.unpack_data_light_packed(f.read())


def _empty(u):
    """A track of no rows in u's format."""
    return u.md[:0], u.meta[:0]


def _segments(halo: bool):
    """Rows of the bench clip's segments at a small cap: the first (no
    halo) or the second (a halo of pr.HALO granule-times)."""
    u = _walk(os.path.join(smoke.DATA_DIR, smoke.BENCH_TRACK))
    seg = pr.split_track(u, pr.segment_plan(u.n, u.sample_rate, u.n_channels, 4000))[int(halo)]
    assert seg.halo == (pr.HALO if halo else 0)
    return [(seg.md, seg.meta)]


def _clip_rows(name, copies=1):
    u = _walk(os.path.join(smoke.DATA_DIR, name))
    return [(u.md, u.meta)] * copies


def _at_the_cap():
    """Copies of the bench clip, as many as fit in pr.ROWS_CAP rows."""
    u = _walk(os.path.join(smoke.DATA_DIR, smoke.BENCH_TRACK))
    return [(u.md, u.meta)] * (pr.ROWS_CAP // u.n)


# name -> (the batch's (md, meta) per track, prepare_batch's keywords)
CASES = {os.path.basename(p): (lambda p=p: [(_walk(p).md, _walk(p).meta)], {}) for p in CLIPS}
CASES.update({
    "three_tracks_quantized": (
        lambda: _clip_rows(smoke.TRANSIENT_TRACK, 2) + _clip_rows(smoke.HOT_TRACK),
        {"quantize_nb": True}),
    "empty_track_among_others": (
        lambda: [_empty(_walk(os.path.join(smoke.DATA_DIR, smoke.MONO_TRACK)))]
        + _clip_rows(smoke.MONO_TRACK), {}),
    "only_an_empty_track": (
        lambda: [_empty(_walk(os.path.join(smoke.DATA_DIR, smoke.MONO_TRACK)))], {}),
    "segment_without_halo": (lambda: _segments(False), {}),
    "segment_with_halo": (lambda: _segments(True), {"quantize_nb": True}),
    "forced_shapes": (lambda: _clip_rows(smoke.TRANSIENT_TRACK),
                      {"force_nb": 3, "force_g_pad": 1024}),
    "padding_blocks": (lambda: _clip_rows(smoke.MONO_TRACK), {"force_nb": 5}),
    "rows_cap": (_at_the_cap, {"quantize_nb": True}),
})


@pytest.fixture
def zeroed_pool(monkeypatch):
    """Pooled buffers come back with stale contents where prepare_batch
    leaves them unwritten (its buffer's tail); hand out zeroed ones so the
    whole buffer compares with the lane pack's, whose tail is zero."""
    for pool in (bufpool, jbufpool):
        monkeypatch.setattr(pool, "take", lambda shape, dtype: np.zeros(shape, dtype))


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16 else a))


def _compact_tensors(c: ek.CompactEntropy):
    return [_tensor(a) for a in (c.scalars, c.words, c.word_off, c.meta, c.order)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_plan_and_plain_pack_rebuild_prepare_batch(case, zeroed_pool):
    rows, kw = CASES[case]
    rows = rows()
    md, meta = [r[0] for r in rows], [r[1] for r in rows]
    want = ek.prepare_batch(md, meta, **kw)
    theirs = jek.prepare_batch(md, meta, **kw)
    got = ek.prepare_batch_compact(md, meta, **kw)

    n = sum(len(m) for m in meta)
    assert (got.nb, got.n, got.g_pad) == (want.nb, want.n, want.g_pad) == (
        theirs.nb, theirs.n, theirs.g_pad)
    for a in (want, theirs):
        assert np.array_equal(got.inv, a.inv) and np.array_equal(got.scalars, a.scalars)
    order = np.empty_like(want.inv)
    order[want.inv] = np.arange(len(order), dtype=order.dtype)
    assert np.array_equal(got.order, order)
    assert got.word_off.shape == (n + 1,) and got.meta.shape == (n, ek.META_ROWS)
    assert len(got.words) == got.word_off[-1] and np.all(np.diff(got.word_off) >= 0)
    assert got.g_real == int(np.sum(np.diff(np.append(got.scalars[:, 3:].ravel(), got.g_real))))

    with tracing.recording():
        buf, metab = ek.lane_pack(*_compact_tensors(got), g_real=got.g_real, g_pad=got.g_pad)
        assert (tracing.counter("plain.lane_pack"), tracing.counter("launches.lane_pack")) == (1, 0)
    for a in (want, theirs):
        assert torch.equal(buf, torch.from_numpy(a.buf))
        assert torch.equal(metab, _tensor(a.meta))
    assert not buf[got.g_real:].any()


def test_light_core_on_compact_arrays_equals_the_copied_core():
    """analysis_core_light_compact (lane pack, then the light core) on
    prepare_batch_arrays_light_compact's arrays gives the histograms,
    indices and peaks analysis_core_light gives on prepare_batch_arrays_light's,
    bit for bit, with the same rows beside the entropy input."""
    ups = [_walk(os.path.join(smoke.DATA_DIR, smoke.TRANSIENT_TRACK))] * 2
    tail = pr.LightTail(ups[0].sample_rate, ups[0].n_channels)
    prep, rest, g_max = pr.prepare_batch_arrays_light(ups, 2)
    old = pr.analysis_core_light(tail, *[_tensor(a) for a in (prep.scalars, prep.buf, prep.meta,
                                                             prep.inv) + tuple(rest)],
                                 nb=prep.nb, g_max=g_max)
    c, rest_c, g_c = pr.prepare_batch_arrays_light_compact(ups, 2)
    assert g_c == g_max
    for x, y in zip(rest, rest_c):
        assert np.array_equal(x, y)
    stages = []
    new = pr.analysis_core_light_compact(
        tail, *[_tensor(a) for a in (c.scalars, c.words, c.word_off, c.meta, c.order, c.inv)
                + tuple(rest_c)],
        nb=c.nb, g_max=g_c, g_real=c.g_real, g_pad=c.g_pad, on_stage=stages.append)
    assert stages[:3] == ["lane pack", "row map", "K1"]
    for x, y in zip(old, new):
        assert torch.equal(x, y)


def test_runner_ships_the_compact_arrays():
    """A light batch's Prepared holds the plan and the walk-order rows, not
    the lane-major buffer, and hands every pooled array back on upload."""
    u = _walk(os.path.join(smoke.DATA_DIR, smoke.MONO_TRACK))
    runner = pr.Runner("cpu")
    p = runner.prepare_light([u, u], u.sample_rate, u.n_channels)
    scalars, words, word_off, meta, order, inv = p.arrays[:6]
    assert word_off.shape == (2 * u.n + 1,) and meta.shape == (2 * u.n, ek.META_ROWS)
    assert len(words) == word_off[-1] and order.shape == inv.shape == (p.shapes["nb"] * ek.LANES,)
    assert np.array_equal(p.arrays[pr.LIGHT_COUNTS][:2], [u.n, u.n])
    assert {"g_real", "g_pad"} <= set(p.shapes)
    assert all(any(np.shares_memory(a, b) for b in p.pooled)
               for a in (words, word_off, meta, order, inv))
    hist, _, peak = runner.collect(runner.launch(p))
    want, _, want_peak = pr.Runner("cpu").analyze_unpacked_light([u], u.sample_rate, u.n_channels)
    assert np.array_equal(hist, np.repeat(want, 2, axis=0))
    assert np.array_equal(peak, np.repeat(want_peak, 2))


MALFORMED = {
    "words": lambda t: t.to(torch.int64),
    "word_off": lambda t: t.to(torch.int64),
    "meta": lambda t: t.to(torch.int32),
    "order": lambda t: t[:-1],
    "scalars": lambda t: t[:, :-1].contiguous(),
}


@pytest.mark.parametrize("field", sorted(MALFORMED))
def test_lane_pack_rejects_malformed_inputs(field):
    u = _walk(os.path.join(smoke.DATA_DIR, smoke.MONO_TRACK))
    c = ek.prepare_batch_compact(u.md, u.meta)
    args = dict(zip(("scalars", "words", "word_off", "meta", "order"), _compact_tensors(c)))
    args[field] = MALFORMED[field](args[field])
    with pytest.raises(ValueError, match=field):
        ek.lane_pack(**args, g_real=c.g_real, g_pad=c.g_pad)
    with pytest.raises(ValueError, match="g_real"):
        ek.lane_pack(*_compact_tensors(c), g_real=c.g_pad + 1, g_pad=c.g_pad)


def test_compact_plan_rejects_rows_wider_than_a_lane_reads():
    u = _walk(os.path.join(smoke.DATA_DIR, smoke.MONO_TRACK))
    wide = np.zeros((u.n, 4 * 8 * ek.W8_MAX + 4), np.uint8)
    with pytest.raises(ValueError, match="md rows"):
        ek.prepare_batch_compact(wide, u.meta)
