"""Torch port: the in-process recorder (mp3rgain_tpu_torch/tracing.py).

The span tree and counters of a small scan and of an album on the CPU
(names, parents, the entry-point ids that pool threads share, padded and
real rows against the prepared batches); nothing recorded while off; a
profiler session switching recording on for the pool threads; a fresh
record for each profiler session; recording() refusing to nest; the
spans' clock against the profiler's; the idle partition as a pure function.
One `cuda` test holds the Runner's busy intervals, mapped through its
anchor, to the profiler's device activity on the card.
"""

import os
import shutil
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mp3rgain_tpu_torch import analysis, scan, tracing
from mp3rgain_tpu_torch.parallel import runner as pr
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke

torch.set_num_threads(2)

STAGES = ["row map", "K1", "gathers", "K2", "hybrid GEMMs", "overlap-add + polyphase",
          "peak", "IIR", "histogram + index"]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two 44.1 kHz stereo and two 22.05 kHz mono copies of the committed
    3 s clips: two buckets, one batch each."""
    out = tmp_path_factory.mktemp("tracing")
    paths = []
    for i, name in enumerate([smoke.TRANSIENT_TRACK, smoke.MONO_TRACK] * 2):
        paths.append(str(out / f"t{i}.mp3"))
        shutil.copy(os.path.join(smoke.DATA_DIR, name), paths[-1])
    return paths


def _capture_prepared(monkeypatch, runner):
    """The Prepared batches runner.prepare_light hands out."""
    seen = []
    real = runner.prepare_light

    def prepare(*a):
        seen.append(real(*a))
        return seen[-1]

    monkeypatch.setattr(runner, "prepare_light", prepare)
    return seen


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_scan_span_tree_and_counters(clips, tmp_path, monkeypatch):
    runner = pr.Runner("cpu")
    prepared = _capture_prepared(monkeypatch, runner)
    with tracing.recording():
        res = scan.scan_files(clips, manifest_path=tmp_path / "m.json", runner=runner)
        scan.album_union(res, clips[:2])
    snap = tracing.snapshot()
    assert len(res.results) == len(clips)
    assert not any(isinstance(r, Exception) for r in res.results.values())
    spans = _by_name(snap["spans"])
    (root,) = spans["scan"]
    assert root["parent"] is None and root["root"] == root["id"]
    (union,) = spans["album_union"]
    assert union["parent"] is None and union["root"] == union["id"] != root["id"]
    ids = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        if s is not union:
            assert s["root"] == root["id"], s  # one entry-point call, every thread
    for name in ("manifest.lookup", "manifest.compact", "drain"):
        assert [s["parent"] for s in spans[name]] == [root["id"]], name
    (lookup,) = spans["manifest.lookup"]
    assert [s["parent"] for s in spans["detect"]] == [lookup["id"]] * len(clips)
    assert len(spans["walk"]) == len(clips)
    assert all(s["parent"] == root["id"] and s["submit_ns"] <= s["start_ns"]
               for s in spans["walk"])
    # Two batches: each prepared on the prep pool, uploaded and enqueued on
    # the uploader thread, collected on the caller's, journalled.
    assert len(spans["prep"]) == len(spans["upload"]) == len(spans["enqueue"]) == 2
    for p in spans["prep"]:
        assert p["parent"] == root["id"] and p["thread"].startswith("mp3rgain-prep")
        assert p["submit_ns"] <= p["start_ns"]  # the prep pool's queue wait
    for u in spans["upload"]:
        assert u["parent"] == root["id"] and u["thread"].startswith("mp3rgain-upload")
    assert {s["parent"] for s in spans["enqueue"]} == {u["id"] for u in spans["upload"]}
    assert len(spans["manifest.journal"]) == 2
    assert all(ids[s["parent"]]["name"] in ("drain", "admit", "scan")
               for s in spans["collect"])
    # The device stages of each batch, in order, under its upload span.
    for u in spans["upload"]:
        stages = sorted((s for s in snap["spans"] if s["device"] and s["parent"] == u["id"]),
                        key=lambda s: s["start_ns"])
        assert [s["name"] for s in stages] == STAGES
        assert all(s["thread"] == "cpu" for s in stages)
    assert not any(s["device"] for s in snap["spans"] if s["name"] not in STAGES)
    # Counters: the rows the prepared batches hold and the rows they pad to.
    assert len(prepared) == 2
    real = sum(int(p.arrays[4].sum()) for p in prepared)  # the per-track counts
    padded = sum(len(p.arrays[4]) * p.shapes["g_max"] for p in prepared)
    c = snap["counters"]
    assert (c["rows.real"], c["rows.padded"]) == (real, padded) and real < padded
    assert c["plain.entropy_decode_rows"] == c["plain.requant_stereo"] == 2
    assert "launches.entropy_decode_rows" not in c
    t = snap["totals"]
    assert t["walk"]["count"] == len(clips) and t["prep"]["count"] == 2
    assert t["scan"]["self_s"] < t["scan"]["wall_s"]
    assert snap["dropped"] == 0 and snap["busy"] == []  # the CPU has no busy intervals


def test_album_span_tree(clips, monkeypatch):
    runner = pr.Runner("cpu")
    prepared = _capture_prepared(monkeypatch, runner)
    with tracing.recording():
        analysis.analyze_album(clips[:2], device="cpu", runner=runner)
    snap = tracing.snapshot()
    spans = _by_name(snap["spans"])
    (album,) = spans["album"]
    assert album["parent"] is None
    assert all(s["root"] == album["id"] for s in snap["spans"])
    assert [s["parent"] for s in spans["track"]] == [album["id"]] * 2
    tracks = {s["id"] for s in spans["track"]}
    for name in ("detect", "walk", "prep", "upload", "collect"):
        assert len(spans[name]) == 2 and {s["parent"] for s in spans[name]} == tracks, name
    assert {s["parent"] for s in spans["enqueue"]} == {s["id"] for s in spans["upload"]}
    host = [s for s in snap["spans"] if not s["device"]]
    assert {s["thread"] for s in host} == {"MainThread"}
    assert sorted(s["name"] for s in snap["spans"] if s["device"]) == sorted(STAGES * 2)
    assert snap["counters"]["rows.real"] == sum(int(p.arrays[4].sum()) for p in prepared)
    assert snap["counters"]["rows.padded"] == sum(len(p.arrays[4]) * p.shapes["g_max"]
                                                  for p in prepared)


def test_nothing_is_recorded_when_off(clips):
    with tracing.recording():
        with tracing.span("before"):
            pass
    kept = tracing.snapshot()
    assert not tracing.on()
    assert tracing.span("a") is tracing.span("b")  # the shared do-nothing context
    with tracing.span("a") as s:
        assert s is None

    def f():
        return 1

    assert tracing.carry(f) is f
    tracing.count("rows.real", 5)
    pr.analyze_library(clips[:1], runner=pr.Runner("cpu"))
    after = tracing.snapshot()
    assert after is kept and [s["name"] for s in after["spans"]] == ["before"]
    assert after["counters"] == {}


def test_a_profiler_session_records_the_pool_threads(clips):
    with tracing.recording():
        with tracing.span("an earlier record"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.on()
        pr.analyze_library(clips[:3], runner=pr.Runner("cpu"))
    assert not tracing.on()
    snap = tracing.snapshot()
    spans = _by_name(snap["spans"])
    assert "an earlier record" not in spans  # the session started a fresh record
    walk_threads = {s["thread"] for s in spans["walk"]}
    assert len(spans["walk"]) == 3
    assert walk_threads != {"MainThread"} or (os.cpu_count() or 1) <= 3
    assert all(s["thread"].startswith("mp3rgain-prep") for s in spans["prep"])
    assert all(s["thread"].startswith("mp3rgain-upload") for s in spans["upload"])
    assert snap["counters"]["plain.entropy_decode_rows"] == 2
    assert tracing.snapshot() is snap  # read after the session: the record has ended


def test_each_profiler_session_starts_a_fresh_record():
    """Two sessions back to back, no snapshot between them: the second
    record holds only the second session's spans and counts."""
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span(name):
                tracing.count("sessions")
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["second"]
    assert snap["counters"] == {"sessions": 1} and list(snap["totals"]) == ["second"]


def test_recording_does_not_nest():
    with tracing.recording():
        tracing.count("outer")
        with pytest.raises(RuntimeError, match="already active"):
            with tracing.recording():
                pass
        assert tracing.on()
        tracing.count("outer")
        with profile(activities=[ProfilerActivity.CPU]):  # records into the outer record
            tracing.count("outer")
    assert not tracing.on()
    assert tracing.snapshot()["counters"] == {"outer": 3}


def test_many_threads_lose_no_span_or_count():
    """More threads than cores and a short switch interval: every span and
    every count arrives, each span under the carried parent."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    n, per = 4 * (os.cpu_count() or 1), 200

    def work(_):
        for _ in range(per):
            with tracing.span("stress"):
                tracing.count("stress")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording(), tracing.span("root") as root:
            with ThreadPoolExecutor(n) as ex:
                list(ex.map(tracing.carry(work), range(n), timeout=120))
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    assert snap["totals"]["stress"]["count"] == snap["counters"]["stress"] == n * per
    stress = [s for s in snap["spans"] if s["name"] == "stress"]
    assert len(stress) == n * per and {s["parent"] for s in stress} == {root.id}
    assert len({s["id"] for s in snap["spans"]}) == len(snap["spans"])


def test_spans_are_on_the_profilers_clock():
    """A span on the caller's thread is also a profiler event of its name;
    its start and end match the event's within 0.1 ms. (A process's first
    record_function sets up for about 1 ms after its event has started: a
    span opened first takes that call.)"""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("first"):
            pass
        for _ in range(3):
            with tracing.span("clock probe"):
                time.sleep(0.002)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock probe"]
    spans = _by_name(tracing.snapshot()["spans"])["clock probe"]
    assert len(events) == len(spans) == 3
    for e, s in zip(sorted(events, key=lambda e: e.start_ns()), spans):
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert abs(s["start_ns"] - start) < 100_000, (s["start_ns"], start)
        assert abs(s["end_ns"] - end) < 100_000, (s["end_ns"], end)


# --- the idle partition, a pure function -------------------------------------

def _brute(spans, busy, lo, hi):
    """The partition by walking every nanosecond of a small window."""
    classes = {c: 0 for c, _ in tracing.IDLE_CLASSES}
    untraced = 0
    for t in range(lo, hi):
        if any(a <= t < b for a, b in busy):
            continue
        for c, names in tracing.IDLE_CLASSES:
            if any(n in names and a <= t < b for n, a, b in spans):
                classes[c] += 1
                break
        else:
            untraced += 1
    return classes, untraced


def test_idle_partition_priority_order():
    spans = [("scan", 0, 100), ("upload", 10, 30), ("prep", 20, 40), ("walk", 35, 60),
             ("manifest.journal", 55, 70), ("album_union", 65, 75), ("collect", 72, 85),
             ("drain", 80, 95), ("detect", 96, 98)]
    busy = [(25, 37), (90, 92)]
    got = tracing.idle_partition(spans, busy)
    c = {k: round(v * 1e9) for k, v in got["classes"].items()}
    # upload 10-25, prep 37-40, walk 40-60 and 96-98, manifest 60-70,
    # album union 70-75, collect 75-85, admit 85-90 and 92-95; the rest
    # (0-10, 95-96, 98-100) is the root's self time: untraced.
    assert c == {"upload": 15, "prep": 3, "walk": 22, "manifest": 10, "album_union": 5,
                 "collect": 10, "admit": 8}
    assert round(got["untraced_s"] * 1e9) == 13
    assert round(got["idle_s"] * 1e9) == 100 - 14
    assert round(got["window_s"] * 1e9) == 100


@pytest.mark.parametrize("seed", range(8))
def test_idle_partition_sums_to_the_idle_time(seed):
    rng = np.random.default_rng(seed)
    names = [n for _, ns in tracing.IDLE_CLASSES for n in ns] + ["scan", "track", "K1"]
    spans = []
    for _ in range(12):
        a = int(rng.integers(0, 200))
        spans.append((str(rng.choice(names)), a, a + int(rng.integers(1, 60))))
    busy = []
    for _ in range(5):
        a = int(rng.integers(0, 250))
        busy.append((a, a + int(rng.integers(1, 40))))
    lo, hi = 5, 240
    got = tracing.idle_partition(spans, busy, lo, hi)
    classes, untraced = _brute(spans, busy, lo, hi)
    assert {k: round(v * 1e9) for k, v in got["classes"].items()} == classes
    assert round(got["untraced_s"] * 1e9) == untraced
    total = sum(got["classes"].values()) + got["untraced_s"]
    assert abs(total - got["idle_s"]) < 1e-12


def test_idle_partition_of_nothing():
    got = tracing.idle_partition([], [(0, 10)])
    assert got == {"window_s": 0.0, "idle_s": 0.0, "untraced_s": 0.0,
                   "classes": {c: 0.0 for c, _ in tracing.IDLE_CLASSES}}


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_busy_intervals_meet_the_profilers_device_activity(clips):
    """In a traced scan on the card the Runner's busy intervals (CUDA
    events, mapped through its anchor onto the tracing clock) start and end
    within 0.5 ms of the profiler's device activity at the median edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    runner = pr.Runner("cuda")
    paths = clips * 4
    pr.analyze_library(paths, runner=runner, max_batch=2)  # warm: tables, kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pr.analyze_library(paths, runner=runner, max_batch=2)
        torch.cuda.synchronize()
    busy = tracing.snapshot()["busy"]
    assert len(busy) == 2 * 8  # an upload and a compute interval per batch
    dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation())
    starts = np.array([a for a, _ in dev])
    ends = np.array([b for _, b in dev])
    gaps = []
    for a, b in busy:
        gaps.append(np.abs(starts - a).min())
        gaps.append(np.abs(ends - b).min())
    median_ms = statistics.median(gaps) / 1e6
    assert median_ms < 0.5, (median_ms, sorted(gaps))
