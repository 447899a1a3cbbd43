"""The podcast archive: its configuration is found by name and plans 16
episodes of 30 min to 6 h in 4 show folders, most of whose audio lies in
episodes over the program's rows cap; its metric readers on synthetic
records. Run from the checkout's root: python -m pytest benchmark/tests -q"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

from harness import library, registry  # noqa: E402

CELL = "podcast_archive.rescan"
ROWS_CAP = 640_000  # the program's rows cap, in granule-channel rows


def _episodes():
    cfg = registry.config("podcast_archive")
    out = []
    for rel in library.plan(cfg, 2**31 + 19):
        module = cfg["formats"][rel.format]["module"]
        for _, clip, copies, _ in rel.tracks:
            lay = library.clip_layout(module, clip)
            granules = copies * lay.samples // 576
            out.append((rel.name, rel.format, copies * lay.samples / lay.sample_rate,
                        granules * lay.channels))
    return out


def test_the_archive_is_found_by_name_and_plans_its_episodes():
    spec = registry.load_spec(ROOT)
    cell = registry.cell(spec, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("podcast_archive", "rescan", 1)
    assert registry.mix(cell["traffic"])["driver"] == "rescan"
    eps = _episodes()
    assert len(eps) == 16 and len({name for name, *_ in eps}) == 4
    assert sorted(f for _, f, _, _ in eps).count("mp3_22k_mono") == 4
    seconds = [s for _, _, s, _ in eps]
    assert 1800 <= min(seconds) and max(seconds) <= 21600 + 5
    assert sum(seconds) / 3600 == pytest.approx(52.0, abs=0.1)
    over = [(f, s) for _, f, s, rows in eps if rows > ROWS_CAP]
    assert sum(f == "mp3_44k" for f, _ in over) == 11
    assert sum(f == "mp3_22k_mono" for f, _ in over) == 1
    assert sum(s for _, s in over) / sum(seconds) == pytest.approx(0.84, abs=0.02)


def test_the_new_readers_on_synthetic_records():
    from mp3rgain_tpu_torch import tracing

    rec = {"analysed": {"audio_s": 7200.0}, "window_s": 10.0,
           "busy_ms": [(0.0, 2000.0), (1000.0, 3000.0)],
           "timings": [{"device_ms": 500.0}, {"device_ms": 700.0}]}
    with tracing.recording():
        tracing.gauge("device.peak_bytes", 7_000_000_000)
        tracing.gauge("device.peak_bytes", 9_500_000_000)
        tracing.gauge("device.peak_bytes", 8_000_000_000)
        tracing.device_spans("cuda:0", 1, 1, [("carry", 0, 2_000_000),
                                              ("carry", 5_000_000, 6_000_000)])
        peak = registry.reader("device_peak_gb.podcast_rescan")(rec)
        carry = registry.reader("carry_s_per_audio_h.podcast_rescan")(rec)
    assert peak == pytest.approx(9.5)
    assert carry == pytest.approx(0.003 / 2.0)
    assert registry.reader("device_idle_pct.podcast_rescan")(rec) == \
        registry.reader("device_idle_pct.rescan")(rec) == pytest.approx(70.0)
    assert registry.reader("device_s_per_audio_h.podcast_rescan")(rec) == \
        registry.reader("device_s_per_audio_h.rescan")(rec) == pytest.approx(0.6)
    # A program that records neither (the parent of this cell): no value.
    with tracing.recording():
        assert registry.reader("device_peak_gb.podcast_rescan")(rec) is None
        assert registry.reader("carry_s_per_audio_h.podcast_rescan")(rec) is None


# The rescan readers the podcast cell loads by name, each as it reads there.
SHARED = ("prep_s_per_audio_h", "upload_s_per_audio_h", "walk_s_per_audio_h",
          "idle_walk_s_per_pass", "idle_untraced_pct", "row_fill_pct",
          "synthesis_s_per_audio_h", "k1_roofline_pct", "k2_roofline_pct")


@pytest.mark.parametrize("base", SHARED)
def test_the_podcast_readers_read_as_the_rescan_ones(base):
    import time

    from mp3rgain_tpu_torch import tracing

    rec = {"analysed": {"audio_s": 7200.0, "main_data_bytes": 10**8,
                        "side_info_bytes": 10**6, "granule_channels": 10**5},
           "window_s": 10.0, "passes": [{}, {}],
           "busy_ms": [(0.0, 2000.0)],
           "timings": [{"device_ms": 500.0, "prep_s": 0.25, "h2d_s": 0.05},
                       {"device_ms": 700.0, "prep_s": 0.75, "h2d_s": 0.15}],
           "kernels": {"entropy_decode_rows_kernel(int*)": 0.01,
                       "requant_stereo_kernel(float*)": 0.02}}
    with tracing.recording():
        for name in ("walk", "prep"):
            with tracing.span(name):
                time.sleep(0.002)
        tracing.count("rows.real", 3)
        tracing.count("rows.padded", 4)
        tracing.device_spans("cuda:0", 1, 1, [("hybrid GEMMs", 0, 2_000_000),
                                              ("overlap-add + polyphase", 0, 1_000_000)])
        got = registry.reader(f"{base}.podcast_rescan")(rec)
        want = registry.reader(f"{base}.rescan")(rec)
    assert got is not None and got == want


def test_idle_under_prep_per_pass():
    import time

    from mp3rgain_tpu_torch import tracing

    rec = {"passes": [{}, {}]}
    with tracing.recording():
        with tracing.span("prep"):
            time.sleep(0.004)
        snap = tracing.snapshot()
        got = registry.reader("idle_prep_s_per_pass.podcast_rescan")(rec)
    assert got == snap["idle"]["classes"]["prep"] / 2 and got >= 0.002
    with tracing.recording():
        assert registry.reader("idle_prep_s_per_pass.podcast_rescan")(rec) is None

