"""The check fails what it must: a run with the timed path broken
underneath (an answer altered where it is produced; half of a batch or a
release left out) comes out not correct, a sound run correct, and the
control (the reference one precision down, on a card) not correct.

The runs skip the harness's look for a card and drive the rest of a run
on the CPU at a small size."""

import os
import sys

import numpy as np
import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

import run  # noqa: E402
from harness import check, registry  # noqa: E402

SEED = 2**31 + 101
CELLS = ["mp3_library.rescan", "mp3_library.release_ingest"]


def small_config():
    cfg = registry.config("mp3_library")
    cfg["track_seconds"] = [1, 2]
    cfg["releases"] = [{"kind": "album", "tracks": 1, "count": 1, "format": "mp3_22k_mono"},
                       {"kind": "album", "tracks": 2, "count": 1, "format": "mp3_48k"},
                       {"kind": "album", "tracks": 3, "count": 1, "format": "mp3_44k"}]
    cfg["check"]["sample_tracks"] = 6
    return cfg


def run_small(cell):
    spec = registry.load_spec(ROOT)
    return run.run_cell(spec, registry.cell(spec, cell), SEED, 0.2, trace=False,
                        device="cpu", config=small_config())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("what", ["peak", "loudness"])
def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch, cell, what):
    from mp3rgain_tpu_torch.parallel import runner as pr

    collect = pr.Runner.collect

    def altered(self, handle):
        hist, louds, peaks = collect(self, handle)
        if what == "peak":
            return hist, louds, np.asarray(peaks) * np.float32(1.001)
        return hist, louds + 0.02, peaks

    monkeypatch.setattr(pr.Runner, "collect", altered)
    out = run_small(cell)
    assert not out["correct"], out["check"]


def test_half_of_a_batch_left_out_is_caught(monkeypatch):
    from mp3rgain_tpu_torch.parallel import runner as pr

    library = pr.analyze_library

    def half(paths, *a, **k):
        return library(list(paths)[::2], *a, **k)

    monkeypatch.setattr(pr, "analyze_library", half)
    out = run_small("mp3_library.rescan")
    assert not out["correct"] and out["check"]["missing"]["value"] > 0


def test_half_of_a_release_left_out_is_caught(monkeypatch):
    from mp3rgain_tpu_torch import analysis

    album = analysis.analyze_album

    def half(files, *a, **k):
        return album(list(files)[: len(files) // 2], *a, **k)

    monkeypatch.setattr(analysis, "analyze_album", half)
    out = run_small("mp3_library.release_ingest")
    assert not out["correct"] and out["check"]["missing"]["value"] > 0


@pytest.mark.cuda
def test_the_control_is_not_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control computes in TF32, which needs a CUDA device")
    import control

    nums = control.control_numbers(small_config(), SEED, "cuda")
    assert not check.passed(nums), nums
