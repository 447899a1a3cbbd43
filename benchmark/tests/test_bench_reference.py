"""The plain reference: its decoder against libmpg123 (where the system
has it), its gains and peaks against the float64 ReplayGain oracle on the
committed clips, the periodic shortcut against a whole decode, and what
every module the benchmark runs imports."""

import ast
import glob
import os
import sys

import numpy as np
import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

from harness import library, registry, tile  # noqa: E402
from reference import mp3dec, replaygain, track  # noqa: E402

MP3 = registry.format_module("mp3")

CLIPS = sorted(glob.glob(os.path.join(library.CLIP_DIR, "*.mp3")))
FORBIDDEN = {"jax", "jaxlib", "flax", "mp3rgain_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def benchmark_modules():
    mods = glob.glob(os.path.join(BENCH_DIR, "*.py"))
    for sub in ("harness", "reference", "metrics", "drivers", "formats"):
        mods += glob.glob(os.path.join(BENCH_DIR, sub, "*.py"))
    return sorted(mods)


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    mods = benchmark_modules()
    assert len(mods) > 20
    for m in mods:
        found = top_level_imports(m) & FORBIDDEN
        assert not found, (m, found)
    # whole top-level names: the port's name begins with the JAX package's
    assert "mp3rgain_tpu_torch" in set().union(*map(top_level_imports, mods))


def test_the_reference_imports_nothing_of_the_program():
    for m in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        names = top_level_imports(m)
        assert not names & (FORBIDDEN | {"mp3rgain_tpu_torch", "harness"}), (m, names)
        assert names <= {"__future__", "hashlib", "json", "math", "os", "dataclasses",
                         "numpy", "torch", "scipy"}, (m, names)


def _mpg123():
    try:
        from mp3rgain_tpu_torch.testing import mpg123

        mpg123.decode_file(CLIPS[0])
        return mpg123
    except OSError:
        return None


@pytest.mark.parametrize("clip", CLIPS, ids=os.path.basename)
def test_the_decoder_matches_libmpg123(clip):
    mpg123 = _mpg123()
    if mpg123 is None:
        pytest.skip("libmpg123 is not on this machine")
    ref, sr = mpg123.decode_file(clip)
    ref = np.asarray(ref)
    pcm = mp3dec.decode(open(clip, "rb").read()).numpy()
    if ref.shape[0] != pcm.shape[0]:
        ref = ref.T
    assert ref.shape == pcm.shape
    # libmpg123 decodes in float32: its rounding is the difference
    assert np.abs(ref - pcm).max() < 5e-6


@pytest.mark.parametrize("clip", CLIPS, ids=os.path.basename)
def test_gain_and_peak_match_the_float64_oracle_on_the_committed_clips(clip):
    from mp3rgain_tpu_torch.testing import reference as oracle

    data = open(clip, "rb").read()
    pcm = mp3dec.decode(data).numpy()
    sr = mp3dec.walk(data)[0].sample_rate
    a = track.Analyzer().track(data)
    assert abs(a.gain - oracle.reference_gain(pcm, sr)) < 1e-9
    assert a.peak == oracle.reference_peak(pcm)


@pytest.mark.parametrize("clip,copies", [("test_vbr.mp3", 5), ("transient_3s_44k_128k.mp3", 4),
                                         ("mono_3s_22k_48k.mp3", 3), ("test_48000.mp3", 7)])
def test_the_periodic_shortcut_equals_a_whole_decode(tmp_path, clip, copies):
    src = open(os.path.join(library.CLIP_DIR, clip), "rb").read()
    path = tmp_path / "t.mp3"
    tile.tile_mp3(src, path, copies)
    data = path.read_bytes()
    a = track.Analyzer().track(data)
    pcm = mp3dec.decode(data).numpy()
    sr = mp3dec.walk(data)[0].sample_rate
    hist = replaygain.track_histogram(pcm, sr)
    assert a.samples == pcm.shape[1]
    assert (a.histogram == hist).all()
    assert a.gain == replaygain.gain(hist)
    assert a.peak == float(np.abs(pcm).max())


def test_a_second_level_reuses_the_decode_and_scales_it(tmp_path):
    src = open(os.path.join(library.CLIP_DIR, "test_stereo.mp3"), "rb").read()
    lay = tile.mp3_layout(src)
    an = track.Analyzer()
    answers = []
    for step in (0, -3):
        data = lay.head + MP3.edit_gain(lay.audio, step) * 4 + lay.tail
        answers.append(an.track(data))
    assert len(an._decoded) == 1
    fresh = track.Analyzer().track(lay.head + MP3.edit_gain(lay.audio, -3) * 4 + lay.tail)
    assert abs(answers[1].peak - fresh.peak) <= 1e-15
    assert (answers[1].histogram == fresh.histogram).all()
    assert answers[1].peak == pytest.approx(answers[0].peak * 2 ** -0.75, rel=1e-12)
