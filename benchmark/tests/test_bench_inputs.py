"""The input makers: the library is a function of the seed, every tiled
track is one the program's light walk accepts, the level edit moves the
decoded level by 2^(step/4), and the frame walker's counts."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

from harness import library, registry, tile  # noqa: E402
from reference import mp3dec  # noqa: E402

SEED = 2**31 + 11
MP3 = registry.format_module("mp3")


def small_config():
    cfg = registry.config("mp3_library")
    cfg["track_seconds"] = [2, 4]
    cfg["releases"] = [{"kind": "single", "tracks": 2, "count": 1, "format": "mp3_22k_mono"},
                       {"kind": "ep", "tracks": 4, "count": 1, "format": "mp3_48k"},
                       {"kind": "album", "tracks": 12, "count": 1, "format": "mp3_44k"}]
    return cfg


def digests(releases):
    return {os.path.relpath(t.path, os.path.dirname(os.path.dirname(t.path))):
            hashlib.sha1(open(t.path, "rb").read()).hexdigest()
            for r in releases for t in r.tracks}


def test_the_same_seed_gives_the_same_bytes(tmp_path):
    cfg = small_config()
    a = library.write(library.plan(cfg, SEED), str(tmp_path / "a"), cfg)
    b = library.write(library.plan(cfg, SEED), str(tmp_path / "b"), cfg)
    assert digests(a) == digests(b)
    c = library.write(library.plan(cfg, SEED + 1), str(tmp_path / "c"), cfg)
    assert digests(a) != digests(c)


@pytest.mark.parametrize("seed", [0, 12345, -3, 2**40 + 1])
def test_every_seed_gives_the_same_work(seed):
    cfg = registry.config("mp3_library")
    base = library.plan(cfg, 1)
    other = library.plan(cfg, seed)

    def work(rels):
        return [(r.name, r.kind, r.format, [(p, clip, copies) for p, clip, copies, _ in r.tracks])
                for r in rels]

    def steps(rels):
        return [step for r in rels for *_, step in r.tracks]

    # the same tracks in the same folders, in the same order: only the
    # levels are dealt by the seed, from one fixed set
    assert work(base) == work(other)
    assert sorted(steps(base)) == sorted(steps(other))
    n = sum(len(r.tracks) for r in base)
    assert n == 120 and len(base) == 10


def test_the_programs_light_walk_accepts_every_tiled_track(tmp_path):
    from mp3rgain_tpu_torch.decode import frontend

    cfg = small_config()
    rels = library.write(library.plan(cfg, SEED), str(tmp_path), cfg)
    clips = set()
    for r in rels:
        for t in r.tracks:
            u = frontend.unpack_data_light_packed(open(t.path, "rb").read())
            assert u.n > 0 and u.sample_rate == t.sample_rate and u.n_channels == t.channels
            clips.add(t.clip)
    assert len(clips) >= 5


@pytest.mark.parametrize("clip,step", [("test_stereo.mp3", -4), ("test_joint_stereo.mp3", 2),
                                       ("mono_3s_22k_48k.mp3", -1), ("test_48000.mp3", 3)])
def test_the_level_edit_scales_the_decode_by_2_to_the_step_over_4(clip, step):
    data = open(os.path.join(library.CLIP_DIR, clip), "rb").read()
    lay = tile.mp3_layout(data)
    edited = MP3.edit_gain(lay.audio, step)
    assert len(edited) == len(lay.audio) and edited != lay.audio
    a = mp3dec.decode(lay.audio).numpy()
    b = mp3dec.decode(edited).numpy()
    np.testing.assert_allclose(b, a * 2.0 ** (step / 4), rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        MP3.edit_gain(lay.audio, 200)


def test_the_frame_walker_counts_the_streams_bytes():
    data = open(os.path.join(library.CLIP_DIR, "bench_60s_44k_joint_192k.mp3"), "rb").read()
    lay = tile.mp3_layout(data)
    md, si, gc = MP3.frame_counts(lay.audio)
    assert gc == lay.frames * 2 * 2
    assert si == lay.frames * 32
    assert md + si + 4 * lay.frames == len(lay.audio)


def test_the_config_keeps_its_stated_shares():
    cfg = registry.config("mp3_library")
    rels = library.plan(cfg, SEED)
    assert [len(r.tracks) for r in rels] == [12] * 10
    assert {r.kind for r in rels} == {"album"}
    fmt = {}
    for r in rels:
        fmt[r.format] = fmt.get(r.format, 0) + len(r.tracks)
    assert fmt == {"mp3_44k": 96, "mp3_48k": 12, "mp3_22k_mono": 12}
    seconds = []
    for r in rels:
        module = cfg["formats"][r.format]["module"]
        for _, clip, copies, _ in r.tracks:
            lay = library.clip_layout(module, clip)
            seconds.append(copies * lay.samples / lay.sample_rate)
    assert 180 <= min(seconds) and max(seconds) <= 361
    assert 270 <= sum(seconds) / len(seconds) <= 280
    json.dumps(cfg)
