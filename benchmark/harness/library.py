"""A configuration's library of tracks, written from the seed.

The configuration fixes the composition: the releases (their kinds, sizes
and formats), each format's module (formats/<module>.py, found by name)
and the clips it draws on with their shares, the span of track lengths
and the set of level steps. From that the plan is the same for every
seed: the same tracks (clip, copies) in the same releases, under the same
folder names, so every seed gives the same work in the same order. The
seed only deals the fixed set of level steps over the tracks.

The format module writes each track (copies of a clip at a level) and
says what it holds for the kernel metrics.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import registry

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_DIR = os.path.join(BENCH_DIR, "clips")


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of the seed; any whole number is a seed."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


@dataclass
class Track:
    path: str
    clip: str
    copies: int
    step: int
    seconds: float
    sample_rate: int
    channels: int
    module: str
    counts: dict = field(default_factory=dict)


@dataclass
class Release:
    name: str
    kind: str
    format: str
    tracks: list


def _counts(weights: dict, n: int) -> dict:
    """Largest-remainder split of n over the weights, in key order."""
    keys = list(weights)
    w = np.array([weights[k] for k in keys], float)
    raw = w / w.sum() * n
    base = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - base), kind="stable")[: n - base.sum()]:
        base[i] += 1
    return dict(zip(keys, base.tolist()))


_LAYOUTS: dict = {}


def clip_layout(module: str, clip: str):
    if (module, clip) not in _LAYOUTS:
        with open(os.path.join(CLIP_DIR, clip), "rb") as f:
            _LAYOUTS[module, clip] = registry.format_module(module).layout(f.read())
    return _LAYOUTS[module, clip]


def plan(config: dict, seed: int) -> list[Release]:
    """The releases of a configuration for a seed (paths relative)."""
    lo, hi = config["track_seconds"]
    steps_lo, steps_hi = config["gain_steps"]
    fixed = np.random.default_rng(0)  # one layout for every seed
    slots = []  # (kind, tracks, format) of every release
    for spec in config["releases"]:
        for _ in range(spec["count"]):
            slots.append((spec["kind"], spec["tracks"], spec["format"]))
    slots = [slots[i] for i in fixed.permutation(len(slots))]
    # every format's tracks: (clip, copies)
    specs = {}
    for fmt, fspec in config["formats"].items():
        n = sum(t for _, t, f in slots if f == fmt)
        counts = _counts(fspec["clips"], n)
        order = []
        pending = dict(counts)
        while len(order) < n:  # round robin, so each clip spans the lengths
            for clip in counts:
                if pending[clip]:
                    order.append(clip)
                    pending[clip] -= 1
        lengths = lo + (hi - lo) * (np.arange(n) + 0.5) / n
        out = []
        for clip, sec in zip(order, lengths):
            lay = clip_layout(fspec["module"], clip)
            out.append((clip, max(1, -(-int(round(sec * lay.sample_rate)) // lay.samples))))
        specs[fmt] = [out[i] for i in fixed.permutation(n)]
    n_tracks = sum(t for _, t, _ in slots)
    step_set = np.resize(np.arange(steps_lo, steps_hi + 1), n_tracks)
    steps = iter(step_set[rng_for(seed, 0).permutation(n_tracks)])
    releases, taken = [], {fmt: 0 for fmt in specs}
    for pos, (kind, size, fmt) in enumerate(slots):
        name = f"r{pos:02d}_{kind}"
        ext = registry.format_module(config["formats"][fmt]["module"]).EXTENSION
        releases.append(Release(name, kind, fmt, [
            (f"{name}/t{j + 1:02d}.{ext}", clip, copies, int(next(steps)))
            for j, (clip, copies) in enumerate(specs[fmt][taken[fmt]:taken[fmt] + size])]))
        taken[fmt] += size
    return releases


def write(releases: list[Release], root: str, config: dict) -> list[Release]:
    """Write the planned tracks under `root`; returns the releases with
    Track entries (absolute paths)."""
    out = []
    for rel in releases:
        module = config["formats"][rel.format]["module"]
        fmt = registry.format_module(module)
        os.makedirs(os.path.join(root, rel.name), exist_ok=True)
        tracks = []
        for relpath, clip, copies, step in rel.tracks:
            lay = clip_layout(module, clip)
            path = os.path.join(root, relpath)
            counts = fmt.write(path, lay, copies, step)
            tracks.append(Track(path, clip, copies, step, copies * lay.samples / lay.sample_rate,
                                lay.sample_rate, lay.channels, module, counts))
        out.append(Release(rel.name, rel.kind, rel.format, tracks))
    return out
