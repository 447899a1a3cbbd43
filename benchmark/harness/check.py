"""The comparison that decides `correct`.

A sample of releases drawn from the seed (one of every format of the
library, then more until it holds the config's sample_tracks tracks) is
analysed by the plain reference (each format module's analyzer over
reference/), which reads the track files the benchmark wrote and nothing
the program made. Every answer the program owed for a sampled track or
release in the window is compared with it:

- track_gain_gap_db: the widest |gain - reference gain| over the sampled
  tracks' answers, in dB;
- album_gain_gap_db: the same over the sampled releases' album gains;
- peak_rel_gap: the widest |peak - reference peak| / reference peak over
  the sampled tracks' and releases' peaks;
- missing: sampled tracks or releases due in the window for which the
  program gave no answer or an error.

Each is held to its limit in the config's check.limits (missing to 0).
"""

from __future__ import annotations

import math

from reference import replaygain as rg

from . import library, registry


def sample(releases, config: dict, seed: int):
    """Releases drawn from the seed: one of every format first, then more
    until the sample holds config.check.sample_tracks tracks."""
    want = config["check"]["sample_tracks"]
    order = [releases[i] for i in library.rng_for(seed, 2).permutation(len(releases))]
    out, seen = [], set()
    for r in order:
        if r.format not in seen:
            out.append(r)
            seen.add(r.format)
    for r in order:
        if sum(len(x.tracks) for x in out) >= want:
            break
        if r not in out:
            out.append(r)
    return out


def reference_answers(rels, dtype=None, device: str = "cpu"):
    """{track path: (gain, peak)}, {release name: (album gain, album peak)}
    from each track's format's reference analyzer (float64 on the CPU
    unless `dtype` and `device` say otherwise)."""
    analyzers = {}
    tracks, albums = {}, {}
    for r in rels:
        hists, peaks = [], []
        for t in r.tracks:
            if t.module not in analyzers:
                fmt = registry.format_module(t.module)
                analyzers[t.module] = (fmt.analyzer() if dtype is None
                                       else fmt.analyzer(dtype, device))
            with open(t.path, "rb") as f:
                a = analyzers[t.module].track(f.read())
            tracks[t.path] = (a.gain, a.peak)
            hists.append(a.histogram)
            peaks.append(a.peak)
        albums[r.name] = rg.album(hists, peaks)
    return tracks, albums


def _rel(a, b):
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def compare(answers, ref_tracks, ref_albums, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every number compared: each answer the
    window owed (harness/driving.py) for a sampled track or release."""
    gap = {"track_gain_gap_db": 0.0, "album_gain_gap_db": 0.0, "peak_rel_gap": 0.0}
    missing = 0
    for a in answers:
        for kind, refs in (("track", ref_tracks), ("album", ref_albums)):
            for key, got in a.get(kind + "s", {}).items():
                if key not in refs:
                    continue
                if got is None or isinstance(got, Exception):
                    missing += 1
                    continue
                g, p = refs[key]
                gap[f"{kind}_gain_gap_db"] = max(gap[f"{kind}_gain_gap_db"], abs(got[0] - g))
                gap["peak_rel_gap"] = max(gap["peak_rel_gap"], _rel(got[1], p))
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in gap.items()}
    out["missing"] = {"value": missing, "limit": 0}
    return out


def passed(numbers: dict) -> bool:
    return all(v["limit"] is None or v["value"] <= v["limit"] for v in numbers.values())
