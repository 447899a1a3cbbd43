"""release_ingest: one worker analyses the library's releases one at a
time, in the library's order and round after round, each through
replaygain.analyze_album(paths, device): an ingest queue's worker. The
window ends with a whole round of the library, so every window holds each
release equally often. Records: releases [{tracks, wall_s, batches}] (wall
NaN for a release that failed), rounds [{wall_s}]."""

from __future__ import annotations

import time

from harness.driving import Driver as Base
from harness.driving import analysed, answer
from harness.trace import span


class Driver(Base):
    def __init__(self, *a):
        super().__init__(*a)
        from mp3rgain_tpu_torch import replaygain

        self.rg = replaygain

    def _release(self, rel):
        paths = [t.path for t in rel.tracks]
        t0 = time.monotonic()
        with span("release"):
            with span("analyze_album"):
                res = self.rg.analyze_album(paths, device=self.device)
        return time.monotonic() - t0, res

    def warm(self):
        for rel in self.releases:
            self._release(rel)

    def run(self, seconds: float):
        done, answers, rounds, tracks = [], [], [], []
        failed = 0
        start = round_start = time.monotonic()
        while True:
            for rel in self.releases:
                mark = self.mark()
                before = len(self.timings)
                owed = {"tracks": {t.path: None for t in rel.tracks}, "albums": {rel.name: None}}
                try:
                    wall, res = self._release(rel)
                    owed["tracks"].update((t.path, answer(r)) for t, r in zip(rel.tracks, res.tracks))
                    owed["albums"][rel.name] = (res.album_gain_db, float(res.album_peak))
                except Exception as e:  # a failed release counts, and is no answer
                    wall = float("nan")
                    failed += 1
                    owed = {"tracks": dict.fromkeys(owed["tracks"], e), "albums": {rel.name: e}}
                self.collect(mark)
                answers.append(owed)
                tracks += rel.tracks
                done.append({"tracks": len(rel.tracks), "wall_s": wall,
                             "batches": len(self.timings) - before})
            now = time.monotonic()
            rounds.append({"wall_s": now - round_start})
            round_start = now
            if now - start >= seconds:
                break
        self.records.update(window_s=time.monotonic() - start, releases=done, rounds=rounds,
                            parts=[r["wall_s"] for r in rounds], timings=self.timings,
                            busy_ms=self.busy, attempted=len(done), failed=failed,
                            analysed=analysed(tracks))
        return answers
