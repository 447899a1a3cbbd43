"""rescan: whole passes over the library, back to back, one at a time. A
pass is scan.scan_files(paths, manifest_path=<fresh>, device) over every
track, then scan.album_union for every release folder: `mp3rgain -r -R
--manifest new.json` with album gain. The last pass finishes. Records:
passes [{wall_s, audio_s}]."""

from __future__ import annotations

import os
import time

from harness.driving import Driver as Base
from harness.driving import analysed, answer
from harness.trace import span


class Driver(Base):
    def __init__(self, *a):
        super().__init__(*a)
        from mp3rgain_tpu_torch import scan

        self.scan = scan
        self.paths = sorted(t.path for r in self.releases for t in r.tracks)
        self.manifest = os.path.join(self.workdir, "manifest.json")
        self.audio_s = sum(t.seconds for r in self.releases for t in r.tracks)

    def _pass(self):
        for suffix in ("", ".journal", ".tmp"):
            if os.path.exists(self.manifest + suffix):
                os.remove(self.manifest + suffix)
        t0 = time.monotonic()
        with span("pass"):
            with span("scan_files"):
                res = self.scan.scan_files(self.paths, manifest_path=self.manifest,
                                           device=self.device)
            with span("album_union"):
                albums = {r.name: self.scan.album_union(res, [t.path for t in r.tracks])
                          for r in self.releases}
        return time.monotonic() - t0, res, albums

    def warm(self):
        self._pass()

    def run(self, seconds: float):
        passes, answers = [], []
        start = time.monotonic()
        while True:
            mark = self.mark()
            wall, res, albums = self._pass()
            self.collect(mark)
            passes.append({"wall_s": wall, "audio_s": self.audio_s})
            answers.append({
                "tracks": {p: answer(res.results.get(p)) for p in self.paths},
                "albums": {n: (g, float(pk)) for n, (_, g, pk) in albums.items()}})
            if time.monotonic() - start >= seconds:
                break
        n = len(passes)
        self.records.update(
            window_s=time.monotonic() - start, passes=passes,
            parts=[p["wall_s"] for p in passes], timings=self.timings, busy_ms=self.busy,
            attempted=n * len(self.paths),
            failed=sum(isinstance(v, Exception) for a in answers for v in a["tracks"].values()),
            analysed=analysed([t for r in self.releases for t in r.tracks] * n))
        return answers
