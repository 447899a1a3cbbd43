"""What every driver of a timed window shares (drivers/<driver>.py, named by
a mix file): the program's Runner, whose records of the batches run in the
window it collects, and the shape of the answers it hands the check.

A driver is built as Driver(mix, releases, device, workdir, seed) after the
library is written; warm() runs the cell's shapes once in set-up; run(seconds)
drives the window and returns its answers; `records` holds what the metric
readers read (window_s, attempted, failed, timings, busy_ms, analysed, and
the driver's own lists), and "parts": the wall seconds of the window's
units (passes, rounds), printed by the harness.

The answers are a list of dicts, one per unit of work the window finished:
{"tracks": {path: answer}, "albums": {release name: answer}}, holding every
track and album that unit owed, where an answer is (gain dB, peak), or None
or an Exception where none came. The check compares each one owed for a
sampled release and counts the missing, whatever the driver.
"""

from __future__ import annotations


def since(seq, mark):
    """Entries of a deque appended after the entry `mark` (None: all)."""
    items = list(seq)
    if mark is None:
        return items
    for i in range(len(items) - 1, -1, -1):
        if items[i] is mark:
            return items[i + 1:]
    return items  # the mark has aged out: everything kept is new


def analysed(tracks) -> dict:
    """What the given tracks hold, summed by name, and their audio seconds."""
    out = {"audio_s": 0.0}
    for t in tracks:
        out["audio_s"] += t.seconds
        for k, v in t.counts.items():
            out[k] = out.get(k, 0) + v
    return out


def answer(result) -> tuple | Exception | None:
    """(gain dB, peak) of a program's track or album result."""
    if result is None or isinstance(result, Exception):
        return result
    return (result.gain_db, float(result.peak))


class Driver:
    def __init__(self, mix, releases, device, workdir, seed):
        from mp3rgain_tpu_torch.parallel import runner as pr

        self.mix = mix
        self.releases = releases
        self.device = device
        self.workdir = workdir
        self.seed = seed
        self.runner = pr.shared_runner(device)
        self.timings, self.busy = [], []
        self.records = {}

    def mark(self):
        t = self.runner.timings
        b = self.runner.busy_ms
        return (t[-1] if len(t) else None, b[-1] if len(b) else None)

    def collect(self, mark):
        """Keep the Runner's records added since `mark`."""
        self.timings += since(self.runner.timings, mark[0])
        self.busy += since(self.runner.busy_ms, mark[1])

    def warm(self):
        raise NotImplementedError

    def run(self, seconds: float) -> list:
        raise NotImplementedError
