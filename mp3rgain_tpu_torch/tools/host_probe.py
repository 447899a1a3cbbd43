"""Host side of a library scan: how the walk and the prep scale on threads.

    python -m mp3rgain_tpu_torch.tools.host_probe

Times, on the committed 60 s bench clip (no device work): the light walk
(the main path's, into the main-data stream) of 64 tracks on one thread
and of 256 tracks on walk pools of 4, 6 and 8 threads; the stream walk
beside the copied one (528-byte md rows) over the clip tiled to 30 min, on
1, 4, 6 and 8 threads, in turns, with the fresh host memory each walk
allocates; the 64-track batch prep of the main path
(runner.prepare_batch_arrays_light_compact: the lane plan and the rows in
walk order) beside the copied one (runner.prepare_batch_arrays_light, with
the host transpose) on one thread, and the main path's on 2, 3 and 4 at
once; a 256-track walk beside 4 preps on 2 threads; and how much of the
GIL the prep leaves free (the rate of a pure-Python loop in another thread
during prep, over its rate idle).
analyze_library's PREP_THREADS and walk-pool size rest on these numbers.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..decode import frontend as fe
from ..parallel import runner as pr
from ..testing import make_smoke_data as smoke
from ..testing import tile
from ..utils import bufpool

BATCH = 64
# Copies of the 60 s clip in the long track the two walks are timed on.
LONG_COPIES = 30
WALKS = {"stream": fe.unpack_data_light_stream, "copied": fe.unpack_data_light_packed}


def _fresh_mb(u) -> float:
    """MB of fresh host memory one walk allocates: every output buffer at
    its exact-count size (the sidebands before they are trimmed), the md
    rows or the main-data stream with its offsets and counts."""
    per_row = (fe.IP_N * 2 + fe.SCF_MAIN_BYTES + 4 + fe.SCF_SIDE_BYTES + 4 + fe.SCF_HI_BYTES
               + fe.LIGHT_META_N * 4)
    md = u.md.nbytes if isinstance(u.md, np.ndarray) else u.md.emitted_bytes
    return (u.n * per_row + md) / 1e6


def _long_walks(src: bytes) -> None:
    """The stream walk beside the copied one over the clip tiled to
    LONG_COPIES minutes, on 1, 4, 6 and 8 threads, 4 walks a thread, the
    two in turns: wall seconds and thread-seconds a walk."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "long.mp3")
        tile.tile_mp3(src, path, LONG_COPIES)
        with open(path, "rb") as f:
            data = f.read()
    for name, fn in WALKS.items():
        u = fn(data)
        print(f"{LONG_COPIES} min track, {name} walk: {u.n} rows, fresh "
              f"{_fresh_mb(u):.1f} MB a walk", flush=True)
    for n in (1, 4, 6, 8):
        for name, fn in WALKS.items():
            with ThreadPoolExecutor(n) as ex:
                t = time.perf_counter()
                list(ex.map(lambda _: fn(data), range(4 * n)))
                wall = time.perf_counter() - t
            print(f"{LONG_COPIES} min walk, {name}, {n} threads: wall {wall:.4f} s, "
                  f"{wall * n / (4 * n):.4f} thread-s a walk", flush=True)


def _gil_free_share(work) -> float:
    """Rate of a pure-Python counting loop while `work` runs, over its
    rate while the main thread sleeps."""
    def rate(body):
        stop, n = [False], [0]

        def spin():
            while not stop[0]:
                n[0] += 1

        th = threading.Thread(target=spin)
        th.start()
        t = time.perf_counter()
        body()
        dt = time.perf_counter() - t
        stop[0] = True
        th.join()
        return n[0] / dt

    return rate(work) / rate(lambda: time.sleep(0.3))


def main() -> None:
    with open(os.path.join(smoke.DATA_DIR, smoke.BENCH_TRACK), "rb") as f:
        data = f.read()

    def walk(_=None):
        return fe.unpack_data_light_stream(data)

    walk()  # builds the host libraries on first use
    fe.unpack_data_light_packed(data)
    t = time.perf_counter()
    ups = [walk() for _ in range(BATCH)]
    print(f"os.cpu_count() {os.cpu_count()}; walk {BATCH} x 60 s on 1 thread "
          f"{time.perf_counter() - t:.4f} s", flush=True)
    for n in (4, 6, 8):
        with ThreadPoolExecutor(n) as ex:
            t = time.perf_counter()
            list(ex.map(walk, range(4 * BATCH)))
            print(f"walk {4 * BATCH} on {n} threads {time.perf_counter() - t:.4f} s",
                  flush=True)
    _long_walks(data)
    copied_ups = [fe.unpack_data_light_packed(data) for _ in range(BATCH)]

    def prep(_=None) -> float:
        t = time.perf_counter()
        p, rest, _g = pr.prepare_batch_arrays_light_compact(ups, 2)
        dt = time.perf_counter() - t
        bufpool.give(*p.pooled, rest[1], rest[6])
        return dt

    def prep_copied() -> float:
        t = time.perf_counter()
        p, rest, _g = pr.prepare_batch_arrays_light(copied_ups, 2)
        dt = time.perf_counter() - t
        bufpool.give(p.buf, p.meta, rest[1], rest[6])
        return dt

    def fmt(ts):
        return ", ".join(f"{x:.4f}" for x in ts)

    # In turns, so that both see the same state of the host.
    times = {"compact": [], "copied": []}
    for _ in range(4):
        times["compact"].append(prep())
        times["copied"].append(prep_copied())
    print(f"prep of a {BATCH}-track batch on 1 thread: main path (lane plan) "
          f"{fmt(times['compact'])} s; copied (host transpose) {fmt(times['copied'])} s",
          flush=True)
    for n in (2, 3, 4):
        with ThreadPoolExecutor(n) as ex:
            t = time.perf_counter()
            each = list(ex.map(prep, range(2 * n)))
            print(f"{2 * n} preps on {n} threads: wall {time.perf_counter() - t:.4f} s "
                  f"(each {fmt(each)})", flush=True)
    for n in (8, 6):
        with ThreadPoolExecutor(n) as walkers, ThreadPoolExecutor(2) as preppers:
            t = time.perf_counter()
            walked = walkers.map(walk, range(4 * BATCH))
            each = list(preppers.map(prep, range(4)))
            list(walked)
            print(f"walk {4 * BATCH} on {n} threads beside 4 preps on 2 threads: wall "
                  f"{time.perf_counter() - t:.4f} s (preps {fmt(each)})", flush=True)
    share = _gil_free_share(lambda: [prep() for _ in range(4)])
    print(f"GIL during prep: a Python thread ran at {share:.3f} of its idle rate",
          flush=True)


if __name__ == "__main__":
    main()
