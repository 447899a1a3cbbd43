"""Build and bind the lane planner (_host/lane_plan.cpp), the host half of a
light MP3 batch's entropy input.

Its two entry points, mg_lane_plan and mg_lane_copy, serve
decode/entropy_kernel.prepare_batch_compact: the lane sort and the subgroup
extents of prepare_batch, and each row's used words copied in walk order,
from which the card's lane pack (K0, csrc/lane_pack.cu) builds the
lane-major buffer. The source is the port's own, not a copy of the JAX
package's, so it builds into a library of its own beside native.py's,
with g++ on first use (never at import) and again when it is newer than
the library, under the same file lock. Nothing here imports torch.

Build ahead of time (prints the library's path and the seconds spent):

    python -m mp3rgain_tpu_torch.lane_plan [--force]
"""

from __future__ import annotations

import ctypes
import os
import sys
import time

from . import native

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_host", "lane_plan.cpp")
SO_PATH = os.path.join(native.BUILD_DIR, "libmp3rgain_torch_lanes.so")


def build(force: bool = False) -> str:
    """Compile the planner into SO_PATH if stale (or forced); returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    return native.compile_library(SO_PATH, [SRC], [SRC], force)


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64 = ctypes.c_int64
    lib.mg_lane_plan.restype = i64
    lib.mg_lane_plan.argtypes = [u64p, i64p, i64p, i64, i32p, i64, i64, i64, i64,
                                 i32p, i32p, i32p, i32p, u16p, i64p]
    lib.mg_lane_copy.restype = None
    lib.mg_lane_copy.argtypes = [u64p, u64p, u64p, i64p, i64, i32p, u32p]


_lib = native._Library(build, _declare)


if __name__ == "__main__":
    t0 = time.perf_counter()
    build(force="--force" in sys.argv[1:])
    print(f"{SO_PATH} {time.perf_counter() - t0:.2f} s")
