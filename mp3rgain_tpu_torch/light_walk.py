"""Build and bind the light MP3 walk into a main-data stream
(_host/light_walk.cpp), which frontend.unpack_data_light_stream calls.

Its two entry points, mg_light_stream_count and mg_light_stream_walk, are
the copied packed light walk (mg_mp3_unpack_light2) with each track's main
data written once into an exact-size stream and each row's Huffman window
given as a byte offset and a byte count in it, in place of a 528-byte row.
The source is the port's own and includes the copied parser
(_native/mp3dec.cpp) unchanged, so it builds into a library of its own
beside native.py's, with g++ on first use (never at import) and again when
it or the parser is newer than the library, under the same file lock.
Nothing here imports torch.

Build ahead of time (prints the library's path and the seconds spent):

    python -m mp3rgain_tpu_torch.light_walk [--force]
"""

from __future__ import annotations

import ctypes
import os
import sys
import time

from . import native

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_host", "light_walk.cpp")
SO_PATH = os.path.join(native.BUILD_DIR, "libmp3rgain_torch_walk.so")
DEPS = [SRC] + [os.path.join(native.SRC_DIR, f)
                for f in ("mp3dec.cpp", "native.h", "huffman_tables.h")]


def build(force: bool = False) -> str:
    """Compile the walk into SO_PATH if stale (or forced); returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    return native.compile_library(SO_PATH, [SRC], DEPS, force)


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.mg_light_stream_count.restype = i64
    lib.mg_light_stream_count.argtypes = [u8p, ctypes.c_size_t, i64p]
    lib.mg_light_stream_walk.restype = i64
    lib.mg_light_stream_walk.argtypes = [u8p, ctypes.c_size_t, u16p, u8p, i32p, u8p, i32p,
                                         u8p, i32p, u8p, i64, i64, i64p, u16p, i64, i32p]


_lib = native._Library(build, _declare)


if __name__ == "__main__":
    t0 = time.perf_counter()
    build(force="--force" in sys.argv[1:])
    print(f"{SO_PATH} {time.perf_counter() - t0:.2f} s")
