"""Build and bind the port's native host core (mp3rgain_tpu_torch/_native).

The torch port's copy of the JAX package's mp3rgain_tpu/native.py and
_native/build.py, cut to the entry points the port calls: the MP3
front-end (mp3dec.cpp: the full, light and packed light walks, the
entropy packer, the lane sort, the light-track packer) and the MP4 sniff
(mp4box.cpp). tests/test_torch_host_copies.py holds its outputs equal to
the JAX package's.

g++ builds the two sources into mp3rgain_tpu_torch/_build/ (gitignored)
on first use, never at import, and again when a source is newer than the
library. The build is atomic: it compiles to a temporary name under a
file lock and renames, so processes that race for the first build all
load a whole library. A failed build raises. Unlike the JAX package,
there is no environment opt-out of the malloc tuning: the port reads no
environment switches (device.py).

`_lib` is the loaded library (built on first attribute access);
`_inbuf` and `_u8p` are the ctypes helpers the callers pass buffers with.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "_native")
BUILD_DIR = os.path.join(_HERE, "_build")
SO_PATH = os.path.join(BUILD_DIR, "libmp3rgain_torch_host.so")

SOURCES = ["mp3dec.cpp", "mp4box.cpp"]
HEADERS = ["native.h", "huffman_tables.h"]

CXXFLAGS = [
    "-O3",
    "-std=c++17",
    "-fPIC",
    "-shared",
    "-Wall",
    "-Wextra",
    "-fno-exceptions",
    "-Wl,--no-undefined",
]

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _sources() -> list[str]:
    return [os.path.join(SRC_DIR, s) for s in SOURCES]


def is_stale() -> bool:
    if not os.path.exists(SO_PATH):
        return True
    built = os.path.getmtime(SO_PATH)
    deps = _sources() + [os.path.join(SRC_DIR, h) for h in HEADERS]
    return any(os.path.getmtime(p) > built for p in deps)


def build(force: bool = False) -> str:
    """Compile the host core into SO_PATH if stale (or forced); returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(SO_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not is_stale():
            return SO_PATH
        tmp = f"{SO_PATH}.{os.getpid()}.tmp"
        # The library builds on the host that runs it, so tuning for the
        # local ISA is safe; fall back to the portable baseline if the
        # toolchain rejects the flag.
        for arch in (["-march=native"], []):
            cmd = ["g++", *CXXFLAGS, *arch, "-o", tmp, *_sources()]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, SO_PATH)
                return SO_PATH
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed:\n$ {' '.join(cmd)}\n{proc.stderr}")


def _tune_malloc() -> None:
    """Keep large freed buffers in the heap instead of munmapping them.

    glibc mmaps allocations above ~128 KB and munmaps them on free, so
    every batch re-faults its multi-MB manifest buffers on hosts where a
    first touch is slow. Raising the mmap threshold and disabling trim
    measured 3.7 -> 1.7 ms/track on the JAX package's warm light walk.
    Trade-off: RSS stays at the high-water mark."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 256 << 20)
        libc.mallopt(M_TRIM_THRESHOLD, -1)
    except (OSError, AttributeError):  # non-glibc: nothing to tune
        pass


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    size, i64 = ctypes.c_size_t, ctypes.c_int64
    for name, restype, argtypes in (
        ("mg_mp3_unpack", i64, [_u8p, size, i32p, i32p, i32p, i64]),
        ("mg_mp3_unpack_light", i64, [_u8p, size, i32p, i32p, _u8p, i64, i32p, i64]),
        ("mg_mp3_count_gch", i64, [_u8p, size]),
        ("mg_mp3_unpack_light2", i64,
         [_u8p, size, u16p, _u8p, i32p, _u8p, i32p, _u8p, _u8p, i64, i32p, i64, i32p]),
        ("mg_entropy_pack4", None,
         [u64p, u64p, i64, i64, i32p, i64, i64, i64, i32p, i32p, i64, i64, i32p, u16p]),
        ("mg_sort_est_bits", None, [i32p, i64p, i64, i32p, i32p]),
        ("mg_pack_light_track", ctypes.c_int32,
         [i32p, i32p, i64, u16p, _u8p, i32p, _u8p, i32p, _u8p, i64, i64p, i64p]),
        ("mg_mp4_is_mp4", ctypes.c_int32, [_u8p, size]),
    ):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


class _Library:
    """The host core, built and loaded on first attribute access."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                _tune_malloc()
                lib = ctypes.CDLL(build())
                _declare(lib)
                self._lib = lib
            return self._lib

    def __getattr__(self, name: str):
        return getattr(self.load(), name)


_lib = _Library()


def _inbuf(data) -> _u8p:
    """Read-only view of bytes-like data as a ctypes uint8 pointer."""
    if isinstance(data, bytearray):
        return ctypes.cast((ctypes.c_uint8 * len(data)).from_buffer(data), _u8p)
    return ctypes.cast(ctypes.c_char_p(bytes(data)), _u8p)
