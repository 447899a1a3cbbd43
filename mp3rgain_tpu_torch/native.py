"""Build and bind the port's native host core (mp3rgain_tpu_torch/_native).

The torch port's copy of the JAX package's mp3rgain_tpu/native.py and
_native/build.py, cut to the entry points the port calls: the MP3 gain
surgery core (bitstream.cpp) and the APEv2 tag engine (ape.cpp), which
bitstream.py and ape.py reach through the wrappers below (analyze,
apply_gain, read_gains, ape_parse, ...: the JAX package's, unchanged), the
MP3 front-end (mp3dec.cpp: the full, light and packed light walks, the
entropy packer, the lane sort, the light-track packer), the MP4 box
engine (mp4box.cpp: the sniff and the tag rewrite mp4meta.py calls) and
the AAC-LC front-end (aacdec.cpp: the f32, f16 and quantized ADTS
unpackers decode/aac_frontend.py calls).
tests/test_torch_host_copies.py holds its outputs equal to the JAX
package's. Nothing here imports torch.

g++ builds the five sources into mp3rgain_tpu_torch/_build/ (gitignored)
on first use, never at import, and again when a source is newer than the
library. The build is atomic: it compiles to a temporary name under a
file lock and renames, so processes that race for the first build all
load a whole library. A failed build raises. Unlike the JAX package,
there is no environment opt-out of the malloc tuning: the port reads no
environment switches (device.py).

`_lib` is the loaded library (built on first attribute access);
`_inbuf` and `_u8p` are the ctypes helpers the callers pass buffers with.

Build ahead of time (prints the library's path and the seconds spent):

    python -m mp3rgain_tpu_torch.native [--force]
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "_native")
BUILD_DIR = os.path.join(_HERE, "_build")
SO_PATH = os.path.join(BUILD_DIR, "libmp3rgain_torch_host.so")

SOURCES = ["bitstream.cpp", "ape.cpp", "mp3dec.cpp", "mp4box.cpp", "aacdec.cpp"]
HEADERS = ["native.h", "huffman_tables.h", "aac_tables.h"]

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


def _stale(so_path: str, deps: list[str]) -> bool:
    if not os.path.exists(so_path):
        return True
    built = os.path.getmtime(so_path)
    return any(os.path.getmtime(p) > built for p in deps)


def _deps() -> list[str]:
    return _sources() + [os.path.join(SRC_DIR, h) for h in HEADERS]


def compile_library(so_path: str, sources: list[str], deps: list[str],
                    force: bool = False) -> str:
    """Compile `sources` with g++ into so_path if it is older than one of
    `deps` (or missing, or forced); returns its path. Atomic under a file
    lock beside it. Raises RuntimeError with the compiler's output on
    failure."""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    with open(so_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not _stale(so_path, deps):
            return so_path
        tmp = f"{so_path}.{os.getpid()}.tmp"
        # The library builds on the host that runs it, so tuning for the
        # local ISA is safe; fall back to the portable baseline if the
        # toolchain rejects the flag.
        for arch in (["-march=native"], []):
            cmd = ["g++", *CXXFLAGS, *arch, "-o", tmp, *sources]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, so_path)
                return so_path
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed:\n$ {' '.join(cmd)}\n{proc.stderr}")


def build(force: bool = False) -> str:
    """Compile the host core into SO_PATH if stale (or forced); returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    return compile_library(SO_PATH, _sources(), _deps(), force)


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


class _MgAnalysis(ctypes.Structure):
    _fields_ = [
        ("frame_count", ctypes.c_int64),
        ("min_gain", ctypes.c_uint8),
        ("max_gain", ctypes.c_uint8),
        ("avg_gain", ctypes.c_double),
        ("mpeg_version", ctypes.c_int32),
        ("channel_mode", ctypes.c_int32),
    ]


def _declare(lib: ctypes.CDLL) -> None:
    i8p = ctypes.POINTER(ctypes.c_int8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    size, i64, u8 = ctypes.c_size_t, ctypes.c_int64, ctypes.c_uint8
    for name, restype, argtypes in (
        ("mg_analyze", ctypes.c_int32, [_u8p, size, ctypes.POINTER(_MgAnalysis)]),
        ("mg_apply_gain", i64, [_u8p, size, ctypes.c_int32, ctypes.c_int32]),
        ("mg_apply_gain_channel", i64, [_u8p, size, ctypes.c_int32, ctypes.c_int32]),
        ("mg_read_gains", i64, [_u8p, size, _u8p, i64]),
        ("mg_frame_index", i64, [_u8p, size, i64p, i64]),
        ("mg_find_audio_end", i64, [_u8p, size]),
        ("mg_read_bits8", u8, [_u8p, size, size, u8]),
        ("mg_write_bits8", None, [_u8p, size, size, u8, u8]),
        ("mg_ape_find_footer", i64, [_u8p, size]),
        ("mg_ape_parse", i64, [_u8p, size, _u8p, i64, i64p]),
        ("mg_ape_serialize", i64, [_u8p, size, i64, _u8p, i64]),
        ("mg_ape_remove_region", ctypes.c_int32, [_u8p, size, i64p, i64p]),
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
        ("mg_mp4_read_tags", i64, [_u8p, size, _u8p, i64]),
        ("mg_mp4_write_tags", i64, [_u8p, size, _u8p, size, _u8p, i64]),
        ("mg_aac_unpack_adts", i64,
         [_u8p, size, ctypes.POINTER(ctypes.c_float), i32p, i64]),
        ("mg_aac_unpack_adts_f16", i64, [_u8p, size, u16p, i8p, i32p, i64]),
        ("mg_aac_unpack_adts_q", i64,
         [_u8p, size, i8p, i16p, _u8p, _u8p, u16p, i8p, i64, i64p,
          i32p, i16p, i64, i64p, i32p, i64]),
    ):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


class _Library:
    """A host library, built (`build`) and loaded, its entry points
    declared (`declare`), on first attribute access."""

    def __init__(self, build, declare) -> None:
        self._build = build
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                _tune_malloc()
                lib = ctypes.CDLL(self._build())
                self._declare(lib)
                self._lib = lib
            return self._lib

    def __getattr__(self, name: str):
        return getattr(self.load(), name)


_lib = _Library(build, _declare)


def _inbuf(data) -> _u8p:
    """Read-only view of bytes-like data as a ctypes uint8 pointer."""
    if isinstance(data, bytearray):
        return ctypes.cast((ctypes.c_uint8 * len(data)).from_buffer(data), _u8p)
    return ctypes.cast(ctypes.c_char_p(bytes(data)), _u8p)


def _mutbuf(data: bytearray):
    return (ctypes.c_uint8 * len(data)).from_buffer(data)


@dataclass
class Analysis:
    frame_count: int
    min_gain: int
    max_gain: int
    avg_gain: float
    mpeg_version: int  # 1, 2, 25
    channel_mode: int  # 0 stereo, 1 joint, 2 dual, 3 mono


def analyze(data: bytes) -> Analysis | None:
    out = _MgAnalysis()
    rc = _lib.mg_analyze(_inbuf(data), len(data), ctypes.byref(out))
    if rc != 0:
        return None
    return Analysis(
        frame_count=out.frame_count,
        min_gain=out.min_gain,
        max_gain=out.max_gain,
        avg_gain=out.avg_gain,
        mpeg_version=out.mpeg_version,
        channel_mode=out.channel_mode,
    )


def apply_gain(data: bytearray, steps: int, wrap: bool = False) -> int:
    """Adjust every global_gain in place; returns modified frame count."""
    buf = _mutbuf(data)
    return _lib.mg_apply_gain(
        ctypes.cast(buf, _u8p), len(data), steps, 1 if wrap else 0
    )


def apply_gain_channel(data: bytearray, channel: int, steps: int) -> int:
    buf = _mutbuf(data)
    return _lib.mg_apply_gain_channel(ctypes.cast(buf, _u8p), len(data), channel, steps)


def read_gains(data: bytes) -> np.ndarray:
    cap = max(16, (len(data) // 24) * 4 + 64)
    out = np.empty(cap, dtype=np.uint8)
    n = _lib.mg_read_gains(
        _inbuf(data), len(data), out.ctypes.data_as(_u8p), cap
    )
    if n < 0:
        out = np.empty(-n, dtype=np.uint8)
        n = _lib.mg_read_gains(_inbuf(data), len(data), out.ctypes.data_as(_u8p), -n)
    return out[:n].copy()


def frame_index(data: bytes) -> np.ndarray:
    """(n_frames, 3) int64 array of [offset, frame_size, header_word]."""
    cap = max(16, len(data) // 24 + 64)
    out = np.empty((cap, 3), dtype=np.int64)
    n = _lib.mg_frame_index(
        _inbuf(data), len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap
    )
    if n < 0:
        out = np.empty((-n, 3), dtype=np.int64)
        n = _lib.mg_frame_index(
            _inbuf(data), len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), -n
        )
    return out[:n].copy()


def find_audio_end(data: bytes) -> int:
    return _lib.mg_find_audio_end(_inbuf(data), len(data))


def read_bits8(data: bytes, byte_offset: int, bit_offset: int) -> int:
    return _lib.mg_read_bits8(_inbuf(data), len(data), byte_offset, bit_offset)


def write_bits8(data: bytearray, byte_offset: int, bit_offset: int, value: int) -> None:
    buf = (ctypes.c_uint8 * len(data)).from_buffer(data)
    _lib.mg_write_bits8(ctypes.cast(buf, _u8p), len(data), byte_offset, bit_offset, value)


# ---------------------------------------------------------------------------
# APEv2
# ---------------------------------------------------------------------------


def ape_find_footer(data: bytes) -> int:
    """Footer offset or -1."""
    return _lib.mg_ape_find_footer(_inbuf(data), len(data))


def ape_parse(data: bytes) -> list[tuple[bytes, bytes]] | None:
    """Parse APEv2 tag at end of `data` into [(key, value), ...]."""
    cap = len(data) + 4096
    out = (ctypes.c_uint8 * cap)()
    count = ctypes.c_int64()
    n = _lib.mg_ape_parse(_inbuf(data), len(data), ctypes.cast(out, _u8p), cap, ctypes.byref(count))
    if n < 0:
        return None
    raw = bytes(out[:n])
    items = []
    pos = 0
    for _ in range(count.value):
        klen = int.from_bytes(raw[pos : pos + 4], "little")
        vlen = int.from_bytes(raw[pos + 4 : pos + 8], "little")
        pos += 8
        key = raw[pos : pos + klen]
        pos += klen
        value = raw[pos : pos + vlen]
        pos += vlen
        items.append((key, value))
    return items


def ape_serialize(items: list[tuple[bytes, bytes]]) -> bytes:
    """Serialize [(key, value), ...] to a full APEv2 tag (header+items+footer)."""
    if not items:
        return b""
    packed = bytearray()
    for key, value in items:
        packed += len(key).to_bytes(4, "little")
        packed += len(value).to_bytes(4, "little")
        packed += key
        packed += value
    cap = len(packed) + 64 + 9 * len(items) + 64
    out = (ctypes.c_uint8 * cap)()
    n = _lib.mg_ape_serialize(
        _inbuf(packed), len(packed), len(items), ctypes.cast(out, _u8p), cap
    )
    if n < 0:
        raise RuntimeError("ape_serialize: buffer too small")
    return bytes(out[:n])


def ape_remove_region(data: bytes) -> tuple[int, int] | None:
    """(audio_end, tail_start) for stripping the APE tag; None if no tag."""
    audio_end = ctypes.c_int64()
    tail = ctypes.c_int64()
    rc = _lib.mg_ape_remove_region(
        _inbuf(data), len(data), ctypes.byref(audio_end), ctypes.byref(tail)
    )
    if rc != 0:
        return None
    return audio_end.value, tail.value


if __name__ == "__main__":
    t0 = time.perf_counter()
    build(force="--force" in sys.argv[1:])
    print(f"{SO_PATH} {time.perf_counter() - t0:.2f} s")
