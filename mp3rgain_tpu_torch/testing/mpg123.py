"""Golden-reference MP3 decoding via the system libmpg123 (ctypes).

Test oracle only: the port's own decode path is the native C++ front-end
plus the device back-end (mp3rgain_tpu_torch.decode). Gapless trimming is
disabled so the oracle's sample stream aligns 1:1 with raw frame decode
output.

A copy of the JAX package's mp3rgain_tpu/testing/mpg123.py whose library
is opened, declared and initialised on first use (_load), not at import;
decode_file is the original's. tests/test_torch_host_copies.py holds the
two to the same code and the same arrays.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .lazylib import LazyLibrary


def _load():
    _m = ctypes.CDLL("libmpg123.so.0")

    _m.mpg123_init.restype = ctypes.c_int
    _m.mpg123_new.restype = ctypes.c_void_p
    _m.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    _m.mpg123_param.restype = ctypes.c_int
    _m.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double]
    _m.mpg123_open.restype = ctypes.c_int
    _m.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _m.mpg123_getformat.restype = ctypes.c_int
    _m.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    _m.mpg123_read.restype = ctypes.c_int
    _m.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    _m.mpg123_close.restype = ctypes.c_int
    _m.mpg123_close.argtypes = [ctypes.c_void_p]
    _m.mpg123_delete.restype = None
    _m.mpg123_delete.argtypes = [ctypes.c_void_p]

    _m.mpg123_init()
    return _m


_m = LazyLibrary(_load)

# mpg123.h constants.
_MPG123_ADD_FLAGS = 2
_MPG123_REMOVE_FLAGS = 13
_FLAG_QUIET = 0x20
_FLAG_GAPLESS = 0x40
_FLAG_FORCE_FLOAT = 0x400
_MPG123_OK = 0
_MPG123_DONE = -12


def decode_file(path, gapless: bool = False) -> tuple[np.ndarray, int]:
    """Decode an MP3 file to float32 PCM.

    Returns (pcm, sample_rate) with pcm shaped (n_samples, channels),
    normalized to [-1, 1] (mpg123 float output convention).
    """
    err = ctypes.c_int()
    mh = _m.mpg123_new(None, ctypes.byref(err))
    if not mh:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        _m.mpg123_param(mh, _MPG123_ADD_FLAGS, _FLAG_FORCE_FLOAT | _FLAG_QUIET, 0.0)
        if not gapless:
            _m.mpg123_param(mh, _MPG123_REMOVE_FLAGS, _FLAG_GAPLESS, 0.0)
        if _m.mpg123_open(mh, str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123_open failed for {path}")
        rate = ctypes.c_long()
        channels = ctypes.c_int()
        encoding = ctypes.c_int()
        if _m.mpg123_getformat(mh, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)) != _MPG123_OK:
            raise RuntimeError("mpg123_getformat failed")

        chunks = []
        buf = (ctypes.c_ubyte * (1 << 18))()
        done = ctypes.c_size_t()
        while True:
            rc = _m.mpg123_read(mh, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK,):
                # tolerate new-format notifications and soft errors mid-stream
                if rc == -10 or rc > 0:  # MPG123_NEW_FORMAT is 1 in some vers
                    continue
                break
        raw = b"".join(chunks)
        pcm = np.frombuffer(raw, dtype=np.float32).reshape(-1, channels.value)
        return pcm.copy(), int(rate.value)
    finally:
        _m.mpg123_close(mh)
        _m.mpg123_delete(mh)
