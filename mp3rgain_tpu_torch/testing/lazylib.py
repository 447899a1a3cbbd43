"""A ctypes library loaded on first use instead of at import.

The codec oracles (mpg123.py, avcodec.py, fixtures.py) bind the system
libmpg123, libavcodec and libmp3lame. The machine that runs the port on
the GPU may have none of them, and importing the port must not need
them, so each module-level library name is a LazyLibrary: the first
attribute access runs its loader (open the library, declare the
signatures) once, under a lock, and later accesses go straight to the
loaded library. The functions that call the library are the JAX
package's, unchanged.
"""

from __future__ import annotations

import threading


class LazyLibrary:
    """Stands for the ctypes library that `load()` returns."""

    def __init__(self, load) -> None:
        self._load = load
        self._lock = threading.Lock()
        self._lib = None

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def library(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def __getattr__(self, name: str):
        return getattr(self.library(), name)
