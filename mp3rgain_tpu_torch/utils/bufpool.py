"""The torch port's copy of mp3rgain_tpu/utils/bufpool.py, held equal to it
by tests/test_torch_host_copies.py.

Reusable numpy buffer pool for the host→device pack stages.

First-touch page faults on this class of VM run at ~8-24 MB/s (measured,
NOTES.md): any pipeline that allocates a fresh 100+ MB manifest per batch
while the previous batch's manifest is still alive (in flight to the
device) spends more time faulting pages than packing bits. Recycling the
arrays keeps the pages warm; in steady state a scan touches no new pages
at all.

Usage contract: `take()` may return a buffer with stale contents — every
caller must fully overwrite (or explicitly not read) what it uses;
`take_zeroed()` memsets for callers that rely on zero padding. Buffers
are handed back with `give()` once the device transfer has completed
(dispatch threads call it after device_put returns with the arrays
committed).
"""

from __future__ import annotations

import threading

import numpy as np

_MAX_PER_KEY = 4
_MAX_POOL_BYTES = 2 << 30  # drop buffers beyond ~2 GB of pooled memory

_pool: dict[tuple, list[np.ndarray]] = {}
_lock = threading.Lock()
_pool_bytes = 0


def _key(shape, dtype):
    return (tuple(int(s) for s in shape), np.dtype(dtype).str)


def take(shape, dtype) -> np.ndarray:
    """A writable array of the given shape/dtype; contents undefined."""
    global _pool_bytes
    key = _key(shape, dtype)
    with _lock:
        lst = _pool.get(key)
        if lst:
            a = lst.pop()
            _pool_bytes -= a.nbytes
            return a
    return np.empty(shape, dtype)


def take_zeroed(shape, dtype) -> np.ndarray:
    a = take(shape, dtype)
    a.fill(0)
    return a


def give(*arrays) -> None:
    """Return arrays obtained from take(); silently drops non-poolables."""
    global _pool_bytes
    with _lock:
        for a in arrays:
            if not isinstance(a, np.ndarray) or not a.flags.owndata:
                continue
            key = _key(a.shape, a.dtype)
            lst = _pool.setdefault(key, [])
            if len(lst) >= _MAX_PER_KEY or _pool_bytes + a.nbytes > _MAX_POOL_BYTES:
                continue
            lst.append(a)
            _pool_bytes += a.nbytes


def clear() -> None:
    global _pool_bytes
    with _lock:
        _pool.clear()
        _pool_bytes = 0
