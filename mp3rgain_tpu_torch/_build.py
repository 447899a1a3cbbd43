"""Build and bind the port's CUDA C++ kernels.

The sources under csrc/ compile with nvcc into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds, not minutes). Each source compiles in its own nvcc
process, all started together, and one more links the objects. The
library is built on first use into mp3rgain_tpu_torch/_build/ and
rebuilt when a source is newer than it. Nothing here runs at import
time.

Every C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises on a nonzero code. There is no
fallback: a failed build or launch raises.

Build ahead of time (prints the library's path and the seconds spent):

    python -m mp3rgain_tpu_torch._build [--force]
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import sys
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libmp3rgain_torch_kernels.so")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc/ptxas output of the last build in this process


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin)")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build(force: bool = False) -> float:
    """Compile csrc/*.cu into LIB_PATH if stale; returns the seconds spent
    (0.0 when the library was current). Raises on a compiler error."""
    global build_log
    if not force and not _stale():
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.monotonic()
    jobs = []
    for src in sources():
        stem = os.path.join(BUILD_DIR, os.path.basename(src)[:-3])
        obj, log = f"{stem}.{tag}.o", f"{stem}.{tag}.log"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
        with open(log, "w") as out:
            proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
        jobs.append((cmd, proc, obj, log))
    logs, failed = [], []
    for cmd, proc, _obj, log in jobs:
        rc = proc.wait()
        with open(log) as f:
            logs.append(f.read())
        os.remove(log)
        if rc != 0:
            failed.append(f"rc {rc}: {' '.join(cmd)}")
    build_log = "".join(logs)
    objs = [obj for _cmd, _proc, obj, _log in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed) + "\n" + build_log)
        tmp = f"{LIB_PATH}.{tag}"
        cmd = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (rc {proc.returncode}):\n{' '.join(cmd)}\n{build_log}"
            )
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)
    return time.monotonic() - t0


def _declare(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    i = ctypes.c_int
    lib.mg_cuda_entropy_decode_rows.restype = ctypes.c_int
    lib.mg_cuda_entropy_decode_rows.argtypes = [
        vp, i, vp, vp, vp, i, i, vp, i, i, vp, vp, vp, vp, i, vp,
    ]
    lib.mg_cuda_requant_stereo.restype = ctypes.c_int
    lib.mg_cuda_requant_stereo.argtypes = [vp, vp, vp, vp, vp, vp, i, i, vp]
    lib.mg_cuda_class_core_gemm.restype = ctypes.c_int
    lib.mg_cuda_class_core_gemm.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.mg_cuda_class_core_gemm_smem_bytes.restype = ctypes.c_int
    lib.mg_cuda_class_core_gemm_smem_bytes.argtypes = []
    lib.mg_cuda_hybrid_synthesis.restype = ctypes.c_int
    lib.mg_cuda_hybrid_synthesis.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, vp]
    lib.mg_cuda_overlap_polyphase.restype = ctypes.c_int
    lib.mg_cuda_overlap_polyphase.argtypes = [vp, vp, vp, vp, i, i, vp]
    lib.mg_cuda_lane_pack.restype = ctypes.c_int
    lib.mg_cuda_lane_pack.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, i, vp, vp, vp]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            _declare(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


if __name__ == "__main__":
    spent = build(force="--force" in sys.argv[1:])
    print(f"{LIB_PATH} {spent:.2f} s")
