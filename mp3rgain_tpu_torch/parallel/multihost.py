"""Multi-process data parallelism for library scans, over torch.distributed.

Counterpart of mp3rgain_tpu/parallel/multihost.py, with the same public
names and the same environment. One process per host (or per group of
GPUs); the design keeps cross-process traffic minimal:

- Tracks are partitioned round-robin across processes (process_slice);
  file IO, host unpack and the whole device analysis stay process-local
  (parallel.runner over local_devices()). Nothing per-track ever crosses
  the network: tracks are independent until the album reduction.
- The only global communication is the album union: ONE all_reduce(SUM)
  of the (12000,) int64 histogram and one all_reduce(MAX) of the peak
  (album_union_global), plus a one-word all_reduce by which every process
  learns whether any process failed a file (any_failed_global).

The group is a gloo group over TCP, on the card too: the operand is 96 KB
and scan.album_union already holds it on the host, so nothing is gained by
reducing it on the device, and NCCL refuses two ranks on one GPU.

Usage (one process per host)::

    from mp3rgain_tpu_torch.parallel import multihost
    multihost.initialize("host0:8476", num_processes=4, process_id=rank)
    mine = multihost.process_slice(paths)
    ... analyze `mine` with scan/runner as usual ...
    hist, peak = multihost.album_union_global(local_hist, local_peak)

or set MP3RGAIN_COORDINATOR=host0:8476, MP3RGAIN_NUM_PROCESSES=4 and
MP3RGAIN_PROCESS_ID=<rank> and run the same mp3rgain-torch command on
every host. MP3RGAIN_GROUP_TIMEOUT_S (default 600) bounds the wait for the
other processes, at the rendezvous and in each collective.

Rank and world size come from initialize() or the environment; importing
this module, is_multihost() and process_slice() import no torch, so the
host-only byte-surgery commands stay cheap under a coordinator. The
torch.distributed group is formed when the first collective needs it.
Validated by parallel.dryrun.dryrun_multihost (an n-process group, the
union asserted bit-equal to a single-process analysis) and
tests/test_torch_multihost.py.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_TIMEOUT_S = 600.0

# (coordinator "host:port", number of processes, this process's rank,
# timeout in seconds) from initialize(); None: ask the environment.
_config: tuple[str, int, int, float] | None = None
_joined = False


def _env_timeout() -> float:
    return float(os.environ.get("MP3RGAIN_GROUP_TIMEOUT_S") or DEFAULT_TIMEOUT_S)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, timeout_s: float | None = None) -> None:
    """Name this process's place in a group of num_processes. Imports no
    torch: the torch.distributed group is joined at the first collective.
    A group of one process is no group."""
    global _config
    if _joined:
        return
    if not 0 <= process_id < max(num_processes, 1):
        raise ValueError(f"process_id {process_id} outside 0..{num_processes - 1}")
    _config = None
    if num_processes > 1:
        _config = (coordinator_address, int(num_processes), int(process_id),
                   float(timeout_s if timeout_s is not None else _env_timeout()))


def _group() -> tuple[str, int, int, float] | None:
    """The group this process belongs to: initialize()'s, else the
    environment's (all three variables set, more than one process)."""
    if _config is not None:
        return _config
    coord = os.environ.get("MP3RGAIN_COORDINATOR")
    nprocs = int(os.environ.get("MP3RGAIN_NUM_PROCESSES", "0") or 0)
    pid = os.environ.get("MP3RGAIN_PROCESS_ID")
    if coord and nprocs > 1 and pid is not None:
        initialize(coord, nprocs, int(pid))
    return _config


def is_multihost() -> bool:
    """True when this process is one of a group of more than one."""
    return _group() is not None


def maybe_initialize_from_env() -> bool:
    """Take this process's place in the group the MP3RGAIN_COORDINATOR /
    MP3RGAIN_NUM_PROCESSES / MP3RGAIN_PROCESS_ID environment names.
    Returns True when a group of more than one process is (now) active.

    Distributed CLI semantics: launch the same command on every host with
    a distinct MP3RGAIN_PROCESS_ID; each process analyzes and rewrites its
    round-robin slice of the file list and prints results for that slice;
    the album gain is reduced over the group (scan.album_union), so every
    process applies the identical steps. A process whose slice is empty
    still joins the union."""
    return is_multihost()


def process_index() -> int:
    g = _group()
    return g[2] if g else 0


def process_count() -> int:
    g = _group()
    return g[1] if g else 1


def process_slice(items: list) -> list:
    """This process's round-robin shard of a global work list.

    Round-robin (not contiguous blocks) so that length-sorted corpora
    spread long and short tracks evenly across processes."""
    return list(items[process_index()::process_count()])


def local_devices() -> list:
    """The torch.devices this process analyses on: every visible GPU, or
    the CPU where there is none (the per-track analysis never
    communicates across processes)."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def _join():
    """torch.distributed with this process in its gloo group. Raises a
    RuntimeError naming the coordinator when the group does not form
    within the timeout: a process that cannot reach its peers must not go
    on to a process-local album."""
    import atexit
    import datetime

    import torch.distributed as dist

    global _joined
    group = _group()
    if group is None:
        raise RuntimeError("not in a process group (see multihost.initialize)")
    if _joined:
        return dist
    coord, nprocs, rank, timeout_s = group
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}", world_size=nprocs, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"process {rank} of {nprocs} could not join its group at "
            f"{coord} within {timeout_s:.0f} s: {e}") from e
    _joined = True
    atexit.register(shutdown)
    return dist


def shutdown() -> None:
    """Leave the group (at interpreter exit, or by hand in tests)."""
    global _joined
    if _joined:
        import torch.distributed as dist

        _joined = False
        if dist.is_initialized():
            dist.destroy_process_group()


def _all_reduce(tensor, op_name: str):
    dist = _join()
    coord, nprocs, rank, timeout_s = _group()
    try:
        dist.all_reduce(tensor, op=getattr(dist.ReduceOp, op_name))
    except Exception as e:
        raise RuntimeError(
            f"process {rank} of {nprocs}: the all-reduce with the group at "
            f"{coord} failed (timeout {timeout_s:.0f} s): {e}") from e
    return tensor


def album_union_global(local_hist: np.ndarray, local_peak: float):
    """Cross-process album reduction.

    local_hist: (12000,) uint32/uint64/int64 histogram of this process's
    tracks (all zero for an empty slice); local_peak: max |PCM| over this
    process's tracks (0 for an empty slice). Returns (hist (12000,)
    np.uint64, peak float), identical on every process: one all_reduce
    (SUM) of the int64 histogram and one all_reduce(MAX) of the float64
    peak, over host tensors. A NaN peak loses to any other process's peak
    (NaN only when every process's is), as under the JAX package's pmax;
    gloo's MAX would keep or drop it by operand order, so it enters the
    all-reduce as -inf."""
    import torch

    hist = torch.from_numpy(np.ascontiguousarray(local_hist).astype(np.int64))
    peak = torch.tensor([-np.inf if np.isnan(local_peak) else float(local_peak)],
                        dtype=torch.float64)
    _all_reduce(hist, "SUM")
    _all_reduce(peak, "MAX")
    top = float(peak[0])
    return hist.numpy().astype(np.uint64), float("nan") if top == -np.inf else top


def any_failed_global(failed: bool) -> bool:
    """True on every process when any process passes True: how an album
    command learns of a file that failed on another process's slice, so
    that all processes refuse the album together."""
    import torch

    flag = torch.tensor([int(bool(failed))], dtype=torch.int64)
    return bool(_all_reduce(flag, "MAX")[0])
