"""Self-checks of the two data-parallel layers on tiny shapes.

Counterparts of the JAX package's dryrun_multichip and dryrun_multihost
(__graft_entry__.py) as package functions:

- dryrun_multichip(n): n Runners in one process (parallel.runner.
  RunnerGroup) run the host-decoded analysis core, the album reduce, the
  sharded raw-bits MP3 dispatch and the sharded AAC dispatch, each held
  equal to the single-Runner result.
- dryrun_multihost(n): n processes form a gloo group (parallel.multihost),
  each analyses its round-robin slice of a synthetic corpus, and every
  process holds the album union bit-equal to its own analysis of the whole
  corpus.

Both run on the CUDA card unless given device="cpu". With fewer GPUs than
Runners asked for, the GPUs are shared round-robin (two Runners on one
card share its compute stream and nothing else). Each raises on the first
check that fails; a child process that fails or outlives its time limit
makes dryrun_multihost raise, after every child has been stopped.

    python -c "from mp3rgain_tpu_torch.parallel import dryrun; dryrun.dryrun_multichip(2)"
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

CHILD_TIMEOUT_S = 600.0


def example_batch(batch: int, frames: int, seed: int = 0):
    """Synthetic host-decoded batch, analysis_core's argument tuple:
    `batch` stereo 44.1 kHz tracks of `frames` MPEG-1 frames."""
    from ..decode import frontend as fe

    rng = np.random.default_rng(seed)
    nch = 2
    g = frames * 2 * nch  # MPEG1: 2 granules per frame
    spec_i8 = rng.integers(-4, 5, size=(batch, g, 192)).astype(np.int8)
    esc_idx = np.full((batch, g, 4), 576, dtype=np.int16)
    esc_val = np.zeros((batch, g, 4), dtype=np.int16)
    scf = np.zeros((batch, g, 64), dtype=np.int8)
    info = np.zeros((batch, g, fe.INFO_N), dtype=np.int32)
    info[:, :, fe.GLOBAL_GAIN] = 160
    info[:, :, fe.SAMPLE_RATE] = 44100
    info[:, :, fe.VERSION] = 1
    info[:, :, fe.NCHANNELS] = nch
    info[:, :, fe.BIG_END] = 180
    info[:, :, fe.COUNT1_END] = 180
    info[:, :, fe.VALID] = 1
    valid = np.full((batch,), frames * 2 * 576, dtype=np.int32)
    return (spec_i8, esc_idx, esc_val, scf, info, valid)


def _check(cond, what: str) -> None:
    """Raise unless `cond` (an assert that python -O does not remove)."""
    if not cond:
        raise RuntimeError(f"dry run check failed: {what}")


def _rows(args: tuple, idxs) -> tuple:
    return tuple(np.ascontiguousarray(a[list(idxs)]) for a in args)


def _heavy(runner, args: tuple):
    """analysis_core over a prepared host-decoded batch, on `runner`."""
    from . import runner as pr

    return runner.collect(runner.launch(
        pr.Prepared("heavy", pr.analysis_core, pr.Runner.tail, 44100, 2, len(args[-1]),
                    args, (), {}, 0.0)))


def _devices(n: int, device) -> list[str]:
    """n device names for `device`: the CPU n times, or the visible GPUs
    in turn (every one of them distinct while there are enough)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """The data-parallel layer inside one process, over n_devices Runners."""
    from .. import aac
    from ..decode import aac_frontend as af
    from ..decode import frontend as fe
    from ..ops import histogram as hi
    from ..testing import craft, craft_aac
    from . import runner as pr

    group = pr.RunnerGroup(_devices(n_devices, device))
    _check(group.n_devices == n_devices, f"{group.n_devices} Runners for {n_devices}")
    single = group.runners[0]

    # The host-decoded core: each Runner takes every n-th track.
    batch = 2 * n_devices
    args = example_batch(batch=batch, frames=4)
    hist, loud, peak = _heavy(single, args)
    _check(hist.shape == (batch, hi.HISTOGRAM_SIZE) and loud.shape == (batch,)
           and peak.shape == (batch,), "heavy core shapes")
    for d, runner in enumerate(group.runners):
        idxs = range(d, batch, n_devices)
        h, l, p = _heavy(runner, _rows(args, idxs))
        _check(np.array_equal(h, hist[list(idxs)]) and np.array_equal(l, loud[list(idxs)]),
               f"heavy core on Runner {d} equals the single Runner's")

    # The album reduction over the same Runners.
    total_h, total_p = group.album_reduce_device(hist, np.abs(peak))
    _check(total_h.shape == (hi.HISTOGRAM_SIZE,)
           and np.array_equal(total_h, hist.sum(axis=0, dtype=np.int64))
           and total_p == float(np.abs(peak).max()), "album reduce equals the host sum")

    # The raw-bits path: one K1 + K2 launch per Runner, results equal to
    # the single dispatch.
    data = craft.craft_mixed_block_stream(6)
    ups = [fe.unpack_data_light(data) for _ in range(n_devices)]
    sr, nch = ups[0].sample_rate, ups[0].n_channels
    h1, l1, _ = single.analyze_unpacked_light(ups, sr, nch)
    hs, ls, _ = group.collect(group.dispatch_light_sharded(ups, sr, nch))
    _check(np.array_equal(h1, hs) and np.array_equal(l1, ls),
           "sharded light dispatch equals the single dispatch")

    # The AAC device-prep path, sharded the same way.
    adts = craft_aac.craft_sce_stream(
        4, global_gain=140,
        band_quads=[(1, 0, -1, 0), (0, 1, 0, 0), (-1, -1, 1, 0)],
    )
    uq = af.unpack_adts_q(adts)
    aac_ups = [uq] * n_devices
    asr, anch = uq.sample_rate, (uq.n_channels or 1)
    ha, la, pa = aac.analyze_batch_q(aac_ups, asr, anch, runner=single)
    hsd, lsd, psd = aac.analyze_batch_q_sharded(aac_ups, asr, anch, group=group)
    _check(np.array_equal(ha, hsd) and np.array_equal(la, lsd) and np.allclose(pa, psd),
           "sharded AAC dispatch equals the single dispatch")

    print(
        f"dryrun_multichip ok: {n_devices} Runners on "
        f"{sorted({str(d) for d in group.devices})}, batch {batch}, "
        f"album windows {int(total_h.sum())}, peak {total_p:.4f}, "
        f"sharded entropy decode ok, sharded AAC prep ok"
    )


def dryrun_multihost(n_processes: int = 2, *, device="cuda",
                     timeout_s: float = CHILD_TIMEOUT_S) -> None:
    """An n-process gloo group: each process analyses its round-robin
    shard of a synthetic corpus on its own Runner, then joins the album
    union (the histogram all-reduce and the peak all-reduce, the layer's
    only collectives) and asserts it bit-equal to its own analysis of the
    whole corpus."""
    from ..device import resolve_device

    resolve_device(device)  # no card: raise here, not in n children
    with socket.socket() as s:  # free TCP port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    for var in ("MP3RGAIN_COORDINATOR", "MP3RGAIN_NUM_PROCESSES", "MP3RGAIN_PROCESS_ID"):
        env.pop(var, None)
    code = ("from mp3rgain_tpu_torch.parallel import dryrun; "
            f"dryrun._multihost_child({int(n_processes)}, {{pid}}, {int(port)}, "
            f"{str(device)!r}, {float(timeout_s)!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(pid=pid)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(n_processes)]
    failed = []
    try:
        for pid, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                failed.append((pid, "timeout", err))
                continue
            sys.stdout.write(out)
            if p.returncode != 0:
                failed.append((pid, f"rc={p.returncode}", err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        for pid, why, err in failed:
            sys.stderr.write(f"--- process {pid} ({why}) stderr:\n{err}\n")
        raise RuntimeError(
            f"dryrun_multihost failed in {len(failed)}/{n_processes} processes: "
            + "; ".join(f"process {pid} {why}: {err.strip().splitlines()[-1:]}"
                        for pid, why, err in failed))


def _multihost_child(nprocs: int, pid: int, port: int, device: str,
                     timeout_s: float) -> None:
    """One process of the dryrun_multihost group."""
    import torch

    from . import multihost
    from . import runner as pr

    torch.set_num_threads(2)
    multihost.initialize(f"localhost:{port}", nprocs, pid, timeout_s=timeout_s)
    _check(multihost.is_multihost() and multihost.process_count() == nprocs,
           f"a group of {nprocs}")

    # Deterministic global corpus, identical in every process; each
    # track's granule tensors differ (seed varies per track).
    per_proc = 2
    n_tracks = nprocs * per_proc
    tracks = [example_batch(batch=1, frames=4, seed=100 + t) for t in range(n_tracks)]

    def analyse(idxs):
        args = tuple(np.concatenate([tracks[t][j] for t in idxs], axis=0)
                     for j in range(len(tracks[0])))
        hist, _, peak = _heavy(runner, args)
        return hist.sum(axis=0).astype(np.uint64), float(np.abs(peak).max())

    runner = pr.Runner(device)
    mine = multihost.process_slice(list(range(n_tracks)))
    _check(len(mine) == per_proc, f"slice of {len(mine)} tracks")
    local_hist, local_peak = analyse(mine)

    # The collectives under test.
    union_hist, union_peak = multihost.album_union_global(local_hist, local_peak)

    # Single-process oracle: this process analyses the FULL corpus, in
    # the batches the processes ran, and unions on the host.
    parts = [analyse(list(range(n_tracks))[r::nprocs]) for r in range(nprocs)]
    ref_hist = np.sum([h for h, _ in parts], axis=0, dtype=np.uint64)
    ref_peak = max(p for _, p in parts)

    _check(np.array_equal(union_hist, ref_hist),
           f"proc {pid}: the album histogram union != the single-process union "
           f"(diff bins: {int((union_hist != ref_hist).sum())})")
    _check(union_peak == ref_peak, f"proc {pid}: peak {union_peak} != {ref_peak}")
    _check(int(union_hist.sum()) > int(local_hist.sum()) > 0,
           f"proc {pid}: the union holds more than the local slice")
    print(
        f"dryrun_multihost ok: proc {pid}/{nprocs} on {runner.device}, "
        f"{len(mine)} tracks local, album union bit-equal over gloo "
        f"(windows {int(union_hist.sum())}, peak {union_peak:.4f})",
        flush=True,
    )
