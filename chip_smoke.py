#!/usr/bin/env python3
"""Drive the torch port's ReplayGain main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's host libraries (g++, mp3rgain_tpu_torch/_native and the
lane planner _host/lane_plan.cpp) and the six hand-written CUDA C++ kernels
from the sources in this checkout with nvcc, one process per source, all
started together with the g++ build: the lane pack K0 (csrc/lane_pack.cu,
which builds K1's lane-major input from rows copied in walk order), the
Huffman decode K1 (csrc/entropy_decode.cu, which writes each spectrum
straight into the row its consumer reads), the requantize + stereo pass
K2 (csrc/requant_stereo.cu), the split-bf16 class-core GEMM K3
(csrc/class_core_gemm.cu), the hybrid synthesis K4
(csrc/hybrid_synthesis.cu) and the overlap-add + polyphase synthesis K5
(csrc/overlap_polyphase.cu). Holds each against its plain PyTorch version
on the card and times it beside its bound (K3 beside one cuBLAS call
computing the same product, K4 and K5 beside the dense torch.matmul
products of their plain versions and K0 beside one indexing call doing its
gather, at a 640,000-row batch; the port never calls those on the card),
then sends
hostile input through them (seeded byte flips, truncations and splices of
the committed clips and crafted streams, and an AAC stream whose noise
energies overflow float32: K1, K2 and K3 against their plain versions on
the mutated batches, the light, host-decoded and AAC routes against the
CPU, scan_files with the mutated files among the library's), so that every
later phase runs after them in the same process; then runs the
port's two routes over 64 copies of a 60 s, 44.1 kHz joint-stereo
192 kbps track, the JAX package's bench batch: the light main path
(Runner.analyze_unpacked_light, K0, K1, K2, K4, K5) and the host-decoded route
(Runner.analyze_unpacked, K3), each with the launch counts set to 0 just
before it and read just after; the light device phase split by stage
(CUDA events, median of 3); then the unfused light tail against the
host-decoded route (exact), decode_file and the analysis entry points on
committed clips; then the AAC/M4A path (no TPU kernel lies on it, so no
kernel of this port does: torch ops, GEMMs on cuBLAS in full f32): 64
copies of a 60 s, 44.1 kHz stereo 192 kbps M4A, the JAX bench's AAC track,
through the device-prep ("q") route of the same Runner, held against the
host-requant ("f16") route on the card and against the port's CPU run,
its device phase split by stage, the short clips that reach EIGHT_SHORT,
PNS, fallback and intensity rows, and the entry points on them; then the
library scan, this port's main path for a library: scan.scan_files over
706 files (384 copies of the MP3 bench track, 64 of a 3 s transient clip,
64 of a 3 s 22.05 kHz mono clip, one file of seeded random bytes, one
zero-payload ADTS file, 128 copies of the 60 s M4A and 64 of a 3 s
transient M4A) on the pipelined Runner, every copy held to its
single-track result, the K0/K1/K2/K4/K5 launches counted per MP3 device batch, the
resume from its manifest, and cli.main -a over 160 of the files; then
cli.main -r and -x over 15 files, the per-track path, on the shared
Runner and with a new Runner per file; then the data-parallel layer on the
one card: analyze_library over a 352-file library dealt across two Runners
against one Runner (every track exactly equal, scans in turns), one batch
split over the two Runners against the single dispatch, dryrun_multichip(2)
and dryrun_multihost(2); the CLI's album path as two and three real
processes under the MP3RGAIN_* environment (a gloo group over localhost)
against one process, an empty slice, byte surgery on a slice;
gui.AppState(device="cuda") against the CLI; and last the oracle phase,
which holds the card to references that share no arithmetic with it:
every committed MP3 on the light and the host-decoded route and every
committed M4A and ADTS track on the q route within 0.05 dB of the float64
reference gain (testing/reference.py) of its PCM decoded on the CPU, peaks
within rtol 2e-4; decode_file on the card against the CPU; the byte-surgery
scale oracle (s more gain steps decode to the PCM times 2^(s/4)); the peak
contract through the CLI on a clip whose peak exceeds 1.0; and entry();
then the real_library phase, the input a real library holds against the
same float64 reference: every MPEG class and every AAC rate tiled past the
IIR's dense level-2 limit (so the doubling scan runs) on each of its
routes, the 88.2 kHz degenerate rate on both sides, 4 min / 20 min / 2 h
tracks through analyze_track_internal and scan_files (the 2 h MP3 over the
rows cap, in segments; the long ones held segment by segment), and a scan
of 48 distinct real-length files with two 2 h tracks among them,
every track equal to its single-track run (testing/tile.py makes the long
streams from the committed clips on this host).
Every check raises on failure; there is no CPU branch.
Output, one phase per line:

  device / nvidia-smi name and power limit / build seconds and K0-K5
  registers, shared memory and spills / K0 to K5 agreement, times
  and bounds / hostile input: MP3 raw-bits, MP3 host-decoded, AAC q
  route, scan / light slice launch counts, CPU agreement / light stage
  split / heavy slice launch counts, CPU and light agreement, light
  unfused == heavy / decode_file / entry-point gains / AAC clips, slice,
  routes, stages and entry points / library scan / per-track CLI walls /
  multi_runner / multihost / gui / oracle: one line per clip and route,
  decode_file, byte surgery, peak contract, entry(), the phase's wall /
  real_library: one line per rate-matrix track and route, one per ladder
  track, the library line, the phase's wall and launches / times / a
  JSON line of per-kernel results (K0/K1/K2/K4/K5 launches from the library scan,
  and each kernel's launches in the real_library phase) /
  last line {"ok": true, "device": {"platform": "gpu", ...}}.

Imports nothing of JAX and nothing of the JAX package. Exits non-zero
without a result line when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import threading
import time

K2_RTOL = 1e-5
K2_ATOL_REL = 1e-6  # atol = K2_ATOL_REL * max|plain|
# K3: bf16 products are exact in f32 on both sides; only the summation
# order differs.
K3_RTOL = 1e-5
K3_ATOL_REL = 1e-5  # atol = K3_ATOL_REL * max|plain|
BATCH_TRACKS = 64
PROBE_ROWS = 294_912  # the TPU probe's R, per channel
# Published H100 SXM peaks (NVIDIA's data sheet, dense) for bound_ms: the
# least time for a kernel's work is the larger of its bytes (each input
# read once, each output written once) over the HBM rate and its
# operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12  # FFMA outside the tensor cores (K4, K5)
SYNTH_ROWS = 640_000  # K4 and K5 at the library scan's rows cap: 2 x 128 x 2,500


class Launches:
    """One kernel's counts in the tracing record (the script runs inside
    tracing.recording(), where the counters count): `kernel` launches of
    the hand-written kernel and `plain` calls of its plain version, since
    the last reset()."""

    def __init__(self, name: str):
        self.name = name
        self._base = (0, 0)

    def _now(self) -> tuple[int, int]:
        from mp3rgain_tpu_torch import tracing

        return (tracing.counter("launches." + self.name),
                tracing.counter("plain." + self.name))

    @property
    def kernel(self) -> int:
        return self._now()[0] - self._base[0]

    @property
    def plain(self) -> int:
        return self._now()[1] - self._base[1]

    def reset(self) -> None:
        self._base = self._now()


K0 = Launches("lane_pack")
K1 = Launches("entropy_decode_rows")
K2 = Launches("requant_stereo")
K3 = Launches("class_core_gemm")
K4 = Launches("hybrid_synthesis")
K5 = Launches("overlap_polyphase")
KERNELS = (K0, K1, K2, K3, K4, K5)
LIGHT = (K0, K1, K2, K4, K5)  # the kernels of every MP3 light batch a Runner runs


def plain_calls() -> int:
    """Plain-version calls of every kernel since its last reset."""
    return sum(c.plain for c in KERNELS)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_of(n_bytes: float, flops: float = 0.0,
             flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    """(bound_ms, bound_by) for n_bytes of traffic and flops at flops_per_s
    (bf16 MMA unless given)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

LIBRARY_SEED = 5
LIBRARY_COPIES = {"bench": 384, "transient": 64, "mono": 64}
AAC_LIBRARY_COPIES = {"aacbench": 128, "aactransient": 64}


def _adts_stream(frames: int = 3, payload: int = 200) -> bytes:
    """ADTS frames (AAC-LC, 44.1 kHz, stereo headers, zero payloads): a file
    the scan must route to the AAC path, which decodes it as the JAX
    package does: three silent frames."""
    n = 7 + payload
    head = bytes([0xFF, 0xF1, 0x50, 0x80 | ((n >> 11) & 3), (n >> 3) & 0xFF,
                  ((n & 7) << 5) | 0x1F, 0xFC])
    return (head + bytes(payload)) * frames


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _library_files(root, clips, aac_clips):
    """The library phase's 706 files in `root`: symlinks to the committed
    clips (LIBRARY_COPIES, then AAC_LIBRARY_COPIES), a file of seeded
    random bytes and a zero-payload ADTS file. Returns (every path, the
    MP3-side paths, the random bytes' path, the ADTS file's path)."""
    import numpy as np

    bench_path, mono_path, transient_path = clips
    paths = []
    for kind, src in (("bench", bench_path), ("transient", transient_path),
                      ("mono", mono_path)):
        for i in range(LIBRARY_COPIES[kind]):
            paths.append(os.path.join(root, f"{kind}_{i:03d}.mp3"))
            os.symlink(src, paths[-1])
    noise = os.path.join(root, "noise.mp3")
    with open(noise, "wb") as f:
        f.write(np.random.default_rng(LIBRARY_SEED).integers(
            0, 256, 1 << 16, dtype=np.uint8).tobytes())
    adts = os.path.join(root, "stream.aac")
    with open(adts, "wb") as f:
        f.write(_adts_stream())
    paths += [noise, adts]
    mp3_paths = list(paths)
    for kind, src in zip(AAC_LIBRARY_COPIES, aac_clips):
        for i in range(AAC_LIBRARY_COPIES[kind]):
            paths.append(os.path.join(root, f"{kind}_{i:03d}.m4a"))
            os.symlink(src, paths[-1])
    return paths, mp3_paths, noise, adts


def library_phase(dev, card, bench_u, bench_loud, bench_peak, bench_windows, clips,
                  aac_clips):
    """scan_files over a 706-file library on the card (384 copies of the
    MP3 bench track, 64 of the 3 s transient clip, 64 of the 3 s 22.05 kHz
    mono clip, 128 of the 60 s M4A and 64 of the 3 s transient M4A, as
    symlinks; a file of seeded random bytes; a zero-payload ADTS file), its
    resume from the manifest, and cli.main -a over 160 of the files.
    Returns the scan's K1/K2/K4/K5 launch counts."""
    import contextlib
    import io
    import shutil
    import statistics
    import tempfile
    import warnings

    import numpy as np
    import torch

    from mp3rgain_tpu_torch import aac, analysis, cli, scan
    from mp3rgain_tpu_torch.decode import aac_frontend as af
    from mp3rgain_tpu_torch.decode import class_core as cc
    from mp3rgain_tpu_torch.decode import entropy_kernel as ek
    from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
    from mp3rgain_tpu_torch.ops import histogram as hi
    from mp3rgain_tpu_torch.parallel import runner as pr

    bench_path, mono_path, transient_path = clips
    root = tempfile.mkdtemp(prefix="mp3rgain-library-")
    try:
        paths, mp3_paths, noise, adts = _library_files(root, clips, aac_clips)
        aac_seconds = 3 * 1024 / 44100  # the ADTS file's three silent frames
        for kind, src in zip(AAC_LIBRARY_COPIES, aac_clips):
            aac_seconds += AAC_LIBRARY_COPIES[kind] * aac.audio_seconds(af.unpack_file_q(src))
        manifest = os.path.join(root, "scan.json")

        runner = pr.Runner(dev)
        t0 = time.perf_counter()
        for fmt in ((44100, 2), (22050, 1)):
            runner.tail(*fmt)
        runner.aac_tail(44100, 2)
        torch.cuda.synchronize()
        tails_s = time.perf_counter() - t0
        first_done = {}  # file type -> when the scan reported its first file

        def progress(path):
            first_done.setdefault(os.path.splitext(path)[1], time.perf_counter())

        torch.cuda.reset_peak_memory_stats()
        for c in KERNELS:
            c.reset()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                res = scan.scan_files(paths, manifest_path=manifest, runner=runner,
                                      progress_cb=progress)
                wall = time.perf_counter() - t0
                mp3_wall = first_done[".mp3"] - t0  # the MP3s are scanned first
                n_scan = len(caught)
                # A control: one deliberate sync on another thread is seen.
                ctl = threading.Thread(target=lambda: torch.zeros(1, device=dev).item())
                ctl.start()
                ctl.join()
                control_seen = len(caught) > n_scan
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = {c.name: c.kernel for c in LIGHT}
        plain = plain_calls()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        timings = list(runner.timings)
        busy = list(runner.busy_ms)
        syncs: dict[str, int] = {}
        for w in caught[:n_scan]:
            where = f"{os.path.basename(w.filename)}:{w.lineno}"
            syncs[where] = syncs.get(where, 0) + 1

        # Outcomes: 512 MP3 tracks and 192 AAC ones; the random bytes fail
        # alone; the zero-payload ADTS file is three silent AAC frames, as
        # in the JAX package: an empty histogram, loudness -20 dB, peak 0.
        n_mp3 = sum(LIBRARY_COPIES.values())
        n_aac = sum(AAC_LIBRARY_COPIES.values())
        n_tracks = n_mp3 + n_aac
        ok = [p for p in paths if p != adts and not isinstance(res.results[p], Exception)]
        check(len(ok) == n_tracks and len(res.results) == len(paths),
              f"{len(ok)} of {n_tracks} tracks ok")
        err_noise, silent = res.results[noise], res.results[adts]
        check(isinstance(err_noise, RuntimeError) and "No valid MP3 frames" in str(err_noise),
              f"random bytes fail as no MP3 ({err_noise!r})")
        check(not isinstance(silent, Exception)
              and (silent.file_type, silent.loudness_db, silent.peak, silent.sample_rate)
              == ("aac", -20.0, 0.0, 44100) and not res.histograms[adts].any(),
              f"the zero-payload ADTS file analyses as silent AAC ({silent!r})")
        check(all(res.results[p].file_type == ("aac" if p.endswith(".m4a") else "mp3")
                  for p in ok), "file types")
        n_batches = len(timings)
        mp3_batches = sum(t["route"] == "light" for t in timings)
        aac_batches = sum(t["route"] == "aac_q" for t in timings)
        check(mp3_batches + aac_batches == n_batches
              and aac_batches >= -(-(n_aac + 1) // (4 * scan.BATCH_THRESHOLD)),
              f"routes of the {n_batches} batches: {[t['route'] for t in timings]}")
        check(all(v == mp3_batches for v in launches.values()),
              f"K0, K1, K2, K4 and K5 launched once per MP3 device batch ({launches}, "
              f"{mp3_batches})")
        check(plain == 0, f"no plain-version calls on CUDA ({plain})")

        # Every copy against its reference.
        bench_idx = round(bench_loud * 100) + 2000
        refs = {"bench": (bench_windows, bench_idx, bench_peak)}
        for kind, clip in (("transient", transient_path), ("mono", mono_path),
                           *zip(AAC_LIBRARY_COPIES, aac_clips)):
            r = analysis.analyze_track_internal(clip, device=dev)
            refs[kind] = (int(r.histogram.sum()), round(r.result.loudness_db * 100) + 2000,
                          r.result.peak)
        worst = {"index": 0, "peak_rel": 0.0}
        for p in ok:
            windows, idx, peak = refs[os.path.basename(p).split("_")[0]]
            got = res.results[p]
            g_idx = round(got.loudness_db * 100) + 2000
            check(int(res.histograms[p].sum()) == windows, f"{p} window count")
            check(abs(g_idx - idx) <= 2, f"{p} index {g_idx} vs {idx}")
            check(bool(np.isclose(got.peak, peak, rtol=2e-4, atol=1e-6)),
                  f"{p} peak {got.peak} vs {peak}")
            worst["index"] = max(worst["index"], abs(g_idx - idx))
            worst["peak_rel"] = max(worst["peak_rel"], abs(got.peak / peak - 1))
        loud, gain, apeak = scan.album_union(res, paths)
        total = sum(res.histograms[p].astype(np.uint64) for p in ok)
        want = hi.loudness_from_histogram(total)
        check(loud == want and apeak == max(res.results[p].peak for p in ok),
              f"album_union equals the host sum ({loud} vs {want})")

        # The same scan again resumes every track from the manifest.
        n_before = len(runner.timings)
        k1_before = K1.kernel
        again = scan.scan_files(paths, manifest_path=manifest, runner=runner)
        check(again.resumed == n_tracks + 1,
              f"resumed {again.resumed} of {n_tracks + 1}, AAC records included")
        check(len(runner.timings) == n_before and K1.kernel == k1_before,
              "no device batch on resume")
        for p in ok:
            a, b = res.results[p], again.results[p]
            check((a.loudness_db, a.gain_db, a.peak, a.sample_rate) ==
                  (b.loudness_db, b.gain_db, b.peak, b.sample_rate)
                  and np.array_equal(res.histograms[p], again.histograms[p]),
                  f"{p} resumes identical")

        # The prep pool against one prep thread (the uploader alone keeping
        # pace), scans of the same files in turns.
        default = pr.PREP_THREADS
        turns: dict[int, list[float]] = {1: [], default: []}
        try:
            for n in (1, default, default, 1):
                pr.PREP_THREADS = n
                t0 = time.perf_counter()
                pr.analyze_library(mp3_paths, runner=runner)
                turns[n].append(time.perf_counter() - t0)
        finally:
            pr.PREP_THREADS = default

        # The CLI's album path over 160 of the files, in this process.
        by_kind = {k: [p for p in ok if os.path.basename(p).startswith(k + "_")]
                   for k in (*LIBRARY_COPIES, *AAC_LIBRARY_COPIES)}
        album_files = (by_kind["bench"][:64] + by_kind["transient"][:32]
                       + by_kind["mono"][:32] + by_kind["aacbench"][:16]
                       + by_kind["aactransient"][:16])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-a", "--dry-run", "--batch", "-o", "json", "--manifest",
                           os.path.join(root, "cli.json"), *album_files])
        check(rc == 0, f"cli -a exit code {rc}")
        doc = json.loads(out.getvalue())
        _, want_gain, _ = scan.album_union(res, album_files)
        check(len(doc["files"]) == len(album_files)
              and abs(doc["album"]["gain_db"] - want_gain) <= 0.02,
              f"cli album gain {doc['album']['gain_db']} vs album_union {want_gain}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    audio_h = res.audio_seconds / 3600.0
    aac_h = aac_seconds / 3600.0
    mp3_h = audio_h - aac_h
    aac_wall = wall - mp3_wall

    def medians(route):
        return {k: statistics.median(t[k] for t in timings if t["route"] == route)
                for k in ("prep_s", "h2d_s", "device_ms")}

    med, med_aac = medians("light"), medians("aac_q")
    serial = sum(t["prep_s"] + t["h2d_s"] + t["device_ms"] / 1e3 for t in timings)
    busy_share = _union_ms(busy) / (wall * 1e3)
    findings = ("none" if not syncs else
                "; ".join(f"{k} x{v}" for k, v in sorted(syncs.items())))
    print(f"library {card}: scan_files over {len(paths)} files ({n_mp3} MP3 and {n_aac} "
          f"AAC tracks, the random bytes failed and the zero-payload ADTS file was silent "
          f"as expected), {n_batches} device batches, {audio_h:.3f} audio-hours "
          f"in {wall:.3f} s: real-time factor {res.audio_seconds / wall:.0f}x, "
          f"{audio_h / wall:.3f} audio-hours/s; MP3 part: {mp3_h:.3f} audio-hours in "
          f"{mp3_wall:.3f} s ({mp3_h * 3600 / mp3_wall:.0f}x, {mp3_h / mp3_wall:.3f} "
          f"audio-hours/s), {mp3_batches} batches, per batch (median) prep "
          f"{med['prep_s']:.4f} s, staging and upload {med['h2d_s']:.4f} s, device "
          f"{med['device_ms']:.3f} ms; AAC part: {aac_h:.3f} audio-hours in {aac_wall:.3f} s "
          f"({aac_h * 3600 / aac_wall:.0f}x, {aac_h / aac_wall:.3f} audio-hours/s), "
          f"{aac_batches} batches, per batch (median) prep {med_aac['prep_s']:.4f} s, "
          f"staging and upload {med_aac['h2d_s']:.4f} s, device "
          f"{med_aac['device_ms']:.3f} ms; device busy {busy_share:.1%} of the wall; serial "
          f"sum of prep + upload + device {serial:.3f} s vs wall {wall:.3f} s "
          f"(overlap {serial / wall:.2f}x); peak device memory {peak_gb:.3f} GB; "
          f"os.cpu_count() {os.cpu_count()}; LightTails and the AacTail built before in "
          f"{tails_s:.3f} s; "
          f"sync-debug findings during the scan: {findings} (a deliberate .item() on "
          f"another thread {'was' if control_seen else 'was NOT'} detected); launches {launches}, plain "
          f"calls {plain}; worst index diff {worst['index']}, worst peak rel diff "
          f"{worst['peak_rel']:.2e}; resume: {again.resumed} resumed (AAC records included), 0 batches; cli -a "
          f"over {len(album_files)} files: album gain {doc['album']['gain_db']:.2f} dB vs "
          f"album_union {want_gain:.2f} dB", flush=True)
    print(f"library prep threads {card}: analyze_library over the {len(mp3_paths)} "
          f"MP3-side files in turns: " + "; ".join(
              f"{n} prep thread{'s' if n > 1 else ''} (walk pool "
              f"{max((os.cpu_count() or 1) - n, 1)}) {', '.join(f'{t:.3f}' for t in ts)} s"
              for n, ts in turns.items()), flush=True)
    return {"launches": launches}


HOSTILE_SEED = 8
# Mutations per seed: the 60 s bench clips take longest on the CPU side.
HOSTILE_PER_SEED = {"bench": 1, "other": 3}


def _same_outcome(a, b) -> bool:
    """Two scan outcomes agree: exceptions of one class name and message,
    or results with equal loudness, gain, rate and type and peaks within
    rtol 2e-4 (NaN where the other is NaN)."""
    import math

    if isinstance(a, Exception) or isinstance(b, Exception):
        return (type(a).__name__, str(a)) == (type(b).__name__, str(b))
    same_peak = (math.isnan(a.peak) and math.isnan(b.peak)) or math.isclose(
        a.peak, b.peak, rel_tol=2e-4, abs_tol=1e-6)
    return same_peak and (a.loudness_db, a.gain_db, a.sample_rate, a.file_type) == (
        b.loudness_db, b.gain_db, b.sample_rate, b.file_type)


def _peak_rel(a, b) -> float:
    """Largest relative difference of two peak arrays; NaN against NaN
    counts as 0 and NaN against a number as inf."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    if (nan_a != nan_b).any():
        return float("inf")
    ok = ~nan_a
    if not ok.any():
        return 0.0
    return float((np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-6)).max())


def hostile_phase(dev, card, luts, clips):
    """Hostile input on the card, right after the kernel checks, so that
    every later phase runs in a process whose kernels have decoded
    mutated streams (a fault in a kernel would have ended the CUDA
    context). Seeded byte flips, truncations and splices
    (testing/hostile.mutations) of the committed clips and the crafted
    streams, and the PNS-overflow ADTS stream:

    1. MP3 raw-bits: K1 exactly its plain version (rows, big_end,
       count1_end, input-order and channel-major rows) and the host
       decoder on valid granules; K2 within K2_RTOL / K2_ATOL_REL with its
       non-finite values where the plain version has them; the light
       route on the card against the port's CPU run (window counts and
       loudness exactly, peak rtol 2e-4).
    2. MP3 host-decoded: K3 as the route calls it against its plain
       version within K3_RTOL / K3_ATOL_REL; the route against the CPU.
    3. AAC: mutated M4A and ADTS streams and the PNS-overflow stream on
       the q route against the CPU; the overflow stream reads 0.00 dB from
       58 windows in bin 2000 with a NaN peak.
    4. scan_files over the library phase's 706 files with the mutated
       files among them: every library file exactly as in a scan without
       them; the mutated files scanned alone on the card exactly as on the
       CPU (the q route on both), and among the library files as alone
       (an AAC file's loudness may move with its batch row's PNS noise)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mp3rgain_tpu_torch import aac, scan
    from mp3rgain_tpu_torch.decode import aac_frontend as af
    from mp3rgain_tpu_torch.decode import class_core as cc
    from mp3rgain_tpu_torch.decode import entropy_kernel as ek
    from mp3rgain_tpu_torch.decode import frontend as fe
    from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
    from mp3rgain_tpu_torch.decode import synthesis as syn
    from mp3rgain_tpu_torch.parallel import runner as pr
    from mp3rgain_tpu_torch.testing import craft, craft_aac, hostile
    from mp3rgain_tpu_torch.testing import make_smoke_data as smoke

    t_start = time.perf_counter()
    rng = np.random.default_rng(HOSTILE_SEED)
    aac_clips = [os.path.join(smoke.DATA_DIR, n)
                 for n in (smoke.AAC_BENCH_TRACK, smoke.AAC_TRANSIENT_TRACK)]

    def read(name):
        with open(os.path.join(smoke.DATA_DIR, name), "rb") as f:
            return f.read()

    def mutate(seeds):
        return {f"{k}_{i}": m for k, data in seeds.items()
                for i, m in enumerate(hostile.mutations(
                    data, rng, HOSTILE_PER_SEED["bench" if "bench" in k else "other"]))}

    def to_dev(arrs):
        return [pr._to_device(a, dev) for a in arrs]

    runner = pr.Runner(dev)
    cpu = pr.Runner("cpu")

    # --- 1 and 2: MP3 ------------------------------------------------------------
    mp3 = mutate({
        "bench": read(smoke.BENCH_TRACK), "transient": read(smoke.TRANSIENT_TRACK),
        "mono": read(smoke.MONO_TRACK),
        "craft_intensity": craft.craft_intensity_stream(),
        "craft_lsf_intensity": craft.craft_lsf_intensity_stream(),
        "craft_mixed_block": craft.craft_mixed_block_stream(),
        "craft_count1b": craft.craft_count1b_stream(),
        "craft_scalefactor": craft.craft_scalefactor_stream(
            scf=[3, 2, 1, 4, 5, 6, 7, 0, 1, 2, 3] + [1, 2, 3, 0, 1, 2, 3, 0, 1, 2],
            preflag=1, scfsi=0b1010),
    })
    groups: dict[tuple, list] = {}
    mp3_host_fail = []
    for name, data in mp3.items():
        u = fe.unpack_data_light_packed(data)
        if u.n == 0:
            mp3_host_fail.append(name)
        else:
            groups.setdefault((u.sample_rate, u.n_channels), []).append(name)
    worst = {"k2_rel": 0.0, "k2_nonfinite": 0, "k45_rel": 0.0, "k3_rel": 0.0, "light_peak": 0.0,
             "heavy_peak": 0.0, "valid_rows": 0}
    k3_calls = 0

    def same_rows(got, want):
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "K1 on mutated streams: rows, big_end and count1_end equal the plain version")

    def close_with_nonfinite(got, want, rtol, atol_rel, what):
        """got within rtol and atol_rel * max|want| of want where want is
        finite; the same non-finite values where it is not."""
        fin = torch.isfinite(want)
        check(torch.equal(torch.isfinite(got), fin), f"{what}: non-finite in the same places")
        nf = ~fin
        check(torch.equal(torch.isnan(got[nf]), torch.isnan(want[nf]))
              and bool((got[nf] == want[nf])[~torch.isnan(want[nf])].all()),
              f"{what}: the same non-finite values")
        scale = want[fin].abs().max().item() if bool(fin.any()) else 0.0
        err = (got[fin] - want[fin]).abs().max().item() if bool(fin.any()) else 0.0
        check(torch.allclose(got[fin], want[fin], rtol=rtol, atol=atol_rel * scale),
              f"{what} within rtol {rtol}, atol {atol_rel}*max|plain| ({err:.3e} of {scale:.3e})")
        return err / scale if scale else 0.0, int(nf.sum())

    for (sr, nch), names in sorted(groups.items()):
        ups = [fe.unpack_data_light_packed(mp3[n]) for n in names]
        prep, rest, g_max = pr.prepare_batch_arrays_light(ups, nch)
        batch = to_dev((prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
        args = (*batch[:3], luts, ek.input_order_dest(batch[3], prep.n), prep.n)
        rows = ek.decode_rows(*args)
        same_rows(rows, ek.decode_rows_reference(*args))
        spec, big_end, c1end = (t.cpu().numpy() for t in rows)
        off = 0
        for n, u in zip(names, ups):
            full = fe.unpack_data(mp3[n])
            valid = full.info[:, fe.VALID] == 1
            sl = slice(off, off + u.n)
            check(np.array_equal(spec[sl][valid], full.spectrum[valid])
                  and np.array_equal(big_end[sl][valid], full.info[valid, fe.BIG_END])
                  and np.array_equal(c1end[sl][valid], full.info[valid, fe.COUNT1_END]),
                  f"K1 on {n}: valid granules equal the host decoder")
            worst["valid_rows"] += int(valid.sum())
            off += u.n
        dest, n_rows = pr.dest_rows(batch[3], batch[4], g_max=g_max, n_channels=nch,
                                    channel_major=True)
        rows_cm = ek.decode_rows(*batch[:3], luts, dest, n_rows)
        same_rows(rows_cm, ek.decode_rows_reference(*batch[:3], luts, dest, n_rows))
        tail = runner.tail(sr, nch)
        cm = pr.channel_major_inputs(*rows_cm, *batch[4:11], nb=prep.nb, g_max=g_max,
                                     n_channels=nch)
        rel, nonfin = close_with_nonfinite(
            hk.fused_requant_stereo(*cm, tail.hybrid),
            hk.fused_requant_stereo_reference(*cm, tail.hybrid), K2_RTOL, K2_ATOL_REL,
            f"K2 on the {sr} Hz x {nch} mutated batch")
        worst["k2_rel"] = max(worst["k2_rel"], rel)
        worst["k2_nonfinite"] += nonfin
        # K4 on the rows whose spectra are finite (the dense products spread
        # a non-finite line over the whole row, the kernel over its
        # subband), K5 on the plain hybrid outputs with non-finite values
        # zeroed; each against its plain version.
        xr = hk.fused_requant_stereo_reference(*cm, tail.hybrid)
        keep = torch.isfinite(xr).all(dim=2).all(dim=0)
        xr_f, gm_f = xr[:, keep].contiguous(), cm[2][:, keep].contiguous()
        rel4, _ = close_with_nonfinite(
            hk.hybrid_synthesis(xr_f, gm_f, tail.hybrid),
            hk.hybrid_gemm(xr_f, gm_f, tail.hybrid), K2_RTOL, K2_ATOL_REL,
            f"K4 on the {sr} Hz x {nch} mutated batch")
        z = torch.nan_to_num(hk.hybrid_gemm(xr, cm[2], tail.hybrid), 0.0, 0.0, 0.0)
        z = z.view(nch, -1, g_max // nch, 1152)
        rel5, _ = close_with_nonfinite(
            syn.overlap_polyphase(z, tail.decode),
            syn.overlap_polyphase_reference(z, tail.decode), K2_RTOL, K2_ATOL_REL,
            f"K5 on the {sr} Hz x {nch} mutated batch")
        worst["k45_rel"] = max(worst["k45_rel"], rel4, rel5)
        del batch, rows, rows_cm, cm, xr, xr_f, gm_f, z

        # The light route against the CPU run.
        hist, louds, peaks = runner.analyze_unpacked_light(ups, sr, nch)
        c_hist, c_louds, c_peaks = cpu.analyze_unpacked_light(ups, sr, nch)
        check(np.array_equal(hist.sum(axis=1), c_hist.sum(axis=1))
              and np.array_equal(louds, c_louds)
              and _peak_rel(peaks, c_peaks) <= 2e-4,
              f"light route on the {sr} Hz x {nch} mutated batch against the CPU: "
              f"{louds} vs {c_louds}, {peaks} vs {c_peaks}")
        worst["light_peak"] = max(worst["light_peak"], _peak_rel(peaks, c_peaks))

        # The host-decoded route: K3 held to its plain version on the
        # operands the route gives it, as it calls it (the route reuses
        # its buffers afterwards), then the route against the CPU.
        fulls = [fe.unpack_data(mp3[n]) for n in names]
        calls = []
        real = syn.class_core_gemm

        def spy(x, chi, clo, *, row_core=None):
            out = real(x, chi, clo, row_core=row_core)
            calls.append(close_with_nonfinite(
                out, cc.class_core_gemm_reference(x, chi, clo, row_core=row_core),
                K3_RTOL, K3_ATOL_REL, f"K3 on the {sr} Hz x {nch} mutated batch")[0])
            return out

        syn.class_core_gemm = spy
        try:
            hist, louds, peaks = runner.analyze_unpacked(fulls, sr, nch)
        finally:
            syn.class_core_gemm = real
        check(len(calls) > 0, "the host-decoded route called K3")
        worst["k3_rel"] = max([worst["k3_rel"], *calls])
        k3_calls += len(calls)
        c_hist, c_louds, c_peaks = cpu.analyze_unpacked(fulls, sr, nch)
        check(np.array_equal(hist.sum(axis=1), c_hist.sum(axis=1))
              and np.array_equal(louds, c_louds) and _peak_rel(peaks, c_peaks) <= 2e-4,
              f"host-decoded route on the {sr} Hz x {nch} mutated batch against the CPU: "
              f"{louds} vs {c_louds}, {peaks} vs {c_peaks}")
        worst["heavy_peak"] = max(worst["heavy_peak"], _peak_rel(peaks, c_peaks))
    n_dev = sum(len(v) for v in groups.values())
    torch.cuda.empty_cache()
    print(f"hostile mp3 raw-bits {card}: {len(mp3)} files mutated (seed {HOSTILE_SEED}; "
          f"3 clips, 5 crafted streams), {n_dev} reached the device in "
          f"{len(groups)} (rate, channels) batches, {len(mp3_host_fail)} failed on the host "
          f"(no frame kept); K1 exactly its plain version and the host decoder on "
          f"{worst['valid_rows']} valid granules; K2 max rel err {worst['k2_rel']:.2e} "
          f"(rtol {K2_RTOL}), {worst['k2_nonfinite']} non-finite values in the plain "
          f"version's places; K4 and K5 max rel err {worst['k45_rel']:.2e}; light route vs CPU: windows and loudness equal, max peak "
          f"rel diff {worst['light_peak']:.2e}", flush=True)
    print(f"hostile mp3 host-decoded {card}: the same {n_dev} files, {k3_calls} K3 calls "
          f"held to the plain version, max rel err {worst['k3_rel']:.2e} (rtol {K3_RTOL}); "
          f"route vs CPU: windows and loudness equal, max peak rel diff "
          f"{worst['heavy_peak']:.2e}", flush=True)

    # --- 3: AAC ----------------------------------------------------------------------
    m4a = mutate({"m4a_bench": read(smoke.AAC_BENCH_TRACK),
                  "m4a_transient": read(smoke.AAC_TRANSIENT_TRACK),
                  "m4a_pns": read(smoke.AAC_PNS_TRACK),
                  "m4a_two_tracks": read(smoke.AAC_TWO_TRACKS)})
    adts = mutate({
        "adts_mono": read(smoke.AAC_ADTS_TRACK),
        "craft_sce": craft_aac.craft_sce_stream(
            8, n_bands=45, energy={40: (1, -1, 1, 0)}, pulses=[(0, 4)],
            tns=dict(length=45, order=3, coefs=[5, 2, 7]), global_gain=150),
        "craft_cpe": craft_aac.craft_cpe_stream(
            8, n_bands=10, left_energy={b: (1, 0, -1, 0) for b in range(10)},
            is_bands={7: (15, 2), 8: (14, -1), 9: (15, 4)}, ms_used={0, 7},
            global_gain=150)})
    adts["pns_overflow"] = hostile.pns_overflow_stream()
    aac_groups: dict[tuple, list] = {}
    aac_host_fail = {}
    unpacked = {}
    for name, data in {**m4a, **adts}.items():
        try:  # the host front-end alone: a demux or decode error fails the file
            u = af.unpack_adts_q(af.mp4_to_adts(data) if name.startswith("m4a") else data)
        except Exception as e:  # noqa: BLE001 - recorded per file, as the scan does
            aac_host_fail[name] = type(e).__name__
            continue
        if u.n == 0:
            aac_host_fail[name] = "no frame"
            continue
        unpacked[name] = u
        aac_groups.setdefault((u.sample_rate, u.n_channels), []).append(name)
    aac_peak = 0.0
    for (sr, nch), names in sorted(aac_groups.items()):
        ups = [unpacked[n] for n in names]
        hist, louds, peaks = aac.analyze_batch_q(ups, sr, nch, runner=runner)
        c_hist, c_louds, c_peaks = aac.analyze_batch_q(ups, sr, nch, runner=cpu)
        check(np.array_equal(hist.sum(axis=1), c_hist.sum(axis=1))
              and np.array_equal(louds, c_louds) and _peak_rel(peaks, c_peaks) <= 2e-4,
              f"AAC q route on the {sr} Hz x {nch} mutated batch against the CPU: "
              f"{louds} vs {c_louds}, {peaks} vs {c_peaks}")
        aac_peak = max(aac_peak, _peak_rel(peaks, c_peaks))
        if "pns_overflow" in names:
            i = names.index("pns_overflow")
            check(louds[i] == 0.0 and int(hist[i].sum()) == int(hist[i, 2000]) == 58
                  and np.isnan(peaks[i]),
                  f"the PNS-overflow stream reads 0.00 dB from 58 windows in bin 2000, "
                  f"peak NaN: {louds[i]}, {int(hist[i].sum())}, {int(hist[i, 2000])}, "
                  f"{peaks[i]}")
    n_aac_dev = sum(len(v) for v in aac_groups.values())
    # What the histogram's explicit bin index replaced: torch's own
    # float -> int32 cast of NaN, inf and -inf, here and on the CPU.
    raw = torch.tensor([float("nan"), float("inf"), float("-inf")])
    cast = [raw.to(d).to(torch.int32).cpu().tolist() for d in (dev, "cpu")]
    print(f"hostile aac q route {card}: {len(m4a) + len(adts) - 1} files mutated (4 M4A "
          f"clips, 1 ADTS clip, 2 crafted streams) and the PNS-overflow stream, {n_aac_dev} "
          f"reached the device in {len(aac_groups)} batches, {len(aac_host_fail)} failed on "
          f"the host ({', '.join(sorted(set(aac_host_fail.values())))}); against the CPU: "
          f"windows and loudness equal, max peak rel diff {aac_peak:.2e}; the PNS-overflow "
          f"stream: 0.00 dB, 58 windows in bin 2000, peak NaN; torch's own float->int32 "
          f"cast of [nan, inf, -inf] (no longer used by the histogram): {cast[0]} on {dev}, "
          f"{cast[1]} on the CPU", flush=True)

    # --- 4: the library scan with the mutated files among the clean ones ------------
    root = tempfile.mkdtemp(prefix="mp3rgain-hostile-")
    try:
        clean_paths, _, _, _ = _library_files(root, clips, aac_clips)
        hostile_paths = []
        for name, data in {**mp3, **m4a, **adts}.items():
            ext = ".mp3" if name in mp3 else ".m4a" if name in m4a else ".aac"
            hostile_paths.append(os.path.join(root, f"hostile_{name}{ext}"))
            with open(hostile_paths[-1], "wb") as f:
                f.write(data)
        lib = pr.Runner(dev)
        t0 = time.perf_counter()
        clean = scan.scan_files(clean_paths, runner=lib, device_prep=True)
        clean_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mixed = scan.scan_files(clean_paths + hostile_paths, runner=lib, device_prep=True)
        mixed_s = time.perf_counter() - t0
        # The mutated files alone, on the card and on the CPU: the same
        # batches on both. Every scan here takes the AAC q route, the
        # card's default, named so that the CPU takes it too.
        alone = scan.scan_files(hostile_paths, runner=lib, device_prep=True)
        on_cpu = scan.scan_files(hostile_paths, runner=cpu, device_prep=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for p in clean_paths:
        a, b = mixed.results[p], clean.results[p]
        same = ((type(a).__name__, str(a)) == (type(b).__name__, str(b))
                if isinstance(a, Exception) or isinstance(b, Exception) else a == b)
        check(same and np.array_equal(mixed.histograms.get(p), clean.histograms.get(p)),
              f"{p} in the scan with the mutated files equals the clean scan: {a} vs {b}")
    failed = [p for p in hostile_paths if isinstance(mixed.results[p], Exception)]
    moved = []  # AAC files whose PNS noise moved with their batch row
    for p in hostile_paths:
        check(_same_outcome(alone.results[p], on_cpu.results[p]),
              f"{p} on the card as on the CPU: {alone.results[p]} vs {on_cpu.results[p]}")
        a, b = mixed.results[p], alone.results[p]
        if p.endswith(".mp3") or isinstance(a, Exception) or isinstance(b, Exception):
            check(_same_outcome(a, b), f"{p} among the library files as alone: {a} vs {b}")
        else:
            # The q route keys its PNS noise by the row in the batch (the
            # JAX package's _noise_uniform), so an AAC track's noise, and
            # on a stream of overflowing noise energies its loudness,
            # depends on the batch it lands in.
            check((a.sample_rate, a.file_type) == (b.sample_rate, b.file_type),
                  f"{p} among the library files as alone: {a} vs {b}")
            if a.loudness_db != b.loudness_db:
                moved.append(abs(a.loudness_db - b.loudness_db))
    print(f"hostile scan {card}: scan_files over the library phase's {len(clean_paths)} "
          f"files, clean {clean_s:.3f} s, with {len(hostile_paths)} mutated files among them "
          f"{mixed_s:.3f} s; every library file's result and histogram exactly as in the "
          f"clean scan; {len(failed)} mutated files failed and "
          f"{len(hostile_paths) - len(failed)} were analysed; the mutated files scanned "
          f"alone on the card equal their CPU scan (q route); among the library files each "
          f"MP3 and each failure as alone, {len(moved)} AAC files with another loudness "
          f"from their batch row's PNS noise (max {max(moved, default=0.0):.2f} dB); "
          f"hostile phase {time.perf_counter() - t_start:.1f} s", flush=True)


AAC_STAGES = ["nibble unpack + escapes", "requantize", "PNS", "stereo", "fallback merge",
              "long GEMM + windows", "short GEMMs", "overlap-add", "clip + peak", "IIR",
              "histogram + index"]


def _index(loudness_db: float) -> int:
    return round(loudness_db * 100) + 2000


def aac_phase(dev, card, runner, mp3_clip):
    """The AAC/M4A path on the card: the committed clips reach their
    branches; 64 copies of the 60 s M4A through the Runner's device-prep
    route (wall, split, peak memory), against the host-requant route on the
    card and against the CPU; the device phase by stage; the entry points.
    Returns (the 60 s and the transient clip's paths, the slice's line for
    the times section)."""
    import numpy as np
    import torch

    from mp3rgain_tpu_torch import aac, analysis
    from mp3rgain_tpu_torch.decode import aac_frontend as af
    from mp3rgain_tpu_torch.decode import aac_prep
    from mp3rgain_tpu_torch.decode import class_core as cc
    from mp3rgain_tpu_torch.decode import entropy_kernel as ek
    from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
    from mp3rgain_tpu_torch.decode.aac_synthesis import EIGHT_SHORT
    from mp3rgain_tpu_torch.parallel import runner as pr
    from mp3rgain_tpu_torch.testing import make_smoke_data as smoke

    def path(name):
        return os.path.join(smoke.DATA_DIR, name)

    # --- the clips reach their branches ---------------------------------------
    want = {  # clip -> (sample rate, channels, the branches it must reach)
        smoke.AAC_BENCH_TRACK: (44100, 2, ("short", "fallback", "pns", "ms", "escapes")),
        smoke.AAC_TRANSIENT_TRACK: (44100, 2, ("short", "fallback", "pns", "intensity")),
        smoke.AAC_PNS_TRACK: (44100, 2, ("pns", "intensity", "ms")),
        smoke.AAC_ADTS_TRACK: (22050, 1, ("pns", "escapes")),
        smoke.AAC_TWO_TRACKS: (44100, 2, ("pns",)),
    }
    seen = []
    for name, (sr, nch, branches) in want.items():
        u = af.unpack_file_q(path(name))
        reach = {"short": int((u.info[:, af.WINDOW_SEQ] == EIGHT_SHORT).sum()),
                 "fallback": len(u.fbrows), "pns": int((u.btype == 2).sum()),
                 "intensity": int((u.btype >= 3).sum()), "ms": int(u.msf.sum()),
                 "escapes": len(u.esc_idx)}
        check((u.sample_rate, u.n_channels) == (sr, nch) and u.n > 0,
              f"{name} unpacks as {sr} Hz, {nch} channel(s)")
        check(all(reach[b] > 0 for b in branches), f"{name} reaches {branches}: {reach}")
        seen.append(f"{name} {u.n} rows " + " ".join(f"{k} {v}" for k, v in reach.items()))
    second = af.unpack_file_q(path(smoke.AAC_TWO_TRACKS), track_index=1)
    check((second.sample_rate, second.n_channels) == (32000, 1), "the M4A's second track")
    print(f"aac clips: {'; '.join(seen)}; {smoke.AAC_TWO_TRACKS} track 1: "
          f"{second.n} rows at 32000 Hz mono", flush=True)

    # --- bit-exact pieces on the card -------------------------------------------
    prep_cpu, prep_dev = aac_prep.AacPrep(44100), aac_prep.AacPrep(44100).to(dev)
    check(torch.equal(prep_dev.noise_uniform(4099).cpu(), prep_cpu.noise_uniform(4099)),
          "the PNS noise hash on the card equals the CPU's bit for bit")
    allb = torch.arange(-128, 128, dtype=torch.int8)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(
        aac_prep.unpack_nibbles(allb.to(dev)), aac_prep.unpack_nibbles(allb))),
        "the nibble unpack on the card equals the CPU's over all 256 bytes")

    # --- the slice: 64 x 60 s through the q route -------------------------------
    bench = path(smoke.AAC_BENCH_TRACK)
    uq = af.unpack_file_q(bench)
    uf = af.unpack_file(bench, f16=True)
    track_s = aac.audio_seconds(uq)
    audio_s = BATCH_TRACKS * track_s
    tail = runner.aac_tail(44100, 2)
    for _ in range(2):  # warm-up, once per pinned staging slot
        aac.analyze_batch_q([uq] * BATCH_TRACKS, 44100, 2, runner=runner)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in KERNELS:
        c.reset()
    t0 = time.perf_counter()
    hist, louds, peaks = aac.analyze_batch_q([uq] * BATCH_TRACKS, 44100, 2, runner=runner)
    wall_s = time.perf_counter() - t0
    timing = runner.timings[-1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(timing["route"] == "aac_q", f"route {timing['route']}")
    check(hist.shape == (BATCH_TRACKS, 12000) and bool(np.isfinite(louds).all())
          and bool(np.isfinite(peaks).all()) and bool((peaks > 0).all()),
          "AAC slice: finite results of the expected shape")
    check(bool((hist.sum(axis=1) == hist[0].sum()).all())
          and int(np.abs(np.array([_index(v) for v in louds]) - _index(louds[0])).max()) <= 1
          and bool(np.allclose(peaks, peaks[0], rtol=1e-5)),
          "the 64 copies agree with each other")
    check(sum(c.kernel for c in KERNELS) == 0 and plain_calls() == 0,
          "the AAC path reaches none of K0 to K5 nor their plain versions")
    prepared = runner.prepare_aac_q([uq] * BATCH_TRACKS, 44100, 2)
    rows = prepared.arrays[0].shape[0] * prepared.arrays[0].shape[1]
    upload_mb = sum(a.nbytes for a in prepared.arrays) / 1e6

    # The host-requant route on the card, the same batch.
    for _ in range(2):
        f_hist, f_louds, f_peaks = aac.analyze_batch([uf] * BATCH_TRACKS, 44100, 2,
                                                     runner=runner)
    f_timing = runner.timings[-1]
    check(f_timing["route"] == "aac", f"route {f_timing['route']}")
    d_loud = float(np.abs(louds - f_louds).max())
    d_peak = float(np.abs(peaks / f_peaks - 1).max())
    check(bool((hist.sum(axis=1) == f_hist.sum(axis=1)).all()) and d_loud <= 0.02 + 1e-9
          and d_peak <= 1e-3,
          f"q route against the f16 route: loudness {d_loud} dB, peak rel {d_peak}")

    # The card against the port's CPU run, q route, track by track.
    cpu = pr.Runner("cpu")
    vs_cpu = []
    for name in (smoke.AAC_BENCH_TRACK, smoke.AAC_TRANSIENT_TRACK, smoke.AAC_PNS_TRACK,
                 smoke.AAC_ADTS_TRACK):
        u = af.unpack_file_q(path(name))
        args = ([u], u.sample_rate, u.n_channels)
        g_hist, g_louds, g_peaks = aac.analyze_batch_q(*args, runner=runner)
        c_hist, c_louds, c_peaks = aac.analyze_batch_q(*args, runner=cpu)
        d_idx = abs(_index(g_louds[0]) - _index(c_louds[0]))
        check(int(g_hist.sum()) == int(c_hist.sum()) and d_idx <= 2
              and bool(np.isclose(g_peaks[0], c_peaks[0], rtol=2e-4, atol=1e-6)),
              f"{name} on the card against the CPU: index {_index(g_louds[0])} vs "
              f"{_index(c_louds[0])}, peak {g_peaks[0]} vs {c_peaks[0]}")
        vs_cpu.append(f"{name} index diff {d_idx}, peak rel diff "
                      f"{abs(g_peaks[0] / c_peaks[0] - 1):.1e}")
    print(f"aac slice: Runner q route {BATCH_TRACKS} x {track_s:.2f} s on {dev}: {rows} "
          f"padded frame-channel rows, upload {upload_mb:.1f} MB, K1 to K5 launches 0; "
          f"track 0 gain {64.82 - louds[0]:.2f} dB, peak {peaks[0]:.6f}, windows "
          f"{int(hist[0].sum())}; against the f16 route on the card: max loudness diff "
          f"{d_loud:.3f} dB, max peak rel diff {d_peak:.1e}; against the CPU (q route): "
          f"{'; '.join(vs_cpu)}", flush=True)

    # --- the device phase by stage ------------------------------------------------
    dev_args = [pr._to_device(a, dev) for a in prepared.arrays]
    runs = []
    for _ in range(3):
        events = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        torch.cuda.synchronize()
        mark("start")
        aac.analysis_core_q(tail, *dev_args, **prepared.shapes, on_stage=mark)
        torch.cuda.synchronize()
        runs.append({st: a.elapsed_time(b)
                     for (_, a), (st, b) in zip(events, events[1:])})
    del dev_args
    torch.cuda.empty_cache()
    stage_ms = {st: float(np.median([r[st] for r in runs])) for st in runs[0]}
    check(list(stage_ms) == AAC_STAGES, f"stages {list(stage_ms)}")
    total_ms = sum(stage_ms.values())
    counts = prepared.shapes["short_counts"]
    print(f"aac stages {card} (CUDA events, median of 3; {sum(counts)} EIGHT_SHORT rows "
          f"by window pair {counts}, {prepared.arrays[4].shape[0]} fallback rows): "
          + "; ".join(f"{st} {stage_ms[st]:.3f} ms ({stage_ms[st] / total_ms:.1%})"
                      for st in AAC_STAGES) + f"; sum {total_ms:.3f} ms", flush=True)

    # --- entry points ------------------------------------------------------------------
    ent = []
    for name, track in ((smoke.AAC_TRANSIENT_TRACK, None), (smoke.AAC_PNS_TRACK, None),
                        (smoke.AAC_ADTS_TRACK, None), (smoke.AAC_TWO_TRACKS, 1)):
        r = analysis.analyze_track_internal(path(name), track, device=dev)
        c = analysis.analyze_track_internal(path(name), track, device="cpu")
        check(r.result.file_type == "aac" and r.audio_seconds == c.audio_seconds > 0
              and r.result.sample_rate == c.result.sample_rate, f"{name} entry point")
        # The card takes the q route and the CPU the f16 route by default.
        check(abs(r.result.gain_db - c.result.gain_db) <= 0.02 + 1e-9
              and abs(r.result.peak / c.result.peak - 1) <= 1e-3,
              f"{name} gain {r.result.gain_db} vs CPU {c.result.gain_db}, peak "
              f"{r.result.peak} vs {c.result.peak}")
        pk = analysis.find_peak_amplitude(path(name), device=dev)
        if track is None:
            check(bool(np.isclose(pk.peak, r.result.peak, rtol=1e-6))
                  and pk.peak <= aac.AAC_CLIP,
                  f"{name} find_peak_amplitude {pk.peak} vs {r.result.peak}")
        ent.append(f"{name}{'' if track is None else f' track {track}'} "
                   f"{r.result.gain_db:.2f} dB (peak {r.result.peak:.4f})")
    try:
        analysis.analyze_track_internal(path(smoke.AAC_TWO_TRACKS), 2, device=dev)
        check(False, "a track index past the last one raises")
    except af.Mp4DemuxError as e:
        check("out of range" in str(e), str(e))
    dec = []
    for name in (smoke.AAC_TRANSIENT_TRACK, smoke.AAC_ADTS_TRACK):
        got, sr_g = aac.decode_file(path(name), device=dev)
        ref, sr_w = aac.decode_file(path(name), device="cpu")
        bound = 5e-4 * float(np.sqrt((ref ** 2).mean())) + 1e-5
        err = float(np.abs(got - ref).max())
        check(sr_g == sr_w and got.shape == ref.shape and err < bound,
              f"aac.decode_file {name} on the card vs CPU ({err:.3e} >= {bound:.3e})")
        dec.append(f"{name} {got.shape} max|err| {err:.2e} (bound {bound:.2e})")
    files = [path(smoke.AAC_PNS_TRACK), mp3_clip, path(smoke.AAC_ADTS_TRACK)]
    album = analysis.analyze_album(files, device=dev)
    album_cpu = analysis.analyze_album(files, device="cpu")
    check([t.file_type for t in album.tracks] == ["aac", "mp3", "aac"]
          and abs(album.album_gain_db - album_cpu.album_gain_db) <= 0.02 + 1e-9,
          f"album over AAC and MP3: {album.album_gain_db} vs CPU {album_cpu.album_gain_db}")
    print(f"aac entry points (cuda, against cpu): {'; '.join(ent)}; album over "
          f"AAC + MP3 + AAC {album.album_gain_db:.2f} dB, album peak "
          f"{album.album_peak:.4f}; decode_file: {'; '.join(dec)}", flush=True)

    dev_s = timing["device_ms"] / 1e3
    split = timing["prep_s"] + timing["h2d_s"] + dev_s
    line = (f"times {card}: aac slice wall {wall_s:.3f} s = host prep "
            f"{timing['prep_s']:.3f} s + staging and upload {timing['h2d_s']:.3f} s + "
            f"device {dev_s:.3f} s (sum {split:.3f}); {audio_s:.0f} s of audio, real-time "
            f"factor {audio_s / wall_s:.0f}x; device-only {audio_s / dev_s:.0f}x; peak "
            f"device memory {peak_gb:.3f} GB; f16 route: host prep "
            f"{f_timing['prep_s']:.3f} s, staging and upload {f_timing['h2d_s']:.3f} s, "
            f"device {f_timing['device_ms'] / 1e3:.3f} s")
    return (bench, path(smoke.AAC_TRANSIENT_TRACK)), line


def per_track_cli_phase(dev, card, mp3_clip, aac_clip):
    """cli.main -r and -x over 15 files each: below scan.BATCH_THRESHOLD,
    so the per-track path, which shares one Runner per device; beside it
    the same 15 analyses with a new Runner per file, as the entry points
    built one before they shared it."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from mp3rgain_tpu_torch import analysis, cli, scan
    from mp3rgain_tpu_torch.parallel import runner as pr

    n = scan.BATCH_THRESHOLD - 1
    root = tempfile.mkdtemp(prefix="mp3rgain-cli-")
    try:
        mp3s, m4as = [], []
        for i in range(n):
            mp3s.append(os.path.join(root, f"t{i:02d}.mp3"))
            os.symlink(mp3_clip, mp3s[-1])
            m4as.append(os.path.join(root, f"t{i:02d}.m4a"))
            os.symlink(aac_clip, m4as[-1])

        def run(argv):
            out = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            check(rc == 0, f"cli {argv[:3]} exit code {rc}")
            return wall, out.getvalue()

        pr._shared.clear()  # the first call builds the shared Runner
        walls = {}
        for label, files in (("-r mp3", mp3s), ("-r m4a", m4as)):
            argv = ["-r", "--dry-run", "-o", "json", *files]
            cold, text = run(argv)
            doc = json.loads(text)
            check(len(doc["files"]) == n
                  and all(f["status"] in ("dry_run", "skipped") and "loudness_db" in f
                          for f in doc["files"]), f"cli {label}: {doc['files'][:1]}")
            walls[label] = (cold, run(argv)[0])
        cold, text = run(["-x", "-o", "json", *mp3s])
        check(len(json.loads(text)["files"]) == n, "cli -x")
        walls["-x mp3"] = (cold, run(["-x", "-o", "json", *mp3s])[0])

        fresh = {}
        for label, files in (("mp3", mp3s), ("m4a", m4as)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in files:
                analysis.analyze_track_internal(f, runner=pr.Runner(dev))
            fresh[label] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"per-track cli {card}: cli.main over {n} x 60 s files on the per-track path, one "
          f"shared Runner (first call, second call): "
          + "; ".join(f"{k} {a:.3f} s, {b:.3f} s" for k, (a, b) in walls.items())
          + f"; the same {n} analyze_track_internal calls with a new Runner per file: "
          + "; ".join(f"{k} {v:.3f} s" for k, v in fresh.items()), flush=True)


MULTI_COPIES = {"bench": 192, "transient": 32, "mono": 32}
MULTI_AAC_COPIES = {"aacbench": 64, "aactransient": 32}
CHILD_TIMEOUT_S = 300


def _symlinks(root, kind, src, n, ext):
    out = [os.path.join(root, f"{kind}_{i:03d}{ext}") for i in range(n)]
    for p in out:
        os.symlink(src, p)
    return out


def multi_runner_phase(dev, card, bench_u, clips, aac_clips):
    """Two Runners on the one card (they share its compute stream and
    SMs): analyze_library over a 352-file MP3 + AAC library dealt across
    them against one Runner, in turns (one, two, two, one), every track
    exactly equal; the sharded light and AAC dispatches of a 64-track
    batch against the single dispatch; dryrun_multichip(2), whose
    host-decoded core launches K3."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mp3rgain_tpu_torch import aac
    from mp3rgain_tpu_torch.decode import aac_frontend as af
    from mp3rgain_tpu_torch.decode import class_core as cc
    from mp3rgain_tpu_torch.decode import entropy_kernel as ek
    from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
    from mp3rgain_tpu_torch.parallel import dryrun
    from mp3rgain_tpu_torch.parallel import runner as pr

    bench_path, mono_path, transient_path = clips
    counters = KERNELS
    one = [pr.Runner(dev)]
    two = [pr.Runner(dev), pr.Runner(dev)]
    for r in one + two:
        for fmt in ((44100, 2), (22050, 1)):
            r.tail(*fmt)
        r.aac_tail(44100, 2)
    torch.cuda.synchronize()

    def scan(runners, mp3_paths, aac_paths):
        for r in runners:
            r.timings.clear()
            r.busy_ms.clear()
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mp3 = pr.analyze_library(mp3_paths, runners=runners, album=True)
        a = pr.analyze_library(aac_paths, runners=runners, album=True, file_type="aac")
        wall = time.perf_counter() - t0
        # The Runners' clocks start at their own origin events: shift each
        # onto the first Runner's before taking the union.
        busy = []
        for r in runners:
            off = runners[0]._origin.elapsed_time(r._origin)
            busy += [(x + off, y + off) for x, y in r.busy_ms]
        routes = [[t["route"] for t in r.timings] for r in runners]
        return {"mp3": mp3, "aac": a, "wall": wall, "busy": _union_ms(busy) / (wall * 1e3),
                "routes": routes, "light": {c.name: c.kernel for c in LIGHT},
                "plain": sum(c.plain for c in counters),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    root = tempfile.mkdtemp(prefix="mp3rgain-multi-")
    try:
        mp3_paths, aac_paths = [], []
        for kind, src in (("bench", bench_path), ("transient", transient_path),
                          ("mono", mono_path)):
            mp3_paths += _symlinks(root, kind, src, MULTI_COPIES[kind], ".mp3")
        for kind, src in zip(MULTI_AAC_COPIES, aac_clips):
            aac_paths += _symlinks(root, kind, src, MULTI_AAC_COPIES[kind], ".m4a")
        runs = [(len(rs), scan(rs, mp3_paths, aac_paths)) for rs in (one, two, two, one)]
    finally:
        shutil.rmtree(root, ignore_errors=True)

    ref = runs[0][1]
    n_files = len(mp3_paths) + len(aac_paths)
    check(all(t.ok for part in ("mp3", "aac") for t in ref[part].tracks),
          "every track of the one-Runner scan is ok")
    for n, run in runs:
        batches = sum(len(r) for r in run["routes"])
        light = sum(route == "light" for r in run["routes"] for route in r)
        check(all(v == light for v in run["light"].values()) and light > 0,
              f"{n} Runner(s): K0, K1, K2, K4 and K5 launches {run['light']} equal the "
              f"{light} MP3 batches")
        check(run["plain"] == 0, f"{n} Runner(s): plain calls {run['plain']}")
        check(all(len(r) > 0 for r in run["routes"]) and batches > light,
              f"every Runner took batches: {[len(r) for r in run['routes']]}")
        for part in ("mp3", "aac"):
            got, want = run[part], ref[part]
            for a, b in zip(got.tracks, want.tracks):
                check(a.ok and a.path == b.path and a.result == b.result
                      and np.array_equal(a.histogram, b.histogram),
                      f"{n} Runner(s): {a.path} equals the one-Runner scan exactly")
            total = np.sum([t.histogram for t in got.tracks], axis=0, dtype=np.int64)
            check(np.array_equal(got.album_histogram, total)
                  and got.album_peak == max(t.result.peak for t in got.tracks),
                  f"{n} Runner(s): the {part} album histogram equals the host sum")
    audio_s = ref["mp3"].audio_seconds + ref["aac"].audio_seconds

    # One batch split over the two Runners against the single dispatch.
    group = pr.RunnerGroup(runners=two)
    uq = af.unpack_file_q(aac_clips[0])
    sharded = {}
    for label, ups, single_fn, sharded_fn in (
        ("light", [bench_u] * BATCH_TRACKS,
         lambda ups: two[0].analyze_unpacked_light(ups, 44100, 2),
         lambda ups: group.collect(group.dispatch_light_sharded(ups, 44100, 2))),
        ("aac q", [uq] * BATCH_TRACKS,
         lambda ups: aac.analyze_batch_q(ups, 44100, 2, runner=two[0]),
         lambda ups: aac.analyze_batch_q_sharded(ups, 44100, 2, group=group)),
    ):
        walls = {"single": [], "sharded": []}
        out = {}
        for c in counters:
            c.reset()
        for name, fn in (("single", single_fn), ("sharded", sharded_fn),
                         ("sharded", sharded_fn), ("single", single_fn)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn(ups)
            walls[name].append(time.perf_counter() - t0)
        for a, b, what in zip(out["single"], out["sharded"], ("hist", "loudness", "peak")):
            check(a.shape == b.shape and bool((a == b).all()),
                  f"sharded {label} dispatch: {what} equals the single dispatch exactly")
        want_k = (2 + 2 * 2) if label == "light" else 0  # single x2, two shards x2
        check(all(c.kernel == want_k for c in LIGHT)
              and sum(c.plain for c in counters) == 0,
              f"sharded {label}: K0, K1, K2, K4, K5 launches "
              f"{[c.kernel for c in LIGHT]}, {want_k} wanted")
        sharded[label] = walls
    for c in counters:
        c.reset()
    dryrun.dryrun_multichip(2, device=dev)
    k3 = K3.kernel
    check(k3 > 0 and K1.kernel >= 3 and sum(c.plain for c in counters) == 0,
          f"dryrun_multichip(2) launched K3 {k3}, K1 {K1.kernel} times, no plain call")

    def fmt(n):
        picked = [run for k, run in runs if k == n]
        return (f"{n} Runner{'s' if n > 1 else ''}: walls "
                + ", ".join(f"{r['wall']:.3f}" for r in picked) + " s ("
                + ", ".join(f"{audio_s / r['wall']:.0f}x" for r in picked)
                + "), device busy " + ", ".join(f"{r['busy']:.1%}" for r in picked)
                + ", batches per Runner "
                + ", ".join(str([len(x) for x in r["routes"]]) for r in picked)
                + ", peak memory " + ", ".join(f"{r['peak_gb']:.3f}" for r in picked) + " GB")

    print(f"multi_runner {card}: analyze_library over {n_files} files "
          f"({len(mp3_paths)} MP3, {len(aac_paths)} M4A, {audio_s / 3600:.3f} audio-hours), "
          f"scans in turns (one, two, two, one Runner on {dev}): {fmt(1)}; {fmt(2)}; every "
          f"track's histogram, loudness and peak exactly equal in all four scans, album "
          f"histograms equal the host sums, K0 = K1 = K2 = K4 = K5 launches = MP3 batches "
          f"({runs[1][1]['light']['entropy_decode_rows']}), plain calls 0; one "
          f"{BATCH_TRACKS}-track batch split over the two Runners against the single "
          f"dispatch (exactly equal), walls in turns (single, sharded, sharded, single): "
          + "; ".join(f"{k} single {w['single'][0]:.3f}, {w['single'][1]:.3f} s, sharded "
                      f"{w['sharded'][0]:.3f}, {w['sharded'][1]:.3f} s"
                      for k, w in sharded.items())
          + f"; dryrun_multichip(2) ok, K3 launches {k3}", flush=True)
    return {"class_core_gemm_dryrun": k3}


def multihost_phase(dev, card, clips):
    """Two and three processes on the one card, as real subprocesses of
    `python -m mp3rgain_tpu_torch.cli` with the MP3RGAIN_* environment (a
    gloo group over localhost): the album block of 32 files in two
    processes against one process; an empty slice; byte surgery on a
    slice; dryrun_multihost(2)."""
    import shutil
    import socket
    import subprocess
    import sys
    import tempfile

    from mp3rgain_tpu_torch.parallel import dryrun

    here = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items() if not k.startswith("MP3RGAIN_")}
    base["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep) if p])
    base["MP3RGAIN_GROUP_TIMEOUT_S"] = "240"

    def run_group(cmd, n):
        """`cmd` as n processes of one group: [(exit code, stdout, stderr)]
        and the wall; every child is stopped before this returns."""
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = [dict(base) for _ in range(n)]
        if n > 1:
            for pid, e in enumerate(env):
                e.update(MP3RGAIN_COORDINATOR=f"localhost:{port}",
                         MP3RGAIN_NUM_PROCESSES=str(n), MP3RGAIN_PROCESS_ID=str(pid))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd, env=e, cwd=here, text=True, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE) for e in env]
        try:
            out = []
            for p in procs:
                o, err = p.communicate(timeout=CHILD_TIMEOUT_S)
                out.append((p.returncode, o, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return out, time.perf_counter() - t0

    def doc_of(rc, out, err, what):
        check(rc == 0, f"{what}: exit code {rc}: {err[-1500:]}")
        return json.loads(out[out.index("{"):])

    bench_path, mono_path, transient_path = clips
    cli_cmd = [sys.executable, "-m", "mp3rgain_tpu_torch.cli"]
    root = tempfile.mkdtemp(prefix="mp3rgain-multihost-")
    try:
        files = []
        for i in range(32):  # two buckets, three lengths, interleaved
            kind, src = (("bench", bench_path), ("transient", transient_path),
                         ("mono", mono_path), ("bench", bench_path))[i % 4]
            files.append(os.path.join(root, f"t{i:02d}_{kind}.mp3"))
            os.symlink(src, files[-1])
        argv = ["-a", "-n", "-o", "json", *files]
        (single,), single_s = run_group(cli_cmd + argv, 1)
        ref = doc_of(*single, "cli -a in one process")
        check(len(ref["files"]) == 32 and "album" in ref, "one process: 32 files and an album")
        pair, pair_s = run_group(cli_cmd + argv, 2)
        for pid, res in enumerate(pair):
            doc = doc_of(*res, f"cli -a, process {pid} of 2")
            check([f["file"] for f in doc["files"]] == files[pid::2],
                  f"process {pid} of 2 prints its slice")
            check(doc["album"] == ref["album"],
                  f"process {pid} of 2: album {doc['album']} equals one process's "
                  f"{ref['album']} exactly")
            for a, b in zip(doc["files"], ref["files"][pid::2]):
                check(a["gain_applied_steps"] == b["gain_applied_steps"]
                      and abs(a["loudness_db"] - b["loudness_db"]) <= 0.02 + 1e-9,
                      f"process {pid} of 2: {a['file']} against one process")

        # Three processes over two files: the third's slice is empty, it
        # joins the union all the same, and every process exits 0.
        few = ["-a", "-n", "-o", "json", *files[:2]]
        (one_few,), _ = run_group(cli_cmd + few, 1)
        ref_few = doc_of(*one_few, "cli -a over 2 files in one process")
        triple, triple_s = run_group(cli_cmd + few, 3)
        docs = [doc_of(*res, f"cli -a over 2 files, process {pid} of 3")
                for pid, res in enumerate(triple)]
        check([len(d["files"]) for d in docs] == [1, 1, 0]
              and all(d["album"] == ref_few["album"] for d in docs),
              f"3 processes over 2 files: slices {[len(d['files']) for d in docs]}, albums "
              f"{[d['album'] for d in docs]} vs {ref_few['album']}")

        # Byte surgery under the coordinator: no peer, no torch, the slice only.
        copies = []
        for i in range(4):
            copies.append(os.path.join(root, f"g{i}.mp3"))
            shutil.copy(transient_path, copies[-1])
        before = [open(f, "rb").read() for f in copies]
        prog = ("import json, sys\n"
                "from mp3rgain_tpu_torch import cli\n"
                "rc = cli.main(['-g', '2', *sys.argv[1:]])\n"
                "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules}))\n")
        env = dict(base, MP3RGAIN_COORDINATOR="localhost:1", MP3RGAIN_NUM_PROCESSES="2",
                   MP3RGAIN_PROCESS_ID="1")
        proc = subprocess.run([sys.executable, "-c", prog, *copies], env=env, cwd=here,
                              capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        check(proc.returncode == 0, f"-g 2 under the coordinator: {proc.stderr[-800:]}")
        check(json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "torch": False},
              f"-g 2 under the coordinator loads no torch: {proc.stdout[-300:]}")
        changed = [open(f, "rb").read() != b for f, b in zip(copies, before)]
        check(changed == [False, True, False, True],
              f"-g 2 as process 1 of 2 rewrites its slice only: {changed}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    t0 = time.perf_counter()
    dryrun.dryrun_multihost(2, device=dev, timeout_s=CHILD_TIMEOUT_S)
    dry_s = time.perf_counter() - t0
    a = ref["album"]
    print(f"multihost {card}: cli -a -n -o json over 32 files (symlinks to three clips, two "
          f"buckets) as subprocesses on {dev}, gloo over localhost: one process "
          f"{single_s:.3f} s; two processes {pair_s:.3f} s, each printed its 16-file slice "
          f"and both the one-process album block exactly (gain {a['gain_db']:.2f} dB, "
          f"{a['gain_steps']} steps, peak {a['peak']:.6f}); three processes over 2 files "
          f"{triple_s:.3f} s, the empty slice joined the union, exit codes 0, 0, 0; -g 2 as "
          f"process 1 of 2 with no coordinator listening rewrote files 1 and 3 of 4 and "
          f"loaded no torch; dryrun_multihost(2) ok in {dry_s:.3f} s (walls include each "
          f"process's start, imports and table builds)", flush=True)


def gui_phase(dev, card, clips):
    """gui.AppState(device="cuda") over 15 MP3 files, below
    scan.BATCH_THRESHOLD: analyze_tracks and analyze_album give the CLI's
    gains; apply then undo restores every byte."""
    import contextlib
    import io
    import shutil
    import tempfile

    from mp3rgain_tpu_torch import cli, gui, scan

    n = scan.BATCH_THRESHOLD - 1
    root = tempfile.mkdtemp(prefix="mp3rgain-gui-")
    try:
        files = []
        for i in range(n):
            files.append(os.path.join(root, f"t{i:02d}.mp3"))
            shutil.copy(clips[i % len(clips)], files[-1])
        before = [open(f, "rb").read() for f in files]

        def cli_json(flag):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main([flag, "--dry-run", "-o", "json", *files])
            check(rc == 0, f"cli {flag} exit code {rc}")
            return json.loads(out.getvalue())

        tracks, album = cli_json("-r"), cli_json("-a")
        state = gui.AppState(device=str(dev))
        check(state.add_folder(root) == n, "the GUI lists the 15 files")
        t0 = time.perf_counter()
        state.analyze_tracks()
        tracks_s = time.perf_counter() - t0
        for entry, row, f in zip(state.files, state.rows(), tracks["files"]):
            check(str(entry.path) == f["file"] and entry.status == "analyzed",
                  f"{entry.name}: {entry.status} {entry.error}")
            check(abs(entry.track_gain_db - (64.82 - f["loudness_db"])) <= 1e-9
                  and entry.peak == f["peak"]
                  and row["gain_steps"] == str(f["gain_applied_steps"]),
                  f"{entry.name}: GUI gain {entry.track_gain_db}, steps {row['gain_steps']} "
                  f"vs cli {64.82 - f['loudness_db']}, {f['gain_applied_steps']}")
        t0 = time.perf_counter()
        state.analyze_album()
        album_s = time.perf_counter() - t0
        check(all(abs(e.album_gain_db - album["album"]["gain_db"]) <= 1e-9
                  for e in state.files),
              f"GUI album gain {state.files[0].album_gain_db} vs cli "
              f"{album['album']['gain_db']}")
        applied = state.apply_gain(use_album=False)
        changed = sum(open(f, "rb").read() != b for f, b in zip(files, before))
        check(applied == n and changed > 0, f"apply: {applied} applied, {changed} rewritten")
        undone = state.undo_all()
        check(undone == changed and [open(f, "rb").read() for f in files] == before,
              f"undo restored the bytes of {undone} of {changed} files")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"gui {card}: AppState(device={str(dev)!r}) over {n} MP3 files: analyze_tracks "
          f"{tracks_s:.3f} s, analyze_album {album_s:.3f} s, gains and steps equal cli -r, "
          f"album gain {state.files[0].album_gain_db:+.2f} dB equals cli -a; apply rewrote "
          f"{changed} files, undo restored every byte", flush=True)


ORACLE_DB = 0.05  # |card - float64 reference| budget: the product's accuracy (PERF.md §1)
ORACLE_PEAK_RTOL = 2e-4
PEAK_KEYS = ("max_amplitude", "peak")


def _same_cli_file(card_f: dict, cpu_f: dict) -> bool:
    """One file's JSON from the CLI on the card equals the CPU's: the same
    keys, integers and flags, strings equal but for numbers with a
    fraction, peaks within rtol 2e-4, other floats (dB) within 0.02."""
    import re

    if sorted(card_f) != sorted(cpu_f):
        return False
    for k, a in card_f.items():
        b = cpu_f[k]
        if isinstance(a, float) or isinstance(b, float):
            tol = ORACLE_PEAK_RTOL * abs(b) if k in PEAK_KEYS else 0.02
            if abs(a - b) > tol:
                return False
        elif isinstance(a, str) and isinstance(b, str):
            if re.sub(r"\d+\.\d+", "#", a) != re.sub(r"\d+\.\d+", "#", b):
                return False
        elif a != b:
            return False
    return True


def oracle_phase(dev, card):
    """Hold the card to references that share no arithmetic with it: every
    committed clip through each of its routes against the float64
    reference gain and peak of its decoded PCM (testing/reference.py),
    the decoder on the card against the CPU, the byte-surgery scale oracle
    (a file with s more gain steps decodes to its PCM times 2^(s/4)), the
    peak contract (an MP3 whose peak exceeds 1.0 through the CLI), and
    entry(). No step here is timed but the phase's wall."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mp3rgain_tpu_torch import aac, analysis, bitstream, cli
    from mp3rgain_tpu_torch import entry as entry_mod
    from mp3rgain_tpu_torch.decode import class_core as cc
    from mp3rgain_tpu_torch.decode import entropy_kernel as ek
    from mp3rgain_tpu_torch.decode import frontend as fe
    from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
    from mp3rgain_tpu_torch.decode import synthesis as syn
    from mp3rgain_tpu_torch.parallel import runner as pr
    from mp3rgain_tpu_torch.replaygain import PINK_REF, db_to_steps
    from mp3rgain_tpu_torch.testing import make_smoke_data as smoke
    from mp3rgain_tpu_torch.testing.reference import reference_gain, reference_peak

    t_phase = time.perf_counter()
    runner = pr.Runner(dev)
    worst = {"db": 0.0, "peak": 0.0}

    def path(name):
        return os.path.join(smoke.DATA_DIR, name)

    def reset():
        for c in KERNELS:
            c.reset()

    def hold(what, gain, peak, ref_gain, ref_peak, pcm_of):
        diff = gain - ref_gain
        rel = abs(peak / ref_peak - 1.0) if ref_peak else abs(peak)
        check(abs(diff) <= ORACLE_DB,
              f"{what}: card {gain:.4f} dB vs float64 reference {ref_gain:.4f} dB")
        check(rel <= ORACLE_PEAK_RTOL,
              f"{what}: card peak {peak:.6f} vs reference {ref_peak:.6f}")
        worst["db"] = max(worst["db"], abs(diff))
        worst["peak"] = max(worst["peak"], rel)
        print(f"oracle {what}: card {gain:.4f} dB, reference {ref_gain:.4f} dB "
              f"({pcm_of}), diff {diff:+.4f} dB; peak {peak:.6f} vs {ref_peak:.6f} "
              f"(rel {rel:.2e})", flush=True)

    # (a) MP3: each committed clip on the light route (K1, K2, K4, K5) and the
    # host-decoded route (K3), against the reference on the port's CPU
    # decode; the card's decode against the CPU's.
    mp3 = [smoke.BENCH_TRACK, smoke.MONO_TRACK, smoke.TRANSIENT_TRACK, smoke.HOT_TRACK]
    dec = []
    for name in mp3:
        with open(path(name), "rb") as f:
            data = f.read()
        pcm, sr = syn.decode_file(path(name), device="cpu")
        ref_g, ref_p = reference_gain(pcm, sr), reference_peak(pcm)
        light = fe.unpack_data_light_packed(data)
        reset()
        _, louds, peaks = runner.analyze_unpacked_light([light], sr, light.n_channels)
        check(all(c.kernel >= 1 for c in LIGHT) and plain_calls() == 0,
              f"{name}: light route launched K0, K1, K2, K4 and K5, no plain call")
        hold(f"{name} light route", PINK_REF - float(louds[0]), float(peaks[0]),
             ref_g, ref_p, "CPU decode")
        full = fe.unpack_data(data)
        reset()
        _, louds, peaks = runner.analyze_unpacked([full], sr, full.n_channels)
        check(K3.kernel >= 1 and plain_calls() == 0,
              f"{name}: heavy route launched K3, no plain call")
        hold(f"{name} heavy route", PINK_REF - float(louds[0]), float(peaks[0]),
             ref_g, ref_p, "CPU decode")
        got, sr_g = syn.decode_file(path(name), device=dev)
        bound = 5e-4 * float(np.sqrt((pcm ** 2).mean())) + 1e-5
        err = float(np.abs(got - pcm).max())
        check(sr_g == sr and got.shape == pcm.shape and err < bound,
              f"decode_file {name} on the card vs CPU ({err:.3e} >= {bound:.3e})")
        dec.append(f"{name} {err:.2e} (bound {bound:.2e})")
    print(f"oracle decode_file (cuda vs cpu, max|err|): {'; '.join(dec)}", flush=True)

    # (b) AAC: each committed M4A and ADTS clip (both tracks of the
    # two-track file) on the q route, against the reference on the PCM
    # that route analyses (its PNS noise is keyed by batch row), computed
    # on the CPU, and on the host decoder's PCM, whose PNS noise differs:
    # held for every clip without PNS bands, reported for the PNS clip.
    aac_clips = [(smoke.AAC_BENCH_TRACK, None), (smoke.AAC_TRANSIENT_TRACK, None),
                 (smoke.AAC_PNS_TRACK, None), (smoke.AAC_ADTS_TRACK, None),
                 (smoke.AAC_TWO_TRACKS, 0), (smoke.AAC_TWO_TRACKS, 1)]
    pns_finding = None
    for name, track in aac_clips:
        what = name if track is None else f"{name} track {track}"
        r = aac.analyze_track_internal(path(name), track, device=dev, runner=runner,
                                       device_prep=True).result
        q_pcm, sr = aac.decode_file_q(path(name), track, device="cpu")
        hold(f"{what} q route", r.gain_db, r.peak, reference_gain(q_pcm, sr),
             reference_peak(q_pcm), "the q route's PCM on the CPU")
        host_pcm, sr_h = aac.decode_file(path(name), track, device="cpu")
        host_pcm = np.clip(host_pcm, -aac.AAC_CLIP, aac.AAC_CLIP)
        check(sr_h == sr, f"{what}: sample rates")
        ref_host = reference_gain(host_pcm, sr)
        if name == smoke.AAC_PNS_TRACK:
            pns_finding = (r.gain_db - ref_host, r.peak, reference_peak(host_pcm))
            print(f"oracle {what} q route vs the host decoder's PCM (different PNS "
                  f"noise, reported, not held): card {r.gain_db:.4f} dB, reference "
                  f"{ref_host:.4f} dB, diff {pns_finding[0]:+.4f} dB; peak "
                  f"{r.peak:.6f} vs {pns_finding[2]:.6f}", flush=True)
        else:
            hold(f"{what} q route", r.gain_db, r.peak, ref_host,
                 reference_peak(host_pcm), "the host decoder's PCM on the CPU")
    check(pns_finding is not None, "the PNS clip was analysed")

    root = tempfile.mkdtemp(prefix="mp3rgain-oracle-")
    try:
        # (c) The byte-surgery scale oracle: global_gain enters requantization
        # as an exact 2^(gain/4), so s more steps scale the decoded PCM by
        # 2^(s/4); the port's decoder on the card stands in for libmpg123.
        base, _ = syn.decode_file(path(smoke.BENCH_TRACK), device=dev)
        info = bitstream.analyze(path(smoke.BENCH_TRACK))
        scale_errs = []
        for steps in (-3, 2, 4):
            check(info.max_gain + max(steps, 0) <= 255 and info.min_gain + min(steps, 0) >= 0,
                  f"no gain saturation at {steps:+d} steps")
            p = os.path.join(root, f"bench{steps:+d}.mp3")
            shutil.copy(path(smoke.BENCH_TRACK), p)
            check(bitstream.apply_gain(p, steps) == info.frame_count,
                  f"apply_gain({steps:+d}) rewrote every frame")
            got, _ = syn.decode_file(p, device=dev)
            want = base.astype(np.float64) * 2.0 ** (steps / 4.0)
            bound = 5e-4 * float(np.sqrt((want ** 2).mean())) + 1e-5
            err = float(np.abs(got - want).max())
            check(got.shape == base.shape and err < bound,
                  f"{steps:+d} steps decode to 2^({steps}/4) x the PCM ({err:.3e} >= "
                  f"{bound:.3e})")
            scale_errs.append(f"{steps:+d} steps max|err| {err:.2e} (bound {bound:.2e})")
        print(f"oracle byte surgery on {smoke.BENCH_TRACK}, decoded on the card: "
              f"{'; '.join(scale_errs)}", flush=True)

        # (d) The peak contract: the hot clip, +4 steps, peaks above 1.0.
        hot = os.path.join(root, "hot.mp3")
        mid = os.path.join(root, "mid.mp3")
        shutil.copy(path(smoke.HOT_TRACK), hot)
        shutil.copy(path(smoke.HOT_TRACK), mid)
        bitstream.apply_gain(hot, 4)
        peak = analysis.find_peak_amplitude(hot, device=dev).peak
        peak_cpu = analysis.find_peak_amplitude(hot, device="cpu").peak
        check(1.2 < peak < 2.0 and abs(peak / peak_cpu - 1) <= ORACLE_PEAK_RTOL,
              f"+4 steps: unclipped peak {peak} above 1.0, CPU {peak_cpu}")
        mid_peak = analysis.find_peak_amplitude(mid, device=dev).peak

        def run_cli(argv, device):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(argv, device=device)
            check(rc == 0, f"cli {argv} on {device}: exit code {rc}")
            return json.loads(out.getvalue())["files"][0]

        runs = {}
        for key, argv in (("x", ["-x", "-o", "json", hot]),
                          ("k", ["-n", "-k", "-r", "-o", "json", hot]),
                          ("k_mid", ["-n", "-k", "-r", "-o", "json", mid]),
                          ("compat_x", ["--clip-peak-compat", "-x", "-o", "json", hot]),
                          ("compat_k", ["--clip-peak-compat", "-n", "-k", "-r", "-o",
                                        "json", hot])):
            runs[key] = run_cli(argv, str(dev))
            cpu_f = run_cli(argv, "cpu")
            check(_same_cli_file(runs[key], cpu_f),
                  f"cli {' '.join(argv[:-1])} on the card {runs[key]} equals the CPU's {cpu_f}")
        x, k, k_mid = runs["x"], runs["k"], runs["k_mid"]
        check(x["max_amplitude"] > 32768.0 and "may be clipped" in (x.get("warning") or ""),
              f"-x reports the unclipped peak and warns: {x}")
        check(k["gain_applied_steps"] == max(db_to_steps(-20.0 * np.log10(peak)), 0) == 0
              and "prevent clipping" in (k.get("warning") or ""),
              f"-k caps the gain at 0 steps for peak {peak}: {k}")
        cap = max(db_to_steps(-20.0 * np.log10(mid_peak)), 0)
        check(0 < cap == k_mid["gain_applied_steps"]
              and mid_peak * 10 ** (1.5 * cap / 20) <= 1.0,
              f"-k caps the gain at {cap} steps for peak {mid_peak}: {k_mid}")
        check(abs(runs["compat_x"]["max_amplitude"] - 32768.0) < 1e-6
              and abs(runs["compat_k"]["peak"] - 1.0) < 1e-9
              and runs["compat_k"]["gain_applied_steps"] == 0,
              f"--clip-peak-compat reports 1.0: {runs['compat_x']}, {runs['compat_k']}")
        print(f"oracle peak contract on {smoke.HOT_TRACK} +4 steps: card peak {peak:.6f} "
              f"(CPU {peak_cpu:.6f}); -x max_amplitude {x['max_amplitude']:.1f}, "
              f"'{x['warning']}'; -n -k -r applies {k['gain_applied_steps']} of "
              f"{db_to_steps(PINK_REF - k['loudness_db'])} steps; unboosted (peak "
              f"{mid_peak:.6f}) -k caps at {cap} steps, peak after "
              f"{mid_peak * 10 ** (1.5 * cap / 20):.4f}; --clip-peak-compat peak "
              f"{runs['compat_k']['peak']}, max_amplitude "
              f"{runs['compat_x']['max_amplitude']:.1f}; five CLI outputs equal the CPU's",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (e) entry(): one forward step of the heavy route on the card.
    fn, args = entry_mod.entry(dev)
    reset()
    hist, idx, pk = (t.cpu().numpy() for t in fn(*args))
    k3, plain = K3.kernel, plain_calls()
    check(k3 >= 1 and plain == 0, f"entry(): K3 launches {k3}, plain calls {plain}")
    c_fn, c_args = entry_mod.entry("cpu")
    c_hist, c_idx, c_pk = (t.numpy() for t in c_fn(*c_args))
    check(bool((hist.sum(axis=1) == c_hist.sum(axis=1)).all()), "entry(): windows exact")
    check(int(np.abs(idx.astype(int) - c_idx.astype(int)).max()) <= 2,
          "entry(): loudness index within 2 bins of the CPU")
    check(bool(np.allclose(pk, c_pk, rtol=ORACLE_PEAK_RTOL, atol=0)),
          "entry(): peak within rtol 2e-4 of the CPU")
    print(f"oracle entry() on {dev}: K3 launches {k3}, plain calls {plain}; windows "
          f"{hist.sum(axis=1).tolist()} equal the CPU's, max index diff "
          f"{int(np.abs(idx.astype(int) - c_idx.astype(int)).max())}, max peak rel diff "
          f"{float(np.abs(pk / c_pk - 1).max()):.2e}", flush=True)
    del runner
    torch.cuda.empty_cache()
    print(f"oracle phase {card}: wall {time.perf_counter() - t_phase:.1f} s; "
          f"{len(mp3)} MP3 clips x 2 routes and {len(aac_clips)} AAC tracks on the q "
          f"route within {worst['db']:.4f} dB (budget {ORACLE_DB}) and peak rel "
          f"{worst['peak']:.2e} (rtol {ORACLE_PEAK_RTOL}) of the float64 reference; PNS "
          f"clip vs the host decoder's PCM {pns_finding[0]:+.4f} dB (reported)",
          flush=True)


# --- the real_library phase: real track lengths and every sample rate -------------

REAL_RATE_FACTOR = 1.2  # rate-matrix tracks: this many times the dense level-2 limit
REAL_DEGENERATE_S = 63.0  # 88.2 kHz runs no solve at all: any length over 60 s
# Copies of the 60 s bench clips (MP3, and the M4A's frames as ADTS): 4 min,
# 20 min and 2 h. The first is held to the whole float64 reference, the
# others segment by segment; the last is the batch of one over the rows cap.
REAL_LADDER = {"4 min": 4, "20 min": 20, "2 h": 120}
REAL_SEGMENT_S = 10.0
REAL_WARMUP_S = 1.0  # the float64 filter starts this long before a segment
REAL_SEGMENT_TOL = 1e-3  # max |card - float64| / segment peak at 44.1 kHz
# The library: per short source, files of evenly spaced lengths in minutes.
REAL_LIBRARY_MINUTES = (2.0, 12.0)
REAL_LIBRARY_SOURCES = (("mp3", "transient", 12), ("mp3", "48k", 12), ("mp3", "mono", 12),
                        ("aac", "bench", 6), ("aac", "48k", 6))
REAL_POOL = 8  # reference worker processes (at most the host's cores)


def _solve(n: int, limit_nb2: int) -> tuple[int, str]:
    """(nb2, level-2 solve) the IIR runs on n padded samples."""
    nb2 = -(-(-(-n // 128)) // 128)
    return nb2, ("dense" if nb2 <= limit_nb2 else "doubling")


def _degenerate_reference(pcm, sr: int) -> tuple[float, int, int]:
    """The float64 reference at a rate whose filter diverges (88.2 kHz):
    reference_gain's 50 ms windows, each binned as the JAX package bins
    it (ops/histogram.bin_index: a NaN mean square lands in bin 2000, the
    reference's `NaN as i32` cast), since Python's int() refuses NaN.
    Returns (gain dB, NaN windows, windows)."""
    import numpy as np
    import torch

    from mp3rgain_tpu_torch.ops import histogram as hi
    from mp3rgain_tpu_torch.ops.iir import equal_loudness_scan
    from mp3rgain_tpu_torch.replaygain import PINK_REF

    x = np.asarray(pcm, dtype=np.float64)[:2] * 32768.0
    w = hi.window_size(sr)
    with np.errstate(all="ignore"):
        filt = equal_loudness_scan(x, sr).numpy()
        c, t = filt.shape
        n_win = -(-t // w)
        sq = np.pad(filt ** 2, ((0, 0), (0, n_win * w - t))).reshape(c, n_win, w).sum(-1)
        lsum, rsum = sq[0], sq[1] if c == 2 else sq[0]
        ms = (lsum + rsum) / np.minimum(w, t - np.arange(n_win) * w) * 0.5
        val = torch.from_numpy(100 * 10 * np.log10(ms + 1e-37))
    idx = hi.bin_index(val).numpy()
    hist = np.bincount(idx[(idx >= 0) & (idx < hi.HISTOGRAM_SIZE)],
                       minlength=hi.HISTOGRAM_SIZE)
    return PINK_REF - hi.loudness_from_histogram(hist), int(np.isnan(ms).sum()), n_win


def _real_reference(kind: str, path: str) -> dict:
    """In a worker process: the port's CPU decode of `path` (MP3: the
    host decoder's PCM; AAC: the q route's own PCM, whose PNS noise is
    the route's) and the float64 reference gain and peak of it."""
    import torch

    torch.set_num_threads(1)
    from mp3rgain_tpu_torch.ops.coeffs import DEGENERATE_RATES
    from mp3rgain_tpu_torch.testing.reference import reference_gain, reference_peak

    t0 = time.perf_counter()
    if kind == "mp3":
        from mp3rgain_tpu_torch.decode import synthesis as syn

        pcm, sr = syn.decode_file(path, device="cpu")
    else:
        from mp3rgain_tpu_torch import aac

        pcm, sr = aac.decode_file_q(path, None, device="cpu")
    out = {"sr": sr, "channels": pcm.shape[0], "samples": pcm.shape[-1],
           "peak": reference_peak(pcm)}
    if sr in DEGENERATE_RATES:
        out["gain"], out["nan_windows"], out["windows"] = _degenerate_reference(pcm, sr)
    else:
        out["gain"] = reference_gain(pcm, sr)
    out["s"] = time.perf_counter() - t0
    return out


def real_library_phase(dev, card):
    """The port on the input a real library holds, against the float64
    reference (testing/reference.py):

    (a) the rate matrix: each of the 12 standard MP3 fixture classes (every
    MPEG rate; mono, stereo, joint stereo, VBR) tiled to 1.2x its rate's
    dense level-2 limit, on the light route (K1, K2) and the host-decoded
    route (K3), the unfused light tail equal to the latter exactly; an ADTS
    clip at each of the 12 AAC rates tiled the same way (88.2 kHz to 63 s)
    on the q route. Each within 0.05 dB of reference_gain and rtol 2e-4 of
    reference_peak on the track's CPU decode; every track's IIR ran the
    doubling scan (read from the padded length the filter was given), but
    at 88.2 kHz, where both sides give the degenerate result;
    (b) the length ladder: the 60 s bench MP3 and the bench M4A's frames
    as ADTS at 4 min, 20 min and 2 h, each through analyze_track_internal
    and scan_files (equal); 4 min against the whole reference; 20 min and
    2 h by three 10 s segments of EqualLoudness on the card over the
    card's decode, each against the float64 filter started 1 s before it;
    the 2 h MP3 is over the rows cap and runs as segments;
    (c) a library of 48 distinct files of 2-12 min in five (rate,
    channels) buckets, MP3 and AAC, with the 2 h MP3 and a symlink to it:
    scan_files with a manifest, every track equal to its single-track run
    (window count and loudness exact, peak rtol 2e-4; a window may change
    bins, since cuBLAS rounds a batch of other rows differently).
    The references decode and filter on the CPU in a pool of worker
    processes while the card works. Returns the phase's K1 to K5 launches."""
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from mp3rgain_tpu_torch import aac, analysis, scan
    from mp3rgain_tpu_torch.decode import aac_frontend as af
    from mp3rgain_tpu_torch.decode import class_core as cc
    from mp3rgain_tpu_torch.decode import entropy_kernel as ek
    from mp3rgain_tpu_torch.decode import frontend as fe
    from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
    from mp3rgain_tpu_torch.decode import synthesis as syn
    from mp3rgain_tpu_torch.ops import iir
    from mp3rgain_tpu_torch.ops.coeffs import DEGENERATE_RATES
    from mp3rgain_tpu_torch.parallel import runner as pr
    from mp3rgain_tpu_torch.replaygain import PINK_REF
    from mp3rgain_tpu_torch.testing import make_smoke_data as smoke
    from mp3rgain_tpu_torch.testing import tile

    t_phase = time.perf_counter()
    limit_nb2 = iir.NB2_DENSE_MAX
    dense_limit = limit_nb2 * iir.L2 * iir.DEFAULT_BLOCK  # samples per channel
    runner = pr.Runner(dev)

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    # The padded length each IIR call is given, read by a forward pre-hook
    # on every EqualLoudness module (nothing in the package counts it).
    seen: list[tuple[int, tuple, int]] = []

    def on_iir(module, args):
        if isinstance(module, iir.EqualLoudness):
            seen.append((module.sample_rate, tuple(args[0].shape), id(module)))

    hook = torch.nn.modules.module.register_module_forward_pre_hook(on_iir)
    worst = {"db": 0.0, "peak": 0.0, "seg": 0.0}
    for c in KERNELS:
        c.reset()
    root = tempfile.mkdtemp(prefix="mp3rgain-real-")
    workers = max(1, min(REAL_POOL, os.cpu_count() or 1))
    pool = ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        # --- the inputs: tiled on this host, nothing of it timed ---------------
        t0 = time.perf_counter()
        matrix = []  # (kind, label, path, layout, copies)
        for src in smoke.standard_paths():
            data = read(src)
            layout = tile.mp3_layout(data)
            copies = tile.copies_for(layout, int(REAL_RATE_FACTOR * dense_limit))
            path = os.path.join(root, "rate_" + os.path.basename(src))
            tile.tile_mp3(data, path, copies)
            matrix.append(("mp3", os.path.basename(src), path, layout, copies))
        bench_adts = af.mp4_to_adts(read(os.path.join(smoke.DATA_DIR, smoke.AAC_BENCH_TRACK)))
        aac_srcs = [(smoke.adts_rate_name(sr, ch), read(os.path.join(smoke.ADTS_DIR,
                                                                     smoke.adts_rate_name(sr, ch))))
                    for sr, ch, _ in smoke.ADTS_RATES]
        aac_srcs += [(smoke.AAC_TRANSIENT_TRACK + " as ADTS", af.mp4_to_adts(
            read(os.path.join(smoke.DATA_DIR, smoke.AAC_TRANSIENT_TRACK)))),
                     (smoke.AAC_ADTS_TRACK, read(os.path.join(smoke.DATA_DIR,
                                                              smoke.AAC_ADTS_TRACK)))]
        for label, data in sorted(aac_srcs, key=lambda s: tile.adts_layout(s[1]).sample_rate):
            layout = tile.adts_layout(data)
            want = (int(REAL_DEGENERATE_S * layout.sample_rate)
                    if layout.sample_rate in DEGENERATE_RATES
                    else int(REAL_RATE_FACTOR * dense_limit))
            copies = tile.copies_for(layout, want)
            path = os.path.join(root, f"rate_{layout.sample_rate}_{layout.channels}ch.aac")
            tile.tile_adts(data, path, copies)
            matrix.append(("aac", label, path, layout, copies))
        bench_mp3 = read(os.path.join(smoke.DATA_DIR, smoke.BENCH_TRACK))
        ladder = []  # (kind, label, path, layout, copies)
        for label, copies in REAL_LADDER.items():
            for kind, data, ext in (("mp3", bench_mp3, "mp3"), ("aac", bench_adts, "aac")):
                path = os.path.join(root, f"ladder_{copies}.{ext}")
                layout = (tile.tile_mp3 if kind == "mp3" else tile.tile_adts)(data, path, copies)
                ladder.append((kind, label, path, layout, copies))
        tile_s = time.perf_counter() - t0

        # The references: worker processes decode on the CPU and filter in
        # float64 while the card works; the longest first.
        jobs = [(k, p) for k, _, p, _, _ in matrix]
        jobs += [(k, p) for k, label, p, _, _ in ladder if label == next(iter(REAL_LADDER))]
        sizes = {p: os.path.getsize(p) for _, p in jobs}
        futures = {p: pool.submit(_real_reference, k, p)
                   for k, p in sorted(jobs, key=lambda j: -sizes[j[1]])}

        def reference(path):
            return futures[path].result()

        def iir_call(want_sr):
            calls = [s for s in seen if s[0] == want_sr]
            check(len(calls) == 1, f"one IIR call at {want_sr} Hz, saw {seen}")
            return calls[0][1]

        def hold(line, gain, peak, ref, n_padded, sr):
            diff = gain - ref["gain"]
            rel = abs(peak / ref["peak"] - 1.0) if ref["peak"] else abs(peak)
            nb2, solve = _solve(n_padded, limit_nb2)
            if sr in DEGENERATE_RATES:
                solve = "no solve: degenerate rate, the filter's output is all ones"
            else:
                check(solve == "doubling", f"{line}: the doubling scan ran (padded "
                      f"{n_padded} samples, nb2 {nb2} > {limit_nb2})")
            check(abs(diff) <= ORACLE_DB,
                  f"{line}: card {gain:.4f} dB vs float64 reference {ref['gain']:.4f} dB")
            check(rel <= ORACLE_PEAK_RTOL, f"{line}: card peak {peak:.6f} vs "
                  f"reference {ref['peak']:.6f}")
            worst["db"] = max(worst["db"], abs(diff))
            worst["peak"] = max(worst["peak"], rel)
            print(f"real_library {line}: {ref['sr']} Hz, {ref['channels']} ch, "
                  f"{ref['samples'] / ref['sr']:.1f} s ({ref['samples']} samples), padded "
                  f"{n_padded} samples, nb2 {nb2} ({solve}); card {gain:.4f} dB vs reference "
                  f"{ref['gain']:.4f} dB (the CPU decode), diff {diff:+.4f} dB; peak "
                  f"{peak:.6f} vs {ref['peak']:.6f} (rel {rel:.2e})", flush=True)

        # --- (a) the rate matrix ----------------------------------------------------
        for kind, label, path, layout, copies in matrix:
            data = read(path)
            sr = layout.sample_rate
            what = f"rate {label} x{copies}"
            if kind == "mp3":
                light = fe.unpack_data_light_packed(data)
                nch = light.n_channels
                seen.clear()
                _, louds, peaks = runner.analyze_unpacked_light([light], sr, nch)
                n_light = iir_call(sr)[-1]
                full = fe.unpack_data(data)
                seen.clear()
                h_hist, h_louds, h_peaks = runner.analyze_unpacked([full], sr, nch)
                n_heavy = iir_call(sr)[-1]
                prep, rest, g_lt = pr.prepare_batch_arrays_light([light], nch)
                batch = [pr._to_device(a, dev)
                         for a in (prep.scalars, prep.buf, prep.meta, prep.inv, *rest)]
                lt = pr.analysis_core_light(runner.tail(sr, nch), *batch, nb=prep.nb,
                                            g_max=g_lt, fused=False)
                del batch
                h_idx = np.array([round(v * 100) + 2000 for v in h_louds])
                for a, b, name in zip(lt, (h_hist, h_idx, h_peaks),
                                      ("hist", "loud_idx", "peak")):
                    a = a[:1].cpu().numpy()
                    check(a.shape == b.shape and bool((a == b).all()),
                          f"{what}: light_tail(fused=False) {name} equals the heavy route")
                ref = reference(path)
                check(ref["samples"] == copies * layout.samples,
                      f"{what}: {ref['samples']} decoded samples, {copies} copies")
                hold(f"{what} light route", PINK_REF - float(louds[0]), float(peaks[0]),
                     ref, n_light, sr)
                hold(f"{what} heavy route (light unfused == heavy)",
                     PINK_REF - float(h_louds[0]), float(h_peaks[0]), ref, n_heavy, sr)
            else:
                seen.clear()
                r = aac.analyze_track_internal(path, None, device=dev, runner=runner,
                                               device_prep=True)
                n_q = iir_call(sr)[-1]
                ref = reference(path)
                if sr in DEGENERATE_RATES:
                    windows = int(r.histogram.sum())
                    check(r.result.loudness_db == 0.0 and int(r.histogram[2000]) == windows
                          and windows == ref["windows"] and r.result.gain_db == PINK_REF,
                          f"{what}: every window in bin 2000 on the card ({windows} of "
                          f"{ref['windows']}), loudness {r.result.loudness_db}")
                    check(ref["nan_windows"] >= ref["windows"] - 1,
                          f"{what}: the float64 filter diverges ({ref['nan_windows']} NaN "
                          f"windows of {ref['windows']})")
                    print(f"real_library {what}: degenerate on both sides, as the JAX "
                          f"package gives it: the card files all {windows} windows in bin "
                          f"2000 (loudness 0.00 dB); the float64 filter diverges, "
                          f"{ref['nan_windows']} of {ref['windows']} windows NaN, binned "
                          f"as the JAX package bins them", flush=True)
                hold(f"{what} q route", r.result.gain_db, r.result.peak, ref, n_q, sr)
        check(len(matrix) == 24, f"12 MPEG classes and 12 AAC rates ({len(matrix)})")

        # --- (b) the length ladder ----------------------------------------------------
        longest = list(REAL_LADDER)[-1]
        singles = {}  # path -> (histogram, loudness, gain, peak)
        for kind, label, path, layout, copies in ladder:
            sr = layout.sample_rate
            what = f"ladder {label} {'MP3' if kind == 'mp3' else 'ADTS'} (x{copies})"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seen.clear()
            t0 = time.perf_counter()
            one = analysis.analyze_track_internal(path, device=dev, runner=runner)
            one_s = time.perf_counter() - t0
            mem_gb = torch.cuda.max_memory_allocated() / 1e9
            rows_per = 576 if kind == "mp3" else 1024
            plan = None
            if kind == "mp3":
                rows = layout.frames * copies * (2 if layout.samples_per_frame == 1152 else 1)
                rows *= layout.channels
                plan = pr.segment_plan(rows, sr, layout.channels, pr.ROWS_CAP)
            if plan is None:
                shape = iir_call(sr)
                padded_rows = shape[0] * shape[1] // rows_per
            else:
                # Over the rows cap: one IIR call a segment, in order, each
                # over its own granule-times (its halo's PCM dropped) and
                # within the cap with its halo's rows.
                calls = [c[1] for c in seen if c[0] == sr]
                check(len(calls) == len(plan), f"{what}: one IIR call for each of the "
                      f"{len(plan)} segments, saw {calls}")
                seg_rows = []
                for (a, b), (c, n) in zip(plan, calls):
                    seg_rows.append(c * (n // 576 + min(pr.HALO, a)))
                    check(c == layout.channels and (b - a) * 576 <= n
                          and seg_rows[-1] <= pr.ROWS_CAP,
                          f"{what}: segment [{a}, {b}) ran as ({c}, {n}): "
                          f"{seg_rows[-1]} padded rows, cap {pr.ROWS_CAP}")
                shape = max(calls, key=lambda c: c[1])  # the longest segment's
                padded_rows = sum(seg_rows)
            res = scan.scan_files([path], runner=runner)
            got = res.results[path]
            check(not isinstance(got, Exception), f"{what}: scan_files ({got!r})")
            check((one.result.loudness_db, one.result.gain_db, one.result.peak)
                  == (got.loudness_db, got.gain_db, got.peak)
                  and np.array_equal(one.histogram, res.histograms[path]),
                  f"{what}: analyze_track_internal equals scan_files")
            singles[path] = (one.histogram, one.result.loudness_db, one.result.gain_db,
                             one.result.peak)
            n_padded = shape[-1]
            if kind == "mp3":
                size = (f"{rows} granule-channels ({rows / pr.ROWS_CAP:.2f}x the "
                        f"{pr.ROWS_CAP:,}-row cap), {padded_rows} padded rows"
                        + (f" in {len(plan)} segments of {', '.join(map(str, seg_rows))} "
                           f"(padded samples: the longest's)" if plan else ""))
            else:
                rows = layout.frames * copies * layout.channels
                size = (f"{rows} frame-channel lanes ({rows / pr.AAC_ROWS_CAP:.2f}x the "
                        f"AAC_ROWS_CAP), {padded_rows} padded lanes")
            nb2, solve = _solve(n_padded, limit_nb2)
            line = (f"{what}: analyze_track_internal == scan_files ({one.result.gain_db:.2f} "
                    f"dB, {int(one.histogram.sum())} windows, peak {one.result.peak:.6f}); "
                    f"{size}, padded {n_padded} samples, nb2 {nb2} ({solve}); "
                    f"analyze_track_internal {one_s:.2f} s, peak device memory {mem_gb:.2f} GB")
            check(solve == "doubling", f"{what}: the doubling scan ran")
            if (kind, path) in jobs:
                ref = reference(path)
                hold(f"{what} whole track", one.result.gain_db, one.result.peak, ref,
                     n_padded, sr)
                print(f"real_library {line}", flush=True)
                continue
            # Segments: EqualLoudness on the card over the card's decode,
            # against the float64 filter started REAL_WARMUP_S before each.
            t0 = time.perf_counter()
            if kind == "mp3":
                pcm, sr_d = syn.decode_file(path, device=dev)
            else:
                pcm, sr_d = aac.decode_file_q(path, None, device=dev, runner=runner)
            decode_s = time.perf_counter() - t0
            check(sr_d == sr and pcm.shape[0] == layout.channels
                  and bool(np.isfinite(pcm).all()), f"{what}: card decode")
            x = torch.from_numpy(pcm).to(dev) * 32768.0
            eq = iir.EqualLoudness(sr).to(dev)
            y = eq(x)[0]
            del x, eq
            t = pcm.shape[-1]
            seg, warm = int(REAL_SEGMENT_S * sr), int(REAL_WARMUP_S * sr)
            errs = []
            for start in (0, (t - seg) // 2, t - seg):
                lo = max(0, start - warm)
                want = iir.equal_loudness_scan(
                    pcm[:, lo:start + seg].astype(np.float64) * 32768.0, sr).numpy()
                want = want[:, start - lo:]
                card_seg = y[:, start:start + seg].cpu().numpy().astype(np.float64)
                err = float(np.abs(card_seg - want).max() / np.abs(want).max())
                check(err <= REAL_SEGMENT_TOL, f"{what}: segment at {start / sr:.0f} s, "
                      f"max|card - float64| {err:.2e} of its peak > {REAL_SEGMENT_TOL}")
                errs.append(f"{start / sr:.0f} s {err:.2e}")
                worst["seg"] = max(worst["seg"], err)
            del y
            torch.cuda.empty_cache()
            print(f"real_library {line}; EqualLoudness on the card over the card's decode "
                  f"({decode_s:.1f} s, {t} samples) vs the float64 filter started "
                  f"{REAL_WARMUP_S:.0f} s before each {REAL_SEGMENT_S:.0f} s segment, "
                  f"max|err| / segment peak: {'; '.join(errs)} (limit {REAL_SEGMENT_TOL}; "
                  f"1.2-2.0e-4 on a CPU for float32 at 44.1 kHz)", flush=True)

        # --- (c) a library at real lengths ----------------------------------------------
        sources = {
            ("mp3", "transient"): read(os.path.join(smoke.DATA_DIR, smoke.TRANSIENT_TRACK)),
            ("mp3", "48k"): read(os.path.join(smoke.STANDARD_DIR, "test_48000.mp3")),
            ("mp3", "mono"): read(os.path.join(smoke.DATA_DIR, smoke.MONO_TRACK)),
            ("aac", "bench"): bench_adts,
            ("aac", "48k"): read(os.path.join(smoke.ADTS_DIR,
                                              smoke.adts_rate_name(48000, 2))),
        }
        lib_dir = os.path.join(root, "library")
        os.makedirs(lib_dir)
        lib = []
        lo_min, hi_min = REAL_LIBRARY_MINUTES
        for kind, name, count in REAL_LIBRARY_SOURCES:
            data = sources[(kind, name)]
            layout = (tile.mp3_layout if kind == "mp3" else tile.adts_layout)(data)
            made = set()
            for i in range(count):
                minutes = lo_min + (hi_min - lo_min) * i / max(count - 1, 1)
                copies = max(1, round(minutes * 60 * layout.sample_rate / layout.samples))
                check(copies not in made, f"library {kind} {name}: distinct lengths")
                made.add(copies)
                path = os.path.join(lib_dir, f"{kind}_{name}_{copies}.{kind}")
                (tile.tile_mp3 if kind == "mp3" else tile.tile_adts)(data, path, copies)
                lib.append(path)
        long_mp3 = next(p for k, label, p, _, _ in ladder if k == "mp3" and label == longest)
        long_link = os.path.join(lib_dir, "long_link.mp3")
        os.symlink(long_mp3, long_link)
        singles[long_link] = singles[long_mp3]
        paths = lib + [long_mp3, long_link]
        for p in lib:
            r = analysis.analyze_track_internal(p, device=dev, runner=runner)
            singles[p] = (r.histogram, r.result.loudness_db, r.result.gain_db, r.result.peak)

        retryable = pr._retryable
        halved = []

        def counting(e):
            if retryable(e):
                halved.append(repr(e)[:160])
                return True
            return False

        n_busy = len(runner.busy_ms)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen.clear()
        pr._retryable = counting
        try:
            t0 = time.perf_counter()
            res = scan.scan_files(paths, manifest_path=os.path.join(root, "scan.json"),
                                  runner=runner)
            wall = time.perf_counter() - t0
        finally:
            pr._retryable = retryable
        lib_mem = torch.cuda.max_memory_allocated() / 1e9
        busy = list(runner.busy_ms)[n_busy:]
        calls = list(seen)
        worst_lib = 0.0
        differ: dict[str, int] = {}  # tracks whose histogram is not bit-equal, by type
        moved = 0
        for p in paths:
            got = res.results[p]
            check(not isinstance(got, Exception), f"library {p}: {got!r}")
            hist, loud, gain, peak = singles[p]
            check(int(res.histograms[p].sum()) == int(hist.sum())
                  and (got.loudness_db, got.gain_db) == (loud, gain),
                  f"library {p}: windows and loudness equal the single-track run "
                  f"({int(res.histograms[p].sum())} vs {int(hist.sum())} windows, "
                  f"{got.loudness_db} vs {loud} dB)")
            check(bool(np.isclose(got.peak, peak, rtol=ORACLE_PEAK_RTOL, atol=0)),
                  f"library {p}: peak {got.peak} vs {peak}")
            worst_lib = max(worst_lib, abs(got.peak / peak - 1) if peak else 0.0)
            diff = np.abs(res.histograms[p].astype(np.int64) - hist.astype(np.int64))
            if diff.any():
                kind = os.path.splitext(p)[1][1:].upper()
                differ[kind] = differ.get(kind, 0) + 1
            moved = max(moved, int(diff.sum()) // 2)
        # Batches per bucket, from the IIR calls of the scan.
        owner = {}
        for (sr, nch), t in runner._tails.items():
            owner[id(t.iir)] = ("MP3", sr, nch)
        for (sr, nch), t in runner._aac_tails.items():
            owner[id(t.iir)] = ("AAC", sr, nch)
        per_bucket: dict = {}
        biggest = (0, None)
        for sr, shape, mid in calls:
            key = owner[mid]
            per_bucket[key] = per_bucket.get(key, 0) + 1
            rows = shape[0] * shape[1] // (576 if key[0] == "MP3" else 1024)
            biggest = max(biggest, (rows, key))
            # A segment's IIR leaves out its halo's 2 granule-times.
            check(key[0] != "MP3" or rows <= pr.ROWS_CAP,
                  f"library: an MP3 batch of {rows} rows over the cap ({shape})")
        buckets = "; ".join(f"{c} {s / 1000:g} kHz {n} ch: {k}"
                            for (c, s, n), k in sorted(per_bucket.items()))
        check(len(per_bucket) >= 4 and {c for c, _, _ in per_bucket} == {"MP3", "AAC"},
              f"at least four buckets, MP3 and AAC: {per_bucket}")
        entries = [(key, v) for tails in (runner._tails, runner._aac_tails)
                   for tl in tails.values() for key, v in tl.iir._t3m.items()]
        t3m_mb = sum(v.numel() * v.element_size() for _, v in entries) / 1e6
        audio_h = res.audio_seconds / 3600.0
        print(f"real_library library {card}: scan_files over {len(paths)} files ({len(lib)} "
              f"distinct tiled files of {lo_min:g}-{hi_min:g} min, the {longest} MP3 and a "
              f"symlink to it), {len(calls)} device batches ({buckets}), largest batch "
              f"{biggest[0]} padded rows ({biggest[1][0]} {biggest[1][1] / 1000:g} kHz); "
              f"{audio_h:.3f} audio-hours in {wall:.3f} s ({res.audio_seconds / wall:.0f}x "
              f"real time); device busy {_union_ms(busy) / (wall * 1e3):.1%} of the wall; "
              f"peak device memory {lib_mem:.2f} GB; batches halved on OOM: "
              f"{len(halved)}{' (' + '; '.join(halved) + ')' if halved else ''}; every "
              f"track equals its single-track run (window counts and loudness exact, max "
              f"peak rel diff {worst_lib:.2e}; histograms not bit-equal: "
              f"{sum(differ.values())} of {len(paths)}{f' {differ}' if differ else ''}, at most {moved} "
              f"windows in another bin); dense level-2 operators cached in the Runner: "
              f"{len(entries)} entries, {t3m_mb:.1f} MB", flush=True)
    finally:
        hook.remove()
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(root, ignore_errors=True)

    launches = {c.name: c.kernel for c in KERNELS}
    plain = plain_calls()
    check(all(v >= 1 for v in launches.values()) and plain == 0,
          f"real_library: K0 to K5 launched ({launches}), no plain call ({plain})")
    del runner
    torch.cuda.empty_cache()
    ref_s = [f.result()["s"] for f in futures.values()]
    print(f"real_library phase {card}: wall {time.perf_counter() - t_phase:.1f} s (tiling "
          f"{tile_s:.1f} s; {len(ref_s)} references decoded and filtered on the CPU by "
          f"{workers} worker processes, {sum(ref_s):.1f} s of work, "
          f"{max(ref_s):.1f} s the longest); "
          f"{len(matrix)} rate-matrix tracks and the 4 min tracks within {worst['db']:.4f} dB "
          f"(budget {ORACLE_DB}) and peak rel {worst['peak']:.2e} (rtol {ORACLE_PEAK_RTOL}) "
          f"of the float64 reference; segments within {worst['seg']:.2e} of their peak "
          f"(limit {REAL_SEGMENT_TOL}); launches {launches}", flush=True)
    return launches


def main() -> None:
    import numpy as np
    import torch

    from mp3rgain_tpu_torch.device import card_label, cuda_ms, require_cuda

    # --- 1. device -----------------------------------------------------------
    dev = require_cuda()
    name = torch.cuda.get_device_name(0)
    smi = card_label()
    card = f"[{smi}]"
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}", flush=True)

    from mp3rgain_tpu_torch import _build, analysis, lane_plan, native
    from mp3rgain_tpu_torch.decode import class_core as cc
    from mp3rgain_tpu_torch.decode import entropy_kernel as ek
    from mp3rgain_tpu_torch.decode import frontend as fe
    from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
    from mp3rgain_tpu_torch.decode import synthesis as syn
    from mp3rgain_tpu_torch.parallel import runner as pr
    from mp3rgain_tpu_torch.testing import craft
    from mp3rgain_tpu_torch.testing import make_smoke_data as smoke
    from mp3rgain_tpu_torch.tools import hk_dotprobe

    torch.set_num_threads(min(8, os.cpu_count() or 1))

    # --- 2. build ------------------------------------------------------------
    # The host library (g++) builds in a thread while nvcc builds the kernels.
    host = {}

    def build_host():
        t = time.perf_counter()
        try:
            native.build(force=True)
            lane_plan.build(force=True)
        except Exception as e:  # re-raised below
            host["error"] = e
        host["s"] = time.perf_counter() - t

    gxx = threading.Thread(target=build_host)
    gxx.start()
    nvcc_s = _build.build(force=True)
    gxx.join()
    if "error" in host:
        raise host["error"]
    native._lib.load()
    lane_plan._lib.load()
    k3_smem = _build.library().mg_cuda_class_core_gemm_smem_bytes()
    resources = {}  # kernel -> its distinct ptxas register, smem and spill lines
    entry = None
    for ln in _build.build_log.splitlines():
        if "Compiling entry function" in ln:
            # K1's two small row-fill passes (mark_rows, zero_rows) are not
            # listed; K2 has one entry per channel count.
            entry = ("K0" if "lane_pack_kernel" in ln else
                     "K1" if "entropy_decode_rows_kernel" in ln else
                     "K2" if "requant_stereo_kernel" in ln else
                     "K3" if "class_core_gemm_wgmma" in ln else
                     "K4" if "hybrid_synthesis_kernel" in ln else
                     "K5" if "overlap_polyphase_kernel" in ln else None)
        elif entry and ("registers" in ln or "spill" in ln):
            line = " ".join(ln.replace("ptxas info    :", "").split())
            if line not in resources.setdefault(entry, []):
                resources[entry].append(line)
    check(set(resources) == {"K0", "K1", "K2", "K3", "K4", "K5"},
          f"ptxas reported K0 to K5: {sorted(resources)}")
    resources["K3"].append(f"{k3_smem} bytes dynamic smem")
    regs = [f"{k}: {', '.join(v)}" for k, v in sorted(resources.items())]
    print(f"build: host libraries g++ {host['s']:.2f} s; K0 to K5 nvcc {nvcc_s:.2f} s "
          f"({'; '.join(regs)})", flush=True)

    # --- 3. inputs -----------------------------------------------------------
    def read(fname):
        with open(os.path.join(smoke.DATA_DIR, fname), "rb") as f:
            return f.read()

    bench = read(smoke.BENCH_TRACK)
    clips = [os.path.join(smoke.DATA_DIR, f)
             for f in (smoke.BENCH_TRACK, smoke.MONO_TRACK, smoke.TRANSIENT_TRACK)]
    u = fe.unpack_data_light_packed(bench)
    full = fe.unpack_data(bench)
    check(u.n == full.n and u.sample_rate == 44100 and u.n_channels == 2,
          "bench track unpacks as 44.1 kHz stereo")
    track_s = (u.n // u.n_channels) * 576 / u.sample_rate
    audio_s = BATCH_TRACKS * track_s
    streams = {
        "mono_22k": read(smoke.MONO_TRACK),
        "transient": read(smoke.TRANSIENT_TRACK),
        "truncated": read(smoke.TRANSIENT_TRACK)[:24000],
        "craft_intensity": craft.craft_intensity_stream(),
        "craft_mixed_block": craft.craft_mixed_block_stream(),
        "craft_count1b": craft.craft_count1b_stream(),
        "craft_scalefactor": craft.craft_scalefactor_stream(
            scf=[3, 2, 1, 4, 5, 6, 7, 0, 1, 2, 3] + [1, 2, 3, 0, 1, 2, 3, 0, 1, 2],
            preflag=1, scfsi=0b1010),
        "craft_lsf_intensity": craft.craft_lsf_intensity_stream(),
    }
    print(f"inputs: {BATCH_TRACKS} x {track_s:.2f} s bench track "
          f"({len(bench)} bytes, {u.n} granule-channels each), "
          f"{len(streams)} K1 streams", flush=True)

    luts = ek.EntropyLuts().to(dev)

    def to_dev(arrs):
        return [pr._to_device(a, dev) for a in arrs]

    # --- 4. K1: CUDA kernel against the plain version -------------------------
    def k1_compare(args, dest, n_rows):
        got = ek.decode_rows(*args, luts, dest, n_rows)
        want = ek.decode_rows_reference(*args, luts, dest, n_rows)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "K1 spec_rows/big_end/count1_end equal the plain version")
        err = max((g.int() - w.int()).abs().max().item() if g.numel() else 0
                  for g, w in zip(got, want))
        return got, err

    def host_equal(rows, host, n_tracks):
        """Rows in input order of n_tracks copies equal the host decoder."""
        spec, big_end, c1end = rows
        n = host.n
        valid = torch.from_numpy(host.info[:, fe.VALID] == 1).to(dev)
        want = torch.from_numpy(host.spectrum).to(dev)
        got = spec[: n * n_tracks].view(n_tracks, n, 576).int()
        diff = ((got != want[None]).any(dim=2) & valid[None]).sum().item()
        check(diff == 0, f"{diff} unsorted spectra equal the host decoder")
        for field, got_f in ((fe.BIG_END, big_end), (fe.COUNT1_END, c1end)):
            w = torch.from_numpy(host.info[:, field]).to(dev)
            g = got_f[: n * n_tracks].view(n_tracks, n)
            check(bool(((g == w[None]) | ~valid[None]).all()),
                  "big_end/count1_end equal the host decoder")

    k1_err = 0
    for label, data in streams.items():
        light = fe.unpack_data_light(data)
        check(light.n > 0, f"{label} has granules")
        p = ek.prepare_batch(light.md, light.meta)
        args = to_dev((p.scalars, p.buf, p.meta, p.inv))
        rows, err = k1_compare(args[:3], ek.input_order_dest(args[3], p.n), p.n)
        k1_err = max(k1_err, err)
        host_equal(rows, fe.unpack_data(data), 1)

    prep, rest, g_max = pr.prepare_batch_arrays_light([u] * BATCH_TRACKS, 2)
    batch = to_dev((prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
    nb = prep.nb
    rows, err = k1_compare(batch[:3], ek.input_order_dest(batch[3], prep.n), prep.n)
    k1_err = max(k1_err, err)
    host_equal(rows, full, BATCH_TRACKS)
    del rows
    # The main path's map: K2's channel-major rows, with padding slots.
    dest, n_rows = pr.dest_rows(batch[3], batch[4], g_max=g_max, n_channels=2,
                                channel_major=True)
    rows_cm, err = k1_compare(batch[:3], dest, n_rows)
    k1_err = max(k1_err, err)
    # K1's integer decode steps have no rate in the published table: its
    # bound counts bytes only (inputs with the row map, tables, outputs).
    k1_bound = bound_of(nbytes(*batch[:3], dest, *rows_cm) + nbytes(*luts.buffers()))
    k1_ms = cuda_ms(lambda: ek.decode_rows(*batch[:3], luts, dest, n_rows), 10)
    k1_plain_ms = cuda_ms(
        lambda: ek.decode_rows_reference(*batch[:3], luts, dest, n_rows), 2)
    print(f"K1 entropy_decode_rows (CUDA C++): exact against the plain version on "
          f"{len(streams)} streams and the {BATCH_TRACKS}-track batch "
          f"(nb={nb}, {nb * ek.LANES} lanes; input-order rows and {n_rows} "
          f"channel-major rows), input-order rows equal the host decoder; kernel "
          f"{k1_ms:.3f} ms, plain {k1_plain_ms:.1f} ms, bound {k1_bound[0]:.3f} ms "
          f"({k1_bound[1]}; {k1_bound[0] / k1_ms:.1%} of it) {card}", flush=True)

    # --- 4b. K0: the lane pack at the rows cap against its plain version -------
    # The bench track's rows to SYNTH_ROWS (a rescan batch at the rows cap),
    # planned and copied in walk order on the host; K0 must rebuild what the
    # host pack (prepare_batch) gives.
    reps, rem = divmod(SYNTH_ROWS, u.n)
    k0_rows = ([u.md] * reps + [u.md[:rem]], [u.meta] * reps + [u.meta[:rem]])
    c = ek.prepare_batch_compact(*k0_rows, quantize_nb=True)
    host_pack = ek.prepare_batch(*k0_rows, quantize_nb=True)
    k0_args = to_dev((c.scalars, c.words, c.word_off, c.meta, c.order))
    k0_shapes = {"g_real": c.g_real, "g_pad": c.g_pad}
    got = ek.lane_pack(*k0_args, **k0_shapes)
    want = ek.lane_pack_reference(*k0_args, **k0_shapes)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "K0 buf and meta equal the plain version")
    check(torch.equal(got[0][: c.g_real].cpu(), torch.from_numpy(host_pack.buf[: c.g_real]))
          and torch.equal(got[1].cpu(), torch.from_numpy(host_pack.meta.view(np.int16))),
          "K0 buf and meta equal the host pack")
    del want, host_pack
    k0_bound = bound_of(nbytes(*k0_args, *got))
    k0_ms = cuda_ms(lambda: ek.lane_pack(*k0_args, **k0_shapes), 10)
    k0_plain_ms = cuda_ms(lambda: ek.lane_pack_reference(*k0_args, **k0_shapes), 2)
    # The same gather as one PyTorch indexing call, byte swap aside: each
    # buffer word's index in the compact words (the zero past them for none).
    order_l = k0_args[4].long()
    real = order_l < c.n
    offs = k0_args[2].long()
    start = torch.where(real, offs[torch.where(real, order_l, 0)], 0)
    cnt = torch.where(real, offs[torch.where(real, order_l + 1, 0)] - start, 0)
    lane = torch.arange(c.nb * ek.LANES, device=dev)
    sg_off = k0_args[0][:, 3:].reshape(-1).long()
    w8 = torch.diff(sg_off, append=sg_off.new_tensor([c.g_real]))[lane // ek.SUBG]
    base = sg_off[lane // ek.SUBG] * 8 * ek.SUBG + lane % ek.SUBG
    src = torch.full((c.g_pad * 8 * ek.SUBG,), len(c.words), dtype=torch.int64, device=dev)
    for k in range(int(w8.max()) * 8):
        line = k < w8 * 8
        src[(base + k * ek.SUBG)[line]] = torch.where(k < cnt, start + k, len(c.words))[line]
    words_z = torch.cat([k0_args[1], k0_args[1].new_zeros(1)])
    index_ms = cuda_ms(lambda: words_z[src], 10)
    del order_l, real, offs, start, cnt, lane, base, src, words_z, got
    print(f"K0 lane_pack (CUDA C++): exact against the plain version and the host "
          f"pack at {c.n} rows (nb={c.nb}, {c.g_real} of {c.g_pad} word-groups, "
          f"{len(c.words)} compact words); kernel {k0_ms:.4f} ms, plain "
          f"{k0_plain_ms:.1f} ms, one indexing call (words[src]) {index_ms:.4f} ms, "
          f"bound {k0_bound[0]:.4f} ms ({k0_bound[1]}; {k0_bound[0] / k0_ms:.1%} of it) "
          f"{card}", flush=True)
    del k0_args, c

    # --- 5. K2: CUDA kernel against the plain version -------------------------
    tail = pr.LightTail(44100, 2).to(dev)
    cm = pr.channel_major_inputs(*rows_cm, *batch[4:11], nb=nb, g_max=g_max,
                                 n_channels=2)
    del rows_cm
    xr = hk.fused_requant_stereo(*cm, tail.hybrid)
    ref = hk.fused_requant_stereo_reference(*cm, tail.hybrid)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    k2_err = (xr - ref).abs().max().item()
    check(bool(torch.isfinite(xr).all()) and scale > 0, "K2 output finite")
    check(torch.allclose(xr, ref, rtol=K2_RTOL, atol=K2_ATOL_REL * scale),
          f"K2 within rtol {K2_RTOL}, atol {K2_ATOL_REL}*max|ref|")
    del xr, ref
    k2_ms = cuda_ms(lambda: hk.fused_requant_stereo(*cm, tail.hybrid), 10)
    k2_plain_ms = cuda_ms(
        lambda: hk.fused_requant_stereo_reference(*cm, tail.hybrid), 3)
    rows = cm[0].shape[1]
    gbytes = (nbytes(*cm) + 2 * rows * 576 * 4) / 1e9  # inputs + f32 output
    k2_bound = bound_of(gbytes * 1e9)
    print(f"K2 requant_stereo (CUDA C++): rows {rows} x 2 channels, max_abs_err "
          f"{k2_err:.3e} of max|ref| {scale:.1f} (rtol {K2_RTOL}, atol "
          f"{K2_ATOL_REL}*max|ref|); kernel {k2_ms:.3f} ms "
          f"({gbytes / (k2_ms / 1e3):.0f} GB/s), plain {k2_plain_ms:.3f} ms, bound "
          f"{k2_bound[0]:.3f} ms ({k2_bound[1]}; {k2_bound[0] / k2_ms:.1%} of it) "
          f"{card}", flush=True)
    # --- 5b. K4 and K5 at the rows cap: kernels against their plain versions ---
    # K2's rows of the batch, repeated to SYNTH_ROWS (2 channels x 128 tracks
    # x 2,500 granule-times, a library scan batch's size).
    xr = hk.fused_requant_stereo(*cm, tail.hybrid)
    idx = torch.arange(SYNTH_ROWS // 2, device=dev) % rows
    xr, gm = xr[:, idx].contiguous(), cm[2][:, idx].contiguous()
    del cm, batch, dest
    got = hk.hybrid_synthesis(xr, gm, tail.hybrid)
    z = hk.hybrid_gemm(xr, gm, tail.hybrid)
    torch.cuda.synchronize()
    k4_scale = z.abs().max().item()
    k4_err = (got - z).abs().max().item()
    check(torch.allclose(got, z, rtol=K2_RTOL, atol=K2_ATOL_REL * k4_scale),
          f"K4 within rtol {K2_RTOL}, atol {K2_ATOL_REL}*max|plain| at {SYNTH_ROWS} rows")
    del got
    z = z.view(2, 128, SYNTH_ROWS // 256, 1152)
    got = syn.overlap_polyphase(z, tail.decode)
    want = syn.overlap_polyphase_reference(z, tail.decode)
    torch.cuda.synchronize()
    k5_scale = want.abs().max().item()
    k5_err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=K2_RTOL, atol=K2_ATOL_REL * k5_scale),
          f"K5 within rtol {K2_RTOL}, atol {K2_ATOL_REL}*max|plain| at {SYNTH_ROWS} rows")
    del got, want
    torch.cuda.empty_cache()

    def dense_hybrid():
        """The plain version's three torch.matmul products on operands
        masked beforehand (not timed): its library calls alone."""
        cls = gm[..., hk.GM_CLS : hk.GM_CLS + 1]
        lane = torch.arange(576, device=dev)
        ops = [(torch.where(cls == 0, xr, 0.0), tail.hybrid.cores2[0]),
               (torch.where((cls == 1) | ((cls == 2) & (lane >= tail.hybrid.p)), xr, 0.0),
                tail.hybrid.cores2[1]),
               (torch.where(cls == 2, xr[..., :tail.hybrid.p], 0.0).contiguous(),
                tail.hybrid.head)]
        return lambda: [torch.matmul(a, b) for a, b in ops]

    def dense_polyphase():
        """The plain version's two torch.matmul products on out18 and its
        shifted copy, made beforehand (not timed)."""
        out18 = z[..., :576].clone()
        out18[:, :, 1:] += z[:, :, :-1, 576:]
        prev18 = torch.cat([torch.zeros_like(out18[:, :, :1]), out18[:, :, :-1]], dim=2)
        return lambda: (torch.matmul(out18, tail.decode.synth_na),
                        torch.matmul(prev18, tail.decode.synth_nb))

    synth_ms = {}
    for name, fn in (("K4", lambda: hk.hybrid_synthesis(xr, gm, tail.hybrid)),
                     ("K4 plain", lambda: hk.hybrid_gemm(xr, gm, tail.hybrid)),
                     ("K4 library", dense_hybrid()),
                     ("K5", lambda: syn.overlap_polyphase(z, tail.decode)),
                     ("K5 plain", lambda: syn.overlap_polyphase_reference(z, tail.decode)),
                     ("K5 library", dense_polyphase())):
        synth_ms[name] = cuda_ms(fn, 3 if " " in name else 10)
        del fn
        torch.cuda.empty_cache()
    # Operations: K4 a subband's 36 x 18 map, 31 boundaries of 8 butterflies
    # (4 ops each) and the window; K5 per slot the 64 x 32 matrixing and
    # the 32 x 16 dewindow.
    k4_bound = bound_of(nbytes(xr, gm) + SYNTH_ROWS * 1152 * 4,
                        SYNTH_ROWS * (2 * 32 * 36 * 18 + 31 * 8 * 4 + 1152), F32_FLOPS_PER_S)
    k5_bound = bound_of(nbytes(z) + SYNTH_ROWS * 576 * 4,
                        SYNTH_ROWS * 18 * 2 * (64 * 32 + 32 * 16), F32_FLOPS_PER_S)
    for k, bound, err, scale in (("K4", k4_bound, k4_err, k4_scale),
                                 ("K5", k5_bound, k5_err, k5_scale)):
        what = ("hybrid_synthesis" if k == "K4" else "overlap_polyphase")
        print(f"{k} {what} (CUDA C++): {SYNTH_ROWS} rows, max_abs_err {err:.3e} of "
              f"max|plain| {scale:.1f} (rtol {K2_RTOL}, atol {K2_ATOL_REL}*max|plain|); "
              f"kernel {synth_ms[k]:.3f} ms, plain {synth_ms[k + ' plain']:.3f} ms, "
              f"library (its torch.matmul products) {synth_ms[k + ' library']:.3f} ms, "
              f"bound {bound[0]:.3f} ms ({bound[1]}; {bound[0] / synth_ms[k]:.1%} of it) "
              f"{card}", flush=True)
    del xr, gm, z
    torch.cuda.empty_cache()

    # --- 6. K3: CUDA kernel against the plain version -------------------------
    def k3_compare(x, chi, clo, row_core):
        got = cc.class_core_gemm(x, chi, clo, row_core=row_core)
        want = cc.class_core_gemm_reference(x, chi, clo, row_core=row_core)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()) and scale > 0, "K3 output finite")
        check(torch.allclose(got, want, rtol=K3_RTOL, atol=K3_ATOL_REL * scale),
              f"K3 within rtol {K3_RTOL}, atol {K3_ATOL_REL}*max|plain| "
              f"(max_abs_err {err:.3e} of {scale:.3e})")
        del got, want
        p_ms = cuda_ms(lambda: cc.class_core_gemm_reference(
            x, chi, clo, row_core=row_core), 2)
        return err, scale, p_ms

    def k3_times(x, chi, clo, row_core, cores):
        """The kernel and its yardstick timed in turns (kernel, library,
        library, kernel; 5 calls each), as {name: [ms, ms]}. The
        yardstick: one cuBLAS bf16 GEMM, torch.mm([xh | xh | xl] per core,
        [chi_k; clo_k; chi_k] per core, out_dtype=f32), K = 1728 per core,
        on operands split and concatenated before and not timed. The port
        never calls it."""
        xh, xl = cc.split_bf16(x.reshape(-1, 576))
        a = torch.cat([xh, xh, xl] * len(cores), dim=1)
        b = torch.cat([t for k in cores for t in (chi[k], clo[k], chi[k])], dim=0)
        del xh, xl
        fns = {"kernel": lambda: cc.class_core_gemm(x, chi, clo, row_core=row_core),
               "library": lambda: torch.mm(a, b, out_dtype=torch.float32)}
        ms = {"kernel": [], "library": []}
        for name in ("kernel", "library", "library", "kernel"):
            ms[name].append(cuda_ms(fns[name], 5))
        del a, b, fns
        torch.cuda.empty_cache()
        return ms

    def turns(v):
        return f"{sum(v) / len(v):.3f} ms (turns {', '.join(f'{t:.3f}' for t in v)})"

    def k3_bound(x, chi, clo, row_core):
        """K3's bound on this run's data: each row's own cores' 3 passes
        (all cores when row_core is None), x and z once, the cores the
        rows select once."""
        c, r = x.shape[:2]
        used = range(chi.shape[0]) if row_core is None else [
            k for k in range(chi.shape[0]) if bool((row_core == k).any())]
        products = c * r * len(used) if row_core is None else int(
            ((row_core >= 0) & (row_core < chi.shape[0])).sum())
        flops = 2 * 3 * products * 576 * 1152
        n = nbytes(x) + c * r * 1152 * 4 + 2 * len(used) * nbytes(chi[0])
        if row_core is not None:
            n += nbytes(row_core)
        return bound_of(n, flops)

    # (a) the TPU probe's shape and inputs: 2 channels, 3 cores summed, 3 passes.
    x, chi, clo = (t.to(dev) for t in hk_dotprobe.make_inputs(PROBE_ROWS, 3))
    k3p_err, k3p_scale, k3p_plain_ms = k3_compare(x, chi, clo, None)
    k3p_t = k3_times(x, chi, clo, None, [0, 1, 2])
    k3p_ms, k3p_lib_ms = (sum(v) / len(v) for v in (k3p_t["kernel"], k3p_t["library"]))
    k3p_bound = k3_bound(x, chi, clo, None)
    fl = hk_dotprobe.flops(PROBE_ROWS, 3, 3)
    print(f"K3 class_core_gemm (CUDA C++ wgmma + TMA), probe shape R={PROBE_ROWS} x 2 "
          f"channels, NCORE 3, NPASS 3: max_abs_err {k3p_err:.3e} of max|plain| "
          f"{k3p_scale:.3e}; kernel {turns(k3p_t['kernel'])} "
          f"({fl / k3p_ms / 1e9:.1f} TFLOP/s), plain {k3p_plain_ms:.3f} ms "
          f"({fl / k3p_plain_ms / 1e9:.1f} TFLOP/s), library torch.mm K=5184 "
          f"{turns(k3p_t['library'])}, bound {k3p_bound[0]:.3f} ms "
          f"({k3p_bound[1]}; {k3p_bound[0] / k3p_ms:.1%} of it) {card}", flush=True)
    # (b) the host-decoded route's shape: the batch's 64 x g_max records as
    # one channel, the real decode cores, each record's layout class.
    cls = syn._classes(syn.batch_from_unpacked(full, dev).kind, tail.decode)
    cls = np.pad(cls[0].cpu().numpy(), (0, g_max - full.n))
    row_core = torch.from_numpy(np.tile(cls, BATCH_TRACKS)[None].astype(np.int32)).to(dev)
    x = x.view(1, -1, 576)
    check(x.shape[1] == row_core.shape[1], "heavy shape: 64 x g_max records")
    k3_err, k3_scale, k3_plain_ms = k3_compare(
        x, tail.decode.chi, tail.decode.clo, row_core)
    # The library call runs the long core for every row (one call cannot
    # select per row; 99.93% of this batch's rows are long).
    k3_t = k3_times(x, tail.decode.chi, tail.decode.clo, row_core, [0])
    k3_ms, k3_lib_ms = (sum(v) / len(v) for v in (k3_t["kernel"], k3_t["library"]))
    k3h_bound = k3_bound(x, tail.decode.chi, tail.decode.clo, row_core)
    heavy_rows = x.shape[1]
    fl_h = 2 * 3 * heavy_rows * 576 * 1152
    shares = np.bincount(cls, minlength=3) / len(cls)
    print(f"K3 class_core_gemm (CUDA C++ wgmma + TMA), heavy shape R={heavy_rows} x 1 "
          f"channel, row_core classes long/short/mixed {shares.round(4).tolist()}: "
          f"max_abs_err {k3_err:.3e} of max|plain| {k3_scale:.3e}; kernel "
          f"{turns(k3_t['kernel'])} ({fl_h / k3_ms / 1e9:.1f} TFLOP/s useful), plain "
          f"{k3_plain_ms:.3f} ms, library torch.mm K=1728 {turns(k3_t['library'])}, "
          f"bound {k3h_bound[0]:.3f} ms "
          f"({k3h_bound[1]}; {k3h_bound[0] / k3_ms:.1%} of it) {card}", flush=True)
    del x, chi, clo, row_core
    torch.cuda.empty_cache()

    # --- 6b. hostile input through K1, K2, K3 and the AAC route ----------------
    # Every later phase runs in this process after it.
    hostile_phase(dev, card, luts, clips)
    torch.cuda.empty_cache()

    # --- 7. the light main path at full size -----------------------------------
    runner = pr.Runner(dev)
    for _ in range(2):  # warm-up, once per pinned staging slot
        runner.analyze_unpacked_light([u] * BATCH_TRACKS, 44100, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in KERNELS:
        c.reset()
    # The lane-major decode and its unsort are off the main path now: make
    # any call of them fail the run (the spectrum row gathers are gone
    # from the code).
    off_path = {f: getattr(ek, f) for f in ("decode_blocks_reference", "unsort_blocks")}
    for f in off_path:
        setattr(ek, f, lambda *a, f=f, **k: check(False, f"{f} ran on the main path"))
    try:
        t0 = time.perf_counter()
        hist, louds, peaks = runner.analyze_unpacked_light([u] * BATCH_TRACKS, 44100, 2)
        wall_s = time.perf_counter() - t0
    finally:
        for f, fn in off_path.items():
            setattr(ek, f, fn)
    counts = {c.name: c.kernel for c in LIGHT}
    n_plain = plain_calls()
    timing = runner.timings[-1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(v == 1 for v in counts.values()),
          f"K0, K1, K2, K4 and K5 launched once: {counts}")
    check(n_plain == 0, f"no plain-version calls on CUDA ({n_plain})")
    check(hist.shape == (BATCH_TRACKS, 12000), "histogram shape")
    check(bool(np.isfinite(louds).all() and np.isfinite(peaks).all()),
          "finite loudness and peak")
    win_counts = hist.sum(axis=1)

    cpu_hist, cpu_louds, cpu_peaks = pr.Runner("cpu").analyze_unpacked_light(
        [u], 44100, 2)
    idx = [round(v * 100) + 2000 for v in (louds[0], cpu_louds[0])]
    check(int(win_counts[0]) == int(cpu_hist.sum()), "window counts equal CPU")
    check(abs(idx[0] - idx[1]) <= 2, f"loudness index within 2 bins of CPU {idx}")
    check(bool(np.allclose(peaks[0], cpu_peaks[0], rtol=2e-4, atol=1e-6)),
          f"peak within rtol 2e-4 of CPU ({peaks[0]} vs {cpu_peaks[0]})")
    print(f"slice: Runner.analyze_unpacked_light {BATCH_TRACKS} x {track_s:.2f} s "
          f"on {dev}: launches {counts}, plain calls {n_plain}, unsort and "
          f"lane-major decode calls 0; track 0 "
          f"gain {64.82 - louds[0]:.2f} dB, peak {peaks[0]:.6f}, windows "
          f"{int(win_counts[0])} vs CPU gain {64.82 - cpu_louds[0]:.2f} dB, "
          f"peak {cpu_peaks[0]:.6f}, windows {int(cpu_hist.sum())}", flush=True)

    # The light device phase by stage: CUDA events recorded as each stage
    # of analysis_core_light_compact has been enqueued, median of 3 runs.
    prep, rest, g_lt = pr.prepare_batch_arrays_light_compact([u] * BATCH_TRACKS, 2)
    batch = to_dev((prep.scalars, prep.words, prep.word_off, prep.meta, prep.order,
                    prep.inv) + tuple(rest))
    runs = []
    for _ in range(3):
        events = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        torch.cuda.synchronize()
        mark("start")
        pr.analysis_core_light_compact(runner.tail(44100, 2), *batch, nb=prep.nb,
                                       g_max=g_lt, g_real=prep.g_real, g_pad=prep.g_pad,
                                       on_stage=mark)
        torch.cuda.synchronize()
        runs.append({st: a.elapsed_time(b)
                     for (_, a), (st, b) in zip(events, events[1:])})
    del batch
    stage_ms = {st: float(np.median([r[st] for r in runs])) for st in runs[0]}
    stage_ms["gathers"] += stage_ms.pop("row map")
    order = ["lane pack", "K1", "gathers", "K2", "hybrid GEMMs", "overlap-add + polyphase",
             "IIR", "histogram + index", "peak"]
    check(sorted(order) == sorted(stage_ms), f"stages {sorted(stage_ms)}")
    total_ms = sum(stage_ms.values())
    print(f"light stages {card} (CUDA events, median of 3; gathers = row map + "
          f"scalefactor/info/gmeta gathers): " + "; ".join(
              f"{st} {stage_ms[st]:.3f} ms ({stage_ms[st] / total_ms:.1%})" for st in order)
          + f"; sum {total_ms:.3f} ms", flush=True)

    # --- 8. the host-decoded route at full size ---------------------------------
    for _ in range(2):  # warm-up, once per pinned staging slot
        runner.analyze_unpacked([full] * BATCH_TRACKS, 44100, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in KERNELS:
        c.reset()
    t0 = time.perf_counter()
    h_hist, h_louds, h_peaks = runner.analyze_unpacked([full] * BATCH_TRACKS, 44100, 2)
    h_wall_s = time.perf_counter() - t0
    h_counts = {"class_core_gemm": K3.kernel}
    h_plain = plain_calls()
    h_timing = runner.timings[-1]
    h_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(h_counts["class_core_gemm"] > 0, f"K3 launched on the heavy route: {h_counts}")
    check(h_plain == 0, f"no plain-version calls on CUDA ({h_plain})")
    check(h_hist.shape == (BATCH_TRACKS, 12000), "heavy histogram shape")
    check(bool(np.isfinite(h_louds).all() and np.isfinite(h_peaks).all()),
          "finite heavy loudness and peak")
    h_win = h_hist.sum(axis=1)
    c_hist, c_louds, c_peaks = pr.Runner("cpu").analyze_unpacked([full], 44100, 2)
    h_idx = np.array([round(v * 100) + 2000 for v in h_louds])
    c_idx = round(c_louds[0] * 100) + 2000
    l_idx = np.array([round(v * 100) + 2000 for v in louds])
    check(int(h_win[0]) == int(c_hist.sum()), "heavy window counts equal CPU")
    check(abs(int(h_idx[0]) - c_idx) <= 2, f"heavy index within 2 bins of CPU "
          f"({h_idx[0]} vs {c_idx})")
    check(bool(np.allclose(h_peaks[0], c_peaks[0], rtol=2e-4, atol=1e-6)),
          f"heavy peak within rtol 2e-4 of CPU ({h_peaks[0]} vs {c_peaks[0]})")
    check(bool((h_win == win_counts).all()), "heavy window counts equal light's")
    check(bool((np.abs(h_idx - l_idx) <= 2).all()), "heavy index within 2 bins of light")
    check(bool(np.allclose(h_peaks, peaks, rtol=2e-4, atol=1e-6)),
          "heavy peak within rtol 2e-4 of light")
    print(f"heavy slice: Runner.analyze_unpacked {BATCH_TRACKS} x {track_s:.2f} s on "
          f"{dev}: launches {h_counts}, plain calls {h_plain}; track 0 index "
          f"{h_idx[0]}, peak {h_peaks[0]:.6f}, windows {int(h_win[0])} vs CPU index "
          f"{c_idx}, peak {c_peaks[0]:.6f}, windows {int(c_hist.sum())}; vs light: "
          f"max index diff {int(np.abs(h_idx - l_idx).max())}, max peak rel diff "
          f"{float(np.abs(h_peaks / peaks - 1).max()):.2e}", flush=True)

    # The unfused light tail feeds the same analysis_tail: exactly equal.
    prep, rest, g_lt = pr.prepare_batch_arrays_light([u] * BATCH_TRACKS, 2)
    batch = to_dev((prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
    lt = pr.analysis_core_light(runner.tail(44100, 2), *batch, nb=prep.nb,
                                g_max=g_lt, fused=False)
    del batch
    lt = [t[:BATCH_TRACKS].cpu().numpy() for t in lt]
    for a, b, what in zip(lt, (h_hist, h_idx, h_peaks), ("hist", "loud_idx", "peak")):
        check(a.shape == b.shape and bool((a == b).all()),
              f"light_tail(fused=False) {what} equals the heavy route exactly")
    print(f"light unfused == heavy on {dev}: hist, loud_idx and peak exactly equal "
          f"over {BATCH_TRACKS} tracks", flush=True)
    del lt
    torch.cuda.empty_cache()

    dec = []
    for fname in (smoke.MONO_TRACK, smoke.TRANSIENT_TRACK):
        path = os.path.join(smoke.DATA_DIR, fname)
        got, sr_g = syn.decode_file(path, device=dev)
        want, sr_w = syn.decode_file(path, device="cpu")
        bound = 5e-4 * float(np.sqrt((want ** 2).mean())) + 1e-5
        err = float(np.abs(got - want).max())
        check(sr_g == sr_w and got.shape == want.shape and err < bound,
              f"decode_file {fname} on the card vs CPU ({err:.3e} >= {bound:.3e})")
        dec.append(f"{fname} {got.shape} max|err| {err:.2e} (bound {bound:.2e})")
    print(f"decode_file (cuda vs cpu): {'; '.join(dec)}", flush=True)

    gains = []
    for path in clips:
        r = analysis.analyze_track_internal(path, device=dev).result
        r_cpu = analysis.analyze_track_internal(path, device="cpu").result
        check(abs(r.gain_db - r_cpu.gain_db) <= 0.02, f"{path} gain vs CPU")
        gains.append(f"{os.path.basename(path)} {r.gain_db:.2f} dB "
                     f"(peak {r.peak:.4f})")
    album = analysis.analyze_album(clips, device=dev)
    peak_r = analysis.find_peak_amplitude(clips[1], device=dev)
    check(np.isfinite(album.album_gain_db) and peak_r.peak > 0, "album and peak")
    print(f"entry points (cuda): {'; '.join(gains)}; album "
          f"{album.album_gain_db:.2f} dB, album peak {album.album_peak:.4f}",
          flush=True)

    # --- 9. the AAC/M4A path -------------------------------------------------------
    aac_clips, aac_times = aac_phase(dev, card, runner, clips[2])

    # --- 10. the library scan ------------------------------------------------------
    del runner
    torch.cuda.empty_cache()
    lib = library_phase(dev, card, u, louds[0], peaks[0], int(win_counts[0]), clips,
                        aac_clips)

    # --- 11. the per-track CLI path ---------------------------------------------------
    per_track_cli_phase(dev, card, clips[0], aac_clips[0])

    # --- 12. two Runners on the card, two processes on the card, the GUI -----------
    multi = multi_runner_phase(dev, card, u, clips, aac_clips)
    multihost_phase(dev, card, clips)
    gui_phase(dev, card, clips)

    # --- 13. the card against the float64 reference, the oracles, entry() ----------
    oracle_phase(dev, card)

    # --- 14. real track lengths and every sample rate against the reference ---------
    real = real_library_phase(dev, card)

    # --- 15. times ---------------------------------------------------------------
    dev_s = timing["device_ms"] / 1e3
    h_dev_s = h_timing["device_ms"] / 1e3
    split = timing["prep_s"] + timing["h2d_s"] + dev_s
    h_split = h_timing["prep_s"] + h_timing["h2d_s"] + h_dev_s
    print(f"times {card}: slice wall {wall_s:.3f} s = host prep "
          f"{timing['prep_s']:.3f} s + staging and upload {timing['h2d_s']:.3f} s + device "
          f"{dev_s:.3f} s (sum {split:.3f}); {audio_s:.0f} s of audio, "
          f"real-time factor {audio_s / wall_s:.0f}x; device-only "
          f"{audio_s / dev_s:.0f}x; peak device memory "
          f"{peak_gb:.3f} GB; K1 {k1_ms:.3f} ms vs plain {k1_plain_ms:.1f} ms; "
          f"K2 {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms; K4 {synth_ms['K4']:.3f} ms, "
          f"K5 {synth_ms['K5']:.3f} ms vs their torch.matmul products "
          f"{synth_ms['K4 library']:.3f}, {synth_ms['K5 library']:.3f} ms", flush=True)
    print(f"times {card}: heavy slice wall {h_wall_s:.3f} s = host prep "
          f"{h_timing['prep_s']:.3f} s + staging and upload {h_timing['h2d_s']:.3f} s + "
          f"device {h_dev_s:.3f} s (sum {h_split:.3f}); real-time factor "
          f"{audio_s / h_wall_s:.0f}x; device-only {audio_s / h_dev_s:.0f}x; "
          f"peak device memory {h_peak_gb:.2f} GB; K3 heavy shape {k3_ms:.3f} ms vs "
          f"plain {k3_plain_ms:.3f} ms, library {k3_lib_ms:.3f} ms; K3 probe shape "
          f"{k3p_ms:.3f} ms vs plain {k3p_plain_ms:.3f} ms, library {k3p_lib_ms:.3f} ms",
          flush=True)
    print(aac_times, flush=True)

    kernels = [
        {"name": "entropy_decode_rows", "route": "cuda",
         "source": "mp3rgain_tpu_torch/csrc/entropy_decode.cu",
         "replaces": "mp3rgain_tpu/decode/entropy_kernel.py:154",
         "launches": lib["launches"]["entropy_decode_rows"],
         "light_slice_launches": counts["entropy_decode_rows"],
         "real_library_launches": real["entropy_decode_rows"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "requant_stereo", "route": "cuda",
         "source": "mp3rgain_tpu_torch/csrc/requant_stereo.cu",
         "replaces": "mp3rgain_tpu/decode/hybrid_kernel.py:163",
         "launches": lib["launches"]["requant_stereo"],
         "light_slice_launches": counts["requant_stereo"],
         "real_library_launches": real["requant_stereo"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        *({"name": name, "route": "cuda", "source": f"mp3rgain_tpu_torch/csrc/{name}.cu",
           "replaces": None, "launches": lib["launches"][name],
           "light_slice_launches": counts[name], "real_library_launches": real[name],
           "max_abs_err": err, "rows": SYNTH_ROWS, "ms": synth_ms[k],
           "plain_ms": synth_ms[k + " plain"], "bound_ms": bound[0], "bound_by": bound[1],
           "library_ms": synth_ms[k + " library"]}
          for k, name, err, bound in (("K4", "hybrid_synthesis", k4_err, k4_bound),
                                      ("K5", "overlap_polyphase", k5_err, k5_bound))),
        {"name": "class_core_gemm", "route": "cuda",
         "source": "mp3rgain_tpu_torch/csrc/class_core_gemm.cu",
         "replaces": "tools/hk_dotprobe.py:22",
         "launches": h_counts["class_core_gemm"],
         "dryrun_multichip_launches": multi["class_core_gemm_dryrun"],
         "real_library_launches": real["class_core_gemm"],
         "max_abs_err": max(k3_err, k3p_err),
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3h_bound[0],
         "bound_by": k3h_bound[1], "library_ms": k3_lib_ms,
         "probe_ms": k3p_ms, "probe_plain_ms": k3p_plain_ms,
         "probe_bound_ms": k3p_bound[0], "probe_library_ms": k3p_lib_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    from mp3rgain_tpu_torch import tracing

    with tracing.recording():
        main()
