#!/usr/bin/env python3
"""Drive the torch port's ReplayGain main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds both hand-written kernels from the sources in this checkout (the
CUDA Huffman decode with nvcc, the Triton requantize + stereo pass), holds
each against its plain PyTorch version on the card, then runs the port's
main path — Runner.analyze_unpacked_light over 64 copies of a 60 s,
44.1 kHz joint-stereo 192 kbps track, the JAX package's bench batch — and
the analysis entry points on three committed clips. Every check raises on
failure; there is no CPU branch. Output, one phase per line:

  device / nvidia-smi name and power limit / build seconds /
  K1 and K2 agreement and times / slice launch counts, CPU agreement and
  times / entry-point gains / a JSON line of per-kernel results /
  last line {"ok": true, "device": {"platform": "gpu", ...}}.

Imports nothing of JAX. Exits non-zero without a result line when no
CUDA device is available.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

K2_RTOL = 1e-5
K2_ATOL_REL = 1e-6  # atol = K2_ATOL_REL * max|plain|
BATCH_TRACKS = 64


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over `iters` calls after one
    warm-up call, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import numpy as np
    import torch

    from mp3rgain_tpu_torch.device import require_cuda

    # --- 1. device -----------------------------------------------------------
    dev = require_cuda()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}", flush=True)

    from mp3rgain_tpu.decode import frontend as fe
    from mp3rgain_tpu.testing import craft
    from mp3rgain_tpu_torch import _build, analysis
    from mp3rgain_tpu_torch.decode import entropy_kernel as ek
    from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
    from mp3rgain_tpu_torch.parallel import runner as pr
    from mp3rgain_tpu_torch.testing import make_smoke_data as smoke

    torch.set_num_threads(min(8, os.cpu_count() or 1))

    # --- 2. build ------------------------------------------------------------
    nvcc_s = _build.build(force=True)
    _build.library()
    regs = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln]
    t0 = time.perf_counter()
    tables0 = hk.HybridTables(0).to(dev)
    z16 = torch.zeros((2, 1, 576), dtype=torch.int16, device=dev)
    hk.fused_requant_stereo(z16, torch.zeros((2, 1, 64), dtype=torch.int8, device=dev),
                            torch.zeros((2, 1, hk.GM_N), dtype=torch.int32, device=dev),
                            tables0)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    print(f"build: K1 nvcc {nvcc_s:.2f} s ({'; '.join(regs)}); "
          f"K2 triton jit {triton_s:.2f} s", flush=True)

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
    def k1_compare(args):
        spec_b, mout = ek.decode_blocks(*args, luts)
        ref_s, ref_m = ek.decode_blocks_reference(*args, luts)
        torch.cuda.synchronize()
        check(torch.equal(spec_b, ref_s) and torch.equal(mout, ref_m),
              "K1 spec_b/mout equal the plain version")
        err = max((spec_b.int() - ref_s.int()).abs().max().item(),
                  (mout - ref_m).abs().max().item())
        return spec_b, mout, err

    def host_equal(spec, big_end, c1end, host, n_tracks):
        """Unsorted spectra of n_tracks copies equal the host decoder."""
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
        spec_b, mout, err = k1_compare(args[:3])
        k1_err = max(k1_err, err)
        spec, big_end, c1end, _ = ek.unsort_blocks(spec_b, mout, args[3], nb=p.nb)
        host_equal(spec, big_end, c1end, fe.unpack_data(data), 1)

    prep, rest, g_max = pr.prepare_batch_arrays_light([u] * BATCH_TRACKS, 2)
    batch = to_dev((prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
    nb = prep.nb
    spec_b, mout, err = k1_compare(batch[:3])
    k1_err = max(k1_err, err)
    spec, big_end, c1end, _ = ek.unsort_blocks(spec_b, mout, batch[3], nb=nb)
    host_equal(spec, big_end, c1end, full, BATCH_TRACKS)
    del spec, big_end, c1end
    k1_ms = cuda_ms(lambda: ek.decode_blocks(*batch[:3], luts), 10)
    k1_plain_ms = cuda_ms(lambda: ek.decode_blocks_reference(*batch[:3], luts), 2)
    print(f"K1 entropy_decode (CUDA C++): exact against the plain version on "
          f"{len(streams)} streams and the {BATCH_TRACKS}-track batch "
          f"(nb={nb}, {nb * ek.LANES} lanes), unsorted spectra equal the host "
          f"decoder; kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.1f} ms {card}",
          flush=True)

    # --- 5. K2: Triton kernel against the plain version -----------------------
    tail = pr.LightTail(44100, 2).to(dev)
    cm = pr.channel_major_inputs(spec_b, mout, *batch[3:11], nb=nb, g_max=g_max,
                                 n_channels=2)
    del spec_b, mout
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
    gbytes = sum(t.numel() * t.element_size() for t in cm) / 1e9 \
        + 2 * rows * 576 * 4 / 1e9
    print(f"K2 requant_stereo (Triton): rows {rows} x 2 channels, max_abs_err "
          f"{k2_err:.3e} of max|ref| {scale:.1f} (rtol {K2_RTOL}, atol "
          f"{K2_ATOL_REL}*max|ref|); kernel {k2_ms:.3f} ms "
          f"({gbytes / (k2_ms / 1e3):.0f} GB/s), plain {k2_plain_ms:.3f} ms "
          f"{card}", flush=True)
    del cm, batch
    torch.cuda.empty_cache()

    # --- 6. the main path at full size ----------------------------------------
    runner = pr.Runner(dev)
    runner.analyze_unpacked_light([u] * BATCH_TRACKS, 44100, 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ek.COUNT.reset()
    hk.COUNT.reset()
    t0 = time.perf_counter()
    hist, louds, peaks = runner.analyze_unpacked_light([u] * BATCH_TRACKS, 44100, 2)
    wall_s = time.perf_counter() - t0
    counts = {"entropy_decode": ek.COUNT.kernel, "requant_stereo": hk.COUNT.kernel}
    plain_calls = ek.COUNT.plain + hk.COUNT.plain
    timing = runner.last_timings
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(v > 0 for v in counts.values()), f"both kernels launched: {counts}")
    check(plain_calls == 0, f"no plain-version calls on CUDA ({plain_calls})")
    check(hist.shape == (BATCH_TRACKS, 12000), "histogram shape")
    check(bool(np.isfinite(louds).all() and np.isfinite(peaks).all()),
          "finite loudness and peak")
    win_counts = hist.sum(dim=1).cpu().numpy()

    cpu_hist, cpu_louds, cpu_peaks = pr.Runner("cpu").analyze_unpacked_light(
        [u], 44100, 2)
    idx = [round(v * 100) + 2000 for v in (louds[0], cpu_louds[0])]
    check(int(win_counts[0]) == int(cpu_hist.sum()), "window counts equal CPU")
    check(abs(idx[0] - idx[1]) <= 2, f"loudness index within 2 bins of CPU {idx}")
    check(bool(np.allclose(peaks[0], cpu_peaks[0], rtol=2e-4, atol=1e-6)),
          f"peak within rtol 2e-4 of CPU ({peaks[0]} vs {cpu_peaks[0]})")
    print(f"slice: Runner.analyze_unpacked_light {BATCH_TRACKS} x {track_s:.2f} s "
          f"on {dev}: launches {counts}, plain calls {plain_calls}; track 0 "
          f"gain {64.82 - louds[0]:.2f} dB, peak {peaks[0]:.6f}, windows "
          f"{int(win_counts[0])} vs CPU gain {64.82 - cpu_louds[0]:.2f} dB, "
          f"peak {cpu_peaks[0]:.6f}, windows {int(cpu_hist.sum())}", flush=True)

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

    # --- 7. times ---------------------------------------------------------------
    split = timing["prep_s"] + timing["h2d_s"] + timing["device_s"]
    print(f"times {card}: slice wall {wall_s:.3f} s = host prep "
          f"{timing['prep_s']:.3f} s + h2d {timing['h2d_s']:.3f} s + device "
          f"{timing['device_s']:.3f} s (sum {split:.3f}); {audio_s:.0f} s of audio, "
          f"real-time factor {audio_s / wall_s:.0f}x; device-only "
          f"{audio_s / timing['device_s']:.0f}x; peak device memory "
          f"{peak_gb:.2f} GB; K1 {k1_ms:.3f} ms vs plain {k1_plain_ms:.1f} ms; "
          f"K2 {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms", flush=True)

    kernels = [
        {"name": "entropy_decode", "route": "cuda",
         "source": "mp3rgain_tpu_torch/csrc/entropy_decode.cu",
         "replaces": "mp3rgain_tpu/decode/entropy_kernel.py:154",
         "launches": counts["entropy_decode"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "requant_stereo", "route": "triton",
         "source": "mp3rgain_tpu_torch/decode/hybrid_kernel.py",
         "replaces": "mp3rgain_tpu/decode/hybrid_kernel.py:163",
         "launches": counts["requant_stereo"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
