"""AAC/M4A analysis path: host AAC-LC front-end + device DSP.

Counterpart of mp3rgain_tpu/aac.py (analyze_batch_q_sharded runs a batch
over several devices, one parallel.runner.Runner each). The AAC
path shares the MP3 path's equal-loudness filter and histogram; only the
decode back-end differs (AAC IMDCT and windowing instead of the MP3
hybrid filterbank and polyphase). Two routes, both batched through
parallel.runner.Runner (pinned staging, a copy stream, a readback one
batch behind):

- device prep (the "q" route, Runner.prepare_aac_q): the host ships
  quantized coefficients and band metadata (prepare_batch_arrays_aac_q)
  and decode/aac_prep.py requantizes, fills PNS bands and applies stereo
  on the device. The default on a CUDA device.
- host requant (the "f16" route, Runner.prepare_aac): the host decodes
  to block-scaled float16 spectra (prepare_batch_arrays_aac). The q
  route's oracle, and the default on the CPU.

The route is an argument (device_prep=True / False / None for the
device's default), never an environment switch. The two host packers are
the JAX package's, held equal to them by output in
tests/test_torch_aac.py. Every entry point runs on the CUDA card unless
given device="cpu"; without a card it raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import tracing
from .decode import aac_frontend as af
from .decode import aac_prep, aac_synthesis
from .decode.aac_format_tables import SWB_1024_MAP, SWB_LONG_TABLES
from .device import mark_stage
from .ops import histogram as hi
from .ops.iir import EqualLoudness
from .parallel import runner as pr
from .replaygain import PINK_REF, PeakAmplitudeResult, ReplayGainResult
from .utils import bufpool

SAMPLE_SCALE_16BIT = 32768.0

# AAC analysis clips decoded samples at ±1.0, matching the reference
# analyzer's decoder (its AAC peaks and loudness are computed from clipped
# PCM). This is the opposite of the MP3 contract (true unclipped peak,
# mp3gain parity) because mp3gain never handled AAC, and because AAC
# encoder priming can decode to wild magnitudes with no container
# metadata to trim by.
AAC_CLIP = 1.0


class AacError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Host packers (the JAX package's, array for array).
# ---------------------------------------------------------------------------


def prepare_batch_arrays_aac(unpacked: list, n_channels: int):
    """Pad AAC tracks to ladder-quantized (B, F) shapes for analysis_core.

    Zero-spectrum padding frames decode to zero PCM; everything past a
    track's valid_samples is masked out of peak and histogram. When
    every track was unpacked with f16=True the batch ships block-scaled
    float16 + per-frame exponents (half the upload); otherwise float32
    with zero exponents (f16 entries upconvert exactly). The four big
    arrays come from the shared buffer pool."""
    bsz = len(unpacked)
    f_max = max((u.n // n_channels) * n_channels for u in unpacked)
    f_max = pr._quantize_up(max(f_max, n_channels), n_channels, base=128,
                            ratio=1.3)
    bpad = next((b for b in pr._B_LADDER if b >= bsz), bsz)
    all_f16 = all(u.spec16 is not None for u in unpacked)
    spec = bufpool.take_zeroed((bpad, f_max, 1024),
                               np.float16 if all_f16 else np.float32)
    sexp = bufpool.take_zeroed((bpad, f_max), np.int8)
    wseq = bufpool.take_zeroed((bpad, f_max), np.int32)
    wshape = bufpool.take_zeroed((bpad, f_max), np.int32)
    valid = np.zeros(bpad, np.int32)
    for i, u in enumerate(unpacked):
        n = (u.n // n_channels) * n_channels
        if all_f16:
            spec[i, :n] = u.spec16[:n]
            sexp[i, :n] = u.sexp[:n]
        elif u.spec16 is not None:
            spec[i, :n] = u.spec16[:n].astype(np.float32)
            spec[i, :n] *= np.exp2(u.sexp[:n].astype(np.float32))[:, None]
        else:
            spec[i, :n] = u.spec[:n]
        wseq[i, :n] = u.info[:n, af.WINDOW_SEQ]
        wshape[i, :n] = u.info[:n, af.WINDOW_SHAPE]
        valid[i] = (n // n_channels) * 1024
    return spec, sexp, wseq, wshape, valid


# Fallback-row ladder: keeps the (rare) fallback sideband's shape
# population small across batches.
_FB_LADDER = (4, 16, 64, 256, 1024, 4096, 16384)

# Escape-coefficient ladder (|q| > 7 positions, sparse scatter-add;
# ~1.4% of coefficients on real content, 6 B each). Geometric at the
# bottom, then linear 128k steps: coarse top steps would ship megabytes
# of zero padding per batch.
_ESC_LADDER = tuple([512, 2048, 8192, 32768]
                    + [131072 * k for k in range(1, 129)])


def _f_max_q(n: int, n_channels: int) -> int:
    """The q route's padded frame-channel count for a longest track of n
    lanes (finer than the f16 route's 1.3-ratio ladder: spec_q4 and meta
    dominate the upload and both scale with it)."""
    return pr._quantize_up(max(n, n_channels), 8 * n_channels, base=128,
                           ratio=1.08)


def prepare_batch_arrays_aac_q(unpacked: list, n_channels: int,
                               force_shapes: tuple | None = None):
    """Pad device-requant AAC tracks into ladder-quantized batch arrays
    for analysis_core_q. Returns (spec_q4, meta, esc_idx, esc_val, fb16,
    fbexp, fbmap, wseq, wshape, valid). force_shapes = (bpad, f_max, ext,
    ecap, fbp) pins every shape, so independently prepared shards can
    stack."""
    bsz = len(unpacked)
    f_max = max((u.n // n_channels) * n_channels for u in unpacked)
    f_max = _f_max_q(f_max, n_channels)
    bpad = next((b for b in pr._B_LADDER if b >= bsz), bsz)

    # Coded extent: quantized coefficients live only in btype==1 bands,
    # so the batch ships (B, F, EXT) with EXT from the largest coded
    # band, rounded to 128 to keep the shape population small.
    sr = unpacked[0].sample_rate
    swb = SWB_LONG_TABLES[SWB_1024_MAP[af.ADTS_SR_INDEX[sr]]]
    kmax = 0
    for u in unpacked:
        nz = np.nonzero((u.btype == 1).any(axis=0))[0]
        if len(nz):
            kmax = max(kmax, int(nz[-1]) + 1)
    ext = min(1024, max(128, -(-swb[min(kmax, len(swb) - 1)] // 128) * 128))

    force_ecap = force_fbp = None
    if force_shapes is not None:
        f_bpad, f_fmax, f_ext, force_ecap, force_fbp = force_shapes
        assert f_bpad >= bsz and f_fmax >= f_max and f_ext >= ext
        bpad, f_max, ext = f_bpad, f_fmax, f_ext

    # The spectrum buffer dominates the payload: two signed 4-bit
    # coefficients per byte, with every |q| > 7 routed to the sparse
    # escape sideband (prep_spectra adds them back exactly). Take it
    # unzeroed and memset only the regions the per-track copies leave
    # stale (pad rows per track + unused batch lanes).
    exth = ext // 2
    nbands = aac_prep.n_bands(sr)
    spec_q4 = bufpool.take((bpad, f_max, exth), np.int8)
    meta = bufpool.take_zeroed((bpad, f_max, nbands), np.uint16)
    wseq = bufpool.take_zeroed((bpad, f_max), np.uint8)
    wshape = bufpool.take_zeroed((bpad, f_max), np.uint8)
    valid = np.zeros(bpad, np.int32)
    fbmap = bufpool.take((bpad * f_max,), np.int32)
    fbmap[:] = np.arange(bpad * f_max, dtype=np.int32)

    # Escape entries ship as one flat coefficient index (row*1024 + pos)
    # + the exact int16 value. int64 indices only when the batch's flat
    # coefficient space outgrows int32 (batches of many ~40-min tracks).
    idx_dt = np.int32 if bpad * f_max * 1024 < 2**31 else np.int64

    fb_rows = []
    fb_exps = []
    esc_idxs = []
    esc_vals = []
    for i, u in enumerate(unpacked):
        n = (u.n // n_channels) * n_channels
        a = u.qspec[:n, :ext]
        big = (a > 7) | (a < -7)  # not np.abs: abs(int8 -128) overflows
        if big.any():
            r2, p2 = np.nonzero(big)
            esc_idxs.append(((r2 + i * f_max).astype(idx_dt) << 10)
                            | p2.astype(idx_dt))
            esc_vals.append(a[r2, p2].astype(np.int16))
            a = np.where(big, np.int8(0), a)
        # Two's-complement nibble pack: low nibble = even coefficient.
        spec_q4[i, :n] = (a[:, 0::2] & np.int8(15)) | (a[:, 1::2] << 4)
        spec_q4[i, n:] = 0
        # lvl (sf / PNS energy / intensity position) fits 12 bits with
        # a +2048 bias (values beyond ±2048 overflow exp2 in f32 anyway
        # — only reachable through corrupt streams, hence the clip);
        # btype (0..4) in bits 12-14, ms_used in bit 15.
        meta[i, :n] = (
            (np.clip(u.lvl[:n, :nbands], -2048, 2047).astype(np.int32)
             + 2048)
            | (u.btype[:n, :nbands].astype(np.int32) << 12)
            | (u.msf[:n, :nbands].astype(np.int32) << 15)
        ).astype(np.uint16)
        wseq[i, :n] = u.info[:n, af.WINDOW_SEQ].astype(np.uint8)
        wshape[i, :n] = u.info[:n, af.WINDOW_SHAPE].astype(np.uint8)
        valid[i] = (n // n_channels) * 1024
        if len(u.esc_idx):
            row = u.esc_idx >> 10
            keep = row < n
            # Escape positions always lie inside a coded band, and ext
            # covers every coded band in the batch, so pos < ext.
            esc_idxs.append(((row[keep] + i * f_max).astype(idx_dt) << 10)
                            | (u.esc_idx & 1023)[keep].astype(idx_dt))
            esc_vals.append(u.esc_val[keep])
        for j, row in enumerate(u.fbrows):
            if row >= n:
                continue
            fbmap[i * f_max + int(row)] = bpad * f_max + len(fb_rows)
            fb_rows.append(u.fb16[j])
            fb_exps.append(u.fbexp[j])
    spec_q4[bsz:] = 0

    n_esc = sum(len(e) for e in esc_idxs)
    ecap = next((e for e in _ESC_LADDER if e >= max(n_esc, 1)),
                max(n_esc, 1))
    if force_ecap is not None:
        assert force_ecap >= n_esc
        ecap = force_ecap
    esc_idx = np.zeros(ecap, idx_dt)  # padding adds 0 at index 0
    esc_val = np.zeros(ecap, np.int16)
    if n_esc:
        esc_idx[:n_esc] = np.concatenate(esc_idxs)
        esc_val[:n_esc] = np.concatenate(esc_vals)

    fbp = next((f for f in _FB_LADDER if f >= max(len(fb_rows), 1)),
               max(len(fb_rows), 1))
    if force_fbp is not None:
        assert force_fbp >= len(fb_rows)
        fbp = force_fbp
    fb16 = np.zeros((fbp, 1024), np.uint16)
    fbexp = np.zeros(fbp, np.int8)
    if fb_rows:
        fb16[: len(fb_rows)] = np.stack(fb_rows)
        fbexp[: len(fb_rows)] = np.array(fb_exps, np.int8)
    return (spec_q4, meta, esc_idx, esc_val,
            fb16.view(np.float16), fbexp, fbmap, wseq, wshape, valid)


# ---------------------------------------------------------------------------
# Device pipeline.
# ---------------------------------------------------------------------------


class AacTail(nn.Module):
    """The AAC routes' constants for one (sample rate, channel count):
    the spectral prep's band tables (prep), the equal-loudness solve (iir)
    and the IMDCT tables (synthesis; rate-independent, so a Runner shares
    one AacSynthesis among its AacTails)."""

    def __init__(self, sample_rate: int, n_channels: int,
                 synthesis: aac_synthesis.AacSynthesis | None = None):
        super().__init__()
        if n_channels not in (1, 2):
            raise ValueError(f"n_channels {n_channels}")
        self.sample_rate = sample_rate
        self.n_channels = n_channels
        self.prep = aac_prep.AacPrep(sample_rate)
        self.iir = EqualLoudness(sample_rate)
        self.synthesis = synthesis or aac_synthesis.AacSynthesis()


def analysis_tail(tail: AacTail, spec, window_seq, window_shape,
                  valid_samples, short_rows, *, short_counts, on_stage=None):
    """(B, F, 1024) spectra → (hist (B, 12000) int32, loud_idx (B,) int32,
    peak (B,) f32): IMDCT, the clip at ±AAC_CLIP, the masked peak, then
    the MP3 path's IIR, histogram and index."""
    pcm = tail.synthesis.decode(spec, window_seq, window_shape, short_rows,
                                short_counts, n_channels=tail.n_channels,
                                on_stage=on_stage)
    del spec
    pcm = pcm.clamp_(-AAC_CLIP, AAC_CLIP)
    bsz, c, n = pcm.shape
    sample_idx = torch.arange(n, device=pcm.device)
    mask = sample_idx[None, None, :] < valid_samples[:, None, None]
    peak = (pcm.abs() * mask).amax(dim=(1, 2))  # (B,)
    mark_stage(on_stage, "clip + peak")
    x = pcm.reshape(bsz * c, n) * SAMPLE_SCALE_16BIT
    del pcm
    filtered = tail.iir(x).reshape(bsz, c, n)
    mark_stage(on_stage, "IIR")
    hist = hi.histogram(filtered, valid_samples,
                        hi.window_size(tail.sample_rate))
    loud_idx = hi.loudness_index(hist)
    mark_stage(on_stage, "histogram + index")
    return hist, loud_idx, peak


def analysis_core(tail: AacTail, spec, sexp, window_seq, window_shape,
                  valid_samples, short_rows, *, short_counts, on_stage=None):
    """The host-requant route: block-scaled spectra (the true spectrum is
    spec * 2^sexp; sexp all-zero when the host shipped f32) →
    analysis_tail."""
    spec = spec.to(torch.float32) * torch.exp2(sexp.to(torch.float32))[..., None]
    return analysis_tail(tail, spec, window_seq, window_shape, valid_samples,
                         short_rows, short_counts=short_counts,
                         on_stage=on_stage)


def analysis_core_q(tail: AacTail, spec_q4, meta, esc_idx, esc_val, fb16,
                    fbexp, fb_dst, window_seq, window_shape, valid_samples,
                    short_rows, *, short_counts, on_stage=None):
    """The device-prep route: quantized coefficients in, spectral prep
    (decode/aac_prep.py) → analysis_tail."""
    spec = tail.prep.prep_spectra(
        spec_q4, meta, esc_idx, esc_val, fb16, fbexp, fb_dst,
        n_channels=tail.n_channels, on_stage=on_stage)
    return analysis_tail(tail, spec, window_seq, window_shape, valid_samples,
                         short_rows, short_counts=short_counts,
                         on_stage=on_stage)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def use_device_prep(device: torch.device, device_prep: bool | None) -> bool:
    """The route for `device`: device prep on CUDA, the host-requant
    oracle on the CPU, unless the caller names one."""
    return device.type == "cuda" if device_prep is None else bool(device_prep)


def analyze_batch_q(unpacked: list, sample_rate: int, n_channels: int, *,
                    device="cuda", runner: pr.Runner | None = None):
    """Analyze same-format quantized-unpacked tracks (unpack_file_q) in
    one batch on the device-prep route. Returns host arrays (hist (B,
    12000) int32, loudness (B,) dB, peak (B,))."""
    runner = runner or pr.shared_runner(device)
    return runner.collect(runner.launch(
        runner.prepare_aac_q(unpacked, sample_rate, n_channels)))


def analyze_batch_q_sharded(unpacked: list, sample_rate: int, n_channels: int, *,
                            devices="cuda", group: pr.RunnerGroup | None = None):
    """analyze_batch_q over several devices: the batch is split across the
    Runners of `group` (or of `devices`, as parallel.runner.runners_for
    reads them) the way RunnerGroup.dispatch_light_sharded splits an MP3
    batch, each shard runs the whole device-prep pipeline on its Runner,
    and the results come back in the original track order. One device, or
    fewer tracks than devices: the single-device batch. The shards are
    independent launches, so none is padded to another's shape (the
    packer's force_shapes is not used)."""
    group = group or pr.RunnerGroup(devices)
    return group.collect(group.dispatch_sharded(
        "prepare_aac_q", unpacked, sample_rate, n_channels))


def analyze_batch(unpacked: list, sample_rate: int, n_channels: int, *,
                  device="cuda", runner: pr.Runner | None = None):
    """Analyze same-format host-decoded tracks (unpack_file, f16 or f32)
    in one batch on the host-requant route; returns as analyze_batch_q."""
    runner = runner or pr.shared_runner(device)
    return runner.collect(runner.launch(
        runner.prepare_aac(unpacked, sample_rate, n_channels)))


def unpack_for(path, track_index, device_prep: bool):
    """The route's unpack of one file; AacError when nothing decodes."""
    if device_prep:
        u = af.unpack_file_q(path, track_index=track_index)
    else:
        u = af.unpack_file(path, track_index=track_index, f16=True)
    if u.n == 0:
        raise AacError("No decodable AAC frames found")
    return u


def audio_seconds(u) -> float:
    """Duration from decoded sample counts."""
    nch = u.n_channels or 1
    sr = u.sample_rate
    return (u.n // nch) * 1024 / sr if sr else 0.0


def _analyze_on_device(path, track_index, runner: pr.Runner,
                       device_prep: bool | None):
    device_prep = use_device_prep(runner.device, device_prep)
    with tracing.span("walk"):
        u = unpack_for(path, track_index, device_prep)
    batch = analyze_batch_q if device_prep else analyze_batch
    hist, louds, peaks = batch([u], u.sample_rate, u.n_channels or 1,
                               runner=runner)
    return hist[0], float(louds[0]), float(peaks[0]), u.sample_rate, audio_seconds(u)


def analyze_track_internal(path, track_index=None, *, device="cuda",
                           runner: pr.Runner | None = None,
                           device_prep: bool | None = None):
    from .analysis import TrackAnalysisInternal

    hist, loudness_db, peak, sr, seconds = _analyze_on_device(
        path, track_index, runner or pr.shared_runner(device), device_prep)
    result = ReplayGainResult(
        loudness_db=loudness_db,
        gain_db=PINK_REF - loudness_db,
        peak=peak,
        sample_rate=sr,
        file_type="aac",
    )
    return TrackAnalysisInternal(result, hist, audio_seconds=seconds)


def find_peak_amplitude(path, *, device="cuda", runner: pr.Runner | None = None,
                        device_prep: bool | None = None) -> PeakAmplitudeResult:
    """Decoded peak over all channels, clipped at ±AAC_CLIP."""
    _, _, peak, sr, _ = _analyze_on_device(
        path, None, runner or pr.shared_runner(device), device_prep)
    return PeakAmplitudeResult(
        peak=peak, peak_pcm=peak * SAMPLE_SCALE_16BIT, sample_rate=sr
    )


def decode_file(path, track_index=None, *, device="cuda"):
    """Full-file AAC decode of the host-decoded spectra (the f16 route's
    host decode, in f32) on the device's shared IMDCT tables; (pcm (C, N)
    np array, sample_rate)."""
    return aac_synthesis.decode_file(
        path, track_index, device=device,
        synthesis=pr.shared_runner(device).aac_synthesis())


def decode_file_q(path, track_index=None, *, device="cuda",
                  runner: pr.Runner | None = None):
    """The PCM that the device-prep route analyses for one track, as a
    batch of one: spectral prep and the IMDCT of analysis_core_q, clipped
    at ±AAC_CLIP, cut to the track's valid samples; (pcm (C, N) np array,
    sample_rate). Its PNS noise is keyed by batch row, so it is the noise
    of analyze_track_internal(..., device_prep=True), not the host
    decoder's."""
    runner = runner or pr.shared_runner(device)
    u = unpack_for(path, track_index, True)
    nch = u.n_channels or 1
    prepared = runner.prepare_aac_q([u], u.sample_rate, nch)
    args = [pr._to_device(a, runner.device) for a in prepared.arrays]
    bufpool.give(*prepared.pooled)
    (spec_q4, meta, esc_idx, esc_val, fb16, fbexp, fb_dst, wseq, wshape, valid,
     rows) = args
    tail = runner.aac_tail(u.sample_rate, nch)
    with torch.no_grad():
        spec = tail.prep.prep_spectra(spec_q4, meta, esc_idx, esc_val, fb16, fbexp,
                                      fb_dst, n_channels=nch)
        pcm = tail.synthesis.decode(spec, wseq, wshape, rows,
                                    prepared.shapes["short_counts"], n_channels=nch)
        pcm = pcm[0, :, : int(valid[0])].clamp_(-AAC_CLIP, AAC_CLIP)
    return pcm.cpu().numpy(), u.sample_rate
