"""ReplayGain analysis entry points: track, album and peak.

Counterpart of mp3rgain_tpu/analysis.py. MP3 input always takes the
raw-bits ("light") route: native light walk → parallel.runner.Runner
(Huffman decode, requantize + stereo, hybrid and polyphase GEMMs, IIR,
histogram on the device) → 95th-percentile readout; gain = PINK_REF −
loudness. MP4 containers and raw ADTS streams take the AAC path (aac.py).
Every entry point runs on the CUDA card unless it is given device="cpu"
(as the tests do); without a card it raises. Given no runner, the entry
points share one Runner per device (parallel.runner.shared_runner).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import tracing
from .decode import frontend
from .native import _inbuf, _lib
from .ops import histogram as hi
from .parallel.runner import SAMPLE_SCALE_16BIT, Runner, shared_runner
from .replaygain import (
    PINK_REF,
    AlbumGainResult,
    PeakAmplitudeResult,
    ReplayGainResult,
)


class AnalysisError(RuntimeError):
    pass


class TrackAnalysisInternal:
    def __init__(self, result: ReplayGainResult, hist: np.ndarray,
                 audio_seconds: float = 0.0):
        self.result = result
        self.histogram = hist  # (12000,) int32, read back to the host
        # Decoded duration where the analysis reports it (the AAC path; 0.0
        # otherwise): the histogram undercounts it, because silent windows
        # fall below the lowest bin and are dropped.
        self.audio_seconds = audio_seconds


def _sniff_adts(head: bytes) -> bool:
    """True if `head` starts (after any ID3v2 tag) with a plausible ADTS
    AAC frame, confirmed by the next frame header (the JAX package's
    analysis._sniff_adts)."""
    pos = 0
    if head[:3] == b"ID3" and len(head) >= 10:
        size = (
            (head[6] & 0x7F) << 21 | (head[7] & 0x7F) << 14
            | (head[8] & 0x7F) << 7 | (head[9] & 0x7F)
        )
        pos = 10 + size
    if pos + 7 > len(head):
        return False
    b = head[pos:]
    if b[0] != 0xFF or (b[1] & 0xF6) != 0xF0:
        return False
    frame_len = ((b[3] & 0x03) << 11) | (b[4] << 3) | (b[5] >> 5)
    if frame_len < 7:
        return False
    nxt = pos + frame_len
    if nxt + 2 <= len(head):
        return head[nxt] == 0xFF and (head[nxt + 1] & 0xF6) == 0xF0
    return nxt >= len(head)  # single trailing frame


@tracing.traced("detect")
def _detect_file_type(path) -> str:
    """"aac" for MP4 containers and raw ADTS streams, else "mp3"."""
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
    if len(head) >= 12 and _lib.mg_mp4_is_mp4(_inbuf(head[:12]), 12):
        return "aac"
    return "aac" if _sniff_adts(head) else "mp3"


def _analyze_mp3(path, runner: Runner):
    """(hist (12000,) on the host, loudness dB, peak, sample rate)."""
    with tracing.span("walk"), open(path, "rb") as f:
        u = frontend.unpack_data_light_packed(f.read())
    if u.n == 0:
        raise AnalysisError("No valid MP3 frames found")
    hist, louds, peaks = runner.analyze_unpacked_light(
        [u], u.sample_rate, u.n_channels)
    return hist[0], float(louds[0]), float(peaks[0]), u.sample_rate


@tracing.traced("track")
def analyze_track_internal(path: os.PathLike | str,
                           track_index: int | None = None, *,
                           device="cuda", runner: Runner | None = None
                           ) -> TrackAnalysisInternal:
    """One track on `runner` (the device's shared Runner when None)."""
    runner = runner or shared_runner(device)
    if _detect_file_type(path) == "aac":
        from . import aac

        return aac.analyze_track_internal(path, track_index, runner=runner)
    # MP3 streams have exactly one audio track.
    if track_index not in (None, 0):
        raise AnalysisError(
            f"Track index {track_index} out of range (file has 1 audio track(s))"
        )
    hist, loudness_db, peak, sr = _analyze_mp3(path, runner)
    result = ReplayGainResult(
        loudness_db=loudness_db,
        gain_db=PINK_REF - loudness_db,
        peak=peak,
        sample_rate=sr,
        file_type="mp3",
    )
    return TrackAnalysisInternal(result, hist)


@tracing.traced("album")
def analyze_album(files, track_index: int | None = None, *,
                  device="cuda", runner: Runner | None = None) -> AlbumGainResult:
    """Album analysis over MP3 and AAC files: union histogram
    (duration-weighted), peak max. The tracks run one by one through one
    Runner, which keeps one set of tables per format."""
    runner = runner or shared_runner(device)
    tracks = []
    album_peak = 0.0
    album_hist = np.zeros(hi.HISTOGRAM_SIZE, np.int64)
    for f in files:
        internal = analyze_track_internal(f, track_index, runner=runner)
        album_peak = max(album_peak, internal.result.peak)
        album_hist += internal.histogram
        tracks.append(internal.result)
    idx = int(hi.loudness_index(torch.from_numpy(album_hist)[None])[0])
    album_loudness = hi.index_to_loudness(idx)
    return AlbumGainResult(
        tracks=tracks,
        album_loudness_db=album_loudness,
        album_gain_db=PINK_REF - album_loudness,
        album_peak=album_peak,
    )


def find_peak_amplitude(path: os.PathLike | str, *, device="cuda",
                        runner: Runner | None = None) -> PeakAmplitudeResult:
    """Decoded peak over all channels: unclipped for MP3 (like mp3gain),
    clipped at ±1 for AAC (aac.AAC_CLIP)."""
    runner = runner or shared_runner(device)
    if _detect_file_type(path) == "aac":
        from . import aac

        return aac.find_peak_amplitude(path, runner=runner)
    _, _, peak, sr = _analyze_mp3(path, runner)
    return PeakAmplitudeResult(peak=peak, peak_pcm=peak * SAMPLE_SCALE_16BIT,
                               sample_rate=sr)
