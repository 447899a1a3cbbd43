"""ReplayGain analysis entry points: track, album and peak, for MP3.

Counterpart of the MP3 part of mp3rgain_tpu/analysis.py, always on the
raw-bits ("light") route: native light walk → parallel.runner.Runner
(Huffman decode, requantize + stereo, hybrid and polyphase GEMMs, IIR,
histogram on the device) → 95th-percentile readout; gain = PINK_REF −
loudness. Every entry point runs on the CUDA card unless it is given
device="cpu" (as the tests do); without a card it raises. AAC input is not
ported yet (ROADMAP Queue 1 item 10) and raises NotImplementedError.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .decode import frontend
from .native import _inbuf, _lib
from .ops import histogram as hi
from .parallel.runner import SAMPLE_SCALE_16BIT, Runner
from .replaygain import (
    PINK_REF,
    AlbumGainResult,
    PeakAmplitudeResult,
    ReplayGainResult,
)


class AnalysisError(RuntimeError):
    pass


class TrackAnalysisInternal:
    def __init__(self, result: ReplayGainResult, hist: np.ndarray):
        self.result = result
        self.histogram = hist  # (12000,) int32, read back to the host


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


def _detect_file_type(path) -> str:
    """"aac" for MP4 containers and raw ADTS streams, else "mp3"."""
    with open(path, "rb") as f:
        head = f.read(64 * 1024)
    if len(head) >= 12 and _lib.mg_mp4_is_mp4(_inbuf(head[:12]), 12):
        return "aac"
    return "aac" if _sniff_adts(head) else "mp3"


def _require_mp3(path) -> None:
    if _detect_file_type(path) == "aac":
        raise NotImplementedError(
            "AAC/M4A analysis is not ported to the torch package yet "
            "(ROADMAP Queue 1 item 10); use mp3rgain_tpu.analysis"
        )


def _analyze_mp3(path, runner: Runner):
    """(hist (12000,) on the host, loudness dB, peak, sample rate)."""
    with open(path, "rb") as f:
        u = frontend.unpack_data_light_packed(f.read())
    if u.n == 0:
        raise AnalysisError("No valid MP3 frames found")
    hist, louds, peaks = runner.analyze_unpacked_light(
        [u], u.sample_rate, u.n_channels)
    return hist[0], float(louds[0]), float(peaks[0]), u.sample_rate


def analyze_track_internal(path: os.PathLike | str,
                           track_index: int | None = None, *,
                           device="cuda", runner: Runner | None = None
                           ) -> TrackAnalysisInternal:
    """One track on `runner` (a new Runner on `device` when None)."""
    _require_mp3(path)
    # MP3 streams have exactly one audio track.
    if track_index not in (None, 0):
        raise AnalysisError(
            f"Track index {track_index} out of range (file has 1 audio track(s))"
        )
    hist, loudness_db, peak, sr = _analyze_mp3(path, runner or Runner(device))
    result = ReplayGainResult(
        loudness_db=loudness_db,
        gain_db=PINK_REF - loudness_db,
        peak=peak,
        sample_rate=sr,
        file_type="mp3",
    )
    return TrackAnalysisInternal(result, hist)


def analyze_album(files, track_index: int | None = None, *,
                  device="cuda") -> AlbumGainResult:
    """Album analysis: union histogram (duration-weighted), peak max. The
    tracks run one by one through one Runner, which keeps one LightTail
    per format."""
    runner = Runner(device)
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


def find_peak_amplitude(path: os.PathLike | str, *,
                        device="cuda") -> PeakAmplitudeResult:
    """True decoded peak over all channels (unclipped, like mp3gain)."""
    _require_mp3(path)
    _, _, peak, sr = _analyze_mp3(path, Runner(device))
    return PeakAmplitudeResult(peak=peak, peak_pcm=peak * SAMPLE_SCALE_16BIT,
                               sample_rate=sr)
