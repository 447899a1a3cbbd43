"""ReplayGain 1.0 analysis API (track/album/peak), result types, constants.

Counterpart of mp3rgain_tpu/replaygain.py: is_available,
analyze_track(_with_index), analyze_album(_with_index),
find_peak_amplitude, ReplayGainResult, AlbumGainResult,
PeakAmplitudeResult, plus db_to_steps (mp3rgain_tpu/bitstream.py's), which
the gain_steps methods use. The entry points reach analysis.py lazily, so
importing this module imports no torch: the CLI's byte-surgery commands
import it. They run on the CUDA card unless given device="cpu", and raise
DeviceUnavailable where there is no card.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

# 89 dB SPL reference (the reference Rust mp3rgain, src/replaygain.rs:35-37).
REPLAYGAIN_REFERENCE_DB = 89.0

# Loudness of the -14 dB FS pink-noise calibration signal
# (src/replaygain.rs:39-44): gain_db = PINK_REF - loudness_db.
PINK_REF = 64.82

GAIN_STEP_DB = 1.5


class DeviceUnavailable(RuntimeError):
    """An analysis was asked to run on a CUDA device that is not there."""


def db_to_steps(db: float) -> int:
    """Convert dB to the nearest 1.5 dB step (round-half-away-from-zero)."""
    x = db / GAIN_STEP_DB
    # Rust f64::round rounds half away from zero; Python round() is banker's.
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


@dataclass
class ReplayGainResult:
    loudness_db: float
    gain_db: float
    peak: float
    sample_rate: int
    file_type: str  # "mp3" | "aac"

    def gain_steps(self) -> int:
        return db_to_steps(self.gain_db)


@dataclass
class AlbumGainResult:
    tracks: list[ReplayGainResult]
    album_loudness_db: float
    album_gain_db: float
    album_peak: float

    def album_gain_steps(self) -> int:
        return db_to_steps(self.album_gain_db)


@dataclass
class PeakAmplitudeResult:
    peak: float
    peak_pcm: float
    sample_rate: int


def is_available() -> bool:
    try:
        from . import analysis  # noqa: F401

        return True
    except Exception:
        return False


def analyze_track(path: os.PathLike | str, *, device="cuda") -> ReplayGainResult:
    return analyze_track_with_index(path, None, device=device)


def analyze_track_with_index(
    path: os.PathLike | str, track_index: int | None, *, device="cuda"
) -> ReplayGainResult:
    from . import analysis

    return analysis.analyze_track_internal(path, track_index, device=device).result


def analyze_album(files, *, device="cuda") -> AlbumGainResult:
    return analyze_album_with_index(files, None, device=device)


def analyze_album_with_index(files, track_index: int | None, *,
                             device="cuda") -> AlbumGainResult:
    from . import analysis

    return analysis.analyze_album(files, track_index, device=device)


def find_peak_amplitude(path: os.PathLike | str, *,
                        device="cuda") -> PeakAmplitudeResult:
    from . import analysis

    return analysis.find_peak_amplitude(path, device=device)
