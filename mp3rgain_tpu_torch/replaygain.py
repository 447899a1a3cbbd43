"""ReplayGain 1.0 result types and constants.

The torch port's copy of the result half of mp3rgain_tpu/replaygain.py
(PINK_REF and the three result dataclasses) and of
mp3rgain_tpu/bitstream.py::db_to_steps, which their gain_steps methods
use. The analysis entry points themselves are in analysis.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# 89 dB SPL reference (the reference Rust mp3rgain, src/replaygain.rs:35-37).
REPLAYGAIN_REFERENCE_DB = 89.0

# Loudness of the -14 dB FS pink-noise calibration signal
# (src/replaygain.rs:39-44): gain_db = PINK_REF - loudness_db.
PINK_REF = 64.82

GAIN_STEP_DB = 1.5


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
