"""L0 public API: lossless MP3 gain analysis and application.

The torch port's copy of mp3rgain_tpu/bitstream.py, held equal to it by
tests/test_torch_host_copies.py (the code of every function but
find_max_amplitude, and the outputs of all of them). It mirrors the
reference Rust mp3rgain's library surface (src/lib.rs): analyze,
apply_gain, apply_gain_db, apply_gain_wrap, apply_gain_channel, the
*_with_undo variants, undo_gain, and find_max_amplitude. The byte engine is
the port's copy of the native C++ core (_native/bitstream.cpp). Nothing
here imports torch, except find_max_amplitude's decoded peak, which goes
through replaygain.find_peak_amplitude.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from enum import Enum

from . import ape as ape_mod
from . import native
from .ape import (
    ApeTag,
    TAG_MP3GAIN_MINMAX,
    TAG_MP3GAIN_UNDO,
    parse_undo_values,
    read_ape_tag_from_file,
    write_ape_tag,
    delete_ape_tag,
)

# Format-defined constants (reference src/lib.rs:47-54).
GAIN_STEP_DB = 1.5
MAX_GAIN = 255
MIN_GAIN = 0

_VERSION_NAMES = {1: "MPEG1", 2: "MPEG2", 25: "MPEG2.5"}
_CHANNEL_NAMES = {0: "Stereo", 1: "Joint Stereo", 2: "Dual Channel", 3: "Mono"}


class Mp3Error(RuntimeError):
    pass


def _tag_io(path, backend: str):
    """(read, write, delete) for the undo-bookkeeping store.

    backend "ape" (default, reference parity) keeps the APEv2 engine;
    "id3" routes the same ApeTag items into ID3v2 TXXX frames (-s i —
    implemented for real here where the reference warns and falls back,
    src/main.rs:256-258). For id3 the tag is validated up front so an
    unwritable tag (v2.2/unsynchronised) fails before gain surgery."""
    if backend == "id3":
        from . import id3v2

        try:
            id3v2.check_writable(path)
        except id3v2.Id3Error as e:
            raise Mp3Error(str(e)) from e
        return (id3v2.read_id3_tag_from_file, id3v2.write_id3_tag,
                id3v2.delete_id3_tag_items)
    return read_ape_tag_from_file, write_ape_tag, delete_ape_tag


class Channel(Enum):
    """Channel selection for -l (reference src/lib.rs:641-667)."""

    LEFT = 0
    RIGHT = 1

    def index(self) -> int:
        return self.value

    @staticmethod
    def from_index(index: int) -> "Channel | None":
        if index == 0:
            return Channel.LEFT
        if index == 1:
            return Channel.RIGHT
        return None


@dataclass
class Mp3Analysis:
    """Result of file analysis (reference src/lib.rs:57-75)."""

    frame_count: int
    mpeg_version: str
    channel_mode: str
    min_gain: int
    max_gain: int
    avg_gain: float
    headroom_steps: int
    headroom_db: float


def db_to_steps(db: float) -> int:
    """Convert dB to the nearest 1.5 dB step (round-half-away-from-zero)."""
    import math

    x = db / GAIN_STEP_DB
    # Rust f64::round rounds half away from zero; Python round() is banker's.
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def steps_to_db(steps: int) -> float:
    return steps * GAIN_STEP_DB


def _read(path) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise Mp3Error(f"Failed to read: {path}: {e}") from e


def _write(path, data: bytes) -> None:
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError as e:
        raise Mp3Error(f"Failed to write: {path}: {e}") from e


def analyze_data(data: bytes) -> Mp3Analysis:
    res = native.analyze(data)
    if res is None:
        raise Mp3Error("No valid MP3 frames found")
    headroom_steps = MAX_GAIN - res.max_gain
    return Mp3Analysis(
        frame_count=res.frame_count,
        mpeg_version=_VERSION_NAMES[res.mpeg_version],
        channel_mode=_CHANNEL_NAMES[res.channel_mode],
        min_gain=res.min_gain,
        max_gain=res.max_gain,
        avg_gain=res.avg_gain,
        headroom_steps=headroom_steps,
        headroom_db=headroom_steps * GAIN_STEP_DB,
    )


def analyze(path: os.PathLike | str) -> Mp3Analysis:
    return analyze_data(_read(path))


def is_mono(path: os.PathLike | str) -> bool:
    return analyze(path).channel_mode == "Mono"


def apply_gain(path: os.PathLike | str, gain_steps: int) -> int:
    """Saturating whole-file gain apply; zero-gain fast path leaves the file
    untouched (reference src/lib.rs:602-616)."""
    if gain_steps == 0:
        return 0
    data = bytearray(_read(path))
    frames = native.apply_gain(data, gain_steps, wrap=False)
    _write(path, bytes(data))
    return frames


def apply_gain_wrap(path: os.PathLike | str, gain_steps: int) -> int:
    if gain_steps == 0:
        return 0
    data = bytearray(_read(path))
    frames = native.apply_gain(data, gain_steps, wrap=True)
    _write(path, bytes(data))
    return frames


def apply_gain_db(path: os.PathLike | str, gain_db: float) -> int:
    return apply_gain(path, db_to_steps(gain_db))


def apply_gain_channel(path: os.PathLike | str, channel: Channel, gain_steps: int) -> int:
    """Channel-specific saturating apply; errors on mono (lib.rs:748-768)."""
    if gain_steps == 0:
        return 0
    analysis = analyze(path)
    if analysis.channel_mode == "Mono":
        raise Mp3Error(
            "Cannot apply channel-specific gain to mono file. Use -g for mono files."
        )
    data = bytearray(_read(path))
    frames = native.apply_gain_channel(data, channel.index(), gain_steps)
    _write(path, bytes(data))
    return frames


def apply_gain_with_undo(path: os.PathLike | str, gain_steps: int,
                         backend: str = "ape") -> int:
    """Apply + record cumulative undo info in the tag (lib.rs:1280-1308)."""
    if gain_steps == 0:
        return 0
    read_tag, write_tag, _ = _tag_io(path, backend)
    analysis = analyze(path)
    tag = read_tag(path) or ApeTag()
    existing = tag.get_undo_gain() or 0
    new_undo = existing + gain_steps
    tag.set_undo_gain(new_undo, new_undo, False)
    if tag.get(TAG_MP3GAIN_MINMAX) is None:
        tag.set_minmax(analysis.min_gain, analysis.max_gain)
    frames = apply_gain(path, gain_steps)
    write_tag(path, tag)
    return frames


def apply_gain_with_undo_wrap(path: os.PathLike | str, gain_steps: int,
                              backend: str = "ape") -> int:
    if gain_steps == 0:
        return 0
    read_tag, write_tag, _ = _tag_io(path, backend)
    analysis = analyze(path)
    tag = read_tag(path) or ApeTag()
    existing = tag.get_undo_gain() or 0
    new_undo = existing + gain_steps
    tag.set_undo_gain(new_undo, new_undo, True)
    if tag.get(TAG_MP3GAIN_MINMAX) is None:
        tag.set_minmax(analysis.min_gain, analysis.max_gain)
    frames = apply_gain_wrap(path, gain_steps)
    write_tag(path, tag)
    return frames


def apply_gain_channel_with_undo(
    path: os.PathLike | str, channel: Channel, gain_steps: int,
    backend: str = "ape",
) -> int:
    """Channel apply with per-channel undo bookkeeping (lib.rs:771-812)."""
    if gain_steps == 0:
        return 0
    read_tag, write_tag, _ = _tag_io(path, backend)
    analysis = analyze(path)
    if analysis.channel_mode == "Mono":
        raise Mp3Error(
            "Cannot apply channel-specific gain to mono file. Use -g for mono files."
        )
    tag = read_tag(path) or ApeTag()
    left, right = parse_undo_values(tag.get(TAG_MP3GAIN_UNDO))
    if channel is Channel.LEFT:
        left += gain_steps
    else:
        right += gain_steps
    tag.set_undo_gain(left, right, False)
    if tag.get(TAG_MP3GAIN_MINMAX) is None:
        tag.set_minmax(analysis.min_gain, analysis.max_gain)
    frames = apply_gain_channel(path, channel, gain_steps)
    write_tag(path, tag)
    return frames


def undo_gain(path: os.PathLike | str, backend: str = "ape") -> int:
    """Reverse recorded gain; removes the undo tags, deleting the tag
    entirely when it becomes empty (lib.rs:1311-1338; for the id3
    backend only the owned TXXX frames are ever removed)."""
    read_tag, write_tag, delete_tag = _tag_io(path, backend)
    tag = read_tag(path)
    if tag is None:
        label = "ID3v2" if backend == "id3" else "APE"
        raise Mp3Error(f"No {label} tag found - cannot undo")
    undo = tag.get_undo_gain()
    if undo is None:
        raise Mp3Error("No MP3GAIN_UNDO tag found - cannot undo")
    if undo == 0:
        return 0
    frames = apply_gain(path, -undo)
    tag.remove(TAG_MP3GAIN_UNDO)
    tag.remove(TAG_MP3GAIN_MINMAX)
    if tag.is_empty():
        delete_tag(path)
    else:
        write_tag(path, tag)
    return frames


def find_max_amplitude(path: os.PathLike | str, *,
                       device="cuda") -> tuple[float, int, int]:
    """(max_amplitude_normalized, max_gain, min_gain); decodes audio for the
    true peak (reference src/lib.rs:1174-1199) on `device`."""
    data = _read(path)
    gains = native.read_gains(data)
    if gains.size == 0:
        raise Mp3Error("No valid MP3 frames found")
    max_gain = int(gains.max())
    min_gain = int(gains.min())
    from . import replaygain

    try:
        peak = replaygain.find_peak_amplitude(path, device=device).peak
    except replaygain.DeviceUnavailable:
        raise  # asked for the card and there is none: no estimate instead
    except Exception:
        # Fallback estimate from global_gain headroom (lib.rs:1203-1229).
        headroom_db = (MAX_GAIN - max_gain) * GAIN_STEP_DB
        peak = 10.0 ** (-headroom_db / 20.0)
    return (peak, max_gain, min_gain)


# Re-export tag API at the package's bitstream level for parity with the
# reference's flat lib.rs surface.
read_ape_tag = ape_mod.read_ape_tag
serialize_ape_tag = ape_mod.serialize_ape_tag
remove_ape_tag = ape_mod.remove_ape_tag
