"""APEv2 tag API: read/write/delete APEv2 tags and mp3gain undo bookkeeping.

The torch port's copy of mp3rgain_tpu/ape.py (held equal to it by
tests/test_torch_host_copies.py). Mirrors the reference Rust mp3rgain's
public surface (src/lib.rs:838-1163):
ApeTag (get/set/remove, set_undo_gain with the "+002,+002,N|W" format at
lib.rs:930-934, set_minmax), read_ape_tag, write_ape_tag, delete_ape_tag.
Byte-level parse/serialize runs in the native C++ engine.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from . import native

# mp3gain-specific tag keys (reference src/lib.rs:848-856).
TAG_MP3GAIN_UNDO = "MP3GAIN_UNDO"
TAG_MP3GAIN_MINMAX = "MP3GAIN_MINMAX"
TAG_MP3GAIN_ALBUM_MINMAX = "MP3GAIN_ALBUM_MINMAX"
TAG_REPLAYGAIN_TRACK_GAIN = "REPLAYGAIN_TRACK_GAIN"
TAG_REPLAYGAIN_TRACK_PEAK = "REPLAYGAIN_TRACK_PEAK"
TAG_REPLAYGAIN_ALBUM_GAIN = "REPLAYGAIN_ALBUM_GAIN"
TAG_REPLAYGAIN_ALBUM_PEAK = "REPLAYGAIN_ALBUM_PEAK"


@dataclass
class ApeTag:
    """Ordered APEv2 item collection with case-insensitive keys."""

    items: list[tuple[str, str]] = field(default_factory=list)

    def get(self, key: str) -> str | None:
        key_upper = key.upper()
        for k, v in self.items:
            if k.upper() == key_upper:
                return v
        return None

    def set(self, key: str, value: str) -> None:
        # Replaces an existing item in place; new items stored upper-cased,
        # matching the reference (lib.rs:887-901).
        key_upper = key.upper()
        for i, (k, _) in enumerate(self.items):
            if k.upper() == key_upper:
                self.items[i] = (k, value)
                return
        self.items.append((key_upper, value))

    def remove(self, key: str) -> None:
        key_upper = key.upper()
        self.items = [(k, v) for k, v in self.items if k.upper() != key_upper]

    def is_empty(self) -> bool:
        return not self.items

    def get_undo_gain(self) -> int | None:
        """Left-channel cumulative undo steps (first CSV field; lib.rs:916-927)."""
        v = self.get(TAG_MP3GAIN_UNDO)
        if v is None:
            return None
        parts = v.split(",")
        if not parts:
            return None
        try:
            return int(parts[0].strip())
        except ValueError:
            return None

    def set_undo_gain(self, left_gain: int, right_gain: int, wrap: bool) -> None:
        wrap_flag = "W" if wrap else "N"
        value = f"{left_gain:+04d},{right_gain:+04d},{wrap_flag}"
        self.set(TAG_MP3GAIN_UNDO, value)

    def set_minmax(self, min_gain: int, max_gain: int) -> None:
        self.set(TAG_MP3GAIN_MINMAX, f"{min_gain},{max_gain}")


def parse_undo_values(undo_str: str | None) -> tuple[int, int]:
    """Parse MP3GAIN_UNDO into (left, right); lib.rs:815-831."""
    if undo_str is None:
        return (0, 0)
    parts = undo_str.split(",")

    def _parse(s: str) -> int | None:
        try:
            return int(s.strip())
        except ValueError:
            return None

    left = _parse(parts[0]) if parts else None
    left = 0 if left is None else left
    right = _parse(parts[1]) if len(parts) > 1 else None
    right = left if right is None else right
    return (left, right)


def read_ape_tag(data: bytes) -> ApeTag | None:
    items = native.ape_parse(data)
    if items is None:
        return None
    return ApeTag(
        items=[
            (k.decode("utf-8", errors="replace"), v.decode("utf-8", errors="replace"))
            for k, v in items
        ]
    )


def read_ape_tag_from_file(path: os.PathLike | str) -> ApeTag | None:
    with open(path, "rb") as f:
        return read_ape_tag(f.read())


def serialize_ape_tag(tag: ApeTag) -> bytes:
    return native.ape_serialize(
        [(k.encode("utf-8"), v.encode("utf-8")) for k, v in tag.items]
    )


def remove_ape_tag(data: bytes) -> bytes:
    """Strip the trailing APE tag, preserving a trailing ID3v1 (lib.rs:1088-1119)."""
    region = native.ape_remove_region(data)
    if region is None:
        return bytes(data)
    audio_end, tail_start = region
    if tail_start >= 0:
        return bytes(data[:audio_end]) + bytes(data[tail_start:])
    return bytes(data[:audio_end])


def write_ape_tag_to_data(data: bytes, tag: ApeTag) -> bytes:
    """Replace any existing APE tag with `tag`, keeping ID3v1 last (lib.rs:1122-1150)."""
    audio = bytearray(remove_ape_tag(data))
    has_id3v1 = len(audio) >= 128 and audio[-128:-125] == b"TAG"
    tag_data = serialize_ape_tag(tag)
    if has_id3v1:
        id3v1 = bytes(audio[-128:])
        del audio[-128:]
        audio += tag_data
        audio += id3v1
    else:
        audio += tag_data
    return bytes(audio)


def write_ape_tag(path: os.PathLike | str, tag: ApeTag) -> None:
    with open(path, "rb") as f:
        data = f.read()
    new_data = write_ape_tag_to_data(data, tag)
    with open(path, "wb") as f:
        f.write(new_data)


def delete_ape_tag(path: os.PathLike | str) -> None:
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(remove_ape_tag(data))
