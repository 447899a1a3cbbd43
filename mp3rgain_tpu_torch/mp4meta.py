"""MP4/M4A metadata API: iTunes freeform ReplayGain tags.

The torch port's copy of mp3rgain_tpu/mp4meta.py. It differs in one
place: the ctypes declarations of the three MP4 entry points live in
native._declare, so importing this module loads no library (the JAX
package's copy declares them at import); tests/test_torch_host_copies.py
holds the rest of its code and its outputs equal to the original.
Mirrors the reference Rust mp3rgain's public surface (src/mp4meta.rs):
ReplayGainTags (with "+3.50 dB" / "0.987650" value formats, mp4meta.rs:126-134),
read/write/delete_replaygain_tags, is_mp4_file. The byte engine is the native
C++ MP4 box engine (_native/mp4box.cpp).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

from .native import _inbuf, _lib, _u8p

RG_TRACK_GAIN = "replaygain_track_gain"
RG_TRACK_PEAK = "replaygain_track_peak"
RG_ALBUM_GAIN = "replaygain_album_gain"
RG_ALBUM_PEAK = "replaygain_album_peak"
ITUNES_NAMESPACE = "com.apple.iTunes"


class Mp4Error(RuntimeError):
    pass


@dataclass
class ReplayGainTags:
    track_gain: str | None = None
    track_peak: str | None = None
    album_gain: str | None = None
    album_peak: str | None = None

    def set_track(self, gain_db: float, peak: float) -> None:
        self.track_gain = f"{gain_db:+.2f} dB"
        self.track_peak = f"{peak:.6f}"

    def set_album(self, gain_db: float, peak: float) -> None:
        self.album_gain = f"{gain_db:+.2f} dB"
        self.album_peak = f"{peak:.6f}"

    def is_empty(self) -> bool:
        return (
            self.track_gain is None
            and self.track_peak is None
            and self.album_gain is None
            and self.album_peak is None
        )

    def _pack(self) -> bytes:
        out = bytearray()
        for v in (self.track_gain, self.track_peak, self.album_gain, self.album_peak):
            if v is None:
                out += b"\xff\xff\xff\xff"
            else:
                b = v.encode("utf-8")
                out += len(b).to_bytes(4, "little") + b
        return bytes(out)

    @staticmethod
    def _unpack(raw: bytes) -> "ReplayGainTags":
        vals: list[str | None] = []
        pos = 0
        for _ in range(4):
            n = int.from_bytes(raw[pos : pos + 4], "little")
            pos += 4
            if n == 0xFFFFFFFF:
                vals.append(None)
            else:
                vals.append(raw[pos : pos + n].decode("utf-8", errors="replace"))
                pos += n
        return ReplayGainTags(*vals)


def is_mp4_file(path: os.PathLike | str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False
    return bool(_lib.mg_mp4_is_mp4(_inbuf(head), len(head)))


def read_replaygain_tags_from_data(data: bytes) -> ReplayGainTags:
    cap = len(data) + 64
    out = (ctypes.c_uint8 * cap)()
    n = _lib.mg_mp4_read_tags(_inbuf(data), len(data), ctypes.cast(out, _u8p), cap)
    if n < 0:
        raise Mp4Error("mp4 tag read failed")
    return ReplayGainTags._unpack(bytes(out[:n]))


def read_replaygain_tags(path: os.PathLike | str) -> ReplayGainTags:
    with open(path, "rb") as f:
        return read_replaygain_tags_from_data(f.read())


def write_replaygain_tags_to_data(data: bytes, tags: ReplayGainTags) -> bytes:
    packed = tags._pack()
    cap = len(data) + len(packed) + 4096
    out = (ctypes.c_uint8 * cap)()
    n = _lib.mg_mp4_write_tags(
        _inbuf(data), len(data), _inbuf(packed), len(packed), ctypes.cast(out, _u8p), cap
    )
    if n == -1:
        raise Mp4Error("No moov box found in MP4 file")
    if n < 0:
        raise Mp4Error("mp4 rewrite buffer too small")
    return bytes(out[:n])


def write_replaygain_tags(path: os.PathLike | str, tags: ReplayGainTags) -> None:
    with open(path, "rb") as f:
        data = f.read()
    new_data = write_replaygain_tags_to_data(data, tags)
    with open(path, "wb") as f:
        f.write(new_data)


def delete_replaygain_tags(path: os.PathLike | str) -> None:
    write_replaygain_tags(path, ReplayGainTags())
