"""ID3v2 TXXX tag backend for `-s i` (the torch port's copy of
mp3rgain_tpu/id3v2.py, held equal to it by tests/test_torch_host_copies.py).

The reference warns "-s i (ID3v2 tags) not fully supported, using APEv2"
and falls back (the reference Rust mp3rgain, src/main.rs:54,256-258). This module
implements the mode for real: mp3gain's undo/minmax bookkeeping (and
ReplayGain keys for foreign-tagged files) stored as ID3v2 TXXX frames
instead of APEv2 items, using the same ApeTag container and value
formats so the two backends are interchangeable in bitstream.py.

Scope (deliberate):
- ID3v2.3 and v2.4 tags are read and rewritten in place, preserving
  every frame we don't own, the extended header, and the v2.4 footer.
  Existing padding is reused; the file is only rewritten when the tag
  must grow.
- New tags are created as ID3v2.3 (the most widely read revision).
- ID3v2.2 and unsynchronised tags are refused (Mp3Error) — the caller
  falls back to APEv2 exactly like the reference does for the whole
  mode.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from .ape import ApeTag

# Keys this backend owns (same set the APEv2 engine manages).
OWNED_KEYS = frozenset({
    "MP3GAIN_UNDO",
    "MP3GAIN_MINMAX",
    "MP3GAIN_ALBUM_MINMAX",
    "REPLAYGAIN_TRACK_GAIN",
    "REPLAYGAIN_TRACK_PEAK",
    "REPLAYGAIN_ALBUM_GAIN",
    "REPLAYGAIN_ALBUM_PEAK",
})

_NEW_TAG_PADDING = 1024


class Id3Error(Exception):
    pass


def _syncsafe(n: int) -> bytes:
    return bytes(((n >> s) & 0x7F) for s in (21, 14, 7, 0))


def _unsyncsafe(b: bytes) -> int:
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


@dataclass
class _Tag:
    version: int  # major: 3 or 4
    flags: int
    body: bytes  # frames + padding (after any extended header)
    ext_header: bytes  # raw extended header bytes ("" if absent)
    tag_size: int  # header "size" field (ext header + body, no footer)
    has_footer: bool


def _parse_header(data: bytes) -> _Tag | None:
    if len(data) < 10 or data[:3] != b"ID3":
        return None
    major, _rev, flags = data[3], data[4], data[5]
    size = _unsyncsafe(data[6:10])
    if major == 2:
        raise Id3Error("ID3v2.2 tags are not supported for -s i")
    if major not in (3, 4):
        raise Id3Error(f"unknown ID3v2.{major} tag")
    if flags & 0x80:
        raise Id3Error("unsynchronised ID3v2 tags are not supported for -s i")
    if len(data) < 10 + size:
        raise Id3Error("truncated ID3v2 tag")
    region = data[10 : 10 + size]
    ext = b""
    if flags & 0x40:  # extended header
        if major == 3:
            if len(region) < 4:
                raise Id3Error("truncated ID3v2.3 extended header")
            ext_len = 4 + struct.unpack(">I", region[:4])[0]
        else:
            if len(region) < 4:
                raise Id3Error("truncated ID3v2.4 extended header")
            ext_len = _unsyncsafe(region[:4])  # includes its own size
        if ext_len > len(region):
            raise Id3Error("extended header overruns tag")
        ext, region = region[:ext_len], region[ext_len:]
    return _Tag(
        version=major, flags=flags, body=region, ext_header=ext,
        tag_size=size, has_footer=bool(flags & 0x10),
    )


def _frame_size(version: int, raw: bytes) -> int:
    return _unsyncsafe(raw) if version == 4 else struct.unpack(">I", raw)[0]


def _pack_frame_size(version: int, n: int) -> bytes:
    return _syncsafe(n) if version == 4 else struct.pack(">I", n)


def _iter_frames(tag: _Tag):
    """Yields (frame_id: bytes, flags: bytes, payload: bytes, raw: bytes).
    Stops at padding (a zero byte where a frame ID should start)."""
    body = tag.body
    pos = 0
    while pos + 10 <= len(body):
        fid = body[pos : pos + 4]
        if fid[0] == 0:
            break  # padding
        size = _frame_size(tag.version, body[pos + 4 : pos + 8])
        end = pos + 10 + size
        if end > len(body):
            raise Id3Error("frame overruns ID3v2 tag")
        yield fid, body[pos + 8 : pos + 10], body[pos + 10 : end], body[pos:end]
        pos = end


def _decode_txxx(payload: bytes) -> tuple[str, str] | None:
    """TXXX payload -> (description, value), or None if undecodable."""
    if not payload:
        return None
    enc, rest = payload[0], payload[1:]
    try:
        if enc == 0:
            desc, _, val = rest.partition(b"\x00")
            return desc.decode("latin-1"), val.rstrip(b"\x00").decode("latin-1")
        if enc == 3:
            desc, _, val = rest.partition(b"\x00")
            return desc.decode("utf-8"), val.rstrip(b"\x00").decode("utf-8")
        if enc in (1, 2):  # UTF-16 (with BOM) / UTF-16BE
            codec = "utf-16" if enc == 1 else "utf-16-be"
            idx = rest.find(b"\x00\x00")
            # The terminator is 2-byte aligned from the start of rest.
            while idx != -1 and idx % 2:
                idx = rest.find(b"\x00\x00", idx + 1)
            if idx == -1:
                return None
            desc = rest[:idx].decode(codec)
            val = rest[idx + 2 :]
            if enc == 1 and val[:2] in (b"\xff\xfe", b"\xfe\xff"):
                return desc, val.decode("utf-16").rstrip("\x00")
            return desc, val.decode(codec).rstrip("\x00")
    except UnicodeDecodeError:
        return None
    return None


def _encode_txxx(desc: str, value: str) -> bytes:
    try:
        body = b"\x00" + desc.encode("latin-1") + b"\x00" + value.encode("latin-1")
    except UnicodeEncodeError:
        body = b"\x03" + desc.encode("utf-8") + b"\x00" + value.encode("utf-8")
    return body


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path, data: bytes) -> None:
    tmp = os.fspath(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def check_writable(path: os.PathLike | str) -> None:
    """Raise Id3Error if the file's existing ID3v2 tag can't be
    rewritten by this backend (v2.2 / unsynchronised). Called before
    gain surgery so an unsupported tag fails the whole operation up
    front instead of leaving applied gain without undo bookkeeping."""
    _parse_header(_read(path))


def read_id3_tag_from_file(path: os.PathLike | str) -> ApeTag | None:
    """The owned TXXX items as an ApeTag, or None if no usable tag."""
    data = _read(path)
    try:
        tag = _parse_header(data)
    except Id3Error:
        return None
    if tag is None:
        return None
    out = ApeTag()
    try:
        for fid, _flags, payload, _raw in _iter_frames(tag):
            if fid != b"TXXX":
                continue
            decoded = _decode_txxx(payload)
            if decoded and decoded[0].upper() in OWNED_KEYS:
                out.set(decoded[0].upper(), decoded[1])
    except Id3Error:
        return None
    return None if out.is_empty() else out


def write_id3_tag(path: os.PathLike | str, tag_items: ApeTag) -> None:
    """Set/replace the owned TXXX frames, preserving everything else.

    Reuses existing padding when the new frames fit inside the current
    tag size (in-place header+region rewrite, audio untouched);
    otherwise rewrites the file with the tag grown by _NEW_TAG_PADDING.
    """
    data = _read(path)
    tag = _parse_header(data)  # raises Id3Error on v2.2/unsync

    new_frames = b""
    version = tag.version if tag else 3
    for key, value in tag_items.items:
        payload = _encode_txxx(key, value)
        new_frames += (
            b"TXXX" + _pack_frame_size(version, len(payload)) + b"\x00\x00"
            + payload
        )

    if tag is None:
        header = (b"ID3" + bytes((3, 0, 0))
                  + _syncsafe(len(new_frames) + _NEW_TAG_PADDING))
        _write(path, header + new_frames + bytes(_NEW_TAG_PADDING) + data)
        return

    kept = b""
    for fid, _flags, payload, raw in _iter_frames(tag):
        if fid == b"TXXX":
            decoded = _decode_txxx(payload)
            if decoded and decoded[0].upper() in OWNED_KEYS:
                continue  # replaced below
        kept += raw
    frames = kept + new_frames

    audio_off = 10 + tag.tag_size + (10 if tag.has_footer else 0)
    fixed = len(tag.ext_header)
    if fixed + len(frames) <= tag.tag_size and not tag.has_footer:
        # Fits in the existing region: keep the declared size, pad out.
        pad = tag.tag_size - fixed - len(frames)
        region = tag.ext_header + frames + bytes(pad)
        with open(path, "r+b") as f:
            f.seek(10)
            f.write(region)
        return

    new_size = fixed + len(frames) + _NEW_TAG_PADDING
    header = (b"ID3" + bytes((tag.version, 0, tag.flags & ~0x10))
              + _syncsafe(new_size))
    body = tag.ext_header + frames + bytes(_NEW_TAG_PADDING)
    _write(path, header + body + data[audio_off:])


def delete_id3_tag_items(path: os.PathLike | str, keys=None) -> None:
    """Remove owned TXXX frames (or `keys`); drop the whole tag if no
    frames remain, else shrink-in-place by converting to padding."""
    data = _read(path)
    try:
        tag = _parse_header(data)
    except Id3Error:
        return
    if tag is None:
        return
    targets = frozenset(k.upper() for k in keys) if keys else OWNED_KEYS

    kept = b""
    removed = False
    for fid, _flags, payload, raw in _iter_frames(tag):
        if fid == b"TXXX":
            decoded = _decode_txxx(payload)
            if decoded and decoded[0].upper() in targets:
                removed = True
                continue
        kept += raw
    if not removed:
        return
    audio_off = 10 + tag.tag_size + (10 if tag.has_footer else 0)
    if not kept and not tag.ext_header:
        _write(path, data[audio_off:])  # tag is now empty: drop it
        return
    pad = tag.tag_size - len(tag.ext_header) - len(kept)
    if pad >= 0 and not tag.has_footer:
        region = tag.ext_header + kept + bytes(pad)
        with open(path, "r+b") as f:
            f.seek(10)
            f.write(region)
        return
    header = (b"ID3" + bytes((tag.version, 0, tag.flags & ~0x10))
              + _syncsafe(len(tag.ext_header) + len(kept)))
    _write(path, header + tag.ext_header + kept + data[audio_off:])
