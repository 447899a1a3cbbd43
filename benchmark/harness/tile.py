"""Long streams from short ones: N copies of a clip's audio frames.

The benchmark's frozen copy of the MP3 half of
mp3rgain_tpu_torch/testing/tile.py, so that a change to the program cannot
change the benchmark's inputs.

A real library holds tracks of 3 to 120 minutes; the committed clips last
1 to 60 s. tile_mp3 writes a stream that plays a clip N times
over, so the analysis can be held at real track lengths on a machine that
has no encoder:

- MP3: the ID3v2 tag and the Xing/LAME info frame of the first copy, then
  the audio frames of N copies, then whatever followed the audio (an
  ID3v1 or APE tag) once. Copies 2..N bring no tag and no info frame. A
  copy's first audio frame must have main_data_begin 0 (LAME's first
  frame has no reservoir to borrow from), so every granule's main data
  lies in the copy it belongs to and the bit reservoir stays valid.

It writes to the path it is given, one copy at a time, and returns the
layout of one copy.
"""

from __future__ import annotations

from dataclasses import dataclass

_MPEG1 = 3
_MPEG2 = 2
_MPEG25 = 0
_BITRATES = {
    True: (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320),  # MPEG-1
    False: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160),  # MPEG-2/2.5
}
_RATES = {_MPEG1: (44100, 48000, 32000), _MPEG2: (22050, 24000, 16000),
          _MPEG25: (11025, 12000, 8000)}
_ADTS_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050, 16000, 12000,
               11025, 8000)


@dataclass(frozen=True)
class Layout:
    """One copy of a clip: its bytes are head + audio + tail, its audio
    `frames` frames of
    `samples_per_frame` samples per channel."""

    head: bytes
    audio: bytes
    tail: bytes
    frames: int
    samples_per_frame: int
    sample_rate: int
    channels: int

    @property
    def samples(self) -> int:
        """Decoded samples per channel of one copy."""
        return self.frames * self.samples_per_frame


def _mp3_header(data: bytes, pos: int):
    """(frame_len, mpeg1, sample_rate, channels, side_info_offset) of the
    Layer III header at pos, or None."""
    if pos + 4 > len(data) or data[pos] != 0xFF or (data[pos + 1] & 0xE0) != 0xE0:
        return None
    b1, b2, b3 = data[pos + 1], data[pos + 2], data[pos + 3]
    version, layer = (b1 >> 3) & 3, (b1 >> 1) & 3
    br_idx, sr_idx, pad = b2 >> 4, (b2 >> 2) & 3, (b2 >> 1) & 1
    if version == 1 or layer != 1 or br_idx in (0, 15) or sr_idx == 3:
        return None
    mpeg1 = version == _MPEG1
    sr = _RATES[version][sr_idx]
    kbps = _BITRATES[mpeg1][br_idx]
    size = (144000 if mpeg1 else 72000) * kbps // sr + pad
    channels = 1 if (b3 >> 6) == 3 else 2
    side_offset = 4 if b1 & 1 else 6  # protection bit clear: a CRC follows
    return size, mpeg1, sr, channels, side_offset


def _side_info_len(mpeg1: bool, channels: int) -> int:
    if mpeg1:
        return 17 if channels == 1 else 32
    return 9 if channels == 1 else 17


def _id3v2_end(data: bytes) -> int:
    if len(data) < 10 or data[:3] != b"ID3":
        return 0
    size = 0
    for b in data[6:10]:
        size = (size << 7) | (b & 0x7F)
    footer = 10 if data[5] & 0x10 else 0
    return 10 + size + footer


def mp3_layout(data: bytes) -> Layout:
    """Split an MP3 clip into head (ID3v2 tag and info frame), audio
    frames and tail. Raises ValueError on a free-format or non-contiguous
    stream, or when the first audio frame borrows from a reservoir."""
    pos = _id3v2_end(data)
    first = None
    frames = 0
    spf = rate = channels = 0
    while True:
        h = _mp3_header(data, pos)
        if h is None or pos + h[0] > len(data):
            break
        size, mpeg1, sr, nch, side = h
        body = pos + side + _side_info_len(mpeg1, nch)
        info = data[body:body + 4] in (b"Xing", b"Info")
        if first is None and not info:
            first = pos
            spf, rate, channels = (1152 if mpeg1 else 576), sr, nch
            mdb = ((data[pos + side] << 1) | (data[pos + side + 1] >> 7)
                   if mpeg1 else data[pos + side])
            if mdb != 0:
                raise ValueError(f"first audio frame has main_data_begin {mdb}")
        elif first is not None:
            if info:
                raise ValueError(f"an info frame among the audio frames at byte {pos}")
            if (sr, nch) != (rate, channels):
                raise ValueError(f"the stream changes format at byte {pos}")
        if first is not None:
            frames += 1
        pos += size
    if first is None:
        raise ValueError("no Layer III audio frame")
    return Layout(data[:first], data[first:pos], data[pos:], frames, spf, rate, channels)


def _write(layout: Layout, dst, copies: int) -> Layout:
    if copies < 1:
        raise ValueError(f"copies must be at least 1, got {copies}")
    with open(dst, "wb") as f:
        f.write(layout.head)
        for _ in range(copies):
            f.write(layout.audio)
        f.write(layout.tail)
    return layout


def tile_mp3(src: bytes, dst, copies: int) -> Layout:
    """Write `copies` copies of MP3 clip `src` (bytes) as one stream to
    path `dst`; returns one copy's layout."""
    return _write(mp3_layout(src), dst, copies)
