"""MP3 (MPEG-1/2/2.5 Layer III) tracks: how the library writes them and how
the plain reference analyses them.

A format module gives the library and the check what they need of one
codec, found by the name a configuration's format gives under "module":

- EXTENSION: the track files' extension;
- layout(data): one clip, with .samples (per channel, one copy),
  .sample_rate and .channels;
- write(path, layout, copies, step): writes a track of `copies` copies of
  the clip at level `step`; returns what the track holds for the kernel
  metrics, by name (here main_data_bytes, side_info_bytes,
  granule_channels);
- analyzer(dtype, device): the reference, whose .track(bytes) gives the
  track's .gain, .peak and .histogram.

Here a track is the clip's ID3 tag and info frame, `copies` copies of its
audio frames (harness/tile.py), then its tail, with every granule's
global_gain moved by `step`: mp3gain's own lossless edit, which scales the
decoded level by 2^(step/4). Granules that carry no audio bits are clamped
to the field's range instead.
"""

from __future__ import annotations

import functools

import torch

from harness import tile
from reference import mp3dec
from reference.track import Analyzer

EXTENSION = "mp3"


def layout(data: bytes) -> tile.Layout:
    return tile.mp3_layout(data)


@functools.lru_cache(maxsize=128)
def edit_gain(audio: bytes, step: int) -> bytes:
    """The audio frames with every granule's global_gain moved by `step`;
    raises ValueError where a granule that carries audio would leave
    [0, 255]."""
    buf = bytearray(audio)
    for f in mp3dec.walk(audio):
        if f.crc:
            raise ValueError("CRC-protected frames are not edited")
        for row in f.gc:
            for g in row:
                new = g["global_gain"] + step
                if not 0 <= new <= 255:
                    if g["part2_3_length"]:
                        raise ValueError(f"global_gain {g['global_gain']} + {step} is out of range")
                    new = min(max(new, 0), 255)
                bit = f.side_offset * 8 + g["global_gain_bit"]
                byte, shift = bit >> 3, 16 - 8 - (bit & 7)
                word = (buf[byte] << 8) | buf[byte + 1]
                word = (word & ~(0xFF << shift)) | (new << shift)
                buf[byte], buf[byte + 1] = word >> 8, word & 0xFF
    return bytes(buf)


@functools.lru_cache(maxsize=64)
def frame_counts(audio: bytes) -> tuple[int, int, int]:
    """(main-data bytes, side-info bytes, granule-channels) of audio frames."""
    md = si = gc = 0
    for f in mp3dec.walk(audio):
        si += f.side_len
        md += f.offset + f.size - f.body_offset
        gc += f.granules * f.channels
    return md, si, gc


def write(path: str, lay: tile.Layout, copies: int, step: int) -> dict:
    audio = edit_gain(lay.audio, step)
    with open(path, "wb") as f:
        f.write(lay.head)
        for _ in range(copies):
            f.write(audio)
        f.write(lay.tail)
    md, si, gc = frame_counts(lay.audio)
    return {"main_data_bytes": copies * md, "side_info_bytes": copies * si,
            "granule_channels": copies * gc}


def analyzer(dtype=torch.float64, device: str = "cpu") -> Analyzer:
    return Analyzer(dtype, device)
