"""Hostile inputs: byte mutations of real streams and a crafted AAC stream
whose noise energy overflows float32.

`mutations` is the JAX package's fuzz generator (tests/test_fuzz.py): the
same three mutation kinds drawn with the same `numpy` generator calls, so
one seed gives the same bytes in both packages' tests.

`pns_overflow_stream` is an ADTS stream of sane SCE frames with a few
frames between them whose perceptual-noise-substitution (PNS) bands raise
the noise energy by +60 per band. The front-end range-checks
scalefactors but not noise energies, so the noise gain
2^(0.25 * (energy - 100) - 15) is inf in float32 from energy 672 on: the
decoded samples turn NaN and the IIR carries the NaN through every later
window. The JAX package files each such window in bin 2000 (XLA's
float->int32 convert maps NaN to 0) and reads loudness 0.00 dB.
"""

from __future__ import annotations

import numpy as np

from .craft import BitWriter
from .craft_aac import _array, craft_sce_frame

CB_NOISE = 13  # NOISE_HCB
PNS_BANDS = 49  # every band of a 44.1 kHz long window
PNS_STEP = 60  # the largest scalefactor-codebook delta, +60 per band
SANE_BEFORE, HOT, SANE_AFTER = 60, 3, 60  # frames of the overflow stream


def mutations(data: bytes, rng: np.random.Generator, n: int):
    """n mutated copies of `data`: random byte flips, a truncation or a
    random splice, one kind per copy, drawn from `rng`."""
    for _ in range(n):
        buf = bytearray(data)
        kind = rng.integers(0, 3)
        if kind == 0:  # random byte flips
            for _ in range(int(rng.integers(1, 50))):
                buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        elif kind == 1:  # truncation
            buf = buf[: int(rng.integers(1, len(buf)))]
        else:  # random splice
            a, b = sorted(rng.integers(0, len(buf), size=2))
            buf[a:b] = bytes(rng.integers(0, 256, size=int(rng.integers(0, 64))).tolist())
        yield bytes(buf)


def _pns_frame() -> bytes:
    """One ADTS frame (AAC-LC, 44.1 kHz, mono SCE, ONLY_LONG, sine shape)
    whose PNS_BANDS bands are all noise bands: the first noise energy is
    global_gain - 90 = 10 (its 9-bit PCM start at 256, no offset), each
    later band PNS_STEP above the one before."""
    sf_codes, sf_lens = _array("kAacSfCode"), _array("kAacSfLen")
    bw = BitWriter()
    bw.put(0, 3)  # id_syn_ele = SCE
    bw.put(0, 4)  # element_instance_tag
    bw.put(100, 8)  # global_gain
    bw.put(0, 1)  # ics_reserved
    bw.put(0, 2)  # ONLY_LONG
    bw.put(0, 1)  # sine shape
    bw.put(PNS_BANDS, 6)
    bw.put(0, 1)  # predictor_data_present
    bw.put(CB_NOISE, 4)  # one section of noise bands: 31 + 18
    bw.put(31, 5)
    bw.put(PNS_BANDS - 31, 5)
    bw.put(256, 9)  # the first noise energy: global_gain - 90 + (256 - 256)
    for _ in range(PNS_BANDS - 1):
        bw.put(sf_codes[PNS_STEP + 60], sf_lens[PNS_STEP + 60])
    bw.put(0, 1)  # pulse_data_present
    bw.put(0, 1)  # tns_data_present
    bw.put(0, 1)  # gain_control_data_present
    # Noise bands carry no spectral data.
    bw.put(7, 3)  # END
    payload = bw.bytes()

    frame_len = len(payload) + 7
    h = BitWriter()
    h.put(0xFFF, 12)  # syncword
    h.put(0, 1)   # MPEG-4
    h.put(0, 2)   # layer
    h.put(1, 1)   # protection_absent
    h.put(1, 2)   # profile: AAC-LC
    h.put(4, 4)   # sampling_frequency_index: 44100
    h.put(0, 1)   # private
    h.put(1, 3)   # channel_configuration: mono
    h.put(0, 2)   # original/home
    h.put(0, 2)   # copyright id bit/start
    h.put(frame_len, 13)
    h.put(0x7FF, 11)  # buffer fullness: VBR
    h.put(0, 2)   # raw_data_blocks - 1
    return h.bytes() + payload


def sane_sce_frame() -> bytes:
    """A plain codebook-1 SCE frame (45 bands, energy in bands 10-29, about
    63 dB)."""
    return craft_sce_frame(n_bands=45, energy={b: (1, -1, 1, 0) for b in range(10, 30)},
                           global_gain=170)


def pns_overflow_stream() -> bytes:
    """SANE_BEFORE sane frames, HOT all-PNS frames whose noise energy
    climbs +60 per band (to 10 + 48 * 60 = 2890, past float32's 672),
    SANE_AFTER sane frames: 123 frames, 58 RMS windows."""
    sane = sane_sce_frame()
    return sane * SANE_BEFORE + _pns_frame() * HOT + sane * SANE_AFTER
