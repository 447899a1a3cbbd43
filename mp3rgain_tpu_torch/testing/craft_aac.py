"""Hand-crafted AAC-LC ADTS streams for paths no encoder emits
(pulse data; TNS filters spanning past tns_max_bands).

Builds a syntactically complete single-SCE raw_data_block bit-by-bit:
long windows, codebook 1 spectra, optional pulse_data and tns_data.
Huffman code tables are read back from the generated
`_native/aac_tables.h` so the crafter stays in sync with the decoder.
"""

from __future__ import annotations

import re
from functools import lru_cache
from pathlib import Path

from ..decode.aac_format_tables import SWB_1024_MAP, SWB_LONG_TABLES
from .craft import BitWriter

_TABLES_H = Path(__file__).resolve().parent.parent / "_native" / "aac_tables.h"

# 44.1 kHz (sampling frequency index 4) long-window swb offsets, 49 bands.
SWB_44_LONG = SWB_LONG_TABLES[SWB_1024_MAP[4]]


@lru_cache(maxsize=None)
def _array(name: str) -> list[int]:
    text = _TABLES_H.read_text()
    m = re.search(rf"{name}\[\d+\] = \{{\n  ([^}}]*)\n\}};", text)
    assert m, name
    return [int(x) for x in m.group(1).split(",")]


def _put_cb1_quad(bw: BitWriter, quad) -> None:
    """Codebook 1: dim 4, signed, lav 1 (values in -1..1, no sign bits)."""
    assert len(quad) == 4 and all(-1 <= v <= 1 for v in quad)
    idx = 0
    for v in quad:
        idx = idx * 3 + (v + 1)
    codes, lens = _array("kAacSpecCode1"), _array("kAacSpecLen1")
    bw.put(codes[idx], lens[idx])


def craft_sce_frame(
    band_quads: list[tuple[int, int, int, int]] | None = None,
    *,
    n_bands: int | None = None,
    energy: dict[int, tuple[int, int, int, int]] | None = None,
    pulses: list[tuple[int, int]] | None = None,
    pulse_start_sfb: int = 0,
    tns: dict | None = None,
    global_gain: int = 100,
) -> bytes:
    """One ADTS frame: SCE, 44.1 kHz, ONLY_LONG, sine shape.

    Two spectral conventions:
    - band_quads: one 4-value tuple per band, bands 0..len-1 (each of the
      first 11 bands at 44.1 kHz is exactly 4 lines wide);
    - n_bands + energy: all bands 0..n_bands-1 coded with codebook 1;
      `energy[sfb]` is a quad repeated across that band, others zero.

    pulses: up to 4 (offset, amp) pairs accumulating from
    swb_offset[pulse_start_sfb] (ISO 14496-3 4.6.3.3).
    tns: {"length": int, "order": int, "coefs": [3-bit ints],
    "direction": 0/1} — one long-window filter, coef_res=0, compress=0.
    """
    if band_quads is not None:
        assert n_bands is None and energy is None
        n_bands = len(band_quads)
        energy = {i: q for i, q in enumerate(band_quads)}
    energy = energy or {}
    assert 1 <= n_bands <= 49

    bw = BitWriter()
    bw.put(0, 3)  # id_syn_ele = SCE
    bw.put(0, 4)  # element_instance_tag
    bw.put(global_gain, 8)
    # ics_info
    bw.put(0, 1)  # ics_reserved
    bw.put(0, 2)  # window_sequence = ONLY_LONG
    bw.put(0, 1)  # window_shape = sine
    bw.put(n_bands, 6)
    bw.put(0, 1)  # predictor_data_present
    # section_data: one codebook-1 section covering all bands (long
    # windows: 5-bit increments, 31 = escape-and-continue)
    bw.put(1, 4)  # sect_cb
    rest = n_bands
    while rest >= 31:
        bw.put(31, 5)
        rest -= 31
    bw.put(rest, 5)
    # scale_factor_data: dscf=0 per coded band (sf == global_gain)
    sf_codes, sf_lens = _array("kAacSfCode"), _array("kAacSfLen")
    for _ in range(n_bands):
        bw.put(sf_codes[60], sf_lens[60])
    # pulse_data
    if pulses:
        assert 1 <= len(pulses) <= 4
        bw.put(1, 1)
        bw.put(len(pulses) - 1, 2)
        bw.put(pulse_start_sfb, 6)
        for off, amp in pulses:
            assert 0 <= off < 32 and 0 <= amp < 16
            bw.put(off, 5)
            bw.put(amp, 4)
    else:
        bw.put(0, 1)
    # tns_data
    if tns:
        bw.put(1, 1)
        bw.put(1, 2)  # n_filt (long: 2 bits)
        bw.put(0, 1)  # coef_res: 3-bit coefficients
        bw.put(tns["length"], 6)
        bw.put(tns["order"], 5)
        bw.put(tns.get("direction", 0), 1)
        bw.put(0, 1)  # coef_compress
        coefs = tns["coefs"]
        assert len(coefs) == tns["order"]
        for c in coefs:
            assert 0 <= c < 8
            bw.put(c, 3)
    else:
        bw.put(0, 1)
    bw.put(0, 1)  # gain_control_data_present
    for sfb in range(n_bands):
        width = SWB_44_LONG[sfb + 1] - SWB_44_LONG[sfb]
        quad = energy.get(sfb, (0, 0, 0, 0))
        for _ in range(width // 4):
            _put_cb1_quad(bw, quad)
    bw.put(7, 3)  # id_syn_ele = END
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


def craft_sce_stream(n_frames: int = 40, **kw) -> bytes:
    return craft_sce_frame(**kw) * n_frames


def _put_sections(bw: BitWriter, cbs: list[int]) -> None:
    """section_data for long windows from a per-band codebook list."""
    i = 0
    while i < len(cbs):
        j = i
        while j < len(cbs) and cbs[j] == cbs[i]:
            j += 1
        bw.put(cbs[i], 4)
        rest = j - i
        while rest >= 31:
            bw.put(31, 5)
            rest -= 31
        bw.put(rest, 5)
        i = j


def craft_cpe_frame(
    n_bands: int,
    left_energy: dict[int, tuple[int, int, int, int]],
    right_energy: dict[int, tuple[int, int, int, int]] | None = None,
    is_bands: dict[int, tuple[int, int]] | None = None,
    ms_used: set[int] = frozenset(),
    global_gain: int = 100,
) -> bytes:
    """One ADTS frame: CPE, 44.1 kHz, ONLY_LONG, common window.

    is_bands: {sfb: (codebook 14|15, is_position)} — right-channel bands
    coded as intensity (IS_MINUS=14 negative, IS_PLUS=15 positive);
    is_position values are sent DPCM through the scalefactor codebook.
    ms_used: sfbs with the M/S bit set (ms_mask_present=1). On an
    intensity band this inverts the intensity direction.
    """
    is_bands = is_bands or {}
    right_energy = right_energy or {}
    assert not (set(is_bands) & set(right_energy))
    assert 1 <= n_bands <= 49

    sf_codes, sf_lens = _array("kAacSfCode"), _array("kAacSfLen")
    cb_right = [
        is_bands[b][0] if b in is_bands else 1 for b in range(n_bands)
    ]

    bw = BitWriter()
    bw.put(1, 3)  # id_syn_ele = CPE
    bw.put(0, 4)  # element_instance_tag
    bw.put(1, 1)  # common_window
    # shared ics_info
    bw.put(0, 1)  # ics_reserved
    bw.put(0, 2)  # ONLY_LONG
    bw.put(0, 1)  # sine shape
    bw.put(n_bands, 6)
    bw.put(0, 1)  # predictor_data_present
    bw.put(1, 2)  # ms_mask_present = 1 (per-band bits)
    for b in range(n_bands):
        bw.put(1 if b in ms_used else 0, 1)

    for ch, (energy, cbs) in enumerate(
        [(left_energy, [1] * n_bands), (right_energy, cb_right)]
    ):
        bw.put(global_gain, 8)
        _put_sections(bw, cbs)
        # scale_factor_data: separate DPCM chains for sf (from
        # global_gain) and intensity position (from 0).
        is_prev = 0
        for b in range(n_bands):
            if cbs[b] in (14, 15):
                delta = is_bands[b][1] - is_prev
                is_prev = is_bands[b][1]
                assert -60 <= delta <= 60
                bw.put(sf_codes[delta + 60], sf_lens[delta + 60])
            else:
                bw.put(sf_codes[60], sf_lens[60])  # dscf = 0
        bw.put(0, 1)  # pulse_data_present
        bw.put(0, 1)  # tns_data_present
        bw.put(0, 1)  # gain_control_data_present
        for b in range(n_bands):
            if cbs[b] in (14, 15):
                continue  # intensity bands carry no spectral data
            width = SWB_44_LONG[b + 1] - SWB_44_LONG[b]
            quad = energy.get(b, (0, 0, 0, 0))
            for _ in range(width // 4):
                _put_cb1_quad(bw, quad)
    bw.put(7, 3)  # END
    payload = bw.bytes()

    frame_len = len(payload) + 7
    h = BitWriter()
    h.put(0xFFF, 12)
    h.put(0, 1)
    h.put(0, 2)
    h.put(1, 1)
    h.put(1, 2)   # AAC-LC
    h.put(4, 4)   # 44100
    h.put(0, 1)
    h.put(2, 3)   # channel_configuration: stereo
    h.put(0, 2)
    h.put(0, 2)
    h.put(frame_len, 13)
    h.put(0x7FF, 11)
    h.put(0, 2)
    return h.bytes() + payload


def craft_cpe_stream(n_frames: int = 40, **kw) -> bytes:
    return craft_cpe_frame(**kw) * n_frames
