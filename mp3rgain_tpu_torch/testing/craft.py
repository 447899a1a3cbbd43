"""The torch port's copy of mp3rgain_tpu/testing/craft.py, held equal to it
by tests/test_torch_host_copies.py.

Hand-crafted MP3 streams for decoder paths no encoder emits.

Builds bit-exact MPEG1 Layer III frames directly (header, side info,
scalefactors, Huffman data) to exercise intensity stereo — lame never
produces it, so these synthetic streams are the only way to validate the
intensity reconstruction against the golden decoder (libmpg123).

All frames are 44.1 kHz, 128 kbps, joint stereo, long blocks, with the
whole big_values region coded by Huffman table 1 (alphabet {0,1}, no
linbits): (0,0)->"1", (1,0)->"01", (0,1)->"001", (1,1)->"000", each
nonzero value followed by one sign bit.
"""

from __future__ import annotations

# 44.1 kHz long-block scalefactor band starts (ISO 11172-3 table B.8b).
BAND_START_44 = [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90,
                 110, 134, 162, 196, 238, 288, 342, 418, 576]

# 22.05 kHz LSF long-block band starts (ISO 13818-3 table B.2).
BAND_START_22 = [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140,
                 168, 200, 238, 284, 336, 396, 464, 522, 576]


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def __len__(self) -> int:
        return len(self.bits)

    def bytes(self, pad_to: int | None = None) -> bytes:
        bits = self.bits[:]
        while len(bits) % 8:
            bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        if pad_to is not None:
            assert len(out) <= pad_to, (len(out), pad_to)
            out.extend(bytes(pad_to - len(out)))
        return bytes(out)


def _encode_table1_pairs(bw: BitWriter, ones_lines: set[int], n_lines: int) -> None:
    """Huffman-code lines 0..n_lines-1 with table 1; `ones_lines` get +1."""
    assert n_lines % 2 == 0
    for i in range(0, n_lines, 2):
        x = 1 if i in ones_lines else 0
        y = 1 if i + 1 in ones_lines else 0
        code, length = {(0, 0): (0b1, 1), (1, 0): (0b01, 2),
                        (0, 1): (0b001, 3), (1, 1): (0b000, 3)}[(x, y)]
        bw.put(code, length)
        if x:
            bw.put(0, 1)  # positive sign
        if y:
            bw.put(0, 1)


def _lines_for_bands(bands: list[int], starts=BAND_START_44) -> set[int]:
    lines: set[int] = set()
    for b in bands:
        lines.update(range(starts[b], starts[b + 1]))
    return lines


def craft_joint_stereo_frame(
    mode_extension: int,
    is_positions: list[int],
    ch0_bands: list[int],
    ch1_bands: list[int] = (),
    global_gain: int = 190,
) -> bytes:
    """One MPEG1 44.1 kHz 128 kbps joint-stereo long-block frame.

    - mode_extension: 1 = intensity, 2 = MS, 3 = MS+intensity.
    - is_positions: 10 values (0..7) for sfbs 11..20, sent as ch1
      scalefactors with scalefac_compress=3 (slen (0, 3)); 7 is the
      illegal position (decoders must pass the band through unchanged).
    - ch0_bands / ch1_bands: sfb indices (0..20) filled with +1 lines.
      Bands above ch1's last coded band are the intensity region.
    """
    assert len(is_positions) == 10
    assert all(0 <= p <= 7 for p in is_positions)
    assert ch0_bands, "ch0 must carry spectrum"

    header = bytes([0xFF, 0xFB, 0x90, 0x40 | (mode_extension << 4)])

    ch_lines = []
    ch_big_values = []
    for bands in (list(ch0_bands), list(ch1_bands)):
        lines = _lines_for_bands(bands)
        n_lines = BAND_START_44[max(bands) + 1] if bands else 0
        ch_lines.append(lines)
        ch_big_values.append(n_lines // 2)

    # Measure per-channel main_data bit counts by dry-writing once.
    def write_main(bw: BitWriter, ch: int) -> None:
        if ch == 1:
            # scalefac_compress=3 -> slen (0, 3): sfbs 0..10 no bits,
            # sfbs 11..20 get 3 bits each (intensity positions).
            for p in is_positions:
                bw.put(p, 3)
        _encode_table1_pairs(bw, ch_lines[ch], ch_big_values[ch] * 2)

    part23 = []
    for ch in range(2):
        tmp = BitWriter()
        write_main(tmp, ch)
        part23.append(len(tmp))
    assert all(p < 4096 for p in part23)

    side = BitWriter()
    side.put(0, 9)   # main_data_begin
    side.put(0, 3)   # private
    side.put(0, 8)   # scfsi (both channels, 4 bands each)
    for _gr in range(2):
        for ch in range(2):
            side.put(part23[ch], 12)
            side.put(ch_big_values[ch], 9)
            side.put(global_gain, 8)
            side.put(0 if ch == 0 else 3, 4)  # scalefac_compress
            side.put(0, 1)   # window_switching
            for _ in range(3):
                side.put(1, 5)   # table_select: table 1 everywhere
            side.put(0, 4)   # region0_count
            side.put(7, 3)   # region1_count (regions only pick tables)
            side.put(0, 1)   # preflag
            side.put(0, 1)   # scalefac_scale
            side.put(0, 1)   # count1table_select
    side_bytes = side.bytes(pad_to=32)

    main = BitWriter()
    for _gr in range(2):
        for ch in range(2):
            start = len(main)
            write_main(main, ch)
            assert len(main) - start == part23[ch]
    frame_size = 417  # floor(144 * 128000 / 44100), padding bit 0
    main_bytes = main.bytes(pad_to=frame_size - 4 - 32)

    return header + side_bytes + main_bytes


def craft_mixed_block_frame(
    ones_lines: set[int] | None = None,
    subblock_gain: tuple[int, int, int] = (0, 1, 2),
    global_gain: int = 190,
) -> bytes:
    """One MPEG1 44.1 kHz 128 kbps MONO frame with mixed blocks.

    window_switching=1, block_type=2, mixed_block_flag=1: the first two
    subbands (lines 0..35) stay long, the rest are short blocks with
    per-window subblock gains. scalefac_compress=0 (no scalefactor bits);
    both window-switch Huffman regions use table 1.
    """
    if ones_lines is None:
        # Energy in the long region and across the short-region windows.
        ones_lines = set(range(0, 36, 3)) | set(range(36, 120, 5))
    n_lines = 120
    assert max(ones_lines) < n_lines and n_lines % 2 == 0
    big_values = n_lines // 2

    header = bytes([0xFF, 0xFB, 0x90, 0xC0])  # mono

    tmp = BitWriter()
    _encode_table1_pairs(tmp, ones_lines, n_lines)
    part23 = len(tmp)

    side = BitWriter()
    side.put(0, 9)   # main_data_begin
    side.put(0, 5)   # private (mono: 5 bits)
    side.put(0, 4)   # scfsi
    for _gr in range(2):
        side.put(part23, 12)
        side.put(big_values, 9)
        side.put(global_gain, 8)
        side.put(0, 4)   # scalefac_compress
        side.put(1, 1)   # window_switching
        side.put(2, 2)   # block_type 2 (short)
        side.put(1, 1)   # mixed_block_flag
        side.put(1, 5)   # table_select[0]
        side.put(1, 5)   # table_select[1]
        for sg in subblock_gain:
            side.put(sg, 3)
        side.put(0, 1)   # preflag
        side.put(0, 1)   # scalefac_scale
        side.put(0, 1)   # count1table_select
    side_bytes = side.bytes(pad_to=17)

    main = BitWriter()
    for _gr in range(2):
        _encode_table1_pairs(main, ones_lines, n_lines)
    frame_size = 417
    main_bytes = main.bytes(pad_to=frame_size - 4 - 17)

    return header + side_bytes + main_bytes


def craft_mixed_block_stream(n_frames: int = 40, **kw) -> bytes:
    return craft_mixed_block_frame(**kw) * n_frames


def _crc16_mpeg(data: bytes) -> int:
    """MPEG audio CRC-16 (poly 0x8005, init 0xFFFF, MSB-first)."""
    crc = 0xFFFF
    for byte in data:
        for bit in range(7, -1, -1):
            fb = ((crc >> 15) ^ (byte >> bit)) & 1
            crc = ((crc << 1) & 0xFFFF) ^ (0x8005 if fb else 0)
    return crc


def add_crc_protection(frame: bytes, side_info_len: int) -> bytes:
    """Convert an unprotected frame to a CRC-protected one (protection
    bit 0, 16-bit CRC over header bytes 2..3 + side info inserted after
    the header). Two trailing pad bytes are dropped to keep the frame
    size field consistent."""
    assert frame[1] & 1, "frame already protected"
    header = bytes([frame[0], frame[1] & 0xFE, frame[2], frame[3]])
    side = frame[4 : 4 + side_info_len]
    crc = _crc16_mpeg(header[2:4] + side)
    body = frame[4:-2]
    return header + bytes([crc >> 8, crc & 0xFF]) + body


# MPEG1 slen pairs per scalefac_compress index.
SLEN = [(0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
        (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3)]

# scfsi band groups (sfb ranges) for MPEG1 long blocks.
SCFSI_GROUPS = [(0, 6), (6, 11), (11, 16), (16, 21)]


def craft_scalefactor_frame(
    scf: list[int],
    scalefac_compress: int = 13,
    preflag: int = 0,
    scalefac_scale: int = 0,
    scfsi: int = 0,
    global_gain: int = 200,
) -> bytes:
    """One MPEG1 44.1 kHz 128 kbps MONO long-block frame exercising the
    scalefactor machinery: nonzero scalefactors, preflag, scalefac_scale,
    and scfsi group reuse (granule 1 skips groups whose scfsi bit is set).

    scf: 21 values; sfbs 0..10 use slen1 bits, 11..20 slen2.
    """
    assert len(scf) == 21
    slen1, slen2 = SLEN[scalefac_compress]
    for i, v in enumerate(scf):
        assert 0 <= v < (1 << (slen1 if i < 11 else slen2)), (i, v)

    header = bytes([0xFF, 0xFB, 0x90, 0xC0])  # mono
    ones = _lines_for_bands([0, 2, 5, 8, 12, 15, 18, 20])
    big_values = BAND_START_44[21] // 2  # lines 0..417

    def write_main(bw: BitWriter, gr: int) -> None:
        for gi, (lo, hi) in enumerate(SCFSI_GROUPS):
            if gr == 1 and (scfsi >> (3 - gi)) & 1:
                continue  # reused from granule 0
            for b in range(lo, hi):
                bw.put(scf[b], slen1 if b < 11 else slen2)
        _encode_table1_pairs(bw, ones, big_values * 2)

    part23 = []
    for gr in range(2):
        tmp = BitWriter()
        write_main(tmp, gr)
        part23.append(len(tmp))

    side = BitWriter()
    side.put(0, 9)
    side.put(0, 5)   # private (mono)
    side.put(scfsi, 4)
    for gr in range(2):
        side.put(part23[gr], 12)
        side.put(big_values, 9)
        side.put(global_gain, 8)
        side.put(scalefac_compress, 4)
        side.put(0, 1)   # window_switching
        for _ in range(3):
            side.put(1, 5)
        side.put(0, 4)
        side.put(7, 3)
        side.put(preflag, 1)
        side.put(scalefac_scale, 1)
        side.put(0, 1)   # count1table_select
    side_bytes = side.bytes(pad_to=17)

    main = BitWriter()
    for gr in range(2):
        write_main(main, gr)
    main_bytes = main.bytes(pad_to=417 - 4 - 17)
    return header + side_bytes + main_bytes


def craft_scalefactor_stream(n_frames: int = 40, **kw) -> bytes:
    return craft_scalefactor_frame(**kw) * n_frames


def craft_count1b_frame(
    quads: list[tuple[int, int, int, int]],
    global_gain: int = 190,
) -> bytes:
    """One MPEG1 44.1 kHz 128 kbps MONO long-block frame whose count1
    region uses table B (count1table_select=1: fixed 4-bit codes, the
    one's complement of the |v|w|x|y| bit pattern, one sign bit per
    nonzero value).

    big_values covers lines 0..7 with (1,1) pairs (table 1); `quads`
    (values in -1..1) fill lines 8.. in the count1 region.
    """
    big_values = 4
    header = bytes([0xFF, 0xFB, 0x90, 0xC0])  # mono

    def write_main(bw: BitWriter) -> None:
        _encode_table1_pairs(bw, set(range(0, 8, 2)), big_values * 2)
        for q in quads:
            assert all(-1 <= v <= 1 for v in q)
            bits = 0
            for v in q:
                bits = (bits << 1) | (1 if v else 0)
            bw.put((~bits) & 0xF, 4)
            for v in q:
                if v:
                    bw.put(0 if v > 0 else 1, 1)

    tmp = BitWriter()
    write_main(tmp)
    part23 = len(tmp)

    side = BitWriter()
    side.put(0, 9)
    side.put(0, 5)   # private (mono)
    side.put(0, 4)   # scfsi
    for _gr in range(2):
        side.put(part23, 12)
        side.put(big_values, 9)
        side.put(global_gain, 8)
        side.put(0, 4)   # scalefac_compress
        side.put(0, 1)   # window_switching
        for _ in range(3):
            side.put(1, 5)
        side.put(0, 4)   # region0_count
        side.put(7, 3)   # region1_count
        side.put(0, 1)   # preflag
        side.put(0, 1)   # scalefac_scale
        side.put(1, 1)   # count1table_select = table B
    side_bytes = side.bytes(pad_to=17)

    main = BitWriter()
    for _gr in range(2):
        write_main(main)
    main_bytes = main.bytes(pad_to=417 - 4 - 17)
    return header + side_bytes + main_bytes


def craft_count1b_stream(n_frames: int = 40, quads=None) -> bytes:
    if quads is None:
        quads = [(1, 0, 1, 0), (0, -1, 0, 1), (1, 1, 1, 1), (0, 0, 0, 0),
                 (-1, -1, 0, 0), (0, 0, 1, -1)]
    return craft_count1b_frame(quads) * n_frames


def craft_lsf_intensity_frame(
    is_positions: list[int],
    ch0_bands: list[int],
    intensity_scale: int = 0,
    global_gain: int = 190,
) -> bytes:
    """One MPEG2 22.05 kHz 64 kbps joint-stereo frame, LSF intensity stereo.

    ch1 transmits no spectrum; its scalefactors are the intensity
    positions. int_scalefac_compress = 87 -> slen (2, 2, 3) over the long
    partitions {7, 7, 7}: sfbs 0..6 and 7..13 take 2-bit positions,
    sfbs 14..20 take 3-bit positions (7 = illegal, band unchanged).
    `is_positions` must have 21 entries in those ranges.
    """
    assert len(is_positions) == 21
    slens = [2] * 7 + [2] * 7 + [3] * 7
    assert all(0 <= p < (1 << s) for p, s in zip(is_positions, slens))
    assert ch0_bands

    # MPEG2, layer III, no CRC, 64 kbps, 22.05 kHz, joint stereo, IS on.
    header = bytes([0xFF, 0xF3, 0x80, 0x50])

    lines = _lines_for_bands(ch0_bands, BAND_START_22)
    big_values = BAND_START_22[max(ch0_bands) + 1] // 2

    def write_main(bw: BitWriter, ch: int) -> None:
        if ch == 1:
            for p, s in zip(is_positions, slens):
                bw.put(p, s)
        else:
            _encode_table1_pairs(bw, lines, big_values * 2)

    part23 = []
    for ch in range(2):
        tmp = BitWriter()
        write_main(tmp, ch)
        part23.append(len(tmp))

    # ch1 scalefac_compress: (int_sf << 1) | intensity_scale, int_sf=87.
    side = BitWriter()
    side.put(0, 8)   # main_data_begin (LSF: 8 bits)
    side.put(0, 2)   # private
    for ch in range(2):  # one granule
        side.put(part23[ch], 12)
        side.put(big_values if ch == 0 else 0, 9)
        side.put(global_gain, 8)
        side.put(0 if ch == 0 else (87 << 1) | intensity_scale, 9)
        side.put(0, 1)   # window_switching
        for _ in range(3):
            side.put(1, 5)   # table_select: table 1
        side.put(0, 4)   # region0_count
        side.put(7, 3)   # region1_count
        side.put(0, 1)   # scalefac_scale
        side.put(0, 1)   # count1table_select
    side_bytes = side.bytes(pad_to=17)

    main = BitWriter()
    for ch in range(2):
        write_main(main, ch)
    frame_size = 208  # floor(72 * 64000 / 22050)
    main_bytes = main.bytes(pad_to=frame_size - 4 - 17)

    return header + side_bytes + main_bytes


def craft_lsf_intensity_stream(
    n_frames: int = 80,
    is_positions: list[int] | None = None,
    ch0_bands: list[int] | None = None,
    intensity_scale: int = 0,
) -> bytes:
    if is_positions is None:
        # Cover every legal value per slen plus the 3-bit illegal 7.
        is_positions = ([0, 1, 2, 3, 0, 1, 2] * 2) + [0, 1, 2, 3, 4, 5, 7]
    if ch0_bands is None:
        ch0_bands = [2, 5, 8, 11, 14, 15, 16, 17, 18]
    frame = craft_lsf_intensity_frame(is_positions, ch0_bands, intensity_scale)
    return frame * n_frames


def craft_intensity_stream(
    n_frames: int = 40,
    mode_extension: int = 1,
    is_positions: list[int] | None = None,
    ch0_bands: list[int] | None = None,
    ch1_bands: list[int] = (),
) -> bytes:
    """Repeat one crafted joint-stereo frame `n_frames` times.

    Defaults put ch0 energy in sfbs 12..18 (the intensity-coded region)
    with one distinct is_position per band, including an is_pos=6
    (full-left) and an illegal 7.
    """
    if is_positions is None:
        is_positions = [0, 1, 2, 3, 4, 5, 6, 7, 0, 2]
    if ch0_bands is None:
        ch0_bands = [11, 12, 13, 14, 15, 16, 17, 18]
    frame = craft_joint_stereo_frame(
        mode_extension, is_positions, ch0_bands, ch1_bands
    )
    return frame * n_frames
