"""The torch port's copy of mp3rgain_tpu/decode/entropy_tables.py (it
parses the port's own _native/huffman_tables.h), held equal to it by
tests/test_torch_host_copies.py.

Device entropy-decode LUTs: MP3 Huffman tables packed for the MXU.

The Pallas entropy kernel (entropy_kernel.py) decodes one (x, y) pair per
lockstep step via one-hot(window) x LUT matmuls. The window cascade is
8 + 5 + 6 bits (= 19, the longest code, table 13):

  level 1: 8-bit primary window over 16 groups (table 0 + the 15 code
           tables).  A 256-wide contraction is half the MXU passes of the
           original 9-bit design, and the L2 group count barely moves
           (192 -> 197 raw, 172 after dedup) because almost every 9-bit
           code shares its 8-bit prefix with an existing longer code.
  level 2: 5-bit window over the per-prefix continuation groups (L2).
  level 3: 6-bit window over the rare >13-bit tails (L3).

Continuation groups are deduplicated by *content* (many tables share
identical code tails), keeping the L2 LUT within 3 MXU row-tiles.

count1 quads use a separate 6-bit window over a 2-group LUT (quad table
A's longest code is 6 bits; table B is fixed 4 bits) — a (4, 64)
contraction instead of sharing the big-values primary LUT.

LUT layout (values all fit 0..255 so the int8/bf16 MXU paths are exact;
fields are packed 2 rows per group as [ab, adv + 16*flag]):
  LUT_A  (256, N_GROUPS_A*2): short code: ab = x + 16*y, adv = len, flag 0
                              long prefix: ab = l2 group id, adv = 8, flag 1
                              invalid: flag 3 (decoder overrun, matches
                              mp3dec.cpp HuffLut::decode returning false)
  LUT_B  (32, n_l2*2):  [ab, f2]; f2: 0 invalid, 1..5 remaining length,
                        6 (= F2_L3) -> ab is an L3 group id
  LUT_C  (64, n_l3*2):  [ab, rem3]; rem3: 0 invalid, 1..6 remaining length
  LUT_CT (64, 2*2):     count1 groups [A, B]: [v, adv + 16*flag]

Tables parsed from _native/huffman_tables.h (ISO 11172-3 Table B.7
constants, the same source the host decoder compiles in) so host and
device decode from identical data.
"""

from __future__ import annotations

import os
import re
from functools import lru_cache

import numpy as np

L1_BITS = 8
L2_BITS = 5
L3_BITS = 6
CT_BITS = 6

# kHuffTableIds order in huffman_tables.h.
TABLE_IDS = [1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15, 16, 24]
GROUP_ZERO = 0
GROUP_OF_TABLE = {tid: i + 1 for i, tid in enumerate(TABLE_IDS)}
# Host meta encodes the count1 table as group 16 (A) / 17 (B)
# (mp3dec.cpp LM_GCNT); the kernel maps that to LUT_CT group 0/1.
GROUP_COUNT1_A = 16
GROUP_COUNT1_B = 17
N_GROUPS_A = 16

FLAG_OK = 0
FLAG_CONT = 1
FLAG_INVALID = 3

# lut_b f-field encoding: 0 invalid, 1..L2_BITS remaining length, 6 -> L3.
F2_L3 = 6


def _header_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, "_native",
        "huffman_tables.h",
    )


@lru_cache(maxsize=None)
def _parse_tables():
    src = open(_header_path()).read()
    tables = {}
    for m in re.finditer(r"kHuffTable(\d+)\[(\d+)\] = \{(.*?)\};", src, re.S):
        tid = int(m.group(1))
        ents = [
            (int(x), int(y), int(c, 16), int(l))
            for x, y, c, l in re.findall(
                r"\{(\d+),\s*(\d+),\s*0x([0-9a-fA-F]+)u,\s*(\d+)\}", m.group(3)
            )
        ]
        tables[tid] = ents
    m = re.search(r"kHuffSelect\[32\] = \{(.*?)\};", src, re.S)
    select = [
        (int(a), int(b))
        for a, b in re.findall(r"\{(-?\d+),\s*(-?\d+)\}", m.group(1))
    ]
    quad_a_code = [
        int(v)
        for v in re.search(r"kQuadACode\[16\] = \{(.*?)\};", src, re.S)
        .group(1).split(",")
    ]
    quad_a_len = [
        int(v)
        for v in re.search(r"kQuadALen\[16\] = \{(.*?)\};", src, re.S)
        .group(1).split(",")
    ]
    return tables, select, quad_a_code, quad_a_len


@lru_cache(maxsize=None)
def build_luts():
    """Builds the full 8+5+6 cascade with content-deduped continuation
    groups.

    Returns (lut_a (256, N_GROUPS_A*2), lut_b (32, n_l2*2),
    lut_c (64, n_l3*2), lut_ct (64, 2*2), n_l2, n_l3), all int16 with
    values in 0..255.
    """
    tables, _, qa_code, qa_len = _parse_tables()

    # --- enumerate continuation groups, content-first for dedup ----------
    # L3 groups: (tid, first 13 bits) of codes longer than L1+L2 bits.
    l3_content = {}  # (tid, pre13) -> {win6: (ab, rem3)}
    for tid in TABLE_IDS:
        for x, y, c, l in tables[tid]:
            if l > L1_BITS + L2_BITS:
                pre13 = c >> (l - L1_BITS - L2_BITS)
                g = l3_content.setdefault((tid, pre13), {})
                rem3 = l - L1_BITS - L2_BITS
                assert 1 <= rem3 <= L3_BITS, (tid, l)
                tail = c & ((1 << rem3) - 1)
                for w in range(tail << (L3_BITS - rem3),
                               (tail + 1) << (L3_BITS - rem3)):
                    g[w] = (x + 16 * y, rem3)
    l3_sig_to_gid = {}
    l3_gid_of_key = {}
    for key in sorted(l3_content):
        sig = tuple(sorted(l3_content[key].items()))
        if sig not in l3_sig_to_gid:
            l3_sig_to_gid[sig] = len(l3_sig_to_gid)
        l3_gid_of_key[key] = l3_sig_to_gid[sig]
    n_l3 = max(len(l3_sig_to_gid), 1)

    # L2 groups: (tid, first 8 bits) of codes longer than L1 bits, with
    # L3 escapes resolved to deduped L3 ids before signature matching.
    l2_content = {}  # (tid, pre8) -> {win5: (ab, f2)}
    for tid in TABLE_IDS:
        for x, y, c, l in tables[tid]:
            if l <= L1_BITS:
                continue
            pre8 = c >> (l - L1_BITS)
            g = l2_content.setdefault((tid, pre8), {})
            if l <= L1_BITS + L2_BITS:
                rem = l - L1_BITS
                tail = c & ((1 << rem) - 1)
                for w in range(tail << (L2_BITS - rem),
                               (tail + 1) << (L2_BITS - rem)):
                    g[w] = (x + 16 * y, rem)
            else:
                pre13 = c >> (l - L1_BITS - L2_BITS)
                g[pre13 & ((1 << L2_BITS) - 1)] = (
                    l3_gid_of_key[(tid, pre13)], F2_L3
                )
    l2_sig_to_gid = {}
    l2_gid_of_key = {}
    for key in sorted(l2_content):
        sig = tuple(sorted(l2_content[key].items()))
        if sig not in l2_sig_to_gid:
            l2_sig_to_gid[sig] = len(l2_sig_to_gid)
        l2_gid_of_key[key] = l2_sig_to_gid[sig]
    n_l2 = len(l2_sig_to_gid)
    assert n_l2 <= 255 and n_l3 <= 255  # group ids ride the ab byte

    # --- LUT_A: 8-bit primary window over the 16 big-value groups --------
    lut_a = np.zeros((1 << L1_BITS, N_GROUPS_A * 2), np.int16)
    for tid in TABLE_IDS:
        g = GROUP_OF_TABLE[tid]
        block = np.zeros((1 << L1_BITS, 2), np.int64)
        block[:, 1] = 16 * FLAG_INVALID
        for x, y, c, l in tables[tid]:
            if l <= L1_BITS:
                base = c << (L1_BITS - l)
                block[base : base + (1 << (L1_BITS - l))] = (
                    x + 16 * y, l + 16 * FLAG_OK
                )
        # Long prefixes override after short codes (prefix-free: disjoint).
        for x, y, c, l in tables[tid]:
            if l > L1_BITS:
                pre8 = c >> (l - L1_BITS)
                block[pre8] = (
                    l2_gid_of_key[(tid, pre8)], L1_BITS + 16 * FLAG_CONT
                )
        lut_a[:, 2 * g : 2 * g + 2] = block.astype(np.int16)
    # Group 0 (table 0): zeros, adv 0, always valid — zero defaults.

    # --- LUT_B / LUT_C: deduped continuation groups ----------------------
    lut_b = np.zeros((1 << L2_BITS, n_l2 * 2), np.int16)  # f2=0 invalid
    lut_c = np.zeros((1 << L3_BITS, n_l3 * 2), np.int16)  # rem3=0 invalid
    done_b = set()
    for key, g in l2_content.items():
        gid = l2_gid_of_key[key]
        if gid in done_b:
            continue
        done_b.add(gid)
        for w, (ab, f2) in g.items():
            lut_b[w, 2 * gid : 2 * gid + 2] = (ab, f2)
    done_c = set()
    for key, g in l3_content.items():
        gid = l3_gid_of_key[key]
        if gid in done_c:
            continue
        done_c.add(gid)
        for w, (ab, rem3) in g.items():
            lut_c[w, 2 * gid : 2 * gid + 2] = (ab, rem3)

    # --- LUT_CT: count1 quads, 6-bit window over groups [A, B] -----------
    lut_ct = np.zeros((1 << CT_BITS, 2 * 2), np.int16)
    lut_ct[:, 1] = 16 * FLAG_INVALID
    for v in range(16):
        l = qa_len[v]
        assert 1 <= l <= CT_BITS
        base = qa_code[v] << (CT_BITS - l)
        lut_ct[base : base + (1 << (CT_BITS - l)), 0:2] = (
            v, l + 16 * FLAG_OK
        )
    # Table B: v = 15 - first 4 bits, always 4 bits, always valid.
    for w in range(1 << CT_BITS):
        lut_ct[w, 2:4] = (15 - (w >> (CT_BITS - 4)), 4 + 16 * FLAG_OK)

    return lut_a, lut_b, lut_c, lut_ct, n_l2, n_l3
