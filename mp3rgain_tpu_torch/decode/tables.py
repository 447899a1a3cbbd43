"""The torch port's copy of mp3rgain_tpu/decode/tables.py, held equal to it
by tests/test_torch_host_copies.py.

Constant tensors for the JAX decode back-end.

Everything here is precomputed once in NumPy (float64) from closed-form
ISO 11172-3 formulas plus the generated band/window tables, then used as
constants inside jitted device code. Layout conventions:

- Block kinds: 0 long (bt0), 1 start (bt1), 2 short (bt2 pure),
  3 stop (bt3), 4 mixed (bt2 mixed).
- Spectrum layouts: the front-end emits Huffman order; `reorder` maps to
  subband-major order dst[sb*18 + u] where for short subbands
  u = window*6 + line (per-window IMDCT input order).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .format_tables import BAND_SIZE_LONG, BAND_SIZE_SHORT, PRETAB, SR_ROW
from .synth_window import SYNTH_WINDOW_D

N_KINDS = 5
KIND_LONG, KIND_START, KIND_SHORT, KIND_STOP, KIND_MIXED = range(5)

# scf slot layout (matches _native/mp3dec.cpp): long sfbs at 0..22,
# short sfbs at 23 + sfb*3 + window.
SCF_LONG = 0
SCF_SHORT = 23
SCF_SLOTS = 64


def _long_index(row: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(BAND_SIZE_LONG[row])])


def _short_index(row: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(BAND_SIZE_SHORT[row])])


@dataclass
class SampleMaps:
    """Per-sample requantization metadata, shape (N_KINDS, 576) each."""

    slot: np.ndarray  # scf slot index (0..63)
    window: np.ndarray  # 0..2 (0 for long samples)
    is_short: np.ndarray  # bool
    pretab: np.ndarray  # preemphasis value for the sample's long band
    band_start: np.ndarray  # start sample index of the sample's band
    reorder: np.ndarray  # src index into huffman-order spectrum


def _build_maps_for_row(row: int) -> SampleMaps:
    li = _long_index(row)
    si = _short_index(row)
    slot = np.zeros((N_KINDS, 576), dtype=np.int32)
    window = np.zeros((N_KINDS, 576), dtype=np.int32)
    is_short = np.zeros((N_KINDS, 576), dtype=bool)
    pretab = np.zeros((N_KINDS, 576), dtype=np.int32)
    band_start = np.zeros((N_KINDS, 576), dtype=np.int32)
    reorder = np.tile(np.arange(576, dtype=np.int32), (N_KINDS, 1))

    def long_fill(kind: int, lo: int, hi: int) -> None:
        for b in range(22):
            s, e = li[b], li[b + 1]
            s, e = max(s, lo), min(e, hi)
            if s >= e:
                continue
            slot[kind, s:e] = SCF_LONG + min(b, 21)
            pretab[kind, s:e] = PRETAB[b]
            band_start[kind, s:e] = li[b]
        # Samples past the last band keep the last slot (they are zero anyway).

    def short_band_of(line: int) -> int:
        b = int(np.searchsorted(si, line, side="right") - 1)
        return min(max(b, 0), 12)

    def short_fill(kind: int, first_line: int) -> None:
        # Huffman order within the short region: for each band b
        # (lines [s_b, e_b) per window), 3 windows of width (e_b - s_b).
        # dst subband-major index: 18*sb + w*6 + l  with line = 6*sb + l.
        for f in range(first_line, 192):
            b = short_band_of(f)
            w_b = si[b + 1] - si[b]
            for w in range(3):
                src = 3 * si[b] + w * w_b + (f - si[b])
                sb, l = divmod(f, 6)
                dst = 18 * sb + w * 6 + l
                slot[kind, dst] = SCF_SHORT + min(b, 12) * 3 + w
                window[kind, dst] = w
                is_short[kind, dst] = True
                band_start[kind, dst] = 3 * si[b]
                reorder[kind, dst] = src

    for kind in (KIND_LONG, KIND_START, KIND_STOP):
        long_fill(kind, 0, 576)
    short_fill(KIND_SHORT, 0)
    long_fill(KIND_MIXED, 0, 36)
    short_fill(KIND_MIXED, 12)

    return SampleMaps(slot, window, is_short, pretab, band_start, reorder)


# ---------------------------------------------------------------------------
# Alias reduction (ISO 2.4.3.4.10.1): 8 butterflies per long-subband boundary.
# Expressed as out[i] = diag_a[i]*x[i] + diag_b[i]*x[mirror[i]].
# ---------------------------------------------------------------------------

_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
_CS = 1.0 / np.sqrt(1.0 + _CI**2)
_CA = _CI * _CS


def _build_alias(n_boundaries: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    a = np.ones(576)
    b = np.zeros(576)
    mirror = np.arange(576, dtype=np.int32)
    for sb in range(1, n_boundaries + 1):
        for i in range(8):
            up = 18 * sb - 1 - i
            dn = 18 * sb + i
            a[up] = _CS[i]
            b[up] = -_CA[i]
            mirror[up] = dn
            a[dn] = _CS[i]
            b[dn] = _CA[i]
            mirror[dn] = up
    return a, b, mirror


# ---------------------------------------------------------------------------
# IMDCT + window matrices: one (36, 18) matrix per block type.
# ---------------------------------------------------------------------------


def _window_long(bt: int) -> np.ndarray:
    i = np.arange(36)
    w = np.sin(np.pi / 36.0 * (i + 0.5))
    if bt == 1:  # start
        w = np.where(i < 18, w, 1.0)
        w = np.where((i >= 24) & (i < 30), np.sin(np.pi / 12.0 * (i - 18 + 0.5)), w)
        w = np.where(i >= 30, 0.0, w)
    elif bt == 3:  # stop
        w = np.where(i >= 18, np.sin(np.pi / 36.0 * (i + 0.5)), w)
        w2 = np.zeros(36)
        w2[6:12] = np.sin(np.pi / 12.0 * (np.arange(6, 12) - 6 + 0.5))
        w2[12:18] = 1.0
        w2[18:] = w[18:]
        w = w2
    return w


def _imdct_matrix(bt: int) -> np.ndarray:
    if bt == 2:
        m = np.zeros((36, 18))
        i = np.arange(12)[:, None]
        k = np.arange(6)[None, :]
        core = np.cos(np.pi / 24.0 * (2 * i + 7) * (2 * k + 1))
        win = np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))[:, None]
        sub = core * win  # (12, 6)
        for w in range(3):
            m[6 + 6 * w : 18 + 6 * w, 6 * w : 6 * w + 6] += sub
        return m
    i = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    core = np.cos(np.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))
    return core * _window_long(bt)[:, None]


# ---------------------------------------------------------------------------
# Polyphase synthesis constants.
# ---------------------------------------------------------------------------


def _synth_matrix() -> np.ndarray:
    """N[i][k] = cos((16 + i)(2k + 1) pi / 64), shape (64, 32)."""
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * np.pi / 64.0)


def _synth_taps() -> tuple[np.ndarray, np.ndarray]:
    """Per-tap window coefficients and V-column selectors.

    PCM_t[j] = sum_k  D[32k + j] * V_{t-k}[col_k[j]]
    where col_k[j] = j for even k, 32 + j for odd k (ISO figure A.2 U-build).
    """
    d = np.zeros((16, 32))
    col = np.zeros((16, 32), dtype=np.int32)
    for k in range(16):
        j = np.arange(32)
        d[k] = SYNTH_WINDOW_D[32 * k + j]
        col[k] = j if k % 2 == 0 else 32 + j
    return d, col


@dataclass
class DecodeTables:
    """All constant tensors for the decode back-end (NumPy, float64)."""

    # Per sample-rate row (9, N_KINDS, 576):
    slot: np.ndarray
    window: np.ndarray
    is_short: np.ndarray
    pretab: np.ndarray
    band_start: np.ndarray
    reorder: np.ndarray
    # Alias (per kind): diag a/b and mirror index (N_KINDS, 576).
    alias_a: np.ndarray
    alias_b: np.ndarray
    alias_mirror: np.ndarray
    # IMDCT-with-window matrices per block type (4, 36, 18).
    imdct: np.ndarray
    # Synthesis: N matrix (64, 32), window taps (16, 32), column map (16, 32).
    synth_n: np.ndarray
    synth_d: np.ndarray
    synth_col: np.ndarray


@lru_cache(maxsize=1)
def build_tables() -> DecodeTables:
    maps = [_build_maps_for_row(r) for r in range(9)]
    alias_full = _build_alias(31)
    alias_none = _build_alias(0)
    alias_mixed = _build_alias(1)
    per_kind = [alias_full, alias_full, alias_none, alias_full, alias_mixed]
    return DecodeTables(
        slot=np.stack([m.slot for m in maps]),
        window=np.stack([m.window for m in maps]),
        is_short=np.stack([m.is_short for m in maps]),
        pretab=np.stack([m.pretab for m in maps]),
        band_start=np.stack([m.band_start for m in maps]),
        reorder=np.stack([m.reorder for m in maps]),
        alias_a=np.stack([a for a, _, _ in per_kind]),
        alias_b=np.stack([b for _, b, _ in per_kind]),
        alias_mirror=np.stack([m for _, _, m in per_kind]),
        imdct=np.stack([_imdct_matrix(bt) for bt in range(4)]),
        synth_n=_synth_matrix(),
        synth_d=_synth_taps()[0],
        synth_col=_synth_taps()[1],
    )


# ---------------------------------------------------------------------------
# Static per-sample-rate-row constants for the gather-free device path.
#
# Batches are bucketed by sample rate, so the band-table row is static per
# compiled pipeline; every per-sample table lookup then becomes either a
# structural op or a small one-hot matmul on the MXU — no dynamic gathers
# (which lower to serial while-loops on TPU).
#
# Layout classes: 0 = long (block kinds 0/1/3), 1 = short (kind 2),
# 2 = mixed (kind 4).
# ---------------------------------------------------------------------------

N_CLASSES = 3
CLASS_OF_KIND = np.array([0, 0, 1, 0, 2], dtype=np.int32)
_CLASS_KIND_REP = [KIND_LONG, KIND_SHORT, KIND_MIXED]  # representative kind


@dataclass
class RowTables:
    """Constants for one sample-rate row, per layout class where relevant."""

    # Permutation: dst[i] = src[perm[i]] for the short layout (the mixed
    # layout equals identity below sample 36 and the short permutation
    # above it — see tables build; exploited by the device path).
    perm_short: np.ndarray  # (576,) int32
    perm_short_onehot: np.ndarray  # (576, 576) f32, out = x @ P.T
    # scf slot one-hots per class: samples = scf(G,64) @ OH (64, 576).
    slot_onehot: np.ndarray  # (3, 64, 576) f32
    # subblock-gain window one-hots per class: (3, 3, 576) f32.
    win_onehot: np.ndarray
    # Per-sample constants per class:
    pretab: np.ndarray  # (3, 576) f32
    band_start: np.ndarray  # (3, 576) int32
    is_short: np.ndarray  # (3, 576) bool


@lru_cache(maxsize=None)
def row_tables(sr_row: int) -> RowTables:
    t = build_tables()
    perm = t.reorder[sr_row, KIND_SHORT].astype(np.int32)
    onehot = np.zeros((576, 576), dtype=np.float32)
    onehot[np.arange(576), perm] = 1.0
    # The mixed reorder must equal identity below 36 / short above.
    pm = t.reorder[sr_row, KIND_MIXED]
    assert (pm[:36] == np.arange(36)).all()
    assert (pm[36:] == perm[36:]).all()

    slot_oh = np.zeros((N_CLASSES, 64, 576), dtype=np.float32)
    win_oh = np.zeros((N_CLASSES, 3, 576), dtype=np.float32)
    pretab = np.zeros((N_CLASSES, 576), dtype=np.float32)
    band_start = np.zeros((N_CLASSES, 576), dtype=np.int32)
    is_short = np.zeros((N_CLASSES, 576), dtype=bool)
    for c, kind in enumerate(_CLASS_KIND_REP):
        slot_oh[c, t.slot[sr_row, kind], np.arange(576)] = 1.0
        win_oh[c, t.window[sr_row, kind], np.arange(576)] = 1.0
        pretab[c] = t.pretab[sr_row, kind]
        band_start[c] = t.band_start[sr_row, kind]
        is_short[c] = t.is_short[sr_row, kind]
    return RowTables(
        perm_short=perm,
        perm_short_onehot=onehot,
        slot_onehot=slot_oh,
        win_onehot=win_oh,
        pretab=pretab,
        band_start=band_start,
        is_short=is_short,
    )


__all__ = [
    "DecodeTables",
    "build_tables",
    "RowTables",
    "row_tables",
    "CLASS_OF_KIND",
    "SR_ROW",
    "N_KINDS",
    "KIND_LONG",
    "KIND_START",
    "KIND_SHORT",
    "KIND_STOP",
    "KIND_MIXED",
]
