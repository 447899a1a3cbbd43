"""Decode back-end constants: the fused hybrid cores and polyphase maps.

Counterpart of the numpy builders in mp3rgain_tpu/decode/synthesis.py
(lines 242-403), copied so that the port never imports that module (it
imports jax at the top); the tests hold every copy bit-identical to the
original. The unfused decode (_decode_jit) is not ported yet.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from mp3rgain_tpu.decode.tables import build_tables

# Alias-reduction butterfly coefficients (derived from the ISO ci values).
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
_CS = (1.0 / np.sqrt(1.0 + _CI**2)).astype(np.float64)
_CA = (_CI / np.sqrt(1.0 + _CI**2)).astype(np.float64)


@lru_cache(maxsize=None)
def _alias_matrices():
    """Alias reduction as (576, 576) linear maps: identity plus, at each
    subband boundary sb, 8 butterflies pairing line 18*sb+17-i with
    18*sb+18+i (ISO 11172-3 2.4.3.4.10.1). A_long applies all 31
    boundaries; A_mixed boundary 0 only."""
    a_long = np.eye(576, dtype=np.float64)
    a_mixed = np.eye(576, dtype=np.float64)
    for sb in range(31):
        targets = (a_long, a_mixed) if sb == 0 else (a_long,)
        for i in range(8):
            a = 18 * sb + 17 - i
            b2 = 18 * sb + 18 + i
            for mat in targets:
                mat[a, a] = _CS[i]
                mat[b2, a] = -_CA[i]
                mat[b2, b2] = _CS[i]
                mat[a, b2] = _CA[i]
    return a_long, a_mixed


@lru_cache(maxsize=None)
def _fused_hybrid_cores():
    """Alias reduction ∘ IMDCT ∘ window as THREE (576, 1152) maps, one
    per layout class, with output columns ordered [head(576) | tail(576)]
    in hybrid line layout (col 18*sb + i). The 36-point long core is
    unwindowed (the long window is applied per granule afterwards); the
    short composite and the mixed splice bake their windows. Built in
    f64."""
    from mp3rgain_tpu.decode.tables import _window_long

    t = build_tables()
    i = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    core36 = np.cos(np.pi / 72.0 * (2 * i + 1 + 18) * (2 * k + 1))
    short_m = t.imdct[2]  # windowed short composite (36, 18)
    long_m0 = t.imdct[0]  # windowed long (mixed blocks, sb < 2)

    def blockdiag(mat_of_sb):
        c = np.zeros((576, 1152))
        for sb in range(32):
            m = mat_of_sb(sb)  # (36, 18): [out line w, input line mm]
            sl = slice(18 * sb, 18 * sb + 18)
            c[sl, sl] = m[:18].T
            c[sl, slice(576 + 18 * sb, 576 + 18 * sb + 18)] = m[18:].T
        return c

    a_long, a_mixed = _alias_matrices()
    core_long = a_long @ blockdiag(lambda sb: core36)  # unwindowed
    core_short = blockdiag(lambda sb: short_m)  # window baked
    core_mixed = a_mixed @ blockdiag(
        lambda sb: long_m0 if sb < 2 else short_m
    )

    wins = np.zeros((4, 1152))
    for bt in (0, 1, 3):
        w = _window_long(bt)
        for sb in range(32):
            wins[bt, 18 * sb : 18 * sb + 18] = w[:18]
            wins[bt, 576 + 18 * sb : 576 + 18 * sb + 18] = w[18:]
    return core_long, core_short, core_mixed, wins


def _synth_kernel() -> np.ndarray:
    """Combined synthesis kernel W (16 taps, 64 in, 32 out):
    PCM_t[j] = sum_k sum_u V[t-k, u] * W[k, u, j]."""
    t = build_tables()
    w = np.zeros((16, 64, 32))
    j = np.arange(32)
    for k in range(16):
        cols = j if k % 2 == 0 else 32 + j
        w[k, cols, j] = t.synth_d[k]
    return w


@lru_cache(maxsize=None)
def _tail_matrices():
    """Polyphase synthesis as three GEMM constants over 576/1152 columns.

    V-row layout per granule-time t: column 64*i + u = V value u of slot
    ts = 18*t + i. N18 does the DCT matrixing from hybrid columns
    (18*sb + i); A/B do the 16-tap dewindowing — a tap reaches at most
    17 slots back, so PCM_t = V_t @ A + V_{t-1} @ B exactly."""
    tbs = build_tables()
    n = tbs.synth_n  # (64, 32)
    n18 = np.zeros((576, 1152))
    for sb in range(32):
        for i in range(18):
            n18[18 * sb + i, 64 * i : 64 * i + 64] = n[:, sb]

    w = _synth_kernel()  # (16, 64, 32)
    a = np.zeros((1152, 576))
    b = np.zeros((1152, 576))
    for i in range(18):
        for ip in range(18):
            k = ip - i
            if 0 <= k <= 15:
                a[64 * i : 64 * i + 64, 32 * ip : 32 * ip + 32] = w[k]
            k2 = 18 + ip - i
            if 0 <= k2 <= 15:
                b[64 * i : 64 * i + 64, 32 * ip : 32 * ip + 32] = w[k2]
    return n18, a, b


@lru_cache(maxsize=None)
def _tail_matrices_fused():
    """Polyphase synthesis folded to TWO (576, 576) maps:
    PCM_t = out18_t @ (N18 @ A) + out18_{t-1} @ (N18 @ B), with the
    frequency-inversion sign pattern (odd subbands, odd samples) folded
    into the rows."""
    n18, a, b = _tail_matrices()
    col = np.arange(576)
    sign = np.where(((col // 18) % 2 == 1) & ((col % 18) % 2 == 1), -1.0, 1.0)
    return sign[:, None] * (n18 @ a), sign[:, None] * (n18 @ b)
