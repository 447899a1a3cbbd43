"""Equal-loudness IIR filter as a blocked linear recurrence, in torch.

Counterpart of mp3rgain_tpu/ops/iir.py. The constant builders
(_arP_kernels, _prefix_kernels, _group_kernels, _group_ok, NB2_DENSE_MAX)
are copies of the JAX module's, held bit-identical by the tests; the
solve is the same exact restructuring of the reference's per-sample
direct-form filter (the Rust mp3rgain, src/replaygain.rs:586-616):

  - the 10th-order Yule stage as ONE blocked direct-form solve (an
    (L, L+10) composite FIR∘AR-Toeplitz matmul per 128-sample block),
    then the 2nd-order Butterworth the same way — for rates whose
    blocked operators are well conditioned (_group_ok, all rates up to
    48 kHz); the factored biquad cascade otherwise (64 and 96 kHz);
  - block carries s_n = M s_{n-1} + v_n resolved by a two-level affine
    prefix: a lower-triangular Toeplitz matmul over superblocks of l2
    carries, then across superblocks either one dense block-Toeplitz
    matmul (up to NB2_DENSE_MAX superblocks) or a log-step doubling scan
    of batched matmuls over the (M^l2, carry) affine pairs;
  - 88.2 kHz, whose published table row is unstable, returns all ones
    (the reference's degenerate result, every window in bin 2000).

All products are plain matmuls (cuBLAS on the GPU) in the input's dtype;
the device policy keeps float32 matmuls in full precision.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .coeffs import (
    DEGENERATE_RATES,
    DENORMAL_PREVENTION,
    YULE_A,
    filter_plan,
)

DEFAULT_BLOCK = 128
L2 = 128  # first-level superblock length (carries per superblock)

# Level-2 dense cross-superblock operator cap: up to this many superblocks
# the cross-superblock solve is ONE (nb2*P)² matmul; above it the
# doubling scan keeps the footprint linear in duration.
NB2_DENSE_MAX = 204


@lru_cache(maxsize=None)
def _arP_kernels(a_tail: tuple, block: int):
    """Order-P blocked recurrence operators for y_t = f_t - sum a_k y_{t-k}.

    Returns (T_h (L, L) lower-triangular zero-state Toeplitz,
    G (L, P) homogeneous responses to unit initial states y_{-1-j} = 1,
    M (P, P) end-of-block state map, all float64). The block state is
    s = [y_{L-1}, ..., y_{L-P}]; M[i, j] = G[L-1-i, j]."""
    a = np.asarray(a_tail, dtype=np.float64)
    P = len(a)
    L = block
    h = np.zeros(L + P)
    h[0] = 1.0
    for t in range(1, L + P):
        acc = 0.0
        for k in range(1, P + 1):
            if t - k >= 0:
                acc -= a[k - 1] * h[t - k]
        h[t] = acc
    g = np.zeros((L, P))
    for j in range(P):
        hist = np.zeros(P)
        hist[j] = 1.0  # y_{-1-j} = 1
        for t in range(L):
            val = -np.dot(a, hist)
            g[t, j] = val
            hist = np.concatenate([[val], hist[:-1]])
    th = np.zeros((L, L))
    for t in range(L):
        th[t, : t + 1] = h[t::-1][: t + 1]
    m = g[L - 1 - np.arange(P), :]  # (P, P)
    return th, g, m


@lru_cache(maxsize=None)
def _prefix_kernels(a_tail: tuple, block: int, nb2: int | None, l2: int):
    """Constants for the two-level affine-prefix solve of
    s_n = M s_{n-1} + v_n over first-level carries, P-dim state.

    Returns (T2 (l2*P, l2*P) local prefix operator, T3 (nb2*P, nb2*P)
    strict-lower cross-superblock operator or None when nb2 is None,
    Pw (l2, P, P) powers M^(t+1), Ml2 (P, P)), tap-major layout."""
    _, _, m = _arP_kernels(a_tail, block)
    P = m.shape[0]

    powers = [np.eye(P)]
    for _ in range(l2 + 1):
        powers.append(m @ powers[-1])

    t2 = np.zeros((l2, l2, P, P))
    for t in range(l2):
        for s in range(t + 1):
            t2[t, s] = powers[t - s]
    ml2 = powers[l2]
    p = np.stack(powers[1 : l2 + 1])
    # out[(i,t)] = sum_{(j,s)} T[(i,t),(j,s)] v[(j,s)], tap axis outside.
    t2m = t2.transpose(2, 0, 3, 1).reshape(l2 * P, l2 * P)

    t3m = None
    if nb2 is not None:
        ml2_pow = [np.eye(P)]
        for _ in range(nb2):
            ml2_pow.append(ml2 @ ml2_pow[-1])
        t3 = np.zeros((nb2, nb2, P, P))
        for t in range(nb2):
            for s in range(t):
                t3[t, s] = ml2_pow[t - 1 - s]
        t3m = t3.transpose(0, 2, 1, 3).reshape(nb2 * P, nb2 * P)
    return t2m, t3m, p, ml2


@lru_cache(maxsize=None)
def _group_kernels(b_taps: tuple, a_tail: tuple, block: int):
    """Composite blocked-IIR operator Tc (L, L+K-1) = T_h @ Band for a
    direct-form filter with K numerator taps and order-P denominator.

    Band maps the extended input block [x[-(K-1)], ..., x[-1], x[0..L-1]]
    to the FIR output f[t] = sum_k b[k] x[t-k]; T_h is the AR(P)
    zero-state Toeplitz."""
    L = block
    K = len(b_taps)
    th, g, m = _arP_kernels(a_tail, block)
    band = np.zeros((L, L + K - 1))
    for t in range(L):
        for k, bk in enumerate(b_taps):
            band[t, t + K - 1 - k] = bk
    return th @ band, g, m


@lru_cache(maxsize=None)
def _group_ok(sample_rate: int, block: int) -> bool:
    """True when the direct-form 10th-order Yule blocked operators are
    well-conditioned enough for the grouped solve (empirically: all
    rates <= 48 kHz; 64k/96k grow homogeneous responses to 1.4e3/2.1e4
    and keep the biquad cascade; 88.2k is degenerate everywhere)."""
    a_tail = tuple(float(c) for c in YULE_A[sample_rate][1:])
    th, g, m = _arP_kernels(a_tail, block)
    bound = max(np.max(np.abs(th)), np.max(np.abs(g)))
    return bool(np.isfinite(bound) and bound <= 128.0)


def stage_plan(sample_rate: int, block: int = DEFAULT_BLOCK):
    """[(b_taps, a_tail), ...] of the blocked solves this rate runs, in
    order: [Yule AR(10), Butterworth] when grouped, the six biquads of
    the factored cascade otherwise, nothing at a degenerate rate."""
    if sample_rate in DEGENERATE_RATES:
        return []
    plan = filter_plan(sample_rate)
    if _group_ok(sample_rate, block):
        a1, a2 = plan.butter_section
        b = plan.butter_b
        return [
            (tuple(float(c) for c in plan.yule_b),
             tuple(float(c) for c in YULE_A[sample_rate][1:])),
            (tuple(float(c) for c in (b[0], b[1], b[2])),
             (float(a1), float(a2))),
        ]
    return [
        (tuple(float(c) for c in sec[:3]), tuple(float(c) for c in sec[3:]))
        for sec in plan.sos
    ]


STAGE_FIELDS = ("tc", "g", "t2m", "p", "ml2")


def stage_arrays(sample_rate: int,
                 block: int = DEFAULT_BLOCK) -> dict[str, np.ndarray]:
    """float64 constants of every stage of stage_plan, keyed
    s{i}_{field} (the EqualLoudness buffer names)."""
    out = {}
    for i, (b_taps, a_tail) in enumerate(stage_plan(sample_rate, block)):
        tc, g, _ = _group_kernels(b_taps, a_tail, block)
        t2m, _, p, ml2 = _prefix_kernels(a_tail, block, None, L2)
        for name, arr in zip(STAGE_FIELDS, (tc, g, t2m, p, ml2)):
            out[f"s{i}_{name}"] = np.asarray(arr, dtype=np.float64)
    return out


def _affine_prefix(v, t2m, t3m, p, ml2, l2: int = L2):
    """s_n = M s_{n-1} + v_n (s_{-1} = 0) for v (B, P, N) TAP-MAJOR:
    a lower-triangular Toeplitz matmul over each superblock of l2
    carries, then the cross-superblock solve — one dense matmul when
    t3m is given, else a log-step doubling scan over (M^l2, carry)
    affine pairs (element i absorbs element i-d through M^(l2·d) at
    distances d = 1, 2, 4, ...)."""
    b, P, n = v.shape
    nb2 = -(-n // l2)
    vp = F.pad(v, (0, nb2 * l2 - n))
    vb = vp.reshape(b, P, nb2, l2).permute(0, 2, 1, 3).reshape(b, nb2, P * l2)
    local = torch.matmul(vb, t2m.T).reshape(b, nb2, P, l2)
    carries = local[:, :, :, -1]  # (B, nb2, P)
    if t3m is not None:
        s_end = torch.matmul(carries.reshape(b, nb2 * P), t3m.T)
        s_end = s_end.reshape(b, nb2, P)
    else:
        s2 = carries
        a = ml2
        d = 1
        while d < nb2:
            s2 = torch.cat(
                [s2[:, :d], s2[:, d:] + torch.matmul(s2[:, :-d], a.T)], dim=1
            )
            a = a @ a
            d *= 2
        s_end = torch.cat([torch.zeros_like(s2[:, :1]), s2[:, :-1]], dim=1)
    cross = torch.einsum("bmj,tij->bmit", s_end, p)  # (B, nb2, P, l2)
    s = (local + cross).permute(0, 2, 1, 3).reshape(b, P, nb2 * l2)
    return s[:, :, :n]


def _group_apply(x, tc, g, t2m, t3m, p, ml2, block: int, x_hist=None, y_hist=None):
    """Apply a full direct-form IIR (K-tap FIR + AR(P)) along the last
    axis of (B, T), blockwise and exactly: one (L, L+K-1) matmul per
    block plus the two-level affine carry prefix.

    From zero state, or, given x_hist (B, K-1) and y_hist (B, P) (the K-1
    inputs and the P outputs before x[0], oldest first), from that state:
    the inputs extend the first block, and the outputs enter the first
    block's carry through M (p[0]) and its homogeneous response through
    G, as a block's carry enters the next."""
    L = block
    K = tc.shape[1] - L + 1
    P = g.shape[1]
    b, t = x.shape
    nblk = -(-t // L)
    xb = F.pad(x, (0, nblk * L - t)).reshape(b, nblk, L)
    # Extended input block: previous block's last K-1 samples + this block.
    if x_hist is None:
        prev = F.pad(xb[:, :-1, L - (K - 1):], (0, 0, 1, 0))
    else:
        prev = torch.cat([x_hist[:, None, :], xb[:, :-1, L - (K - 1):]], dim=1)
    xin = torch.cat([prev, xb], dim=-1)  # (B, NB, L+K-1)
    y_zs = torch.matmul(xin, tc.T)  # (B, NB, L)
    del xin, prev
    # Block carry state s = [y_{L-1}, ..., y_{L-P}], tap-major (B, P, NB).
    v = y_zs[:, :, L - 1 - torch.arange(P, device=x.device)].transpose(1, 2)
    if y_hist is None:
        s = _affine_prefix(v, t2m, t3m, p, ml2)  # (B, P, NB)
        s_prev = F.pad(s, (1, 0))[:, :, :-1]
    else:
        s_init = y_hist.flip(-1)  # the block-state order, newest first
        v = v.clone()
        v[:, :, 0] += torch.matmul(s_init, p[0].T)
        s = _affine_prefix(v, t2m, t3m, p, ml2)
        s_prev = torch.cat([s_init[:, :, None], s[:, :, :-1]], dim=2)
    y_zs += torch.matmul(s_prev.transpose(1, 2), g.T)
    return y_zs.reshape(b, nblk * L)[:, :t]


class EqualLoudness(nn.Module):
    """The equal-loudness filter of one sample rate, its blocked-solve
    constants as float64 buffers (cast to the input's dtype at use)."""

    def __init__(self, sample_rate: int, block: int = DEFAULT_BLOCK):
        super().__init__()
        self.sample_rate = sample_rate
        self.block = block
        self.plan = stage_plan(sample_rate, block)
        self.grouped = len(self.plan) == 2
        for name, arr in stage_arrays(sample_rate, block).items():
            self.register_buffer(name, torch.from_numpy(arr.copy()))
        self._t3m = {}  # (stage, nb2, dtype, device) -> dense level-2 operator

    def _dense_t3m(self, i: int, n: int, like: torch.Tensor):
        nblk = -(-n // self.block)
        nb2 = -(-nblk // L2)
        if nb2 > NB2_DENSE_MAX:
            return None
        key = (i, nb2, like.dtype, like.device)
        if key not in self._t3m:
            a_tail = self.plan[i][1]
            t3m = torch.as_tensor(_prefix_kernels(a_tail, self.block, nb2, L2)[1],
                                  dtype=like.dtype)
            if like.device.type == "cuda":
                # From pinned memory without a host sync: a new length
                # class mid-scan must not stall the queued batches.
                t3m = t3m.pin_memory().to(like.device, non_blocking=True)
            self._t3m[key] = t3m
        return self._t3m[key]

    def _stage(self, y, i: int, x_hist=None, y_hist=None):
        c = {f: getattr(self, f"s{i}_{f}").to(y.dtype) for f in STAGE_FIELDS}
        t3m = self._dense_t3m(i, y.shape[-1], y)
        return _group_apply(y, c["tc"], c["g"], c["t2m"], t3m, c["p"],
                            c["ml2"], self.block, x_hist, y_hist)

    @property
    def state_width(self) -> int:
        """Numbers of one row's filter state: each stage's K-1 last inputs
        and P last outputs."""
        return sum(len(b) - 1 + len(a) for b, a in self.plan)

    def forward(self, x: torch.Tensor, state: torch.Tensor | None = None,
                end: int | None = None):
        """Filter (B, T) audio scaled to the 16-bit range (×32768), from
        zero state, or from `state` (B, state_width), where x continues a
        stream whose filter left that state: exactly, with nothing warmed
        up. Returns (y, ends): with `end` given, ends are small tensors
        whose torch.cat along dim 1 is the state after sample end - 1,
        else an empty list. The state holds, stage by stage, the stage's
        last K-1 inputs and its last P outputs before the constant is
        added, oldest first."""
        ends, off = [], 0
        if not self.plan:
            # Degenerate rate: the reference's NaN windows land in bin 2000
            # (loudness 0.0); a constant all-ones output reproduces that.
            return torch.ones_like(x), ends

        def stage(inp, i):
            nonlocal off
            k1, p = len(self.plan[i][0]) - 1, len(self.plan[i][1])
            hist = (None, None) if state is None else (
                state[:, off:off + k1], state[:, off + k1:off + k1 + p])
            off += k1 + p
            y = self._stage(inp, i, *hist)
            if end is not None:
                ends.extend([inp[:, end - k1:end].clone(), y[:, end - p:end].clone()])
            return y

        if self.grouped:
            y = stage(x, 0) + DENORMAL_PREVENTION
            return stage(y, 1) + DENORMAL_PREVENTION, ends
        y = x
        for i in range(len(self.plan)):
            if i == len(self.plan) - 1:
                y = y + DENORMAL_PREVENTION
            y = stage(y, i)
        return y + DENORMAL_PREVENTION, ends


def equal_loudness(x: torch.Tensor, sample_rate: int,
                   block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Equal-loudness filter along the last axis of (B, T), on x's device
    and in x's dtype."""
    return EqualLoudness(sample_rate, block).to(x.device)(x)[0]


# ---------------------------------------------------------------------------
# Exact per-sample oracle (direct-form I, float64) for validation.
# ---------------------------------------------------------------------------


def equal_loudness_scan(x, sample_rate: int) -> torch.Tensor:
    """Reference-exact float64 filter of (B, T) x, the counterpart of the
    JAX package's per-sample direct-form-I scan: the Yule AR(10) stage,
    then the Butterworth stage, each adding DENORMAL_PREVENTION at every
    step. Returns a float64 tensor on x's device (the CPU for an array).

    Each stage is scipy's float64 lfilter: the same difference equation
    from zero state, run in compiled code (a Python loop over samples is
    far too slow for a full track), with nothing to build (scipy is on
    every machine the port runs on, where a loop in the host C++ library
    would be one more native entry point to keep). The constant added at
    every step enters by linearity: the stage's output is lfilter(b, a,
    input) plus c * lfilter([1], a, ones). This is a test oracle; no route
    calls it."""
    from scipy.signal import lfilter

    plan = filter_plan(sample_rate)
    t = torch.as_tensor(x)
    out = t.detach().cpu().numpy().astype(np.float64)
    ones = np.ones(out.shape[-1])
    for b, a in ((plan.yule_b, YULE_A[sample_rate]),
                 (plan.butter_b, (1.0, *plan.butter_section))):
        out = lfilter(b, a, out, axis=-1) + DENORMAL_PREVENTION * lfilter([1.0], a, ones)
    return torch.from_numpy(out).to(t.device)
