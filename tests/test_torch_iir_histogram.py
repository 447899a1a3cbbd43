"""Torch port: equal-loudness IIR, RMS-window histogram and readout.

The blocked IIR in float64 must match the JAX package's exact
per-sample oracle (iir.equal_loudness_scan) for every rate but the
degenerate 88.2 kHz, including the level-2 doubling scan past
NB2_DENSE_MAX, at rtol 1e-9 with atol 1e-9 times the signal's peak: the
blocked restructuring is exact algebra, but its float64 rounding differs
from the per-sample recurrence by up to ~5e-10 of the peak (the JAX
package's own blocked float64 path shows the same 4.6e-10 at 96 kHz), so
an absolute 1e-9 near zero crossings would test rounding, not the
algorithm. The affine prefix alone holds rtol = atol = 1e-9. In float32
the filter's mean square stays within 1e-3 of the oracle's. The
histogram of one filtered float32 array, and the 95th-percentile index,
must equal the JAX functions exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from mp3rgain_tpu.ops import coeffs  # noqa: E402
from mp3rgain_tpu.ops import histogram as jhi  # noqa: E402
from mp3rgain_tpu.ops import iir as jiir  # noqa: E402
from mp3rgain_tpu_torch.ops import histogram as hi  # noqa: E402
from mp3rgain_tpu_torch.ops import iir  # noqa: E402

torch.set_num_threads(2)

RATES = [r for r in coeffs.SUPPORTED_RATES if r not in coeffs.DEGENERATE_RATES]


def _scan64(x: np.ndarray, rate: int) -> np.ndarray:
    with jax.enable_x64(True):
        return np.asarray(jiir.equal_loudness_scan(jnp.asarray(x), rate))


@pytest.mark.parametrize("rate", RATES)
def test_float64_matches_scan_oracle(rate):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4096)) * 0.3 * 32768.0
    ref = _scan64(x, rate)
    got = iir.equal_loudness(torch.from_numpy(x), rate).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())
    # float32: mean-square energy within 1e-3 (≈0.004 dB) of the oracle.
    got32 = iir.equal_loudness(torch.from_numpy(x.astype(np.float32)), rate)
    ms_ref = (ref**2).mean()
    ms32 = (got32.numpy().astype(np.float64) ** 2).mean()
    assert abs(ms32 - ms_ref) / ms_ref < 1e-3


def test_affine_prefix_doubling_scan_matches_recurrence():
    """Past NB2_DENSE_MAX superblocks the cross-superblock solve is the
    doubling scan; both it and the dense level 2 match the recurrence."""
    rng = np.random.default_rng(7)
    a_tail = (-1.6, 0.68)  # stable AR(2)
    block, l2 = 128, 128
    n = iir.NB2_DENSE_MAX * l2 + 513
    v = rng.standard_normal((1, 2, n))
    t2m, _, p, ml2 = (None if a is None else torch.from_numpy(a)
                      for a in iir._prefix_kernels(a_tail, block, None, l2))
    out = iir._affine_prefix(torch.from_numpy(v), t2m, None, p, ml2, l2)

    _, _, m = iir._arP_kernels(a_tail, block)
    s = np.zeros(2)
    ref = np.empty((n, 2))
    for t in range(n):
        s = m @ s + v[0, :, t]
        ref[t] = s
    np.testing.assert_allclose(out[0].numpy().T, ref, rtol=1e-9, atol=1e-9)

    n_short = 4 * l2 + 37
    t3m = torch.from_numpy(iir._prefix_kernels(a_tail, block, 5, l2)[1])
    dense = iir._affine_prefix(torch.from_numpy(v[:, :, :n_short]), t2m, t3m,
                               p, ml2, l2)
    np.testing.assert_allclose(dense[0].numpy().T, ref[:n_short],
                               rtol=1e-9, atol=1e-9)


def test_long_track_scan_path_matches_oracle():
    """A track long enough for the level-2 doubling scan filters exactly:
    float64 output equals the per-sample oracle on its head (the full
    oracle scan is too slow for CI at this length), and the float32
    energy stays within 2e-3 of it."""
    sr = 44100
    samples = (iir.NB2_DENSE_MAX * 128 + 7) * 128 + 3000
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, samples)) * 0.2 * 32768.0
    head = 1 << 15
    ref = _scan64(x[:, :head], sr)
    got = iir.equal_loudness(torch.from_numpy(x), sr).numpy()
    np.testing.assert_allclose(got[:, :head], ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())
    got32 = iir.equal_loudness(torch.from_numpy(x.astype(np.float32)), sr)
    ms_ref = (ref**2).mean()
    ms32 = (got32.numpy()[:, :head].astype(np.float64) ** 2).mean()
    assert abs(ms32 - ms_ref) / ms_ref < 2e-3


def test_degenerate_rate_returns_ones():
    x = torch.randn(2, 5000, dtype=torch.float32) * 1e4
    out = iir.equal_loudness(x, 88200)
    assert torch.equal(out, torch.ones_like(x))
    hist = hi.histogram(out.reshape(1, 2, -1), torch.tensor([5000]),
                        hi.window_size(88200))
    n_win = -(-5000 // hi.window_size(88200))
    assert int(hist[0, 2000]) == n_win and int(hist.sum()) == n_win


@pytest.mark.parametrize("channels", [1, 2])
def test_histogram_matches_jax_exactly(channels):
    rng = np.random.default_rng(11 + channels)
    sr = 44100
    t = 3 * sr + 777
    x = rng.standard_normal((3, channels, t)).astype(np.float32)
    x *= np.geomspace(30.0, 20000.0, t, dtype=np.float32)  # many bins
    x[1, :, sr : sr + 4 * 2205] = 0.0  # silent windows are dropped
    valid = np.array([t, t - 5000, 2 * sr + 13], np.int32)
    win = hi.window_size(sr)
    want = np.asarray(jhi._histogram_jit(jnp.asarray(x), jnp.asarray(valid), win))
    got = hi.histogram(torch.from_numpy(x), torch.from_numpy(valid), win)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want > 0).sum() > 100


def test_loudness_index_matches_jax_exactly():
    rng = np.random.default_rng(4)
    hist = np.zeros((6, hi.HISTOGRAM_SIZE), np.int32)
    hist[0, 5000] = 19
    hist[0, 6000] = 1
    hist[2] = rng.integers(0, 3, hi.HISTOGRAM_SIZE)
    hist[3, rng.integers(0, hi.HISTOGRAM_SIZE, 40)] = 1
    hist[4, 11999] = 7
    hist[5, 0] = 1  # row 1 stays empty: index -1
    want = np.asarray(jhi.loudness_index_device(jnp.asarray(hist)))
    got = hi.loudness_index(torch.from_numpy(hist))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got[1]) == -1
    assert [hi.index_to_loudness(int(i)) for i in got] == [
        jhi.index_to_loudness(int(i)) for i in want]
    assert [hi.window_size(r) for r in RATES] == [jhi.window_size(r) for r in RATES]
