"""Torch port: the compact constants of the two synthesis kernels (K4
csrc/hybrid_synthesis.cu, K5 csrc/overlap_polyphase.cu) and their
wrappers, on the CPU.

The kernels compute MP3 synthesis by its subband structure; their plain
versions (hybrid_kernel.hybrid_gemm, synthesis.overlap_polyphase_reference)
apply the dense maps natural_cores and _tail_matrices_fused, which other
tests hold to the JAX package. Here each kernel's algorithm, written out
in float64 numpy over its compact constants (as the CUDA source applies
them), is run on every basis vector: the maps it builds must be the dense
maps, for every sample-rate row. tests/test_torch_cuda.py holds the
kernels to their plain versions on a card.
"""

import numpy as np
import pytest
import torch

from mp3rgain_tpu_torch import tracing
from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
from mp3rgain_tpu_torch.decode import synthesis as syn

torch.set_num_threads(2)

SR_ROWS = range(9)  # MPEG-1 0-2, MPEG-2 3-5, MPEG-2.5 6-8


def hybrid_structured(x, cls, maps, wins, alias, perms, bt=0):
    """K4's algorithm on rows x (R, 576) of one class: gather, butterflies,
    per-subband maps, window (long rows) → (R, 1152) head|tail."""
    cs, ca = alias
    y = x[:, perms[cls]].reshape(len(x), 32, 18)
    z = y.copy()
    bounds = range(31) if cls == 0 else ([0] if cls == 2 else [])
    for sb in bounds:
        for i in range(8):
            a, b = y[:, sb, 17 - i], y[:, sb + 1, i]
            z[:, sb, 17 - i] = a * cs[i] - b * ca[i]
            z[:, sb + 1, i] = b * cs[i] + a * ca[i]
    mi = [hk.MAP_LONG if cls == 0 else
          (hk.MAP_LONG0 if cls == 2 and sb < 2 else hk.MAP_SHORT) for sb in range(32)]
    out = np.einsum("rsk,swk->rsw", z, maps[mi])  # (R, 32, 36)
    if cls == 0:
        out = out * wins[{1: 1, 3: 3}.get(bt, 0)]
    return np.concatenate([out[..., :18].reshape(len(x), 576),
                           out[..., 18:].reshape(len(x), 576)], axis=1)


def polyphase_structured(out18, n, d):
    """K5's algorithm on hybrid outputs out18 (S, T, 576) → (S, T·576):
    frequency inversion, 64 x 32 matrixing per slot, 16-tap dewindow over
    V's last 16 slots (zeros before the first)."""
    s_, t_ = out18.shape[:2]
    col = np.arange(576)
    sign = np.where(((col // 18) % 2 == 1) & ((col % 18) % 2 == 1), -1.0, 1.0)
    sub = (out18 * sign).reshape(s_, t_, 32, 18).transpose(0, 1, 3, 2)
    v = sub.reshape(s_, 18 * t_, 32) @ n.T  # (S, slots, 64)
    v = np.concatenate([np.zeros((s_, 15, 64)), v], axis=1)
    pcm = np.zeros((s_, 18 * t_, 32))
    for k in range(16):
        cols = np.arange(32) + 32 * (k % 2)
        pcm += d[k] * v[:, 15 - k : 15 - k + 18 * t_][:, :, cols]
    return pcm.reshape(s_, 576 * t_)


def _dense_hybrid(c):
    """The long (unwindowed), short and mixed maps K4 applies, (3, 576,
    1152), and the long windows as wins rows (4, 1152)."""
    # Long rows unwindowed (windows of ones): the window multiplies each
    # output column after the map, as wins does in the plain version.
    dense = np.stack([hybrid_structured(np.eye(576), cls, c["maps"], np.ones((4, 36)),
                                        c["alias"], c["perms"]) for cls in range(3)])
    w = np.asarray(c["wins"])
    wins = np.concatenate([np.tile(w[:, :18], 32), np.tile(w[:, 18:], 32)], axis=1)
    return dense, wins


@pytest.mark.parametrize("sr_row", SR_ROWS)
def test_hybrid_constants_rebuild_natural_cores(sr_row):
    """K4's compact constants (three 36 x 18 maps, windows, butterflies,
    permutations) through its algorithm in float64 give natural_cores'
    cores2, head and wins: exactly (to float64 rounding) from the float64
    builders, and within f32 rounding from the f32 buffers."""
    from mp3rgain_tpu_torch.decode.synthesis import _fused_hybrid_cores

    c = hk.synthesis_consts(sr_row)
    dense, wins = _dense_hybrid(c)
    # float64 dense maps in natural order, as natural_cores builds them.
    want = []
    for cls, core in enumerate(_fused_hybrid_cores()[:3]):
        q = np.zeros((576, 576))
        q[hk._perms(sr_row)[cls], np.arange(576)] = 1.0
        want.append(q @ core)
    np.testing.assert_allclose(dense, np.stack(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(wins, _fused_hybrid_cores()[3], rtol=0, atol=1e-15)

    cores2, head, p, wins32 = hk.natural_cores(sr_row)
    t = hk.HybridTables(sr_row)
    c32 = {"maps": t.syn_maps.double().numpy(), "wins": t.syn_wins.double().numpy(),
           "alias": t.syn_alias.double().numpy(), "perms": t.syn_perms.numpy()}
    assert t.syn_perms.dtype == torch.int32 and t.syn_maps.dtype == torch.float32
    dense32, wins_b = _dense_hybrid(c32)
    tol = 4 * np.finfo(np.float32).eps
    np.testing.assert_allclose(dense32[:2], cores2, rtol=0, atol=tol)
    np.testing.assert_allclose(dense32[2][:p], head, rtol=0, atol=tol)
    np.testing.assert_allclose(dense32[2][p:], cores2[1][p:], rtol=0, atol=tol)
    assert np.array_equal(wins_b.astype(np.float32), wins32)
    # The same zero pattern: the kernel touches only the dense maps' nonzeros.
    assert np.array_equal(np.abs(dense32[:2]) > 1e-6, np.abs(cores2) > 1e-6)


@pytest.mark.parametrize("sr_row", SR_ROWS)
def test_polyphase_taps_rebuild_tail_maps(sr_row):
    """K5's N (64 x 32) and D (16 x 32) with the frequency-inversion signs,
    through its algorithm in float64, give _tail_matrices_fused()'s two
    (576, 576) maps: out18_t @ na + out18_{t-1} @ nb."""
    from mp3rgain_tpu_torch.decode.tables import build_tables

    na, nb = syn._tail_matrices_fused()
    basis = np.zeros((576, 2, 576))
    basis[np.arange(576), 0, np.arange(576)] = 1.0  # out18_0 = e_r, out18_1 = 0
    tb = build_tables()
    got = polyphase_structured(basis, tb.synth_n, tb.synth_d)
    np.testing.assert_allclose(got[:, :576], na, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[:, 576:], nb, rtol=0, atol=1e-12)

    t = syn.DecodeTables(sr_row)
    assert t.synth_n.shape == (64, 32) and t.synth_d.shape == (16, 32)
    got32 = polyphase_structured(basis, t.synth_n.double().numpy(),
                                 t.synth_d.double().numpy())
    tol = 8 * np.finfo(np.float32).eps * np.abs(na).max()
    np.testing.assert_allclose(got32[:, :576], t.synth_na.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got32[:, 576:], t.synth_nb.numpy(), rtol=0, atol=tol)


def _rows(rng, c, r):
    xr = torch.from_numpy(rng.standard_normal((c, r, 576)).astype(np.float32))
    gm = np.zeros((c, r, hk.GM_N), np.int32)
    gm[..., hk.GM_CLS] = rng.integers(0, 3, (c, r))
    gm[..., hk.GM_BT] = rng.integers(0, 4, (c, r))
    return xr, torch.from_numpy(gm)


@pytest.mark.parametrize("sr_row", [0, 4, 7])
def test_structured_algorithms_match_plain_versions(sr_row):
    """On random rows of every class and block type, and random hybrid
    outputs of several tracks, the two algorithms in float64 agree with
    the plain versions (float32) to within the card tests' tolerance."""
    rng = np.random.default_rng(sr_row)
    t = hk.HybridTables(sr_row)
    xr, gm = _rows(rng, 2, 40)
    want = hk.hybrid_gemm(xr, gm, t).numpy()
    c = hk.synthesis_consts(sr_row)
    got = np.zeros_like(want, dtype=np.float64)
    for ch in range(2):
        for r in range(40):
            cls, bt = int(gm[ch, r, hk.GM_CLS]), int(gm[ch, r, hk.GM_BT])
            got[ch, r] = hybrid_structured(xr[ch, r:r + 1].double().numpy(), cls,
                                           c["maps"], c["wins"], c["alias"],
                                           c["perms"], bt)[0]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)

    d = syn.DecodeTables(sr_row)
    z = torch.from_numpy(rng.standard_normal((2, 3, 7, 1152)).astype(np.float32))
    want = syn.overlap_polyphase_reference(z, d).numpy()
    zz = z.double().numpy()
    out18 = zz[..., :576].copy()
    out18[:, :, 1:] += zz[:, :, :-1, 576:]
    from mp3rgain_tpu_torch.decode.tables import build_tables

    tb = build_tables()
    got = polyphase_structured(out18.reshape(6, 7, 576), tb.synth_n,
                               tb.synth_d).reshape(2, 3, 7 * 576)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors each wrapper runs its plain version and moves its
    plain counter, never the launch counter."""
    rng = np.random.default_rng(5)
    t = hk.HybridTables(3)
    d = syn.DecodeTables(3)
    xr, gm = _rows(rng, 2, 9)
    with tracing.recording():
        z = hk.hybrid_synthesis(xr, gm, t)
        pcm = syn.overlap_polyphase(z.reshape(2, 3, 3, 1152), d)
        got = [tracing.counter(f"{k}.{n}") for n in ("hybrid_synthesis", "overlap_polyphase")
               for k in ("plain", "launches")]
    assert got == [1, 0, 1, 0]
    assert torch.equal(z, hk.hybrid_gemm(xr, gm, t))
    assert pcm.shape == (2, 3, 3 * 576)
    assert torch.equal(pcm, syn.overlap_polyphase_reference(z.reshape(2, 3, 3, 1152), d))


def test_hybrid_synthesis_rejects_bad_inputs():
    rng = np.random.default_rng(7)
    t = hk.HybridTables(0)
    xr, gm = _rows(rng, 2, 5)
    with tracing.recording():
        with pytest.raises(ValueError, match="xr"):
            hk.hybrid_synthesis(xr.double(), gm, t)
        with pytest.raises(ValueError, match="xr"):
            hk.hybrid_synthesis(xr[0], gm, t)
        with pytest.raises(ValueError, match="xr"):
            hk.hybrid_synthesis(xr[..., :575], gm, t)
        with pytest.raises(ValueError, match="xr"):
            hk.hybrid_synthesis(xr.transpose(0, 1).contiguous().transpose(0, 1), gm, t)
        with pytest.raises(ValueError, match="gmeta"):
            hk.hybrid_synthesis(xr, gm[..., :-1], t)
        with pytest.raises(ValueError, match="gmeta"):
            hk.hybrid_synthesis(xr, gm.long(), t)
        with pytest.raises(ValueError, match="unsupported device"):
            hk.hybrid_synthesis(xr.to("meta"), gm.to("meta"), t)
        assert tracing.counter("plain.hybrid_synthesis") == 0
        assert tracing.counter("launches.hybrid_synthesis") == 0


def test_overlap_polyphase_rejects_bad_inputs():
    d = syn.DecodeTables(0)
    z = torch.zeros((2, 3, 4, 1152))
    with tracing.recording():
        with pytest.raises(ValueError, match="z"):
            syn.overlap_polyphase(z.double(), d)
        with pytest.raises(ValueError, match="z"):
            syn.overlap_polyphase(z[0], d)
        with pytest.raises(ValueError, match="z"):
            syn.overlap_polyphase(z[..., :1151], d)
        with pytest.raises(ValueError, match="z"):
            syn.overlap_polyphase(torch.zeros((3, 3, 4, 1152)), d)
        with pytest.raises(ValueError, match="z"):
            syn.overlap_polyphase(z.transpose(1, 2), d)
        with pytest.raises(ValueError, match="unsupported device"):
            syn.overlap_polyphase(z.to("meta"), d)
        assert tracing.counter("plain.overlap_polyphase") == 0
        assert tracing.counter("launches.overlap_polyphase") == 0
