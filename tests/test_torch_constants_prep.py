"""Torch port: host batch prep and constant tables against the JAX package.

The port copies the JAX package's numpy builders and host packers (it
imports nothing of the JAX package). Every copy must stay bit-identical
to its original: each side here runs on its own package's host code
(front-end, native library, buffer pool), and the port's LightTail
buffers (the decode back-end's DecodeTables, with K3's bf16 class cores,
among them) must equal constants.from_jax_arrays over the JAX builders'
arrays, for every MP3 sample-rate row.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import ml_dtypes  # noqa: E402

from mp3rgain_tpu.decode import entropy_kernel as jek  # noqa: E402
from mp3rgain_tpu.decode import frontend as jfe  # noqa: E402
from mp3rgain_tpu.decode import hybrid_kernel as jhk  # noqa: E402
from mp3rgain_tpu.decode import synthesis as jsyn  # noqa: E402
from mp3rgain_tpu.ops import iir as jiir  # noqa: E402
from mp3rgain_tpu.parallel import runner as jpr  # noqa: E402
from mp3rgain_tpu.utils import bufpool as jbufpool  # noqa: E402
from mp3rgain_tpu_torch import constants, native  # noqa: E402
from mp3rgain_tpu_torch.decode import entropy_kernel as ek  # noqa: E402
from mp3rgain_tpu_torch.decode import frontend as fe  # noqa: E402
from mp3rgain_tpu_torch.decode import hybrid_kernel as hk  # noqa: E402
from mp3rgain_tpu_torch.decode import synthesis as syn  # noqa: E402
from mp3rgain_tpu_torch.decode.format_tables import SR_ROW  # noqa: E402
from mp3rgain_tpu_torch.ops import coeffs, iir  # noqa: E402
from mp3rgain_tpu_torch.parallel import runner as pr  # noqa: E402
from mp3rgain_tpu_torch.testing import fixtures as tfixtures  # noqa: E402
from mp3rgain_tpu_torch.utils import bufpool  # noqa: E402

torch.set_num_threads(2)


def _assert_same(a, b, what):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
        return
    if a is None or isinstance(a, (int, float)):
        assert a == b, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def jax_arrays(sample_rate: int) -> dict:
    """constants.from_jax_arrays input, from the JAX package's builders."""
    sr_row = SR_ROW[sample_rate]
    arrays = dict(zip(constants.PACK_NAMES, jek._luts_packed()[:4]))
    arrays.update(zip(constants.CONSTS_NAMES, jhk._consts(sr_row)))
    arrays["cores2"], arrays["head"], _, arrays["wins"] = jhk.natural_cores(sr_row)
    (arrays["core_l"], arrays["core_s"], arrays["core_m"],
     arrays["wins"]) = jsyn._fused_hybrid_cores()
    arrays["na"], arrays["nb"] = jsyn._tail_matrices_fused()
    for i, (b_taps, a_tail) in enumerate(iir.stage_plan(sample_rate)):
        tc, g, _ = jiir._group_kernels(b_taps, a_tail, 128)
        t2m, _, p, ml2 = jiir._prefix_kernels(a_tail, 128, None, 128)
        for name, arr in zip(iir.STAGE_FIELDS, (tc, g, t2m, p, ml2)):
            arrays[f"iir.s{i}_{name}"] = arr
    return arrays


def test_copied_constants_and_builders():
    assert (ek.LANES, ek.SUBG, ek.W8_MAX, ek.META_ROWS, ek.MAX_STEPS) == (
        jek.LANES, jek.SUBG, jek.W8_MAX, jek.META_ROWS, jek.MAX_STEPS)
    assert ek.NB_CAPS == jek.NB_CAPS
    assert pr._B_LADDER == jpr._B_LADDER
    assert iir.NB2_DENSE_MAX == jiir.NB2_DENSE_MAX
    for g in list(range(0, 2000, 7)) + [10_000, 123_457]:
        assert ek._quantize_g(g) == jek._quantize_g(g)
        assert ek._cap(g, ek.NB_CAPS) == jek._cap(g, jek.NB_CAPS)
        for unit, base, ratio in ((4, 512, 1.3), (2, 512, 1.3), (8, 256, 4.0)):
            assert (pr._quantize_up(g, unit, base, ratio)
                    == jpr._quantize_up(g, unit, base, ratio))
    names = [f for f in dir(jhk) if f.startswith("GM_")]
    assert names and all(getattr(hk, f) == getattr(jhk, f) for f in names)
    _assert_same(ek._luts_packed(), jek._luts_packed(), "luts_packed")
    _assert_same(syn._alias_matrices(), jsyn._alias_matrices(), "alias")
    _assert_same(syn._fused_hybrid_cores(), jsyn._fused_hybrid_cores(), "cores")
    _assert_same(syn._synth_kernel(), jsyn._synth_kernel(), "synth_kernel")
    _assert_same(syn._tail_matrices(), jsyn._tail_matrices(), "tail")
    _assert_same(syn._tail_matrices_fused(), jsyn._tail_matrices_fused(), "tailf")
    # The port's native.py declares the packer's ctypes signature itself.
    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    mine, theirs = Lib(), Lib()
    native._declare(mine)
    jek._declare_pack(theirs)
    assert mine.mg_entropy_pack4.argtypes == theirs.mg_entropy_pack4.argtypes
    assert mine.mg_entropy_pack4.restype is theirs.mg_entropy_pack4.restype


@pytest.mark.parametrize("sr_row", range(9))
def test_hybrid_builders_bit_identical(sr_row):
    _assert_same(hk._perms(sr_row), jhk._perms(sr_row), "perms")
    _assert_same(hk._consts(sr_row), jhk._consts(sr_row), "consts")
    _assert_same(hk.natural_cores(sr_row), jhk.natural_cores(sr_row), "cores")


def test_iir_builders_bit_identical():
    for rate in coeffs.SUPPORTED_RATES:
        if rate in coeffs.DEGENERATE_RATES:
            assert iir.stage_plan(rate) == []
            continue
        assert iir._group_ok(rate, 128) == jiir._group_ok(rate, 128)
        for b_taps, a_tail in iir.stage_plan(rate):
            _assert_same(iir._arP_kernels(a_tail, 128),
                         jiir._arP_kernels(a_tail, 128), "arP")
            _assert_same(iir._group_kernels(b_taps, a_tail, 128),
                         jiir._group_kernels(b_taps, a_tail, 128), "group")
            for nb2 in (None, 3):
                _assert_same(iir._prefix_kernels(a_tail, 128, nb2, 128),
                             jiir._prefix_kernels(a_tail, 128, nb2, 128),
                             f"prefix {rate} {nb2}")


@pytest.mark.parametrize("sample_rate", sorted(SR_ROW))
def test_from_jax_arrays_matches_port_state(sample_rate):
    ja = jax_arrays(sample_rate)
    n_channels = 1 if SR_ROW[sample_rate] % 2 else 2
    tail = pr.LightTail(sample_rate, n_channels)
    state = constants.from_jax_arrays(ja, sample_rate, n_channels, "cpu")
    mine = tail.state_dict()
    assert sorted(state) == sorted(mine)
    for k, v in state.items():
        assert v.dtype == mine[k].dtype and torch.equal(v, mine[k]), k
    fresh = pr.LightTail(sample_rate, n_channels)
    fresh.load_state_dict(state)


@pytest.mark.parametrize("sr_row", [0, 3, 8])
def test_index_tables_equal_onehot_products(sr_row):
    """The K2 gather tables reproduce the JAX kernel's one-hot dots."""
    slot, win = jhk._consts(sr_row)[:2]
    slot_idx = constants.onehot_to_index(slot)
    win_idx = constants.onehot_to_index(win)
    rng = np.random.default_rng(sr_row)
    scf = rng.integers(0, 32, (5, 64)).astype(np.float32)
    sbg = rng.integers(0, 8, (5, 3)).astype(np.float32)
    for c in range(3):
        want = scf @ slot[c]
        got = np.where(slot_idx[c] >= 0, scf[:, np.maximum(slot_idx[c], 0)], 0)
        assert np.array_equal(got, want)
        want = sbg @ win[c]
        got = np.where(win_idx[c] >= 0, sbg[:, np.maximum(win_idx[c], 0)], 0)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("sr_row", [0, 4, 8])
def test_decode_tables_equal_jax_onehot_products(sr_row):
    """DecodeTables' index selects reproduce the JAX decode's one-hot HIGH
    dots (reorder, scalefactor and subblock-gain expansion) and its
    per-class constants; chi + clo is the f32 core's bf16 split."""
    from mp3rgain_tpu.decode.tables import CLASS_OF_KIND, row_tables

    rt = row_tables(sr_row)
    t = syn.DecodeTables(sr_row)
    rng = np.random.default_rng(sr_row)
    x = rng.integers(-8206, 8207, (5, 576)).astype(np.float32)
    assert np.array_equal(x[:, t.perm_short.numpy()], x @ rt.perm_short_onehot.T)
    scf = torch.from_numpy(rng.integers(0, 32, (5, 64)).astype(np.float32))
    sbg = torch.from_numpy(rng.integers(0, 8, (5, 3)).astype(np.float32))
    for c, (got_scf, got_sbg) in enumerate(zip(syn._expand(scf, t.slot_idx),
                                               syn._expand(sbg, t.win_idx))):
        assert np.array_equal(got_scf.numpy(), scf.numpy() @ rt.slot_onehot[c])
        assert np.array_equal(got_sbg.numpy(), sbg.numpy() @ rt.win_onehot[c])
    assert np.array_equal(t.class_of_kind.numpy(), CLASS_OF_KIND)
    _assert_same(t.pretab.numpy(), rt.pretab, "pretab")
    _assert_same(t.band_start.numpy(), rt.band_start, "band_start")
    _assert_same(t.is_short.numpy(), rt.is_short.astype(np.float32), "is_short")
    cores = np.stack(jsyn._fused_hybrid_cores()[:3]).astype(np.float32)
    assert t.chi.dtype == t.clo.dtype == torch.bfloat16
    hi = t.chi.to(torch.float32).numpy()
    assert np.array_equal(hi, cores.astype(ml_dtypes.bfloat16).astype(np.float32))
    err = np.abs(hi + t.clo.to(torch.float32).numpy() - cores)
    assert (err <= np.abs(cores) * 2.0 ** -16).all()


def test_luts_from_packed_equal_plain_tables():
    got = constants.luts_from_packed(jek._luts_packed()[:4])
    want = ek.plain_luts()
    for k in ek.LUT_NAMES:
        _assert_same(got[k], want[k], k)


def _tracks():
    out = []
    for sr, ch, mode, br, seed in ((44100, 2, tfixtures.MODE_JOINT, 128, 1),
                                   (44100, 2, tfixtures.MODE_JOINT, 192, 2),
                                   (44100, 2, tfixtures.MODE_STEREO, 96, 3)):
        rng = np.random.default_rng(seed)
        n = int(sr * 0.4)
        wave = 0.3 * np.sin(2 * np.pi * (300 + 70 * seed) * np.arange(n) / sr)
        wave += 0.1 * rng.standard_normal(n)
        pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
        pcm = np.stack([pcm, np.roll(pcm, 5)], axis=1)
        out.append(tfixtures.encode_mp3(pcm, sr, bitrate=br, mode=mode))
    return out


@pytest.fixture
def zeroed_pool(monkeypatch):
    """Pooled buffers come back with stale contents in the regions the
    packers leave unwritten (never read by a decode); hand out zeroed
    ones so whole buffers compare. Each package has its own pool."""
    for pool in (bufpool, jbufpool):
        monkeypatch.setattr(pool, "take", lambda shape, dtype: np.zeros(shape, dtype))


def test_prepare_batch_bit_identical(zeroed_pool):
    ups = [fe.unpack_data_light(d) for d in _tracks()]
    jups = [jfe.unpack_data_light(d) for d in _tracks()]
    for kw in ({}, {"quantize_nb": True}, {"force_nb": 3, "force_g_pad": 512}):
        a = ek.prepare_batch([u.md for u in ups], [u.meta for u in ups], **kw)
        b = jek.prepare_batch([u.md for u in jups], [u.meta for u in jups], **kw)
        for f in ("scalars", "buf", "meta", "inv"):
            _assert_same(getattr(a, f), getattr(b, f), f)
        assert (a.nb, a.n, a.w8_cap, a.g_pad) == (b.nb, b.n, b.w8_cap, b.g_pad)
    steps_meta = np.concatenate([u.meta for u in ups])
    _assert_same(ek._estimate_steps(steps_meta), jek._estimate_steps(steps_meta),
                 "steps")


@pytest.mark.parametrize("packed", [True, False])
def test_prepare_batch_arrays_light_bit_identical(packed, zeroed_pool):
    name = "unpack_data_light_packed" if packed else "unpack_data_light"
    pa, ra, ga = pr.prepare_batch_arrays_light(
        [getattr(fe, name)(d) for d in _tracks()], 2)
    pb, rb, gb = jpr.prepare_batch_arrays_light(
        [getattr(jfe, name)(d) for d in _tracks()], 2)
    assert ga == gb
    for f in ("scalars", "buf", "meta", "inv"):
        _assert_same(getattr(pa, f), getattr(pb, f), f)
    _assert_same(list(ra), list(rb), "rest")
