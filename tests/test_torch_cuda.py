"""Torch port on a CUDA card: each hand-written kernel against its plain
version, and both routes on the card against the CPU.

Every test carries the `cuda` marker and skips where
torch.cuda.is_available() is false. The file needs neither jax nor an MP3
encoder, so it runs on a GPU machine that has neither: its inputs are
crafted streams (mp3rgain_tpu_torch.testing.craft) and the committed
clips of mp3rgain_tpu_torch/testing/data, and it imports nothing of the
JAX package. Run there with
`python -m pytest tests/test_torch_cuda.py -q -m cuda`.
"""

import os

import numpy as np
import pytest
import torch

from mp3rgain_tpu_torch import _build
from mp3rgain_tpu_torch.decode import class_core as cc
from mp3rgain_tpu_torch.decode import entropy_kernel as ek
from mp3rgain_tpu_torch.decode import frontend as fe
from mp3rgain_tpu_torch.decode import hybrid_kernel as hk
from mp3rgain_tpu_torch.decode import synthesis as syn
from mp3rgain_tpu_torch.parallel import runner as pr
from mp3rgain_tpu_torch.testing import craft
from mp3rgain_tpu_torch.testing import make_smoke_data as smoke

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _clip(name: str) -> bytes:
    with open(os.path.join(smoke.DATA_DIR, name), "rb") as f:
        return f.read()


STREAMS = {
    "mono_22k": lambda: _clip(smoke.MONO_TRACK),
    "transient": lambda: _clip(smoke.TRANSIENT_TRACK),
    "truncated": lambda: _clip(smoke.TRANSIENT_TRACK)[:20000],
    "craft_intensity": craft.craft_intensity_stream,
    "craft_mixed_block": craft.craft_mixed_block_stream,
    "craft_count1b": craft.craft_count1b_stream,
    "craft_lsf_intensity": craft.craft_lsf_intensity_stream,
}


def _on(dev, arrays):
    return [pr._to_device(a, dev) for a in arrays]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k1_kernel_matches_plain_and_host(name, dev):
    data = STREAMS[name]()
    light = fe.unpack_data_light(data)
    p = ek.prepare_batch(light.md, light.meta)
    scalars, buf, meta, inv = _on(dev, (p.scalars, p.buf, p.meta, p.inv))
    luts = ek.EntropyLuts().to(dev)
    k0, p0 = ek.COUNT.kernel, ek.COUNT.plain
    spec_b, mout = ek.decode_blocks(scalars, buf, meta, luts)
    torch.cuda.synchronize()
    assert (ek.COUNT.kernel, ek.COUNT.plain) == (k0 + 1, p0)
    ref_s, ref_m = ek.decode_blocks_reference(scalars, buf, meta, luts)
    assert torch.equal(spec_b, ref_s) and torch.equal(mout, ref_m)
    spec, big_end, c1end, _ = ek.unsort_blocks(spec_b, mout, inv, nb=p.nb)
    full = fe.unpack_data(data)
    valid = full.info[:, fe.VALID] == 1
    got = spec[: p.n].cpu().numpy().astype(np.int32)
    assert not ((got != full.spectrum).any(axis=1) & valid).any()
    assert np.array_equal(big_end[: p.n].cpu().numpy()[valid],
                          full.info[valid, fe.BIG_END])
    assert np.array_equal(c1end[: p.n].cpu().numpy()[valid],
                          full.info[valid, fe.COUNT1_END])


@pytest.mark.parametrize("name", ["mono_22k", "transient", "craft_intensity",
                                  "craft_lsf_intensity"])
def test_k2_kernel_matches_plain(name, dev):
    u = fe.unpack_data_light_packed(STREAMS[name]())
    prep, rest, g_max = pr.prepare_batch_arrays_light([u], u.n_channels)
    args = _on(dev, (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
    tail = pr.LightTail(u.sample_rate, u.n_channels).to(dev)
    spec_b, mout = ek.decode_blocks(*args[:3], tail.luts)
    cm = pr.channel_major_inputs(spec_b, mout, *args[3:11], nb=prep.nb,
                                 g_max=g_max, n_channels=u.n_channels)
    k0 = hk.COUNT.kernel
    got = hk.fused_requant_stereo(*cm, tail.hybrid)
    torch.cuda.synchronize()
    assert hk.COUNT.kernel == k0 + 1
    want = hk.fused_requant_stereo_reference(*cm, tail.hybrid)
    scale = want.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


def test_light_path_on_card_matches_cpu(dev):
    u = fe.unpack_data_light_packed(_clip(smoke.TRANSIENT_TRACK))
    ek.COUNT.reset()
    hk.COUNT.reset()
    hist, louds, peaks = pr.Runner(dev).analyze_unpacked_light(
        [u, u], u.sample_rate, u.n_channels)
    assert (ek.COUNT.kernel, hk.COUNT.kernel) == (1, 1)
    assert (ek.COUNT.plain, hk.COUNT.plain) == (0, 0)
    c_hist, c_louds, c_peaks = pr.Runner("cpu").analyze_unpacked_light(
        [u], u.sample_rate, u.n_channels)
    assert torch.equal(hist.sum(dim=1).cpu(), c_hist.sum(dim=1).repeat(2))
    assert np.all(np.abs(louds - c_louds[0]) <= 0.02 + 1e-9)
    np.testing.assert_allclose(peaks, c_peaks[0], rtol=2e-4, atol=1e-6)


def test_failed_kernel_library_raises(dev, monkeypatch):
    def broken():
        raise RuntimeError("build failed")

    monkeypatch.setattr(_build, "library", broken)
    p = ek.prepare_batch(*(lambda lt: (lt.md, lt.meta))(
        fe.unpack_data_light(craft.craft_count1b_stream())))
    before = ek.COUNT.plain
    with pytest.raises(RuntimeError, match="build failed"):
        ek.decode_blocks(*_on(dev, (p.scalars, p.buf, p.meta)),
                         ek.EntropyLuts().to(dev))
    assert ek.COUNT.plain == before


# rows: 1000 is 7 full row tiles of 128 and a partial one of 104; 300 is
# 3 tiles (18 output tiles, fewer than the card's SMs); 40 is one partial
# tile.
@pytest.mark.parametrize("ncore,npass,select,rows", [
    (1, 1, False, 1000), (2, 2, False, 1000), (3, 3, False, 1000), (3, 3, True, 1000),
    (3, 2, True, 1000), (3, 1, True, 1000), (1, 3, True, 1000), (1, 3, False, 1000),
    (3, 3, True, 300), (2, 1, False, 300), (3, 3, False, 40)])
def test_k3_kernel_matches_plain(ncore, npass, select, rows, dev):
    rng = np.random.default_rng(ncore * 10 + npass)
    x = torch.from_numpy(rng.standard_normal((2, rows, 576)).astype(np.float32)).to(dev)
    cores = torch.from_numpy(rng.standard_normal((ncore, 576, 1152)).astype(np.float32))
    chi, clo = (t.to(dev) for t in cc.split_bf16(cores))
    row_core = None
    if select:
        rc = rng.integers(0, ncore, (2, rows)).astype(np.int32)
        rc[0, :256] = 0  # tiles of one class skip the other cores
        rc[1, rows // 3 : rows // 3 + 10] = -1  # rows of no class come out zero
        row_core = torch.from_numpy(rc).to(dev)
    k0, p0 = cc.COUNT.kernel, cc.COUNT.plain
    got = cc.class_core_gemm(x, chi, clo, npass=npass, row_core=row_core)
    torch.cuda.synchronize()
    assert (cc.COUNT.kernel, cc.COUNT.plain) == (k0 + 1, p0)
    want = cc.class_core_gemm_reference(x, chi, clo, npass=npass, row_core=row_core)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    if select:
        assert not got[1, rows // 3 : rows // 3 + 10].any()
    # No split-K and no atomics: a second call gives the same bits.
    again = cc.class_core_gemm(x, chi, clo, npass=npass, row_core=row_core)
    assert torch.equal(got, again)


def test_k3_rejects_misaligned_input(dev):
    """TMA takes 16-byte aligned tensors; the wrapper raises before a launch."""
    x = torch.zeros(4 * 576 + 1, device=dev)[1:].view(1, 4, 576)
    chi = torch.zeros((1, 576, 1152), dtype=torch.bfloat16, device=dev)
    k0 = cc.COUNT.kernel
    with pytest.raises(ValueError, match="16-byte aligned"):
        cc.class_core_gemm(x, chi, chi)
    assert cc.COUNT.kernel == k0


def test_k3_failed_library_raises(dev, monkeypatch):
    def broken():
        raise RuntimeError("build failed")

    monkeypatch.setattr(_build, "library", broken)
    x = torch.zeros((1, 4, 576), device=dev)
    chi = torch.zeros((1, 576, 1152), dtype=torch.bfloat16, device=dev)
    before = cc.COUNT.plain
    with pytest.raises(RuntimeError, match="build failed"):
        cc.class_core_gemm(x, chi, chi)
    assert cc.COUNT.plain == before


def test_heavy_route_on_card_matches_cpu_and_light(dev):
    data = _clip(smoke.TRANSIENT_TRACK)
    full = fe.unpack_data(data)
    cc.COUNT.reset()
    hist, louds, peaks = pr.Runner(dev).analyze_unpacked(
        [full, full], full.sample_rate, full.n_channels)
    assert cc.COUNT.kernel == 1 and cc.COUNT.plain == 0
    c_hist, c_louds, c_peaks = pr.Runner("cpu").analyze_unpacked(
        [full], full.sample_rate, full.n_channels)
    assert torch.equal(hist.sum(dim=1).cpu(), c_hist.sum(dim=1).repeat(2))
    assert np.all(np.abs(louds - c_louds[0]) <= 0.02 + 1e-9)
    np.testing.assert_allclose(peaks, c_peaks[0], rtol=2e-4, atol=1e-6)

    # light_tail(fused=False) on the card equals the heavy route exactly.
    u = fe.unpack_data_light_packed(data)
    prep, rest, g_max = pr.prepare_batch_arrays_light([u, u], u.n_channels)
    args = _on(dev, (prep.scalars, prep.buf, prep.meta, prep.inv) + tuple(rest))
    tail = pr.LightTail(u.sample_rate, u.n_channels).to(dev)
    light = pr.analysis_core_light(tail, *args, nb=prep.nb, g_max=g_max, fused=False)
    heavy_args = _on(dev, pr.prepare_batch_arrays([full, full], full.n_channels))
    heavy = pr.analysis_core(tail, *heavy_args)
    for a, b in zip(light, heavy):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", [smoke.MONO_TRACK, smoke.TRANSIENT_TRACK])
def test_decode_file_on_card_matches_cpu(name, dev):
    path = os.path.join(smoke.DATA_DIR, name)
    got, sr = syn.decode_file(path, device=dev)
    want, sr_cpu = syn.decode_file(path, device="cpu")
    assert sr == sr_cpu and got.shape == want.shape
    bound = 5e-4 * np.sqrt((want ** 2).mean()) + 1e-5
    assert np.abs(got - want).max() < bound
