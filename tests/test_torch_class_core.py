"""Torch port: K3, the split-bf16 class-core GEMM, and its probe entry.

class_core_gemm on CPU tensors (its plain version) against the JAX
statement of the TPU probe's kernel body (tools/hk_dotprobe.py:25-37:
bf16 hi/lo split of x, jnp.dot of bf16 operands with f32 results, summed
over passes and cores), with and without the heavy route's per-row class
select. Tolerance rtol 1e-5, atol 1e-5·max|ref|: each product of two bf16
values is exact in f32 on both sides, so only the summation order
differs. The split itself is bit-identical to JAX's astype, and the
bf16x3 product stays within 1e-4·max|ref| of the float64 unsplit x @ C.
The probe module (tools/hk_dotprobe.py) cannot be imported: it runs its
benchmark at import.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from mp3rgain_tpu_torch.decode import class_core as cc  # noqa: E402
from mp3rgain_tpu_torch.tools import hk_dotprobe  # noqa: E402

torch.set_num_threads(2)

ROWS = 300


def _inputs(ncore, seed=0, rows=ROWS, channels=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((channels, rows, 576)).astype(np.float32)
    x[:, ::7] *= 1e3  # a spread of magnitudes exercises the lo parts
    cores = rng.standard_normal((ncore, 576, 1152)).astype(np.float32)
    row_core = rng.integers(0, 3, (channels, rows)).astype(np.int32)
    row_core[:, :5] = 7  # rows that select no core come out zero
    return x, cores, row_core


def _jax_probe_body(x, chi, clo, npass, row_core):
    """hk_dotprobe.py:25-37 on each channel, plus the class select."""
    out = []
    for c in range(x.shape[0]):
        xc = jnp.asarray(x[c])
        xh = xc.astype(jnp.bfloat16)
        xl = (xc - xh.astype(jnp.float32)).astype(jnp.bfloat16)
        acc = None
        for k in range(chi.shape[0]):
            z = jnp.dot(xh, chi[k], preferred_element_type=jnp.float32)
            if npass >= 2:
                z += jnp.dot(xh, clo[k], preferred_element_type=jnp.float32)
            if npass >= 3:
                z += jnp.dot(xl, chi[k], preferred_element_type=jnp.float32)
            if row_core is not None:
                z = jnp.where(jnp.asarray(row_core[c] == k)[:, None], z, 0.0)
            acc = z if acc is None else acc + z
        out.append(np.asarray(acc))
    return np.stack(out)


def _split_np(a):
    hi = a.astype(ml_dtypes.bfloat16)
    return hi, (a - hi.astype(np.float32)).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("select", [False, True])
@pytest.mark.parametrize("npass", [1, 2, 3])
@pytest.mark.parametrize("ncore", [1, 2, 3])
def test_plain_version_matches_jax_probe_body(ncore, npass, select):
    x, cores, row_core = _inputs(ncore, seed=10 * ncore + npass)
    chi_np, clo_np = _split_np(cores)
    want = _jax_probe_body(x, jnp.asarray(chi_np), jnp.asarray(clo_np), npass,
                           row_core if select else None)
    chi, clo = cc.split_bf16(torch.from_numpy(cores))
    before = (cc.COUNT.kernel, cc.COUNT.plain)
    got = cc.class_core_gemm(torch.from_numpy(x), chi, clo, npass=npass,
                             row_core=torch.from_numpy(row_core) if select else None)
    assert (cc.COUNT.kernel, cc.COUNT.plain) == (before[0], before[1] + 1)
    assert got.shape == (2, ROWS, 1152) and got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
    if select:
        assert not got[:, :5].any()


def test_split_is_bit_identical_to_jax():
    x, cores, _ = _inputs(1)
    for a in (x, cores):
        hi, lo = cc.split_bf16(torch.from_numpy(a))
        want_hi, want_lo = _split_np(a)
        jhi = jnp.asarray(a).astype(jnp.bfloat16)
        jlo = (jnp.asarray(a) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
        for got, want in ((hi, want_hi), (lo, want_lo), (hi, np.asarray(jhi)),
                          (lo, np.asarray(jlo))):
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_bf16x3_budget_against_float64():
    """The bf16x3 product is within 1e-4·max|ref| of the unsplit float64
    product (the dropped lo×lo term and the split's rounding)."""
    x, cores, row_core = _inputs(3, seed=5)
    chi, clo = cc.split_bf16(torch.from_numpy(cores))
    got = cc.class_core_gemm(torch.from_numpy(x), chi, clo,
                             row_core=torch.from_numpy(row_core)).numpy()
    ref = np.zeros_like(got, dtype=np.float64)
    for k in range(3):
        z = x.astype(np.float64) @ cores[k].astype(np.float64)
        ref = np.where((row_core == k)[..., None], z, ref)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_wrapper_rejects_bad_inputs():
    x, cores, row_core = _inputs(2, rows=8, channels=1)
    xt = torch.from_numpy(x)
    chi, clo = cc.split_bf16(torch.from_numpy(cores))
    rc = torch.from_numpy(row_core)
    with pytest.raises(ValueError, match="dtype"):
        cc.class_core_gemm(xt.double(), chi, clo)
    with pytest.raises(ValueError, match="shape"):
        cc.class_core_gemm(xt[..., :512].contiguous(), chi, clo)
    with pytest.raises(ValueError, match="contiguous"):
        cc.class_core_gemm(xt[:, ::2], chi, clo)
    with pytest.raises(ValueError, match="clo"):
        cc.class_core_gemm(xt, chi, clo[:1])
    with pytest.raises(ValueError, match="row_core"):
        cc.class_core_gemm(xt, chi, clo, row_core=rc.long())
    with pytest.raises(ValueError, match="npass"):
        cc.class_core_gemm(xt, chi, clo, npass=4)
    with pytest.raises(ValueError, match="unsupported device"):
        cc.class_core_gemm(xt.to("meta"), chi.to("meta"), clo.to("meta"))
    empty = cc.class_core_gemm(xt[:, :0], chi, clo)
    assert empty.shape == (1, 0, 1152)


def test_probe_inputs_match_the_tpu_probe():
    """make_inputs draws what tools/hk_dotprobe.py:58-63 draws."""
    rows, ncore = 40, 2
    x, chi, clo = hk_dotprobe.make_inputs(rows, ncore)
    rng = np.random.default_rng(0)
    want_x = rng.standard_normal((2, 1, rows, 576)).astype(np.float32)
    cores = rng.standard_normal((ncore, 576, 1152)).astype(np.float32)
    want_hi, want_lo = _split_np(cores)
    assert np.array_equal(x.numpy(), want_x[:, 0])
    assert np.array_equal(chi.view(torch.int16).numpy(), want_hi.view(np.int16))
    assert np.array_equal(clo.view(torch.int16).numpy(), want_lo.view(np.int16))
    assert hk_dotprobe.flops(294_912, 3, 3) == 2 * 2 * 3 * 3 * 294_912 * 576 * 1152


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        hk_dotprobe.main(["--rows", "16", "--ncore", "1"])
