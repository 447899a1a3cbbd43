"""K3: the class-core GEMM in split bf16 ("bf16x3"), and its plain version.

Counterpart of the TPU probe kernel tools/hk_dotprobe.py::make (body at
:25-37) and of the product the JAX package's host-decoded decode runs
under jax.default_matmul_precision("high"): the three class-core GEMMs
of mp3rgain_tpu/decode/synthesis.py::_imdct_overlap_fused and their
per-row class select. The contract:

    class_core_gemm(x (C, R, 576) f32, chi, clo (NCORE, 576, 1152) bf16,
                    *, npass=3, row_core (C, R) int32 | None) -> (C, R, 1152) f32
    z[c, r] = sum_k [row_core is None or row_core[c, r] == k] *
              (xh @ chi_k + [npass >= 2] xh @ clo_k + [npass >= 3] xl @ chi_k)
    xh = bf16_rn(x), xl = bf16_rn(x - f32(xh))

The lo x lo term is left out, as in the probe. On CUDA tensors the
wrapper launches the hand-written kernel csrc/class_core_gemm.cu (wgmma
with TMA-fed shared memory, bf16 operands, f32 accumulation; the three
passes as one K loop); on CPU tensors it runs class_core_gemm_reference.
A failed build or launch raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import LaunchCount, check_tensor

K = 576
N = 1152

# Kernel launches and plain-version calls of class_core_gemm.
COUNT = LaunchCount()


def split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 `t` → (hi, lo) bf16 with hi = bf16_rn(t), lo = bf16_rn(t − hi),
    rounding to nearest even on both, as JAX's astype does."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.to(torch.float32)).to(torch.bfloat16)


def _check_inputs(x, chi, clo, npass, row_core):
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (C, R, {K})")
    c, r = x.shape[:2]
    dev = x.device
    check_tensor("x", x, torch.float32, (c, r, K), dev)
    ncore = chi.shape[0] if chi.dim() == 3 else -1
    if ncore < 1:
        raise ValueError(f"chi: shape {tuple(chi.shape)}, expected (NCORE, {K}, {N})")
    check_tensor("chi", chi, torch.bfloat16, (ncore, K, N), dev)
    check_tensor("clo", clo, torch.bfloat16, (ncore, K, N), dev)
    if row_core is not None:
        check_tensor("row_core", row_core, torch.int32, (c, r), dev)
    if npass not in (1, 2, 3):
        raise ValueError(f"npass {npass}, expected 1, 2 or 3")
    return dev, c, r, ncore


def class_core_gemm(x: torch.Tensor, chi: torch.Tensor, clo: torch.Tensor,
                    *, npass: int = 3,
                    row_core: torch.Tensor | None = None) -> torch.Tensor:
    """The contract in the module docstring. CUDA tensors launch the
    kernel on the current stream without synchronising; CPU tensors run
    class_core_gemm_reference."""
    dev, c, r, ncore = _check_inputs(x, chi, clo, npass, row_core)
    if dev.type == "cpu":
        return class_core_gemm_reference(x, chi, clo, npass=npass, row_core=row_core)
    if dev.type != "cuda":
        raise ValueError(f"class_core_gemm: unsupported device {dev}")
    if ncore > 31:
        raise ValueError(f"class_core_gemm: ncore {ncore}, the kernel takes 1 to 31")
    for name, t in (("x", x), ("chi", chi), ("clo", clo)):
        if t.data_ptr() % 16:
            raise ValueError(f"class_core_gemm: {name} is not 16-byte aligned (TMA)")
    out = torch.empty((c, r, N), dtype=torch.float32, device=dev)
    if c * r == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mg_cuda_class_core_gemm(
        x.data_ptr(), chi.data_ptr(), clo.data_ptr(),
        None if row_core is None else row_core.data_ptr(), out.data_ptr(),
        c, r, ncore, npass, stream,
    )
    COUNT.kernel += 1
    _build.check(rc, "class_core_gemm launch")
    return out


def class_core_gemm_reference(x: torch.Tensor, chi: torch.Tensor,
                              clo: torch.Tensor, *, npass: int = 3,
                              row_core: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of class_core_gemm (same contract): each
    product is a float32 torch.matmul of bf16-valued operands, exact with
    TF32 off; only the summation order differs from the kernel's. Cores
    that no row selects are skipped."""
    _, c, r, ncore = _check_inputs(x, chi, clo, npass, row_core)
    COUNT.plain += 1
    xh, xl = (t.to(torch.float32) for t in split_bf16(x))
    acc = torch.zeros((c, r, N), dtype=torch.float32, device=x.device)
    for k in range(ncore):
        sel = None if row_core is None else (row_core == k)[..., None]
        if sel is not None and not bool(sel.any()):
            continue
        hi = chi[k].to(torch.float32)
        z = torch.matmul(xh, hi)
        if npass >= 2:
            z += torch.matmul(xh, clo[k].to(torch.float32))
        if npass >= 3:
            z += torch.matmul(xl, hi)
        if sel is None:
            acc += z
        else:
            acc = torch.where(sel, z, acc)
        del z
    return acc
