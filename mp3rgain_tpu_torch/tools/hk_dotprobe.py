"""Time K3, the split-bf16 class-core GEMM, against its plain version.

    python -m mp3rgain_tpu_torch.tools.hk_dotprobe [--ncore 3] [--npass 3]
        [--rows 294912] [--iters 10]

The port's counterpart of the TPU probe tools/hk_dotprobe.py: the same
work (2 channels × NCORE cores × NPASS bf16 passes over R rows of
(576) @ (576, 1152), f32 accumulation), the same inputs (numpy
default_rng(0): x (2, R, 576), cores (NCORE, 576, 1152) split into bf16
hi/lo) and the same FLOP count, 2·2·NCORE·NPASS·R·576·1152. It runs
decode.class_core.class_core_gemm (the CUDA kernel) and
class_core_gemm_reference (cuBLAS f32 products of the bf16-valued
operands) on the card, checks that they agree (rtol 1e-5, atol
1e-5·max|plain|) and prints each one's milliseconds (CUDA events) and
TFLOP/s beside the card's name and power limit.

The probe's TILES and VLIM knobs set TPU VMEM tile sizes and limits and
have no counterpart here; NCORE and NPASS are flags instead of
environment variables. Needs a CUDA device; nothing runs at import.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

RTOL = 1e-5
ATOL_REL = 1e-5  # atol = ATOL_REL * max|plain|


def make_inputs(rows: int, ncore: int, seed: int = 0):
    """(x (2, rows, 576) f32, chi, clo (ncore, 576, 1152) bf16) on the CPU,
    drawn as the TPU probe draws them (x first, then the cores, both
    float64 normals cast to f32); x is drawn one channel at a time,
    which gives the same numbers with half the float64 scratch."""
    from ..decode.class_core import split_bf16

    rng = np.random.default_rng(seed)
    x = np.empty((2, rows, 576), np.float32)
    for ch in range(2):
        x[ch] = rng.standard_normal((rows, 576))
    cores = rng.standard_normal((ncore, 576, 1152)).astype(np.float32)
    chi, clo = split_bf16(torch.from_numpy(cores))
    return torch.from_numpy(x), chi, clo


def flops(rows: int, ncore: int, npass: int) -> int:
    """The probe's FLOP count: 2 channels, 2 per multiply-add."""
    return 2 * 2 * ncore * npass * rows * 576 * 1152


def main(argv=None) -> None:
    from ..decode.class_core import class_core_gemm, class_core_gemm_reference
    from ..device import card_label, cuda_ms, require_cuda

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncore", type=int, default=3)
    ap.add_argument("--npass", type=int, default=3, choices=(1, 2, 3))
    ap.add_argument("--rows", type=int, default=294_912)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    dev = require_cuda()
    card = card_label()
    x, chi, clo = (t.to(dev) for t in make_inputs(args.rows, args.ncore))

    def kernel():
        return class_core_gemm(x, chi, clo, npass=args.npass)

    def plain():
        return class_core_gemm_reference(x, chi, clo, npass=args.npass)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale):
        raise SystemExit(f"kernel disagrees with the plain version: max_abs_err "
                         f"{err:.3e} of max|plain| {scale:.3e}")
    del got, want
    k_ms = cuda_ms(kernel, args.iters)
    p_ms = cuda_ms(plain, max(1, args.iters // 5))
    fl = flops(args.rows, args.ncore, args.npass)
    print(f"NCORE={args.ncore} NPASS={args.npass} R={args.rows} x 2 channels "
          f"[{card}]: kernel {k_ms:.3f} ms ({fl / k_ms / 1e9:.1f} TFLOP/s), "
          f"plain {p_ms:.3f} ms ({fl / p_ms / 1e9:.1f} TFLOP/s); max_abs_err "
          f"{err:.3e} of max|plain| {scale:.3e}", flush=True)


if __name__ == "__main__":
    main()
