"""Device and precision policy of the port.

Counterpart of the backend sniffing in mp3rgain_tpu/parallel/runner.py
(use_fused_hybrid, device_entropy_enabled): the port has no routing
switches. A CUDA device runs the hand-written kernels; a CPU device runs
their plain PyTorch versions (tests only). Asking for CUDA where there is
none raises — nothing continues on the CPU instead.

Precision: float32 everywhere with TF32 off. The JAX package pinned
near-f32 matmuls because bf16 through synthesis and the IIR broke the
±0.05 dB budget (mp3rgain_tpu/decode/synthesis.py:437-441,
mp3rgain_tpu/ops/iir.py:289-293); TF32 keeps ~3 decimal digits and is
unmeasured against that budget, so it stays off.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

import torch

from .replaygain import DeviceUnavailable


def apply_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32), set explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def require_cuda() -> torch.device:
    """The current CUDA device, or DeviceUnavailable (a RuntimeError) when
    there is none."""
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "a CUDA device is required (torch.cuda.is_available() is False)"
        )
    apply_precision_policy()
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """Validate an explicit device argument ("cuda", "cuda:0", "cpu", ...)
    and apply the precision policy."""
    dev = torch.device(device)
    if dev.type == "cuda":
        cur = require_cuda()
        if dev.index is None:
            dev = cur
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    apply_precision_policy()
    return dev


@dataclass
class LaunchCount:
    """Per-kernel counters: `kernel` counts launches of the hand-written
    kernel, `plain` counts calls of its plain PyTorch version."""

    kernel: int = 0
    plain: int = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


def mark_stage(on_stage, name: str) -> None:
    """Call on_stage(name), if a caller gave one: the device pipelines
    report each stage as it has been enqueued (for per-stage timing with
    CUDA events)."""
    if on_stage is not None:
        on_stage(name)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple | None = None, device=None) -> None:
    """Raise ValueError unless `t` has the dtype, shape (None entries are
    free), device and contiguity a kernel takes."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and (
        t.dim() != len(shape)
        or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of `fn` over `iters` calls after
    one warm-up call, timed with CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`--query-gpu=name,power.limit --format=csv,noheader`), first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]
