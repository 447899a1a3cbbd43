"""The port's whole-pipeline entry points, the counterpart of the JAX
package's __graft_entry__.py.

- entry(device) returns (fn, args): one forward analysis step of the
  host-decoded ("heavy") route, parallel.runner.analysis_core bound to
  the tables of 44.1 kHz stereo (the route whose decode GEMM is the K3
  kernel), and parallel.dryrun.example_batch(4, 6) uploaded to the
  device. fn(*args) returns (hist (4, 12000) int32, loud_idx (4,) int32,
  peak (4,) float32).
- dryrun_multichip and dryrun_multihost are parallel.dryrun's.

Everything runs on the CUDA card unless given device="cpu".

    python -c "from mp3rgain_tpu_torch import entry; fn, args = entry.entry(); print(fn(*args)[1])"
"""

from __future__ import annotations

from functools import partial

from .parallel.dryrun import dryrun_multichip, dryrun_multihost, example_batch

__all__ = ["entry", "dryrun_multichip", "dryrun_multihost"]


def entry(device="cuda"):
    """(fn, example_args): one forward analysis step on `device`."""
    from .device import resolve_device
    from .parallel import runner as pr

    dev = resolve_device(device)
    fn = partial(pr.analysis_core, pr.LightTail(44100, 2).to(dev))
    args = tuple(pr._to_device(a, dev) for a in example_batch(batch=4, frames=6))
    return fn, args
