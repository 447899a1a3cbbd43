"""Batch analysis on one or several CUDA devices (parallel.runner), across
processes (parallel.multihost), and their self-checks (parallel.dryrun).

The names below are those of the JAX package's parallel package, with
Runner in MeshRunner's place, plus RunnerGroup. They load parallel.runner,
and with it torch, on first use only: the CLI's byte surgery imports
parallel.multihost and must not pull torch in.
"""

_RUNNER_NAMES = ("BatchResult", "Runner", "RunnerGroup", "analyze_library")

__all__ = list(_RUNNER_NAMES)


def __getattr__(name):
    if name in _RUNNER_NAMES:
        from . import runner

        return getattr(runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
