"""The traced window: torch.profiler over the measured passes or releases,
reduced to device seconds by kernel name, the union of device activity,
and the longest idle gaps labelled by what the host had open.

The benchmark's own spans (span(), record_function underneath), which a
driver wraps around each unit of its window and each call into the
program, are known by having been opened through span(); a gap's label is
the innermost host event open when the gap began, under the benchmark span
around it.
"""

from __future__ import annotations

import bisect
import contextlib

BENCH_SPANS: set = set()  # the names span() has opened


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint [start, end] pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """The block under torch.profiler when enabled (else no profiler)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def span(name: str):
    """A host span in the trace (recorded only while torch.profiler runs)."""
    from torch.profiler import record_function

    BENCH_SPANS.add(name)
    return record_function(name)


def _raw_events(prof):
    """(name, is device work, start ns, end ns, is a user span) of every
    event: the profiler's raw records, which are far cheaper to walk than
    its event tree."""
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), str(e.device_type()).endswith("CUDA"), start,
               start + e.duration_ns(), e.is_user_annotation())


def reduce(prof, top: int = 10) -> dict:
    """kernels {name: device seconds}, busy_s (union of device activity),
    breakdown {device_ops, idle_gaps}."""
    dev, host = [], []
    for name, on_device, a, b, annotation in _raw_events(prof):
        if on_device:
            if not annotation:  # a host span mirrored on the device is no work
                dev.append((name, a, b))
        elif b > a:
            host.append((a, b, name))
    kernels = {}
    for name, a, b in dev:
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e9
    busy_spans = merged([(a, b) for _, a, b in dev])
    busy = sum(b - a for a, b in busy_spans) / 1e9
    gaps = sorted(((busy_spans[i + 1][0] - busy_spans[i][1], busy_spans[i][1])
                   for i in range(len(busy_spans) - 1)), reverse=True)[:top]
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for length, start in gaps:
        t = start + 1
        outer = inner = None
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            a, b, name = host[i]
            if b <= t:
                continue
            if name in BENCH_SPANS:
                outer = outer or name
            else:
                inner = inner or name
            if outer and inner:
                break
        label = outer or "outside the window's spans"
        if inner:
            label += " > " + inner
        idle.append([label, length / 1e9])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"kernels": kernels, "busy_s": busy,
            "breakdown": {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}}
