"""Spans and counters inside the port, on the profiler's clock.

A span marks one piece of work at a layer boundary: a file's walk, a
batch's prep, upload and enqueue, a wait on the device, a manifest write,
one stage of a batch on the device. It records its name, start and end,
its thread, the span that caused it and the id of the entry-point call
(scan, album, album union) it belongs to; work handed to a pool thread
through carry() keeps the submitting span as its parent, and the first
span the pool thread opens for it also records when it was submitted
(a prep span's queue wait is its start minus that). A counter adds up
what a layer did: padded and real rows, out-of-memory retries, kernel
launches and calls of their plain versions.

Recording is on while a torch.profiler session runs, which every thread
sees through torch's module flag torch.autograd.profiler._is_profiler_enabled,
and inside recording() (tests, operators). Off, a span site reads that one
flag and gets a shared do-nothing context back: no allocation, no lock, no
record_function, no CUDA event; a counter reads the flag and returns.

Each profiler session (torch's start hook, wrapped below) and each
recording() starts a fresh record, which stays in memory (nothing is
written to disk) until the next one starts: snapshot() returns it as plain
Python data. recording() does not nest, and a profiler session opened
inside it records into its record. The spans are kept in a bounded store
(STORE_SPANS, the rest counted as dropped); per-name totals (count, wall,
self time) and the counters are never dropped.

Clock: time.time_ns(), the Unix-epoch nanoseconds the profiler stamps its
own events with, so spans line up with a saved trace. On the caller's
thread, where the profiler records host events, a span is also opened as a
record_function of the same name. The Runner maps its CUDA-event intervals
(device busy, device stages) onto this clock through an anchor taken when it
is built (parallel/runner.py).

The idle partition (idle_partition) charges each instant the device was
idle, between the record's first and last host span, to the first class in
IDLE_CLASSES with a span open on any thread then; the rest is untraced.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

# Closed spans a record keeps: a 51 s window of the benchmark's library
# rescan or album ingest holds 13,000-21,000 (PERF.md, §6).
STORE_SPANS = 1 << 18

# Where device idle is charged: the first class with a span open, in order.
IDLE_CLASSES = (
    ("upload", ("upload", "slot_wait", "enqueue")),
    ("prep", ("prep",)),
    ("walk", ("walk", "detect")),
    ("manifest", ("manifest.lookup", "manifest.journal", "manifest.compact")),
    ("album_union", ("album_union",)),
    ("collect", ("collect",)),
    ("admit", ("admit", "drain")),
)


class _Forced:
    """Stands in for the profiler module inside recording()."""

    _is_profiler_enabled = True


# What a span site reads: torch's profiler module, or _Forced while
# recording() is active.
_gate = _profiler
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_record_lock = threading.Lock()
_record = None


class _Record:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans: list[tuple] = []
        self.dropped = 0
        self.totals: dict[str, list] = {}  # name -> [count, wall ns, self ns]
        self.counters: dict[str, int] = {}
        self.busy: list[tuple[int, int]] = []
        self.sealed = False
        self.snap: dict | None = None

    def add(self, span: tuple, self_ns: int) -> None:
        wall = span[6] - span[5]
        with self.lock:
            if len(self.spans) < STORE_SPANS:
                self.spans.append(span)
            else:
                self.dropped += 1
            t = self.totals.setdefault(span[3], [0, 0, 0])
            t[0] += 1
            t[1] += wall
            t[2] += self_ns


def _live() -> _Record:
    """The record spans go to, a fresh one where the last has ended."""
    global _record
    rec = _record
    if rec is None or rec.sealed:
        with _record_lock:
            if _record is None or _record.sealed:
                _record = _Record()
            rec = _record
    return rec


def _fresh() -> None:
    global _record
    with _record_lock:
        _record = _Record()


def _on_profiler_start(start=_profiler._run_on_profiler_start):
    """torch.autograd.profiler's hook at the start of every profiler
    session: outside recording(), the session starts a fresh record."""
    if _gate is _profiler:
        _fresh()
    start()


_profiler._run_on_profiler_start = _on_profiler_start


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "id", "parent", "root", "submit", "start", "child_ns", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.id = next(_ids)
        self.submit = None
        if st:
            self.parent, self.root = st[-1].id, st[-1].root
        else:
            ctx = getattr(_local, "ctx", None)
            if ctx is None:
                self.parent, self.root = None, self.id
            else:
                self.parent, self.root, self.submit = ctx
                if self.root is None:
                    self.root = self.id
        self.child_ns = 0
        self.rf = None
        # The profiler records host events of this thread: show the span there.
        if _profiler._is_profiler_enabled and torch._C._autograd._profiler_enabled():
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()  # its event starts here, past any first-call set-up
        st.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        st = _stack()
        st.pop()
        wall = end - self.start
        if st:
            st[-1].child_ns += wall
        _live().add((self.id, self.parent, self.root, self.name,
                     threading.current_thread().name, self.start, end, self.submit,
                     False), wall - self.child_ns)
        return False


def on() -> bool:
    """Whether spans and counters are being recorded."""
    return _gate._is_profiler_enabled


def span(name: str):
    """A context that records a span named `name` while recording is on
    (the span object, with its id and root, is what `with` gives), and
    does nothing otherwise (`with` gives None)."""
    if not _gate._is_profiler_enabled:
        return _NULL
    return _Span(name)


def traced(name: str):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _gate._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def carry(fn):
    """fn itself while recording is off; on, a wrapper that runs fn with
    the calling thread's innermost span as the parent of the spans fn
    opens (on whatever thread runs it), and the time of this call as their
    submit time."""
    if not _gate._is_profiler_enabled:
        return fn
    st = _stack()
    if st:
        ctx = (st[-1].id, st[-1].root, time.time_ns())
    else:
        outer = getattr(_local, "ctx", None) or (None, None)
        ctx = (outer[0], outer[1], time.time_ns())

    def carried(*args, **kwargs):
        prev = getattr(_local, "ctx", None)
        _local.ctx = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _local.ctx = prev

    return carried


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while recording is on."""
    if not _gate._is_profiler_enabled:
        return
    rec = _live()
    with rec.lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter's value in the current record (0 where it never counted)."""
    rec = _record
    if rec is None:
        return 0
    with rec.lock:
        return rec.counters.get(name, 0)


def busy(start_ns: int, end_ns: int) -> None:
    """One interval the device was busy (a Runner's CUDA events, mapped
    onto this clock), while recording is on."""
    if not _gate._is_profiler_enabled:
        return
    rec = _live()
    with rec.lock:
        rec.busy.append((start_ns, end_ns))


def device_spans(thread: str, parent: int, root: int, stages) -> None:
    """Spans of the stages of one batch on the device, (name, start ns,
    end ns) each, under the batch's upload span `parent`."""
    rec = _live()
    for name, a, b in stages:
        rec.add((next(_ids), parent, root, name, thread, a, b, None, True), b - a)


@contextlib.contextmanager
def recording():
    """Record inside this block, with a fresh record, whether or not a
    profiler session runs. Does not nest."""
    global _gate
    if _gate is _Forced:
        raise RuntimeError("tracing.recording() is already active")
    _fresh()
    rec = _record
    _gate = _Forced
    try:
        yield
    finally:
        _gate = _profiler
        rec.sealed = True


# ---------------------------------------------------------------------------
# Reading the record.
# ---------------------------------------------------------------------------


def _merged(intervals) -> list[list[int]]:
    """The union of (start, end) intervals as sorted disjoint [start, end]."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersect(xs, ys) -> list[list[int]]:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys) -> list[list[int]]:
    """xs less ys, both sorted disjoint interval lists."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append([a, ys[k][0]])
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def _length(xs) -> int:
    return sum(b - a for a, b in xs)


def idle_partition(spans, busy_intervals, lo: int | None = None,
                   hi: int | None = None) -> dict:
    """Device idle between lo and hi (default: the first start and last
    end of `spans`), charged to IDLE_CLASSES. spans: (name, start ns, end
    ns) of host spans, on any thread; busy_intervals: (start ns, end ns)
    of device work. Idle is the complement of the busy intervals; each
    idle instant goes to the first class with a span open then, and what
    no class holds (no span, or only spans of other names) is untraced.
    Returns seconds: {"window_s", "idle_s", "classes": {class: s},
    "untraced_s"}; the classes and the untraced part sum to idle_s."""
    spans = list(spans)
    if lo is None:
        lo = min((a for _, a, _ in spans), default=0)
    if hi is None:
        hi = max((b for _, _, b in spans), default=lo)
    window = [[lo, hi]] if hi > lo else []
    left = _subtract(window, _merged(busy_intervals))
    idle_ns = _length(left)
    classes = {}
    for cls, names in IDLE_CLASSES:
        held = _merged((a, b) for name, a, b in spans if name in names)
        classes[cls] = _length(_intersect(left, held)) / 1e9
        left = _subtract(left, held)
    return {"window_s": (hi - lo) / 1e9, "idle_s": idle_ns / 1e9, "classes": classes,
            "untraced_s": _length(left) / 1e9}


_FIELDS = ("id", "parent", "root", "name", "thread", "start_ns", "end_ns", "submit_ns",
           "device")


def snapshot() -> dict:
    """The current record as plain data: {"spans": [dict per span, fields
    _FIELDS], "dropped": spans the store had no room for, "totals": {name:
    {"count", "wall_s", "self_s"}} (self: wall less the same thread's child
    spans), "counters": {name: n}, "busy": [(start ns, end ns)], "idle":
    idle_partition over the host spans}. Taken while nothing records, it
    is kept: later snapshots return it until another record starts."""
    rec = _record
    if rec is None:
        return {"spans": [], "dropped": 0, "totals": {}, "counters": {}, "busy": [],
                "idle": idle_partition([], [])}
    if not _gate._is_profiler_enabled:
        rec.sealed = True
    if rec.sealed and rec.snap is not None:
        return rec.snap
    with rec.lock:
        spans = list(rec.spans)
        out = {
            "dropped": rec.dropped,
            "totals": {k: {"count": c, "wall_s": w / 1e9, "self_s": s / 1e9}
                       for k, (c, w, s) in rec.totals.items()},
            "counters": dict(rec.counters),
            "busy": list(rec.busy),
        }
    out["spans"] = [dict(zip(_FIELDS, s)) for s in spans]
    out["idle"] = idle_partition([(s[3], s[5], s[6]) for s in spans if not s[8]],
                                 out["busy"])
    if rec.sealed:
        rec.snap = out
    return out
