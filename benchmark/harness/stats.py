"""Small statistics the metric readers share."""

from __future__ import annotations

import math

from .trace import merged


def percentile(values, q: float) -> float:
    """Nearest rank: the smallest value with at least a share q of the
    values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def idle_pct(rec) -> float | None:
    """100 x (1 - union of the window's device-busy intervals / its wall)."""
    busy = rec.get("busy_ms")
    if not busy or not rec.get("window_s"):
        return None
    busy_ms = sum(b - a for a, b in merged(busy))
    return 100.0 * (1.0 - busy_ms / 1000.0 / rec["window_s"])
