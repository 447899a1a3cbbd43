"""release_p95_s: 95th percentile (nearest rank) over every release finished
in the window of one analyze_album call's time, by the host clock."""

from harness.stats import percentile


def read(rec):
    walls = [r["wall_s"] for r in rec.get("releases") or [] if r["wall_s"] == r["wall_s"]]
    return percentile(walls, 0.95) if walls else None
