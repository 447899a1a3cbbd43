"""release_p50_s: median over every release finished in the window of one
analyze_album call's time, call to return, by the host clock."""

from harness.stats import percentile


def read(rec):
    walls = [r["wall_s"] for r in rec.get("releases") or [] if r["wall_s"] == r["wall_s"]]
    return percentile(walls, 0.50) if walls else None
