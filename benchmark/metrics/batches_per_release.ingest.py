"""batches_per_release.ingest: the Runner's timings entries (one per batch)
added per release, the mean over the releases finished in the window."""


def read(rec):
    rel = rec.get("releases")
    if not rel or not rec.get("timings"):
        return None
    return sum(r["batches"] for r in rel) / len(rel)
