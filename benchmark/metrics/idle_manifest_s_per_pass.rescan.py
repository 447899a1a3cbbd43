"""idle_manifest_s_per_pass.rescan: device idle charged to the manifest
(`manifest.lookup`, `manifest.journal`, `manifest.compact` spans, with no
upload, prep or walk span open) by the program's idle partition, seconds
per pass. None where the program records no spans."""


def read(rec):
    try:
        from mp3rgain_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    snap = tracing.snapshot()
    if not snap["spans"] or not rec.get("passes"):
        return None
    return snap["idle"]["classes"]["manifest"] / len(rec["passes"])
