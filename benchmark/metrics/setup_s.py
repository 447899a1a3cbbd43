"""setup_s: process start to the first timed operation (imports, CUDA context,
kernel build or load, writing the library, warm-up), by the host clock."""


def read(rec):
    return rec.get("setup_s")
