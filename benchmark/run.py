"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (BENCHMARK.json's workloads) names a
configuration (configs/<config>.json: the library, which
formats/<module>.py writes) and a traffic mix (mixes/<traffic>.json: its
parameters and the drivers/<driver>.py that drives the window); its
metrics are read by metrics/<metric>.py. In order: the program's kernels build or load (into
the checkout), the library is written from the seed under TMPDIR, the
cell's shapes are warmed, the window runs for --seconds (under
torch.profiler with --trace 1), then the plain reference checks a seeded
sample of the answers. Exits non-zero with no result where there is no
CUDA device, fewer than the cell asks for, or where JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)  # the program under test: the checkout's package

FORBIDDEN = ("jax", "jaxlib", "flax", "mp3rgain_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = _T0, config: dict | None = None) -> dict:
    """One run of a cell: the result's object, with the numbers compared
    under "check" (last)."""
    import torch

    from harness import check, library, registry, roofline
    from harness.trace import profiled, reduce

    config = config or registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    on_card = device != "cpu"
    workdir = tempfile.mkdtemp(prefix="mp3rgain-bench-")
    try:
        releases = library.write(library.plan(config, seed), os.path.join(workdir, "library"),
                                 config)
        os.sync()  # the library's writeback ends here, not inside the window
        drv = registry.driver(mix["driver"])(mix, releases, device, workdir, seed)
        drv.warm()
        if on_card:
            torch.cuda.synchronize()
        rec = drv.records
        rec["setup_s"] = time.monotonic() - t0
        with profiled(trace) as prof:
            answers = drv.run(seconds)
            if on_card:
                torch.cuda.synchronize()
        peak_mem = max(torch.cuda.max_memory_allocated(i)
                       for i in range(torch.cuda.device_count())) if on_card else 0
        if prof is not None:
            rec.update(reduce(prof))
            del prof
        found = forbidden_modules()
        if found:
            raise SystemExit(f"loaded after the window: {', '.join(found)}")
        del drv
        if on_card:
            torch.cuda.empty_cache()
        rels = check.sample(releases, config, seed)
        ref_tracks, ref_albums = check.reference_answers(rels)
        numbers = check.compare(answers, ref_tracks, ref_albums, config["check"]["limits"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    parts = sorted(rec.get("parts") or [])
    if parts:
        print(f"window: {len(parts)} parts, wall s min {parts[0]!r} median "
              f"{parts[len(parts) // 2]!r} max {parts[-1]!r}", file=sys.stderr)
    metrics = {}
    for m in registry.metrics_of(spec, cell["name"], trace):
        value = registry.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak_mem}
    if trace:
        dev["busy_s"] = rec.get("busy_s", 0.0) / max(1, cell["chips"])
        dev["window_s"] = rec["window_s"]
    if on_card:
        dev["card"] = roofline.power_limit()
    out = {"correct": rec["failed"] == 0 and check.passed(numbers),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if trace and "breakdown" in rec:
        out["breakdown"] = rec["breakdown"]
    out["check"] = numbers
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import registry

    spec = registry.load_spec(ROOT)
    cell = registry.cell(spec, args.workload)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES",
                          ",".join(str(i) for i in range(cell["chips"])))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace))
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
