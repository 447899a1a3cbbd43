"""The control of the check: the plain reference put in the program's place,
computed one precision below the configuration's float32-with-TF32-off:
float32 with TF32 matmuls (the IMDCT and polyphase products on a CUDA
device), a float32 filter and windows. For each seed it writes the cell's
library, draws the check's sample, and prints the numbers the check
compares for the control's answers against the float64 reference's. The
check has to find the control not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The benchmark's runs never run it; it sets the upper reading of each limit
(PERF.md). Prints one JSON line per seed, then one with the smallest
reading of each number over the seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)


def control_numbers(config: dict, seed: int, device: str) -> dict:
    """The check's numbers for the control's answers on one seed."""
    import torch

    from harness import check, library

    workdir = tempfile.mkdtemp(prefix="mp3rgain-control-")
    try:
        releases = library.write(library.plan(config, seed), os.path.join(workdir, "library"),
                                 config)
        rels = check.sample(releases, config, seed)
        ref_tracks, ref_albums = check.reference_answers(rels)
        if device != "cpu":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        ctl_tracks, ctl_albums = check.reference_answers(rels, torch.float32, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    answers = [{"tracks": ctl_tracks, "albums": ctl_albums}]
    return check.compare(answers, ref_tracks, ref_albums, config["check"]["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from harness import check, registry

    spec = registry.load_spec()
    config = registry.config(registry.cell(spec, args.workload)["config"])
    least = {}
    for seed in args.seeds:
        nums = control_numbers(config, seed, args.device)
        print(json.dumps({"seed": seed, "correct": check.passed(nums), "check": nums}))
        sys.stdout.flush()
        for k, v in nums.items():
            least[k] = min(least.get(k, v["value"]), v["value"])
    print(json.dumps({"least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
