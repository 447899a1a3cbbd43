"""The harness is driven by data: cells, configs, mixes and metric readers
are found by name; BENCHMARK.json keeps to the contract's character rules
and its per-layer metrics to their cells; without a card a run prints no
result. Run from the checkout's root: python -m pytest benchmark/tests -q"""

import json
import os
import re
import shutil
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

from harness import registry  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def spec():
    return registry.load_spec(ROOT)


def test_names_and_units_use_the_allowed_characters():
    s = spec()
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    names += [w["name"] for w in s["workloads"]] + [c["name"] for c in s["configs"]]
    names += [w["config"] for w in s["workloads"]] + [w["traffic"] for w in s["workloads"]]
    names += [k for c in s["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(m["name"] for m in s["end_to_end"] + s["per_layer"])) == \
        len(s["end_to_end"]) + len(s["per_layer"])
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in s["workloads"]] + [c["source"] for c in s["configs"]]
                 + [m["layer"] for m in s["per_layer"]] + s["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    assert len(json.dumps(s)) <= 64 * 1024


def test_every_per_layer_metric_moves_one_metric_its_cells_report():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    cells = {w["name"] for w in s["workloads"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert m["workloads"], m["name"]
        for c in m["workloads"]:
            assert c in cells, (m["name"], c)
            assert c in e2e[m["moves"]].get("workloads", [c]), (m["name"], c)
            assert m in registry.metrics_of(s, c, trace=True)


def test_every_cell_has_its_files_and_metrics():
    s = spec()
    for w in s["workloads"]:
        cfg = registry.config(w["config"])
        assert cfg["name"] == w["config"]
        assert callable(registry.driver(registry.mix(w["traffic"])["driver"]))
        for f in cfg["formats"].values():
            assert registry.format_module(f["module"]).EXTENSION
        e2e = registry.metrics_of(s, w["name"], trace=False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert registry.metrics_of(s, w["name"], trace=True)
        for m in e2e + registry.metrics_of(s, w["name"], trace=True):
            assert callable(registry.reader(m["name"]))
    for c in s["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


# A traffic shape, a format and metrics that no file of the benchmark knows:
# every track through replaygain.analyze_track, one at a time.
NEW_DRIVER = '''"""each_track: the library's tracks one at a time through
replaygain.analyze_track, round after round until the window has passed."""
import time

from harness.driving import Driver as Base
from harness.driving import analysed, answer


class Driver(Base):
    def __init__(self, *a):
        super().__init__(*a)
        from mp3rgain_tpu_torch import replaygain

        self.rg = replaygain
        self.tracks = [t for r in self.releases for t in r.tracks][: self.mix["tracks"]]

    def warm(self):
        self.rg.analyze_track(self.tracks[0].path, device=self.device)

    def run(self, seconds):
        walls, answers = [], []
        start = time.monotonic()
        while not answers or time.monotonic() - start < seconds:
            for t in self.tracks:
                t0 = time.monotonic()
                got = answer(self.rg.analyze_track(t.path, device=self.device))
                walls.append(time.monotonic() - t0)
                answers.append({"tracks": {t.path: got}})
        self.records.update(window_s=time.monotonic() - start, walls=walls, parts=walls,
                            attempted=len(walls), failed=0,
                            analysed=analysed(self.tracks * (len(walls) // len(self.tracks))))
        return answers
'''

NEW_FORMAT = '''"""MP3 tracks at their clips' own level: no level edit."""
from harness import registry

mp3 = registry.format_module("mp3")
EXTENSION = mp3.EXTENSION
layout = mp3.layout
analyzer = mp3.analyzer


def write(path, lay, copies, step):
    return mp3.write(path, lay, copies, 0)
'''


def _tree_bytes(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, top)] = open(p, "rb").read()
    return out


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_bytes(bench)
    s = spec()
    cfg = registry.config("mp3_library")
    cfg["name"] = "mp3_small"
    cfg["track_seconds"] = [1, 2]
    cfg["releases"] = [{"kind": "album", "tracks": 2, "count": 1, "format": "plain"}]
    cfg["formats"] = {"plain": {"module": "mp3_plain", "clips": {"test_stereo.mp3": 1.0}}}
    cfg["check"]["sample_tracks"] = 2
    (bench / "configs" / "mp3_small.json").write_text(json.dumps(cfg))
    (bench / "formats" / "mp3_plain.py").write_text(NEW_FORMAT)
    (bench / "drivers" / "each_track.py").write_text(NEW_DRIVER)
    (bench / "mixes" / "each_track.json").write_text(json.dumps({"driver": "each_track",
                                                                 "tracks": 2}))
    (bench / "metrics" / "track_p50_s.py").write_text(
        "def read(rec):\n    w = sorted(rec.get('walls') or [])\n"
        "    return w[len(w) // 2] if w else None\n")
    (bench / "metrics" / "tracks.each_track.py").write_text(
        "def read(rec):\n    return len(rec.get('walls') or []) or None\n")
    s["configs"].append({"name": "mp3_small", "source": "a test", "file":
                         "benchmark/configs/mp3_small.json", "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "mp3_small.each_track", "config": "mp3_small",
                           "traffic": "each_track", "chips": 1, "why": "a test"})
    s["end_to_end"].append({"name": "track_p50_s", "unit": "s", "better": "lower",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["mp3_small.each_track"]})
    s["per_layer"].append({"name": "tracks.each_track", "unit": "tracks", "better": "higher",
                           "source": "program_counter", "layer": "a test",
                           "moves": "track_p50_s", "workloads": ["mp3_small.each_track"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    code = (f"import json, sys\nsys.path.append({ROOT!r})\nsys.path.insert(0, 'benchmark')\n"
            "import run\nfrom harness import registry\n"
            "s = registry.load_spec()\ncell = registry.cell(s, 'mp3_small.each_track')\n"
            "out = [run.run_cell(s, cell, 2**31 + 9, 0.2, t, device='cpu') for t in (0, 1)]\n"
            "print(json.dumps([{k: o[k] for k in ('correct', 'metrics', 'check')} for o in out]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                             TMPDIR=str(tmp_path)))
    assert r.returncode == 0, r.stderr[-3000:]
    e2e, layer = json.loads(r.stdout.strip().splitlines()[-1])
    assert e2e["correct"] and layer["correct"], (e2e["check"], layer["check"])
    assert set(e2e["metrics"]) == {"track_p50_s", "setup_s"}
    assert set(layer["metrics"]) == {"tracks.each_track"}
    assert e2e["check"]["missing"]["value"] == 0
    after = _tree_bytes(bench)
    assert {p: after[p] for p in before} == before


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mp3_library.rescan",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "metrics" not in r.stdout and "correct" not in r.stdout


def test_a_checkout_of_only_the_benchmark_exits_non_zero(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mp3_library.rescan",
                        "--seed", "7", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=dict(os.environ, TMPDIR=str(tmp_path)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
