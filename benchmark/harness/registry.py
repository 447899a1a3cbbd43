"""Finds a cell's pieces by name: BENCHMARK.json at the checkout's root, and
under the benchmark's folder configs/<config>.json (the library),
mixes/<traffic>.json (the traffic's parameters), drivers/<driver>.py (the
code that drives a window, named by the mix), formats/<module>.py (a
codec's writer and reference, named by the config) and metrics/<metric>.py
(a metric's reader). Adding any of them is adding its file and its entry;
nothing here or elsewhere names one."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, bench_dir: str) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json("configs", name, bench_dir)


def mix(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json("mixes", name, bench_dir)


_MODULES: dict = {}


def _module(kind: str, name: str, bench_dir: str):
    """<bench_dir>/<kind>/<name>.py, loaded once."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The read(records) function of metrics/<name>.py."""
    return _module("metrics", name, bench_dir).read


def driver(name: str, bench_dir: str = BENCH_DIR):
    """The Driver class of drivers/<name>.py."""
    return _module("drivers", name, bench_dir).Driver


def format_module(name: str, bench_dir: str = BENCH_DIR):
    """formats/<name>.py: a codec's writer and reference."""
    return _module("formats", name, bench_dir)


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off: those that list the cell,
    and those without a list) or per-layer ones (trace on: those that list
    the cell)."""
    if not trace:
        return [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    return [m for m in spec["per_layer"] if cell_name in m["workloads"]]
