"""Find a cell's parts by name: the workload in BENCHMARK.json, its
configuration, its traffic mix and its per-layer metrics' readers."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def load_limits(workload: str) -> dict:
    """The cell's compared numbers, each {"limit", and the readings it was
    set from}."""
    return _json(BENCH_DIR / "limits" / f"{workload}.json")


def metrics_for(bench: dict, workload: str, kind: str) -> list:
    """The entries of bench[kind] ("end_to_end" or "per_layer") that this
    workload reports: those without a "workloads" list, and those whose
    list names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_metric(name: str):
    """metrics/<name>.py as a module; its read(ctx) returns the metric's
    value, or None where the traced window holds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
