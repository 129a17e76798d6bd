"""Finds a cell's pieces by the names in ``BENCHMARK.json``: the
configuration's file, the traffic mix's data file and each metric's
reader, so that a new cell, mix or metric is a new file and a new entry,
never an edit."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


def load_benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, repo: Path = REPO) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((repo / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def rows(cfg: dict, scale: float = 1.0) -> dict:
    """The configuration's row counts (``scale`` times them, for the
    harness's CPU rehearsals)."""
    out = {t: int(n) for t, n in cfg["rows"].items()}
    if scale != 1.0:
        out = {t: max(1000, int(round(n * scale))) for t, n in out.items()}
    return out


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: end-to-end ones with
    tracing off, per-layer ones with it on; an entry with a
    ``workloads`` key only in the cells it lists."""
    pool = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in pool if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value, or None
    where the run gave it nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hsbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
