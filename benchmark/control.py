#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference, computed in
float32 (the precision below the configuration's float64 sums), put in
the program's place. It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]

For every parameter set of the cell's mix (all that a window can send),
the float32 answer is held to the float64 reference by the benchmark's
own comparison and limits; the numbers go out as one JSON line a seed.
The program is not run: the control stands in its place. The benchmark's
runs do not run it. ``--rehearse-on-cpu SCALE`` runs it on the CPU at
SCALE times the configuration's rows, for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from hsbench import check, spec, traffic  # noqa: E402
from hsbench.tpch import int_bounds, make_tables  # noqa: E402


def control_numbers(bench: dict, cell_name: str, seed: int, scale: float, device: str) -> dict:
    import torch

    from reference.groupby import Table, group_by

    cell = spec.workload(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    rows = spec.rows(cfg, scale)
    tables = make_tables(seed, rows)
    stats = int_bounds(tables)
    mix = traffic.Mix(spec.traffic(cell["traffic"]), seed, stats)
    used = sorted({c for s in mix.shapes for c in s.columns()})
    table = Table({c: tables[mix.shapes[0].table][c] for c in used}, device)
    records, memo = [], {}
    for si, shape in enumerate(mix.shapes):
        for pi, pset in enumerate(shape.psets):
            low = group_by(table, pset, shape.group_by, shape.aggs, dtype=torch.float32)
            memo[(si, pi)] = (group_by(table, pset, shape.group_by, shape.aggs), shape.group_by)
            records.append(((si, pi), low, check.summary(low)))
    verdict = check.judge(records, 0, memo.__getitem__, cfg["check_limits"])
    return {"cell": cell_name, "seed": seed, "rows": rows, "correct": verdict["correct"],
            "numbers": verdict["numbers"], "limits": verdict["limits"],
            "answers": verdict["answers"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--rehearse-on-cpu", type=float, default=None, metavar="SCALE",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    rehearse = args.rehearse_on_cpu is not None
    if not rehearse and not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    for seed in args.seed:
        t0 = time.perf_counter()
        out = control_numbers(bench, args.workload, seed, args.rehearse_on_cpu or 1.0,
                              "cpu" if rehearse else "cuda")
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
