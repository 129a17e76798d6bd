"""Metrics exporter CLI — render and validate the telemetry registry.

Usage:
    python -m hyperspace_tpu_torch.tools.metrics                # Prometheus text (live)
    python -m hyperspace_tpu_torch.tools.metrics --format jsonl # JSON-lines
    python -m hyperspace_tpu_torch.tools.metrics --demo         # synthetic registry
    python -m hyperspace_tpu_torch.tools.metrics --check        # validate renderings
    python -m hyperspace_tpu_torch.tools.metrics --write DIR    # rotated on-disk snapshot

``--check`` builds a synthetic registry exercising every metric type —
counter, gauge, timer, time- and byte-bucket histograms — renders it,
and validates the Prometheus text the way a scraper would
(telemetry/export.py ``check_prometheus``: name grammar, single
HELP/TYPE per family, label escaping, monotone cumulative buckets). The
live process registry is validated too. Exit 0 clean, 1 on problems.

Counterpart of the reference's ``scripts/metrics.py``: the demo registry
holds the same recordings, so both render the same text.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..telemetry import export as texport
from ..telemetry.metrics import Metrics, metrics


def _demo_registry() -> Metrics:
    """A synthetic registry covering every metric type and the naming
    grammar's edge shapes — what --check validates against."""
    reg = Metrics()
    reg.incr("serve.submitted", 7)
    reg.incr("scan.path.resident_device", 3)
    reg.gauge("build.stream.workers.ingest", 4)
    reg.gauge("serve.queue_depth", 12)
    reg.record_time("scan.total", 0.125)
    reg.record_time("scan.total", 0.5)
    reg.record_time("compile.pipeline_run", 0.01)
    for v in (0.0004, 0.003, 0.02, 0.4, 7.5):
        reg.observe("serve.latency_seconds", v)
    for v in (512, 4096, 1 << 20):
        reg.observe("scan.resident.d2h_bytes", v)
    return reg


def check_registry(reg: Metrics, label: str) -> list:
    """Problems with ``reg``'s renderings: the Prometheus text as a
    scraper validates it, and the JSONL parsed back line by line."""
    problems = [f"[{label}] {p}" for p in
                texport.check_prometheus(texport.render_prometheus(reg))]
    for i, line in enumerate(texport.render_jsonl(reg).splitlines(), start=1):
        try:
            json.loads(line)
        except ValueError as e:
            problems.append(f"[{label}] jsonl line {i}: {e}")
    return problems


def _check() -> int:
    problems = []
    for label, reg in (("demo", _demo_registry()), ("live", metrics)):
        problems += check_registry(reg, label)
    # label escaping is part of the contract even though the current
    # renderings carry no labels beyond histogram le= — validate the
    # escaper round-trips the hostile characters
    hostile = 'a"b\\c\nd'
    esc = texport.escape_label_value(hostile)
    sample = f'hyperspace_demo_labels{{tenant="{esc}"}} 1'
    for p in texport.check_prometheus(
        "# HELP hyperspace_demo_labels demo\n"
        "# TYPE hyperspace_demo_labels gauge\n" + sample + "\n"
    ):
        problems.append(f"[escape] {p}")
    if problems:
        for p in problems:
            print(p)
        print(f"metrics check: {len(problems)} problem(s)")
        return 1
    print("metrics check: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="metrics", description="telemetry registry exporter"
    )
    ap.add_argument(
        "--format", choices=("prom", "jsonl"), default="prom", dest="fmt"
    )
    ap.add_argument(
        "--demo",
        action="store_true",
        help="render a synthetic registry (a fresh process's live "
        "registry is empty)",
    )
    ap.add_argument(
        "--check",
        action="store_true",
        help="validate the Prometheus/JSONL renderings; exit 1 on problems",
    )
    ap.add_argument(
        "--write",
        metavar="DIR",
        help="append a rotated JSON-lines snapshot to DIR "
        "(telemetry/export.py export_to_dir)",
    )
    args = ap.parse_args(argv)
    if args.check:
        return _check()
    reg = _demo_registry() if args.demo else metrics
    if args.write:
        path = texport.export_to_dir(args.write, registry=reg)
        print(f"metrics: wrote {path}")
        return 0
    if args.fmt == "prom":
        sys.stdout.write(texport.render_prometheus(reg))
    else:
        sys.stdout.write(texport.render_jsonl(reg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
