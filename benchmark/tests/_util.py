"""Shared helpers of the harness's tests: run the benchmark's command on
the CPU at a small scale and read its result line."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
SCALE = "0.02"  # 120,024 lineitem rows


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def run_command(args, cwd=REPO, timeout=300):
    """(exit code, result line or None, stderr) of ``benchmark/run.py``."""
    p = subprocess.run([sys.executable, str(Path(cwd) / "benchmark" / "run.py"), *args],
                       cwd=cwd, capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr
