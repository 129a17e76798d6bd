"""Every cell of BENCHMARK.json through the one command, on the CPU at a
small scale: the result line's shape, its metrics and ``correct``."""

from __future__ import annotations

import pytest

from _util import SCALE, bench, run_command

CELLS = [w["name"] for w in bench()["workloads"]]
DEVICE_ONLY = {m["name"] for m in bench()["per_layer"] if m["source"] == "device_trace"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal(cell, trace):
    b = bench()
    rc, res, err = run_command(["--workload", cell, "--seed", "3000000019", "--seconds", "2",
                                "--trace", str(trace), "--rehearse-on-cpu", SCALE])
    assert rc == 0, err[-3000:]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    pool = b["per_layer"] if trace else b["end_to_end"]
    want = {m["name"] for m in pool if cell in m.get("workloads", [cell])}
    if trace:
        want -= DEVICE_ONLY  # no device trace on the CPU
    assert set(res["metrics"]) == want
    units = {m["name"]: m["unit"] for m in pool}
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and m["value"] >= 0
    assert res["device"]["platform"] == "cpu"
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


def test_no_card_no_result():
    rc, res, err = run_command(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                                "--trace", "0"])
    assert rc != 0 and res is None
    assert "CUDA card" in err


def test_paths_alone_are_not_enough(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's paths
    cannot run: the program is not there."""
    import shutil

    from _util import BENCH_DIR, REPO

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    rc, res, _err = run_command(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                                 "--trace", "0", "--rehearse-on-cpu", SCALE], cwd=tmp_path)
    assert rc != 0 and res is None
