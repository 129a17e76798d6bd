"""The comparison has to catch a broken timed path, and its control (the
reference in float32) has to come out as not correct.

The faults are planted in the program under a run on the CPU: half of the
rows left out of the device aggregate, and one answer altered where the
group table is made. The cells run on one card, so there is no exchange
between chips to leave out, and they hold no state that a step could
leave unchanged."""

from __future__ import annotations

import importlib.util
import json

import pytest

from _util import BENCH_DIR, SCALE, bench

CELLS = [w["name"] for w in bench()["workloads"]]


def _main(path):
    spec = importlib.util.spec_from_file_location(f"hsbench_test_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _run(capsys, cell):
    rc = _main(BENCH_DIR / "run.py")(["--workload", cell, "--seed", "2900000001", "--seconds",
                                      "2", "--trace", "0", "--rehearse-on-cpu", SCALE])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _half_rows(orig):
    def core(plan, mask, gvals, flats):
        mask = mask.clone()
        mask[mask.numel() // 2:] = False
        return orig(plan, mask, gvals, flats)
    return core


def _altered(orig):
    def finish(table, plan, group_by, aggs, outs):
        batch = orig(table, plan, group_by, aggs, outs)
        for name in batch.column_names:
            if name.startswith("sum_"):
                batch.columns[name].data[0] *= 1.0 + 1e-6
        return batch
    return finish


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half_rows", "altered_answer"])
def test_fault_is_caught(cell, fault, capsys, monkeypatch):
    from hyperspace_tpu_torch.exec import scan_agg

    if fault == "half_rows":
        monkeypatch.setattr(scan_agg, "core_scan_agg", _half_rows(scan_agg.core_scan_agg))
    else:
        monkeypatch.setattr(scan_agg, "finish_scan_agg", _altered(scan_agg.finish_scan_agg))
    res = _run(capsys, cell)
    assert res["correct"] is False
    bad = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    # half of the rows: the counts differ (and the sums with them); the
    # altered sum: only its float gap
    assert ("mismatch" in bad) if fault == "half_rows" else (bad == {"float_rel_err"})


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys):
    assert _run(capsys, cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, capsys):
    rc = _main(BENCH_DIR / "control.py")(["--workload", cell, "--seed", "11", "--seed",
                                          "3000000005", "--rehearse-on-cpu", SCALE])
    assert rc == 0
    for line in capsys.readouterr().out.strip().splitlines():
        out = json.loads(line)
        assert out["correct"] is False
        assert out["numbers"]["float_rel_err"] > 100 * out["limits"]["float_rel_err"]
        assert out["numbers"]["mismatch"] == 0  # only the float sums fall


@pytest.mark.gpu
def test_control_fails_on_the_card_at_the_cells_size(capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    rc = _main(BENCH_DIR / "control.py")(["--workload", CELLS[0], "--seed", "101"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"] is False
