"""The plain reference against answers worked out by hand, and the
comparison's verdicts on small tables."""

from __future__ import annotations

import sys

import numpy as np
import torch

from _util import BENCH_DIR

sys.path.insert(0, str(BENCH_DIR))

from hsbench import check  # noqa: E402
from reference.groupby import Table, group_by  # noqa: E402

COLS = {
    "k": np.array([3, 1, 3, 2, 1, 3, 9], dtype=np.int64),
    "d": np.array([10, 20, 30, 40, 50, 60, 70], dtype=np.int32),
    "p": np.array([1.5, 2.0, 2.5, 4.0, 0.25, 1.0, 8.0]),
}
AGGS = (("sum", "p"), ("avg", "p"), ("min", "d"), ("max", "d"), ("count", None))


def test_group_by_by_hand():
    # d < 70 drops the row of k 9; groups 1, 2, 3
    out = group_by(Table(COLS), [("d", "<", 70)], "k", AGGS)
    assert out["k"].tolist() == [1, 2, 3]
    assert out["count"].tolist() == [2, 1, 3]
    assert out["sum_p"].tolist() == [2.25, 4.0, 5.0]
    assert np.allclose(out["avg_p"], [1.125, 4.0, 5.0 / 3])
    assert out["min_d"].tolist() == [20, 40, 10]
    assert out["max_d"].tolist() == [50, 40, 60]


def test_blocks_do_not_change_the_answer():
    a = group_by(Table(COLS), [("k", ">=", 2)], "k", AGGS)
    b = group_by(Table(COLS), [("k", ">=", 2)], "k", AGGS, block_rows=2)
    assert all(np.array_equal(a[c], b[c]) for c in a)


def test_integer_average_and_empty_filter():
    out = group_by(Table(COLS), [("d", ">", 100)], "k", (("avg", "d"), ("count", None)))
    assert len(out["k"]) == 0 and len(out["count"]) == 0
    out = group_by(Table(COLS), [], "k", (("avg", "d"), ("count", None)))
    assert out["avg_d"].tolist() == [35.0, 40.0, 100.0 / 3, 70.0]


def test_float32_control_departs():
    rng = np.random.default_rng(0)
    cols = {"k": rng.integers(0, 4, 200_000), "p": rng.uniform(900, 2100, 200_000)}
    want = group_by(Table(cols), [], "k", (("sum", "p"), ("count", None)))
    low = group_by(Table(cols), [], "k", (("sum", "p"), ("count", None)), dtype=torch.float32)
    ok, gap = check.compare(low, want, "k")
    assert ok and gap > 1e-7


def test_compare_verdicts():
    want = group_by(Table(COLS), [], "k", AGGS)
    got = {c: v.copy() for c, v in want.items()}
    order = np.argsort(-got["k"])  # the program's order need not be the key's
    got = {c: v[order] for c, v in got.items()}
    assert check.compare(got, want, "k") == (True, 0.0)
    got["count"][0] += 1
    assert check.compare(got, want, "k")[0] is False
    got["count"][0] -= 1
    got["sum_p"][1] *= 1 + 1e-6
    ok, gap = check.compare(got, want, "k")
    assert ok and 5e-7 < gap < 2e-6
    del got["min_d"]
    assert check.compare(got, want, "k") == (False, 0.0)
