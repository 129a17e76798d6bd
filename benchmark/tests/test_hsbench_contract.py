"""BENCHMARK.json against the rules the benchmark is held to, and the
pieces the harness finds by name."""

from __future__ import annotations

import json
import re
import sys

import numpy as np
import pytest

from _util import BENCH_DIR, REPO, bench

sys.path.insert(0, str(BENCH_DIR))

from hsbench import spec, traffic  # noqa: E402
from hsbench.tpch import int_bounds, make_tables  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the domains of every generated column, at a small scale
STATS = int_bounds(make_tables(1, {"orders": 3000, "lineitem": 12000, "part": 2000,
                                    "supplier": 100}))


def test_keys_and_names():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"]
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_metrics_and_readers():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert {"name", "unit", "better", "source", "layer", "moves"} <= set(m)
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", [])) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in cells:  # every cell reports setup_s, another end-to-end metric and a layer's
        assert len(spec.cell_metrics(b, c, False)) >= 2 and spec.cell_metrics(b, c, True)


def test_configs_and_cells():
    b = bench()
    for c in b["configs"]:
        cfg = spec.config(b, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/configs/")
        assert cfg["expect"]["tier"]  # run.py holds the residency to it
    used = set()
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
        spec.config(b, w["config"])
        assert spec.traffic(w["traffic"])["clients"] > 0
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH_DIR / "traffic").glob("*.json")))
def test_every_seed_sends_the_same_mix(name):
    mix_spec = spec.traffic(name)
    take = lambda mix, c: [next(it) for it in [mix.stream(c)] for _ in range(200)]
    a = traffic.Mix(mix_spec, 5, STATS)
    b = traffic.Mix(mix_spec, 2**31 + 11, STATS)
    assert take(a, 0) == take(traffic.Mix(mix_spec, 5, STATS), 0)
    assert take(a, 0) != take(b, 0) and take(a, 0) != take(a, 1)
    count = lambda seq: np.bincount([s for s, _p, _u in seq], minlength=len(a.shapes)).tolist()
    # every block holds each shape in its weight's proportion
    block = len(a._block)
    assert count(take(a, 0)[:block * 10]) == count(take(b, 3)[:block * 10])
    # a filter names an index's key, or the rule does not rewrite it to the index
    declared = bench()
    for s in a.shapes:
        keys = {k for c in declared["configs"]
                for ix in spec.config(declared, c["name"])["indexes"]
                if ix["table"] == s.table for k in ix["indexed"]}
        assert all(any(c in keys for c, _o, _v in p) for p in s.psets if p)


def test_traffic_values():
    mix = traffic.Mix(spec.traffic("agg_dashboard"), 7, STATS)
    q1 = next(s for s in mix.shapes if s.name == "q1_shape")
    ship = [v for p in q1.psets for c, o, v in p if c == "l_shipdate"]
    assert min(ship) >= traffic.day("1998-12-01") - 120 and max(ship) <= traffic.day("1998-12-01") - 60
    q17 = next(s for s in mix.shapes if s.name == "q17_inner")
    for p in q17.psets:
        lo = next(v for c, o, v in p if o == ">=")
        hi = next(v for c, o, v in p if o == "<")
        assert hi - lo == round((STATS["l_orderkey"][1]) / 3)
    json.dumps([s.psets for s in mix.shapes])  # plain numbers only


def test_lineitem_is_full_width():
    """Every column of TPC-H's lineitem at the spec's type and length
    (clause 4.2.3), read back through the port's avro reader unchanged."""
    from pathlib import Path

    from hsbench import avro
    from hsbench.tpch import CURRENT_DATE, INSTRUCTIONS, MODES, SCHEMAS

    rows = {"orders": 3000, "lineitem": 12000, "part": 2000, "supplier": 100}
    li = make_tables(7, rows)["lineitem"]
    assert list(li) == list(SCHEMAS["lineitem"]) and len(li) == 16
    assert all(len(a) == rows["lineitem"] for a in li.values())
    lens = np.char.str_len(li["l_comment"])
    assert lens.min() >= 10 and lens.max() <= 43
    assert set(li["l_shipinstruct"].tolist()) == {s.encode() for s in INSTRUCTIONS}
    assert set(li["l_shipmode"].tolist()) == {s.encode() for s in MODES}
    assert li["l_suppkey"].min() >= 1 and li["l_suppkey"].max() <= rows["supplier"]
    assert (li["l_linenumber"] >= 1).all() and (li["l_linenumber"] <= 7).all()
    gap = li["l_receiptdate"] - li["l_shipdate"]
    assert gap.min() >= 1 and gap.max() <= 30
    late = li["l_receiptdate"] > CURRENT_DATE
    assert (li["l_returnflag"][late] == b"N").all() and (li["l_returnflag"][~late] != b"N").all()
    assert set(np.round(li["l_discount"] * 100).astype(int).tolist()) <= set(range(11))

    import tempfile

    from hyperspace_tpu_torch.storage.avro_io import read_avro

    with tempfile.TemporaryDirectory() as d:
        avro.write_dir(Path(d), li, SCHEMAS["lineitem"], 2)
        back = read_avro(sorted(Path(d).glob("*.avro")))
    for name, want in li.items():
        got = back.columns[name].to_values()
        if want.dtype.kind == "S":
            got = np.array([g.encode() if isinstance(g, str) else bytes(g) for g in got])
            assert np.array_equal(got, want), name
        else:
            assert np.array_equal(np.asarray(got).astype(want.dtype), want), name
