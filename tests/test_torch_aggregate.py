"""Parity of the port's aggregates with the JAX package on the CPU.

``hash_aggregate``, ``aggregate_join_ranges`` (the aggregate-over-join
fusion on the join's match ranges), ``bucketed_join_ranges``, the
executor's aggregate arms, ``group_by``/``GroupedData``, and the rules and
explain over an ``Aggregate``. The same numpy input, made from a seed,
goes through both packages; sessions of both serve one index tree. Mirrors
test_aggregate.py (against the JAX package instead of pandas),
test_join_aggregate.py and test_fuzz_parity.py's aggregate fuzz, and adds
the group order, a run without pandas, int64 sums past 2^53 and a hybrid
aggregate. Tolerance, the oracle's (test_join_aggregate.py): group sets,
group order and integer columns exact; float columns ``rtol=1e-9`` with
``equal_nan``.
"""

import sys

import numpy as np
import pytest
import torch

import hyperspace_tpu as hs_jax
from hyperspace_tpu.exec import aggregate as jagg
from hyperspace_tpu.exec import joins as jjoins
from hyperspace_tpu.ops.hashing import bucket_ids_host, key_repr
from hyperspace_tpu.plan import aggregates as jspecs
from hyperspace_tpu.storage import parquet_io as jax_parquet
from hyperspace_tpu.storage.columnar import Column as JaxColumn
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch
from hyperspace_tpu.telemetry.metrics import metrics as jax_metrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.exec import aggregate as tagg
from hyperspace_tpu_torch.exec import joins as tjoins
from hyperspace_tpu_torch.plan import aggregates as tspecs
from hyperspace_tpu_torch.plan import ir as torch_ir
from hyperspace_tpu_torch.storage.columnar import Column as TorchColumn
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TorchBatch
from hyperspace_tpu_torch.telemetry.metrics import metrics as torch_metrics

from tests.test_torch_hybrid import Tree, _tree

PKGS = {"jax": hs_jax, "torch": hs_torch}
SPECS = {"jax": jspecs, "torch": tspecs}
AGG = {"jax": jagg, "torch": tagg}
METRICS = {"jax": jax_metrics, "torch": torch_metrics}
PLAIN = {"hyperspace.index.hybridscan.enabled": False,
         "hyperspace.index.lineage.enabled": False}


def to_torch(batch: JaxBatch) -> TorchBatch:
    return TorchBatch({n: TorchColumn(c.dtype_str, c.data, c.vocab)
                       for n, c in batch.columns.items()})


def assert_same(got, exp, ordered=True, keys=None):
    """Column names and dtypes equal; rows in the same order (or sorted by
    ``keys``); floats to rtol 1e-9 with NaN equal to NaN, the rest exact."""
    assert got is not None and exp is not None
    assert got.column_names == exp.column_names
    assert got.num_rows == exp.num_rows
    cols = {}
    for side, b in (("got", got), ("exp", exp)):
        vals = {n: b.columns[n].to_values() for n in b.column_names}
        if not ordered:
            order = sorted(range(b.num_rows),
                           key=lambda i: tuple(repr(vals[k][i]) for k in keys))
            vals = {n: v[order] for n, v in vals.items()}
        cols[side] = vals
    for n in exp.column_names:
        assert got.columns[n].dtype_str == exp.columns[n].dtype_str, n
        g, e = cols["got"][n], cols["exp"][n]
        if exp.columns[n].data.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), e.astype(np.float64),
                                       rtol=1e-9, equal_nan=True, err_msg=n)
        else:
            assert [repr(x) for x in g] == [repr(x) for x in e], n


def make_batch(n=1000, seed=0):
    """test_aggregate.make_batch's table."""
    rng = np.random.default_rng(seed)
    return JaxBatch({
        "k": JaxColumn.from_values(rng.integers(0, 20, n).astype(np.int64)),
        "s": JaxColumn.from_optional_values(
            [None if i % 13 == 0 else f"g{i % 5}" for i in range(n)]),
        "v": JaxColumn.from_values(rng.integers(-50, 50, n).astype(np.int64)),
        "f": JaxColumn.from_values(
            np.where(rng.random(n) < 0.1, np.nan, rng.normal(0, 10, n))),
    })


def both_hash(batch, keys, make_specs):
    """hash_aggregate of both packages on one batch: (port, reference)."""
    return (tagg.hash_aggregate(to_torch(batch), keys, make_specs(tspecs)),
            jagg.hash_aggregate(batch, keys, make_specs(jspecs)))


# ---------------------------------------------------------------------------
# test_aggregate.py's ten cases, the JAX package as the oracle
# ---------------------------------------------------------------------------
def test_int_key_all_fns():
    got, exp = both_hash(make_batch(), ["k"], lambda m: [
        m.agg_sum("v"), m.agg_count(), m.agg_count("f", "nn_f"), m.agg_min("v"),
        m.agg_max("v"), m.agg_avg("f")])
    assert_same(got, exp)
    assert got.num_rows == 20


def test_string_key_with_nulls():
    got, exp = both_hash(make_batch(), ["s"], lambda m: [m.agg_count(), m.agg_sum("v")])
    assert_same(got, exp)
    assert None in got.columns["s"].to_values()  # NULL keys form their own group


def test_multi_key_and_string_minmax():
    got, exp = both_hash(make_batch(), ["k", "s"],
                         lambda m: [m.agg_count(), m.agg_min("s", "min_s"),
                                    m.agg_max("s", "max_s")])
    assert_same(got, exp)
    keys, mins = got.columns["s"].to_values(), got.columns["min_s"].to_values()
    assert all(m == k for k, m in zip(keys, mins) if k is not None)


def test_global_aggregate_and_empty():
    b = make_batch(100)
    got, exp = both_hash(b, [], lambda m: [m.agg_count(), m.agg_sum("v")])
    assert_same(got, exp)
    assert got.num_rows == 1 and int(got.columns["count"].data[0]) == 100
    empty = b.take(np.array([], dtype=np.int64))
    for keys in (["k"], []):
        got, exp = both_hash(empty, keys, lambda m: [m.agg_count(), m.agg_avg("f")])
        assert_same(got, exp)
        assert got.num_rows == (0 if keys else 1)


def test_int_sum_exact_past_2_53():
    """hash_aggregate's int64 path, and the fusion's prefix arm (duplicate
    right matches) and its left-side sums, exact past float64's 2^53."""
    big = (1 << 53) + 1
    b = JaxBatch({"k": JaxColumn.from_values(np.array([1, 1, 2], dtype=np.int64)),
                  "v": JaxColumn.from_values(np.array([big, 1, 5], dtype=np.int64))})
    got, exp = both_hash(b, ["k"], lambda m: [m.agg_sum("v")])
    assert_same(got, exp)
    assert got.columns["sum_v"].data.tolist() == [big + 1, 5]  # float64: big
    left = JaxBatch({"lk": JaxColumn("int64", np.array([0, 0, 1, 2], dtype=np.int64)),
                     "g": JaxColumn("int64", np.array([7, 7, 8, 9], dtype=np.int64)),
                     "lv": JaxColumn("int64", np.array([big, 1, 3, 4], dtype=np.int64))})
    right = JaxBatch({"rk": JaxColumn("int64", np.array([0, 0, 1, 2, 2], dtype=np.int64)),
                      "rv": JaxColumn("int64", np.array([big, 2, big, 1, 1], dtype=np.int64))})
    lb, rb = split_by_bucket(left, ["lk"], 2), split_by_bucket(right, ["rk"], 2)
    aggs = lambda m: [m.agg_sum("rv", "s"), m.agg_sum("lv", "ls"), m.agg_count()]  # noqa: E731
    got = fused("torch", lb, rb, ["g"], aggs)
    assert_same(got, materialized("jax", lb, rb, ["g"], aggs), ordered=False, keys=["g"])
    sums = dict(zip(got.columns["g"].data.tolist(), got.columns["s"].data.tolist()))
    assert sums == {7: 2 * (big + 2), 8: big, 9: 2}
    lsums = dict(zip(got.columns["g"].data.tolist(), got.columns["ls"].data.tolist()))
    assert lsums == {7: 2 * (big + 1), 8: 3, 9: 8}


def test_duplicate_agg_output_rejected():
    for m in (jspecs, tspecs):
        with pytest.raises(Exception, match="Duplicate output"):
            m.validate_specs((m.agg_sum("v", "x"), m.agg_count(name="x")), ("k",))


def test_sum_over_string_rejected():
    with pytest.raises(HyperspaceException, match="sum over string"):
        tagg.hash_aggregate(to_torch(make_batch(10)), ["k"], [tspecs.agg_sum("s")])


@pytest.fixture
def src_tree(tmp_path):
    t = Tree(tmp_path, **PLAIN)
    t.write("a.avro", make_batch(500, 1))
    return t


def _collect_both(tree, make_query, enabled=False):
    out = {}
    for key, mod in PKGS.items():
        s = tree.session(key)
        (s.enable_hyperspace if enabled else s.disable_hyperspace)()
        out[key] = make_query(s, mod, SPECS[key]).collect()
    return out["torch"], out["jax"]


def test_dataframe_api_and_having(src_tree):
    def q(s, mod, m):
        agg = (s.read.avro(str(src_tree.src)).filter(mod.col("v") > 0)
               .group_by("k").agg(m.agg_sum("v", "total"), m.agg_count()))
        return agg.filter(mod.col("total") > 300)  # HAVING

    got, exp = _collect_both(src_tree, q)
    assert_same(got, exp)
    assert 0 < got.num_rows < 20 and (got.columns["total"].data > 300).all()
    got, exp = _collect_both(src_tree, lambda s, mod, m: s.read.avro(
        str(src_tree.src)).groupBy("K").count())
    assert_same(got, exp)
    assert got.column_names == ["k", "count"] and got.num_rows == 20


def test_aggregate_schema_and_unknown_columns(src_tree):
    s = src_tree.session("torch")
    df = s.read.avro(str(src_tree.src))
    agg = df.group_by("k").agg(hs_torch.agg_avg("v"), hs_torch.agg_min("f"))
    assert agg.columns() == ["k", "avg_v", "min_f"]
    assert agg.plan.output_schema() == {"k": "int64", "avg_v": "float64", "min_f": "float64"}
    with pytest.raises(HyperspaceException, match="Unknown group-by"):
        df.group_by("nope")
    with pytest.raises(HyperspaceException, match="Unknown aggregate column"):
        df.group_by("k").agg(hs_torch.agg_sum("nope"))
    with pytest.raises(HyperspaceException, match="at least one AggSpec"):
        df.group_by("k").agg()


# ---------------------------------------------------------------------------
# two indexed tables: the Q17 shape and the fused arm through the executor
# ---------------------------------------------------------------------------
_LI = {"okey": "int64", "pkey": "int64", "qty": "int64", "ship": "date32"}
_OD = {"o_okey": "int64", "price": "float64", "odate": "date32"}


def _li_rows(rng, n, n_orders):
    return JaxBatch.from_pydict({
        "okey": rng.integers(1, n_orders + 1, n).astype(np.int64),
        "pkey": rng.integers(1, 150, n).astype(np.int64),
        "qty": rng.integers(1, 51, n).astype(np.int64),
        "ship": rng.integers(8000, 10000, n).astype(np.int32),
    }, schema=_LI)


def _od_rows(rng, keys):
    return JaxBatch.from_pydict({
        "o_okey": keys.astype(np.int64),
        "price": np.round(rng.normal(100, 20, len(keys)), 2),
        "odate": rng.integers(8000, 10000, len(keys)).astype(np.int32),
    }, schema=_OD)


def create_pq(tree, pkg, name, indexed, included, table):
    s = tree.session(pkg)
    mod = PKGS[pkg]
    mod.Hyperspace(s).create_index(s.read.parquet(str(tree.root / table)),
                                   mod.IndexConfig(name, indexed, included))


def _q17_tables(tree, seed=11, n=3000, n_orders=600):
    """Parquet, which keeps ``date32`` in both packages' readers."""
    rng = np.random.default_rng(seed)
    jax_parquet.write_parquet(tree.root / "li" / "a.parquet", _li_rows(rng, n, n_orders))
    jax_parquet.write_parquet(tree.root / "orders" / "a.parquet",
                              _od_rows(rng, np.arange(1, n_orders + 1)))


@pytest.fixture(scope="module")
def q17_tree(tmp_path_factory):
    """li (okey, pkey, qty, ship) and orders (o_okey, price, odate), both
    indexed on the order key by the port."""
    t = Tree(tmp_path_factory.mktemp("q17"), **PLAIN)
    _q17_tables(t)
    create_pq(t, "torch", "li_i", ["okey"], ["pkey", "qty", "ship"], "li")
    create_pq(t, "torch", "or_i", ["o_okey"], ["price", "odate"], "orders")
    return t


def q17(s, mod, m, root):
    return (s.read.parquet(str(root / "li"))
            .join(s.read.parquet(str(root / "orders")), mod.col("okey") == mod.col("o_okey"))
            .group_by("pkey")
            .agg(m.agg_sum("price", "rev"), m.agg_avg("price", "avg_rev"), m.agg_count()))


def q1(s, mod, m, root):
    return (s.read.parquet(str(root / "li"))
            .filter((mod.col("okey") >= 100) & (mod.col("okey") < 400) & (mod.col("qty") < 24))
            .group_by("qty")
            .agg(m.agg_sum("okey"), m.agg_avg("okey"), m.agg_min("ship"), m.agg_max("ship"),
                 m.agg_count()))


def serve_both(tree, make_query, keys):
    """Each package serves the query with Hyperspace off and on: the on
    rows equal the off rows (sorted by ``keys``); the plan trees, explain
    text and on rows are equal between the packages. Returns the port's
    plan, rows and counters."""
    out = {}
    for key, mod in PKGS.items():
        s = tree.session(key)
        q = make_query(s, mod, SPECS[key], tree.root)
        s.disable_hyperspace()
        off = q.collect()
        s.enable_hyperspace()
        plan = q.optimized_plan()
        METRICS[key].reset()
        on = q.collect()
        assert_same(on, off, ordered=False, keys=keys)
        out[key] = (plan, q.explain(), on, METRICS[key].snapshot())
    assert _tree(out["torch"][0]) == _tree(out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    assert_same(out["torch"][2], out["jax"][2])
    return out["torch"][0], out["torch"][2], out["torch"][3]


def test_aggregate_over_indexed_join_fuses(q17_tree):
    """test_aggregate.py's Q17 case and test_join_aggregate.py's executor
    case: JoinIndexRule fires below the Aggregate, which stays on top, and
    the executor takes the fused arm."""
    plan, rows, counters = serve_both(q17_tree, q17, ["pkey"])
    assert isinstance(plan, torch_ir.Aggregate)
    assert len(plan.collect(lambda n: isinstance(n, torch_ir.IndexScan))) == 2
    # one integer group key over right-side values: the native
    # single-pass arm, as in the reference
    assert counters.get("aggregate.path.join_fused_native") == 1
    assert "aggregate.path.join_fused" not in counters
    # both index sides are key-sorted per bucket: the presorted route
    # (K2 over the flat-remapped codes; its plain version here), no argsort
    assert counters.get("join.path.presorted_merge_flat", 0) == 1
    assert counters.get("join.path.device_kernel", 0) == 0
    assert rows.num_rows > 100


def test_filtered_aggregate_explain_and_having(q17_tree):
    """A3's shape: FilterIndexRule below the Aggregate, all five
    functions (min/max over date32), then a HAVING filter on the count."""
    plan, rows, _ = serve_both(q17_tree, q1, ["qty"])
    assert isinstance(plan, torch_ir.Aggregate)
    assert plan.collect(lambda n: isinstance(n, torch_ir.IndexScan))
    assert rows.columns["min_ship"].dtype_str == "date32"

    def having(s, mod, m, root):
        return q1(s, mod, m, root).filter(mod.col("count") > 5)

    plan, rows, _ = serve_both(q17_tree, having, ["qty"])
    # pushdown never moves the HAVING filter below the Aggregate
    assert isinstance(plan, torch_ir.Filter) and isinstance(plan.child, torch_ir.Aggregate)
    assert (rows.columns["count"].data > 5).all() and rows.num_rows > 0


def test_global_aggregate_over_filter(q17_tree):
    """A4's shape: ``group_by()`` with no keys over the filtered index."""
    def q6(s, mod, m, root):
        return (s.read.parquet(str(root / "li")).filter(mod.col("qty") < 24).group_by()
                .agg(m.agg_sum("qty"), m.agg_count()))

    _, rows, _ = serve_both(q17_tree, q6, [])
    assert rows.num_rows == 1


def test_group_keys_spanning_both_sides_materialize(q17_tree):
    """A2's shape: group keys on both sides, so the orientation declines
    and the materialized join plus hash_aggregate serves."""
    def q3(s, mod, m, root):
        return (s.read.parquet(str(root / "li")).filter(mod.col("ship") > 8500)
                .join(s.read.parquet(str(root / "orders")).filter(mod.col("odate") < 9500),
                      mod.col("okey") == mod.col("o_okey"))
                .group_by("okey", "odate").agg(m.agg_sum("price", "revenue"), m.agg_count()))

    _, rows, counters = serve_both(q17_tree, q3, ["okey", "odate"])
    assert counters.get("aggregate.path.join_fused", 0) == 0
    assert rows.num_rows > 0


def test_right_side_group_key_orients(q17_tree):
    """Group keys all on the right side: the rule swaps the sides and the
    fused arm serves; min/max declines before any bucket I/O."""
    def q(s, mod, m, root):
        return (s.read.parquet(str(root / "li"))
                .join(s.read.parquet(str(root / "orders")), mod.col("okey") == mod.col("o_okey"))
                .group_by("odate").agg(m.agg_sum("qty"), m.agg_count("price", "n")))

    _, _, counters = serve_both(q17_tree, q, ["odate"])
    assert counters.get("aggregate.path.join_fused") == 1

    def qmax(s, mod, m, root):
        return (s.read.parquet(str(root / "li"))
                .join(s.read.parquet(str(root / "orders")), mod.col("okey") == mod.col("o_okey"))
                .group_by("pkey").agg(m.agg_max("price")))

    _, _, counters = serve_both(q17_tree, qmax, ["pkey"])
    assert counters.get("aggregate.path.join_fused", 0) == 0


def test_column_pruning_keeps_group_keys_and_inputs(q17_tree):
    """Pruning puts a Project under the Aggregate that keeps exactly the
    group keys and the aggregate inputs, in both packages."""
    for make, want in ((q17, ["pkey", "price"]), (q1, ["qty", "okey", "ship"])):
        trees = {}
        for key, mod in PKGS.items():
            s = q17_tree.session(key)
            s.enable_hyperspace()
            plan = make(s, mod, SPECS[key], q17_tree.root).optimized_plan()
            trees[key] = _tree(plan)
            assert type(plan.child).__name__ == "Project"
            assert list(plan.child.columns) == want == plan.input_columns()
        assert trees["torch"] == trees["jax"]


# ---------------------------------------------------------------------------
# test_join_aggregate.py: the fusion against materialize + hash_aggregate
# ---------------------------------------------------------------------------
def split_by_bucket(batch, keys, nb, sort_keys=False):
    b = bucket_ids_host([key_repr(batch.columns[k]) for k in keys], nb)
    out = {}
    for x in np.unique(b):
        part = batch.take(np.flatnonzero(b == x))
        if sort_keys:
            part = part.take(np.argsort(part.columns[keys[0]].data, kind="stable"))
        out[int(x)] = part
    return out


def _sides(pkg, lb, rb):
    if pkg == "jax":
        return lb, rb
    return ({b: to_torch(v) for b, v in lb.items()}, {b: to_torch(v) for b, v in rb.items()})


def fused(pkg, lb, rb, group_by, make_specs):
    lb, rb = _sides(pkg, lb, rb)
    if pkg == "jax":
        ranges = jjoins.bucketed_join_ranges(lb, rb, ["lk"], ["rk"])
    else:
        ranges = tjoins.bucketed_join_ranges(lb, rb, ["lk"], ["rk"], "cpu")
    assert ranges is not None
    return AGG[pkg].aggregate_join_ranges(*ranges[:2], group_by, make_specs(SPECS[pkg]),
                                          *ranges[2:])


def materialized(pkg, lb, rb, group_by, make_specs):
    lb, rb = _sides(pkg, lb, rb)
    if pkg == "jax":
        parts = jjoins.bucketed_join_pairs(lb, rb, ["lk"], ["rk"])
        joined = JaxBatch.concat(parts)
    else:
        parts = tjoins.bucketed_join_pairs(lb, rb, ["lk"], ["rk"], "cpu")
        joined = TorchBatch.concat(parts)
    return AGG[pkg].hash_aggregate(joined, group_by, make_specs(SPECS[pkg]))


@pytest.mark.parametrize("seed", range(8))
def test_fused_aggregate_parity_fuzz(seed):
    rng = np.random.default_rng(9000 + seed)
    n_l = int(rng.integers(200, 4000))
    n_r = int(rng.integers(50, 1500))
    nb = int(rng.choice([4, 8, 16]))
    key_dt = rng.choice(["int8", "int16", "int32", "int64"])
    val_dt = rng.choice(["int32", "int64", "float32", "float64"])
    unique_right = bool(rng.random() < 0.5)
    sort_buckets = bool(rng.random() < 0.5)
    key_hi = min(int(rng.integers(20, 120)), np.iinfo(np.dtype(key_dt)).max)
    key_lo = max(-key_hi, int(np.iinfo(np.dtype(key_dt)).min))
    if unique_right:
        rk = rng.permutation(np.arange(n_r * 3))[:n_r].astype(np.int64)
    else:
        rk = rng.integers(0, max(n_r // 2, 2), n_r).astype(np.int64)
    lk = rng.choice(rk, n_l).astype(np.int64)
    lk[rng.random(n_l) < 0.2] = -5  # some left rows match nothing
    gvals = rng.integers(key_lo, key_hi + 1, n_l).astype(np.dtype(key_dt))
    rvals = rng.normal(0, 100, n_r).astype(np.dtype(val_dt))
    if val_dt.startswith("float"):
        rvals[rng.random(n_r) < 0.15] = np.nan  # NULLs
    lvals = rng.integers(-50, 50, n_l).astype(np.int64)
    left = JaxBatch({"lk": JaxColumn("int64", lk), "g": JaxColumn(key_dt, gvals),
                     "lv": JaxColumn("int64", lvals)})
    right = JaxBatch({"rk": JaxColumn("int64", rk), "rv": JaxColumn(val_dt, rvals)})
    lb = split_by_bucket(left, ["lk"], nb, sort_keys=sort_buckets)
    rb = split_by_bucket(right, ["rk"], nb, sort_keys=sort_buckets)
    assert set(lb) & set(rb)
    dup_matches = int(fused_counts(lb, rb).max()) > 1
    aggs_r = lambda m: [m.agg_count(), m.agg_sum("rv", "s"), m.agg_avg("rv", "a"),  # noqa: E731
                        m.agg_count("rv", "c")]
    aggs_full = lambda m: aggs_r(m) + [m.agg_sum("lv", "ls")]  # noqa: E731
    for aggs in (aggs_r, aggs_full):
        exp = materialized("jax", lb, rb, ["g"], aggs)
        torch_metrics.reset()
        got = fused("torch", lb, rb, ["g"], aggs)
        # right-side values alone take the native arm, which sums floats
        # under duplicate matches too; a left value takes the generic arm
        native = aggs is aggs_r
        assert torch_metrics.get("aggregate.path.join_fused_native") == int(native)
        declines = val_dt.startswith("float") and dup_matches and not native
        assert (got is None) == declines, (seed, val_dt, dup_matches)
        if got is None:  # the executor's fallback: materialize + hash_aggregate
            got = materialized("torch", lb, rb, ["g"], aggs)
        assert_same(got, exp, ordered=False, keys=["g"])
        ref = fused("jax", lb, rb, ["g"], aggs)
        if ref is not None:
            assert_same(got, ref)  # and the reference's group order
        if native:  # one C++ over the same ranges: bit for bit
            assert all(got.columns[n].data.tobytes() == ref.columns[n].data.tobytes()
                       for n in ref.column_names)


def fused_counts(lb, rb):
    _l, _r, _lo, counts, _o = tjoins.bucketed_join_ranges(*_sides("torch", lb, rb),
                                                          ["lk"], ["rk"], "cpu")
    return counts


def test_fused_int8_key_spanning_sign_boundary():
    n_r = 64
    rk = np.arange(n_r, dtype=np.int64)
    lk = np.tile(rk, 8)
    g = np.tile(np.array([-128, -1, 0, 127], dtype=np.int8), len(lk) // 4)
    left = JaxBatch({"lk": JaxColumn("int64", lk), "g": JaxColumn("int8", g)})
    right = JaxBatch({"rk": JaxColumn("int64", rk),
                      "rv": JaxColumn("float64", np.linspace(0, 1, n_r))})
    lb = split_by_bucket(left, ["lk"], 4, sort_keys=True)
    rb = split_by_bucket(right, ["rk"], 4, sort_keys=True)
    aggs = lambda m: [m.agg_count(), m.agg_sum("rv", "s"), m.agg_avg("rv", "a")]  # noqa: E731
    got = fused("torch", lb, rb, ["g"], aggs)
    assert_same(got, fused("jax", lb, rb, ["g"], aggs))
    assert_same(got, materialized("jax", lb, rb, ["g"], aggs), ordered=False, keys=["g"])
    assert got.columns["g"].data.tolist() == [-128, -1, 0, 127]


@pytest.mark.parametrize("case", ["min", "max", "string_sum", "string_count"])
def test_fused_declines_minmax_and_string_values(case):
    rng = np.random.default_rng(3)
    rk = np.arange(40, dtype=np.int64)
    left = JaxBatch({"lk": JaxColumn("int64", rng.choice(rk, 200)),
                     "g": JaxColumn("int64", rng.integers(0, 5, 200))})
    right = JaxBatch({"rk": JaxColumn("int64", rk),
                      "rv": JaxColumn("float64", rng.normal(0, 1, 40)),
                      "rs": JaxColumn.from_values(rng.choice(["a", "b"], 40).astype(object))})
    lb, rb = split_by_bucket(left, ["lk"], 4), split_by_bucket(right, ["rk"], 4)
    make = {"min": lambda m: [m.agg_min("rv", "m")],
            "max": lambda m: [m.agg_max("rv", "m")],
            "string_sum": lambda m: [m.agg_count(), m.agg_count("rs", "n"), m.agg_max("rs")],
            "string_count": lambda m: [m.agg_count("rs", "n")]}[case]
    assert fused("torch", lb, rb, ["g"], make) is None
    assert fused("jax", lb, rb, ["g"], make) is None


def test_bucketed_join_ranges_match_the_reference():
    """Over key-sorted buckets both packages take the presorted route, so
    both ranges index the right rows directly (r_order None); either way
    they name the same right rows for every left row, over the same
    concatenated sides."""
    rng = np.random.default_rng(5)
    left = JaxBatch({"lk": JaxColumn("int64", rng.integers(0, 300, 2000))})
    right = JaxBatch({"rk": JaxColumn("int64", rng.integers(0, 300, 700))})
    lb = split_by_bucket(left, ["lk"], 8, sort_keys=True)
    rb = split_by_bucket(right, ["rk"], 8, sort_keys=True)
    torch_metrics.reset()
    t = tjoins.bucketed_join_ranges(*_sides("torch", lb, rb), ["lk"], ["rk"], "cpu")
    j = jjoins.bucketed_join_ranges(lb, rb, ["lk"], ["rk"])
    assert torch_metrics.timings()["join.bucketed_ranges"][1] == 1
    assert np.array_equal(t[0].columns["lk"].data, j[0].columns["lk"].data)
    assert np.array_equal(t[1].columns["rk"].data, j[1].columns["rk"].data)
    assert np.array_equal(t[3], j[3])
    assert t[4] is None and j[4] is None
    t_order = np.arange(t[1].num_rows) if t[4] is None else t[4]
    j_order = np.arange(j[1].num_rows) if j[4] is None else j[4]
    for i in range(len(t[2])):
        got = sorted(t_order[t[2][i]:t[2][i] + t[3][i]].tolist())
        assert got == sorted(j_order[j[2][i]:j[2][i] + j[3][i]].tolist())
    with pytest.raises(HyperspaceException, match="duplicate columns"):
        tjoins.bucketed_join_ranges(*_sides("torch", lb, lb), ["lk"], ["lk"], "cpu")
    assert tjoins.bucketed_join_ranges({0: to_torch(left)}, {1: to_torch(right)},
                                       ["lk"], ["rk"], "cpu") is None


# ---------------------------------------------------------------------------
# group order and no pandas
# ---------------------------------------------------------------------------
def _order_batch(kind, n=600, seed=4):
    rng = np.random.default_rng(seed)
    if kind == "wide_string":
        k = JaxColumn.from_optional_values(
            [None if i % 17 == 0 else f"w{x}" for i, x in enumerate(rng.integers(0, 10**6, n))])
    elif kind == "sparse_int":
        k = JaxColumn.from_values(rng.choice(
            np.array([10**12, -7, 3 * 10**15, 77, -(10**14)], dtype=np.int64), n))
    else:
        k = JaxColumn.from_values(rng.choice([np.nan, -0.0, 0.0, 1.5, -2.5, np.inf], n))
    return JaxBatch({"k": k, "v": JaxColumn.from_values(rng.integers(-9, 9, n))})


@pytest.mark.parametrize("kind", ["wide_string", "sparse_int", "float_nan_negzero"])
def test_group_order_matches_the_reference(kind):
    """Keys that are not bounded-range integers come out in order of first
    appearance, as the reference's pd.factorize(sort=False) numbers them;
    NaN is one group and -0.0 groups with 0.0."""
    b = _order_batch(kind)
    got, exp = both_hash(b, ["k"], lambda m: [m.agg_count(), m.agg_sum("v")])
    assert_same(got, exp)
    got2, exp2 = both_hash(b, ["k", "v"], lambda m: [m.agg_count()])
    assert_same(got2, exp2)
    if kind == "float_nan_negzero":
        keys = got.columns["k"].data
        assert got.num_rows == 5 and np.isnan(keys).sum() == 1


def test_no_pandas(monkeypatch):
    """The port's aggregate runs where pandas is not installed: a wide
    string key and a sparse int key through hash_aggregate and the fusion."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    for kind in ("wide_string", "sparse_int"):
        b = _order_batch(kind)
        got = tagg.hash_aggregate(to_torch(b), ["k"], [tspecs.agg_count(), tspecs.agg_avg("v")])
        monkeypatch.undo()
        assert_same(got, jagg.hash_aggregate(b, ["k"], [jspecs.agg_count(), jspecs.agg_avg("v")]))
        monkeypatch.setitem(sys.modules, "pandas", None)
        n = b.num_rows
        left = JaxBatch({"lk": JaxColumn("int64", np.arange(n) % 50), "g": b.columns["k"],
                         "lv": b.columns["v"]})
        right = JaxBatch({"rk": JaxColumn("int64", np.arange(50) % 25),
                          "rv": JaxColumn("int64", np.arange(50))})
        lb, rb = split_by_bucket(left, ["lk"], 4), split_by_bucket(right, ["rk"], 4)
        aggs = lambda m: [m.agg_count(), m.agg_sum("rv"), m.agg_avg("lv")]  # noqa: E731
        got = fused("torch", lb, rb, ["g"], aggs)
        monkeypatch.undo()
        assert_same(got, fused("jax", lb, rb, ["g"], aggs))
        monkeypatch.setitem(sys.modules, "pandas", None)


# ---------------------------------------------------------------------------
# test_fuzz_parity.py's aggregate fuzz, across the packages
# ---------------------------------------------------------------------------
def _fuzz_batch(rng, n):
    """test_fuzz_parity.random_batch's columns."""
    return JaxBatch({
        "k_int": JaxColumn.from_values(rng.integers(
            -(10 ** rng.integers(1, 9)), 10 ** rng.integers(1, 9), n).astype(np.int64)),
        "k_small": JaxColumn.from_values(rng.integers(0, rng.integers(2, 50), n).astype(np.int32)),
        "f32": JaxColumn.from_values(
            (rng.standard_normal(n) * 10 ** rng.integers(0, 4)).astype(np.float32)),
        "f64": JaxColumn.from_values(np.round(rng.standard_normal(n) * 1e3, 3)),
        "s": JaxColumn.from_values(rng.choice(["a", "bb", "CCC", "", "zz~!"], n).astype(object)),
    })


def _fuzz_pred(rng, batch):
    """A random predicate as data (leaves and connectives), built in each
    package by ``build``."""
    def leaf():
        c = str(rng.choice(["k_int", "k_small", "f64", "s"]))
        if c == "s":
            return (c, str(rng.choice(["eq", "ne", "lt", "ge"])),
                    str(rng.choice(["a", "bb", "CCC", "", "nope"])))
        pool = batch.columns[c].data
        v = pool[rng.integers(0, len(pool))].item() if rng.random() < 0.7 else 10 ** 10
        return (c, str(rng.choice(["eq", "ne", "lt", "le", "gt", "ge"])), v)

    spec = [("leaf", leaf())]
    for _ in range(int(rng.integers(0, 3))):
        spec.append((str(rng.choice(["and", "or", "andnot"])), leaf()))
    return spec


def _build_pred(mod, spec):
    def leaf(c, op, v):
        e = mod.col(c)
        return {"eq": e == v, "ne": e != v, "lt": e < v, "le": e <= v, "gt": e > v,
                "ge": e >= v}[op]

    p = leaf(*spec[0][1])
    for conn, args in spec[1:]:
        q = leaf(*args)
        p = p & q if conn == "and" else p | q if conn == "or" else p & ~q
    return p


@pytest.mark.parametrize("seed", range(6))
def test_aggregate_parity_fuzz(tmp_path, seed):
    rng = np.random.default_rng(7000 + seed)
    n = int(rng.integers(100, 1500))
    batch = _fuzz_batch(rng, n)
    if rng.random() < 0.4:  # NaNs in the f64 aggregate input
        d = batch.columns["f64"].data.copy()
        d[rng.random(n) < 0.1] = np.nan
        batch = JaxBatch({**batch.columns, "f64": JaxColumn.from_values(d)})
    t = Tree(tmp_path, **PLAIN, **{"hyperspace.index.numBuckets": int(rng.choice([2, 8, 16]))})
    t.write("p0.avro", batch)
    keys = [str(k) for k in rng.choice(["k_small", "s", "k_int"],
                                        size=int(rng.integers(1, 3)), replace=False)]
    val = str(rng.choice(["f64", "k_int", "f32"]))
    t.create("torch" if seed % 2 else "jax", "az", [keys[0]],
             [c for c in batch.column_names if c != keys[0]])
    spec = _fuzz_pred(rng, batch)

    def q(s, mod, m, root):
        return (s.read.avro(str(root / "data")).filter(_build_pred(mod, spec))
                .group_by(*keys).agg(m.agg_count(), m.agg_sum(val, "S"), m.agg_min(val, "m"),
                                     m.agg_max(val, "M"), m.agg_avg(val, "A")))

    serve_both(t, q, keys)


# ---------------------------------------------------------------------------
# an aggregate over a hybrid join
# ---------------------------------------------------------------------------
def test_aggregate_over_hybrid_join(tmp_path):
    """Both sources run ahead of their indexes (files appended, one
    deleted): the sides are BucketUnion + Repartition, and the fused arm
    reads the merged bucket groups in both packages."""
    t = Tree(tmp_path)
    _q17_tables(t, seed=12, n=1500, n_orders=400)
    create_pq(t, "jax", "li_h", ["okey"], ["pkey", "qty", "ship"], "li")
    create_pq(t, "jax", "or_h", ["o_okey"], ["price", "odate"], "orders")
    rng = np.random.default_rng(13)
    jax_parquet.write_parquet(t.root / "li" / "b.parquet", _li_rows(rng, 200, 420))
    jax_parquet.write_parquet(t.root / "orders" / "b.parquet", _od_rows(rng, np.arange(401, 421)))
    plan, rows, counters = serve_both(t, q17, ["pkey"])
    names = {type(n).__name__ for n in plan.collect(lambda n: True)}
    assert {"BucketUnion", "Repartition", "Aggregate"} <= names
    assert counters.get("aggregate.path.join_fused_native") == 1
    assert counters.get("union.repartition.rows") == 220
    assert rows.num_rows > 100


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_fused_ranges_come_from_k2_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.ops import launch_counts, reset_launch_counts

    rng = np.random.default_rng(8)
    rk = np.arange(1, 60_001, dtype=np.int64)
    left = TorchBatch({"lk": TorchColumn("int64", np.sort(rng.choice(rk, 240_000))),
                       "g": TorchColumn("int64", rng.integers(1, 5_000, 240_000))})
    right = TorchBatch({"rk": TorchColumn("int64", rk),
                        "rv": TorchColumn("float64", np.round(rng.uniform(1, 9, len(rk)), 2))})
    lb = split_by_bucket(left, ["lk"], 4, sort_keys=True)
    rb = split_by_bucket(right, ["rk"], 4, sort_keys=True)
    aggs = [tspecs.agg_sum("rv"), tspecs.agg_avg("rv"), tspecs.agg_count()]
    want = tagg.aggregate_join_ranges(
        *tjoins.bucketed_join_ranges(lb, rb, ["lk"], ["rk"], "cpu")[:2], ["g"], aggs,
        *tjoins.bucketed_join_ranges(lb, rb, ["lk"], ["rk"], "cpu")[2:])
    reset_launch_counts()
    torch_metrics.reset()
    ranges = tjoins.bucketed_join_ranges(lb, rb, ["lk"], ["rk"], "cuda")
    assert torch_metrics.get("join.path.presorted_merge_flat") == 1
    assert launch_counts().get(tk.K2) == 1 and launch_counts().get(tk.K2F) == 1
    got = tagg.aggregate_join_ranges(*ranges[:2], ["g"], aggs, *ranges[2:])
    assert_same(got, want)
