"""Parity of the port's query front end with the JAX package on the CPU:
predicate pushdown, column pruning, explain, the catalog and the source
formats.

The same numpy tables (from a seed) go through both packages. For every
plan shape of the reference's oracles (test_predicate_pushdown.py,
test_column_pruning.py, test_plananalysis.py, test_catalog.py,
test_formats.py) the normalized and rewritten plans, the explain text and
the collected rows must be equal. Explain prints index directories, so the
two packages are compared on one index tree, in both directions: built by
one package and served by the other. Tolerance: exact.
"""

from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.plan import aggregates as jax_aggregates
from hyperspace_tpu.plan import ir as jax_ir
from hyperspace_tpu.plan.rules.column_pruning import prune_columns as jax_prune
from hyperspace_tpu.plan.rules.predicate_pushdown import (
    push_filters_through_joins as jax_push,
)
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage import parquet_io as jax_parquet
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.plan import aggregates as torch_aggregates
from hyperspace_tpu_torch.plan import ir as torch_ir
from hyperspace_tpu_torch.plan.rules.column_pruning import prune_columns as torch_prune
from hyperspace_tpu_torch.plan.rules.predicate_pushdown import (
    push_filters_through_joins as torch_push,
)
from hyperspace_tpu_torch.storage import parquet_io as torch_parquet
from hyperspace_tpu_torch.telemetry.metrics import metrics

N_BUCKETS = 4

_TABLES = {
    "li": {"l_k": "int64", "l_q": "int64", "l_s": "string", "l_p": "float64"},
    "od": {"o_k": "int64", "o_t": "int64", "o_c": "int64"},
    "cu": {"c_k": "int64", "c_n": "string"},
}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    n = 600
    return {
        "li": {
            "l_k": rng.integers(1, 120, n).astype(np.int64),
            "l_q": rng.integers(1, 50, n).astype(np.int64),
            "l_s": rng.choice(["A", "N", "R"], n).astype(object),
            "l_p": (rng.random(n) * 100).round(2),
        },
        "od": {
            "o_k": (rng.permutation(120) + 1).astype(np.int64),
            "o_t": rng.integers(0, 1000, 120).astype(np.int64),
            "o_c": rng.integers(0, 30, 120).astype(np.int64),
        },
        "cu": {
            "c_k": np.arange(30, dtype=np.int64),
            "c_n": rng.choice(["x", "y", "z"], 30).astype(object),
        },
    }


def _write_sources(root: Path, fmt: str = "avro"):
    """Two files per table, written with the reference's writers."""
    paths = {}
    for name, cols in _data().items():
        d = root / name
        n = len(next(iter(cols.values())))
        for i, (s, e) in enumerate(((0, n // 2), (n // 2, n))):
            part = JaxBatch.from_pydict(
                {k: v[s:e] for k, v in cols.items()}, schema=_TABLES[name]
            )
            f = d / f"part-{i}.{fmt}"
            (jax_avro.write_avro if fmt == "avro" else jax_parquet.write_parquet)(f, part)
        paths[name] = str(d)
    return paths


def _session(mod, system_path, **conf):
    values = {"hyperspace.system.path": str(system_path),
              "hyperspace.index.numBuckets": N_BUCKETS, **conf}
    if mod is hs_torch:
        values["hyperspace.torch.device"] = "cpu"
    return mod.HyperspaceSession(mod.HyperspaceConf(values))


def _create_indexes(session, mod, paths):
    hsp = mod.Hyperspace(session)
    read = session.read.avro
    hsp.create_index(read(paths["li"]), mod.IndexConfig("li_i", ["l_k"], ["l_q", "l_s", "l_p"]))
    hsp.create_index(read(paths["od"]), mod.IndexConfig("od_i", ["o_k"], ["o_t", "o_c"]))
    hsp.create_index(read(paths["cu"]), mod.IndexConfig("cu_i", ["c_k"], ["c_n"]))


def _shapes(session, mod, paths):
    """The query shapes of the reference's pushdown and pruning oracles,
    written as users write them (no filter or select under a join)."""
    col = mod.col
    li = session.read.avro(paths["li"])
    od = session.read.avro(paths["od"])
    cu = session.read.avro(paths["cu"])
    on = col("l_k") == col("o_k")
    return {
        # side conjuncts move into the children, the mixed one stays above
        "side_conjuncts": li.join(od, on).filter(
            (col("l_q") > 25) & (col("o_t") < 500) & (col("l_k") > col("o_k"))),
        "nothing_splits": li.join(od, on).filter(col("l_k") > col("o_k")),
        # Filter commutes with Project: join(...).select(...).filter(...)
        "filter_over_select": li.join(od, on).select("l_q", "o_t", "l_k")
        .filter(col("l_q") > 25),
        # CombineFilters: a side conjunct stacked over a kept mixed one
        "combine_filters": li.join(od, on).filter(col("l_k") > col("o_k"))
        .filter(col("o_t") < 500).select("l_q", "o_t"),
        # a 3-table chain needs one pass per level (fixpoint)
        "three_way": li.join(od, on).join(cu, col("o_c") == col("c_k"))
        .filter((col("l_q") > 25) & (col("c_n") == "x")).select("l_q", "o_t", "c_n"),
        # column pruning: a Project over each join side
        "prune_select": li.join(od, on).select("l_q", "o_t"),
        "prune_filter_below": li.filter(col("l_s") == "A").join(od, on).select("l_q"),
        "all_columns_needed": li.join(od, on),
        # the naturally written Q3 shape
        "natural_q3": li.join(od, on).filter((col("l_q") > 10) & (col("o_t") < 500))
        .select("l_k", "l_p", "o_t", "o_c"),
        "filter_only": li.filter((col("l_k") >= 20) & (col("l_k") < 60) & (col("l_s") != "N"))
        .select("l_k", "l_q", "l_s"),
    }


def _rows(batch):
    """Order-free row set: columns by name, rows sorted lexicographically."""
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    return names, sorted(zip(*[[repr(v) for v in c] for c in cols]))


SHAPES = [
    "side_conjuncts", "nothing_splits", "filter_over_select", "combine_filters",
    "three_way", "prune_select", "prune_filter_below", "all_columns_needed",
    "natural_q3", "filter_only",
]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Sources, and an index tree built by each package."""
    root = tmp_path_factory.mktemp("frontend")
    paths = _write_sources(root / "src")
    _create_indexes(_session(hs_jax, root / "ix_jax"), hs_jax, paths)
    _create_indexes(_session(hs_torch, root / "ix_torch"), hs_torch, paths)
    return root, paths


@pytest.mark.parametrize("shape", SHAPES)
def test_normalized_plans_and_rows_match(trees, shape):
    """Hyperspace off: pushdown and pruning give the same plan and rows."""
    root, paths = trees
    j = _shapes(_session(hs_jax, root / "ix_jax"), hs_jax, paths)[shape]
    t = _shapes(_session(hs_torch, root / "ix_torch"), hs_torch, paths)[shape]
    assert t.optimized_plan().tree_string() == j.optimized_plan().tree_string()
    assert _rows(t.collect()) == _rows(j.collect())


@pytest.mark.parametrize("built_by", ["jax", "torch"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rewritten_plans_explain_and_rows_match(trees, shape, built_by):
    """Hyperspace on, one index tree served by both packages: the same
    rewritten plan, the same explain text (verbose up to the engine
    metrics, which count each process's own paths) and the same rows."""
    root, paths = trees
    tree = root / f"ix_{built_by}"
    js = _session(hs_jax, tree).enable_hyperspace()
    ts = _session(hs_torch, tree).enable_hyperspace()
    j, t = _shapes(js, hs_jax, paths)[shape], _shapes(ts, hs_torch, paths)[shape]
    assert t.optimized_plan().tree_string() == j.optimized_plan().tree_string()
    assert t.explain() == j.explain()
    assert hs_torch.Hyperspace(ts).explain(t) == hs_jax.Hyperspace(js).explain(j)
    cut = "Engine metrics (cumulative, this process):"
    tv, jv = t.explain(verbose=True), j.explain(verbose=True)
    assert cut in tv and tv.split(cut)[0] == jv.split(cut)[0]
    assert _rows(t.collect()) == _rows(j.collect())


def test_natural_q3_runs_the_bucketed_join(trees):
    """The join written the normal way reaches JoinIndexRule once pushdown
    and pruning have run, and executes as the bucketed SMJ (K2's plain
    version on the CPU), not the host join."""
    root, paths = trees
    ts = _session(hs_torch, root / "ix_torch").enable_hyperspace()
    q = _shapes(ts, hs_torch, paths)["natural_q3"]
    used = q.explain().split("Indexes used:")[1]
    assert "li_i:" in used and "od_i:" in used
    scans = q.optimized_plan().collect(lambda n: isinstance(n, torch_ir.IndexScan))
    assert len(scans) == 2 and all(s.use_bucket_spec for s in scans)
    metrics.reset()
    q.collect()
    assert metrics.get("join.path.device_kernel") == 1


@pytest.mark.parametrize("mode", ["html", "console", "plaintext_custom_tags"])
def test_explain_display_modes_match(trees, mode):
    root, paths = trees
    conf = {"hyperspace.explain.displayMode": mode.split("_")[0]}
    if mode.endswith("custom_tags"):
        conf.update({"hyperspace.explain.displayMode.highlight.beginTag": ">>",
                     "hyperspace.explain.displayMode.highlight.endTag": "<<"})
    js = _session(hs_jax, root / "ix_jax", **conf).enable_hyperspace()
    ts = _session(hs_torch, root / "ix_jax", **conf).enable_hyperspace()
    j = _shapes(js, hs_jax, paths)["natural_q3"]
    t = _shapes(ts, hs_torch, paths)["natural_q3"]
    assert t.explain() == j.explain()


def test_explain_without_applicable_index_matches(trees):
    root, paths = trees
    js = _session(hs_jax, root / "ix_jax")
    ts = _session(hs_torch, root / "ix_jax")
    j = js.read.avro(paths["li"]).filter(hs_jax.col("l_q") == 1)
    t = ts.read.avro(paths["li"]).filter(hs_torch.col("l_q") == 1)
    assert t.explain() == j.explain()
    assert "<----" not in t.explain()


def _agg_plans(ir, aggregates, col, scan):
    return {
        "agg_over_filter": ir.Aggregate(
            ("l_k",), (aggregates.agg_sum("l_q"),), ir.Filter(col("l_q") > 2, scan)),
        "agg_over_join": ir.Aggregate(
            ("l_s",), (aggregates.agg_count(),),
            ir.Join(scan, scan, col("l_k") == col("l_k"), "inner")),
        "left_join_keeps_filter_above": ir.Filter(
            col("l_q") > 25, ir.Join(scan, scan, col("l_k") == col("l_k"), "left")),
    }


@pytest.mark.parametrize("name", ["agg_over_filter", "agg_over_join",
                                  "left_join_keeps_filter_above"])
def test_pass_outputs_match_on_plans_without_a_dataframe_verb(trees, name):
    """Plans the port's DataFrame cannot write yet (aggregates arrive with
    GroupedData; outer joins are not executed): the two passes give the
    same trees, the Aggregate arm of column pruning included."""
    root, paths = trees
    js, ts = _session(hs_jax, root / "ix_jax"), _session(hs_torch, root / "ix_torch")
    j = _agg_plans(jax_ir, jax_aggregates, hs_jax.col,
                   js.read.avro(paths["li"]).plan)[name]
    t = _agg_plans(torch_ir, torch_aggregates, hs_torch.col,
                   ts.read.avro(paths["li"]).plan)[name]
    assert torch_prune(torch_push(t)).tree_string() == jax_prune(jax_push(j)).tree_string()


def test_catalog_views_and_tables_match(trees):
    """session.table over temp views and registered tables rewrites and
    answers as the path-based read does, in both packages."""
    root, paths = trees
    got = {}
    for mod in (hs_jax, hs_torch):
        s = _session(mod, root / "ix_jax").enable_hyperspace()
        s.read.avro(paths["li"]).create_or_replace_temp_view("LineItem")
        s.catalog.create_table("orders", paths["od"], file_format="avro")
        with pytest.raises(mod.HyperspaceException, match="already exists"):
            s.catalog.create_table("ORDERS", paths["od"], file_format="avro")
        q = s.table("lineitem").join(s.table("Orders"), mod.col("l_k") == mod.col("o_k")) \
            .filter(mod.col("l_q") > 10).select("l_q", "o_t")
        listed = s.catalog.list()
        dropped = (s.catalog.drop("lineitem"), s.catalog.drop("lineitem"))
        with pytest.raises(mod.HyperspaceException, match="Unknown table"):
            s.table("lineitem")
        got[mod.__name__] = (q.explain(), _rows(q.collect()), listed, dropped)
    assert got["hyperspace_tpu_torch"] == got["hyperspace_tpu"]
    assert "IndexScan" in got["hyperspace_tpu"][0]


def test_view_over_foreign_session_dataframe_rejected(trees):
    root, paths = trees
    a, b = _session(hs_torch, root / "ix_torch"), _session(hs_torch, root / "ix_torch")
    with pytest.raises(hs_torch.HyperspaceException, match="different session"):
        b.catalog.create_or_replace_temp_view("v", a.read.avro(paths["li"]))


def test_pandas_views_match(trees, capsys):
    root, paths = trees
    frames, shown = {}, {}
    for mod in (hs_jax, hs_torch):
        s = _session(mod, root / "ix_jax")
        df = s.read.avro(paths["od"]).filter(mod.col("o_t") < 300).select("o_k", "o_t")
        frames[mod.__name__] = (df.to_pandas(), mod.Hyperspace(s).indexes_df())
        df.show(5)
        shown[mod.__name__] = capsys.readouterr().out
    j, t = frames["hyperspace_tpu"], frames["hyperspace_tpu_torch"]
    assert t[0].equals(j[0]) and t[1].equals(j[1]) and len(t[1]) == 3
    assert shown["hyperspace_tpu_torch"] == shown["hyperspace_tpu"]


def _format_batch():
    rng = np.random.default_rng(5)
    n = 300
    return {"k": rng.integers(0, 60, n).astype(np.int64),
            "v": rng.integers(0, 10**6, n).astype(np.int64),
            "s": rng.choice(["x", "y", "z"], n).astype(object)}


def _write_format(root: Path, fmt: str) -> str:
    import pyarrow as pa

    data = _format_batch()
    d = root / fmt
    d.mkdir(parents=True)
    table = pa.table({k: pa.array(list(v) if v.dtype == object else v)
                      for k, v in data.items()})
    for i, sl in enumerate((slice(0, 150), slice(150, 300))):
        part = table.slice(sl.start, sl.stop - sl.start)
        f = d / f"part-{i}.{fmt}"
        if fmt == "csv":
            import pyarrow.csv as pacsv

            pacsv.write_csv(part, str(f))
        elif fmt == "json":
            f.write_text("".join(
                '{"k": %d, "v": %d, "s": "%s"}\n' % r
                for r in zip(*[part[c].to_pylist() for c in ("k", "v", "s")])))
        elif fmt == "orc":
            from pyarrow import orc as paorc

            paorc.write_table(part, str(f))
        elif fmt == "parquet":
            import pyarrow.parquet as pq

            pq.write_table(part, str(f))
        else:  # text: one line per row, with a CR line ending and a blank line
            f.write_bytes(b"".join(b"%d,%s\r\n" % (k, s.encode()) for k, s in
                                   zip(part["k"].to_pylist(), part["s"].to_pylist())) + b"\n")
    return str(d)


def _bucket_bytes(system_path: Path, index: str):
    """{bucket: TCB bytes} (file names carry a per-build suffix)."""
    return {int(f.name[1:].split("-")[0]): f.read_bytes()
            for f in (system_path / index).glob("v__=*/*.tcb")}


def _batch_view(b):
    return (b.schema(), {n: (c.data.dtype.str, c.data.tobytes(),
                             None if c.vocab is None else list(c.vocab))
                         for n, c in b.columns.items()})


@pytest.mark.parametrize("fmt", ["csv", "json", "orc", "text", "parquet"])
def test_format_readers_match(tmp_path, fmt):
    d = Path(_write_format(tmp_path, fmt))
    files = sorted(str(p) for p in d.iterdir())
    want = jax_parquet.read_files(fmt, files)
    got = torch_parquet.read_files(fmt, files)
    assert got.num_rows == want.num_rows > 0
    assert _batch_view(got) == _batch_view(want)
    cols = ["value"] if fmt == "text" else ["v"]
    assert _batch_view(torch_parquet.read_files(fmt, files, columns=cols)) == \
        _batch_view(jax_parquet.read_files(fmt, files, columns=cols))


@pytest.mark.parametrize("fmt", ["csv", "json", "orc"])
def test_index_over_format_source_matches(tmp_path, fmt):
    """Create index over a csv/json/orc source: equal TCB bytes, and the
    rewritten filter answers alike."""
    src = _write_format(tmp_path / "src", fmt)
    out = {}
    for mod in (hs_jax, hs_torch):
        tree = tmp_path / f"ix_{mod.__name__}"
        s = _session(mod, tree)
        mod.Hyperspace(s).create_index(
            s.read.format(fmt).load(src), mod.IndexConfig("f_i", ["k"], ["v", "s"]))
        s.enable_hyperspace()
        q = getattr(s.read, fmt)(src).filter(mod.col("k") < 20).select("k", "v", "s")
        out[mod.__name__] = (
            _bucket_bytes(tree, "f_i"),
            _rows(q.collect()),
            "IndexScan" in q.explain(),
        )
    assert out["hyperspace_tpu_torch"] == out["hyperspace_tpu"]
    assert len(out["hyperspace_tpu"][0]) > 1 and out["hyperspace_tpu"][2]


def test_unsupported_format_refused(tmp_path):
    s = _session(hs_torch, tmp_path / "ix")
    with pytest.raises(hs_torch.HyperspaceException):
        s.read.format("xml").load(str(tmp_path))
