"""Parity of the port's Hybrid Scan with the JAX package on the CPU.

An index whose source has since gained or lost files is served as the
index plus a read of the appended files and a lineage ``NOT IN`` over the
deleted ones (Union for a filter, BucketUnion + Repartition for a join).
Both packages serve ONE index tree over one source: for every case the
optimized plan trees (node by node through ``describe()``), the explain
text and the rows with Hyperspace off and on must be equal between the
packages, and the rows with Hyperspace on must equal those with it off as
the reference's tests compare them (as value multisets, so a float -0.0
read from a source file equals the 0.0 an index returns). Mirrors
test_hybrid_scan.py, test_partitioned_source.py's hybrid cases,
test_metadata_infra.py's defaults and test_fuzz_parity.py's hybrid fuzz;
adds a string included column across a union, a NOT IN over hundreds of
deleted ids lowered to K1's program, the appended rows' bucket ids, the
ranker's common-bytes choice and a join fuzz. Tolerance: exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import hyperspace_tpu as hs_jax
from hyperspace_tpu.ops import hashing as jax_hashing
from hyperspace_tpu.ops import kernels as jk
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage.columnar import Column as JaxColumn
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch
from hyperspace_tpu.telemetry.metrics import metrics as jax_metrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.exec.executor import Executor
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.plan import ir as torch_ir
from hyperspace_tpu_torch.storage.columnar import Column as TorchColumn
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TorchBatch
from hyperspace_tpu_torch.telemetry.metrics import metrics as torch_metrics

from tests.test_torch_hashing import _col, _columns

PKGS = {"jax": hs_jax, "torch": hs_torch}
N_BUCKETS = 4
HYBRID = {
    "hyperspace.index.hybridscan.enabled": True,
    "hyperspace.index.lineage.enabled": True,
}
_LI = {"orderkey": "int64", "qty": "int32", "flag": "string"}


def sample_batch(n, seed, key_lo=0, key_hi=100):
    """test_lifecycle.sample_batch's table."""
    rng = np.random.default_rng(seed)
    return JaxBatch.from_pydict({
        "orderkey": rng.integers(key_lo, key_hi, n).astype(np.int64),
        "qty": rng.integers(1, 51, n).astype(np.int32),
        "flag": rng.choice(["A", "N", "R"], n).astype(object),
    }, schema=_LI)


def _rows(batch):
    """Exact row set: columns by name, rows as reprs, sorted."""
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    return names, sorted(zip(*[[repr(v) for v in c] for c in cols]))


def _values(batch):
    """Row multiset by value, as the reference's assert_row_parity holds
    it (-0.0 == 0.0)."""
    names = sorted(batch.column_names)
    cols = [[v + 0.0 if isinstance(v, float) else v for v in batch.columns[n].to_values()]
            for n in names]
    return names, sorted(zip(*cols), key=repr)


class Tree:
    """One source directory (or several), one index tree, and fresh
    sessions of both packages over them."""

    def __init__(self, root: Path, **conf):
        self.root = root
        self.src = root / "data"
        self.conf = {"hyperspace.system.path": str(root / "indexes"),
                     "hyperspace.index.numBuckets": N_BUCKETS, **HYBRID, **conf}

    def session(self, key, **conf):
        values = {**self.conf, **conf}
        if key == "torch":
            values["hyperspace.torch.device"] = "cpu"
        mod = PKGS[key]
        return mod.HyperspaceSession(mod.HyperspaceConf(values))

    def write(self, name, batch, table="data"):
        jax_avro.write_avro(self.root / table / name, batch)

    def create(self, pkg, name, indexed, included, table="data", **conf):
        s = self.session(pkg, **conf)
        mod = PKGS[pkg]
        mod.Hyperspace(s).create_index(s.read.avro(str(self.root / table)),
                                       mod.IndexConfig(name, indexed, included))

    def verb(self, pkg, name, *args):
        getattr(PKGS[pkg].Hyperspace(self.session(pkg)), name)(*args)

    def compare(self, make_query, **conf):
        """Plans, explain text and rows of both packages; returns the
        port's plan and its rows with Hyperspace on (the batch itself is
        kept as ``last``). The metrics hold each package's indexed run."""
        out, plans = {}, {}
        for key, mod in PKGS.items():
            s = self.session(key, **conf)
            q = make_query(s, mod, self.root)
            s.disable_hyperspace()
            off = q.collect()
            s.enable_hyperspace()
            plans[key] = q.optimized_plan()
            (jax_metrics if key == "jax" else torch_metrics).reset()
            on = q.collect()
            assert _values(on) == _values(off), key
            out[key] = (_tree(plans[key]), q.explain(), _rows(off), _rows(on))
        self.last = on
        assert out["torch"] == out["jax"]
        return plans["torch"], out["torch"][3]


def _tree(plan):
    """The plan node by node: depth, node type and ``describe()``."""
    rows = []

    def walk(n, depth):
        rows.append((depth, type(n).__name__, n.describe()))
        for c in n.children:
            walk(c, depth + 1)

    walk(plan, 0)
    return rows


def _has(plan, name):
    return any(type(n).__name__ == name for n in plan.collect(lambda n: True))


def fquery(s, mod, root, table="data"):
    return (s.read.avro(str(root / table)).filter(mod.col("orderkey") == 7)
            .select("orderkey", "qty"))


@pytest.fixture(params=["jax", "torch"], ids=["built_by_jax", "built_by_torch"])
def built_by(request):
    return request.param


@pytest.fixture
def tree(tmp_path):
    t = Tree(tmp_path)
    t.write("part-0.avro", sample_batch(300, 1))
    t.write("part-1.avro", sample_batch(300, 2))
    return t


# ---------------------------------------------------------------------------
# test_hybrid_scan.py's ten cases
# ---------------------------------------------------------------------------
def test_append_only_filter(tree, built_by):
    tree.create(built_by, "idx", ["orderkey"], ["qty"])
    tree.write("part-9.avro", sample_batch(60, 9))  # within the 0.3 ratio
    plan, _ = tree.compare(fquery)
    assert _has(plan, "IndexScan") and _has(plan, "Union")
    assert not _has(plan, "BucketUnion")


def test_appended_ratio_threshold(tree):
    tree.create("jax", "idx", ["orderkey"], ["qty"])
    tree.write("part-9.avro", sample_batch(3000, 9))
    plan, _ = tree.compare(fquery)
    assert not _has(plan, "IndexScan")


def test_append_and_delete_over_the_deleted_cap(tree):
    tree.create("torch", "idx", ["orderkey"], ["qty"])
    tree.write("part-9.avro", sample_batch(50, 9))
    (tree.src / "part-1.avro").unlink()  # half the indexed bytes: over 0.2
    plan, _ = tree.compare(fquery)
    assert not _has(plan, "IndexScan")


def test_small_delete_with_raised_cap(tree, built_by):
    tree.conf["hyperspace.index.hybridscan.maxDeletedRatio"] = 0.6
    tree.create(built_by, "idx", ["orderkey"], ["qty"])
    (tree.src / "part-1.avro").unlink()
    plan, rows = tree.compare(fquery)
    assert _has(plan, "IndexScan") and not _has(plan, "Union")
    (flt,) = [n for n in plan.collect(lambda n: isinstance(n, torch_ir.Filter))
              if "_data_file_id" in repr(n.condition)]
    assert isinstance(flt.condition, texpr.Not)
    full = sample_batch(300, 1)
    assert len(rows[1]) == int((full.columns["orderkey"].data == 7).sum())


def test_delete_requires_lineage(tree):
    tree.conf["hyperspace.index.lineage.enabled"] = False
    tree.create("jax", "idx", ["orderkey"], ["qty"])
    tree.conf["hyperspace.index.hybridscan.maxDeletedRatio"] = 0.9
    (tree.src / "part-1.avro").unlink()
    plan, _ = tree.compare(fquery)
    assert not _has(plan, "IndexScan")


def _orders(tree, n=100, seed=5):
    rng = np.random.default_rng(seed)
    tree.write("part-0.avro", JaxBatch.from_pydict({
        "o_orderkey": rng.permutation(n).astype(np.int64),
        "o_total": (rng.random(n) * 100).round(2),
        "o_name": rng.choice(["x", "yy", "zzz"], n).astype(object),
    }, schema={"o_orderkey": "int64", "o_total": "float64", "o_name": "string"}),
        table="orders")


def jquery(s, mod, root, li_filter=None, cols=("orderkey", "qty")):
    li = s.read.avro(str(root / "data"))
    if li_filter is not None:
        li = li.filter(li_filter(mod))
    return li.select(*cols).join(
        s.read.avro(str(root / "orders")).select("o_orderkey", "o_total", "o_name"),
        mod.col("orderkey") == mod.col("o_orderkey"))


def test_join_bucket_union(tree, built_by):
    _orders(tree)
    tree.create(built_by, "li_idx", ["orderkey"], ["qty"])
    tree.create(built_by, "od_idx", ["o_orderkey"], ["o_total", "o_name"], table="orders")
    tree.write("part-9.avro", sample_batch(60, 10))  # lineitem only
    plan, rows = tree.compare(jquery)
    assert len(plan.collect(lambda n: isinstance(n, torch_ir.IndexScan))) == 2
    (bu,) = plan.collect(lambda n: isinstance(n, torch_ir.BucketUnion))
    assert bu.describe() == f"BucketUnion [orderkey] x{N_BUCKETS}"
    assert isinstance(bu.children[1], torch_ir.Repartition)
    assert rows[1]
    # the bucketed join served it: the appended rows were hashed into the
    # index's buckets, not joined through the host join
    assert torch_metrics.get("union.repartition.rows") == 60
    # the right side (orders) is index-only, key-sorted per bucket: the
    # presorted route over the flat-remapped codes
    assert torch_metrics.get("join.path.presorted_merge_flat") == 1


def test_join_with_appends_on_both_sides_and_a_delete(tree):
    """The lineage NOT IN on the lineitem join side (evaluated per bucket),
    appended rows on both sides, and a filter above the lineitem side."""
    tree.conf["hyperspace.index.hybridscan.maxDeletedRatio"] = 0.6
    _orders(tree)
    tree.create("jax", "li_idx", ["orderkey"], ["qty", "flag"])
    tree.create("jax", "od_idx", ["o_orderkey"], ["o_total", "o_name"], table="orders")
    tree.write("part-9.avro", sample_batch(40, 11))
    (tree.src / "part-1.avro").unlink()
    rng = np.random.default_rng(6)
    tree.write("part-1.avro", JaxBatch.from_pydict({
        "o_orderkey": np.arange(100, 110, dtype=np.int64),
        "o_total": rng.random(10).round(2),
        "o_name": rng.choice(["w", "x"], 10).astype(object),
    }, schema={"o_orderkey": "int64", "o_total": "float64", "o_name": "string"}),
        table="orders")

    def q(s, mod, root):
        return jquery(s, mod, root, li_filter=lambda m: m.col("qty") > 10,
                      cols=("orderkey", "qty", "flag"))

    plan, rows = tree.compare(q)
    assert len(plan.collect(lambda n: isinstance(n, torch_ir.BucketUnion))) == 2
    assert any("_data_file_id" in n.describe() for n in plan.collect(lambda n: True))
    assert rows[1]


def test_quick_refresh_then_query_with_hybrid_off(tree, built_by):
    tree.create(built_by, "idx", ["orderkey"], ["qty"])
    tree.write("part-9.avro", sample_batch(60, 12))
    tree.verb(built_by, "refresh_index", "idx", "quick")
    tree.conf["hyperspace.index.hybridscan.enabled"] = False
    plan, _ = tree.compare(fquery)
    # the recorded update is served through the hybrid transformation
    assert _has(plan, "IndexScan") and _has(plan, "Union")


def test_no_common_files_no_candidate(tree):
    tree.create("torch", "idx", ["orderkey"], ["qty"])
    tree.write("part-0.avro", sample_batch(100, 3), table="other")
    plan, _ = tree.compare(lambda s, mod, root: fquery(s, mod, root, table="other"))
    assert not _has(plan, "IndexScan")


def test_lineage_ids_stable_across_refresh_with_shifted_sort_order(tree, built_by):
    tree.create(built_by, "idx", ["orderkey"], ["qty"])
    tree.write("aaa-append.avro", sample_batch(60, 9))  # sorts before part-*
    tree.verb(built_by, "refresh_index", "idx", "incremental")
    (tree.src / "part-1.avro").unlink()
    tree.conf["hyperspace.index.hybridscan.maxDeletedRatio"] = 0.6
    plan, _ = tree.compare(fquery)
    assert _has(plan, "IndexScan")


def test_delete_path_bucket_pruning(tmp_path):
    """Filter(key, Project(Filter(NOT IN, IndexScan))) still prunes to the
    key's bucket: the Project that drops the lineage column is transparent
    to pushdown."""
    t = Tree(tmp_path, **{"hyperspace.index.numBuckets": 16})
    rng = np.random.default_rng(0)
    n, per = 4000, 500
    k = rng.integers(0, 500, n).astype(np.int64)
    v = rng.integers(0, 10**6, n).astype(np.int64)
    for i in range(8):
        t.write(f"part-{i}.avro", JaxBatch.from_pydict(
            {"k": k[i * per:(i + 1) * per], "v": v[i * per:(i + 1) * per]},
            schema={"k": "int64", "v": "int64"}))
    t.create("jax", "pr_idx", ["k"], ["v"])
    (t.src / "part-7.avro").unlink()  # 12.5% of the bytes, under the 0.2 cap
    key = int(k[10])
    plan, rows = t.compare(lambda s, mod, root: s.read.avro(str(root / "data"))
                           .filter(mod.col("k") == key).select("k", "v"))
    assert _has(plan, "IndexScan") and not _has(plan, "Union")
    for get in (jax_metrics.counter, torch_metrics.get):
        assert 1 <= get("scan.files_read") <= 2
    want = sorted(v[:7 * per][k[:7 * per] == key].tolist())
    assert sorted(t.last.columns["v"].data.tolist()) == want


# ---------------------------------------------------------------------------
# partitioned sources (test_partitioned_source.py:262,284)
# ---------------------------------------------------------------------------
def _part_batch(n, key_hi, seed):
    rng = np.random.default_rng(seed)
    return JaxBatch.from_pydict({
        "orderkey": rng.integers(0, key_hi, n).astype(np.int64),
        "qty": rng.integers(0, 1000, n).astype(np.int64),
    }, schema={"orderkey": "int64", "qty": "int64"})


@pytest.fixture
def ptree(tmp_path):
    t = Tree(tmp_path)
    for i, (region, day) in enumerate([("us", 1), ("us", 2), ("eu", 1), ("eu", 2)]):
        t.write(f"region={region}/day={day}/part-0.avro", _part_batch(200, 300, i))
    return t


def test_hybrid_append_new_partition(ptree):
    ptree.create("jax", "hidx", ["orderkey"], ["qty", "region"])
    ptree.write("region=ap/day=3/part-0.avro", _part_batch(40, 300, 9))

    def q(s, mod, root):
        return (s.read.avro(str(root / "data")).filter(mod.col("orderkey") == 7)
                .select("orderkey", "qty", "region"))

    plan, rows = ptree.compare(q)
    assert _has(plan, "Union")
    assert "'ap'" in {r[2] for r in rows[1]}


def test_hybrid_delete_partition_file(ptree):
    ptree.create("torch", "didx", ["orderkey"], ["qty", "day"])
    (ptree.src / "region=us" / "day=2" / "part-0.avro").unlink()

    def q(s, mod, root):
        return (s.read.avro(str(root / "data")).filter(mod.col("orderkey") == 7)
                .select("orderkey", "qty", "day"))

    # a quarter of the bytes: under the cap only once it is raised
    plan, _ = ptree.compare(q)
    assert not _has(plan, "IndexScan")
    plan, _ = ptree.compare(q, **{"hyperspace.index.hybridscan.maxDeletedRatio": 0.3})
    assert _has(plan, "IndexScan")


def test_partition_pruning_on_the_appended_side(ptree):
    """A predicate on a partition column prunes the appended side's files
    before any is read, as the Scan arm prunes a source scan."""
    ptree.create("jax", "pidx", ["orderkey"], ["qty", "region"])
    ptree.write("region=ap/day=3/part-0.avro", _part_batch(40, 300, 9))
    ptree.write("region=eu/day=3/part-0.avro", _part_batch(40, 300, 10))

    def q(s, mod, root):
        return (s.read.avro(str(root / "data"))
                .filter((mod.col("orderkey") < 50) & (mod.col("region") == "ap"))
                .select("orderkey", "qty", "region"))

    plan, rows = ptree.compare(q)
    assert _has(plan, "Union") and rows[1]
    assert torch_metrics.get("scan.partition_pruned") == 1
    assert jax_metrics.counter("scan.partition_pruned") == 1


# ---------------------------------------------------------------------------
# configuration (test_metadata_infra.py:40-41)
# ---------------------------------------------------------------------------
def test_hybrid_conf_defaults_and_overrides_match():
    for values in ({}, {"hyperspace.index.hybridscan.maxAppendedRatio": "0.5",
                        "hyperspace.index.hybridscan.maxDeletedRatio": 0.05}):
        got = [(c.hybrid_scan_enabled(), c.hybrid_scan_appended_ratio_threshold(),
                c.hybrid_scan_deleted_ratio_threshold())
               for c in (mod.HyperspaceConf(dict(values)) for mod in PKGS.values())]
        assert got[0] == got[1]
    assert got[0] == (False, 0.5, 0.05)
    assert hs_torch.HyperspaceConf().hybrid_scan_appended_ratio_threshold() == 0.3
    assert hs_torch.HyperspaceConf().hybrid_scan_deleted_ratio_threshold() == 0.2


# ---------------------------------------------------------------------------
# beyond the reference's cases
# ---------------------------------------------------------------------------
def test_string_included_column_across_the_union(tree, built_by):
    """The appended file's strings are not in the index's dictionary: the
    union unifies the two sides' dictionaries."""
    tree.create(built_by, "sidx", ["orderkey"], ["qty", "flag"])
    extra = sample_batch(60, 13)
    extra.columns["flag"] = JaxColumn.from_optional_values(
        list(np.random.default_rng(3).choice(["N", "new-flag", "Ω"], 60)))
    tree.write("part-9.avro", extra)

    def q(s, mod, root):
        return (s.read.avro(str(root / "data"))
                .filter((mod.col("orderkey") < 40) & (mod.col("flag") != "A"))
                .select("orderkey", "qty", "flag"))

    plan, rows = tree.compare(q)
    assert _has(plan, "Union")
    flags = {r[0] for r in rows[1]}
    assert {"'new-flag'", "'Ω'", "'N'"} <= flags


def test_not_in_over_hundreds_of_deleted_ids_lowers_to_k1(monkeypatch):
    """The index side's lineage filter over 257 deleted ids: its OR chain
    narrows and lowers to a staged K1 program (over the parameter block's
    240 instructions) whose postfix run, and the port's plain mask, equal
    the JAX package's Pallas mask in interpret mode."""
    monkeypatch.setenv("HYPERSPACE_TPU_KERNELS", "interpret")
    rng = np.random.default_rng(21)
    n = 5000
    ids = sorted(rng.choice(2000, 257, replace=False).tolist())
    arrs = {
        "_data_file_id": rng.integers(0, 2000, n).astype(np.int64),
        "orderkey": rng.integers(0, 10**6, n).astype(np.int64),
    }

    def pred(m):
        return (m.col("orderkey") >= 1000) & ~m.is_in(m.col("_data_file_id"), ids)

    want = jk.predicate_mask(pred(jexpr), arrs, n)
    assert want is not None and 0 < want.sum() < n
    narrowed, names, i32 = tk.prepare_predicate(pred(texpr), arrs)
    program = tk.lowered_predicate(narrowed, names)
    assert program.staged and len(program.prog) == 2 * 257 + 2 and program.depth == 2
    cols = [torch.from_numpy(i32[k]) for k in names]
    assert np.array_equal(tk.run_postfix_reference(program.prog, cols).numpy(), want)
    assert np.array_equal(tk.predicate_mask(pred(texpr), arrs, n, device="cpu"), want)


@pytest.mark.parametrize("num_buckets", [1, 7, 200])
def test_repartition_bucket_ids_match_the_reference_hash(num_buckets):
    """``_repartition_by_bucket`` puts every appended row in the bucket the
    JAX package's host hash gives its key, for every key dtype."""
    cols = _columns(seed=4, n=600)
    keys = list(cols) + [("int64", "string")]
    for key in keys:
        names = key if isinstance(key, tuple) else (key,)
        tcols = {n: _col(TorchColumn, *cols[n]) for n in names}
        jcols = {n: _col(JaxColumn, *cols[n]) for n in names}
        batch = TorchBatch({**tcols, "row": TorchColumn("int64", np.arange(600))})
        ex = Executor(device="cpu")
        ex._exec = lambda plan, predicate, columns=None: batch
        node = torch_ir.Repartition(names, num_buckets, torch_ir.Project(("row",), None))
        groups = ex._repartition_by_bucket(node, None)
        want = jax_hashing.bucket_ids_host(
            [jax_hashing.key_repr(jcols[n]) for n in names], num_buckets)
        got = np.full(600, -1)
        for b, part in groups.items():
            got[part.columns["row"].data] = b
        assert np.array_equal(got, want), key


def test_ranker_picks_the_candidate_with_most_common_bytes(tree, built_by):
    """Two candidates over one source: ``old`` misses the appended file,
    ``new`` covers it, and both packages' filter ranker pick ``new``."""
    tree.create(built_by, "old", ["orderkey"], ["qty"])
    tree.write("part-9.avro", sample_batch(60, 14))
    tree.create(built_by, "new", ["orderkey"], ["qty"])
    plan, _ = tree.compare(fquery)
    (scan,) = plan.collect(lambda n: isinstance(n, torch_ir.IndexScan))
    assert scan.entry.name == "new" and not _has(plan, "Union")
    tree.write("part-8.avro", sample_batch(60, 15))
    plan, _ = tree.compare(fquery)
    (scan,) = plan.collect(lambda n: isinstance(n, torch_ir.IndexScan))
    assert scan.entry.name == "new" and _has(plan, "Union")


# ---------------------------------------------------------------------------
# test_fuzz_parity.py:292 across the packages, and a join variant
# ---------------------------------------------------------------------------
def _fuzz_tree(tmp_path, rng, n_files=8):
    n = int(rng.integers(200, 2000))
    per = (n + n_files - 1) // n_files
    k = rng.integers(0, 200, n).astype(np.int64)
    v = rng.integers(-10**6, 10**6, n).astype(np.int64)
    t = Tree(tmp_path, **{"hyperspace.index.numBuckets": int(rng.choice([2, 8, 32]))})
    for i in range(n_files):
        sl = slice(i * per, min((i + 1) * per, n))
        t.write(f"p{i}.avro", JaxBatch.from_pydict(
            {"k": k[sl], "v": v[sl]}, schema={"k": "int64", "v": "int64"}))
    return t


def _mutate(t, rng, n_files=8):
    if rng.random() < 0.8:
        t.write("appended.avro", JaxBatch.from_pydict(
            {"k": rng.integers(0, 200, 40).astype(np.int64),
             "v": rng.integers(-10**6, 10**6, 40).astype(np.int64)},
            schema={"k": "int64", "v": "int64"}))
    if rng.random() < 0.6:
        (t.src / f"p{int(rng.integers(0, n_files))}.avro").unlink()


@pytest.mark.parametrize("seed", range(6))
def test_hybrid_parity_fuzz(tmp_path, seed):
    rng = np.random.default_rng(9000 + seed)
    t = _fuzz_tree(tmp_path, rng)
    t.create("jax" if seed % 2 else "torch", "hz", ["k"], ["v"])
    _mutate(t, rng)
    for _ in range(3):
        key = int(rng.integers(0, 200))
        width = int(rng.integers(1, 30))
        cut = int(rng.integers(-10**6, 10**6))
        which = int(rng.integers(0, 3))

        def q(s, mod, root, key=key, width=width, cut=cut, which=which):
            c = mod.col
            pred = [c("k") == key, (c("k") >= key) & (c("k") < key + width),
                    c("v") > cut][which]
            return s.read.avro(str(root / "data")).filter(pred).select("k", "v")

        t.compare(q)


@pytest.mark.parametrize("seed", range(6))
def test_hybrid_join_parity_fuzz(tmp_path, seed):
    """Both join sides indexed; the left side gains and loses files (and
    the right side gains one on odd seeds) before the join runs."""
    rng = np.random.default_rng(9100 + seed)
    t = _fuzz_tree(tmp_path, rng)
    m = int(rng.integers(200, 600))
    t.write("r0.avro", JaxBatch.from_pydict(
        {"rk": rng.integers(0, 200, m).astype(np.int64),
         "rv": rng.integers(-1000, 1000, m).astype(np.int64)},
        schema={"rk": "int64", "rv": "int64"}), table="right")
    built_by = "jax" if seed % 2 else "torch"
    t.create(built_by, "lz", ["k"], ["v"])
    t.create(built_by, "rz", ["rk"], ["rv"], table="right")
    _mutate(t, rng)
    if seed % 2:
        t.write("r1.avro", JaxBatch.from_pydict(
            {"rk": rng.integers(0, 200, 10).astype(np.int64),
             "rv": rng.integers(-1000, 1000, 10).astype(np.int64)},
            schema={"rk": "int64", "rv": "int64"}), table="right")
    cut = int(rng.integers(-10**6, 10**6))

    def q(s, mod, root):
        c = mod.col
        return (s.read.avro(str(root / "data")).filter(c("v") > cut).select("k", "v")
                .join(s.read.avro(str(root / "right")).select("rk", "rv"),
                      c("k") == c("rk")))

    plan, _ = t.compare(q)
    assert len(plan.collect(lambda n: isinstance(n, torch_ir.IndexScan))) == 2
