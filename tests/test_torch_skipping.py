"""Parity of the port's hive-partitioned sources and data-skipping indexes
with the JAX package on the CPU.

Mirrors the reference's test_partitioned_source.py and
test_data_skipping.py: the same numpy tables (from a seed), written as one
hive-partitioned tree, go through both packages, which must agree on the
partition specs and pruned file lists, the rows of partition-pruned scans,
the TCB bytes and log entries of covering indexes over partitioned avro
and parquet sources, the sketches built per file, the ``sketches.json``
bytes and log entry of a skipping index, the files the skipping rule keeps,
the explain text on one shared index tree (in both directions) and the
rows. Tolerance: exact.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.index import sketches as jax_sk
from hyperspace_tpu.plan import ir as jax_ir
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage import parquet_io as jax_parquet
from hyperspace_tpu.storage import partitions as jax_parts
from hyperspace_tpu.storage.columnar import Column as JaxColumn
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch
from hyperspace_tpu.telemetry.metrics import metrics as jax_metrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.index import sketches as torch_sk
from hyperspace_tpu_torch.plan import ir as torch_ir
from hyperspace_tpu_torch.storage import partitions as torch_parts
from hyperspace_tpu_torch.storage.columnar import Column as TorchColumn
from hyperspace_tpu_torch.telemetry.metrics import metrics as torch_metrics

N_BUCKETS = 4
PKGS = {"jax": hs_jax, "torch": hs_torch}
_SCHEMA = {"orderkey": "int64", "partkey": "int64", "qty": "int64", "price": "float64",
           "flag": "string"}


def _part_batch(n, seed, base):
    rng = np.random.default_rng(seed)
    return JaxBatch.from_pydict({
        "orderkey": np.sort(rng.integers(0, 100, n)).astype(np.int64) + base,
        "partkey": rng.integers(0, 500, n).astype(np.int64),
        "qty": rng.integers(1, 51, n).astype(np.int64),
        "price": (rng.random(n) * 100).round(2),
        "flag": rng.choice(["A", "N", "R"], n).astype(object),
    }, schema=_SCHEMA)


def _write_partitioned(root: Path, fmt: str) -> str:
    """year=YYYY/region=xx/part-N files; the partition columns are absent
    from the files, as hive writes them. Order keys grow from file to file
    inside a directory, so min/max sketches can prune."""
    writer = jax_avro.write_avro if fmt == "avro" else jax_parquet.write_parquet
    seed = 0
    for year in (2021, 2022, 2023):
        for region in ("eu", "us%20west"):
            for i in range(2):
                seed += 1
                writer(root / f"year={year}" / f"region={region}" / f"part-{i}.{fmt}",
                       _part_batch(120, seed, base=i * 100))
    return str(root)


def _session(mod, system_path, **conf):
    values = {"hyperspace.system.path": str(system_path),
              "hyperspace.index.numBuckets": N_BUCKETS, **conf}
    if mod is hs_torch:
        values["hyperspace.torch.device"] = "cpu"
    return mod.HyperspaceSession(mod.HyperspaceConf(values))


def _rows(batch):
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    return names, sorted(zip(*[[repr(v) for v in c] for c in cols]))


def _bucket_bytes(system_path: Path, index: str):
    return {int(f.name[1:].split("-")[0]): f.read_bytes()
            for f in (system_path / index).glob("v__=*/*.tcb")}


def _entry_view(e):
    """A log entry without its ids, timestamps and index location."""
    d = e.derived_dataset
    rel = e.source.relations[0]
    return (
        e.name, e.state, d.kind, json.dumps(d.to_json_dict() if hasattr(d, "to_json_dict")
                                            else repr(d), sort_keys=True, default=str),
        e.signature().provider, e.signature().value,
        list(rel.root_paths), dict(rel.schema), rel.file_format, dict(rel.options),
        sorted((f.name, f.size) for f in e.source_file_infos()),
        len(e.content.files()),
    )


# ---------------------------------------------------------------------------
# partition layout units
# ---------------------------------------------------------------------------
_LAYOUT_CASES = {
    "trailing_run": (["/t/x/a=1/b=2/f.parquet", "/t/x/a=3/b=4/f.parquet"], ["/t/x"], None),
    "base_bounds_run": (["/t/k=5/a=1/f.parquet"], ["/t/k=5"], None),
    "kv_named_root": (["/d/run=5/f.parquet"], ["/d/run=5"], None),
    "inference": (["/t/i=1/f=1.5/s=x/a", "/t/i=20/f=2/s=3/b"], ["/t"], None),
    "nulls_force_string": (["/t/k=__HIVE_DEFAULT_PARTITION__/a", "/t/k=3/b"], ["/t"], None),
    "url_unquoting": (["/t/city=San%20Jose/a", "/t/city=a%2Fb/b"], ["/t"], None),
    "declared_pins": (["/t/k=1/a", "/t/k=2/b"], ["/t"], {"k": "float64"}),
    "date_and_bool": (["/t/d=2024-01-02/flag=true/a"], ["/t"],
                      {"d": "date32", "flag": "bool"}),
    "huge_int_is_float": (["/t/k=99999999999999999999/a"], ["/t"], None),
}


def _layout(parts, name):
    files, bases, declared = _LAYOUT_CASES[name]
    spec = parts.discover_partition_spec(files, bases, declared_schema=declared)
    if spec is None:
        return None
    values = [parts.partition_values_for(f, spec) for f in files]
    return spec, [{k: repr(v) for k, v in vs.items()} for vs in values], \
        [parts.partition_segments(f, bases) for f in files]


@pytest.mark.parametrize("name", sorted(_LAYOUT_CASES))
def test_partition_discovery_matches(name):
    want, got = _layout(jax_parts, name), _layout(torch_parts, name)
    if want is None:
        assert got is None
        return
    assert got[0].columns == want[0].columns and got[0].bases == want[0].bases
    assert got[1:] == want[1:]


@pytest.mark.parametrize("files", [
    ["/t/a=1/f", "/t/b=1/f"],  # conflicting names
    ["/t/a=1/f", "/t/f"],  # partitioned beside flat
])
def test_conflicting_layouts_rejected_alike(files):
    for parts, mod in ((jax_parts, hs_jax), (torch_parts, hs_torch)):
        with pytest.raises(mod.HyperspaceException, match="Conflicting partition"):
            parts.discover_partition_spec(files, ["/t"])


def test_bad_values_rejected_alike():
    for parts, mod in ((jax_parts, hs_jax), (torch_parts, hs_torch)):
        spec = parts.discover_partition_spec(["/t/k=1/a"], ["/t"], {"k": "int64"})
        with pytest.raises(mod.HyperspaceException, match="does not parse"):
            parts.partition_values_for("/t/k=oops/a", spec)


@pytest.mark.parametrize("pred", ["eq", "range", "or_in", "string"])
def test_prune_files_matches(pred):
    class F:  # a FileInfo's name is all pruning reads
        def __init__(self, name):
            self.name = name

    names = [f"/t/y={y}/r={r}/part-{i}" for y in (2021, 2022, 2023)
             for r in ("eu", "us") for i in range(2)]
    kept = {}
    for parts, mod in ((jax_parts, hs_jax), (torch_parts, hs_torch)):
        c = mod.col
        p = {"eq": c("y") == 2022,
             "range": (c("y") >= 2022) & (c("r") != "us"),
             "or_in": mod.is_in(c("y"), [2021, 2023]) | (c("r") == "eu"),
             "string": c("r") > "f"}[pred]
        files = [F(n) for n in names]
        spec = parts.discover_partition_spec(names, ["/t"])
        kept[mod.__name__] = [f.name for f in parts.prune_files(files, spec, p)]
    assert kept["hyperspace_tpu_torch"] == kept["hyperspace_tpu"]
    assert 0 < len(kept["hyperspace_tpu"]) < len(names)


# ---------------------------------------------------------------------------
# partitioned sources end to end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["avro", "parquet"])
def part_src(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"part_{request.param}")
    return request.param, _write_partitioned(root / "sales", request.param), root


def _read(session, fmt, path):
    return getattr(session.read, fmt)(path)


def _part_queries(mod, df):
    c = mod.col
    return {
        "year_eq": df.filter((c("year") == 2022) & (c("qty") < 24)),
        "region_unquoted": df.filter(c("region") == "us west").select("orderkey", "region"),
        "mixed_conjunct": df.filter((c("year") > 2021) & ((c("year") == 2023) | (c("qty") > 40))),
        "to_zero_files": df.filter(c("year") == 1999).select("orderkey", "year"),
        "partition_only": df.filter(c("year") == 2021).select("year", "region"),
    }


def test_partitioned_relation_and_scans_match(part_src):
    """Schema, spec and logged options of the relation; rows and
    ``scan.partition_pruned`` of each scan, Hyperspace off."""
    fmt, src, root = part_src
    out = {}
    for key, mod in PKGS.items():
        s = _session(mod, root / f"ix_{key}")
        df = _read(s, fmt, src)
        rel = df.plan.relation
        res = {}
        for name, q in _part_queries(mod, df).items():
            m = jax_metrics if mod is hs_jax else torch_metrics
            before = (m.counter if mod is hs_jax else m.get)("scan.partition_pruned")
            res[name] = (_rows(q.collect()),
                         (m.counter if mod is hs_jax else m.get)("scan.partition_pruned") - before)
        out[key] = (dict(rel.schema), rel.partition_spec.columns, dict(rel.options), res)
    assert out["torch"] == out["jax"]
    assert out["jax"][1] == (("year", "int64"), ("region", "string"))
    pruned = {k: v[1] for k, v in out["jax"][3].items()}
    assert pruned == {"year_eq": 8, "region_unquoted": 6, "mixed_conjunct": 4,
                      "to_zero_files": 12, "partition_only": 8}


def test_index_over_partitioned_source_matches(part_src):
    """A covering index holding both partition columns: equal TCB bytes
    and log entries (PARTITION_COLUMNS_META logged in the relation), the
    filter rewritten alike; lineage over partitioned files too."""
    fmt, src, root = part_src
    out = {}
    for key, mod in PKGS.items():
        tree = root / f"ix_cov_{key}"
        s = _session(mod, tree, **{"hyperspace.index.lineage.enabled": True})
        mod.Hyperspace(s).create_index(
            _read(s, fmt, src),
            mod.IndexConfig("pidx", ["orderkey"], ["year", "region", "qty"]))
        entry = s.collection_manager.get_indexes()[0]
        s.enable_hyperspace()
        c = mod.col
        q = _read(s, fmt, src).filter((c("orderkey") < 60) & (c("year") == 2022)) \
            .select("orderkey", "region", "qty")
        out[key] = (_bucket_bytes(tree, "pidx"), _entry_view(entry), dict(entry.schema),
                    _rows(q.collect()), "Name: pidx" in q.explain())
    assert out["torch"] == out["jax"]
    assert out["jax"][2]["year"] == "int64" and out["jax"][4]
    assert "hyperspace.source.partitionColumns" in out["jax"][1][9]


def test_index_keyed_on_a_partition_column_matches(part_src):
    fmt, src, root = part_src
    out = {}
    for key, mod in PKGS.items():
        tree = root / f"ix_key_{key}"
        s = _session(mod, tree)
        mod.Hyperspace(s).create_index(
            _read(s, fmt, src), mod.IndexConfig("yidx", ["year"], ["orderkey"]))
        out[key] = _bucket_bytes(tree, "yidx")
    assert out["torch"] == out["jax"] and len(out["jax"]) > 1


# ---------------------------------------------------------------------------
# sketches
# ---------------------------------------------------------------------------
def _sketch_columns(Column):
    rng = np.random.default_rng(11)
    return {
        "int64": Column.from_values(rng.integers(-50, 50, 400).astype(np.int64)),
        "float64": Column.from_values(np.array([-0.0, 0.0, 1.5, -7.25, 1e300, 3.0])),
        "float32": Column.from_values(rng.random(50).astype(np.float32)),
        "string": Column.from_values(rng.choice(["ab", "cd", "é", "zz"], 100).astype(object)),
        "empty": Column.from_values(np.array([], dtype=np.int64)),
    }


_SKETCHES = {
    "minmax": lambda sk: sk.MinMaxSketch("c"),
    "valuelist": lambda sk: sk.ValueListSketch("c", max_size=8),
    "bloom": lambda sk: sk.BloomFilterSketch("c", 0.05, 300),
}
_PROBES = {"int64": [(None, {7}), ((-10, 10), None), ((60, None), None), (None, {99, -3})],
           "float64": [(None, {1.5}), ((2.0, 4.0), None), (None, {-0.0})],
           "float32": [(None, {0.25}), ((0.5, None), None)],
           "string": [(None, {"cd"}), (("d", None), None), (None, {"q"})],
           "empty": [(None, {1})]}


@pytest.mark.parametrize("kind", sorted(_SKETCHES))
@pytest.mark.parametrize("dtype", sorted(_PROBES))
def test_sketch_build_and_tests_match(kind, dtype):
    jc, tc = _sketch_columns(JaxColumn)[dtype], _sketch_columns(TorchColumn)[dtype]
    js, ts = _SKETCHES[kind](jax_sk), _SKETCHES[kind](torch_sk)
    jd, td = js.build(jc), ts.build(tc)
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)
    assert ts.to_json_dict() == js.to_json_dict()
    assert torch_sk.sketch_key(ts.to_json_dict()) == jax_sk.sketch_key(js.to_json_dict())
    dt = jc.dtype_str
    for bounds, pins in _PROBES[dtype]:
        assert ts.can_match(td, dt, bounds, pins) == js.can_match(jd, dt, bounds, pins)


def test_bloom_has_no_false_negatives():
    col = TorchColumn.from_values(np.arange(1000, dtype=np.int64) * 7919)
    s = torch_sk.BloomFilterSketch("c", 0.01, 1000)
    data = s.build(col)
    assert all(s.can_match(data, "int64", None, {int(v)}) for v in col.data[::37])


# ---------------------------------------------------------------------------
# data-skipping indexes end to end
# ---------------------------------------------------------------------------
def _skip_config(mod):
    return mod.DataSkippingIndexConfig(
        "skp", [mod.MinMaxSketch("orderkey"), mod.BloomFilterSketch("partkey", 0.01, 200),
                mod.ValueListSketch("flag")])


def _skip_queries(mod, df):
    c = mod.col
    return {
        "orderkey_window": df.filter((c("orderkey") >= 120) & (c("orderkey") < 140))
        .select("orderkey", "partkey"),
        "bloom_point": df.filter(c("partkey") == 77).select("orderkey", "partkey", "year"),
        "prunes_all": df.filter(c("orderkey") > 10_000).select("orderkey"),
        "with_partition": df.filter((c("orderkey") < 30) & (c("year") == 2023))
        .select("orderkey", "qty"),
        "unprunable": df.filter(c("qty") > 45).select("qty"),
    }


@pytest.fixture(scope="module")
def skip_trees(part_src):
    fmt, src, root = part_src
    for key, mod in PKGS.items():
        s = _session(mod, root / f"ix_skip_{key}")
        mod.Hyperspace(s).create_index(_read(s, fmt, src), _skip_config(mod))
    return fmt, src, root


def test_skipping_index_files_and_entry_match(skip_trees):
    fmt, src, root = skip_trees
    sk = {k: next((root / f"ix_skip_{k}" / "skp").glob("v__=0/sketches.json")).read_bytes()
          for k in PKGS}
    assert sk["torch"] == sk["jax"]
    assert len(json.loads(sk["jax"])["files"]) == 12
    views = {k: _entry_view(_session(m, root / f"ix_skip_{k}").collection_manager
                            .get_indexes()[0]) for k, m in PKGS.items()}
    assert views["torch"] == views["jax"]


def _scan_files(plan, ir):
    return [f.name for f in plan.collect(lambda n: isinstance(n, ir.Scan))[0].relation.files]


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_skipping_rule_prunes_and_explains_alike(skip_trees, built_by):
    """One sketch tree served by both packages: the same files kept, the
    same explain text, and rows equal to the unindexed scan."""
    fmt, src, root = skip_trees
    tree = root / f"ix_skip_{built_by}"
    out = {}
    for key, mod in PKGS.items():
        s = _session(mod, tree)
        ir = jax_ir if mod is hs_jax else torch_ir
        off = {n: _rows(q.collect()) for n, q in _skip_queries(mod, _read(s, fmt, src)).items()}
        s.enable_hyperspace()
        res = {}
        for name, q in _skip_queries(mod, _read(s, fmt, src)).items():
            rows = _rows(q.collect())
            assert rows == off[name], name
            res[name] = (_scan_files(q.optimized_plan(), ir), q.explain(), rows)
        out[key] = res
    assert out["torch"] == out["jax"]
    kept = {n: len(v[0]) for n, v in out["jax"].items()}
    assert kept["orderkey_window"] < 12 and kept["prunes_all"] == 0
    assert kept["unprunable"] == 12
    assert "skp:" in out["jax"]["orderkey_window"][1].split("Indexes used:")[1]


def test_skipping_and_covering_coexist(skip_trees):
    """A covering index claims the scan first; the skipping rule leaves a
    rewritten scan alone and prunes the ones the covering rules decline."""
    fmt, src, root = skip_trees
    out = {}
    for key, mod in PKGS.items():
        tree = root / f"ix_both_{key}"
        s = _session(mod, tree)
        hsp = mod.Hyperspace(s)
        hsp.create_index(_read(s, fmt, src), mod.IndexConfig("cov", ["orderkey"], ["qty"]))
        hsp.create_index(_read(s, fmt, src), _skip_config(mod))
        s.enable_hyperspace()
        c = mod.col
        covered = _read(s, fmt, src).filter(c("orderkey") < 30).select("orderkey", "qty")
        skipped = _read(s, fmt, src).filter(c("orderkey") < 30).select("orderkey", "partkey")
        out[key] = [(q.optimized_plan().tree_string().replace(str(tree), "<ix>"),
                     _rows(q.collect())) for q in (covered, skipped)]
    assert out["torch"] == out["jax"]
    assert "IndexScan" in out["jax"][0][0] and "IndexScan" not in out["jax"][1][0]


def test_skipping_lifecycle_refusals(skip_trees):
    fmt, src, root = skip_trees
    s = _session(hs_torch, root / "ix_skip_torch")
    hsp = hs_torch.Hyperspace(s)
    with pytest.raises(hs_torch.HyperspaceException, match="not supported for data-skipping"):
        hsp.optimize_index("skp")
    with pytest.raises(hs_torch.HyperspaceException, match="Quick refresh is not supported"):
        hsp.refresh_index("skp", "quick")
    before = s.collection_manager._existing_log_manager("skp").get_latest_id()
    hsp.refresh_index("skp", "incremental")  # the source did not change: a no-op
    assert s.collection_manager._existing_log_manager("skp").get_latest_id() == before
    with pytest.raises(hs_torch.HyperspaceException, match="already exists"):
        hsp.create_index(_read(s, fmt, src), _skip_config(hs_torch))
    assert hsp.prefetch_index("skp") is False
    stats = hsp.index("skp")
    assert stats.state == "ACTIVE" and stats.kind == "DataSkippingIndex"


@pytest.mark.parametrize("bad", ["empty_name", "no_sketches", "duplicate", "not_a_sketch"])
def test_skipping_config_validation_matches(bad):
    msgs = {}
    for key, mod in PKGS.items():
        args = {"empty_name": ("", [mod.MinMaxSketch("a")]),
                "no_sketches": ("x", []),
                "duplicate": ("x", [mod.MinMaxSketch("a"), mod.MinMaxSketch("A")]),
                "not_a_sketch": ("x", ["a"])}[bad]
        with pytest.raises(mod.HyperspaceException) as e:
            mod.DataSkippingIndexConfig(*args)
        msgs[key] = str(e.value)
    assert msgs["torch"] == msgs["jax"]


# ---------------------------------------------------------------------------
# a corrupt sketch table leaves the scan unpruned in both packages
# ---------------------------------------------------------------------------
def _corrupt_bits(t, v):
    for per_file in t["files"].values():
        for key, data in per_file.items():
            if "BloomFilter" in key:
                data["bits"] = v(data["bits"])
    return t


def _corrupt_min(t):
    per_file = next(iter(t["files"].values()))
    for key, data in per_file.items():
        if "MinMax" in key:
            data["min"] = "x"
    return t


_CORRUPTIONS = {
    "bits_cut_to_8": lambda t: _corrupt_bits(t, lambda b: b[:8]),
    "bits_null": lambda t: _corrupt_bits(t, lambda b: None),
    "empty_list": lambda t: [],
    "no_files": lambda t: {"files": []},
    "minmax_min_string": _corrupt_min,
}


@pytest.mark.parametrize("corruption", sorted(_CORRUPTIONS))
def test_corrupt_sketch_table_returns_unindexed_rows(tmp_path, corruption):
    """One skipping index tree (a bloom filter on p, min/max on k) over 4
    avro files; after one edit of its sketches.json the rule must leave the
    scan unpruned and both packages return the unindexed rows."""
    src = tmp_path / "src"
    for i in range(4):
        k = np.arange(i * 1000, (i + 1) * 1000, dtype=np.int64)
        jax_avro.write_avro(src / f"part-{i}.avro", JaxBatch.from_pydict(
            {"k": k, "p": k % 97}, schema={"k": "int64", "p": "int64"}))
    tree = tmp_path / "ix"
    s = _session(hs_torch, tree)
    hs_torch.Hyperspace(s).create_index(s.read.avro(str(src)), hs_torch.DataSkippingIndexConfig(
        "sk", [hs_torch.BloomFilterSketch("p"), hs_torch.MinMaxSketch("k")]))
    sk = next((tree / "sk").glob("v__=0/sketches.json"))
    sk.write_text(json.dumps(_CORRUPTIONS[corruption](json.loads(sk.read_text()))))
    out = {}
    for key, mod in PKGS.items():
        s = _session(mod, tree)
        c = mod.col
        q = s.read.avro(str(src)).filter((c("p") == 7) & (c("k") < 2500)).select("k", "p")
        off = _rows(q.collect())
        s.enable_hyperspace()
        out[key] = _rows(q.collect())
        assert out[key] == off, key
    assert out["torch"] == out["jax"] and len(out["jax"][1]) == 26
