"""End-to-end parity of the PyTorch port against the JAX package on the CPU.

Both packages create covering indexes over the same small avro and parquet
sources (8 buckets), then answer the same filter and join queries. The
index files must be byte-identical, the log entries equal apart from ids,
timestamps and file locations, and every query's rows equal. Each package
also serves the index tree the other one built. Tolerance: exact.
"""

from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage import parquet_io as jax_parquet
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TorchBatch
from hyperspace_tpu_torch.index.interop import open_index_tree
from hyperspace_tpu_torch.ops import launch_counts, reset_launch_counts
from hyperspace_tpu_torch.storage import avro_io as torch_avro
from hyperspace_tpu_torch.telemetry.metrics import metrics

N_BUCKETS = 8


def _lineitem(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "l_orderkey": rng.integers(1, n // 3, n).astype(np.int64),
        "l_partkey": rng.integers(0, 200, n).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n).astype(np.int64),
        "l_price": (rng.random(n) * 1000).round(2),
        "l_disc": rng.random(n).astype(np.float32),
        "l_flag": rng.choice(["A", "N", "R"], n).astype(object),
    }


def _orders(n=1000, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "o_orderkey": (rng.permutation(n) + 1).astype(np.int64),
        "o_custkey": rng.integers(0, 150, n).astype(np.int64),
        "o_total": (rng.random(n) * 9000).round(2),
        "o_status": rng.choice(["O", "F", "P"], n).astype(object),
    }


_SCHEMAS = {
    "lineitem": {
        "l_orderkey": "int64", "l_partkey": "int64", "l_quantity": "int64",
        "l_price": "float64", "l_disc": "float32", "l_flag": "string",
    },
    "orders": {
        "o_orderkey": "int64", "o_custkey": "int64", "o_total": "float64",
        "o_status": "string",
    },
}


def _write_sources(root: Path, fmt: str):
    """Two files per table, written with the reference's writers."""
    paths = {}
    for name, data in (("lineitem", _lineitem()), ("orders", _orders())):
        d = root / fmt / name
        n = len(next(iter(data.values())))
        for i, (s, e) in enumerate(((0, n // 2), (n // 2, n))):
            part = JaxBatch.from_pydict(
                {k: v[s:e] for k, v in data.items()}, schema=_SCHEMAS[name]
            )
            f = d / f"part-{i}.{fmt}"
            if fmt == "avro":
                jax_avro.write_avro(f, part)
            else:
                jax_parquet.write_parquet(f, part)
        paths[name] = str(d)
    return paths


def _sessions(tmp_path, fmt):
    paths = _write_sources(tmp_path / "src", fmt)
    jconf = hs_jax.HyperspaceConf(
        {"hyperspace.system.path": str(tmp_path / "ix_jax"),
         "hyperspace.index.numBuckets": N_BUCKETS}
    )
    tconf = hs_torch.HyperspaceConf(
        {"hyperspace.system.path": str(tmp_path / "ix_torch"),
         "hyperspace.index.numBuckets": N_BUCKETS,
         "hyperspace.torch.device": "cpu"}
    )
    js = hs_jax.HyperspaceSession(jconf)
    ts = hs_torch.HyperspaceSession(tconf)
    return paths, js, ts


def _create(session, mod, paths, fmt):
    hs = mod.Hyperspace(session)
    read = getattr(session.read, fmt)
    hs.create_index(
        read(paths["lineitem"]),
        mod.IndexConfig("li_idx", ["l_orderkey"],
                        ["l_partkey", "l_quantity", "l_price", "l_disc", "l_flag"]),
    )
    hs.create_index(
        read(paths["orders"]),
        mod.IndexConfig("ord_idx", ["o_orderkey"], ["o_custkey", "o_total", "o_status"]),
    )


def _queries(session, mod, paths, fmt):
    col = mod.col
    read = getattr(session.read, fmt)
    li = read(paths["lineitem"])
    od = read(paths["orders"])
    return {
        "point": li.filter(col("l_orderkey") == 17).select("l_orderkey", "l_quantity", "l_flag"),
        "range": li.filter(
            (col("l_orderkey") >= 100) & (col("l_orderkey") < 400)
            & (col("l_quantity") < 24) & ~(col("l_flag") == "N")
        ).select("l_orderkey", "l_quantity", "l_price"),
        "in_f32": li.filter(
            mod.is_in(col("l_orderkey"), [3, 5, 8, 13, 21]) | (col("l_disc") > 0.99)
        ).select("l_orderkey", "l_disc"),
        "join": li.filter(col("l_quantity") > 10)
        .select("l_orderkey", "l_quantity", "l_price")
        .join(
            od.filter(col("o_status") != "F").select("o_orderkey", "o_total"),
            col("l_orderkey") == col("o_orderkey"),
        ),
    }


def _rows(batch):
    """Order-free row set: columns by name, rows sorted lexicographically."""
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    rows = sorted(zip(*[[repr(v) for v in c] for c in cols]))
    return names, rows


def _bucket_bytes(system_path: Path, index: str):
    out = {}
    for f in (system_path / index).glob("v__=*/*.tcb"):
        out[int(f.name[1:].split("-")[0])] = f.read_bytes()
    return out


def _entry_view(e):
    d = e.derived_dataset
    rel = e.source.relations[0]
    return (
        e.name, e.state, list(d.indexed_columns), list(d.included_columns),
        dict(d.schema), d.num_buckets, dict(d.properties),
        e.signature().provider, e.signature().value,
        list(rel.root_paths), dict(rel.schema), rel.file_format, dict(rel.options),
        sorted((f.name, f.size) for f in e.source_file_infos()),
        len(e.content.files()),
    )


@pytest.mark.parametrize("fmt", ["avro", "parquet"])
def test_index_bytes_entries_and_queries_match(tmp_path, fmt):
    paths, js, ts = _sessions(tmp_path, fmt)
    _create(js, hs_jax, paths, fmt)
    _create(ts, hs_torch, paths, fmt)
    for idx in ("li_idx", "ord_idx"):
        jb = _bucket_bytes(tmp_path / "ix_jax", idx)
        tb = _bucket_bytes(tmp_path / "ix_torch", idx)
        assert sorted(jb) == sorted(tb) and len(jb) > 1
        for b in jb:
            assert jb[b] == tb[b], f"{idx} bucket {b} differs"
    jentries = {e.name: e for e in js.collection_manager.get_indexes()}
    tentries = {e.name: e for e in ts.collection_manager.get_indexes()}
    for name in ("li_idx", "ord_idx"):
        assert _entry_view(jentries[name]) == _entry_view(tentries[name])

    js.enable_hyperspace()
    ts.enable_hyperspace()
    jq = _queries(js, hs_jax, paths, fmt)
    tq = _queries(ts, hs_torch, paths, fmt)
    metrics.reset()
    reset_launch_counts()
    for name in jq:
        j, t = jq[name].collect(), tq[name].collect()
        assert _rows(j) == _rows(t), name
        assert t.num_rows > 0, name
        assert "IndexScan Hyperspace(Type: CI" in tq[name].explain(), name
    # on the CPU the kernels' plain versions ran: no kernel launched
    assert launch_counts() == {}
    assert metrics.get("scan.path.kernel_mask") > 0
    assert metrics.get("join.path.device_kernel") == 1


@pytest.mark.parametrize("fmt", ["avro", "parquet"])
def test_each_package_serves_the_others_index_tree(tmp_path, fmt):
    paths, js, ts = _sessions(tmp_path, fmt)
    _create(js, hs_jax, paths, fmt)
    _create(ts, hs_torch, paths, fmt)
    tree = open_index_tree(tmp_path / "ix_jax")
    assert sorted(tree) == ["li_idx", "ord_idx"]

    # the port over the JAX-built tree, the JAX package over the port's
    ts_on_jax = hs_torch.HyperspaceSession(hs_torch.HyperspaceConf(
        {"hyperspace.system.path": str(tmp_path / "ix_jax"),
         "hyperspace.torch.device": "cpu"})).enable_hyperspace()
    js_on_torch = hs_jax.HyperspaceSession(hs_jax.HyperspaceConf(
        {"hyperspace.system.path": str(tmp_path / "ix_torch")})).enable_hyperspace()
    js.enable_hyperspace()
    base = _queries(js, hs_jax, paths, fmt)
    cross_t = _queries(ts_on_jax, hs_torch, paths, fmt)
    cross_j = _queries(js_on_torch, hs_jax, paths, fmt)
    for name in base:
        want = _rows(base[name].collect())
        assert _rows(cross_t[name].collect()) == want, name
        assert _rows(cross_j[name].collect()) == want, name
        assert "IndexScan Hyperspace" in cross_t[name].explain()


def test_unindexed_results_match_plain_scan(tmp_path):
    """With Hyperspace disabled the port scans the source; rows equal the
    indexed answer."""
    paths, _js, ts = _sessions(tmp_path, "avro")
    _create(ts, hs_torch, paths, "avro")
    off = {k: _rows(v.collect()) for k, v in _queries(ts, hs_torch, paths, "avro").items()}
    ts.enable_hyperspace()
    on = {k: _rows(v.collect()) for k, v in _queries(ts, hs_torch, paths, "avro").items()}
    assert off == on


def test_avro_reader_matches_reference(tmp_path):
    """The port's avro reader equals the reference's, on the reference's
    single-block files (per-value decode) and on the port's multi-block
    files (numpy decode)."""
    data = _lineitem(5000, seed=3)
    data["l_flag_ok"] = data.pop("l_flag") != "N"
    data["l_neg"] = -np.arange(5000, dtype=np.int64) * 7919 - 2**40
    schema = dict(_SCHEMAS["lineitem"])
    schema.pop("l_flag")
    schema.update({"l_flag_ok": "bool", "l_neg": "int64"})
    batch = JaxBatch.from_pydict(data, schema=schema)
    ref_file = tmp_path / "ref.avro"
    jax_avro.write_avro(ref_file, batch)
    port_file = tmp_path / "port.avro"
    torch_avro.write_avro(
        port_file,
        TorchBatch.from_pydict(data, schema=schema),
    )
    assert port_file.read_bytes() != ref_file.read_bytes()  # multi-block
    for f in (ref_file, port_file):
        want = jax_avro.read_avro([f])
        got = torch_avro.read_avro([f])
        assert got.schema() == want.schema()
        for n in want.column_names:
            assert got.columns[n].data.dtype == want.columns[n].data.dtype
            assert np.array_equal(
                got.columns[n].data.view(np.uint8), want.columns[n].data.view(np.uint8)
            ), n


def _date_source(root: Path, n_files: int = 1, n: int = 3000) -> Path:
    """Avro files written by the port with a ``date``-annotated int column
    (the reference's writer has no date type)."""
    rng = np.random.default_rng(9)
    days = rng.integers(-5, 9000, n).astype(np.int32)
    data = {"d": days, "k": rng.integers(1, n // 4, n).astype(np.int64),
            "v": rng.integers(0, 99, n).astype(np.int64)}
    root.mkdir(parents=True, exist_ok=True)
    bounds = np.linspace(0, n, n_files + 1).astype(int)
    for i, (s, e) in enumerate(zip(bounds[:-1], bounds[1:])):
        part = TorchBatch.from_pydict({c: a[s:e] for c, a in data.items()},
                                      schema={"d": "date32", "k": "int64", "v": "int64"})
        torch_avro.write_avro(root / f"part-{i}.avro", part)
    return root


def test_avro_date_logical_type_round_trips(tmp_path):
    """A ``date``-annotated avro int reads as the reference reads it: the
    same schema (int64), dtype and bytes, from the numpy multi-block
    decoder and from the per-value one."""
    src = _date_source(tmp_path / "src")
    f = src / "part-0.avro"
    assert torch_avro.infer_schema(f) == jax_avro.infer_schema(f) == {
        "d": "int64", "k": "int64", "v": "int64"}
    small = tmp_path / "small.avro"  # one block: the per-value decoder
    torch_avro.write_avro(small, TorchBatch.from_pydict(
        {"d": np.array([-3, 0, 18000], dtype=np.int32)}, schema={"d": "date32"}))
    for path in (f, small):
        want, got = jax_avro.read_avro([path]), torch_avro.read_avro([path])
        assert got.schema() == want.schema()
        for n in want.column_names:
            assert got.columns[n].data.dtype == want.columns[n].data.dtype == np.int64
            assert got.columns[n].data.tobytes() == want.columns[n].data.tobytes(), n
    days = torch_avro.read_avro([small]).columns["d"].data
    assert days.tolist() == [-3, 0, 18000]


def test_index_over_avro_date_column_matches_reference(tmp_path):
    """An index whose key and included columns come from a date-annotated
    avro column: equal log-entry schema and equal TCB bytes in both
    packages."""
    src = str(_date_source(tmp_path / "src", n_files=2))
    conf = {"hyperspace.index.numBuckets": N_BUCKETS}
    js = hs_jax.HyperspaceSession(hs_jax.HyperspaceConf(
        dict(conf, **{"hyperspace.system.path": str(tmp_path / "ix_jax")})))
    ts = hs_torch.HyperspaceSession(hs_torch.HyperspaceConf(
        dict(conf, **{"hyperspace.system.path": str(tmp_path / "ix_torch"),
                      "hyperspace.torch.device": "cpu"})))
    for sess, mod in ((js, hs_jax), (ts, hs_torch)):
        mod.Hyperspace(sess).create_index(
            sess.read.avro(src), mod.IndexConfig("d_idx", ["d"], ["k", "v"]))
    jb = _bucket_bytes(tmp_path / "ix_jax", "d_idx")
    tb = _bucket_bytes(tmp_path / "ix_torch", "d_idx")
    assert sorted(jb) == sorted(tb) and len(jb) > 1
    assert all(jb[b] == tb[b] for b in jb)
    je = js.collection_manager.get_indexes()[0]
    te = ts.collection_manager.get_indexes()[0]
    assert dict(te.derived_dataset.schema) == dict(je.derived_dataset.schema)
    assert dict(te.derived_dataset.schema)["d"] == "int64"
    assert _entry_view(je) == _entry_view(te)


def test_streaming_build_mode_is_refused(tmp_path):
    """An unknown build mode is refused before any log entry is written;
    ``streaming``, once refused here, now builds the reference's bytes
    (tests/test_torch_stream_build.py holds the streaming build itself)."""
    paths, js, ts = _sessions(tmp_path, "avro")
    ts.conf.set("hyperspace.index.build.mode", "bogus")
    with pytest.raises(hs_torch.HyperspaceException, match="Unknown build mode"):
        hs_torch.Hyperspace(ts).create_index(
            ts.read.avro(paths["orders"]),
            hs_torch.IndexConfig("o", ["o_orderkey"], ["o_total"]),
        )
    assert not (tmp_path / "ix_torch" / "o").exists()
    for sess, mod in ((js, hs_jax), (ts, hs_torch)):
        sess.conf.set("hyperspace.index.build.mode", "streaming")
        sess.conf.set("hyperspace.index.build.chunkRows", 1024)
        mod.Hyperspace(sess).create_index(
            sess.read.avro(paths["orders"]),
            mod.IndexConfig("o", ["o_orderkey"], ["o_total"]),
        )
    jb, tb = _bucket_bytes(tmp_path / "ix_jax", "o"), _bucket_bytes(tmp_path / "ix_torch", "o")
    assert jb == tb and len(tb) > 1
