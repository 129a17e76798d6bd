"""Parity of the port's versioned-lake source with the JAX package on the
CPU. Mirrors test_versioned_lake.py: the table's log protocol, commit
conflicts, tombstones, version pinning and time travel, an index over a
table and its incremental refresh. Both packages index one table; their
log entries (times and index file names aside), index bytes and rows must
be equal, with the table mutated under the index and served through
Hybrid Scan too. The table's files are parquet, so this module needs
``pyarrow``.
Tolerance: exact.
"""

import json

import numpy as np
import pytest

pytest.importorskip("pyarrow")

import hyperspace_tpu as hs_jax  # noqa: E402
from hyperspace_tpu.sources import versioned_lake as jax_vlt  # noqa: E402
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch  # noqa: E402

import hyperspace_tpu_torch as hs_torch  # noqa: E402
from hyperspace_tpu_torch.sources import versioned_lake as torch_vlt  # noqa: E402
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TorchBatch  # noqa: E402

from tests.test_torch_lifecycle import (  # noqa: E402
    PKGS,
    _entry_json,
    _outcome,
    _rows,
    _session,
    _version_bytes,
)

VLT = {"jax": (jax_vlt, JaxBatch), "torch": (torch_vlt, TorchBatch)}


def _batch(Batch, keys, vals):
    return Batch.from_pydict(
        {"k": np.asarray(keys, dtype=np.int64), "v": np.asarray(vals, dtype=np.int64)},
        schema={"k": "int64", "v": "int64"},
    )


def _table(key, path):
    vlt, Batch = VLT[key]
    t = vlt.VersionedLakeTable.create(path)
    t.write(_batch(Batch, [1, 2, 3, 4], [10, 20, 30, 40]))
    t.write(_batch(Batch, [5, 6], [50, 60]))
    return t


def _commit_view(t, version):
    c = json.loads(t._commit_path(version).read_text())
    return c["version"], len(c["add"]), [a["size"] for a in c["add"]], c["remove"]


def test_table_log_protocol_matches(tmp_path):
    out = {}
    for key in PKGS:
        t = _table(key, tmp_path / key)
        res = [t.latest_version(), len(t.snapshot()), len(t.snapshot(1)), len(t.snapshot(0)),
               _outcome(lambda: t.snapshot(99)).replace(str(t.path), "<t>")]
        res += [_commit_view(t, v) for v in range(3)]
        v = t.latest_version()
        t._commit(v + 1, [], [])
        res.append(_outcome(lambda: t._commit(v + 1, [], [])).replace(str(t.path), "<t>"))
        name = t.snapshot()[0].name.rsplit("/", 1)[1]
        t.remove_files([name])
        res += [len(t.snapshot()), _outcome(lambda: t.remove_files(["nope.parquet"]))]
        out[key] = res
    assert out["jax"] == out["torch"]
    assert out["torch"][:4] == [2, 2, 1, 0] and "does not exist" in out["torch"][4]
    assert "ConcurrentModificationException" in out["torch"][8]
    assert out["torch"][9] == 1 and "not in the table" in out["torch"][10]


@pytest.mark.parametrize("written_by", ["jax", "torch"])
def test_relation_pins_version_and_time_travels(tmp_path, written_by):
    t = _table(written_by, tmp_path / "table")
    out = {}
    for key, mod in PKGS.items():
        s = _session(mod, tmp_path / f"ix_{key}")
        df = s.read.format("vlt").load(str(t.path))
        rel = df.plan.relation
        df1 = s.read.option("versionAsOf", "1").format("vlt").load(str(t.path))
        bad = _outcome(lambda: s.read.option("versionAsOf", "x").format("vlt").load(str(t.path)))
        out[key] = (dict(rel.options), rel.read_format, rel.file_format,
                    [(f.name, f.size) for f in rel.files], df1.count(), df.count(), bad)
    assert out["jax"] == out["torch"]
    assert out["torch"][0]["versionAsOf"] == "2" and out["torch"][1] == "parquet"
    assert out["torch"][4:6] == (4, 6)


def test_index_refresh_and_queries_on_vlt_match(tmp_path):
    """An index over a table serves point queries; after a write, an
    incremental refresh drops the version pin and indexes the new file."""
    t = _table("jax", tmp_path / "table")
    trees = {k: tmp_path / f"ix_{k}" for k in PKGS}

    def step():
        res = {}
        for key, mod in PKGS.items():
            s = _session(mod, trees[key])
            q = s.read.format("vlt").load(str(t.path)).filter(
                mod.col("k") >= 5).select("k", "v")
            off = _rows(q.collect())
            s.enable_hyperspace()
            on = _rows(q.collect())
            assert on == off, key
            stats = mod.Hyperspace(s).index("vlt_idx")
            res[key] = (on, stats.state, stats.source_files,
                        [_entry_json(e, trees[key]) for e in s.collection_manager.get_indexes()])
        assert res["jax"] == res["torch"]
        assert _version_bytes(trees["jax"], "vlt_idx") == _version_bytes(trees["torch"], "vlt_idx")
        return res["torch"]

    for key, mod in PKGS.items():
        s = _session(mod, trees[key])
        mod.Hyperspace(s).create_index(s.read.format("vlt").load(str(t.path)),
                                       mod.IndexConfig("vlt_idx", ["k"], ["v"]))
    rows, state, n_files, _ = step()
    assert state == "ACTIVE" and n_files == 2 and len(rows[1]) == 2
    t.write(_batch(JaxBatch, [7, 8], [70, 80]))
    for key, mod in PKGS.items():
        mod.Hyperspace(_session(mod, trees[key])).refresh_index("vlt_idx", "incremental")
    rows, _, n_files, _ = step()
    assert n_files == 3 and len(rows[1]) == 4


def test_hybrid_scan_on_vlt_appends_and_removes_matches(tmp_path):
    """test_versioned_lake.py:127: the table gains a file and loses its
    first one under an index with lineage; with hybrid scan on, both
    packages serve the index through the same hybrid plan (the appended
    file's Union, the removed file's lineage NOT IN) with the table's rows."""
    t = _table("jax", tmp_path / "table")
    trees = {k: tmp_path / f"ix_{k}" for k in PKGS}
    for key, mod in PKGS.items():
        s = _session(mod, trees[key], **{"hyperspace.index.lineage.enabled": True})
        mod.Hyperspace(s).create_index(s.read.format("vlt").load(str(t.path)),
                                       mod.IndexConfig("vlt_idx", ["k"], ["v"]))
    t.write(_batch(JaxBatch, [5, 9], [55, 90]))
    first = json.loads(t._commit_path(1).read_text())["add"][0]["path"]
    t.remove_files([first])  # drops keys 1-4, the version-1 write
    res = {}
    for key, mod in PKGS.items():
        # three small files: one appended and one removed are each about
        # half the bytes, so the caps are raised for the index to serve
        s = _session(mod, trees[key], **{"hyperspace.index.lineage.enabled": True,
                                         "hyperspace.index.hybridscan.enabled": True,
                                         "hyperspace.index.hybridscan.maxAppendedRatio": 0.6,
                                         "hyperspace.index.hybridscan.maxDeletedRatio": 0.6})
        out = []
        for k in (5, 1):
            q = s.read.format("vlt").load(str(t.path)).filter(
                mod.col("k") == k).select("k", "v")
            s.disable_hyperspace()
            off = _rows(q.collect())
            s.enable_hyperspace()
            on = _rows(q.collect())
            assert on == off, key
            out.append((on, q.optimized_plan().tree_string()))
        res[key] = out
    assert res["jax"] == res["torch"]
    (five, plan5), (one, _) = res["torch"]
    assert [r[1] for r in five[1]] == ["np.int64(50)", "np.int64(55)"] and one[1] == []
    assert "Union" in plan5 and "_data_file_id" in plan5 and "IndexScan" in plan5
