"""Parity of the port's runs layout with the JAX package on the CPU: the
streaming build's ``finalizeMode=runs`` files, the segment-read planner
(``plan_segment_reads`` / ``execute_segment_reads`` /
``read_run_coalesced``) and the executor's scan and join over a runs-layout
tree, K1's resident path included.

The JAX package builds the trees (avro sources, lineage on, several runs
per index); each tree is opened by the port through ``interop`` and served
by both packages, which must agree on the segment plans, on the rows, and
with the source scan. The port's own runs build of the same source must
equal the reference's byte for byte. Mirrors test_runs_layout.py and the
planner cases of test_compactor.py. Tolerance: exact.
"""

import re

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage import layout as jlayout
from hyperspace_tpu.storage.columnar import ColumnarBatch as JB

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.index.interop import open_index_tree
from hyperspace_tpu_torch.plan import ir as torch_ir
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB
from hyperspace_tpu_torch.storage import layout as tlayout
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

PKGS = {"jax": hs_jax, "torch": hs_torch}
N_BUCKETS = 8
_LI = {"k": "int64", "v": "int64", "q": "int32", "s": "string"}
_OD = {"ok": "int64", "c": "int64"}


@pytest.fixture(autouse=True)
def _hermetic_probe(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_PROBE_CACHE", "")
    monkeypatch.setenv("HYPERSPACE_TPU_TORCH_PROBE_CACHE", "")


def _conf(system_path, key, **over):
    c = {"hyperspace.system.path": str(system_path),
         "hyperspace.index.numBuckets": N_BUCKETS,
         "hyperspace.index.lineage.enabled": True,
         "hyperspace.index.build.mode": "streaming",
         "hyperspace.index.build.chunkRows": 1 << 12,
         "hyperspace.index.build.finalizeMode": "runs",
         "hyperspace.index.build.engine": "device",
         "hyperspace.index.build.device.runChunks": 2, **over}
    if key == "torch":
        c["hyperspace.torch.device"] = "cpu"
    return c


def _session(key, system_path, **over):
    mod = PKGS[key]
    return mod.HyperspaceSession(mod.HyperspaceConf(_conf(system_path, key, **over)))


def _write_sources(root, n=30000, n_files=3, seed=5):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 20000, n).astype(np.int64)
    li = {"k": keys, "v": rng.integers(0, 1000, n).astype(np.int64),
          "q": rng.integers(1, 51, n).astype(np.int32),
          "s": rng.choice(["aa", "bb", "cc"], n).astype(object)}
    per = n // n_files
    for i in range(n_files):
        jax_avro.write_avro(root / "li" / f"p{i}.avro", JB.from_pydict(
            {c: v[i * per:(i + 1) * per] for c, v in li.items()}, schema=_LI))
    ok = np.arange(0, 20000, 3, dtype=np.int64)
    jax_avro.write_avro(root / "od" / "o0.avro", JB.from_pydict(
        {"ok": ok, "c": (ok * 7) % 13}, schema=_OD))
    return root / "li", root / "od"


@pytest.fixture
def jax_tree(tmp_path):
    """Runs-layout indexes li (keys k) and od (keys ok) built by the JAX
    package."""
    li, od = _write_sources(tmp_path)
    tree = tmp_path / "ix"
    s = _session("jax", tree)
    hs = hs_jax.Hyperspace(s)
    hs.create_index(s.read.avro(str(li)), hs_jax.IndexConfig("li", ["k"], ["v", "q", "s"]))
    hs.create_index(s.read.avro(str(od)), hs_jax.IndexConfig("od", ["ok"], ["c"]))
    return tmp_path, li, od, tree


def _rows(batch):
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    return names, sorted(zip(*[[repr(v) for v in c] for c in cols]))


def _queries(key, s, li, od):
    mod = PKGS[key]
    col = mod.col
    L, O = s.read.avro(str(li)), s.read.avro(str(od))
    return {
        "point": L.filter(col("k") == 4242).select("k", "v", "s"),
        "in": L.filter(mod.is_in(col("k"), [7, 1007, 2011, 5003])).select("k", "q"),
        "range": L.filter((col("k") >= 300) & (col("k") < 9000) & (col("q") < 30))
        .select("k", "v", "q"),
        "join": L.filter(col("q") > 10).select("k", "v").join(
            O.select("ok", "c"), col("k") == col("ok")),
    }


def _serve(key, tree, li, od, enabled=True, **over):
    s = _session(key, tree, **over)
    s.enable_hyperspace() if enabled else s.disable_hyperspace()
    qs = _queries(key, s, li, od)
    out = {n: _rows(q.collect()) for n, q in qs.items()}
    if enabled and key == "torch":
        for n, q in qs.items():
            assert q.optimized_plan().collect(lambda x: isinstance(x, torch_ir.IndexScan)), n
    return out


def test_runs_build_matches_reference_bytes(tmp_path):
    """The port's streaming runs build of the same avro source writes the
    reference's run files, byte for byte (matched by run sequence), and
    each run's bucketCounts cover every row."""
    li, od = _write_sources(tmp_path)
    files = {}
    for key, mod in PKGS.items():
        s = _session(key, tmp_path / f"ix_{key}")
        mod.Hyperspace(s).create_index(s.read.avro(str(li)),
                                       mod.IndexConfig("li", ["k"], ["v", "q", "s"]))
        files[key] = {int(p.name[1:6]): p.read_bytes()
                      for p in (tmp_path / f"ix_{key}" / "li").glob("v__=0/*.tcb")}
    assert files["jax"] == files["torch"] and len(files["torch"]) > 2
    total = 0
    for p in (tmp_path / "ix_torch" / "li").glob("v__=0/*.tcb"):
        assert tlayout.is_run_file(p)
        offs = tlayout.run_offsets_checked(p)
        assert len(offs) == N_BUCKETS + 1
        total += int(offs[-1])
        assert tlayout.read_footer(p)["extra"]["indexName"] == "li"
    assert total == 30000


def test_segment_plans_and_reads_match_reference(jax_tree):
    """plan_segment_reads over the JAX-written runs, all buckets and a
    pinned set: the same sweeps, segments and merged ranges in both
    packages; executed planned or naive, every segment's rows equal the
    reference's and read_run_coalesced equals a whole-file read."""
    _root, _li, _od, tree = jax_tree
    entry = open_index_tree(tree)["li"]
    files = entry.content.files()
    assert files and all(tlayout.is_run_file(f) for f in files)
    for buckets, gap in ((None, tlayout.SEGMENT_COALESCE_GAP_ROWS), ({1, 5, 6}, 0), ({3}, 10)):
        jp = jlayout.plan_segment_reads(files, buckets, gap_rows=gap)
        tp = tlayout.plan_segment_reads(files, buckets, gap_rows=gap)
        assert [(s.path, s.segments, s.ranges) for s in jp] == \
            [(s.path, s.segments, s.ranges) for s in tp]
        want = jlayout.execute_segment_reads(jp, columns=["k", "s"], coalesce=True)
        for coalesce in (True, False):
            tmetrics.reset()
            got = tlayout.execute_segment_reads(tp, columns=["k", "s"], coalesce=coalesce,
                                                workers=2)
            assert sorted(got) == sorted(want)
            for key in want:
                for c in ("k", "s"):
                    assert np.array_equal(got[key].columns[c].to_values(),
                                          want[key].columns[c].to_values())
            assert tmetrics.get("io.segment.sweeps") == len(tp)
            n_segs = sum(len(s.segments) for s in tp)
            assert tmetrics.get("io.segment.ranges") + tmetrics.get(
                "io.segment.coalesced") == n_segs
    for f in files:
        whole = tlayout.read_batch(f)
        coalesced = tlayout.read_run_coalesced(f)
        for c in whole.column_names:
            assert np.array_equal(whole.columns[c].to_values(), coalesced.columns[c].to_values())


def test_scan_and_join_over_runs_match_reference(jax_tree):
    """Filters (a point lookup and an IN that pin buckets, a range that
    does not) and a bucketed join over the JAX-written runs tree: both
    packages return the source scan's rows, planned and naive segment IO
    alike; the port read pinned buckets as segments and joined per
    bucket."""
    _root, li, od, tree = jax_tree
    truth = _serve("jax", tree, li, od, enabled=False)
    assert _serve("jax", tree, li, od) == truth
    tmetrics.reset()
    assert _serve("torch", tree, li, od) == truth
    assert tmetrics.get("scan.run_bucket_segments") > 0
    assert tmetrics.get("io.segment.sweeps") > 0
    assert tmetrics.get("join.path.device_kernel") + tmetrics.get(
        "join.path.host_searchsorted") >= 1
    assert _serve("torch", tree, li, od, **{"hyperspace.storage.segmentIo": "naive"}) == truth
    from hyperspace_tpu_torch.storage import layout as tl

    tl.set_segment_io_default("planned")


def test_mixed_layout_and_resident_scan_over_runs(jax_tree):
    """After an incremental refresh the tree holds run files AND per-bucket
    files: both packages still agree with the source; the port's resident
    path (prefetch_index over run files, K1c's plain version on the CPU)
    returns the per-file result."""
    root, li, od, tree = jax_tree
    rng = np.random.default_rng(11)
    n = 900
    jax_avro.write_avro(li / "p9.avro", JB.from_pydict(
        {"k": rng.integers(20000, 21000, n).astype(np.int64),
         "v": rng.integers(0, 1000, n).astype(np.int64),
         "q": rng.integers(1, 51, n).astype(np.int32),
         "s": rng.choice(["aa", "dd"], n).astype(object)}, schema=_LI))
    # a small append builds in memory, as build.mode=auto would choose
    s = _session("jax", tree, **{"hyperspace.index.build.mode": "inmemory"})
    hs_jax.Hyperspace(s).refresh_index("li", "incremental")
    files = open_index_tree(tree)["li"].content.files()
    assert any(tlayout.is_run_file(f) for f in files)
    assert any(not tlayout.is_run_file(f) for f in files)
    truth = _serve("jax", tree, li, od, enabled=False)
    assert _serve("torch", tree, li, od) == truth
    ts = _session("torch", tree, **{"hyperspace.torch.hbm.mode": "force",
                                   "hyperspace.torch.hbm.maxBlockFrac": 1.0,
                                   "hyperspace.torch.hbm.minRows": 1})
    assert hs_torch.Hyperspace(ts).prefetch_index("li", ["k", "q"])
    ts.enable_hyperspace()
    tmetrics.reset()
    q = _queries("torch", ts, li, od)["range"]
    assert _rows(q.collect()) == truth["range"]
    assert tmetrics.get("scan.path.resident_device") == 1


def test_interop_opens_runs_trees_and_refuses_bad_run_footers(jax_tree, tmp_path):
    _root, _li, _od, tree = jax_tree
    assert set(open_index_tree(tree)) == {"li", "od"}
    bad = tmp_path / "bad" / "v__=0"
    name = tlayout.run_file_name(0)
    tlayout.write_batch(bad / name, TB.from_pydict({"k": np.arange(4, dtype=np.int64)}))
    with pytest.raises(hs_torch.HyperspaceException, match="bucketCounts"):
        tlayout.run_offsets_checked(bad / name)
    with pytest.raises(hs_torch.HyperspaceException, match="data file"):
        tlayout.bucket_of_file(bad / name)
    assert re.match(r"^r\d{5}-[0-9a-f]{12}\.tcb$", name)
    assert not tlayout.is_run_file("run-00000-abcdef12.tcb")
    assert tlayout.index_root_of(bad / name) == str(tmp_path / "bad")
    assert tlayout.index_root_of(tmp_path / name) is None
