"""The port's mesh-sharded residency (``hyperspace_tpu_torch/exec/
mesh_cache.py`` and the streaming tier's mesh twin) against the JAX
package's on the CPU. Mirrors ``tests/test_mesh_cache.py`` and the three
mesh cases of ``tests/test_residency.py``: bucket-per-shard placement,
resident filters with zero per-query upload, the per-query route where a
predicate does not narrow, first-touch population, the resident
aggregate, a runs-layout index prefetched through the public verb, f64
two-plane predicates, stale versions, LRU eviction, compressed shards, the
streaming rung's accounting, and batches against singles with
``window_gen``.

The reference runs on its 8-device virtual mesh with residency forced by
environment variables (``HYPERSPACE_TPU_HBM=force``,
``HYPERSPACE_TPU_HBM_MIN_ROWS=1``); the port on ``make_mesh(D,
device="cpu")`` with the same knobs as session conf, where K1c, K1p and
K1b run their plain versions. One index tree, built by the port, serves
both. Rows compare in exact order (the resident path's (path, row) order);
count matrices compare exactly where the largest shard holds more than
4,096 rows (below that the reference counts blocks of ``cap`` rows and the
port blocks of 8,192).
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.exec.mesh_cache import mesh_cache as jmc
from hyperspace_tpu.parallel.mesh import make_mesh as jax_mesh
from hyperspace_tpu.plan import aggregates as jaggs
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.config import ResidencyConf
from hyperspace_tpu_torch.exec.mesh_cache import mesh_cache as tmc
from hyperspace_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from hyperspace_tpu_torch.parallel.mesh import owner_of_bucket
from hyperspace_tpu_torch.plan import aggregates as taggs
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.storage import avro_io, layout
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_aggregate import assert_same

PKGS = {"jax": hs_jax, "torch": hs_torch}
EXPR = {"jax": jexpr, "torch": texpr}
AGGS = {"jax": jaggs, "torch": taggs}
FORCE = ResidencyConf(mode="force", min_rows=1)
TORCH_FORCE = {"hyperspace.torch.hbm.mode": "force", "hyperspace.torch.hbm.minRows": 1}


@pytest.fixture(autouse=True)
def _force_residency(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MIN_ROWS", "1")
    jmc.reset()
    tmc.reset()
    jmetrics.reset()
    tmetrics.reset()
    yield
    jmc.wait_background(timeout_s=30.0)
    tmc.wait_background()
    jmc.reset()
    tmc.reset()


def meshes(D):
    return jax_mesh(D), torch_mesh(D, device="cpu")


def sample(n=4000, seed=0, f64=False):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 500, n).astype(np.int64),
            "v": rng.integers(0, 10**6, n).astype(np.int64),
            "s": rng.choice(["aa", "bb", "cc", "dd"], n).astype(object)}
    schema = {"k": "int64", "v": "int64", "s": "string"}
    if f64:
        cols["d"] = np.round(rng.normal(0, 100.0, n), 3)
        schema["d"] = "float64"
    return TB.from_pydict(cols, schema)


class Tree:
    """An avro source of ``n_files`` files and its covering index ``name``
    (key ``k``, ``num_buckets`` buckets) built by the port; sessions of
    both packages on a mesh over it."""

    def __init__(self, root: Path, batch, name="mi", included=("v", "s"), num_buckets=16,
                 n_files=3, **conf):
        self.root, self.name = root, name
        self.src = root / "src"
        per = -(-batch.num_rows // n_files)
        for i in range(n_files):
            avro_io.write_avro(self.src / f"p-{i}.avro",
                               batch.take(np.arange(i * per, min((i + 1) * per, batch.num_rows))))
        self.conf = {"hyperspace.system.path": str(root / "indexes"),
                     "hyperspace.index.numBuckets": num_buckets,
                     "hyperspace.tpu.distributedQuery.minRows": 0, **conf}
        s = self.session("torch", None, **{"hyperspace.torch.hbm.mode": "off"})
        hs_torch.Hyperspace(s).create_index(self.read(s),
                                            hs_torch.IndexConfig(name, ["k"], list(included)))

    def session(self, pkg, mesh, **conf):
        values = dict(self.conf)
        if pkg == "torch":
            values.update({"hyperspace.torch.device": "cpu", **TORCH_FORCE})
        values.update(conf)
        s = PKGS[pkg].HyperspaceSession(PKGS[pkg].HyperspaceConf(values), mesh=mesh)
        s.enable_hyperspace()
        return s

    def read(self, s):
        return s.read.avro(str(self.src))

    def files(self):
        return sorted(str(p) for p in (self.root / "indexes" / self.name).glob("v__=*/*.tcb"))


def _counts_equal(j_table, t_table, jc, tc):
    """Count matrices equal where the reference also counts 8,192-row
    blocks (its largest shard over 4,096 rows), else the same candidate
    shards."""
    jc, tc = np.asarray(jc), np.asarray(tc)
    assert tc.shape[0] == jc.shape[0]
    if max(j_table.dev_rows) > 4096:
        assert t_table.cap == j_table.cap
        assert np.array_equal(tc, jc)
    else:
        assert [bool(x) for x in tc.any(axis=1)] == [bool(x) for x in jc.any(axis=1)]


def test_prefetch_builds_bucket_per_device_shards(tmp_path):
    t = Tree(tmp_path, sample())
    jm, tm = meshes(8)
    files = t.files()
    want = jmc.prefetch(files, ["k", "s"], jm)
    table = tmc.prefetch(files, ["k", "s"], tm, FORCE)
    assert table is not None and want is not None
    assert table.n_rows == want.n_rows == 4000 and table.n_devices == 8
    assert set(table.columns) == {"k", "s"} and table.columns["s"].enc == "string"
    assert table.dev_rows == want.dev_rows
    assert table.segments == [[tuple(s) for s in segs] for segs in want.segments]
    assert table.cap == max(want.cap, 8192)
    for d in range(8):
        for path, _lo, _hi, _off in table.segments[d]:
            assert owner_of_bucket(layout.bucket_of_file(path), 8) == d
    for name in ("k", "s"):
        for d in range(8):
            got = table.columns[name].data[d].numpy()
            ref = np.asarray(want.columns[name].data)[d]
            assert np.array_equal(got[: len(ref)], ref) and not got[len(ref):].any()
    assert tmc.prefetch(files, ["k"], tm, FORCE) is table  # idempotent


FILTERS = {
    "point": lambda E: E.col("k") == 42,
    "range": lambda E: (E.col("k") >= 50) & (E.col("k") < 220),
    "string": lambda E: (E.col("s") == "bb") & (E.col("k") < 400),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_resident_filter_parity_and_zero_h2d(tmp_path, name):
    t = Tree(tmp_path, sample(40_000, seed=2))
    jm, tm = meshes(4)
    out = {}
    for pkg, mesh in (("jax", jm), ("torch", tm)):
        s = t.session(pkg, mesh)
        assert PKGS[pkg].Hyperspace(s).prefetch_index(t.name, ["k", "s"])
        out[pkg] = t.read(s).filter(FILTERS[name](EXPR[pkg])).select("k", "v", "s").collect()
    assert_same(out["torch"], out["jax"])  # the resident path's exact order
    assert out["torch"].num_rows > 0
    assert tmetrics.get("scan.path.resident_device_mesh") == 1
    assert jmetrics.counter("scan.path.resident_device_mesh") == 1
    assert tmetrics.get("dist.h2d_bytes") == jmetrics.counter("dist.h2d_bytes") == 0
    # the count matrices of both caches' tables
    jt, tt = jmc._tables[0], tmc._tables[0]
    _counts_equal(jt, tt, jmc.block_counts(jt, FILTERS[name](jexpr)),
                  tmc.block_counts(tt, FILTERS[name](texpr)))
    single = t.read(t.session("torch", None, **{"hyperspace.torch.hbm.mode": "off"})).filter(
        FILTERS[name](texpr)).select("k", "v", "s").collect()
    assert_same(out["torch"], single, ordered=False, keys=["k", "v", "s"])


def test_unresolvable_predicate_routes_shipping_path(tmp_path):
    """An int64 literal past int32 does not narrow: the per-query route
    answers, its upload counted, the rows the reference's."""
    t = Tree(tmp_path, sample(seed=3))
    jm, tm = meshes(8)
    out = {}
    for pkg, mesh in (("jax", jm), ("torch", tm)):
        s = t.session(pkg, mesh)
        assert PKGS[pkg].Hyperspace(s).prefetch_index(t.name, ["k", "v"])
        E = EXPR[pkg]
        out[pkg] = t.read(s).filter((E.col("v") >= (1 << 40)) | (E.col("k") == 3)).select(
            "k", "v").collect()
    assert_same(out["torch"], out["jax"])
    assert tmetrics.get("dist.h2d_bytes") > 0 and jmetrics.counter("dist.h2d_bytes") > 0
    assert tmetrics.get("scan.path.resident_device_mesh") == 0


def test_first_touch_population_backgrounds(tmp_path):
    t = Tree(tmp_path, sample(seed=4))
    _, tm = meshes(8)
    s = t.session("torch", tm)
    q = t.read(s).filter(texpr.col("k") == 11).select("k", "v")
    first = q.collect()  # a miss schedules the population
    tmc.wait_background()
    assert tmc.snapshot()["tables"] == 1
    assert tmetrics.get("scan.path.distributed") == 1
    second = q.collect()
    assert tmetrics.get("scan.path.resident_device_mesh") == 1
    assert_same(second, first, ordered=False, keys=["k", "v"])
    # the reference populates the same way
    jm, _ = meshes(8)
    js = t.session("jax", jm)
    js_q = t.read(js).filter(jexpr.col("k") == 11).select("k", "v")
    js_q.collect()
    jmc.wait_background(timeout_s=30.0)
    assert_same(second, js_q.collect())


def test_resident_aggregate_reads_matching_blocks_only(tmp_path):
    """The interpreter's resident arm (compile off: the compiled pipeline
    would aggregate on the card)."""
    t = Tree(tmp_path, sample(seed=5))
    jm, tm = meshes(8)
    out = {}
    for pkg, mesh in (("jax", jm), ("torch", tm)):
        s = t.session(pkg, mesh, **{"hyperspace.compile.mode": "off"})
        assert PKGS[pkg].Hyperspace(s).prefetch_index(t.name, ["k"])
        A, E = AGGS[pkg], EXPR[pkg]
        out[pkg] = t.read(s).filter(E.col("k") < 100).group_by("s").agg(
            A.agg_sum("v", "sv"), A.agg_count()).collect()
    assert_same(out["torch"], out["jax"])
    for c in ("aggregate.path.resident_mesh", "scan.path.resident_device_mesh"):
        assert tmetrics.get(c) == jmetrics.counter(c) == 1, c
    assert tmetrics.get("dist.h2d_bytes") == 0


def test_session_runs_layout_facade_prefetch(tmp_path):
    """A runs-layout index (finalizeMode=runs): ``prefetch_index`` on a
    mesh session fills the MESH cache, run files shard by their footers'
    bucket ranges, and the repeat query is resident, as the reference's."""
    rng = np.random.default_rng(6)
    n = 20_000
    batch = TB.from_pydict({"k": rng.integers(0, 800, n).astype(np.int64),
                            "v": rng.integers(0, 10**6, n).astype(np.int64)})
    t = Tree(tmp_path, batch, name="runs_i", included=("v",), n_files=1,
             **{"hyperspace.index.build.mode": "streaming",
                "hyperspace.index.build.chunkRows": 1 << 12,
                "hyperspace.index.build.finalizeMode": "runs"})
    assert any(layout.is_run_file(f) for f in t.files())
    jm, tm = meshes(8)
    out = {}
    for pkg, mesh in (("jax", jm), ("torch", tm)):
        s = t.session(pkg, mesh)
        assert PKGS[pkg].Hyperspace(s).prefetch_index("runs_i", ["k"])
        E = EXPR[pkg]
        out[pkg] = t.read(s).filter((E.col("k") >= 100) & (E.col("k") < 140)).select(
            "k", "v").collect()
    assert tmc.snapshot()["tables"] == 1
    assert tmc._tables[0].segments == [[tuple(x) for x in segs]
                                       for segs in jmc._tables[0].segments]
    assert_same(out["torch"], out["jax"])
    assert out["torch"].num_rows > 0
    assert tmetrics.get("scan.path.resident_device_mesh") == 1
    assert tmetrics.get("dist.h2d_bytes") == 0


def test_mesh_f64_two_plane_resident_parity(tmp_path):
    t = Tree(tmp_path, sample(40_000, seed=12, f64=True), included=("d", "v"))
    jm, tm = meshes(4)
    out = {}
    for pkg, mesh in (("jax", jm), ("torch", tm)):
        s = t.session(pkg, mesh)
        assert PKGS[pkg].Hyperspace(s).prefetch_index(t.name, ["k", "d"])
        E = EXPR[pkg]
        out[pkg] = t.read(s).filter((E.col("d") >= -50.0) & (E.col("d") < 75.25)
                                    & (E.col("k") < 400)).select("k", "d", "v").collect()
    assert tmc._tables[0].columns["d"].enc == "f64"
    assert_same(out["torch"], out["jax"])
    assert out["torch"].num_rows > 0
    assert tmetrics.get("scan.path.resident_device_mesh") == 1
    assert tmetrics.get("dist.h2d_bytes") == 0


def test_stale_version_never_matches(tmp_path):
    t = Tree(tmp_path, sample(seed=7))
    _, tm = meshes(8)
    files = t.files()
    assert tmc.prefetch(files, ["k"], tm, FORCE)
    st = os.stat(files[0])
    os.utime(files[0], ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert tmc.resident_for([Path(f) for f in files], ["k"], tm, FORCE) is None


def test_budget_eviction_lru(tmp_path):
    ta = Tree(tmp_path / "a", sample(2000, seed=8), name="m1")
    tb = Tree(tmp_path / "b", sample(2000, seed=9), name="m2")
    _, tm = meshes(8)
    # 8 shards x 8192 rows x 4 B = 256 KiB a plane: a 1 MB budget holds
    # one table of two planes... and three of one plane, so key + s
    t1 = tmc.prefetch(ta.files(), ["k", "s"], tm, FORCE)
    assert t1 is not None
    conf = ResidencyConf(mode="force", min_rows=1, budget_mb=1, compression="off",
                         streaming="off")
    t2 = tmc.prefetch(tb.files(), ["k", "v"], tm, conf)
    assert t2 is not None
    assert tmc.snapshot()["tables"] == 1  # LRU evicted t1
    assert tmc.resident_for(tb.files(), ["k"], tm, conf) is t2
    assert tmetrics.get("hbm.mesh.evicted") == 1


# ---------------------------------------------------------------------------
# the ladder: compressed shards, the streaming rung
# ---------------------------------------------------------------------------
def test_mesh_compressed_parity(tmp_path, monkeypatch):
    """An offset domain: the one pack spec's frame comes from the real
    rows, not the zero-padded shards."""
    rng = np.random.default_rng(3)
    base = 1_000_000
    batch = TB.from_pydict({"k": (base + rng.integers(0, 500, 40_000)).astype(np.int64),
                            "v": rng.integers(0, 10**6, 40_000).astype(np.int64)})
    t = Tree(tmp_path, batch, name="mc", included=("v",))
    files = t.files()
    jm, tm = meshes(8)
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_COMPRESSION", "force")
    conf = ResidencyConf(mode="force", min_rows=1, compression="force")
    want = jmc.prefetch(files, ["k"], jm)
    table = tmc.prefetch(files, ["k"], tm, conf)
    assert table.tier == want.tier == "compressed"
    assert dataclasses.astuple(table.columns["k"].pack) == dataclasses.astuple(
        want.columns["k"].pack)
    assert table.columns["k"].pack.ref0 >= base
    assert tmetrics.get("residency.tier.compressed_built") == 1
    pred = {"jax": jexpr.col("k") == base + 123, "torch": texpr.col("k") == base + 123}
    counts = tmc.block_counts(table, pred["torch"])
    _counts_equal(want, table, jmc.block_counts(want, pred["jax"]), counts)
    tmc.reset()
    raw = tmc.prefetch(files, ["k"], tm, ResidencyConf(mode="force", min_rows=1,
                                                       compression="off"))
    assert raw.tier == "resident"
    assert np.array_equal(counts, tmc.block_counts(raw, pred["torch"]))


def _streaming_tree(tmp_path, n, top, name, seed):
    rng = np.random.default_rng(seed)
    batch = TB.from_pydict({"k": rng.integers(0, top, n).astype(np.int64),
                            "v": rng.integers(0, 1 << 30, n).astype(np.int64)})
    return Tree(tmp_path, batch, name=name, included=("v",), n_files=2)


def test_mesh_streaming_rung_parity_and_accounting(tmp_path, monkeypatch):
    t = _streaming_tree(tmp_path, 400_000, 5000, "ms", 9)
    files = t.files()
    jm, tm = meshes(8)
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_BUDGET_MB", "1")
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_WINDOW_ROWS", "8192")
    conf = ResidencyConf(mode="force", min_rows=1, budget_mb=1, window_rows=8192)
    want = jmc.prefetch(files, ["k", "v"], jm)
    table = tmc.prefetch(files, ["k", "v"], tm, conf)
    assert table is not None and table.tier == want.tier == "streaming"
    snap = tmc.snapshot_residency()
    assert snap["by_tier"] == {"streaming": 1}
    row = snap["tables"][0]
    assert row["windows"] == table.n_windows >= 2
    assert row["mb"] < row["host_mb"]  # the slab charge, not the table
    assert tmetrics.get("hbm.mesh.residency.streaming_declined") == 0
    tmetrics.reset()
    pred = {pkg: (E.col("k") >= 1000) & (E.col("k") <= 1500) for pkg, E in EXPR.items()}
    counts = tmc.block_counts(table, pred["torch"])
    assert tmetrics.get("residency.stream.windows") == row["windows"]
    assert tmetrics.get("residency.stream.h2d_bytes") > 0
    want_counts = np.asarray(jmc.block_counts(want, pred["jax"]))
    assert np.array_equal(counts, want_counts)
    # against the raw mesh table (a big budget)
    tmc.reset()
    raw = tmc.prefetch(files, ["k", "v"], tm, FORCE)
    assert raw.tier == "resident"
    raw_counts = tmc.block_counts(raw, pred["torch"])
    nc = raw_counts.shape[1]
    assert np.array_equal(counts[:, :nc], raw_counts) and counts[:, nc:].sum() == 0
    # a genuine decline: the slab pairs themselves over the budget
    tmc.reset()
    tmetrics.reset()
    zero = ResidencyConf(mode="force", min_rows=1, budget_mb=0, window_rows=8192)
    assert tmc.prefetch(files, ["k", "v"], tm, zero) is None
    assert tmetrics.get("hbm.mesh.residency.streaming_declined") == 1
    assert tmetrics.get("hbm.mesh.over_budget_refused") >= 1
    # streaming off: a knob refusal, never counted as a decline
    tmetrics.reset()
    off = ResidencyConf(mode="force", min_rows=1, budget_mb=1, streaming="off",
                        compression="off")
    assert tmc.prefetch(files, ["k", "v"], tm, off) is None
    assert tmetrics.get("hbm.mesh.residency.streaming_declined") == 0
    assert tmetrics.get("hbm.mesh.over_budget_refused") >= 1


def test_mesh_streaming_batch_and_window_generation(tmp_path, monkeypatch):
    t = _streaming_tree(tmp_path, 300_000, 3000, "msb", 10)
    _, tm = meshes(8)
    conf = ResidencyConf(mode="force", min_rows=1, budget_mb=1, window_rows=8192)
    table = tmc.prefetch(t.files(), ["k", "v"], tm, conf)
    assert table is not None and table.tier == "streaming"
    preds = [texpr.col("k") == 77, (texpr.col("k") >= 100) & (texpr.col("k") <= 200)]
    singles = [tmc.block_counts(table, p) for p in preds]
    tmetrics.reset()
    stacked = tmc.block_counts_batch(table, preds)
    assert tmetrics.get("serve.batch.dispatches") == 1
    assert tmetrics.get("residency.stream.windows") == table.n_windows
    for s, b in zip(singles, stacked):
        assert np.array_equal(s, b)
    # a window failure bumps the generation the batcher's key folds
    from hyperspace_tpu_torch.residency import streaming as tstream

    def lost(plane, w, W):
        raise RuntimeError("device lost mid-window")

    gen0 = table.window_gen
    monkeypatch.setattr(tstream, "_window_slice", lost)
    with pytest.raises(RuntimeError):
        tmc.block_counts(table, preds[0])
    assert table.window_gen == gen0 + 1
    assert tmetrics.get("residency.stream.window_failed") == 1
