"""The mesh's resident routes end to end, the port against the JAX
package on the CPU: the mesh hybrid (base and delta shards, K1h once a
shard, zero per-query upload; mirrors ``tests/test_delta_residency.py:
437``), the mesh join region (K2 or K2p once a shard, the partials merged
by ``all_reduce``, zero per-query upload; ``tests/test_join_residency.py:
698``), the compiled mesh scan and device aggregate
(``tests/test_device_agg.py:445`` onward), the batcher's mesh arm (one
dispatch, one K1b a shard, rows equal to the singles), a shard's launch
lost (the table dropped, the per-query mesh route answering), and a
5-seed resident mesh fuzz over filters, aggregates, aggregate-joins and
hybrids.

The reference runs on its 8-device virtual mesh with residency forced by
environment variables; the port on ``make_mesh(D, device="cpu")`` with
``hyperspace.torch.hbm.mode=force``, its kernels' plain versions serving.
Rows compare in exact order where both packages take the same route,
groups in the ascending key order both finishes give; integers exact,
floats ``rtol=1e-9``.
"""

from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.compile.cache import pipeline_cache as j_pipelines
from hyperspace_tpu.exec.mesh_cache import mesh_cache as jmc
from hyperspace_tpu.parallel.mesh import make_mesh as jax_mesh
from hyperspace_tpu.plan import aggregates as jaggs
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.serve import server as jserve
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.compile.cache import pipeline_cache as t_pipelines
from hyperspace_tpu_torch.exec import executor as texec
from hyperspace_tpu_torch.exec import joins as tjoins
from hyperspace_tpu_torch.exec.mesh_cache import mesh_cache as tmc
from hyperspace_tpu_torch.ops import kernels as K
from hyperspace_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from hyperspace_tpu_torch.plan import aggregates as taggs
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.serve import server as tserve
from hyperspace_tpu_torch.storage import avro_io
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_aggregate import assert_same

PKGS = {"jax": hs_jax, "torch": hs_torch}
EXPR = {"jax": jexpr, "torch": texpr}
AGGS = {"jax": jaggs, "torch": taggs}


@pytest.fixture(autouse=True)
def _force_residency(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MIN_ROWS", "1")
    for reset in (jmc.reset, tmc.reset, jmetrics.reset, tmetrics.reset, j_pipelines.reset,
                  t_pipelines.reset, texec.reset_groups_cache, tjoins.reset_setup_cache):
        reset()
    yield
    jmc.wait_background(timeout_s=30.0)
    tmc.wait_background()
    jmc.reset()
    tmc.reset()


def _count(pkg, name):
    return jmetrics.counter(name) if pkg == "jax" else tmetrics.get(name)


def meshes(D):
    return {"jax": jax_mesh(D), "torch": torch_mesh(D, device="cpu")}


def wait_both():
    jmc.wait_background(timeout_s=60.0)
    tmc.wait_background()


class Tree:
    """Avro sources ``li`` (3 files) and ``od`` (2 files) and their covering
    indexes ``li_idx`` (key l_k) and ``od_idx`` (key o_k, unique), built by
    the port; sessions of both packages on a mesh over them, residency
    forced."""

    def __init__(self, root: Path, n_l=24_000, n_o=600, seed=7, num_buckets=16, **conf):
        rng = np.random.default_rng(seed)
        self.li = TB.from_pydict({
            "l_k": rng.integers(0, n_o, n_l).astype(np.int64),
            "l_g": rng.integers(0, 40, n_l).astype(np.int64),
            "l_q": rng.integers(-(1 << 20), 1 << 20, n_l).astype(np.int64),
            "l_p": np.round(rng.uniform(1, 1000, n_l), 2),
            "l_s": rng.choice(["A", "N", "R"], n_l).astype(object),
        }, {"l_k": "int64", "l_g": "int64", "l_q": "int64", "l_p": "float64",
            "l_s": "string"})
        self.od = TB.from_pydict({
            "o_k": rng.permutation(n_o).astype(np.int64),
            "o_t": np.round(rng.uniform(0, 9000, n_o), 2),
        }, {"o_k": "int64", "o_t": "float64"})
        self.root = root
        for name, batch, parts in (("li", self.li, 3), ("od", self.od, 2)):
            per = -(-batch.num_rows // parts)
            for i in range(parts):
                avro_io.write_avro(root / name / f"p-{i}.avro", batch.take(
                    np.arange(i * per, min((i + 1) * per, batch.num_rows))))
        self.conf = {"hyperspace.system.path": str(root / "indexes"),
                     "hyperspace.index.numBuckets": num_buckets,
                     "hyperspace.tpu.distributedQuery.minRows": 0, **conf}
        s = self.session("torch", None, **{"hyperspace.torch.hbm.mode": "off"})
        h = hs_torch.Hyperspace(s)
        h.create_index(self.read(s, "li"), hs_torch.IndexConfig(
            "li_idx", ["l_k"], ["l_g", "l_q", "l_p", "l_s"]))
        h.create_index(self.read(s, "od"), hs_torch.IndexConfig("od_idx", ["o_k"], ["o_t"]))

    def session(self, pkg, mesh, **conf):
        values = dict(self.conf)
        if pkg == "torch":
            values.update({"hyperspace.torch.device": "cpu", "hyperspace.torch.hbm.mode": "force",
                           "hyperspace.torch.hbm.minRows": 1})
        values.update(conf)
        s = PKGS[pkg].HyperspaceSession(PKGS[pkg].HyperspaceConf(values), mesh=mesh)
        s.enable_hyperspace()
        return s

    def read(self, s, table):
        return s.read.avro(str(self.root / table))


QUERIES = {
    "range": lambda t, s, E, A: t.read(s, "li").filter(
        (E.col("l_k") >= 50) & (E.col("l_k") < 260) & (E.col("l_s") != "N")).select(
        "l_k", "l_q", "l_s"),
    "f64": lambda t, s, E, A: t.read(s, "li").filter(
        (E.col("l_k") >= 10) & (E.col("l_p") > 500.0)).select("l_k", "l_p"),
    "agg": lambda t, s, E, A: t.read(s, "li").filter(E.col("l_k") >= 120).group_by("l_g").agg(
        A.agg_sum("l_q", "sq"), A.agg_count(), A.agg_min("l_q", "mn"), A.agg_max("l_q", "mx"),
        A.agg_avg("l_p", "ap")),
    "join_agg": lambda t, s, E, A: t.read(s, "li").join(
        t.read(s, "od"), E.col("l_k") == E.col("o_k")).group_by("l_g").agg(
        A.agg_sum("o_t", "rev"), A.agg_avg("o_t", "avg_rev"), A.agg_count(),
        A.agg_sum("l_q", "sq")),
}
PREFETCH = ["l_k", "l_g", "l_q", "l_p", "l_s"]


def both(tree, name, mesh, **conf):
    """The query ``name`` collected in each package's mesh session."""
    out = {}
    for pkg in PKGS:
        s = tree.session(pkg, mesh[pkg], **conf)
        out[pkg] = QUERIES[name](tree, s, EXPR[pkg], AGGS[pkg]).collect()
    return out


def prefetch_both(tree, mesh, cols=PREFETCH):
    for pkg in PKGS:
        s = tree.session(pkg, mesh[pkg])
        assert PKGS[pkg].Hyperspace(s).prefetch_index("li_idx", cols)


# ---------------------------------------------------------------------------
# the compiled mesh scan and device aggregate
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return Tree(tmp_path_factory.mktemp("mesh_res"))


def test_mesh_scan_pipeline_lowers_with_parity(tree):
    mesh = meshes(8)
    prefetch_both(tree, mesh)
    out = both(tree, "range", mesh)
    assert_same(out["torch"], out["jax"])
    for c in ("compile.lowered.scan", "compile.fused.dispatches",
              "scan.path.resident_device_mesh"):
        assert _count("torch", c) == _count("jax", c) == 1, c
    assert tmetrics.get("dist.h2d_bytes") == 0
    # a fresh-literal burst rides the one lowered pipeline
    s = tree.session("torch", mesh["torch"])
    for k in (3, 77, 150):
        tree.read(s, "li").filter(texpr.col("l_k") == k).select("l_k", "l_q").collect()
    assert tmetrics.get("compile.lowered") == 2  # range, then the point shape
    assert tmetrics.get("scan.path.resident_device_mesh") == 4
    off = QUERIES["range"](tree, tree.session("torch", mesh["torch"],
                                              **{"hyperspace.compile.mode": "off"}),
                           texpr, taggs).collect()
    assert_same(out["torch"], off)


def test_mesh_f64_predicate_resident(tree):
    mesh = meshes(4)
    prefetch_both(tree, mesh)
    out = both(tree, "f64", mesh)
    assert_same(out["torch"], out["jax"])
    assert tmetrics.get("scan.path.resident_device_mesh") == 1


def test_mesh_agg_scan_pipeline_lowers_with_parity(tree):
    mesh = meshes(8)
    prefetch_both(tree, mesh)
    out = both(tree, "agg", mesh)
    assert_same(out["torch"], out["jax"])  # ascending group keys in both
    for c in ("compile.agg.device", "scan.path.resident_agg_mesh", "compile.run.agg_scan"):
        assert _count("torch", c) == _count("jax", c) == 1, c
    assert tmetrics.get("dist.h2d_bytes") == 0
    # the interpreter's resident arm (compile off): the same groups
    off = both(tree, "agg", mesh, **{"hyperspace.compile.mode": "off"})
    assert_same(off["torch"], off["jax"], ordered=False, keys=["l_g"])
    assert_same(out["torch"], off["torch"], ordered=False, keys=["l_g"])
    assert tmetrics.get("aggregate.path.resident_mesh") == 1


def test_mesh_agg_scan_no_table_schedules_population(tree):
    mesh = meshes(4)
    s = tree.session("torch", mesh["torch"])
    first = QUERIES["agg"](tree, s, texpr, taggs).collect()
    assert tmetrics.get("compile.agg.declined.no_table") == 1
    tmc.wait_background()
    second = QUERIES["agg"](tree, s, texpr, taggs).collect()
    assert tmetrics.get("compile.agg.device") == 1
    assert_same(second, first, ordered=False, keys=["l_g"])


# ---------------------------------------------------------------------------
# the mesh join region
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("for_delta", ["on", "off"])
def test_mesh_fused_join_agg_parity_and_zero_h2d(tree, for_delta):
    mesh = meshes(8)
    conf = {"hyperspace.residency.forDelta": for_delta}
    first = both(tree, "join_agg", mesh, **conf)  # schedules the region builds
    wait_both()
    assert tmc.snapshot_joins()["regions"] == jmc.snapshot_joins()["regions"] == 1
    region = tmc._joins[0]
    assert region.dev_rows_l == jmc._joins[0].dev_rows_l
    assert region.dev_rows_r == jmc._joins[0].dev_rows_r
    routes = {r for r in region.routes if r is not None}
    assert routes <= ({"k2p", "k2", "searchsorted"} if for_delta == "on"
                      else {"k2", "searchsorted"})
    tmetrics.reset()
    jmetrics.reset()
    out = both(tree, "join_agg", mesh, **conf)
    assert_same(out["torch"], out["jax"])
    assert_same(out["torch"], first["torch"], ordered=False, keys=["l_g"])
    for pkg in PKGS:
        assert _count(pkg, "scan.path.resident_join_agg_mesh") == 1, pkg
        assert _count(pkg, "hbm.mesh.join.h2d_bytes") == 0, pkg
    assert tmetrics.get("dist.h2d_bytes") == 0
    assert tmetrics.get("compile.fused.dispatches") == 1
    single = QUERIES["join_agg"](tree, tree.session("torch", None), texpr, taggs).collect()
    assert_same(out["torch"], single, ordered=False, keys=["l_g"])


def test_mesh_join_region_declines_materializing_join(tree):
    """The materializing join stays on the per-query mesh route."""
    mesh = meshes(4)
    s = tree.session("torch", mesh["torch"])
    q = tree.read(s, "li").select("l_k", "l_g").join(
        tree.read(s, "od").select("o_k", "o_t"), texpr.col("l_k") == texpr.col("o_k"))
    q.collect()
    assert tmetrics.get("join.path.distributed") == 1
    assert tmetrics.get("scan.path.resident_join") == 0


# ---------------------------------------------------------------------------
# the batcher's mesh arm
# ---------------------------------------------------------------------------
def test_mesh_burst_one_dispatch_one_k1b_a_shard(tree, monkeypatch):
    D = 4
    mesh = meshes(D)
    prefetch_both(tree, mesh)
    keys = [3, 70, 155, 260, 301, 499]
    calls = []
    real = K.resident_counts_tensor

    def recorded(prepared, names, cols, specs, n_rows):
        calls.append(len(prepared))
        return real(prepared, names, cols, specs, n_rows)

    monkeypatch.setattr(K, "resident_counts_tensor", recorded)
    out = {}
    for pkg in PKGS:
        s = tree.session(pkg, mesh[pkg])
        qs = [tree.read(s, "li").filter(EXPR[pkg].col("l_k") == k).select("l_k", "l_q")
              for k in keys]
        serial = [q.collect() for q in qs]
        calls.clear()
        (jmetrics if pkg == "jax" else tmetrics).reset()
        mod = jserve if pkg == "jax" else tserve
        server = mod.QueryServer(s, mod.ServeConfig(max_workers=2, autostart=False))
        tickets = [server.submit(q) for q in qs]
        server.start()
        served = [t.result(timeout=60) for t in tickets]
        stats = server.stats()
        server.close()
        for a, b in zip(serial, served):
            assert_same(b, a)
        assert stats["batch_size_hist"] == {len(keys): 1}, pkg
        assert _count(pkg, "serve.batch.dispatches") == 1, pkg
        assert _count(pkg, "serve.batch.queries") == len(keys), pkg
        out[pkg] = served
        if pkg == "torch":
            assert calls == [len(keys)] * D  # one batched launch a shard
    for a, b in zip(out["torch"], out["jax"]):
        assert_same(a, b)


# ---------------------------------------------------------------------------
# a shard's launch lost
# ---------------------------------------------------------------------------
def test_mesh_device_loss_drops_table_and_ships(tree, monkeypatch):
    mesh = meshes(4)
    prefetch_both(tree, mesh)
    want = both(tree, "range", mesh)["jax"]
    real = K.resident_counts_tensor
    lost = []

    def lossy(*a, **k):
        if not lost:
            lost.append(1)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(*a, **k)

    monkeypatch.setattr(K, "resident_counts_tensor", lossy)
    tmetrics.reset()
    s = tree.session("torch", mesh["torch"])
    got = QUERIES["range"](tree, s, texpr, taggs).collect()
    assert tmetrics.get("scan.resident_mesh.device_failed") == 1
    assert tmetrics.get("compile.pipeline.dropped_on_device_loss") == 1
    assert tmc.snapshot()["tables"] == 0
    assert tmetrics.get("scan.path.distributed") == 1 and tmetrics.get("dist.h2d_bytes") > 0
    assert_same(got, want, ordered=False, keys=["l_k", "l_q", "l_s"])


def test_mesh_join_region_loss_answers_on_the_mesh(tree, monkeypatch):
    mesh = meshes(4)
    s = tree.session("torch", mesh["torch"])
    want = QUERIES["join_agg"](tree, s, texpr, taggs).collect()
    tmc.wait_background()
    from hyperspace_tpu_torch.exec import join_residency as tjr

    def lost(region):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tjr, "region_ranges", lost)
    tmetrics.reset()
    got = QUERIES["join_agg"](tree, s, texpr, taggs).collect()
    assert tmetrics.get("scan.resident_join.device_failed") == 1
    assert tmc.snapshot_joins()["regions"] == 0
    assert tmetrics.get("join.path.distributed") == 1
    assert_same(got, want, ordered=False, keys=["l_g"])


# ---------------------------------------------------------------------------
# the mesh hybrid
# ---------------------------------------------------------------------------
def _hybrid_tree(root, seed=5, delete=False):
    t = Tree(root, n_l=12_000, seed=seed, **{"hyperspace.index.hybridscan.enabled": True,
                                               "hyperspace.index.lineage.enabled": True,
                                               "hyperspace.index.hybridscan.maxDeletedRatio": 0.6})
    rng = np.random.default_rng(seed + 1)
    n = 900
    app = TB.from_pydict({
        "l_k": rng.integers(0, 600, n).astype(np.int64),
        "l_g": rng.integers(0, 40, n).astype(np.int64),
        "l_q": rng.integers(-1000, 1000, n).astype(np.int64),
        "l_p": np.round(rng.uniform(1, 1000, n), 2),
        "l_s": rng.choice(["A", "Z"], n).astype(object),  # "Z": out of the base vocab
    }, {"l_k": "int64", "l_g": "int64", "l_q": "int64", "l_p": "float64", "l_s": "string"})
    avro_io.write_avro(root / "li" / "p-append.avro", app)
    if delete:
        (root / "li" / "p-1.avro").unlink()
    return t


HYBRID = {
    "point": lambda E: E.col("l_k") == 42,
    "range": lambda E: (E.col("l_k") >= 100) & (E.col("l_k") < 180),
    "oov_eq": lambda E: (E.col("l_k") >= 0) & (E.col("l_s") == "Z"),
}


@pytest.mark.parametrize("delete", [False, True])
def test_mesh_fused_hybrid_parity_and_zero_h2d(tmp_path, delete):
    t = _hybrid_tree(tmp_path, delete=delete)
    mesh = meshes(4)
    sessions = {pkg: t.session(pkg, mesh[pkg]) for pkg in PKGS}
    for pkg, s in sessions.items():
        assert PKGS[pkg].Hyperspace(s).prefetch_index("li_idx", ["l_k", "l_s"])

    def q(pkg, name):
        return t.read(sessions[pkg], "li").filter(HYBRID[name](EXPR[pkg])).select(
            "l_k", "l_q", "l_s")

    for pkg in PKGS:
        q(pkg, "point").collect()  # the host union schedules the delta
    wait_both()
    assert tmc.snapshot()["deltas"] == jmc.snapshot()["deltas"] == 1
    delta = tmc._deltas[0]
    jd = jmc._deltas[0]
    assert delta.dev_rows == jd.dev_rows and delta.deleted_ids == jd.deleted_ids
    for d in range(delta.n_devices):
        assert np.array_equal(delta.dev_idx[d], jd.dev_idx[d])
    assert (delta.del_mask is not None) == delete
    for name in HYBRID:
        tmetrics.reset()
        jmetrics.reset()
        out = {pkg: q(pkg, name).collect() for pkg in PKGS}
        assert_same(out["torch"], out["jax"])
        for pkg in PKGS:
            assert _count(pkg, "scan.path.resident_hybrid_mesh") == 1, (pkg, name)
        assert tmetrics.get("dist.h2d_bytes") == 0
        sessions["torch"].disable_hyperspace()
        host = q("torch", name).collect()
        sessions["torch"].enable_hyperspace()
        assert_same(out["torch"], host, ordered=False, keys=["l_k", "l_q", "l_s"])
        if name == "oov_eq":
            assert out["torch"].num_rows > 0


def test_mesh_hybrid_declines_compressed_base(tmp_path):
    t = _hybrid_tree(tmp_path, seed=8)
    mesh = meshes(4)
    s = t.session("torch", mesh["torch"], **{"hyperspace.residency.compression": "force"})
    assert hs_torch.Hyperspace(s).prefetch_index("li_idx", ["l_k"])
    assert tmc._tables[0].tier == "compressed"
    q = t.read(s, "li").filter(texpr.col("l_k") == 42).select("l_k", "l_q")
    q.collect()
    tmc.wait_background()
    assert tmetrics.get("hbm.mesh.delta.declined.tier") >= 1
    assert tmc.snapshot()["deltas"] == 0


# ---------------------------------------------------------------------------
# the fuzz
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(5))
def test_resident_mesh_fuzz(tmp_path, seed):
    """Random shapes through both packages' resident mesh routes: a filter
    and a device aggregate over a prefetched table, an aggregate-join over
    a first-touch region, then a hybrid filter after an append."""
    rng = np.random.default_rng(9100 + seed)
    D = int(rng.choice([2, 4, 8]))
    t = Tree(tmp_path, n_l=int(rng.integers(3000, 20_000)), n_o=int(rng.integers(100, 800)),
             seed=seed, num_buckets=int(rng.choice([8, 16, 32])),
             **{"hyperspace.index.hybridscan.enabled": True})
    mesh = meshes(D)
    lo = int(rng.integers(0, 80))
    width = int(rng.integers(5, 400))
    g_lim = int(rng.integers(1, 40))
    preds = [lambda E: E.col("l_k") == lo,
             lambda E: (E.col("l_k") >= lo) & (E.col("l_k") < lo + width),
             lambda E: (E.col("l_k") >= lo) & (E.col("l_g") < g_lim) & (E.col("l_s") != "A")]
    pred = preds[int(rng.integers(0, len(preds)))]
    prefetch_both(t, mesh)
    sessions = {pkg: t.session(pkg, mesh[pkg]) for pkg in PKGS}

    def run(make):
        return {pkg: make(sessions[pkg], EXPR[pkg], AGGS[pkg]).collect() for pkg in PKGS}

    out = run(lambda s, E, A: t.read(s, "li").filter(pred(E)).select("l_k", "l_g", "l_s"))
    assert_same(out["torch"], out["jax"])
    out = run(lambda s, E, A: t.read(s, "li").filter(pred(E)).group_by("l_g").agg(
        A.agg_sum("l_q", "sq"), A.agg_max("l_p", "mp"), A.agg_count()))
    assert_same(out["torch"], out["jax"])
    assert tmetrics.get("compile.agg.device") == 1
    run(lambda s, E, A: QUERIES["join_agg"](t, s, E, A))
    wait_both()
    tmetrics.reset()
    out = run(lambda s, E, A: QUERIES["join_agg"](t, s, E, A))
    assert_same(out["torch"], out["jax"])
    assert tmetrics.get("scan.path.resident_join_agg_mesh") == 1
    assert tmetrics.get("dist.h2d_bytes") == 0
    app = TB.from_pydict({"l_k": rng.integers(0, 600, 300).astype(np.int64),
                          "l_g": rng.integers(0, 40, 300).astype(np.int64),
                          "l_q": rng.integers(-9, 9, 300).astype(np.int64),
                          "l_p": np.round(rng.uniform(1, 1000, 300), 2),
                          "l_s": rng.choice(["A", "N"], 300).astype(object)},
                         {"l_k": "int64", "l_g": "int64", "l_q": "int64", "l_p": "float64",
                          "l_s": "string"})
    avro_io.write_avro(t.root / "li" / "p-append.avro", app)
    sessions = {pkg: t.session(pkg, mesh[pkg]) for pkg in PKGS}
    hq = lambda s, E, A: t.read(s, "li").filter(pred(E)).select("l_k", "l_g", "l_s")  # noqa
    run(hq)
    wait_both()
    tmetrics.reset()
    out = run(hq)
    assert_same(out["torch"], out["jax"])
    assert tmetrics.get("scan.path.resident_hybrid_mesh") == 1
