"""The port's mesh query paths (``exec/distributed.py`` and the executor's
and compiler's mesh arms) against the JAX package's on the CPU: the
reference on its 8-device virtual mesh (``HYPERSPACE_TPU_HBM=off``: its
per-query route), the port on ``make_mesh(D, device="cpu")`` with
``hyperspace.torch.hbm.mode=off``, where K1 and K2 run their plain
versions. The same numpy rows feed both: the distributed filter (rows in
the exact order: shard-major, then bucket), the two-phase aggregate
(groups in the reference's order, integers exact, floats ``rtol=1e-9``)
and the co-partitioned join (rows in the exact order), as functions, then
through executors and sessions over one index tree the port built, with
the path counters compared, plus a 5-seed mesh fuzz. Mirrors
``tests/test_distributed_query.py``, ``tests/test_runs_layout.py:227``
and ``tests/test_fuzz_parity.py:350``.
"""

from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.exec import distributed as jdist
from hyperspace_tpu.ops.hashing import bucket_ids_host as j_bucket_ids
from hyperspace_tpu.ops.hashing import key_repr as j_key_repr
from hyperspace_tpu.parallel.mesh import make_mesh as jax_mesh
from hyperspace_tpu.plan import aggregates as jaggs
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.storage.columnar import ColumnarBatch as JB
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.exec import distributed as tdist
from hyperspace_tpu_torch.exec import executor as texec
from hyperspace_tpu_torch.exec import joins as tjoins
from hyperspace_tpu_torch.ops.hashing import bucket_ids_host as t_bucket_ids
from hyperspace_tpu_torch.ops.hashing import key_repr as t_key_repr
from hyperspace_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from hyperspace_tpu_torch.plan import aggregates as taggs
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.storage import avro_io
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_aggregate import assert_same

PKGS = {"jax": hs_jax, "torch": hs_torch}
EXPR = {"jax": jexpr, "torch": texpr}
AGGS = {"jax": jaggs, "torch": taggs}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """The reference's per-query mesh route (no residency), both
    registries and the port's join caches empty."""
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "off")
    jmetrics.reset()
    tmetrics.reset()
    texec.reset_groups_cache()
    tjoins.reset_setup_cache()
    yield


def meshes(D):
    return jax_mesh(D), torch_mesh(D, device="cpu")


def split(pkg, table: dict, schema: dict, keys, nb, sort_key=None):
    """The same rows as {bucket: batch} in either package, bucketed by the
    index hash (rows in input order, or sorted by ``sort_key`` within a
    bucket: the on-disk invariant)."""
    B, bids, krepr = ((JB, j_bucket_ids, j_key_repr) if pkg == "jax"
                      else (TB, t_bucket_ids, t_key_repr))
    batch = B.from_pydict(table, schema=schema)
    b = bids([krepr(batch.columns[k]) for k in keys], nb)
    out = {}
    for x in np.unique(b):
        part = batch.take(np.flatnonzero(b == x))
        if sort_key is not None:
            part = part.take(np.argsort(part.columns[sort_key].data, kind="stable"))
        out[int(x)] = part
    return out


def sample(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return ({
        "k": rng.integers(0, 300, n).astype(np.int64),
        "v": rng.integers(0, 10**6, n).astype(np.int64),
        "w": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "s": rng.choice(["aa", "bb", "cc", "dd"], n).astype(object),
        "f": np.round(rng.normal(0, 5, n), 3),
    }, {"k": "int64", "v": "int64", "w": "int64", "s": "string", "f": "float64"})


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------
def test_group_by_owner():
    by_bucket = {b: None for b in [0, 1, 7, 8, 9, 15, 16]}
    for mod in (jdist, tdist):
        owned = mod.group_by_owner(by_bucket, 8)
        assert owned[0] == [0, 8, 16] and owned[1] == [1, 9] and owned[7] == [7, 15]


FILTERS = {
    "point": lambda E: E.col("k") == 7,
    "range": lambda E: (E.col("k") > 50) & (E.col("k") <= 200),
    "string": lambda E: E.col("s") == "bb",
    "or": lambda E: (E.col("v") > 500_000) | (E.col("k") < 10),
    "wide_int": lambda E: E.col("w") > 0,  # does not narrow to int32: torch ops
    "float64": lambda E: E.col("f") > 1.5,  # evaluates on the host
}


@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_distributed_filter_matches_reference(D, name):
    table, schema = sample(seed=D)
    jm, tm = meshes(D)
    cols = ["k", "v", "s"]
    want = jdist.distributed_filter(split("jax", table, schema, ["k"], 16),
                                    FILTERS[name](jexpr), cols, jm)
    got = tdist.distributed_filter(split("torch", table, schema, ["k"], 16),
                                   FILTERS[name](texpr), cols, tm)
    assert_same(got, want)  # exact order: shard-major, bucket ascending
    for c in ("scan.path.distributed", "scan.path.host_f64"):
        assert tmetrics.get(c) == jmetrics.counter(c), c
    assert tmetrics.get("scan.path.torch_mask") == (name == "wide_int")
    if name != "float64":
        assert tmetrics.get("dist.h2d_bytes") > 0


def test_distributed_filter_without_predicate_and_empty():
    table, schema = sample(n=200, seed=1)
    jm, tm = meshes(8)
    assert_same(tdist.distributed_filter(split("torch", table, schema, ["k"], 16), None,
                                         ["k", "s"], tm),
                jdist.distributed_filter(split("jax", table, schema, ["k"], 16), None,
                                         ["k", "s"], jm))
    from hyperspace_tpu_torch.exceptions import HyperspaceException

    with pytest.raises(HyperspaceException):
        tdist.distributed_filter({}, texpr.col("k") == 1, ["k"], tm)


def _specs(A):
    return [A.agg_sum("v"), A.agg_count(), A.agg_count("f", "nnf"), A.agg_min("v"),
            A.agg_max("v"), A.agg_avg("f"), A.agg_sum("f", "sf"), A.agg_min("f", "mnf")]


@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("case", ["k", "k_s", "s_pred", "k_pred2"])
def test_distributed_aggregate_matches_reference(D, case):
    rng = np.random.default_rng(11 + D)
    n = 4000
    table = {
        "k": rng.integers(0, 60, n).astype(np.int64),
        "s": rng.choice(["a", "b", "c"], n).astype(object),
        "v": rng.integers(-1000, 1000, n).astype(np.int64),
        "f": np.where(rng.random(n) < 0.07, np.nan, rng.normal(0, 5, n)),
    }
    schema = {"k": "int64", "s": "string", "v": "int64", "f": "float64"}
    group_by, pred = {
        "k": (["k"], None),
        "k_s": (["k", "s"], None),
        "s_pred": (["s"], lambda E: E.col("k") > 20),
        "k_pred2": (["k"], lambda E: (E.col("v") > 0) & (E.col("s") == "b")),
    }[case]
    jm, tm = meshes(D)
    out = {}
    for pkg, mesh, mod in (("jax", jm, jdist), ("torch", tm, tdist)):
        out[pkg] = mod.distributed_filter_aggregate(
            split(pkg, table, schema, ["k"], 16), pred(EXPR[pkg]) if pred else None,
            group_by, _specs(AGGS[pkg]), mesh)
    assert_same(out["torch"], out["jax"])  # the reference's group order
    assert tmetrics.get("aggregate.path.distributed") == 1
    assert jmetrics.counter("aggregate.path.distributed") == 1


def test_distributed_minmax_keeps_genuine_inf():
    rng = np.random.default_rng(21)
    n = 512
    f = rng.normal(0, 5, n)
    f[7], f[19], f[33] = np.inf, -np.inf, np.nan
    table = {"k": rng.integers(0, 6, n).astype(np.int64), "f": f}
    schema = {"k": "int64", "f": "float64"}
    jm, tm = meshes(8)
    out = {}
    for pkg, mesh, mod in (("jax", jm, jdist), ("torch", tm, tdist)):
        A = AGGS[pkg]
        out[pkg] = mod.distributed_filter_aggregate(
            split(pkg, table, schema, ["k"], 16), None, ["k"],
            [A.agg_min("f", "mn"), A.agg_max("f", "mx"), A.agg_sum("f", "s")], mesh)
    assert_same(out["torch"], out["jax"])
    assert np.isinf(out["torch"].columns["mx"].data).any()
    assert np.isinf(out["torch"].columns["mn"].data).any()


def test_distributed_aggregate_declines_as_the_reference():
    """String inputs, a len x max past 2^53, float64 predicates, no group
    keys: None in both packages."""
    rng = np.random.default_rng(3)
    n = 300
    table = {"k": rng.integers(0, 9, n).astype(np.int64),
             "big": np.full(n, 1 << 50, dtype=np.int64),
             "s": rng.choice(["a", "b"], n).astype(object),
             "f": rng.normal(0, 1, n)}
    schema = {"k": "int64", "big": "int64", "s": "string", "f": "float64"}
    jm, tm = meshes(4)
    for pkg, mesh, mod in (("jax", jm, jdist), ("torch", tm, tdist)):
        A, E = AGGS[pkg], EXPR[pkg]
        bb = split(pkg, table, schema, ["k"], 8)
        assert mod.distributed_filter_aggregate(bb, None, ["k"], [A.agg_max("s")], mesh) is None
        assert mod.distributed_filter_aggregate(bb, None, ["k"], [A.agg_sum("big")], mesh) is None
        assert mod.distributed_filter_aggregate(bb, E.col("f") > 0, ["k"], [A.agg_count()],
                                                mesh) is None
        assert mod.distributed_filter_aggregate(bb, None, [], [A.agg_count()], mesh) is None
    assert tmetrics.get("aggregate.path.distributed") == 0


def _join_sides(seed, n_l=2500, n_r=800, key_hi=200, strings=False):
    rng = np.random.default_rng(seed)
    left = {"l_k": rng.integers(0, key_hi, n_l).astype(np.int64),
            "l_v": np.arange(n_l, dtype=np.int64)}
    right = {"r_k": (rng.permutation(n_r) % key_hi).astype(np.int64),
             "r_v": np.arange(n_r, dtype=np.int64)}
    ls, rs = {"l_k": "int64", "l_v": "int64"}, {"r_k": "int64", "r_v": "int64"}
    if strings:
        left["l_s"] = rng.choice(["x", "y", "z"], n_l).astype(object)
        right["r_s"] = rng.choice(["y", "z", "w"], n_r).astype(object)
        ls["l_s"] = rs["r_s"] = "string"
    return left, ls, right, rs


@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("strings", [False, True])
def test_distributed_join_matches_reference(D, strings):
    left, ls, right, rs = _join_sides(3 + D, strings=strings)
    lk, rk = (["l_k", "l_s"], ["r_k", "r_s"]) if strings else (["l_k"], ["r_k"])
    jm, tm = meshes(D)
    out = {}
    for pkg, mesh, mod in (("jax", jm, jdist), ("torch", tm, tdist)):
        lb = split(pkg, left, ls, lk, 16, sort_key="l_k")
        rb = split(pkg, right, rs, rk, 16, sort_key="r_k")
        out[pkg] = mod.distributed_bucketed_join(lb, rb, lk, rk, mesh)
    assert len(out["torch"]) == len(out["jax"]) > 0
    for got, want in zip(out["torch"], out["jax"]):
        assert_same(got, want)  # exact order, shard by shard
    assert tmetrics.get("join.path.distributed") == jmetrics.counter("join.path.distributed") == 1
    assert tmetrics.get("join.path.device_kernel") >= 1
    assert tmetrics.get("dist.h2d_bytes") > 0


def test_distributed_join_pad_code_declines_to_the_bucketed_join():
    """A real code equal to INT64_MAX (the reference's pad) declines to the
    bucketed join in both packages."""
    top = np.iinfo(np.int64).max
    left = {"l_k": np.array([1, top, 5, top], dtype=np.int64), "l_v": np.arange(4)}
    right = {"r_k": np.array([top, 5, 9], dtype=np.int64), "r_v": np.arange(3)}
    ls, rs = {"l_k": "int64", "l_v": "int64"}, {"r_k": "int64", "r_v": "int64"}
    jm, tm = meshes(4)
    out = {}
    for pkg, mesh, mod in (("jax", jm, jdist), ("torch", tm, tdist)):
        out[pkg] = TB.concat(mod.distributed_bucketed_join(
            split(pkg, left, ls, ["l_k"], 4, "l_k"), split(pkg, right, rs, ["r_k"], 4, "r_k"),
            ["l_k"], ["r_k"], mesh)) if pkg == "torch" else JB.concat(
            mod.distributed_bucketed_join(
                split(pkg, left, ls, ["l_k"], 4, "l_k"),
                split(pkg, right, rs, ["r_k"], 4, "r_k"), ["l_k"], ["r_k"], mesh))
    assert_same(out["torch"], out["jax"], ordered=False, keys=["l_v", "r_v"])
    assert tmetrics.get("join.path.distributed") == 0 == jmetrics.counter(
        "join.path.distributed")


# ---------------------------------------------------------------------------
# executors and sessions over one index tree
# ---------------------------------------------------------------------------
class Tree:
    """Avro sources ``li`` and ``od`` and their indexes (12 buckets, or
    ``od_buckets`` for od's), built by the port; sessions of both packages
    over them, on a mesh."""

    def __init__(self, root: Path, n_l=3000, n_o=800, seed=7, num_buckets=12, od_buckets=None):
        rng = np.random.default_rng(seed)
        li = TB.from_pydict({
            "l_k": rng.integers(0, 400, n_l).astype(np.int64),
            "l_q": rng.integers(1, 50, n_l).astype(np.int64),
            "l_p": np.round(rng.uniform(1, 1000, n_l), 2),
            "l_s": rng.choice(["A", "N", "R"], n_l).astype(object),
        }, {"l_k": "int64", "l_q": "int64", "l_p": "float64", "l_s": "string"})
        od = TB.from_pydict({
            "o_k": rng.permutation(n_o).astype(np.int64) % 400,
            "o_t": rng.integers(0, 9000, n_o).astype(np.int64),
        }, {"o_k": "int64", "o_t": "int64"})
        self.root = root
        for name, batch, parts in (("li", li, 3), ("od", od, 2)):
            per = -(-batch.num_rows // parts)
            for i in range(parts):
                avro_io.write_avro(root / name / f"p-{i}.avro",
                                   batch.take(np.arange(i * per, min((i + 1) * per,
                                                                      batch.num_rows))))
        self.conf = {"hyperspace.system.path": str(root / "indexes"),
                     "hyperspace.index.numBuckets": num_buckets}
        s = self.session("torch", None)
        h = hs_torch.Hyperspace(s)
        h.create_index(self.read(s, "li"), hs_torch.IndexConfig("li_idx", ["l_k"],
                                                                 ["l_q", "l_p", "l_s"]))
        if od_buckets is not None:  # od's index under another numBuckets
            s = self.session("torch", None, **{"hyperspace.index.numBuckets": od_buckets})
            h = hs_torch.Hyperspace(s)
        h.create_index(self.read(s, "od"), hs_torch.IndexConfig("od_idx", ["o_k"], ["o_t"]))

    def session(self, pkg, mesh, **conf):
        values = {**self.conf, C.TPU_DISTRIBUTED_MIN_ROWS: 0, **conf}
        if pkg == "torch":
            values.update({"hyperspace.torch.device": "cpu", "hyperspace.torch.hbm.mode": "off"})
        mod = PKGS[pkg]
        s = mod.HyperspaceSession(mod.HyperspaceConf(values), mesh=mesh)
        s.enable_hyperspace()
        return s

    def read(self, s, table):
        return s.read.avro(str(self.root / table))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return Tree(tmp_path_factory.mktemp("mesh_tree"))


QUERIES = {
    "point": lambda t, s, E: t.read(s, "li").filter(E.col("l_k") == 42).select("l_k", "l_q"),
    "range": lambda t, s, E: t.read(s, "li").filter(
        (E.col("l_k") >= 10) & (E.col("l_k") < 260) & (E.col("l_s") != "N")).select(
        "l_k", "l_q", "l_s"),
    "float64": lambda t, s, E: t.read(s, "li").filter(
        (E.col("l_k") >= 10) & (E.col("l_p") > 500.0)).select("l_k", "l_p"),
    "join": lambda t, s, E: t.read(s, "li").select("l_k", "l_q").join(
        t.read(s, "od").select("o_k", "o_t"), E.col("l_k") == E.col("o_k")),
    "join_filtered": lambda t, s, E: t.read(s, "li").filter(E.col("l_q") < 20).select(
        "l_k", "l_q").join(t.read(s, "od").filter(E.col("o_t") > 3000).select("o_k", "o_t"),
                           E.col("l_k") == E.col("o_k")),
    "aggregate": lambda t, s, E: t.read(s, "li").filter(E.col("l_k") > 30).group_by(
        "l_q").agg(AGGS["jax" if E is jexpr else "torch"].agg_sum("l_p"),
                   AGGS["jax" if E is jexpr else "torch"].agg_count(),
                   AGGS["jax" if E is jexpr else "torch"].agg_avg("l_k")),
}

COUNTERS = ("scan.path.distributed", "join.path.distributed", "aggregate.path.distributed",
            "scan.path.host_f64", "scan.files_read", "shuffle.plan.direct",
            "compile.agg.declined.no_table")


@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_session_mesh_queries_match_reference(tree, D, name):
    jm, tm = meshes(D)
    got = {}
    for pkg, mesh in (("jax", jm), ("torch", tm)):
        s = tree.session(pkg, mesh)
        got[pkg] = QUERIES[name](tree, s, EXPR[pkg]).collect()
    if name == "aggregate":
        assert_same(got["torch"], got["jax"])
    else:
        assert_same(got["torch"], got["jax"])  # the mesh's exact row order
    for c in COUNTERS:
        assert tmetrics.get(c) == jmetrics.counter(c), c
    want_path = {"point": "scan.path.distributed", "range": "scan.path.distributed",
                 "float64": "scan.path.host_f64", "join": "join.path.distributed",
                 "join_filtered": "join.path.distributed",
                 "aggregate": "aggregate.path.distributed"}[name]
    assert tmetrics.get(want_path) == 1
    # and the rows are the single-device session's, in some order
    single = QUERIES[name](tree, tree.session("torch", None), texpr).collect()
    keys = list(single.column_names)
    assert_same(got["torch"], single, ordered=False, keys=keys)


def test_dist_min_rows_gates_to_the_host(tree):
    """Below hyperspace.tpu.distributedQuery.minRows the mesh's filter,
    aggregate and join run on the host, in both packages: a pinned-bucket
    lookup launches no K1 on a mesh."""
    jm, tm = meshes(4)
    for name in ("point", "range", "join", "aggregate"):
        got = {}
        for pkg, mesh in (("jax", jm), ("torch", tm)):
            s = tree.session(pkg, mesh, **{C.TPU_DISTRIBUTED_MIN_ROWS: 10**9})
            got[pkg] = QUERIES[name](tree, s, EXPR[pkg]).collect()
        assert_same(got["torch"], got["jax"])
    for c in ("scan.path.distributed", "join.path.distributed", "aggregate.path.distributed"):
        assert tmetrics.get(c) == jmetrics.counter(c) == 0, c


def test_mesh_session_ignores_residency(tree):
    """Until the mesh's resident tables land, a mesh session ships each
    query whatever the residency mode (the reference's route with its
    residency off)."""
    _, tm = meshes(4)
    s = tree.session("torch", tm, **{"hyperspace.torch.hbm.mode": "force",
                                     "hyperspace.torch.hbm.minRows": 1})
    QUERIES["range"](tree, s, texpr).collect()
    QUERIES["range"](tree, s, texpr).collect()
    assert tmetrics.get("scan.path.distributed") == 2
    assert tmetrics.get("scan.path.resident_device") == 0


def test_executor_mesh_over_run_files(tmp_path):
    """Run files (finalizeMode=runs) split into bucket segments before they
    reach their shards; a pinned lookup reads only its bucket's rows."""
    t = Tree(tmp_path, n_l=2000, seed=9, num_buckets=8)
    t.conf.update({"hyperspace.index.build.finalizeMode": "runs",
                   "hyperspace.index.build.streamingThresholdBytes": 1000,
                   "hyperspace.index.build.chunkRows": 512,
                   "hyperspace.system.path": str(tmp_path / "runs")})
    s = t.session("torch", None)
    hs_torch.Hyperspace(s).create_index(t.read(s, "li"), hs_torch.IndexConfig(
        "li_idx", ["l_k"], ["l_q", "l_p", "l_s"]))
    jm, tm = meshes(8)
    for name in ("point", "range"):
        got = {pkg: QUERIES[name](t, t.session(pkg, mesh), EXPR[pkg]).collect()
               for pkg, mesh in (("jax", jm), ("torch", tm))}
        assert_same(got["torch"], got["jax"])
    assert tmetrics.get("scan.path.distributed") == jmetrics.counter("scan.path.distributed") == 2


@pytest.mark.parametrize("seed", range(5))
def test_mesh_parity_fuzz(tmp_path, seed):
    """Random shapes through both packages' mesh executors: filters and
    the projected join, rows in the mesh's exact order."""
    rng = np.random.default_rng(7000 + seed)
    D = int(rng.choice([2, 3, 5, 8]))
    t = Tree(tmp_path, n_l=int(rng.integers(200, 2500)), n_o=int(rng.integers(50, 600)),
             seed=seed, num_buckets=int(rng.choice([4, 12, 32])))
    jm, tm = meshes(D)
    key = int(rng.integers(0, 400))
    width = int(rng.integers(2, 60))
    q_lim = int(rng.integers(1, 50))
    preds = [lambda E: E.col("l_k") == key,
             lambda E: (E.col("l_k") >= key) & (E.col("l_k") < key + width),
             lambda E: (E.col("l_k") >= 0) & (E.col("l_q") > q_lim)]
    pred = preds[int(rng.integers(0, len(preds)))]
    for make in (lambda s, E: t.read(s, "li").filter(pred(E)).select("l_k", "l_q"),
                 lambda s, E: t.read(s, "li").select("l_k", "l_q").join(
                     t.read(s, "od").select("o_k", "o_t"),
                     E.col("l_k") == E.col("o_k")).select("l_q", "o_t")):
        got = {pkg: make(t.session(pkg, mesh), EXPR[pkg]).collect()
               for pkg, mesh in (("jax", jm), ("torch", tm))}
        assert_same(got["torch"], got["jax"])
        single = make(t.session("torch", None), texpr).collect()
        assert_same(got["torch"], single, ordered=False, keys=list(single.column_names))


# ---------------------------------------------------------------------------
# every shard's work is issued with its device current
# ---------------------------------------------------------------------------
def _scope_programs(n=2000):
    """The six mesh programs over ``n`` sampled rows (joins over about as
    many), each with the kernel boundaries it reaches."""
    from hyperspace_tpu_torch.distributed import shuffle as tshuffle
    from hyperspace_tpu_torch.ops import build as tbuild

    table, schema = sample(n=n, seed=4)
    left, ls, right, rs = _join_sides(6, n_l=n, n_r=n // 3, key_hi=max(200, n // 5))
    range_pred = FILTERS["range"](texpr)
    return {
        "filter_k1": (lambda m: tdist.distributed_filter(
            split("torch", table, schema, ["k"], 16), range_pred, ["k", "v"], m), {"K1"}),
        "filter_torch_mask": (lambda m: tdist.distributed_filter(
            split("torch", table, schema, ["k"], 16), FILTERS["wide_int"](texpr), ["k"], m),
            {"torch_mask"}),
        "aggregate": (lambda m: tdist.distributed_filter_aggregate(
            split("torch", table, schema, ["k"], 16), range_pred, ["s"], _specs(taggs), m),
            {"K1"}),
        "join": (lambda m: tdist.distributed_bucketed_join(
            split("torch", left, ls, ["l_k"], 16, sort_key="l_k"),
            split("torch", right, rs, ["r_k"], 16, sort_key="r_k"), ["l_k"], ["r_k"], m),
            {"K2"}),
        "build": (lambda m: tbuild.build_partition_sharded(
            TB.from_pydict(table, schema=schema), ["k", "s"], 16, m), {"scatter"}),
        "shuffle": (lambda m: tshuffle.repartition_by_bucket(
            split("torch", table, schema, ["k"], 8), ["k"], 12, m), {"scatter"}),
    }


@pytest.mark.parametrize("program", ["filter_k1", "filter_torch_mask", "aggregate", "join",
                                     "build", "shuffle"])
def test_mesh_programs_issue_each_shard_on_its_device(monkeypatch, program):
    """A kernel's C entry launches on the current CUDA device, and a copy
    home is ordered by the source device's stream: each mesh program must
    issue shard d's launches, masks, scatters and fetches inside
    ``Mesh.scope(devices[d])``. ``Mesh.scope`` is replaced by a recorder
    and each of those boundaries checks that a scope is open and names its
    tensor's device; every shard's scope is entered."""
    import contextlib

    from hyperspace_tpu_torch.distributed import shuffle as tshuffle
    from hyperspace_tpu_torch.ops import build as tbuild
    from hyperspace_tpu_torch.ops import kernels as K
    from hyperspace_tpu_torch.ops import resolve_device
    from hyperspace_tpu_torch.parallel import mesh as tmesh

    stack, entered, seen = [], [], set()

    @contextlib.contextmanager
    def scope(self, dev):
        stack.append(dev)
        entered.append(dev)
        try:
            yield
        finally:
            stack.pop()

    def checked(what, fn, dev_of):
        def wrapper(*a, **k):
            assert stack, f"{what} issued with no shard device current"
            dev = dev_of(*a)
            assert dev is None or stack[-1] == dev, (what, stack[-1], dev)
            seen.add(what)
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tmesh.Mesh, "scope", scope)
    monkeypatch.setattr(K, "program_mask_tensor", checked(
        "K1", K.program_mask_tensor, lambda prog, cols: cols[0].device))
    monkeypatch.setattr(K, "sorted_intersect_counts_deferred", checked(
        "K2", K.sorted_intersect_counts_deferred, lambda l, r, dev: resolve_device(dev)))
    monkeypatch.setattr(tdist, "eval_mask", checked(
        "torch_mask", tdist.eval_mask, lambda e, shim, arrays: next(iter(arrays.values())).device))
    for mod in (tbuild, tshuffle):
        monkeypatch.setattr(mod, "scatter_blocks", checked(
            "scatter", mod.scatter_blocks, lambda planes, dest, D, cap: dest.device))
    monkeypatch.setattr(tbuild.DeviceFetch, "__init__", checked(
        "fetch", tbuild.DeviceFetch.__init__,
        lambda self, tensors: tensors[0].device if tensors else None))
    run, want = _scope_programs()[program]
    D = 3
    run(torch_mesh(D, device="cpu"))
    assert seen == want | {"fetch"}
    assert len(entered) >= D


@pytest.mark.gpu
def test_distributed_filter_and_join_on_the_card():
    """On a card: 4 shards on cuda:0, one K1 a shard for the filter and one
    K2 and K2F a shard for the join, against their plain CPU versions."""
    import torch

    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.ops.kernels import K1, K2, K2F

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    table, schema = sample(n=200_000, seed=5)
    bb = split("torch", table, schema, ["k"], 16)
    pred = (texpr.col("k") > 50) & (texpr.col("k") <= 200) & (texpr.col("s") != "aa")
    card, cpu = torch_mesh(4, device="cuda:0"), torch_mesh(4, device="cpu")
    ops.reset_launch_counts()
    got = tdist.distributed_filter(bb, pred, ["k", "v", "s"], card)
    assert ops.launch_counts().get(K1) == 4
    assert_same(got, tdist.distributed_filter(bb, pred, ["k", "v", "s"], cpu))
    left, ls, right, rs = _join_sides(9, n_l=300_000, n_r=90_000, key_hi=60_000)
    lb = split("torch", left, ls, ["l_k"], 16, sort_key="l_k")
    rb = split("torch", right, rs, ["r_k"], 16, sort_key="r_k")
    ops.reset_launch_counts()
    got = tdist.distributed_bucketed_join(lb, rb, ["l_k"], ["r_k"], card)
    counts = ops.launch_counts()
    assert counts.get(K2) == 4 and counts.get(K2F) == 4
    want = tdist.distributed_bucketed_join(lb, rb, ["l_k"], ["r_k"], cpu)
    for g, w in zip(got, want):
        assert_same(g, w)


def _same_result(got, want):
    """Two results of one mesh program (a batch, a list of batches, a
    {bucket: batch}, or the sharded build's (per-shard, counts)), equal
    exactly and in order."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for b in want:
            assert_same(got[b], want[b])
    elif isinstance(want, tuple):
        (g_shards, g_counts), (w_shards, w_counts) = got, want
        assert np.array_equal(g_counts, w_counts) and len(g_shards) == len(w_shards)
        for (gb, gi), (wb, wi) in zip(g_shards, w_shards):
            assert np.array_equal(gi, wi)
            assert_same(gb, wb)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert_same(got, want)


@pytest.mark.gpu
def test_mesh_programs_across_cards():
    """On a host with several cards: one shard on each card
    (``make_mesh()``), every mesh program against the same mesh's shape on
    the CPU, exactly; K1 and K2 launch once a shard."""
    import torch

    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.ops.kernels import K1, K2, K2F

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    cards = torch_mesh()
    D = cards.size
    assert len(set(cards.devices)) == D
    cpu = torch_mesh(D, device="cpu")
    launches = {"filter_k1": {K1: D}, "aggregate": {K1: D}, "join": {K2: D, K2F: D}}
    for name, (run, _) in _scope_programs(n=200_000).items():
        ops.reset_launch_counts()
        got = run(cards)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k, v in launches.get(name, {}).items():
            assert counts.get(k) == v, (name, counts)
        _same_result(got, run(cpu))
