"""The port's shuffle join (``hyperspace_tpu_torch/distributed/``): the
movement planner, the one-round all_to_all repartition and the join of two
indexes built with DIFFERENT numBuckets, against the JAX package's on the
CPU (its 8-device virtual mesh with ``HYPERSPACE_TPU_HBM=off``; the port's
``make_mesh(D, device="cpu")``): decisions, memo hits and spans, moved
buckets and their rows in order, join rows in the exact order, counters,
the compiled ``join_shuffle`` kind and explain(verbose)'s movement-plan
table; and an exchange lost mid-flight (a ``RuntimeError``) answered by
the exact join with ``shuffle.device_failed`` = 1, while a
``KernelBuildError`` is not caught. Mirrors ``tests/test_shuffle_join.py``.
Tolerance: exact.
"""

import numpy as np
import pytest

from hyperspace_tpu.distributed import planner as jplanner
from hyperspace_tpu.distributed import shuffle as jshuffle
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics
from hyperspace_tpu.telemetry.recorder import flight_recorder as j_recorder
from hyperspace_tpu.telemetry.trace import start_trace as j_start_trace

from hyperspace_tpu_torch.distributed import planner as tplanner
from hyperspace_tpu_torch.distributed import shuffle as tshuffle
from hyperspace_tpu_torch.exceptions import KernelBuildError
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics
from hyperspace_tpu_torch.telemetry.recorder import flight_recorder as t_recorder
from hyperspace_tpu_torch.telemetry.trace import start_trace as t_start_trace

from tests.test_torch_aggregate import assert_same
from tests.test_torch_distributed_query import EXPR, Tree, meshes, split

PLANNERS = {"jax": jplanner, "torch": tplanner}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "off")
    jmetrics.reset()
    tmetrics.reset()
    for p in PLANNERS.values():
        p.reset_plan_memo()
    from hyperspace_tpu_torch.exec import executor as texec
    from hyperspace_tpu_torch.exec import joins as tjoins

    texec.reset_groups_cache()
    tjoins.reset_setup_cache()
    yield


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
PLAN_CASES = [
    (({0: 100}, {1: 100}, 8, 8, 8, 0), {}),
    (({0: 9}, {0: 9}, 8, 16, 1, 0), {}),
    (({}, {0: 9}, 8, 16, 8, 0), {}),
    (({0: 3}, {0: 4}, 8, 16, 8, 1000), {}),
    (({0: 10}, {0: 500}, 8, 16, 8, 0), {}),
    (({0: 500}, {0: 10}, 8, 16, 8, 0), {"n_payload_planes": 3}),
]


@pytest.mark.parametrize("args,kw", PLAN_CASES)
def test_planner_decisions_match_reference(args, kw):
    got = tplanner.plan_movement(*args, **kw)
    want = jplanner.plan_movement(*args, **kw)
    assert got.__dict__ == want.__dict__
    for path in ("direct", "host", "shuffle"):
        assert tmetrics.get(f"shuffle.plan.{path}") == jmetrics.counter(f"shuffle.plan.{path}")


def test_planner_memoizes_per_histogram_class():
    for name, p in PLANNERS.items():
        first = p.plan_movement({0: 40, 1: 60}, {0: 900}, 8, 16, 8, 0)
        again = p.plan_movement({0: 41, 1: 59}, {0: 901}, 8, 16, 8, 0)
        assert not first.memo_hit and again.memo_hit and again.path == first.path
        assert not p.plan_movement({0: 40, 1: 60}, {0: 900}, 8, 16, 4, 0).memo_hit
        p.reset_plan_memo()
        assert not p.plan_movement({0: 40, 1: 60}, {0: 900}, 8, 16, 8, 0).memo_hit
    assert tmetrics.get("shuffle.plan.memo_hit") == jmetrics.counter("shuffle.plan.memo_hit") == 1


def test_planner_records_its_span():
    labels = {}
    for name, p, start in (("jax", jplanner, j_start_trace), ("torch", tplanner, t_start_trace)):
        with start("query.collect", origin="test") as t:
            p.plan_movement({0: 50}, {0: 600}, 8, 16, 8, 0)
        labels[name] = dict(t.find("shuffle.plan").labels)
    assert labels["torch"] == labels["jax"]
    assert labels["torch"]["decision"] == "shuffle" and labels["torch"]["moved_side"] == "left"


# ---------------------------------------------------------------------------
# the repartition
# ---------------------------------------------------------------------------
def _sample(n=1800, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 5, n)
    f[::29] = -0.0
    f[3::97] = np.inf
    return ({"k": rng.integers(0, 250, n).astype(np.int64),
             "v": rng.integers(0, 10**6, n).astype(np.int64),
             "s": rng.choice(["aa", "bb", "cc", "dd"], n).astype(object),
             "f32": rng.normal(0, 5, n).astype(np.float32),
             "f": f},
            {"k": "int64", "v": "int64", "s": "string", "f32": "float32", "f": "float64"})


@pytest.mark.parametrize("D", [3, 8])
@pytest.mark.parametrize("target", [16, 7])
def test_repartition_matches_reference(D, target):
    """One round moves every row to its bucket in the TARGET space, strings
    (vocab reattached) and floats (ordered-int64 transport) included; each
    bucket's rows in the reference's order."""
    table, schema = _sample(seed=D + target)
    jm, tm = meshes(D)
    want = jshuffle.repartition_by_bucket(split("jax", table, schema, ["k"], 8), ["k"],
                                          target, jm)
    got = tshuffle.repartition_by_bucket(split("torch", table, schema, ["k"], 8), ["k"],
                                         target, tm)
    assert sorted(got) == sorted(want)
    for b in want:
        assert_same(got[b], want[b])
    for c in ("shuffle.rounds", "shuffle.rows_moved", "shuffle.ici_bytes"):
        assert tmetrics.get(c) == jmetrics.counter(c), c
    assert tmetrics.get("shuffle.rounds") == 1 and tmetrics.get("shuffle.rows_moved") == 1800
    assert tmetrics.get("shuffle.h2d_bytes") > 0 and tmetrics.get("shuffle.d2h_bytes") > 0


def test_repartition_empty_input():
    _, tm = meshes(8)
    assert tshuffle.repartition_by_bucket({}, ["k"], 16, tm) == {}


@pytest.mark.parametrize("moved", ["left", "right"])
def test_try_shuffle_join_matches_reference(moved):
    rng = np.random.default_rng(23)
    left = {"l_k": rng.integers(0, 120, 700).astype(np.int64),
            "l_v": np.arange(700, dtype=np.int64)}
    right = {"r_k": rng.integers(0, 120, 2400).astype(np.int64),
             "r_v": np.arange(2400, dtype=np.int64)}
    ls, rs = {"l_k": "int64", "l_v": "int64"}, {"r_k": "int64", "r_v": "int64"}
    l_nb, r_nb = (8, 16) if moved == "left" else (16, 8)
    target = r_nb if moved == "left" else l_nb
    jm, tm = meshes(8)
    out = {}
    for pkg, mod, mesh in (("jax", jshuffle, jm), ("torch", tshuffle, tm)):
        lb = split(pkg, left, ls, ["l_k"], l_nb, "l_k")
        rb = split(pkg, right, rs, ["r_k"], r_nb, "r_k")
        out[pkg] = mod.try_shuffle_join(lb, rb, ["l_k"], ["r_k"], moved, target, mesh, 0)
    assert len(out["torch"]) == len(out["jax"]) > 0
    for g, w in zip(out["torch"], out["jax"]):
        assert_same(g, w)
    for c in ("scan.path.resident_join_shuffle", "join.path.distributed", "shuffle.rounds"):
        assert tmetrics.get(c) == jmetrics.counter(c) == 1, c


# ---------------------------------------------------------------------------
# the executor and the session
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """li_idx at 12 buckets, od_idx at 5: no shared bucket space."""
    return Tree(tmp_path_factory.mktemp("shuffle_tree"), od_buckets=5)


def _q(t, s, E):
    return t.read(s, "li").select("l_k", "l_q").join(t.read(s, "od").select("o_k", "o_t"),
                                                     E.col("l_k") == E.col("o_k"))


def _both(t, D, query=_q, **conf):
    jm, tm = meshes(D)
    return {pkg: query(t, t.session(pkg, mesh, **conf), EXPR[pkg]) for pkg, mesh in
            (("jax", jm), ("torch", tm))}


SHUFFLE_COUNTERS = ("scan.path.resident_join_shuffle", "shuffle.rounds", "shuffle.rows_moved",
                    "shuffle.ici_bytes", "shuffle.plan.shuffle", "shuffle.plan.host",
                    "shuffle.declined.below_min_rows", "shuffle.declined.device_failed",
                    "shuffle.declined.no_mesh", "shuffle.device_failed",
                    "join.path.distributed", "compile.fused.dispatches")


@pytest.mark.parametrize("D", [3, 8])
def test_session_shuffle_join_matches_reference(tree, D):
    dfs = _both(tree, D)
    got = {pkg: df.collect() for pkg, df in dfs.items()}
    assert_same(got["torch"], got["jax"])  # exact order
    assert got["torch"].num_rows > 0
    for c in SHUFFLE_COUNTERS:
        assert tmetrics.get(c) == jmetrics.counter(c), c
    assert tmetrics.get("shuffle.rounds") == 1 and tmetrics.get("join.path.distributed") == 1
    # the smaller side (od) moved, all of it
    assert tmetrics.get("shuffle.rows_moved") == 800
    single = _q(tree, tree.session("torch", None), texpr).collect()
    assert_same(got["torch"], single, ordered=False, keys=list(single.column_names))


def test_session_explain_and_pipeline_kind(tree):
    dfs = _both(tree, 8)
    sections = {}
    for pkg, df in dfs.items():
        df.collect()
        s = df.session
        sp = s.last_trace.find("shuffle.plan")
        assert sp is not None and sp.labels["decision"] == "shuffle"
        assert s.last_trace.meta["pipeline"]["kind"] == "join_shuffle"
        text = df.explain(verbose=True)
        start = text.index("Shuffle movement plan (last query):")
        sections[pkg] = text[start:].split("Last query trace (spans):")[0]
        if pkg == "torch":
            comp = text[text.index("Whole-plan compilation (last query):"):start]
    assert sections["torch"] == sections["jax"]
    assert "Decision: shuffle (repartition_right)" in sections["torch"]
    assert "Moved side: right" in sections["torch"]
    assert "Pipeline kind: join_shuffle" in comp and "Residency tier at lowering: mesh" in comp


def test_below_min_rows_declines_to_the_exact_join(tree):
    dfs = _both(tree, 8, **{"hyperspace.tpu.distributedQuery.minRows": 10**9})
    got = {pkg: df.collect() for pkg, df in dfs.items()}
    assert_same(got["torch"], got["jax"])
    for c in SHUFFLE_COUNTERS:
        assert tmetrics.get(c) == jmetrics.counter(c), c
    assert tmetrics.get("shuffle.declined.below_min_rows") == 1
    assert tmetrics.get("shuffle.rounds") == 0


def test_no_mesh_declines_as_the_reference(tree):
    got = {pkg: _q(tree, tree.session(pkg, None), EXPR[pkg]).collect()
           for pkg in ("jax", "torch")}
    assert_same(got["torch"], got["jax"])
    assert tmetrics.get("shuffle.declined.no_mesh") == jmetrics.counter(
        "shuffle.declined.no_mesh") == 1


def test_exchange_lost_mid_flight_answers_through_the_exact_join(tree, monkeypatch):
    """A RuntimeError out of the exchange: shuffle.device_failed = 1, a
    flight-recorder snapshot, and the exact join's rows, in both packages."""
    def boom_fn(mesh_, dtypes_sig, cap):
        def fn(*a, **k):
            raise RuntimeError("injected: device lost mid all_to_all")
        return fn

    def boom(blocks, mesh):
        raise RuntimeError("injected: device lost mid all_to_all")

    monkeypatch.setattr(jshuffle, "_shuffle_fn", boom_fn)
    monkeypatch.setattr(tshuffle, "all_to_all", boom)
    j_recorder.reset()
    t_recorder.reset()
    got = {pkg: df.collect() for pkg, df in _both(tree, 8).items()}
    assert_same(got["torch"], got["jax"], ordered=False, keys=["l_k", "l_q", "o_k", "o_t"])
    for c in SHUFFLE_COUNTERS:
        assert tmetrics.get(c) == jmetrics.counter(c), c
    assert tmetrics.get("shuffle.device_failed") == 1
    assert tmetrics.get("shuffle.declined.device_failed") == 1
    for rec in (j_recorder, t_recorder):
        assert any(s["reason"].startswith("shuffle_device_loss") for s in rec.snapshots())
    single = _q(tree, tree.session("torch", None), texpr).collect()
    assert_same(got["torch"], single)  # the exact join's own order


def test_kernel_build_error_is_not_caught(tree, monkeypatch):
    def broken(blocks, mesh):
        raise KernelBuildError("injected: a kernel that cannot build")

    monkeypatch.setattr(tshuffle, "all_to_all", broken)
    _, tm = meshes(8)
    with pytest.raises(KernelBuildError):
        _q(tree, tree.session("torch", tm), texpr).collect()
    assert tmetrics.get("shuffle.device_failed") == 0
