"""Parity of the port's query router (``distributed/router.py``) and its
fleet result cache with the JAX package's, on the CPU: one logical query
fanned out over two per-host QueryServers, partial aggregates re-merged
exactly, concatenated filters, coalescing of identical in-flight bursts,
a dead host costing zero failed tickets, the partition map, the fleet
result cache (hits with zero fan-out legs, invalidation from either
host's lifecycle op or either join side) and warm-compile hints.

Each package runs its router over two of its own sessions ("hosts") that
share one index tree of that package over the same seeded parquet, as
the reference's tests run it. Merged batches must be equal between the
packages (and equal a single session's query), and so must every
``router.*`` counter. Mirrors ``tests/test_router.py`` (6 tests) and the
router tests of ``tests/test_result_cache.py``. Tolerance: exact.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu import distributed as jdist
from hyperspace_tpu import serve as jserve
from hyperspace_tpu.compile.cache import pipeline_cache as j_pipelines
from hyperspace_tpu.exceptions import HyperspaceException as JErr
from hyperspace_tpu.exec.hbm_cache import hbm_cache as j_hbm
from hyperspace_tpu.storage import parquet_io
from hyperspace_tpu.storage.columnar import ColumnarBatch as JB
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics
from hyperspace_tpu.telemetry.recorder import flight_recorder as j_recorder

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch import distributed as tdist
from hyperspace_tpu_torch import serve as tserve
from hyperspace_tpu_torch.compile.cache import pipeline_cache as t_pipelines
from hyperspace_tpu_torch.exceptions import HyperspaceException as TErr
from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache as t_hbm
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics
from hyperspace_tpu_torch.telemetry.recorder import flight_recorder as t_recorder

# the modules (each package's ``compile`` exports the serve-level instance
# under the module's name)
jrc = importlib.import_module("hyperspace_tpu.compile.result_cache")
trc = importlib.import_module("hyperspace_tpu_torch.compile.result_cache")

N = 24_000
SPLIT = 10_000  # partition boundary on k: part 0 takes k < SPLIT

PKG = {
    "jax": SimpleNamespace(hs=hs_jax, dist=jdist, serve=jserve, rc=jrc, pipelines=j_pipelines,
                           hbm=j_hbm, metrics=jmetrics, recorder=j_recorder, err=JErr),
    "torch": SimpleNamespace(hs=hs_torch, dist=tdist, serve=tserve, rc=trc,
                             pipelines=t_pipelines, hbm=t_hbm, metrics=tmetrics,
                             recorder=t_recorder, err=TErr),
}


def counter(pkg, name):
    m = PKG[pkg].metrics
    return m.counter(name) if pkg == "jax" else m.get(name)


def counters(pkg, prefixes=("router.",)):
    snap = PKG[pkg].metrics.snapshot()
    snap = snap.get("counters", snap)
    return {k: v for k, v in snap.items() if k.startswith(prefixes)}


def reset(pkg):
    p = PKG[pkg]
    for c in (p.pipelines, p.hbm, p.rc.result_cache, p.rc.router_result_cache):
        c.reset()
    p.metrics.reset()
    p.recorder.reset()


class Fleet:
    """A seeded parquet source and, per package, two sessions over one
    index tree of that package (index ``name`` on k, covering v and g)."""

    def __init__(self, root, n=N, seed=0, k_hi=20_000, g_hi=30, name="ridx", **conf):
        rng = np.random.default_rng(seed)
        self.data = {"k": rng.integers(0, k_hi, n).astype(np.int64),
                     "v": rng.integers(-500, 1000, n).astype(np.int64),
                     "g": rng.integers(0, g_hi, n).astype(np.int64)}
        self.root, self.name, self.conf = root, name, conf
        self.src = root / "data"
        self.src.mkdir()
        parquet_io.write_parquet(self.src / "part-0.parquet", JB.from_pydict(self.data))

    def session(self, pkg):
        values = {"hyperspace.system.path": str(self.root / f"indexes_{pkg}"),
                  "hyperspace.index.numBuckets": 8, **self.conf}
        if pkg == "torch":
            values["hyperspace.torch.device"] = "cpu"
        hs = PKG[pkg].hs
        return hs.HyperspaceSession(hs.HyperspaceConf(values))

    def hosts(self, pkg):
        """(session_a, session_b): a builds the index, both serve it."""
        hs = PKG[pkg].hs
        a = self.session(pkg)
        hs.Hyperspace(a).create_index(a.read.parquet(str(self.src)),
                                      hs.IndexConfig(self.name, ["k"], ["v", "g"]))
        a.enable_hyperspace()
        b = self.session(pkg)
        b.enable_hyperspace()
        return a, b

    def read(self, session):
        return session.read.parquet(str(self.src))


def part_filter(pkg, df, part_index, n_parts, split=SPLIT):
    assert n_parts == 2
    col = PKG[pkg].hs.col
    return df.filter(col("k") < split) if part_index == 0 else df.filter(col("k") >= split)


def full_aggs(pkg):
    hs = PKG[pkg].hs
    return (hs.agg_sum("v", "sv"), hs.agg_count(None, "n"), hs.agg_avg("v", "av"),
            hs.agg_min("v", "mn"), hs.agg_max("v", "mx"))


def agg_builder(fleet, pkg, aggs=full_aggs, split=SPLIT):
    def build(session, part_index, n_parts):
        df = part_filter(pkg, fleet.read(session), part_index, n_parts, split)
        return df.group_by("g").agg(*aggs(pkg))
    return build


def canon(batch, keys=("g",)):
    order = np.lexsort([np.asarray(batch.columns[k].data) for k in reversed(keys)])
    return batch.take(order)


def assert_equal(a, b, sort=None):
    """Column names and values equal (rows sorted by ``sort`` first)."""
    assert list(a.column_names) == list(b.column_names)
    if sort is not None:
        a, b = canon(a, sort), canon(b, sort)
    for name in a.column_names:
        np.testing.assert_array_equal(np.asarray(a.columns[name].data),
                                      np.asarray(b.columns[name].data), err_msg=name)


def make_router(pkg, a, b, **cfg):
    s = PKG[pkg].serve
    return PKG[pkg].dist.QueryRouter({"a": s.QueryServer(a, s.ServeConfig(max_workers=2, **cfg)),
                                      "b": s.QueryServer(b, s.ServeConfig(max_workers=2, **cfg))})


def both(fleet, scenario):
    """``scenario(pkg, session_a, session_b)`` for each package from reset
    caches and counters; returns {pkg: (its result, router counters)}."""
    out = {}
    for pkg in PKG:
        reset(pkg)
        a, b = fleet.hosts(pkg)
        out[pkg] = (scenario(pkg, a, b), counters(pkg))
    assert out["torch"][1] == out["jax"][1]
    return out


@pytest.fixture
def fleet(tmp_path):
    return Fleet(tmp_path)


def test_router_needs_hosts():
    for pkg in PKG:
        with pytest.raises(PKG[pkg].err):
            PKG[pkg].dist.QueryRouter({})


def test_router_agg_merge_bit_identical(fleet):
    """A two-host aggregate equals the single-session aggregate exactly
    (int partial sums re-merge exactly; avg divides the same S by the same
    N), in both packages, and the packages agree."""
    def run(pkg, a, b):
        router = make_router(pkg, a, b).start()
        try:
            merged = router.submit(agg_builder(fleet, pkg)).result(timeout=120)
        finally:
            router.close()
        single = canon(fleet.read(a).group_by("g").agg(*full_aggs(pkg)).collect())
        assert_equal(merged, single)
        return merged

    out = both(fleet, run)
    assert_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1]["router.merge.agg"] == 1
    assert out["torch"][1]["router.subqueries"] == 2


def test_router_concat_merge_non_aggregate(fleet):
    def run(pkg, a, b):
        router = make_router(pkg, a, b).start()
        try:
            got = router.submit(lambda s, i, n: part_filter(pkg, fleet.read(s), i, n)
                                .select("k", "v")).result(timeout=120)
        finally:
            router.close()
        exp = fleet.read(a).select("k", "v").collect()
        assert got.num_rows == exp.num_rows == N
        assert_equal(got, exp, sort=("k", "v"))
        return got

    out = both(fleet, run)
    assert_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1]["router.merge.concat"] == 1


def test_router_coalesces_identical_inflight_bursts(fleet):
    """The same logical burst in flight coalesces onto ONE fan-out; distinct
    literals never share a ticket; a retired ticket is not reused."""
    def run(pkg, a, b):
        col = PKG[pkg].hs.col
        router = make_router(pkg, a, b, autostart=False)

        def lookup(key):
            return lambda s, i, n: part_filter(pkg, fleet.read(s), i, n).filter(
                col("g") == key).select("k", "v")

        try:
            t1, t2, t3 = router.submit(lookup(3)), router.submit(lookup(3)), router.submit(lookup(4))
            assert t2 is t1 and t3 is not t1
            assert router.stats()["coalesced"] == 1
            router.start()
            r1, r3 = t1.result(timeout=120), t3.result(timeout=120)
            t4 = router.submit(lookup(3))
            assert t4 is not t1
            r4 = t4.result(timeout=120)
        finally:
            router.close()
        exp = fleet.read(a).filter(col("g") == 3).select("k", "v").collect()
        assert_equal(r1, exp, sort=("k", "v"))
        assert_equal(r4, exp, sort=("k", "v"))
        return r1, r3

    out = both(fleet, run)
    for got, want in zip(out["torch"][0], out["jax"][0]):
        assert_equal(got, want, sort=("k", "v"))
    assert out["torch"][1]["router.coalesced"] == 1
    assert out["torch"][1]["router.fanout"] == 3


def test_router_degrades_dead_host_to_survivor(fleet):
    """A host dead at fan-out costs ZERO failed tickets: its partition is
    re-issued on the survivor's session, counted and flight-recorded."""
    def run(pkg, a, b):
        router = make_router(pkg, a, b).start()
        try:
            router.hosts["b"].close()
            merged = router.submit(agg_builder(fleet, pkg)).result(timeout=120)
            assert router.stats()["hosts_lost"] == 1
        finally:
            router.close()
        assert any(s["reason"].startswith("router_host_lost: b")
                   for s in PKG[pkg].recorder.snapshots())
        assert_equal(merged, canon(fleet.read(a).group_by("g").agg(*full_aggs(pkg)).collect()))
        return merged

    out = both(fleet, run)
    assert_equal(out["torch"][0], out["jax"][0])
    c = out["torch"][1]
    assert (c["router.host_lost"], c["router.retried"]) == (1, 1)


def test_partition_map_from_shared_placement(fleet):
    def run(pkg, a, b):
        router = make_router(pkg, a, b, autostart=False)
        try:
            owned = router.partition_map()
            assert owned == router.partition_map(index_name="ridx")
            with pytest.raises(PKG[pkg].err):
                router.partition_map(index_name="nope")
        finally:
            router.close()
        return owned

    out = both(fleet, run)
    # 8 buckets over 2 hosts under the b % n rule: even/odd
    assert out["torch"][0] == out["jax"][0] == {"a": [0, 2, 4, 6], "b": [1, 3, 5, 7]}


# ---------------------------------------------------------------------------
# the fleet result cache (router_result_cache) and warm-compile hints
# ---------------------------------------------------------------------------
def _put_admitted(rc, key, nbytes, cost_s, roots):
    verdict = rc.put(key, object(), roots, 16, 10**9, cost_s=cost_s, repeats=8,
                     byte_rate=1 << 20, total_max_bytes=10**9, nbytes=nbytes)
    assert verdict == "admitted"


def test_router_cache_invalidates_on_either_join_side():
    """A fleet entry anchored to TWO index roots (a join's sides) drops
    when EITHER side is rewritten, through either level's hook."""
    for pkg in PKG:
        reset(pkg)
        rc = PKG[pkg].rc
        for doomed_root, drop in (("/ix/left", rc.router_result_cache.invalidate),
                                  ("/ix/right", rc.invalidate_all)):
            _put_admitted(rc.router_result_cache, ("sig", ("ta", "tb")), nbytes=64, cost_s=1.0,
                          roots=("/ix/left/part.bin", "/ix/right/part.bin"))
            assert rc.router_result_cache.snapshot()["entries"] == 1
            assert drop(doomed_root) == 1
            assert rc.router_result_cache.snapshot()["entries"] == 0
        assert counter(pkg, "router.result_cache.invalidated") == 2
    from hyperspace_tpu_torch.residency import tiers

    _put_admitted(trc.router_result_cache, ("s", "t"), nbytes=600_000, cost_s=5.0,
                  roots=("/ix/a/part.bin",))
    assert tiers.claimant_bytes() == 600_000  # charged to the residency budget
    trc.router_result_cache.reset()


@pytest.fixture
def cached_fleet(tmp_path):
    return Fleet(tmp_path, seed=3, name="rrx", **{"hyperspace.compile.resultCache": "on"})


def test_router_repeat_query_hits_with_zero_fanout_legs(cached_fleet):
    fleet = cached_fleet

    def run(pkg, a, b):
        router = make_router(pkg, a, b).start()
        try:
            build = agg_builder(fleet, pkg, aggs=lambda p: (PKG[p].hs.agg_sum("v", "sv"),
                                                           PKG[p].hs.agg_count(None, "n")))
            r1 = router.submit(build).result(timeout=120)  # cold: declined
            r2 = router.submit(build).result(timeout=120)  # repeat: admitted
            assert PKG[pkg].rc.router_result_cache.snapshot()["entries"] == 1
            legs = counter(pkg, "router.subqueries"), counter(pkg, "router.fanout")
            r3 = router.submit(build).result(timeout=120)
            # the fleet hit costs ZERO fan-out legs
            assert (counter(pkg, "router.subqueries"), counter(pkg, "router.fanout")) == legs
            assert router.stats()["result_cache"]["entries"] == 1
            served = router.hosts["a"].stats()["result_cache"]
        finally:
            router.close()
        for r in (r1, r2):
            assert_equal(r, r3)
        assert served["router"]["entries"] == 1
        assert served["router_counters"]["hits"] == 1
        return r3

    out = both(fleet, run)
    assert_equal(out["torch"][0], out["jax"][0])
    c = out["torch"][1]
    assert (c["router.result_cache.hit"], c["router.result_cache.admitted"]) == (1, 1)


def test_router_cache_dropped_by_refresh_from_either_host(cached_fleet):
    fleet = cached_fleet

    def run(pkg, a, b):
        hs = PKG[pkg].hs
        rrc = PKG[pkg].rc.router_result_cache
        router = make_router(pkg, a, b).start()
        try:
            build = agg_builder(fleet, pkg, aggs=lambda p: (PKG[p].hs.agg_sum("v", "sv"),
                                                           PKG[p].hs.agg_count(None, "n")))
            expected = router.submit(build).result(timeout=120)
            router.submit(build).result(timeout=120)
            assert rrc.snapshot()["entries"] == 1
            # host b's lifecycle op (same shared index log) drops the fleet
            # entry that host a's fan-out stored
            hs.Hyperspace(b).refresh_index("rrx")
            assert rrc.snapshot()["entries"] == 0
            out = router.submit(build).result(timeout=120)  # recompute, exact
            assert_equal(expected, out)
            assert rrc.snapshot()["entries"] == 1  # re-admitted
            hs.Hyperspace(a).optimize_index("rrx")  # ... and host a's op symmetrically
            assert rrc.snapshot()["entries"] == 0
        finally:
            router.close()
        return out

    out = both(fleet, run)
    assert_equal(out["torch"][0], out["jax"][0])


def test_router_warm_hints_pre_lower_on_sibling_hosts(cached_fleet):
    fleet = cached_fleet
    key = int(fleet.data["k"][17])

    def run(pkg, a, b):
        col = PKG[pkg].hs.col
        router = make_router(pkg, a, b).start()
        try:
            router.submit(lambda s, i, n: part_filter(pkg, fleet.read(s), i, n)
                          .filter(col("k") == key).select("k", "v")).result(timeout=120)
            # a cold fleet (both hosts' pipelines gone); the hint book remembers
            PKG[pkg].pipelines.reset()
            first = router.offer_warm_hints()
            assert counter(pkg, "compile.warm_hint.adopted") == first["adopted"] >= 1
            second = router.offer_warm_hints()  # every host already warm
            assert second["adopted"] == 0 and second["declined"] == second["offered"]
            snap = router.hosts["a"].stats()["compile"]
        finally:
            router.close()
        assert snap["warm_hints_adopted"] == first["adopted"]
        return first, second

    out = both(fleet, run)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0][0]["offered"] >= 2
