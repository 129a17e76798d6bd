"""Parity of the port's whole-plan compiler (``hyperspace_tpu_torch/
compile/``) with the JAX package's, on the CPU: one index tree over one
avro source, served by sessions of both packages with residency forced.
For each case the rows, the ``compile.*`` counters (pipeline cache hits
and misses, runs per kind, fused dispatches, device-aggregate declines),
``classify_shape``'s kinds and the fingerprints' equality classes must be
equal between the packages. The port runs its kernels' plain versions
(K1c's, K1's) here; the JAX package its XLA programs. Mirrors
``tests/test_compile.py`` and ``tests/test_result_cache.py``. Tolerance:
rows, counts and integer aggregates exact; float aggregates
``rtol=1e-9``.
"""

import threading

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.compile.cache import pipeline_cache as j_pipelines
from hyperspace_tpu.compile.result_cache import result_cache as j_results
from hyperspace_tpu.exec import hbm_cache as jh
from hyperspace_tpu.residency import knobs as jknobs
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.compile.cache import pipeline_cache as t_pipelines
from hyperspace_tpu_torch.compile.result_cache import result_cache as t_results
from hyperspace_tpu_torch.exec import hbm_cache as th
from hyperspace_tpu_torch.storage import avro_io
from hyperspace_tpu_torch.storage.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_aggregate import assert_same

PKGS = {"jax": hs_jax, "torch": hs_torch}
N_ROWS = 12_000


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Residency forced in both packages (the reference by environment,
    the port by conf), every process-wide cache empty, counters zero."""
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MIN_ROWS", "1")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MAX_BLOCK_FRAC", "1.0")
    jknobs.reset_conf_defaults()
    for c in (jh.hbm_cache, th.hbm_cache, j_pipelines, t_pipelines, j_results, t_results):
        c.reset()
    jmetrics.reset()
    tmetrics.reset()
    yield
    for c in (jh.hbm_cache, th.hbm_cache, j_pipelines, t_pipelines, j_results, t_results):
        c.reset()


def source_batch(n=N_ROWS, seed=0, key_lo=0, key_hi=8000):
    rng = np.random.default_rng(seed)
    return ColumnarBatch({
        "k": Column("int64", rng.integers(key_lo, key_hi, n)),
        "v": Column("int64", rng.integers(-(1 << 30), 1 << 30, n)),
        "g": Column("int64", rng.integers(0, 40, n)),
        "d": Column("float64", np.round(rng.uniform(0.0, 100.0, n), 3)),
    })


class Env:
    """One avro source (``data``, and ``dim`` for joins), one index tree
    the port built, and fresh sessions of both packages over them."""

    def __init__(self, root):
        self.root = root
        self.conf = {"hyperspace.system.path": str(root / "indexes"),
                     "hyperspace.index.numBuckets": 4}

    def session(self, pkg, **conf):
        values = {**self.conf, **conf}
        if pkg == "torch":
            values.update({"hyperspace.torch.device": "cpu", "hyperspace.torch.hbm.mode": "force",
                           "hyperspace.torch.hbm.minRows": 1,
                           "hyperspace.torch.hbm.maxBlockFrac": 1.0})
        mod = PKGS[pkg]
        return mod.HyperspaceSession(mod.HyperspaceConf(values)).enable_hyperspace()

    def read(self, s, table="data"):
        return s.read.avro(str(self.root / table))

    def prefetch(self, pkg, s, name="idx", columns=("k", "v", "g", "d")):
        assert PKGS[pkg].Hyperspace(s).prefetch_index(name, list(columns))


def make_env(root, hybrid=False) -> Env:
    env = Env(root)
    if hybrid:
        env.conf.update({"hyperspace.index.hybridscan.enabled": True,
                         "hyperspace.index.lineage.enabled": True})
    avro_io.write_avro(root / "data" / "part-0.avro", source_batch())
    dim = ColumnarBatch({"dk": Column("int64", np.arange(8000)),
                         "w": Column("int64", np.arange(8000) % 97)})
    avro_io.write_avro(root / "dim" / "part-0.avro", dim)
    s = env.session("torch")
    h = hs_torch.Hyperspace(s)
    h.create_index(env.read(s), hs_torch.IndexConfig("idx", ["k"], ["v", "g", "d"]))
    h.create_index(env.read(s, "dim"), hs_torch.IndexConfig("didx", ["dk"], ["w"]))
    return env


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory.mktemp("compile"))


def lookup(env, s, mod, key):
    return env.read(s).filter(mod.col("k") == int(key)).select("k", "v")


def compile_counts(m) -> dict:
    """The compile.* counters of a package's registry (names equal in both)."""
    snap = m.snapshot()
    snap = snap.get("counters", snap)
    return {k: v for k, v in snap.items() if k.startswith("compile.")}


def both(env, run, prefetch=True, **conf):
    """``run(env, session, module)`` in each package's fresh session;
    returns {pkg: (result, compile counters)}."""
    out = {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg, **conf)
        if prefetch:
            env.prefetch(pkg, s)
        m = jmetrics if pkg == "jax" else tmetrics
        m.reset()
        out[pkg] = (run(env, s, mod), compile_counts(m))
    return out


def test_scan_burst_shares_one_pipeline_with_parity(env):
    """Six lookups of one structure with fresh literals: one lowering, five
    cache hits, six fused dispatches; rows equal."""
    keys = [5, 77, 1234, 4321, 6000, 7999]

    def run(env, s, mod):
        return [lookup(env, s, mod, k).collect() for k in keys]

    out = both(env, run)
    for got, exp in zip(out["torch"][0], out["jax"][0]):
        assert_same(got, exp, ordered=False, keys=["k", "v"])
    assert out["torch"][1] == out["jax"][1]
    c = out["torch"][1]
    assert (c["compile.cache.miss"], c["compile.cache.hit"], c["compile.run.scan"],
            c["compile.fused.dispatches"]) == (1, 5, 6, 6)


QUERIES = {  # name: a DataFrame of (env, session, module)
    "lookup_a": lambda e, s, m: lookup(e, s, m, 3),
    "lookup_b": lambda e, s, m: lookup(e, s, m, 4000),
    "range_a": lambda e, s, m: e.read(s).filter((m.col("k") >= 10) & (m.col("k") < 500))
    .select("k", "v", "g"),
    "range_b": lambda e, s, m: e.read(s).filter((m.col("k") >= 900) & (m.col("k") < 950))
    .select("k", "v", "g"),
    "range_other_cols": lambda e, s, m: e.read(s).filter((m.col("k") >= 10) & (m.col("k") < 500))
    .select("k", "d"),
    "in_2": lambda e, s, m: e.read(s).filter(m.is_in(m.col("k"), [1, 2])).select("k", "v"),
    "in_3": lambda e, s, m: e.read(s).filter(m.is_in(m.col("k"), [1, 2, 9])).select("k", "v"),
    "in_3b": lambda e, s, m: e.read(s).filter(m.is_in(m.col("k"), [4, 5, 6])).select("k", "v"),
    "agg": lambda e, s, m: e.read(s).filter(m.col("k") >= 100).group_by("g")
    .agg(m.agg_sum("v"), m.agg_count()),
    "agg_b": lambda e, s, m: e.read(s).filter(m.col("k") >= 7000).group_by("g")
    .agg(m.agg_sum("v"), m.agg_count()),
    "global_agg": lambda e, s, m: e.read(s).filter(m.col("k") >= 100).group_by()
    .agg(m.agg_count()),
    "join_agg": lambda e, s, m: e.read(s).join(e.read(s, "dim"), m.col("k") == m.col("dk"))
    .group_by("k").agg(m.agg_sum("w")),
    "join": lambda e, s, m: e.read(s).join(e.read(s, "dim"), m.col("k") == m.col("dk"))
    .select("k", "w"),
    "no_index": lambda e, s, m: e.read(s).filter(m.col("v") > 0).select("v"),
}


def test_fingerprint_classes_and_shapes_match(env):
    """Over the optimized plans of both packages: classify_shape's kinds,
    and which plans share a fingerprint (literals masked, structure, IN's
    arity and projections kept)."""
    from hyperspace_tpu.compile import fingerprint as jfp
    from hyperspace_tpu.compile import lowering as jlow
    from hyperspace_tpu_torch.compile import fingerprint as tfp
    from hyperspace_tpu_torch.compile import lowering as tlow

    kinds, classes = {}, {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg)
        plans = {n: q(env, s, mod).optimized_plan() for n, q in QUERIES.items()}
        fp, low = (jfp, jlow) if pkg == "jax" else (tfp, tlow)
        kinds[pkg] = {n: low.classify_shape(p).kind for n, p in plans.items()}
        prints = {n: fp.plan_fingerprint(p) for n, p in plans.items()}
        classes[pkg] = sorted(sorted(n for n in prints if prints[n] == prints[m]) for m in prints)
        assert fp.batch_fingerprint(plans["lookup_a"]) == fp.batch_fingerprint(plans["lookup_b"])
    assert kinds["torch"] == kinds["jax"]
    assert set(kinds["torch"].values()) == {"scan", "agg_scan", "join_agg", "interpret"}
    assert classes["torch"] == classes["jax"]
    assert ["lookup_a", "lookup_b"] in classes["torch"] and ["in_3", "in_3b"] in classes["torch"]


def test_agg_scan_runs_on_the_device_with_parity(env):
    """The agg_scan pipeline aggregates on the card when the table covers
    the group and aggregate columns: one fused dispatch, compile.agg.device,
    groups as the reference's."""
    def run(env, s, mod):
        return (env.read(s).filter(mod.col("k") >= 300).group_by("g")
                .agg(mod.agg_sum("v", "sv"), mod.agg_avg("d", "ad"), mod.agg_min("v", "mv"),
                     mod.agg_count()).collect())

    out = both(env, run)
    assert_same(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][1]["compile.agg.device"] == 1
    assert out["torch"][1]["compile.fused.dispatches"] == 1


def gate_population(monkeypatch, cache) -> threading.Event:
    """Hold ``cache``'s background population until the returned event is
    set: a query that schedules it then finishes before the table can be
    registered, whatever the threads' order."""
    opened = threading.Event()
    build = cache._build

    def gated(*args, **kwargs):
        opened.wait()
        return build(*args, **kwargs)

    monkeypatch.setattr(cache, "_build", gated)
    return opened


@pytest.mark.parametrize("reason", ["shape", "no_table"])
def test_agg_scan_declines_are_counted(env, reason, monkeypatch):
    """A global aggregate declines ``shape``; a table not yet resident
    declines ``no_table`` and schedules the population of the predicate
    and aggregate columns, so the next query aggregates on the card. The
    population is held until the first query has returned (its host tail
    must not find the table)."""
    gates = {mod: gate_population(monkeypatch, (jh if mod is hs_jax else th).hbm_cache)
             for mod in (hs_jax, hs_torch)}

    def run(env, s, mod):
        q = env.read(s).filter(mod.col("k") >= 300)
        q = q.group_by().agg(mod.agg_count()) if reason == "shape" else \
            q.group_by("g").agg(mod.agg_sum("v"))
        res = q.collect()
        gates[mod].set()
        if reason == "no_table":
            (jh if mod is hs_jax else th).hbm_cache.wait_background()
            again = q.collect()
            assert_same(again, res, ordered=False, keys=["g"])
        return res

    out = both(env, run, prefetch=False)
    assert_same(out["torch"][0], out["jax"][0], ordered=False, keys=out["torch"][0].column_names)
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][1][f"compile.agg.declined.{reason}"] == 1
    assert out["torch"][1].get("compile.agg.device", 0) == (reason == "no_table")


def test_compile_off_interprets(env):
    """``hyperspace.compile.mode=off``: no pipeline, no compile counter,
    the same rows."""
    def run(env, s, mod):
        res = lookup(env, s, mod, 77).collect()
        assert s.last_pipeline_info is None
        return res

    out = both(env, run, **{"hyperspace.compile.mode": "off"})
    assert_same(out["torch"][0], out["jax"][0], ordered=False, keys=["k", "v"])
    assert out["torch"][1] == out["jax"][1] == {}


def test_join_agg_pipeline_parity(env):
    """The join_agg pipeline: the host range fusion on a cold cache, the
    region launch once the region is resident (the first run schedules
    it); rows equal."""
    def run(env, s, mod):
        q = QUERIES["join_agg"](env, s, mod)
        first = q.collect()
        (jh if mod is hs_jax else th).hbm_cache.wait_background()
        return first, q.collect()

    out = both(env, run, prefetch=False)
    for i in range(2):
        assert_same(out["torch"][0][i], out["jax"][0][i], ordered=False, keys=["k"])
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][1]["compile.run.join_agg"] == 2
    assert out["torch"][1]["compile.fused.dispatches"] == 1


def test_invalidation_scoped_to_the_refreshed_index(tmp_path):
    """A full refresh drops the pipelines whose leaves read the refreshed
    index (a join pipeline reads both) and keeps the others."""
    env = make_env(tmp_path)
    counts = {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg)
        lookup(env, s, mod, 3).collect()
        env.read(s, "dim").filter(mod.col("dk") == 5).select("dk", "w").collect()
        QUERIES["join"](env, s, mod).collect()
        cache = j_pipelines if pkg == "jax" else t_pipelines
        before = cache.snapshot()["entries"]
        avro_io.write_avro(env.root / "dim" / f"part-{pkg}.avro",
                           ColumnarBatch({"dk": Column("int64", np.arange(3)),
                                          "w": Column("int64", np.arange(3))}))
        mod.Hyperspace(s).refresh_index("didx", "full")
        counts[pkg] = (before, cache.snapshot()["entries"])
        cache.reset()
    assert counts["torch"] == counts["jax"] == (3, 1)


def test_result_cache_admission_hit_and_invalidation(tmp_path):
    """The serve tier's result cache: a structure seen once declines cold,
    the second sighting is admitted, the third is a hit; a refresh of the
    index drops the entry."""
    env = make_env(tmp_path)
    out = {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg, **{"hyperspace.compile.resultCache": "on",
                                "hyperspace.compile.resultCache.byteRatePerSec": 1 << 40})
        m = jmetrics if pkg == "jax" else tmetrics
        m.reset()
        rows = [s.submit(lookup(env, s, mod, 77)).result(timeout=60) for _ in range(3)]
        s.serve().close()
        avro_io.write_avro(env.root / "data" / f"extra-{pkg}.avro", source_batch(100, 9))
        mod.Hyperspace(s).refresh_index("idx", "full")
        snap = compile_counts(m)
        out[pkg] = ({k: snap.get(f"compile.result_cache.{k}", 0)
                     for k in ("declined_cold", "admitted", "hit", "miss", "invalidated")}, rows)
    assert out["torch"][0] == out["jax"][0] == {"declined_cold": 1, "admitted": 1, "hit": 1,
                                                "miss": 2, "invalidated": 1}
    for got, exp in zip(out["torch"][1], out["jax"][1]):
        assert_same(got, exp, ordered=False, keys=["k", "v"])


def test_explain_verbose_reads_the_last_trace(env):
    """explain(verbose)'s last-query sections: the pipeline's kind, tier
    and boundary, and "Aggregate ran:" as the reference words them."""
    sections = {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg)
        env.prefetch(pkg, s)
        q = QUERIES["agg"](env, s, mod)
        q.collect()
        text = q.explain(verbose=True)
        start = text.index("Whole-plan compilation (last query):")
        sections[pkg] = text[start:].split("Last query trace (spans):")[0]
    assert sections["torch"] == sections["jax"]
    assert "Aggregate ran: device segment-sum" in sections["torch"]
    assert "Pipeline kind: agg_scan" in sections["torch"]
