"""Parity of the port's delta residency (``hyperspace_tpu_torch/exec/
delta.py``, the delta regions of ``exec/hbm_cache.py`` and the executor's
``_try_resident_hybrid``) with the JAX package's, on the CPU. Mirrors
``tests/test_delta_residency.py``'s single-device cases: append-only and
append-plus-delete, out-of-vocabulary string equality exact and a range
over it declining, a new append changing the epoch, quick refresh keeping
the delta while full and incremental refresh and optimize invalidate it,
the selectivity gate, background population, a partly encodable delta,
budget refusal, scoped invalidation, and a dropped base dropping its
deltas.

Both packages serve ONE index tree (built by the JAX package, lineage and
hybrid scan on) over one avro source that has gained a file since. The
JAX side runs residency forced by environment variables and its mask in
the Pallas interpreter; the port runs the same knobs as session conf on
the CPU, where K1h's plain version counts base and delta. Every query's
(base counts, delta counts) and rows are held against the JAX package's
and against the host union (Hyperspace off). Tolerance: exact.
"""

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.exec import hbm_cache as jh
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.plan.ir import Union as JaxUnion
from hyperspace_tpu.plan.rules.hybrid_scan import parse_hybrid_union as j_parse
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.config import ResidencyConf
from hyperspace_tpu_torch.exec import hbm_cache as th
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.plan.ir import Union as TorchUnion
from hyperspace_tpu_torch.plan.rules.hybrid_scan import parse_hybrid_union as t_parse
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

PKGS = {"jax": hs_jax, "torch": hs_torch}
EXPR = {"jax": jexpr, "torch": texpr}
FORCE = ResidencyConf(mode="force", min_rows=1, max_block_frac=1.0)
SCHEMA = {"k": "int64", "v": "int64", "s": "string"}


@pytest.fixture(autouse=True)
def _force_residency(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MIN_ROWS", "1")
    monkeypatch.setenv("HYPERSPACE_TPU_KERNELS", "interpret")
    # tiny tables span one block: the gate would route everything host;
    # the gate's own test re-arms it
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MAX_BLOCK_FRAC", "1.0")
    jh.hbm_cache.reset()
    th.hbm_cache.reset()
    yield
    jh.hbm_cache.wait_background(timeout_s=30.0)
    th.hbm_cache.wait_background()
    jh.hbm_cache.reset()
    th.hbm_cache.reset()


def _source_batch(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return JaxBatch.from_pydict({
        "k": rng.integers(0, 500, n).astype(np.int64),
        "v": rng.integers(0, 10**6, n).astype(np.int64),
        "s": rng.choice(["aa", "bb", "cc"], n).astype(object),
    }, SCHEMA)


def _appended_batch(n=300, seed=9, modes=("aa", "zz")):
    rng = np.random.default_rng(seed)
    return JaxBatch.from_pydict({
        "k": rng.integers(0, 500, n).astype(np.int64),
        "v": rng.integers(0, 10**6, n).astype(np.int64),
        "s": rng.choice(list(modes), n).astype(object),
    }, SCHEMA)


def _values(batch):
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    return names, sorted(zip(*cols), key=repr)


class Env:
    """A 3-file avro source, the covering index didx (lineage and hybrid
    scan on, 8 buckets) built by the JAX package, one appended file, and
    sessions of both packages."""

    def __init__(self, root, **conf):
        self.root = root
        self.src = root / "data"
        self.src.mkdir()
        batch = _source_batch()
        per = batch.num_rows // 3
        for i in range(3):
            self.write(f"part-{i}.avro", batch.take(np.arange(i * per, (i + 1) * per)))
        self.base = {"hyperspace.system.path": str(root / "indexes"),
                     "hyperspace.index.numBuckets": 8,
                     "hyperspace.index.hybridscan.enabled": True,
                     "hyperspace.index.lineage.enabled": True, **conf}
        self.sessions = {k: self.session(k) for k in PKGS}
        hs_jax.Hyperspace(self.sessions["jax"]).create_index(
            self.sessions["jax"].read.avro(str(self.src)),
            hs_jax.IndexConfig("didx", ["k"], ["v", "s"]))
        self.write("part-append.avro", _appended_batch())
        for s in self.sessions.values():
            s.enable_hyperspace()

    def write(self, name, batch, src=None):
        jax_avro.write_avro((src or self.src) / name, batch)

    def session(self, key, **conf):
        values = {**self.base, **conf}
        if key == "torch":
            values.update({"hyperspace.torch.device": "cpu", "hyperspace.torch.hbm.mode": "force",
                           "hyperspace.torch.hbm.minRows": 1,
                           "hyperspace.torch.hbm.maxBlockFrac": 1.0})
            values.update(conf)
        return PKGS[key].HyperspaceSession(PKGS[key].HyperspaceConf(values))

    def query(self, key, pred, src=None):
        s = self.sessions[key]
        return s.read.avro(str(src or self.src)).filter(pred(EXPR[key])).select("k", "v", "s")

    def info(self, key, pred):
        plan = self.query(key, pred).optimized_plan()
        union = JaxUnion if key == "jax" else TorchUnion
        unions = plan.collect(lambda n: isinstance(n, union))
        assert unions, plan.tree_string()
        info = (j_parse if key == "jax" else t_parse)(unions[0])
        assert info is not None
        return info

    def prefetch_both(self, pred, columns):
        """Table and delta resident in both packages; returns the port's."""
        ji, ti = self.info("jax", pred), self.info("torch", pred)
        jt = jh.hbm_cache.prefetch(ji.entry.content.files(), columns)
        tt = th.hbm_cache.prefetch(ti.entry.content.files(), columns, device="cpu", conf=FORCE)
        assert jt is not None and tt is not None
        jd = jh.hbm_cache.prefetch_delta(jt, ji.appended, ji.relation, list(ji.user_cols),
                                         ji.deleted_ids)
        td = th.hbm_cache.prefetch_delta(tt, ti.appended, ti.relation, list(ti.user_cols),
                                         ti.deleted_ids, FORCE)
        assert jd is not None and td is not None
        assert (td.n_rows, td.deleted_ids, sorted(td.columns)) == (
            jd.n_rows, jd.deleted_ids, sorted(jd.columns))
        assert {c: list(v) for c, v in td.oov.items()} == {c: list(v) for c, v in jd.oov.items()}
        return ti, tt, td

    def counts_match(self, pred):
        """(base, delta) counts of both packages' resident pair, equal."""
        jt, jd = jh.hbm_cache._tables[-1], jh.hbm_cache._deltas[-1]
        tt, td = th.hbm_cache._tables[-1], th.hbm_cache._deltas[-1]
        want = jh.hbm_cache.hybrid_block_counts(jt, jd, pred(jexpr))
        got = th.hbm_cache.hybrid_block_counts(tt, td, pred(texpr))
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        return got

    def run(self, pred, hybrid: int, src=None):
        """Both packages' rows with Hyperspace on, equal to each other and
        to the host union; ``hybrid`` is the resident_hybrid count each
        must show for the query."""
        out = {}
        for key in PKGS:
            s = self.sessions[key]
            s.disable_hyperspace()
            off = _values(self.query(key, pred, src).collect())
            s.enable_hyperspace()
            before = (jmetrics.counter if key == "jax" else tmetrics.get)("scan.path.resident_hybrid")
            on = self.query(key, pred, src).collect()
            after = (jmetrics.counter if key == "jax" else tmetrics.get)("scan.path.resident_hybrid")
            assert after - before == hybrid, key
            out[key] = _values(on)
            assert out[key] == off, key
        assert out["torch"] == out["jax"]
        return out["torch"]

    def wait(self):
        jh.hbm_cache.wait_background(timeout_s=30.0)
        th.hbm_cache.wait_background()


@pytest.fixture
def env(tmp_path):
    return Env(tmp_path)


K42 = lambda m: m.col("k") == 42  # noqa: E731


def test_append_only_parity_and_zero_per_query_h2d(env):
    env.prefetch_both(K42, ["k"])
    h2d = tmetrics.get("hbm.delta.h2d_bytes")
    assert h2d > 0
    env.counts_match(K42)
    for _ in range(4):
        env.run(K42, hybrid=1)
    assert tmetrics.get("hbm.delta.h2d_bytes") == h2d


def test_append_and_delete_filters_deleted_rows(tmp_path):
    env = Env(tmp_path, **{"hyperspace.index.hybridscan.maxDeletedRatio": 0.6})
    (env.src / "part-1.avro").unlink()
    ti, _tt, td = env.prefetch_both(K42, ["k"])
    assert ti.deleted_ids and td.del_mask is not None
    assert td.del_mask.shape[0] * 32 == th.hbm_cache._tables[-1].n_pad
    base, delta = env.counts_match(K42)
    rows = env.run(K42, hybrid=1)
    batch = _source_batch()
    per = batch.num_rows // 3
    keep = np.concatenate([np.arange(0, per), np.arange(2 * per, 3 * per)])
    want = int((batch.columns["k"].data[keep] == 42).sum()) + int(
        (_appended_batch().columns["k"].data == 42).sum())
    assert len(rows[1]) == want and int(base.sum()) + int(delta.sum()) >= want


def test_oov_string_equality_exact_and_range_declines(env):
    eq = lambda m: (m.col("k") >= 0) & (m.col("s") == "zz")  # noqa: E731
    _ti, _tt, td = env.prefetch_both(eq, ["k", "s"])
    assert list(td.oov["s"]) == [b"zz"]
    env.counts_match(eq)
    assert len(env.run(eq, hybrid=1)[1]) > 0
    rng = lambda m: (m.col("k") >= 0) & (m.col("s") > "bb")  # noqa: E731
    tmetrics.reset()
    assert env.counts_match(rng) is None
    env.run(rng, hybrid=0)
    assert tmetrics.get("hbm.delta.oov_shape_declined") >= 1


def test_new_append_changes_epoch_and_repopulates(env):
    k7 = lambda m: m.col("k") == 7  # noqa: E731
    env.prefetch_both(k7, ["k"])
    env.run(k7, hybrid=1)
    env.write("part-append2.avro", _appended_batch(n=100, seed=11))
    env.run(k7, hybrid=0)  # the stale delta never serves; repopulation starts
    env.wait()
    assert th.hbm_cache.snapshot()["deltas"] == jh.hbm_cache.snapshot()["deltas"] == 1
    env.run(k7, hybrid=1)


def test_quick_refresh_keeps_delta_full_refresh_invalidates(env):
    env.prefetch_both(K42, ["k"])
    env.run(K42, hybrid=1)
    for key in PKGS:
        PKGS[key].Hyperspace(env.sessions[key]).refresh_index("didx", "quick")
        assert (jh if key == "jax" else th).hbm_cache.snapshot()["deltas"] == 1
    h2d = tmetrics.get("hbm.delta.h2d_bytes")
    env.run(K42, hybrid=1)
    assert tmetrics.get("hbm.delta.h2d_bytes") == h2d
    # the port's full refresh rewrites the index: its deltas invalidate
    hs_torch.Hyperspace(env.sessions["torch"]).refresh_index("didx", "full")
    assert th.hbm_cache.snapshot()["deltas"] == 0
    assert tmetrics.get("hbm.delta.invalidated") == 1


def test_incremental_refresh_and_optimize_invalidate(env):
    env.prefetch_both(K42, ["k"])
    tmetrics.reset()
    hs_torch.Hyperspace(env.sessions["torch"]).refresh_index("didx", "incremental")
    assert th.hbm_cache.snapshot()["deltas"] == 0
    # two index files a bucket now: optimize merges them
    env.write("part-append3.avro", _appended_batch(n=200, seed=13))
    ti = env.info("torch", K42)
    tt = th.hbm_cache.prefetch(ti.entry.content.files(), ["k"], device="cpu", conf=FORCE)
    assert th.hbm_cache.prefetch_delta(tt, ti.appended, ti.relation, list(ti.user_cols),
                                       ti.deleted_ids, FORCE) is not None
    hs_torch.Hyperspace(env.sessions["torch"]).optimize_index("didx", "full")
    assert th.hbm_cache.snapshot()["deltas"] == 0
    assert tmetrics.get("hbm.delta.invalidated") == 2
    # invalidate_deltas() with no root drops every delta, as the reference's
    env.write("part-append4.avro", _appended_batch(n=50, seed=17))
    ti = env.info("torch", K42)
    tt = th.hbm_cache.prefetch(ti.entry.content.files(), ["k"], device="cpu", conf=FORCE)
    assert th.hbm_cache.prefetch_delta(tt, ti.appended, ti.relation, list(ti.user_cols),
                                       ti.deleted_ids, FORCE) is not None
    th.hbm_cache.invalidate_deltas()
    assert th.hbm_cache.snapshot()["deltas"] == 0


def test_selectivity_gate_routes_broad_predicates_host(env, monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MAX_BLOCK_FRAC", "0.9")
    env.sessions["torch"] = env.session("torch", **{"hyperspace.torch.hbm.maxBlockFrac": 0.9})
    env.sessions["torch"].enable_hyperspace()
    broad = lambda m: m.col("k") >= 0  # noqa: E731
    env.prefetch_both(broad, ["k"])
    tmetrics.reset()
    jmetrics.reset()
    env.run(broad, hybrid=0)
    assert tmetrics.get("scan.gate.resident_hybrid_selectivity") == 1
    assert jmetrics.counter("scan.gate.resident_hybrid_selectivity") == 1


def test_first_touch_background_population(env):
    k3 = lambda m: m.col("k") == 3  # noqa: E731
    for key, cache in (("jax", jh), ("torch", th)):
        files = env.info(key, k3).entry.content.files()
        table = (cache.hbm_cache.prefetch(files, ["k"]) if key == "jax"
                 else cache.hbm_cache.prefetch(files, ["k"], device="cpu", conf=FORCE))
        assert table is not None
    env.run(k3, hybrid=0)  # host union; schedules the delta
    env.wait()
    assert th.hbm_cache.snapshot()["deltas"] == jh.hbm_cache.snapshot()["deltas"] == 1
    env.counts_match(k3)
    env.run(k3, hybrid=1)


def test_uncoverable_delta_column_memoizes(env):
    """An appended value beyond int32 leaves ``v`` uncoverable for this
    epoch: the partial delta registers once, queries over ``v`` stay on
    the host union without rebuilds, and ``k`` queries still fuse."""
    env.write("part-append-wide.avro", JaxBatch.from_pydict({
        "k": np.array([42, 43], dtype=np.int64),
        "v": np.array([1 << 40, 7], dtype=np.int64),
        "s": np.array(["aa", "bb"], dtype=object)}, SCHEMA))
    kv = lambda m: (m.col("k") == 42) & (m.col("v") >= 0)  # noqa: E731
    for key, cache in (("jax", jh), ("torch", th)):
        files = env.info(key, kv).entry.content.files()
        table = (cache.hbm_cache.prefetch(files, ["k", "v"]) if key == "jax"
                 else cache.hbm_cache.prefetch(files, ["k", "v"], device="cpu", conf=FORCE))
        assert table is not None
    env.run(kv, hybrid=0)
    env.wait()
    snap = th.hbm_cache.snapshot()
    assert snap["deltas"] == 1 and "v" not in snap["per_delta"][0]["columns"]
    assert jh.hbm_cache.snapshot()["per_delta"][0]["columns"] == snap["per_delta"][0]["columns"]
    h2d = tmetrics.get("hbm.delta.h2d_bytes")
    for _ in range(3):
        env.run(kv, hybrid=0)
    env.wait()
    assert tmetrics.get("hbm.delta.h2d_bytes") == h2d
    env.run(K42, hybrid=1)


def test_refresh_of_another_index_keeps_this_ones_delta(env, tmp_path):
    env.prefetch_both(K42, ["k"])
    src2 = tmp_path / "data2"
    src2.mkdir()
    env.write("part-0.avro", _source_batch(seed=7), src2)
    hs_o = hs_torch.Hyperspace(env.sessions["torch"])
    hs_o.create_index(env.sessions["torch"].read.avro(str(src2)),
                      hs_torch.IndexConfig("other", ["k"], ["v"]))
    env.write("part-1.avro", _appended_batch(seed=8), src2)
    hs_o.refresh_index("other", "full")
    assert th.hbm_cache.snapshot()["deltas"] == 1
    env.run(K42, hybrid=1)


def test_delta_refused_when_budget_has_no_headroom(env):
    ti = env.info("torch", K42)
    table = th.hbm_cache.prefetch(ti.entry.content.files(), ["k"], device="cpu", conf=FORCE)
    assert table is not None
    tmetrics.reset()
    none = ResidencyConf(mode="force", min_rows=1, budget_mb=0)
    assert th.hbm_cache.prefetch_delta(table, ti.appended, ti.relation, list(ti.user_cols),
                                       ti.deleted_ids, none) is None
    assert tmetrics.get("hbm.delta.over_budget_refused") >= 1
    assert th.hbm_cache.snapshot()["deltas"] == 0


def test_drop_base_table_drops_dependent_deltas(env):
    _ti, tt, _td = env.prefetch_both(K42, ["k"])
    assert th.hbm_cache.snapshot()["deltas"] == 1
    th.hbm_cache.drop(tt)
    assert th.hbm_cache.snapshot()["deltas"] == 0


def test_residency_off_serves_the_host_union(env):
    env.prefetch_both(K42, ["k"])
    env.sessions["torch"] = env.session("torch", **{"hyperspace.torch.hbm.mode": "off"})
    env.sessions["torch"].enable_hyperspace()
    before = tmetrics.get("scan.path.resident_hybrid")
    s = env.sessions["torch"]
    s.disable_hyperspace()
    off = _values(env.query("torch", K42).collect())
    s.enable_hyperspace()
    assert _values(env.query("torch", K42).collect()) == off
    assert tmetrics.get("scan.path.resident_hybrid") == before
