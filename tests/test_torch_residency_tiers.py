"""Parity of the port's residency tier ladder (``hyperspace_tpu_torch/
residency/``, the compressed and streaming tiers of ``exec/hbm_cache.py``)
with the JAX package's, on the CPU. Mirrors the single-device cases of
``tests/test_residency.py``: the tier planner's ladder, compressed parity
and budget accounting, streaming over several windows, the ladder with
compression and streaming off, the hybrid decline over a compressed base,
and the tier counters (``residency_snapshot``).

Both packages serve ONE index tree, built by the JAX package from one
avro source. The JAX side takes its knobs from environment variables and
runs its mask kernel in the Pallas interpreter; the port takes the same
values as session conf and runs K1c's and K1p's plain versions. The
source has 393,216 rows (a multiple of both packages' padding grains), so
both tables pad alike and a budget in whole MB picks the same tier in
both. Tolerance: exact throughout (specs, words over the real rows, block
counts, rows).
"""

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.exec import hbm_cache as jh
from hyperspace_tpu.ops import bitpack as jb
from hyperspace_tpu.residency import knobs as jknobs
from hyperspace_tpu.residency import plan_tier as j_plan_tier
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics
from hyperspace_tpu.telemetry.metrics import residency_snapshot as j_residency_snapshot

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.config import HyperspaceConf, ResidencyConf
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.exec import hbm_cache as th
from hyperspace_tpu_torch.ops import bitpack as tb
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.residency import plan_tier as t_plan_tier
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics
from hyperspace_tpu_torch.telemetry.metrics import residency_snapshot as t_residency_snapshot

N_ROWS = 393_216  # 12 x 32,768 = 48 x 8,192: both packages pad to it
PKGS = {"jax": hs_jax, "torch": hs_torch}
EXPR = {"jax": jexpr, "torch": texpr}
ENV = {  # the reference's environment knobs, by the port's conf key
    "hyperspace.torch.hbm.budgetMB": "HYPERSPACE_TPU_HBM_BUDGET_MB",
    "hyperspace.residency.compression": "HYPERSPACE_TPU_RESIDENCY_COMPRESSION",
    "hyperspace.residency.streaming": "HYPERSPACE_TPU_RESIDENCY_STREAMING",
    "hyperspace.residency.streaming.windowRows": "HYPERSPACE_TPU_RESIDENCY_WINDOW_ROWS",
}


def _residency_env(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MIN_ROWS", "1")
    monkeypatch.setenv("HYPERSPACE_TPU_KERNELS", "interpret")
    # the zone gate off in both: predicates over the unsorted column
    # would route host before any tier is reached
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MAX_BLOCK_FRAC", "1.0")
    for var in ENV.values():
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(autouse=True)
def _force_residency(monkeypatch):
    _residency_env(monkeypatch)
    jknobs.reset_conf_defaults()
    jh.hbm_cache.reset()
    th.hbm_cache.reset()
    yield
    jh.hbm_cache.reset()
    th.hbm_cache.reset()
    jknobs.reset_conf_defaults()


# ---------------------------------------------------------------------------
# the tier planner and the conf keys
# ---------------------------------------------------------------------------
PLANNER_CASES = [  # (compression, streaming, budget as a multiple of packed)
    (c, s, f) for c in ("auto", "force", "off") for s in ("auto", "off")
    for f in (0.5, 1.0, 1.5, 2.5)
]


@pytest.mark.parametrize("compression,streaming,frac", PLANNER_CASES)
def test_tier_planner_ladder_matches_reference(monkeypatch, compression, streaming, frac):
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_COMPRESSION", compression)
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_STREAMING", streaming)
    n = 1 << 15
    js, ts = jb.pack_spec(0, 100, n), tb.pack_spec(0, 100, n)  # 7 bits -> vpw 4
    raw = 4 * n * 2
    unpacked = 4 * n
    packed = ts.packed_nbytes + unpacked
    budget = int(packed * frac)
    conf = ResidencyConf(compression=compression, streaming=streaming, window_rows=4096)
    for ok in (True, False):
        want = j_plan_tier(raw, budget, {"k": js}, unpacked, 0, streaming_ok=ok)
        got = t_plan_tier(raw, budget, {"k": ts}, unpacked, 0, streaming_ok=ok, conf=conf)
        assert (got.tier, got.reason, sorted(got.specs), got.raw_bytes, got.packed_bytes) == (
            want.tier, want.reason, sorted(want.specs), want.raw_bytes, want.packed_bytes)
        if got.tier == "streaming":
            assert got.window_rows == 4096
    # nothing packable: compressed is never chosen
    assert t_plan_tier(raw, raw - 1, {}, raw, conf=conf).tier == j_plan_tier(
        raw, raw - 1, {}, raw).tier


def test_conf_keys_parse_and_refuse_typos():
    conf = HyperspaceConf({"hyperspace.residency.compression": "FORCE",
                           "hyperspace.residency.streaming.windowRows": 12345})
    r = conf.residency()
    assert (r.compression, r.streaming, r.window_rows) == ("force", "auto", 12345)
    defaults = HyperspaceConf({}).residency()
    from hyperspace_tpu import constants as JC

    assert (defaults.compression, defaults.streaming, defaults.window_rows) == (
        JC.RESIDENCY_COMPRESSION_DEFAULT, JC.RESIDENCY_STREAMING_DEFAULT,
        JC.RESIDENCY_STREAMING_WINDOW_ROWS_DEFAULT)
    bad = HyperspaceConf({"hyperspace.residency.streaming.windowRows": "garbage"})
    assert bad.residency().window_rows == JC.RESIDENCY_STREAMING_WINDOW_ROWS_DEFAULT
    for key in ("hyperspace.residency.compression", "hyperspace.residency.streaming"):
        with pytest.raises(HyperspaceException, match="Unknown"):
            HyperspaceConf({key: "sideways"}).residency()


# ---------------------------------------------------------------------------
# end to end: one index tree, shrinking budgets
# ---------------------------------------------------------------------------
class Ladder:
    """An avro source of N_ROWS rows (``k`` in 0..49, the pack target; ``v``
    in 0..2^30, raw at every tier), the index lidx built by the JAX
    package, and sessions of both packages over it."""

    def __init__(self, root):
        rng = np.random.default_rng(7)
        self.batch = JaxBatch.from_pydict({
            "k": rng.integers(0, 50, N_ROWS).astype(np.int64),
            "v": rng.integers(0, 1 << 30, N_ROWS).astype(np.int64),
        })
        self.src = root / "data"
        self.src.mkdir()
        jax_avro.write_avro(self.src / "p0.avro", self.batch)
        self.base = {"hyperspace.system.path": str(root / "indexes"),
                     "hyperspace.index.numBuckets": 2}
        s = self.session("jax", {})
        hs_jax.Hyperspace(s).create_index(s.read.avro(str(self.src)),
                                          hs_jax.IndexConfig("lidx", ["k"], ["v"]))
        self._source_rows = {}

    def session(self, key, knobs, **extra):
        values = {**self.base, **extra}
        if key == "torch":
            values.update({"hyperspace.torch.device": "cpu", "hyperspace.torch.hbm.mode": "force",
                           "hyperspace.torch.hbm.minRows": 1,
                           "hyperspace.torch.hbm.maxBlockFrac": 1.0, **knobs})
        mod = PKGS[key]
        return mod.HyperspaceSession(mod.HyperspaceConf(values))

    def apply(self, monkeypatch, knobs):
        for k, v in knobs.items():
            monkeypatch.setenv(ENV[k], str(v))

    def query(self, s, key, pred):
        return s.read.avro(str(self.src)).filter(pred(EXPR[key])).select("k", "v")

    def source_rows(self, i, pred):
        """Rows of ``PREDS[i]`` (``pred``) through the JAX package with
        Hyperspace off: the source itself, which no test changes, so each
        predicate's rows are read once a module."""
        if i not in self._source_rows:
            s = self.session("jax", {})
            s.disable_hyperspace()
            self._source_rows[i] = _rows(self.query(s, "jax", pred).collect())
        return self._source_rows[i]

    def files(self):
        from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl

        root = self.base["hyperspace.system.path"]
        return IndexLogManagerImpl(f"{root}/lidx").get_latest_stable_log().content.files()


PREDS = [
    lambda m: (m.col("k") == 7) & (m.col("v") >= 0),
    lambda m: (m.col("k") >= 45) & (m.col("v") < (1 << 28)),
    # literals outside k's frame [0, 49]: exact on the packed plane
    lambda m: (m.col("k") < -3) | (m.col("k") > 60) | (m.col("v") == 12345),
    lambda m: m.is_in(m.col("k"), [0, 13, 49]) & ~(m.col("v") > 1 << 29),
]
# over the included column alone: counted by the caches; a query would not
# be rewritten to the index (its filter names no indexed column)
V_ONLY = lambda m: m.col("v") <= 1 << 20  # noqa: E731


def _rows(b):
    return sorted(zip(b.columns["k"].data.tolist(), b.columns["v"].data.tolist()))


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """One index tree for the module, built under the tests' environment:
    the tests only read it, and each starts from empty caches, its own
    knobs and its own sessions (``_force_residency``, ``_prefetch``)."""
    with pytest.MonkeyPatch.context() as mp:
        _residency_env(mp)
        jknobs.reset_conf_defaults()
        built = Ladder(tmp_path_factory.mktemp("ladder"))
    jh.hbm_cache.reset()
    th.hbm_cache.reset()
    jknobs.reset_conf_defaults()
    return built


def _prefetch(ladder, monkeypatch, knobs):
    ladder.apply(monkeypatch, knobs)
    js, ts = ladder.session("jax", knobs), ladder.session("torch", knobs)
    ok_j = hs_jax.Hyperspace(js).prefetch_index("lidx", ["k", "v"])
    ok_t = hs_torch.Hyperspace(ts).prefetch_index("lidx", ["k", "v"])
    assert ok_j == ok_t
    return js, ts, ok_t


def _counts_and_rows(ladder, js, ts, metric):
    """Block counts of every predicate from both caches, and the rows of
    every query through both sessions, with the tier's path metric."""
    jt, tt = jh.hbm_cache._tables[0], th.hbm_cache._tables[0]
    for i, p in enumerate(PREDS + [V_ONLY]):
        want = jh.hbm_cache.block_counts(jt, p(jexpr))
        got = th.hbm_cache.block_counts(tt, p(texpr))
        assert np.array_equal(got, want), i
    for i, p in enumerate(PREDS):
        out = {}
        for key, s in (("jax", js), ("torch", ts)):
            s.enable_hyperspace()
            (jmetrics if key == "jax" else tmetrics).reset()
            out[key] = _rows(ladder.query(s, key, p).collect())
            reg = jmetrics if key == "jax" else tmetrics
            val = reg.counter(metric) if key == "jax" else reg.get(metric)
            assert val == 1, (key, i, metric)
        assert out["torch"] == out["jax"], i
        assert out["torch"] == ladder.source_rows(i, p), i


def test_compressed_tier_parity_and_budget_accounting(ladder, monkeypatch):
    # raw 3.0 MB, packed 1.875 MB: 2 MB admits the compressed tier (auto)
    knobs = {"hyperspace.torch.hbm.budgetMB": 2}
    js, ts, ok = _prefetch(ladder, monkeypatch, knobs)
    assert ok
    assert th.hbm_cache.snapshot_residency()["by_tier"] == {"compressed": 1}
    assert jh.hbm_cache.snapshot_residency()["by_tier"] == {"compressed": 1}
    jt, tt = jh.hbm_cache._tables[0], th.hbm_cache._tables[0]
    assert (tt.n_rows, tt.n_pad) == (jt.n_rows, jt.n_pad) == (N_ROWS, N_ROWS)
    assert (tt.nbytes, tt.raw_nbytes) == (jt.nbytes, jt.raw_nbytes)
    row = th.hbm_cache.snapshot_residency()["tables"][0]
    assert row["raw_mb"] > row["mb"]
    for c in ("k", "v"):
        jp, tp = jt.columns[c].pack, tt.columns[c].pack
        assert (jp is None) == (tp is None), c
        if tp is None:
            continue
        assert (tp.bits, tp.vpw, tp.ref0) == (jp.bits, jp.vpw, jp.ref0) == (6, 4, 0)
        words = -(-tt.n_rows // tp.vpw)
        jw = np.asarray(jt.columns[c].data).reshape(-1)[:words]
        assert np.array_equal(tt.columns[c].data.numpy()[:words], jw)
        assert tt.columns[c].nbytes * 2 <= tt.n_pad * 4
    assert tt.columns["v"].pack is None
    _counts_and_rows(ladder, js, ts, "scan.path.resident_compressed")


def test_compression_forced_under_a_roomy_budget(ladder, monkeypatch):
    knobs = {"hyperspace.residency.compression": "force"}
    js, ts, ok = _prefetch(ladder, monkeypatch, knobs)
    assert ok and th.hbm_cache.snapshot_residency()["by_tier"] == {"compressed": 1}
    assert jh.hbm_cache.snapshot_residency()["by_tier"] == {"compressed": 1}
    _counts_and_rows(ladder, js, ts, "scan.path.resident_compressed")


@pytest.mark.parametrize("compression", ["auto", "off"])
def test_streaming_tier_parity_over_multiple_windows(ladder, monkeypatch, compression):
    # 1 MB is below even the packed planes; with compression off, 2 MB is
    # below the raw ones: the windows stream, packed or raw
    knobs = {"hyperspace.torch.hbm.budgetMB": 1 if compression == "auto" else 2,
             "hyperspace.residency.compression": compression,
             "hyperspace.residency.streaming.windowRows": 65536}
    js, ts, ok = _prefetch(ladder, monkeypatch, knobs)
    assert ok
    snap = th.hbm_cache.snapshot_residency()
    assert snap["by_tier"] == {"streaming": 1}
    assert jh.hbm_cache.snapshot_residency()["by_tier"] == {"streaming": 1}
    row = snap["tables"][0]
    jrow = jh.hbm_cache.snapshot_residency()["tables"][0]
    assert row["windows"] == jrow["windows"] == 6
    assert row["mb"] == jrow["mb"] and row["host_mb"] == jrow["host_mb"]
    assert row["mb"] < row["host_mb"]
    tt = th.hbm_cache._tables[0]
    assert (tt.columns["k"].planes[""].spec is not None) == (compression == "auto")
    # the streamed counts against the plain tier's counts over the same files
    plain = th.HbmIndexCache()
    pt = plain.prefetch(ladder.files(), ["k", "v"], device="cpu",
                        conf=ResidencyConf(mode="force", min_rows=1))
    assert pt is not None and pt.tier == "resident"
    tmetrics.reset()
    for p in PREDS + [V_ONLY]:
        assert np.array_equal(th.hbm_cache.block_counts(tt, p(texpr)),
                              plain.block_counts(pt, p(texpr)))
    assert tmetrics.get("residency.stream.windows") == 6 * (len(PREDS) + 1)
    assert tmetrics.get("residency.stream.h2d_bytes") > 0
    _counts_and_rows(ladder, js, ts, "scan.path.resident_streaming")


def test_ladder_off_knobs_route_host(ladder, monkeypatch):
    knobs = {"hyperspace.torch.hbm.budgetMB": 1, "hyperspace.residency.compression": "off",
             "hyperspace.residency.streaming": "off"}
    tmetrics.reset()
    js, ts, ok = _prefetch(ladder, monkeypatch, knobs)
    assert not ok
    assert th.hbm_cache.snapshot()["tables"] == 0 and jh.hbm_cache.snapshot()["tables"] == 0
    assert tmetrics.get("hbm.over_budget_refused") >= 1
    for p in PREDS[:2]:
        out = {k: _rows(ladder.query(s, k, p).collect())
               for k, s in (("jax", js), ("torch", ts))}
        assert out["torch"] == out["jax"]


def test_slab_pair_over_budget_refuses_in_both(ladder, monkeypatch):
    # 2^20-row windows: the slab pair alone exceeds 1 MB
    knobs = {"hyperspace.torch.hbm.budgetMB": 1}
    tmetrics.reset()
    _js, _ts, ok = _prefetch(ladder, monkeypatch, knobs)
    assert not ok and tmetrics.get("hbm.over_budget_refused") == 1


def test_residency_snapshot_counters_match_reference(ladder, monkeypatch):
    knobs = {"hyperspace.torch.hbm.budgetMB": 1,
             "hyperspace.residency.streaming.windowRows": 65536}
    jmetrics.reset()
    tmetrics.reset()
    js, ts, ok = _prefetch(ladder, monkeypatch, knobs)
    assert ok
    for key, s in (("jax", js), ("torch", ts)):
        s.enable_hyperspace()
        ladder.query(s, key, PREDS[0]).collect()
    want, got = j_residency_snapshot(), t_residency_snapshot()
    assert got["scans_streaming"] == want["scans_streaming"] == 1
    assert got["streaming_tables_built"] == want["streaming_tables_built"] == 1
    assert got["stream_windows"] == want["stream_windows"] == 6
    assert got["stream_h2d_bytes"] == want["stream_h2d_bytes"]
    assert set(got) <= set(want)


def test_hybrid_declines_compressed_base(tmp_path, monkeypatch):
    """A compressed base cannot anchor a delta: the hybrid query takes the
    exact host union in both packages and no delta registers."""
    rng = np.random.default_rng(4)
    src = tmp_path / "data"
    src.mkdir()
    batch = JaxBatch.from_pydict({"k": rng.integers(0, 50, 60_000).astype(np.int64),
                                  "v": rng.integers(0, 100, 60_000).astype(np.int64)})
    jax_avro.write_avro(src / "p0.avro", batch)
    base = {"hyperspace.system.path": str(tmp_path / "indexes"),
            "hyperspace.index.numBuckets": 2, "hyperspace.index.hybridscan.enabled": True}
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_COMPRESSION", "force")
    port = {"hyperspace.torch.device": "cpu", "hyperspace.torch.hbm.mode": "force",
            "hyperspace.torch.hbm.minRows": 1, "hyperspace.torch.hbm.maxBlockFrac": 1.0,
            "hyperspace.residency.compression": "force"}
    sessions = {"jax": hs_jax.HyperspaceSession(hs_jax.HyperspaceConf(base)),
                "torch": hs_torch.HyperspaceSession(hs_torch.HyperspaceConf({**base, **port}))}
    hs_jax.Hyperspace(sessions["jax"]).create_index(
        sessions["jax"].read.avro(str(src)), hs_jax.IndexConfig("hc", ["k"], ["v"]))
    for key, s in sessions.items():
        assert PKGS[key].Hyperspace(s).prefetch_index("hc", ["k"])
    assert th.hbm_cache.snapshot_residency()["by_tier"] == {"compressed": 1}
    assert jh.hbm_cache.snapshot_residency()["by_tier"] == {"compressed": 1}
    jax_avro.write_avro(src / "p1-append.avro", JaxBatch.from_pydict(
        {"k": rng.integers(0, 50, 800).astype(np.int64),
         "v": rng.integers(0, 100, 800).astype(np.int64)}))
    key = int(batch.columns["k"].data[0])
    out = {}
    tmetrics.reset()
    for name, s in sessions.items():
        q = s.read.avro(str(src)).filter(EXPR[name].col("k") == key).select("k", "v")
        s.disable_hyperspace()
        off = _rows(q.collect())
        s.enable_hyperspace()
        out[name] = _rows(q.collect())
        assert out[name] == off
    assert out["torch"] == out["jax"]
    th.hbm_cache.wait_background()
    jh.hbm_cache.wait_background(timeout_s=30.0)
    assert th.hbm_cache.snapshot()["deltas"] == 0 == jh.hbm_cache.snapshot()["deltas"]
    assert tmetrics.get("scan.path.resident_hybrid") == 0
    assert tmetrics.get("hbm.delta.declined.tier") >= 1
