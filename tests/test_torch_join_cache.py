"""Parity of the port's join path with the JAX package's on the CPU: the
presorted routing ladder (``_segments_sorted``, ``_flat_segment_remap``,
``segmented_join_ranges``) and the cross-query caches (the executor's
bucket groups, the join layer's setup and ranges).

The ladder's helpers get the same codes and bounds in both packages:
(lo, counts) exact, and ``r_order`` None on the same inputs. The caches
run on one index tree built by the JAX package over avro sources and
served by sessions of both packages: hits on a repeat (groups, setup,
ranges), derived tokens through ``Project`` and filters, the hybrid
opt-out, a zero budget disabling them, a refresh missing, and a 6-seed
fuzz of joins and aggregate-joins whose rows equal the reference's.
Mirrors ``tests/test_join_cache.py`` and ``tests/test_batched_join.py``.
Tolerance: rows exact; float aggregates ``rtol=1e-9``.
"""

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.exec import executor as jex
from hyperspace_tpu.exec import joins as jjoins
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.exec import executor as tex
from hyperspace_tpu_torch.exec import joins as tjoins
from hyperspace_tpu_torch.exec.bytecache import JOIN_CACHE_MB_ENV
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

PKGS = {"jax": hs_jax, "torch": hs_torch}
N_BUCKETS = 8
_L = {"lk": "int64", "lg": "int64", "lv": "int64", "lf": "float64"}
_R = {"rk": "int64", "rv": "int64", "rf": "float64"}


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    monkeypatch.setenv(JOIN_CACHE_MB_ENV, "512")
    monkeypatch.setenv("HYPERSPACE_TPU_JOIN_CACHE_MB", "512")
    for mod in (tex, jex):
        mod.reset_groups_cache()
    for mod in (tjoins, jjoins):
        mod.reset_setup_cache()
    yield
    for mod in (tex, jex):
        mod.reset_groups_cache()
    for mod in (tjoins, jjoins):
        mod.reset_setup_cache()


def tables(seed, n=6000, n_r=2000, uniq_right=True):
    """A fact side and a dimension side: left keys draw from the right's
    (some miss), the right keys unique or with duplicates, NaN in the
    float payloads."""
    rng = np.random.default_rng(seed)
    rk = (np.arange(n_r, dtype=np.int64) * 3 if uniq_right
          else np.sort(rng.integers(0, n_r, n_r)).astype(np.int64) * 3)
    lf = rng.normal(0, 10, n)
    lf[rng.integers(0, n, n // 40)] = np.nan
    rf = np.round(rng.uniform(0, 1000, n_r), 3)
    rf[rng.integers(0, n_r, n_r // 50)] = np.nan
    left = JaxBatch.from_pydict({
        "lk": rng.integers(0, 3 * n_r + 30, n).astype(np.int64),
        "lg": rng.integers(0, 40, n).astype(np.int64),
        "lv": rng.integers(-100, 100, n).astype(np.int64),
        "lf": lf,
    }, schema=_L)
    right = JaxBatch.from_pydict({
        "rk": rk,
        "rv": rng.integers(0, 100, n_r).astype(np.int64),
        "rf": rf,
    }, schema=_R)
    return left, right


class JoinTree:
    """Avro sources ``l`` and ``r`` (two files each), covering indexes
    ``jl``/``jr`` built by one package, and fresh sessions of both."""

    def __init__(self, root, seed=0, built_by="jax", conf=None, **kw):
        self.root = root
        self.conf = {"hyperspace.system.path": str(root / "indexes"),
                     "hyperspace.index.numBuckets": N_BUCKETS,
                     "hyperspace.index.hybridscan.enabled": False,
                     "hyperspace.index.lineage.enabled": False, **(conf or {})}
        left, right = tables(seed, **kw)
        for name, b in (("l", left), ("r", right)):
            half = b.num_rows // 2
            jax_avro.write_avro(root / name / "p0.avro", b.take(np.arange(half)))
            jax_avro.write_avro(root / name / "p1.avro", b.take(np.arange(half, b.num_rows)))
        s = self.session(built_by)
        mod = PKGS[built_by]
        h = mod.Hyperspace(s)
        h.create_index(s.read.avro(str(root / "l")), mod.IndexConfig("jl", ["lk"],
                                                                     ["lg", "lv", "lf"]))
        h.create_index(s.read.avro(str(root / "r")), mod.IndexConfig("jr", ["rk"], ["rv", "rf"]))

    def session(self, key, **conf):
        values = {**self.conf, **conf}
        if key == "torch":
            values["hyperspace.torch.device"] = "cpu"
        mod = PKGS[key]
        s = mod.HyperspaceSession(mod.HyperspaceConf(values))
        s.enable_hyperspace()
        return s

    def sides(self, s):
        return s.read.avro(str(self.root / "l")), s.read.avro(str(self.root / "r"))


def join_q(s, mod, tree, pred=None):
    li, od = tree.sides(s)
    if pred is not None:
        li = li.filter(pred(mod))
    return li.join(od, mod.col("lk") == mod.col("rk")).select("lk", "lv", "rv", "rf")


def agg_q(s, mod, tree, aggs=None, pred=None):
    li, od = tree.sides(s)
    if pred is not None:
        li = li.filter(pred(mod))
    aggs = aggs or (lambda m: [m.agg_sum("rf", "srf"), m.agg_avg("rf", "arf"), m.agg_count(),
                               m.agg_sum("lv", "slv")])
    return li.join(od, mod.col("lk") == mod.col("rk")).group_by("lg").agg(*aggs(mod))


def rows(batch):
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    return names, sorted(zip(*[[repr(v) for v in c] for c in cols]))


def assert_agg_same(got, exp):
    assert got.column_names == exp.column_names and got.num_rows == exp.num_rows
    og = np.argsort(np.asarray(got.columns["lg"].data), kind="stable")
    oe = np.argsort(np.asarray(exp.columns["lg"].data), kind="stable")
    for c in exp.column_names:
        g, e = np.asarray(got.columns[c].data)[og], np.asarray(exp.columns[c].data)[oe]
        if e.dtype.kind == "f":
            np.testing.assert_allclose(g, e, rtol=1e-9, equal_nan=True, err_msg=c)
        else:
            assert np.array_equal(g, e), c


def both(tree, make, **conf):
    """(port's result, reference's result, port's counters)."""
    out = {}
    for key in ("jax", "torch"):
        s = tree.session(key, **conf)
        (tmetrics if key == "torch" else jmetrics).reset()
        out[key] = make(s, PKGS[key], tree).collect()
    return out["torch"], out["jax"], tmetrics.snapshot()


# ---------------------------------------------------------------------------
# the routing ladder's helpers, on the same codes and bounds
# ---------------------------------------------------------------------------
def _segments(seed, n_seg, sorted_left, sorted_right, span=5000, dup=False):
    rng = np.random.default_rng(seed)
    l_parts, r_parts = [], []
    for _ in range(n_seg):
        r = rng.integers(0, span, int(rng.integers(0, 300))).astype(np.int64)
        r = np.sort(r) if dup else np.unique(r)
        ls = rng.choice(np.concatenate([r, [span + 1]]), int(rng.integers(1, 500))) \
            + rng.integers(0, 2, 1)[0]
        l_parts.append(np.sort(ls) if sorted_left else rng.permutation(ls))
        r_parts.append(r if sorted_right else rng.permutation(r))
    bounds = lambda parts: np.cumsum([0] + [len(p) for p in parts])  # noqa: E731
    return (np.concatenate(l_parts).astype(np.int64), np.concatenate(r_parts).astype(np.int64),
            bounds(l_parts), bounds(r_parts))


LADDER = {
    # name: (segments, flat remap?, the port's counter)
    "both_sorted": (dict(seed=1, n_seg=8, sorted_left=True, sorted_right=True),
                    "join.path.presorted_merge_flat"),
    "left_unsorted": (dict(seed=2, n_seg=5, sorted_left=False, sorted_right=True, dup=True),
                      "join.path.presorted_merge_flat"),
    "right_unsorted": (dict(seed=3, n_seg=6, sorted_left=True, sorted_right=False, dup=True),
                       "join.path.device_kernel"),
    # K2's plan declines or no flat remap fits: both sides ascending take
    # the native walk, a left side out of order the host searches
    "flat_beyond_int32": (dict(seed=4, n_seg=8, sorted_left=True, sorted_right=True,
                               span=1 << 29), "join.path.native_smj_ranges"),
    "no_flat_remap": (dict(seed=5, n_seg=4, sorted_left=True, sorted_right=True,
                           span=1 << 61), "join.path.native_smj_ranges"),
    "left_unsorted_beyond_int32": (dict(seed=6, n_seg=8, sorted_left=False, sorted_right=True,
                                        span=1 << 29, dup=True), "join.path.host_searchsorted"),
    "left_unsorted_no_flat_remap": (dict(seed=7, n_seg=4, sorted_left=False, sorted_right=True,
                                         span=1 << 61, dup=True), "join.path.presorted_merge"),
}


@pytest.mark.parametrize("name", list(LADDER))
def test_ladder_matches_the_reference(name):
    kw, counter = LADDER[name]
    l, r, lb, rb = _segments(**kw)
    for i in range(len(lb) - 1):
        assert tjoins._segments_sorted(l[lb[i]:lb[i + 1]], [0, lb[i + 1] - lb[i]]) == \
            jjoins._segments_sorted(l[lb[i]:lb[i + 1]], [0, lb[i + 1] - lb[i]])
    assert tjoins._segments_sorted(l, lb) == jjoins._segments_sorted(l, lb)
    assert tjoins._segments_sorted(r, rb) == jjoins._segments_sorted(r, rb)
    tflat = tjoins._flat_segment_remap(l, r, lb, rb)
    jflat = jjoins._flat_segment_remap(l, r, lb, rb)
    assert (tflat is None) == (jflat is None) == name.endswith("no_flat_remap")
    if tflat is not None:
        assert all(np.array_equal(a, b) for a, b in zip(tflat, jflat))
    tmetrics.reset()
    lo, counts, order = tjoins.segmented_join_ranges(l, r, lb, rb, device="cpu")
    jlo, jcounts, jorder = jjoins.segmented_join_ranges(l, r, lb, rb)
    assert np.array_equal(lo, jlo) and np.array_equal(counts, jcounts)
    assert (order is None) == (jorder is None)
    if order is not None:
        assert np.array_equal(order, jorder)
    assert tmetrics.get(counter) == 1
    pairs = tjoins.merge_join_indices_segmented(l, r, lb, rb, device="cpu")
    jpairs = jjoins._expand_ranges(jlo, jcounts, jorder)
    assert all(np.array_equal(a, b) for a, b in zip(pairs, jpairs))


def test_ladder_on_empty_and_single_segments():
    l = np.array([], dtype=np.int64)
    r = np.array([1, 2, 3], dtype=np.int64)
    assert tjoins._flat_segment_remap(l, r, [0, 0], [0, 3]) is None
    assert jjoins._flat_segment_remap(l, r, [0, 0], [0, 3]) is None
    assert tjoins._segments_sorted(r[:1], [0, 1]) and jjoins._segments_sorted(r[:1], [0, 1])
    lo, counts, order = tjoins.segmented_join_ranges(l, r, [0, 0], [0, 3], device="cpu")
    assert len(lo) == 0 and order is None


# ---------------------------------------------------------------------------
# the caches on one index tree
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return JoinTree(tmp_path_factory.mktemp("join_cache"))


def test_repeat_join_hits_groups_and_setup_caches(tree):
    got, exp, m = both(tree, join_q)
    assert rows(got) == rows(exp) and got.num_rows > 1000
    assert m.get("join.cache.miss") == 2 and m.get("join.setup_cache.stored") == 1
    assert m.get("join.path.presorted_merge_flat") == 1
    assert m.get("join.path.native_smj_gather") == 1
    again, _exp, m = both(tree, join_q)
    assert rows(again) == rows(exp)
    assert m.get("join.cache.hit") == 2 and m.get("join.setup_cache.hit") == 1
    assert not m.get("join.cache.miss")
    # the materializing join over presorted sides caches its ranges, as
    # the reference does: the repeat runs no route, only the C++ gather
    assert m.get("join.ranges_cache.hit") == 1 and not m.get("join.path.presorted_merge_flat")
    assert m.get("join.path.native_smj_gather") == 1


def test_repeat_aggregate_join_hits_the_ranges_cache(tree):
    got, exp, m = both(tree, agg_q)
    assert_agg_same(got, exp)
    assert m.get("aggregate.path.join_fused") == 1
    assert m.get("join.path.presorted_merge_flat") == 1 and not m.get("join.ranges_cache.hit")
    again, _exp, m = both(tree, agg_q)
    assert_agg_same(again, exp)
    assert m.get("join.setup_cache.hit") == 1 and m.get("join.ranges_cache.hit") == 1
    assert not m.get("join.path.presorted_merge_flat")


def test_derived_tokens_through_project_and_filters(tree):
    pred = lambda m: m.col("lv") > 10  # noqa: E731
    got, exp, m = both(tree, lambda s, mod, t: join_q(s, mod, t, pred))
    assert rows(got) == rows(exp)
    assert not m.get("join.setup_cache.hit")
    again, _exp, m = both(tree, lambda s, mod, t: join_q(s, mod, t, pred))
    assert rows(again) == rows(exp)
    assert m.get("join.cache.hit") == 2 and m.get("join.setup_cache.hit") == 1
    # another predicate: its own derived token, no stale hit
    other, exp2, m = both(tree, lambda s, mod, t: join_q(s, mod, t, lambda m: m.col("lv") > 50))
    assert rows(other) == rows(exp2) and other.num_rows < got.num_rows
    assert not m.get("join.setup_cache.hit")
    # two equal predicates built apart give one key
    from hyperspace_tpu_torch.plan.expr import col, lit

    a = (col("lv") > 10) & (col("lg") < lit(7))
    b = (col("lv") > 10) & (col("lg") < lit(7))
    assert a is not b and repr(a) == repr(b)
    groups = tex.BucketGroups({})
    groups.cache_token = ("files", ("lk",))
    tok = lambda p: (groups.cache_token, ("pred", repr(p)))  # noqa: E731
    assert tok(a) == tok(b) and tok(a) != tok(col("lv") > 11)
    projected = tex._project_groups(groups, ["lk"])
    assert projected.cache_token == (groups.cache_token, ("lk",))
    assert getattr(tex._project_groups({}, ["lk"]), "cache_token", None) is None


def test_budget_zero_disables_the_caches(tree, monkeypatch):
    monkeypatch.setenv(JOIN_CACHE_MB_ENV, "0")
    monkeypatch.setenv("HYPERSPACE_TPU_JOIN_CACHE_MB", "0")
    for _ in range(2):
        got, exp, m = both(tree, agg_q)
        assert_agg_same(got, exp)
        assert not m.get("join.cache.hit") and not m.get("join.setup_cache.hit")
        assert not m.get("join.ranges_cache.hit")
    # a filtered side cannot derive a token: counted
    pred = lambda m: m.col("lv") > 10  # noqa: E731
    got, exp, m = both(tree, lambda s, mod, t: join_q(s, mod, t, pred))
    assert rows(got) == rows(exp)
    assert m.get("join.cache.optout.filtered") == 1


def test_hybrid_join_opts_out(tmp_path):
    t = JoinTree(tmp_path, seed=3, conf={"hyperspace.index.hybridscan.enabled": True,
                                         "hyperspace.index.lineage.enabled": True})
    extra, _ = tables(9, n=150)
    jax_avro.write_avro(tmp_path / "l" / "p9.avro", extra)
    got, exp, m = both(t, join_q)
    assert rows(got) == rows(exp)
    assert m.get("join.cache.optout.hybrid") == 1
    again, _exp, m = both(t, join_q)
    assert rows(again) == rows(exp) and not m.get("join.setup_cache.hit")


def test_refresh_misses(tmp_path):
    t = JoinTree(tmp_path, seed=4)
    before, _exp, _m = both(t, join_q)
    extra, _ = tables(11, n=300)
    jax_avro.write_avro(tmp_path / "l" / "p7.avro", extra)
    hs_jax.Hyperspace(t.session("jax")).refresh_index("jl", "full")
    got, exp, m = both(t, join_q)
    assert rows(got) == rows(exp) and got.num_rows > before.num_rows
    # the left side's new files miss; the unchanged right side hits
    assert m.get("join.cache.miss") == 1 and m.get("join.cache.hit") == 1
    assert not m.get("join.setup_cache.hit")
    off = t.session("torch")
    off.disable_hyperspace()
    assert rows(join_q(off, hs_torch, t).collect()) == rows(got)


@pytest.mark.parametrize("seed", range(6))
def test_join_fuzz_matches_the_reference(tmp_path, seed):
    """Random sides (unique or duplicate right keys), a random predicate
    or none, both orientations of the aggregate, each run twice (the
    second from the caches): rows equal the reference's."""
    rng = np.random.default_rng(100 + seed)
    t = JoinTree(tmp_path, seed=seed, built_by=("jax", "torch")[seed % 2],
                 n=int(rng.integers(500, 4000)), n_r=int(rng.integers(100, 1500)),
                 uniq_right=bool(seed % 3))
    cut = int(rng.integers(-50, 50))
    pred = None if seed % 2 else (lambda m: m.col("lv") > cut)
    int_aggs = lambda m: [m.agg_sum("rv", "srv"), m.agg_count(), m.agg_min("lv", "mlv")]  # noqa
    for _ in range(2):
        got, exp, _m = both(t, lambda s, mod, tr: join_q(s, mod, tr, pred))
        assert rows(got) == rows(exp)
        got, exp, _m = both(t, lambda s, mod, tr: agg_q(s, mod, tr, int_aggs, pred))
        assert_agg_same(got, exp)
