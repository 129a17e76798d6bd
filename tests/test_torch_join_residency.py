"""Parity of the port's join residency (``hyperspace_tpu_torch/exec/
join_residency.py``, the join regions of ``exec/hbm_cache.py`` and the
executor's resident join arms) with the JAX package's, on the CPU.

Mirrors the single-chip cases of ``tests/test_join_residency.py``: the
materializing resident join's parity and zero upload on a warm query, the
fused aggregate-join over the full spec and min/max only, duplicate right
matches (integer aggregates exact, float ones declining), the filtered and
hybrid declines with their counters, mode off ineligible, a refresh
dropping only its index's regions, the budget refusal and the eviction
order deltas -> joins -> tables, NaN keys never matching, and
``region_agg_plan``'s declines; each with ``hyperspace.residency.forDelta``
on (the right codes FoR-packed, K2p's plain version) and off (raw, K2's).
Regions built by both packages from the same bucket groups have equal
``r_order``, ``uniq_right``, FoR spec, words and refs, payload planes and
``AggPlan.signature()``, and equal ``join_ranges`` and ``join_agg``
outputs. A 6-seed fuzz closes. The reference's device-loss cases are not
mirrored: the port raises a device error instead of dropping the region
and answering on the host.

Query results are held against the JAX package's host path on the same
index tree (built by the JAX package). Tolerance: rows and integer
aggregates exact; float aggregates ``rtol=1e-9``.
"""

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.exec import executor as jex
from hyperspace_tpu.exec import hbm_cache as jh
from hyperspace_tpu.exec import join_residency as jjr
from hyperspace_tpu.exec import joins as jjoins
from hyperspace_tpu.plan import aggregates as jspecs
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage.columnar import Column as JaxColumn
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.config import ResidencyConf
from hyperspace_tpu_torch.exec import executor as tex
from hyperspace_tpu_torch.exec import hbm_cache as th
from hyperspace_tpu_torch.exec import join_residency as tjr
from hyperspace_tpu_torch.exec import joins as tjoins
from hyperspace_tpu_torch.ops import launch_counts, reset_launch_counts
from hyperspace_tpu_torch.plan import aggregates as tspecs
from hyperspace_tpu_torch.plan.ir import Join
from hyperspace_tpu_torch.storage.columnar import Column as TorchColumn
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TorchBatch
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_join_cache import JoinTree, agg_q, assert_agg_same, join_q, rows, tables

FORCE = {"hyperspace.torch.hbm.mode": "force", "hyperspace.torch.hbm.minRows": 1}
FULL = lambda m: [m.agg_sum("rv", "srv"), m.agg_sum("lv", "slv"), m.agg_avg("rf", "arf"),  # noqa
                  m.agg_count(), m.agg_count("rf", "crf"), m.agg_min("lv", "mlv"),
                  m.agg_max("rf", "xrf"), m.agg_avg("lf", "alf")]
MINMAX = lambda m: [m.agg_min("rv", "mrv"), m.agg_max("lv", "xlv"),  # noqa: E731
                    m.agg_min("rf", "mrf")]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    # the reference answers on its host path: its own residency is off
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "off")
    for mod in (tex, jex):
        mod.reset_groups_cache()
    for mod in (tjoins, jjoins):
        mod.reset_setup_cache()
    th.hbm_cache.reset()
    jh.hbm_cache.reset()
    yield
    th.hbm_cache.wait_background()
    th.hbm_cache.reset()
    jh.hbm_cache.reset()


@pytest.fixture(params=["on", "off"], ids=["for_delta_on", "for_delta_off"])
def for_delta(request):
    return request.param


def port(tree, for_delta, **conf):
    return tree.session("torch", **FORCE, **{"hyperspace.residency.forDelta": for_delta}, **conf)


def populate(s, tree, make, rounds=3):
    """Run ``make`` until the background build has a region covering it
    (the widened rebuild needs a second touch after a codes-only one)."""
    for _ in range(rounds):
        make(s, hs_torch, tree).collect()
        th.hbm_cache.wait_background()
    return th.hbm_cache.snapshot_joins()


def reference(tree, make):
    return make(tree.session("jax"), hs_jax, tree).collect()


def warm(s, tree, make):
    reset_launch_counts()
    tmetrics.reset()
    out = make(s, hs_torch, tree).collect()
    return out, tmetrics.snapshot()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return JoinTree(tmp_path_factory.mktemp("join_residency"), seed=7)


def test_resident_join_parity_and_zero_h2d(tree, for_delta):
    s = port(tree, for_delta)
    snap = populate(s, tree, join_q)
    assert snap["regions"] == 1
    region = snap["per_region"][0]
    assert region["route"] == ("k2p" if for_delta == "on" else "k2")
    assert region["for_delta"] == (for_delta == "on")
    got, m = warm(s, tree, join_q)
    assert m.get("scan.path.resident_join") == 1
    assert m.get("scan.gate.resident_bypass_join") == 1
    assert not m.get("hbm.join.h2d_bytes") and m.get("scan.resident_join.d2h_bytes") > 0
    assert launch_counts() == {}  # the CPU runs the kernels' plain versions
    assert rows(got) == rows(reference(tree, join_q))


@pytest.mark.parametrize("spec", ["full", "minmax"])
def test_resident_join_agg_parity(tree, for_delta, spec):
    aggs = {"full": FULL, "minmax": MINMAX}[spec]
    make = lambda s, mod, t: agg_q(s, mod, t, aggs)  # noqa: E731
    s = port(tree, for_delta)
    snap = populate(s, tree, make)
    assert snap["regions"] == 1 and snap["per_region"][0]["payload"]
    got, m = warm(s, tree, make)
    assert m.get("scan.path.resident_join_agg") == 1 and not m.get("hbm.join.h2d_bytes")
    assert not m.get("aggregate.path.join_fused")
    assert_agg_same(got, reference(tree, make))


def test_duplicate_right_matches_int_exact_float_declines(tmp_path, for_delta):
    t = JoinTree(tmp_path, seed=8, uniq_right=False)
    s = port(t, for_delta)
    int_aggs = lambda m: [m.agg_sum("rv", "srv"), m.agg_count(), m.agg_count("rf", "crf"),  # noqa
                          m.agg_sum("lv", "slv")]
    make = lambda s_, mod, tr: agg_q(s_, mod, tr, int_aggs)  # noqa: E731
    populate(s, t, make)
    got, m = warm(s, t, make)
    assert m.get("scan.path.resident_join_agg") == 1
    assert not th.hbm_cache.snapshot_joins()["per_region"][0]["route"] == "searchsorted"
    assert_agg_same(got, reference(t, make))
    fl = lambda s_, mod, tr: agg_q(s_, mod, tr, lambda m: [m.agg_sum("rf", "srf")])  # noqa
    got, m = warm(s, t, fl)
    assert not m.get("scan.path.resident_join_agg") and m.get("hbm.join.declined.dtype") == 1
    assert_agg_same(got, reference(t, fl))
    # the materializing join over duplicate right keys: r_order maps the
    # sorted positions back, pairs in the host's order
    populate(s, t, join_q)
    got, m = warm(s, t, join_q)
    assert m.get("scan.path.resident_join") == 1
    assert rows(got) == rows(reference(t, join_q))


def _join_node(df):
    (node,) = df.optimized_plan().collect(lambda n: isinstance(n, Join))
    return node


def test_filtered_and_hybrid_decline_and_mode_off_is_ineligible(tmp_path, for_delta):
    t = JoinTree(tmp_path, seed=9, conf={"hyperspace.index.hybridscan.enabled": True,
                                         "hyperspace.index.lineage.enabled": True})
    s = port(t, for_delta)
    conf = s.conf.residency()
    pred = lambda m: m.col("lv") > 10  # noqa: E731
    fq = join_q(s, hs_torch, t, pred)
    tmetrics.reset()
    got = fq.collect()
    assert tmetrics.get("hbm.join.declined.filtered") == 1
    node = _join_node(fq)
    res = tjr.resolve_join_residency(node.left, node.right, ["lk"], ["rk"], conf, "cpu")
    assert (res.status, res.reason) == ("declined", "filtered")
    assert rows(got) == rows(reference(t, lambda s_, m, tr: join_q(s_, m, tr, pred)))
    res = tjr.resolve_join_residency(node.left, node.right, ["lk"], ["rk"],
                                     ResidencyConf(mode="off"), "cpu")
    assert (res.status, res.reason) == ("ineligible", "mode")
    extra, _ = tables(19, n=120)
    jax_avro.write_avro(tmp_path / "l" / "p9.avro", extra)
    hq = join_q(s, hs_torch, t)
    tmetrics.reset()
    got = hq.collect()
    assert tmetrics.get("hbm.join.declined.hybrid") == 1
    assert tmetrics.get("join.cache.optout.hybrid") == 1
    th.hbm_cache.wait_background()
    assert th.hbm_cache.snapshot_joins()["regions"] == 0
    assert rows(got) == rows(reference(t, join_q))


def test_refresh_invalidates_only_its_index_regions(tmp_path, for_delta):
    t = JoinTree(tmp_path, seed=10)
    s = port(t, for_delta)
    assert populate(s, t, join_q)["regions"] == 1
    # an unrelated index: its refresh keeps the region
    other, _ = tables(20, n=200)
    jax_avro.write_avro(tmp_path / "u" / "p.avro", other)
    h = hs_torch.Hyperspace(s)
    h.create_index(s.read.avro(str(tmp_path / "u")), hs_torch.IndexConfig("ju", ["lk"], ["lv"]))
    h.refresh_index("ju", "full")
    assert th.hbm_cache.snapshot_joins()["regions"] == 1
    v0 = th.hbm_cache.join_region_version()
    extra, _ = tables(21, n=100)
    jax_avro.write_avro(tmp_path / "l" / "p8.avro", extra)
    tmetrics.reset()
    h.refresh_index("jl", "full")
    assert th.hbm_cache.snapshot_joins()["regions"] == 0
    assert tmetrics.get("hbm.join.invalidated") == 1
    assert th.hbm_cache.join_region_version() > v0
    got = join_q(s, hs_torch, t).collect()  # the new version: host, then a new region
    assert rows(got) == rows(reference(t, join_q))


def test_over_budget_region_is_refused(tree, for_delta):
    s = port(tree, for_delta, **{"hyperspace.torch.hbm.budgetMB": 0})
    tmetrics.reset()
    populate(s, tree, join_q, rounds=1)
    assert th.hbm_cache.snapshot_joins()["regions"] == 0
    assert tmetrics.get("hbm.join.over_budget_refused") >= 1


def test_eviction_order_deltas_then_joins_then_tables():
    """Registering a table under pressure drains deltas first, then join
    regions, then LRU tables (the reference's unit case, sizes in MB)."""
    cache = th.HbmIndexCache()
    budget = 1 << 20

    def table(key, nbytes):
        return th.ResidentTable((key,), [], 1, 1, {}, nbytes, None)

    class _Stub:
        def __init__(self, key, nbytes):
            self.key, self.base_key, self.deleted_ids = key, ("gone",), ()
            self.nbytes, self.last_used = nbytes, 0.0

    cache._register(table("t_old", 300_000), budget)
    cache._deltas.append(_Stub("d1", 300_000))
    cache._joins.append(_Stub("j1", 300_000))
    cache._register(table("t_new", 300_000), budget)
    assert not cache._deltas and len(cache._joins) == 1 and len(cache._tables) == 2
    v0 = cache.join_region_version()
    cache._register(table("t_new2", 300_000), budget)
    assert not cache._joins and len(cache._tables) == 3
    assert cache.join_region_version() > v0
    cache._register(table("t_new3", 300_000), budget)
    assert [t.key for t in cache._tables][0] != ("t_old",)
    # a region under pressure evicts deltas and other regions, never a table
    cache = th.HbmIndexCache()
    cache._register(table("t", 700_000), budget)
    cache._deltas.append(_Stub("d", 100_000))
    cache._joins.append(_Stub("j_old", 100_000))
    big = _Stub("j_new", 400_000)
    assert not cache._register_join(big, budget)
    assert not cache._deltas and not cache._joins and len(cache._tables) == 1
    small = _Stub("j_small", 300_000)
    assert cache._register_join(small, budget) and cache._joins == [small]


def test_nan_keys_never_match():
    nan = np.float64("nan")
    payload = np.array([0x7FF8000000000000, 0x7FF800000000ABCD], dtype=np.uint64).view(
        np.float64)
    lvals = np.array([1.5, payload[0], -0.0, 2.5, payload[1], nan])
    rvals = np.array([payload[1], 0.0, 1.5, payload[0], nan])
    out = {}
    for key, (mod, B, C) in {"jax": (jjoins, JaxBatch, JaxColumn),
                             "torch": (tjoins, TorchBatch, TorchColumn)}.items():
        left = B({"k": C("float64", lvals), "lid": C("int64", np.arange(6, dtype=np.int64))})
        right = B({"rk": C("float64", rvals), "rid": C("int64", np.arange(5, dtype=np.int64))})
        extra = {"device": "cpu"} if key == "torch" else {}
        j = mod.inner_join(left, right, ["k"], ["rk"], **extra)
        out[key] = sorted(zip(j.columns["lid"].data.tolist(), j.columns["rid"].data.tolist()))
        lc, rc = mod.join_codes(
            B({"a": C("int64", np.array([1, 1, 2])), "b": C("float64", np.array([nan, 2.0, -0.0]))}),
            B({"a2": C("int64", np.array([1, 1, 2])), "b2": C("float64", np.array([nan, 2.0, 0.0]))}),
            ["a", "b"], ["a2", "b2"])
        assert lc[1] == rc[1] and lc[2] == rc[2] and lc[0] != rc[0]
    assert out["torch"] == out["jax"] == [(0, 2), (2, 1)]
    # float codes lie past int32: a region over them is refused for good
    lf, rf = tjoins._exact_codes(TorchColumn("float64", lvals), TorchColumn("float64", rvals))
    assert tjr._encode_codes(lf, rf) is None and jjr._encode_codes(lf, rf) is None


def test_region_agg_plan_declines(tree, for_delta):
    s = port(tree, for_delta)
    make = lambda s_, mod, t: agg_q(s_, mod, t, FULL)  # noqa: E731
    populate(s, tree, make)
    node = _join_node(agg_q(s, hs_torch, tree, FULL))
    res = tjr.resolve_join_residency(node.left, node.right, ["lk"], ["rk"], s.conf.residency(),
                                     "cpu", payload_columns=["lg", "rv", "rf", "lv"])
    assert res.status == "ok"
    region = res.region
    assert tjr.region_agg_plan(region, ["lg", "lv"], [tspecs.agg_count()]) is None
    assert tjr.region_agg_plan(region, ["nope"], [tspecs.agg_count()]) is None
    assert tjr.region_agg_plan(region, ["lv"], [tspecs.agg_count()]) is not None
    assert tjr.region_agg_plan(region, ["lg"], [tspecs.agg_sum("nope")]) is None
    # lf is float: no group slots
    assert tjr.region_agg_plan(region, ["lf"], [tspecs.agg_count()]) is None
    assert tjr.region_agg_plan(region, ["lg"], [tspecs.agg_sum("rv", "s"),
                                                tspecs.agg_count()]) is not None


# ---------------------------------------------------------------------------
# regions built by both packages from the same groups
# ---------------------------------------------------------------------------
def _groups(mod_ex, files, columns):
    return mod_ex.Executor._read_groups_by_bucket(files, columns)


def _np(a):
    return a.numpy() if hasattr(a, "numpy") and not isinstance(a, np.ndarray) else np.asarray(a)


@pytest.mark.parametrize("uniq", [True, False], ids=["unique_right", "duplicate_right"])
def test_regions_of_both_packages_match(tmp_path, monkeypatch, for_delta, uniq):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_FOR_DELTA", for_delta)
    t = JoinTree(tmp_path, seed=12, uniq_right=uniq)
    s = t.session("jax")
    entries = {e.name: e for e in s.collection_manager.get_indexes()}
    lf, rf = entries["jl"].content.files(), entries["jr"].content.files()
    lcols, rcols = ["lk", "lg", "lv", "lf"], ["rk", "rv", "rf"]
    payload = ["lg", "lv", "rv", "rf", "lf"]
    jreg = jh.hbm_cache.prefetch_join(_groups(jex, lf, lcols), _groups(jex, rf, rcols), lf, rf,
                                      ["lk"], ["rk"], payload)
    conf = ResidencyConf(mode="force", min_rows=1, for_delta=(for_delta == "on"))
    treg = th.hbm_cache.prefetch_join(_groups(tex, lf, lcols), _groups(tex, rf, rcols), lf, rf,
                                      ["lk"], ["rk"], payload, "cpu", conf)
    assert jreg is not None and treg is not None
    assert treg.key == jreg.key and (treg.n_l, treg.n_r) == (jreg.n_l, jreg.n_r)
    assert np.array_equal(treg.r_order, jreg.r_order) and treg.uniq_right == jreg.uniq_right
    assert treg.uniq_right == uniq
    spec_of = lambda p: None if p is None else (p.bits, p.vpw, p.n, p.ref0, p.block)  # noqa
    assert spec_of(treg.r_pack) == spec_of(jreg.r_pack)
    assert (treg.r_pack is not None) == (for_delta == "on")
    if treg.r_pack is not None:
        spec = treg.r_pack
        assert np.array_equal(_np(treg.r_codes)[: spec.n_words], _np(jreg.r_codes))
        n_refs = -(-spec.n // spec.block)
        assert np.array_equal(_np(treg.r_refs)[:n_refs], _np(jreg.r_refs))
    for side in ("l_cols", "r_cols"):
        tc, jc = getattr(treg, side), getattr(jreg, side)
        assert sorted(tc) == sorted(jc)
        for name in tc:
            assert (tc[name].enc, tc[name].dtype_str) == (jc[name].enc, jc[name].dtype_str)
            for a, b in zip(tc[name].arrays, jc[name].arrays):
                assert np.array_equal(_np(a), _np(b)), (side, name)
            assert (tc[name].mn, tc[name].span) == (jc[name].mn, jc[name].span)
            if tc[name].slots is not None:
                assert np.array_equal(_np(tc[name].slots), _np(jc[name].slots))
    lo, counts = th.hbm_cache.join_ranges(treg)
    jlo, jcounts = jh.hbm_cache.join_ranges(jreg)
    assert np.array_equal(lo, jlo) and np.array_equal(counts, jcounts)
    aggs = [("sum", "rv"), ("count", None), ("min", "lv"), ("max", "lv"), ("avg", "lv")]
    if uniq:
        aggs += [("sum", "rf"), ("avg", "rf"), ("max", "rf"), ("count", "rf"), ("sum", "lf")]
    specs = {k: [m.AggSpec(fn, c, f"{fn}_{c}") for fn, c in aggs]
             for k, m in (("jax", jspecs), ("torch", tspecs))}
    jplan = jjr.region_agg_plan(jreg, ["lg"], specs["jax"])
    tplan = tjr.region_agg_plan(treg, ["lg"], specs["torch"])
    assert tplan.signature() == jplan.signature()
    got = th.hbm_cache.join_agg(treg, ["lg"], specs["torch"])
    exp = jh.hbm_cache.join_agg(jreg, ["lg"], specs["jax"])
    assert_agg_same(got, exp)
    if treg.route != "searchsorted":
        assert treg.max_span > 0
    assert (treg.k2p_groups is not None) == (treg.route == "k2p")


def test_k2p_region_carries_and_charges_its_group_plan(tmp_path, monkeypatch):
    """A ``k2p`` region holds K2p's group plan, cut from the region's own
    K2 plan for its packing, on the region's device, and charges its
    bytes: the region's size is its tensors' bytes and ``r_order``'s,
    the group plan's four arrays among them."""
    import torch

    from hyperspace_tpu_torch.ops import kernels as tk

    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    t = JoinTree(tmp_path, seed=12, n=6000, n_r=3000)
    s = t.session("jax")
    entries = {e.name: e for e in s.collection_manager.get_indexes()}
    lf, rf = entries["jl"].content.files(), entries["jr"].content.files()
    conf = ResidencyConf(mode="force", min_rows=1, for_delta=True)
    reg = th.hbm_cache.prefetch_join(_groups(tex, lf, ["lk", "lv"]), _groups(tex, rf, ["rk"]),
                                     lf, rf, ["lk"], ["rk"], ["lv"], "cpu", conf)
    assert reg is not None and reg.route == "k2p"
    g = reg.k2p_groups
    s_tile, span = (a.numpy() for a in reg.plan[:2])
    want = tk.plan_k2p_groups(s_tile, span, reg.r_pack.vpw, tk.k2p_group_target(reg.device))
    assert (g.vpw, g.max_window, g.window_end) == (want.vpw, want.max_window, want.window_end)
    for a, b in zip(g.arrays(), want.arrays()):
        assert isinstance(a, torch.Tensor) and a.device == reg.device
        assert np.array_equal(a.numpy(), b)
    tensors = [reg.l_codes, reg.r_codes, reg.r_refs, reg.fences, *reg.plan, *g.arrays()]
    tensors += [x for x in (reg.wide_rows, reg.wide_lo, reg.wide_counts) if x is not None]
    for pc in (*reg.l_cols.values(), *reg.r_cols.values()):
        tensors += list(pc.arrays) + ([pc.slots] if pc.slots is not None else [])
    charged = sum(x.numel() * x.element_size() for x in tensors) + reg.r_order.nbytes
    assert reg.nbytes == charged and g.nbytes == sum(
        x.numel() * x.element_size() for x in g.arrays()) > 0


@pytest.mark.parametrize("seed", range(6))
def test_join_residency_fuzz(tmp_path, seed):
    """Random sides, forDelta on or off, each query twice from a populated
    region: the resident arms' rows and groups equal the reference's host
    path."""
    rng = np.random.default_rng(300 + seed)
    t = JoinTree(tmp_path, seed=seed + 30, n=int(rng.integers(800, 5000)),
                 n_r=int(rng.integers(100, 2000)), uniq_right=bool(seed % 3))
    s = port(t, ("on", "off")[seed % 2])
    aggs = (lambda m: [m.agg_sum("rv", "srv"), m.agg_count(), m.agg_sum("lv", "slv")]) \
        if seed % 3 == 0 else FULL
    make = lambda s_, mod, tr: agg_q(s_, mod, tr, aggs)  # noqa: E731
    populate(s, t, make)
    populate(s, t, join_q)
    for _ in range(2):
        got, m = warm(s, t, join_q)
        assert m.get("scan.path.resident_join") == 1
        assert rows(got) == rows(reference(t, join_q))
        got, m = warm(s, t, make)
        assert m.get("scan.path.resident_join_agg") == 1
        assert_agg_same(got, reference(t, make))

