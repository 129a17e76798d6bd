"""Parity of the port's native IO runtime (``hyperspace_tpu_torch.native``
over its own copy of ``tcb_io.cc``) with the JAX package's on the CPU.

Every binding gets the same seeded numpy input in both packages and must
give the same output bit for bit (f64 sums included), and the same output
as the port's numpy arm of the step it replaces: the range walk against
the host searches, the expansions against ``_expand_ranges`` and ``take``,
the group aggregate against bincounts over the expanded pairs, the loads
against mmap reads. A seeded fuzz covers random and empty segments,
left rows that match nothing, a hot key, and 4- and 8-byte columns. Then
the arms above it: ``read_batches`` with ``os.cpu_count`` and the page
cache test patched both ways, the page cache test itself, an int8 group key, Q17's shape served by both packages through the
native aggregate, and a float right column under duplicate matches, now
fused. A missing or failing compiler raises. Mirrors
``tests/test_native.py``, ``tests/test_batched_join.py`` and
``tests/test_join_aggregate.py``. Tolerance: exact everywhere.
"""

import mmap
import os
import re
from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu import native as jnative
from hyperspace_tpu.exec import aggregate as jagg
from hyperspace_tpu.exec import joins as jjoins
from hyperspace_tpu.storage import layout as jlayout
from hyperspace_tpu.storage import parquet_io as jax_parquet
from hyperspace_tpu.storage.columnar import Column as JaxColumn
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch import native as tnative
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.exec import aggregate as tagg
from hyperspace_tpu_torch.exec import executor as tex
from hyperspace_tpu_torch.exec import joins as tjoins
from hyperspace_tpu_torch.plan import aggregates as tspecs
from hyperspace_tpu_torch.storage import layout as tlayout
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_aggregate import (PLAIN, _li_rows, _od_rows, create_pq, fused,
                                        split_by_bucket, to_torch)
from tests.test_torch_hybrid import Tree

REPO = Path(__file__).resolve().parent.parent


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def batch_bits(got, exp) -> bool:
    return got.column_names == exp.column_names and all(
        same_bits(got.columns[n].data, exp.columns[n].data) for n in exp.column_names)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------
def test_source_is_the_reference_source_byte_for_byte():
    port = (REPO / "hyperspace_tpu_torch" / "native" / "tcb_io.cc").read_bytes()
    assert port == (REPO / "native" / "tcb_io.cc").read_bytes()


def test_library_is_built_into_build_named_by_the_source_digest():
    assert tnative.available()
    so = tnative._lib_path()
    assert so.parent == REPO / "hyperspace_tpu_torch" / "_build" and so.exists()
    assert re.fullmatch(r"libtcb_io-[0-9a-f]{12}\.so", so.name)


@pytest.mark.parametrize("fault", ["missing_compiler", "failing_compiler"])
def test_a_missing_or_failing_compiler_raises(fault, tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    if fault == "missing_compiler":
        monkeypatch.setattr(tnative, "_CXX", str(tmp_path / "no-such-g++"))
        match = "could not run"
    else:
        bad = tmp_path / "tcb_io.cc"
        bad.write_text("int hs_pread_many( {\n")
        monkeypatch.setattr(tnative, "_SRC", bad)
        match = "failed to build"
    with pytest.raises(HyperspaceException, match=match):
        tnative.available()
    # every entry raises alike; nothing falls back to Python
    with pytest.raises(HyperspaceException):
        tnative.smj_ranges(np.zeros(1, np.int64), np.zeros(1, np.int64), [0, 1], [0, 1])
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# the range walk, the expansions, the gather: a seeded fuzz
# ---------------------------------------------------------------------------
def _segments(seed):
    """Segment-aligned ascending codes: random segment sizes (some empty),
    left rows drawn from the right's keys and beyond them (no match),
    duplicate runs on both sides; seed 0 adds a hot key."""
    rng = np.random.default_rng(seed)
    n_seg = int(rng.integers(1, 9))
    ls, rs = [], []
    for k in range(n_seg):
        base = k * 1000
        nr = 0 if rng.random() < 0.15 else int(rng.integers(0, 300))
        nl = 0 if rng.random() < 0.15 else int(rng.integers(0, 400))
        r = np.sort(rng.integers(base, base + 200, nr))
        l = np.sort(rng.integers(base, base + 260, nl))
        if seed == 0 and k == 0:
            r = np.sort(np.concatenate([r, np.full(60_000, base + 7)]))
            l = np.sort(np.concatenate([l, np.full(5, base + 7)]))
        ls.append(l.astype(np.int64))
        rs.append(r.astype(np.int64))
    bounds = lambda parts: np.cumsum([0] + [len(p) for p in parts])  # noqa: E731
    return np.concatenate(ls), np.concatenate(rs), bounds(ls), bounds(rs)


def _columns(rng, n, side):
    """4- and 8-byte columns of every kind the gather copies."""
    return {f"{side}_i64": rng.integers(-2**62, 2**62, n).astype(np.int64),
            f"{side}_f64": rng.normal(0, 1e6, n),
            f"{side}_i32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            f"{side}_f32": rng.normal(0, 10, n).astype(np.float32)}


@pytest.mark.parametrize("seed", range(6))
def test_range_walk_expansions_and_gather_fuzz(seed):
    l, r, lb, rb = _segments(seed)
    t_full = tnative.smj_ranges_full(l, r, lb, rb)
    j_full = jnative.smj_ranges_full(l, r, lb, rb)
    assert all(same_bits(a, b) for a, b in zip(t_full[:3], j_full[:3]))
    assert t_full[3] == j_full[3] and j_full[4] == len(l)
    lo, cnt, off, total = t_full
    # the plain arm: the port's host search over the same segments
    plo, pcnt, order = tjoins.segmented_join_ranges(l, r, lb, rb, presorted=(False, True),
                                                   device="cpu")
    assert order is None and same_bits(lo, plo.astype(np.int64))
    assert same_bits(cnt, pcnt.astype(np.int64)) and total == int(pcnt.sum())
    assert all(same_bits(a, b) for a, b in zip(tnative.smj_ranges(l, r, lb, rb), (lo, cnt)))

    pairs = tnative.expand_pairs(lo, cnt)
    assert all(same_bits(a, b) for a, b in zip(pairs, tjoins._expand_ranges(lo, cnt, None)))
    assert all(same_bits(a, b) for a, b in zip(pairs, jnative.smj_pairs(l, r, lb, rb)))
    # the join's own route: the range walk, then the expansion over its offsets
    assert all(same_bits(a, b) for a, b in zip(tnative.expand_pairs(lo, cnt, t_full), pairs))
    if seed == 0:  # the hot key dominates: the gather splits by output position
        assert total >= 5 * 60_000

    rng = np.random.default_rng(100 + seed)
    la, ra = _columns(rng, len(l), "l"), _columns(rng, len(r), "r")
    assert tnative.smj_gather_supported(la, ra)
    for ranges in (None, t_full):
        tl, tr, tt = tnative.smj_join_gather(l, r, lb, rb, la, ra, ranges=ranges)
        jl, jr, jt = jnative.smj_join_gather(l, r, lb, rb, la, ra)
        assert tt == jt == total
        for got, ref, src, idx in ((tl, jl, la, pairs[0]), (tr, jr, ra, pairs[1])):
            assert list(got) == list(src)
            for n in src:
                assert same_bits(got[n], ref[n]) and same_bits(got[n], src[n][idx])


@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_gather_declines_1_and_2_byte_columns(dtype):
    l, r, lb, rb = _segments(3)
    la = {"narrow": np.zeros(len(l), dtype=dtype)}
    ra = {"wide": np.zeros(len(r), dtype=np.int64)}
    assert not tnative.smj_gather_supported(la, ra)
    assert tnative.smj_join_gather(l, r, lb, rb, la, ra) is None
    assert jnative.smj_join_gather(l, r, lb, rb, la, ra) is None


@pytest.mark.parametrize("vals", ["f64_nan", "i64_wrap"])
def test_group_agg_ranges_matches_reference_and_bincount(vals):
    rng = np.random.default_rng(5)
    l, r, lb, rb = _segments(4)
    lo, cnt, _off, _total = tnative.smj_ranges_full(l, r, lb, rb)
    span = 300
    keys = rng.integers(0, span - 7, len(l)).astype(np.int64)  # the top slots stay empty
    if vals == "f64_nan":
        v = rng.normal(0, 1e3, len(r))
        v[rng.random(len(r)) < 0.2] = np.nan
    else:  # large enough that the int64 sums wrap
        v = rng.integers(2**61, 2**62, len(r)).astype(np.int64)
    got = tnative.group_agg_ranges(keys, lo, cnt, v, span)
    ref = jnative.group_agg_ranges(keys, lo, cnt, v, span)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    # the plain arm: accumulate over the expanded pairs in order
    li, ri = tjoins._expand_ranges(lo, cnt, None)
    k, x = keys[li], v[ri]
    if vals == "f64_nan":
        ok = ~np.isnan(x)
        sums = np.bincount(k, weights=np.where(ok, x, 0.0), minlength=span)
        nn = np.bincount(k[ok], minlength=span)
    else:
        sums = np.zeros(span, dtype=np.int64)
        np.add.at(sums, k, x)
        nn = np.bincount(k, minlength=span)
    rows = np.bincount(keys, weights=cnt, minlength=span).astype(np.int64)
    assert same_bits(got[0], sums) and same_bits(got[1], nn.astype(np.int64))
    assert same_bits(got[2], rows)


# ---------------------------------------------------------------------------
# pread_many, write_file_atomic, read_batches
# ---------------------------------------------------------------------------
def test_pread_many_ranges_and_errors(tmp_path):
    p = tmp_path / "blob.bin"
    payload = bytes(range(256)) * 40
    p.write_bytes(payload)
    spans = [(0, 100), (50, 1000), (len(payload) - 7, 7), (4096, 0)]
    got = [np.zeros(nb, np.uint8) for _o, nb in spans]
    ref = [np.zeros(nb, np.uint8) for _o, nb in spans]
    tnative.pread_many([(str(p), o, nb, d) for (o, nb), d in zip(spans, got)])
    assert jnative.pread_many([(str(p), o, nb, d) for (o, nb), d in zip(spans, ref)])
    for (o, nb), g, rf in zip(spans, got, ref):
        assert bytes(g) == payload[o:o + nb] == bytes(rf)
    with pytest.raises(OSError, match="Truncated"):
        tnative.pread_many([(str(p), len(payload) - 10, 100, np.zeros(100, np.uint8))])
    with pytest.raises(FileNotFoundError):
        tnative.pread_many([(str(tmp_path / "missing.bin"), 0, 10, np.zeros(10, np.uint8))])
    with pytest.raises(ValueError):
        tnative.pread_many([(str(p), 0, 10, np.zeros(5, np.uint8))])


@pytest.mark.parametrize("kind", ["array", "bytes"])
def test_write_file_atomic(tmp_path, kind):
    data = np.arange(1000, dtype=np.int64)
    if kind == "bytes":
        data = data.tobytes()
    tnative.write_file_atomic(str(tmp_path / "port.bin"), data)
    assert jnative.write_file_atomic(str(tmp_path / "ref.bin"), data)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    assert np.array_equal(np.fromfile(tmp_path / "port.bin", dtype=np.int64), np.arange(1000))
    assert sorted(f.name for f in tmp_path.iterdir()) == ["port.bin", "ref.bin"]  # no litter
    with pytest.raises(OSError):
        tnative.write_file_atomic(str(tmp_path / "no" / "dir" / "x.bin"), data)


def _tcb_files(tmp_path, n_files=4, rows=500):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(n_files):
        n = 0 if i == 2 else rows  # one empty file
        batch = JaxBatch({
            "k": JaxColumn.from_values(rng.integers(0, 1000, n).astype(np.int64)),
            "v": JaxColumn.from_values(rng.uniform(0, 1, n)),
            "d": JaxColumn("date32", rng.integers(8000, 9000, n).astype(np.int32)),
            "s": JaxColumn.from_values(
                np.array([b"x", b"yy", b"zzz"], dtype=object)[rng.integers(0, 3, n)]),
        })
        p = tmp_path / f"b{i:05d}-n.tcb"
        jlayout.write_batch(p, batch, bucket=i)
        paths.append(p)
    return paths


def _mapped(a) -> bool:
    while a is not None:
        if isinstance(a, np.memmap):
            return True
        a = a.base
    return False


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("cpus", [1, 8])
@pytest.mark.parametrize("columns", [None, ["s", "k"]])
def test_read_batches_both_arms(tmp_path, monkeypatch, cpus, columns, cached):
    paths = _tcb_files(tmp_path)
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    monkeypatch.setattr(tlayout, "pages_cached", lambda mm, start, stop: cached)
    tnative.reset_call_counts()
    got = tlayout.read_batches(paths, columns=columns)
    native_arm = cpus > 1 and not cached
    assert tnative.call_counts().get("hs_pread_many", 0) == int(native_arm)
    monkeypatch.setenv("HYPERSPACE_TPU_NATIVE", "force")
    ref = jlayout.read_batches(paths, columns=columns)
    assert len(got) == len(ref) == len(paths)
    for g, rf, p in zip(got, ref, paths):
        assert g.column_names == rf.column_names == (columns or ["k", "v", "d", "s"])
        mm = tlayout.read_batch(p, columns)  # the mmap arm, the plain version
        for n in g.column_names:
            assert g.columns[n].dtype_str == rf.columns[n].dtype_str
            assert same_bits(g.columns[n].data, rf.columns[n].data)
            assert same_bits(g.columns[n].data, mm.columns[n].data)
            assert list(g.columns[n].to_values()) == list(rf.columns[n].to_values())
            # eager fresh buffers on the native arm, mmap views otherwise
            assert _mapped(g.columns[n].data) == (not native_arm)
    with pytest.raises(HyperspaceException, match="not in"):
        tlayout.read_batches(paths, columns=["nope"])


def test_pages_cached_sees_holes_and_read_pages(tmp_path):
    page = mmap.PAGESIZE
    p = tmp_path / "sparse.bin"
    with open(p, "wb") as f:  # a hole of 64 pages, then one written page
        f.truncate(64 * page)
        f.seek(64 * page)
        f.write(b"\1" * page)
    mm = np.memmap(p, dtype=np.uint8, mode="r")
    assert tlayout.pages_cached(mm, 64 * page, 65 * page)
    assert tlayout.pages_cached(mm, 10, 10)  # an empty range
    assert not tlayout.pages_cached(mm, 0, 65 * page)  # a hole is in no cache
    assert int(np.asarray(mm[: 64 * page]).sum()) == 0  # reading the hole caches it
    assert tlayout.pages_cached(mm, page // 2, 65 * page)


def test_read_batches_maps_files_in_the_page_cache(tmp_path, monkeypatch):
    paths = _tcb_files(tmp_path)  # just written: every page cached
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    tnative.reset_call_counts()
    got = tlayout.read_batches(paths)
    assert "hs_pread_many" not in tnative.call_counts()
    assert all(_mapped(c.data) for b in got for c in b.columns.values())


# ---------------------------------------------------------------------------
# the native aggregate arm
# ---------------------------------------------------------------------------
def test_int8_group_key_spanning_the_sign():
    n_r = 64
    rk = np.arange(n_r, dtype=np.int64)
    lk = np.tile(rk, 8)
    g = np.tile(np.array([-128, -1, 0, 127], dtype=np.int8), len(lk) // 4)
    left = JaxBatch({"lk": JaxColumn("int64", lk), "g": JaxColumn("int8", g)})
    right = JaxBatch({"rk": JaxColumn("int64", rk),
                      "rv": JaxColumn("float64", np.linspace(0, 1, n_r)),
                      "ri": JaxColumn("int32", np.arange(n_r, dtype=np.int32))})
    lb = split_by_bucket(left, ["lk"], 4, sort_keys=True)
    rb = split_by_bucket(right, ["rk"], 4, sort_keys=True)
    aggs = lambda m: [m.agg_count(), m.agg_sum("rv", "s"), m.agg_avg("rv", "a"),  # noqa: E731
                      m.agg_sum("ri", "si"), m.agg_count("ri", "ci")]
    tmetrics.reset()
    got = fused("torch", lb, rb, ["g"], aggs)
    assert tmetrics.get("aggregate.path.join_fused_native") == 1
    assert batch_bits(got, fused("jax", lb, rb, ["g"], aggs))
    assert got.columns["g"].data.tolist() == [-128, -1, 0, 127]
    assert got.columns["g"].data.dtype == np.int8


def test_native_arm_declines_what_the_reference_declines():
    rng = np.random.default_rng(8)
    rk = np.arange(50, dtype=np.int64)
    lk = rng.choice(rk, 400)
    left = JaxBatch({"lk": JaxColumn("int64", lk),
                     "wide": JaxColumn("int64", rng.integers(0, 1 << 40, 400)),
                     "lv": JaxColumn("int64", rng.integers(0, 9, 400))})
    right = JaxBatch({"rk": JaxColumn("int64", rk),
                      "rv": JaxColumn("float64", rng.normal(0, 1, 50))})
    lb = split_by_bucket(left, ["lk"], 4, sort_keys=True)
    rb = split_by_bucket(right, ["rk"], 4, sort_keys=True)
    for group_by, aggs in ((["wide"], lambda m: [m.agg_sum("rv", "s")]),  # span over the rule
                           (["lv"], lambda m: [m.agg_sum("lv", "s")]),  # a left value
                           (["lv", "wide"], lambda m: [m.agg_count()])):  # two keys
        tmetrics.reset()
        got = fused("torch", lb, rb, group_by, aggs)
        assert not tmetrics.get("aggregate.path.join_fused_native")
        assert tmetrics.get("aggregate.path.join_fused") == 1
        assert batch_bits(got, fused("jax", lb, rb, group_by, aggs))


@pytest.fixture(scope="module")
def q17_dup_tree(tmp_path_factory):
    """Q17's tables twice over: orders once with unique keys (``orders``)
    and once with every key twice (``orders2``, prices differing), so the
    join's float right column meets duplicate matches; each indexed on
    the order key."""
    t = Tree(tmp_path_factory.mktemp("q17_native"), **PLAIN)
    rng = np.random.default_rng(21)
    jax_parquet.write_parquet(t.root / "li" / "a.parquet", _li_rows(rng, 2500, 500))
    keys = np.arange(1, 501)
    jax_parquet.write_parquet(t.root / "orders" / "a.parquet", _od_rows(rng, keys))
    jax_parquet.write_parquet(t.root / "orders2" / "a.parquet",
                              _od_rows(rng, np.sort(np.concatenate([keys, keys]))))
    create_pq(t, "torch", "li_n", ["okey"], ["pkey", "qty", "ship"], "li")
    create_pq(t, "torch", "or_n", ["o_okey"], ["price", "odate"], "orders")
    create_pq(t, "torch", "or2_n", ["o_okey"], ["price", "odate"], "orders2")
    return t


def _q17(orders):
    def make(s, mod, m, root):
        return (s.read.parquet(str(root / "li"))
                .join(s.read.parquet(str(root / orders)), mod.col("okey") == mod.col("o_okey"))
                .group_by("pkey")
                .agg(m.agg_sum("price", "rev"), m.agg_avg("price", "avg_rev"), m.agg_count()))
    return make


@pytest.mark.parametrize("orders", ["orders", "orders2"])
def test_q17_served_by_the_native_arm_bit_for_bit(q17_dup_tree, orders):
    """Both packages serve Q17's shape through their native arm over the
    same index tree; the rows agree bit for bit. Under duplicate matches
    (``orders2``) the float sum is fused now, where the port materialized
    it before; it equals the materialized join's hash aggregate."""
    out = {}
    for key, mod in (("jax", hs_jax), ("torch", hs_torch)):
        s = q17_dup_tree.session(key)
        s.enable_hyperspace()
        tex.reset_groups_cache()
        tjoins.reset_setup_cache()
        tmetrics.reset()
        out[key] = _q17(orders)(s, mod, mod, q17_dup_tree.root).collect()
        if key == "torch":
            m = tmetrics.snapshot()
            assert m.get("aggregate.path.join_fused_native") == 1
            assert not m.get("aggregate.path.join_fused")
            assert m.get("join.path.presorted_merge_flat") == 1
            assert "IndexScan" in _q17(orders)(s, mod, mod, q17_dup_tree.root).explain()
    assert batch_bits(out["torch"], out["jax"]) and out["torch"].num_rows > 100
    s = q17_dup_tree.session("torch")
    s.disable_hyperspace()
    tmetrics.reset()
    off = _q17(orders)(s, hs_torch, hs_torch, q17_dup_tree.root).collect()
    assert not tmetrics.get("aggregate.path.join_fused_native")
    order = np.argsort(off.columns["pkey"].data, kind="stable")
    for n in ("pkey", "count"):
        assert same_bits(off.columns[n].data[order], out["torch"].columns[n].data)
    for n in ("rev", "avg_rev"):
        np.testing.assert_allclose(off.columns[n].data[order], out["torch"].columns[n].data,
                                   rtol=1e-12)
    counts = out["torch"].columns["count"].data
    assert (counts.sum() > 2500) == (orders == "orders2")


def test_aggregate_join_ranges_routes_native_then_generic(monkeypatch):
    """The same ranges through ``aggregate_join_ranges``: the native arm
    first, and its output equals the reference's and, on a unique right
    side, the generic arm's (its plain version: sequential sums in left-row
    order on both)."""
    rng = np.random.default_rng(12)
    rk = np.arange(300, dtype=np.int64)
    left = JaxBatch({"lk": JaxColumn("int64", rng.choice(rk, 3000)),
                     "g": JaxColumn("int64", rng.integers(0, 40, 3000))})
    right = JaxBatch({"rk": JaxColumn("int64", rk),
                      "rv": JaxColumn("float64", rng.normal(0, 100, 300))})
    lb = split_by_bucket(left, ["lk"], 4, sort_keys=True)
    rb = split_by_bucket(right, ["rk"], 4, sort_keys=True)
    tl, tr = ({b: to_torch(v) for b, v in d.items()} for d in (lb, rb))
    l_all, r_all, lo, counts, order = tjoins.bucketed_join_ranges(tl, tr, ["lk"], ["rk"], "cpu")
    specs = [tspecs.agg_sum("rv", "s"), tspecs.agg_count()]
    native_out = tagg._join_ranges_native(l_all, r_all, ["g"], specs, lo, counts, order)
    tmetrics.reset()
    routed = tagg.aggregate_join_ranges(l_all, r_all, ["g"], specs, lo, counts, order)
    assert tmetrics.get("aggregate.path.join_fused_native") == 1
    assert batch_bits(routed, native_out)
    jl, jr, jlo, jcounts, jorder = jjoins.bucketed_join_ranges(lb, rb, ["lk"], ["rk"])
    assert batch_bits(routed, jagg.aggregate_join_ranges(
        jl, jr, ["g"], [hs_jax.agg_sum("rv", "s"), hs_jax.agg_count()], jlo, jcounts, jorder))
    monkeypatch.setattr(tagg, "_join_ranges_native", lambda *a: None)
    tmetrics.reset()
    generic = tagg.aggregate_join_ranges(l_all, r_all, ["g"], specs, lo, counts, order)
    assert tmetrics.get("aggregate.path.join_fused") == 1
    assert batch_bits(generic, routed)
