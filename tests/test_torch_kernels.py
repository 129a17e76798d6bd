"""Kernel parity: the port's K1 (predicate mask) and K2 (sorted-intersect)
wrappers on the CPU — where they run the kernels' plain torch versions —
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs. Also K1c's plain version against the reference's fused
mask + block count, the f64 two-plane expansion, the resident entry
points (``resident_mask_fn``, ``resident_sorted_intersect``,
``resident_smj_amortized``, ``resident_fused_agg_over_join``) and their
declines, the postfix lowering K1's CUDA kernel interprets, the join span
planning, K2's edge cases (``ops/k2_cases.py``) and its span semantics
against the Pallas kernel's padded outputs, the constants K2's wrapper
shares with its source, and the CUDA kernels themselves on a card (marked
``gpu``; skipped without one). Tolerance: exact throughout.
"""

import functools
import struct

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops import kernels as jk
from hyperspace_tpu.plan import expr as jexpr

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.ops import k2_cases
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.ops import launch_counts, reset_launch_counts
from hyperspace_tpu_torch.plan import expr as texpr


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_KERNELS", "interpret")


def _arrays(n=3001, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n).astype(np.float32)
    f[::13] = -0.0
    return {
        "a": rng.integers(-500, 500, n).astype(np.int64),
        "b": rng.integers(0, 50, n).astype(np.int32),
        "d": rng.integers(8000, 10600, n).astype(np.int32),
        "f": f,
        "g": rng.integers(0, 50, n).astype(np.int32),
        "flag": rng.integers(0, 2, n).astype(bool),
    }


def _preds(m):
    """The same predicates in one package's expression IR."""
    c, is_in = m.col, m.is_in
    return [
        (c("a") >= -100) & (~(c("b") == 9) | is_in(c("b"), [1, 2, 3])),
        (c("a") < c("b")) & (c("flag") == 1),
        is_in(c("d"), [8100, 9000, 10000]) | (c("d") > 10500),
        (c("f") > 0.5) | (c("f") == 0.0) | (c("f") <= -1.25),
        ~((c("b") != c("g")) | (c("a") > 400)) & (c("d") >= 9000),
        (5 < c("b")) & (c("a") <= 7) & (c("d") < 9999) & (c("g") != 4),
    ]


@pytest.mark.parametrize("i", range(6))
def test_predicate_mask_matches_pallas(i):
    arrs = _arrays(seed=i)
    n = len(arrs["a"])
    want = jk.predicate_mask(_preds(jexpr)[i], arrs, n)
    got = tk.predicate_mask(_preds(texpr)[i], arrs, n, device="cpu")
    assert want is not None and got is not None
    assert got.dtype == np.bool_ and np.array_equal(got, want)


def test_predicate_mask_declines_where_reference_declines():
    arrs = _arrays()
    n = len(arrs["a"])
    nan = dict(arrs, f=np.where(np.arange(n) == 5, np.nan, arrs["f"]).astype(np.float32))
    wide = dict(arrs, a=arrs["a"] + 2**40)
    f64 = dict(arrs, f=arrs["f"].astype(np.float64))
    cases = [
        (lambda m: m.col("a") > 2**40, arrs),  # literal outside int32
        (lambda m: m.col("f") > 0.1, arrs),  # literal not exact in f32
        (lambda m: m.col("f") > 0.5, nan),  # NaN data
        (lambda m: m.col("a") > 3, wide),  # data outside int32
        (lambda m: m.col("f") > 0.5, f64),  # float64 column
        (lambda m: m.col("f") < m.col("b"), arrs),  # f32 vs int col-col
    ]
    for make, data in cases:
        assert jk.predicate_mask(make(jexpr), data, n) is None
        assert tk.predicate_mask(make(texpr), data, n, device="cpu") is None


def _random_expr(rng, names, depth=0):
    r = rng.random()
    if depth > 5 or r < 0.35:
        if rng.random() < 0.25:
            a, b = rng.choice(names, 2, replace=False)
            return texpr.Cmp(rng.choice(list(tk._CMP_CODE)), texpr.col(a), texpr.col(b))
        lit = int(rng.integers(-60, 60))
        op = rng.choice(list(tk._CMP_CODE))
        name = rng.choice(names)
        if rng.random() < 0.3:
            return texpr.Cmp(op, texpr.lit(lit), texpr.col(name))
        return texpr.Cmp(op, texpr.col(name), texpr.lit(lit))
    if r < 0.5:
        return texpr.Not(_random_expr(rng, names, depth + 1))
    kind = texpr.And if r < 0.75 else texpr.Or
    return kind(_random_expr(rng, names, depth + 1), _random_expr(rng, names, depth + 1))


@pytest.mark.parametrize("seed", range(8))
def test_postfix_lowering_matches_eval_mask(seed):
    rng = np.random.default_rng(seed)
    names = ("p", "q", "r")
    cols = [torch.from_numpy(rng.integers(-64, 64, 500).astype(np.int32)) for _ in names]
    for _ in range(25):
        e = _random_expr(rng, list(names))
        prog = tk.lower_predicate(e, names)
        assert prog.dtype == np.int32 and prog.shape[1] == 4
        # the kernel's stack is 64 slots; deeper-operand-first keeps it small
        depth, peak = 0, 0
        for opc, *_ in prog.tolist():
            depth += 1 if opc in (tk.OP_CMP_LIT, tk.OP_CMP_COL) else (
                -1 if opc in (tk.OP_AND, tk.OP_OR) else 0
            )
            peak = max(peak, depth)
        assert depth == 1 and peak <= tk._stack_need(e)
        want = tk.predicate_mask_reference(e, names, cols)
        assert torch.equal(tk.run_postfix_reference(prog, cols), want)


def test_deep_chain_lowers_in_two_slots():
    e = texpr.col("p") == 0
    for v in range(1, 300):  # a right-leaning IN-style chain
        e = texpr.Or(texpr.col("p") == v, e)
    prog = tk.lower_predicate(e, ("p",))
    assert tk._stack_need(e) == 2 and len(prog) == 599


def _clustered(n_l, n_r, buckets, seed):
    """Keys laid out as bucketed index data: hashed into buckets, sorted
    within each bucket, buckets concatenated (right side then argsorted)."""
    rng = np.random.default_rng(seed)
    r_keys = rng.choice(np.arange(4 * n_r, dtype=np.int64), n_r, replace=False)
    l_keys = rng.choice(r_keys, n_l) + rng.integers(0, 2, n_l) * 3
    b_of = lambda k: (k * 2654435761) % buckets  # noqa: E731
    l = np.concatenate([np.sort(l_keys[b_of(l_keys) == b]) for b in range(buckets)])
    return l, np.sort(r_keys)


@pytest.mark.parametrize(
    "n_l,n_r,buckets,seed", [(5000, 1500, 4, 0), (3000, 900, 1, 1), (2000, 2000, 16, 2)]
)
def test_sorted_intersect_matches_pallas(n_l, n_r, buckets, seed):
    l, r = _clustered(n_l, n_r, buckets, seed)
    want = jk.sorted_intersect_counts(l, r)
    got = tk.sorted_intersect_counts(l, r, device="cpu")
    assert want is not None and got is not None
    assert got[0].dtype == np.int64
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_sorted_intersect_plan_matches_reference():
    l, r = _clustered(9000, 3000, 8, 3)
    jp = jk._plan_sorted_intersect(l, r)
    tp = tk._plan_sorted_intersect(l, r)
    s_tile, span, base, l2, r2, _key, l32, r32, wide = jp
    for a, b in zip((s_tile, span, base, l2.reshape(-1), r2.reshape(-1), l32, r32, wide), tp):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("runs", [2, 3])
def test_sorted_intersect_multi_run_buckets_match_reference(runs):
    """Buckets of several files after incremental refreshes: each bucket's
    left side is its files' sorted runs in log order (a large run, then
    small appended ones), no longer one sorted run. K2's plan accepts and
    marks wide tiles (the run boundaries) as the reference's does, and the
    counts are exact."""
    rng = np.random.default_rng(40 + runs)
    r = np.sort(rng.choice(np.arange(800_000, dtype=np.int64), 200_000, replace=False))
    b_of = lambda k: (k * 2654435761) % 8  # noqa: E731
    parts = []
    for b in range(8):
        for size in [160_000] + [2_400] * (runs - 1):
            keys = rng.choice(r, size) + rng.integers(0, 2, size)
            parts.append(np.sort(keys[b_of(keys) == b]))
    l = np.concatenate(parts)
    jp = jk._plan_sorted_intersect(l, r)
    tp = tk._plan_sorted_intersect(l, r)
    assert jp is not None and tp is not None and tp[-1].any()
    s_tile, span, base, l2, r2, _key, l32, r32, wide = jp
    for a, b in zip((s_tile, span, base, l2.reshape(-1), r2.reshape(-1), l32, r32, wide), tp):
        assert np.array_equal(a, b)
    lt = np.searchsorted(r, l, side="left")
    got = tk.sorted_intersect_counts(l, r, device="cpu")
    assert np.array_equal(got[0], lt)
    assert np.array_equal(got[1], np.searchsorted(r, l, side="right") - lt)


def test_sorted_intersect_wide_tiles_fixed_up():
    rng = np.random.default_rng(4)
    r = np.sort(rng.integers(0, 10**6, 200_000)).astype(np.int64)
    # one left tile in eight spans the whole right side (a run boundary)
    l = np.sort(rng.choice(r, 8192))
    l[:1024] = rng.permutation(rng.choice(r, 1024))
    plan = tk._plan_sorted_intersect(l, r)
    assert plan is not None and plan[-1].any() and not plan[-1].all()
    want = jk.sorted_intersect_counts(l, r)
    got = tk.sorted_intersect_counts(l, r, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    lt = np.searchsorted(r, l, side="left")
    assert np.array_equal(got[0], lt)


def test_sorted_intersect_declines_where_reference_declines():
    l = np.array([0, 5, 2**40], dtype=np.int64)  # joint range overflows int32
    r = np.array([1, 5, 9], dtype=np.int64)
    assert jk.sorted_intersect_counts(l, r) is None
    assert tk.sorted_intersect_counts(l, r, device="cpu") is None
    rng = np.random.default_rng(5)
    r = np.sort(rng.integers(0, 10**6, 100_000)).astype(np.int64)
    l = rng.permutation(rng.choice(r, 4096))  # scattered: every tile wide
    assert jk.sorted_intersect_counts(l, r) is None
    assert tk.sorted_intersect_counts(l, r, device="cpu") is None
    z = tk.sorted_intersect_counts(l[:0], r, device="cpu")
    assert z[0].shape == (0,) and z[1].shape == (0,)


def _pallas_padded(l, r):
    """The reference's Pallas kernel (interpreted) on its own plan: the
    padded (lt, eq), pad rows and wide tiles included."""
    s_tile, span, base, l2, r2, key, *_ = jk._plan_sorted_intersect(l, r)
    with jk._x32():
        lt, eq = jk._get_smj_call(key)(s_tile, span, base, l2, r2)
    return np.asarray(lt).reshape(-1), np.asarray(eq).reshape(-1)


@pytest.mark.parametrize("name", k2_cases.CASES)
def test_k2_edge_cases_match_pallas(name):
    """K2's edge cases (the inputs chip_smoke.py and the card test hold the
    CUDA kernel to): the port's counts equal the reference's and numpy's,
    and K2's span semantics equal the Pallas kernel's padded outputs on
    every row, pad rows included."""
    l, r = k2_cases.k2_edge_cases(0)[name]
    plan = tk._plan_sorted_intersect(l, r)
    assert plan is not None and not plan[-1].any()
    want = jk.sorted_intersect_counts(l, r)
    got = tk.sorted_intersect_counts(l, r, device="cpu")
    lt = np.searchsorted(r, l, side="left")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], lt)
    assert np.array_equal(got[1], np.searchsorted(r, l, side="right") - lt)
    span_lt, span_eq = tk.sorted_intersect_span_reference(
        *(torch.from_numpy(a) for a in plan[:5]))
    p_lt, p_eq = _pallas_padded(l, r)
    assert np.array_equal(span_lt.numpy(), p_lt) and np.array_equal(span_eq.numpy(), p_eq)
    shape = {"span_64_and_1": (64, 0), "ragged": (2, 572)}.get(name)
    if shape:  # (largest span, pad rows)
        assert (int(plan[1].max()), len(plan[3]) - len(l)) == shape


def test_k2_span_semantics_on_wide_tiles_and_pads():
    """``sorted_intersect_span_reference`` is K2's exact function: wide
    tiles come back as (base, 0) and pad rows count within their span, as
    the Pallas kernel's padded outputs do."""
    rng = np.random.default_rng(4)
    r = np.sort(rng.integers(0, 10**6, 200_000)).astype(np.int64)
    l = np.sort(rng.choice(r, 7500))
    l[:1024] = rng.permutation(rng.choice(r, 1024))  # one wide tile
    plan = tk._plan_sorted_intersect(l, r)
    assert plan[-1].tolist() == [True] + [False] * 7
    span_lt, span_eq = tk.sorted_intersect_span_reference(
        *(torch.from_numpy(a) for a in plan[:5]))
    p_lt, p_eq = _pallas_padded(l, r)
    assert np.array_equal(span_lt.numpy(), p_lt) and np.array_equal(span_eq.numpy(), p_eq)
    assert not span_lt[:1024].any() and not span_eq[:1024].any()


def test_k2_constants_match_the_kernel_source():
    """The tile, the CTA, the fence stride and the span cap the wrapper
    assumes are the kernel source's, and the largest span's fences fit the
    shared memory a launch gets without asking (48 KB)."""
    import re
    from pathlib import Path

    src = (Path(tk.__file__).resolve().parent.parent / "csrc" / "sorted_intersect.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["TILE"] == tk.SMJ_TILE
    assert consts["THREADS"] == tk.K2_THREADS and consts["KEYS"] * tk.K2_THREADS == tk.SMJ_TILE
    assert consts["FENCE"] == tk.K2_FENCE and tk.SMJ_TILE % tk.K2_FENCE == 0
    assert consts["MAX_SPAN_TILES"] == tk.SMJ_MAX_SPAN_TILES
    assert tk.SMJ_MAX_SPAN_TILES * tk.SMJ_TILE // tk.K2_FENCE * 4 <= 48 * 1024
    r = torch.arange(3 * tk.SMJ_TILE, dtype=torch.int32)
    fences = tk.sorted_intersect_fences(r)
    assert torch.equal(fences, r[:: tk.K2_FENCE]) and fences.is_contiguous()


def test_k2_operand_checks_raise():
    base = torch.zeros(2 * tk.SMJ_TILE + 4, dtype=torch.int32)
    tk._check_aligned(tk.K2, "r", base[4:])
    with pytest.raises(HyperspaceException, match="r at .* is not 16-byte aligned"):
        tk._check_aligned(tk.K2, "r", base[1:])
    assert tk._check_k2_right(base[: 2 * tk.SMJ_TILE]) == 2 * tk.SMJ_TILE
    with pytest.raises(HyperspaceException, match="tile-padded"):
        tk._check_k2_right(base[:-1])


def test_cpu_wrappers_launch_nothing_and_cuda_requests_raise(monkeypatch):
    reset_launch_counts()
    arrs = _arrays()
    tk.predicate_mask(_preds(texpr)[0], arrs, len(arrs["a"]), device="cpu")
    l, r = _clustered(3000, 900, 2, 0)
    tk.sorted_intersect_counts(l, r, device="cpu")
    assert launch_counts() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HyperspaceException, match="cuda"):
        tk.predicate_mask(_preds(texpr)[0], arrs, len(arrs["a"]), device="cuda")
    with pytest.raises(HyperspaceException, match="cuda"):
        tk.sorted_intersect_counts(l, r)


def test_block_counts_match_pallas_counts_fn_pads_included():
    """K1c's plain version against the reference's fused mask + block count
    (``exec/hbm_cache.py:_counts_fn``, Pallas arm, interpreted) over the
    same zero-padded planes: the pad rows of the tail satisfy the
    predicate and count on both sides."""
    from hyperspace_tpu.exec import hbm_cache as jh

    rng = np.random.default_rng(3)
    n_pad, n_real = 32768, 32768 - 5000
    data = {c: np.zeros(n_pad, dtype=np.int32) for c in ("a", "b")}
    data["a"][:n_real] = rng.integers(-300, 300, n_real)
    data["b"][:n_real] = rng.integers(0, 50, n_real)
    names = ("a", "b")
    for i, mk in enumerate((
        lambda m: (m.col("a") <= 10) & (m.col("b") < 30),
        lambda m: ~(m.col("a") == 0) | m.is_in(m.col("b"), [3, 4]),
        lambda m: m.col("a") > m.col("b"),
    )):
        jn = jk.narrow_expr_to_i32(mk(jexpr))
        fn = jh._counts_fn(jn, names, n_pad // jk.LANES, True)
        with jk._x32():
            want = np.asarray(fn([data[c].reshape(-1, jk.LANES) for c in names]))
        got = tk.predicate_block_counts_reference(
            tk.narrow_expr_to_i32(mk(texpr)), names, [torch.from_numpy(data[c]) for c in names]
        )
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        if i == 0:
            assert int(got[-1]) >= 5000  # the pads matched
    cols = [torch.from_numpy(data[c][:-1]) for c in names]
    with pytest.raises(HyperspaceException, match="multiple of 8192"):
        tk.predicate_block_counts_tensor(texpr.col("a") > 0, names, cols)


def test_expand_f64_predicate_matches_reference():
    """The two-plane rewrite of f64 comparisons: the port's expansion,
    evaluated over the int32 planes, equals the predicate over the floats
    and the reference's expansion (oracle: test_hbm_cache.py)."""
    from hyperspace_tpu.ops import floatbits as jf
    from hyperspace_tpu.storage.columnar import Column as JColumn
    from hyperspace_tpu.storage.columnar import ColumnarBatch as JBatch

    from hyperspace_tpu_torch.ops import floatbits as tf
    from hyperspace_tpu_torch.storage.columnar import Column, ColumnarBatch

    rng = np.random.default_rng(2)
    d = np.concatenate([rng.normal(0, 1e6, 500), rng.normal(0, 1e-6, 500),
                        [0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 2.0**40, -(2.0**33)]])
    hi, lo = tf.ordered_i64_planes(tf.f64_to_ordered_i64(d))
    jhi, jlo = jf.ordered_i64_planes(jf.f64_to_ordered_i64(d))
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    nh, nl = tf.plane_names("d")
    assert (nh, nl) == jf.plane_names("d")
    shim = ColumnarBatch({nh: Column("int32", hi), nl: Column("int32", lo)})
    jshim = JBatch({nh: JColumn("int32", hi), nl: JColumn("int32", lo)})
    fbatch = ColumnarBatch({"d": Column("float64", d)})
    for v in (0.0, -1.5, 1.5, 3.25e5, -7.125e-7, 2.0**40, -(2.0**33)):
        for op in ("eq", "ne", "lt", "le", "gt", "ge"):
            for pred, jpred in (
                (texpr.Cmp(op, texpr.col("d"), texpr.lit(v)), jexpr.Cmp(op, jexpr.col("d"), jexpr.lit(v))),
                (texpr.Cmp(op, texpr.lit(v), texpr.col("d")), jexpr.Cmp(op, jexpr.lit(v), jexpr.col("d"))),
            ):
                ex = tf.expand_f64_predicate(pred, {"d"})
                jx = jf.expand_f64_predicate(jpred, {"d"})
                got = np.asarray(texpr.eval_mask(ex, shim))
                assert np.array_equal(got, np.asarray(texpr.eval_mask(pred, fbatch))), (op, v)
                assert np.array_equal(got, np.asarray(jexpr.eval_mask(jx, jshim))), (op, v)
                assert tk.narrow_expr_to_i32(ex) is not None
    assert tf.expand_f64_predicate(texpr.col("d") < texpr.col("d"), {"d"}) is None
    assert tf.expand_f64_predicate(texpr.col("d") == float("nan"), {"d"}) is None
    assert jf.f64_literal_planes(2**63 - 1) is tf.f64_literal_planes(2**63 - 1) is None


@pytest.mark.parametrize("i", [0, 3, 5])
def test_resident_mask_fn_matches_reference(i):
    arrs = _arrays(seed=i)
    n = len(arrs["a"])
    jfn, jcols = jk.resident_mask_fn(_preds(jexpr)[i], arrs)
    tfn, tcols = tk.resident_mask_fn(_preds(texpr)[i], arrs, device="cpu")
    with jk._x32():
        want = np.asarray(jfn(jcols)).reshape(-1)[:n].astype(bool)
    got = tfn(tcols)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    nan = dict(arrs, f=np.where(np.arange(n) == 5, np.nan, arrs["f"]).astype(np.float32))
    bad = jexpr.col("f") > 0.5
    assert jk.resident_mask_fn(bad, nan) == (None, None)
    assert tk.resident_mask_fn(texpr.col("f") > 0.5, nan, device="cpu") == (None, None)


def test_resident_sorted_intersect_and_amortized_match_reference():
    l, r = _clustered(5000, 1500, 4, 0)
    jrun = jk.resident_sorted_intersect(l, r)
    trun = tk.resident_sorted_intersect(l, r, device="cpu")
    with jk._x32():
        jlt, jeq = (np.asarray(a).reshape(-1)[: len(l)] for a in jrun())
    tlt, teq = trun()
    assert np.array_equal(tlt[: len(l)].numpy(), jlt)
    assert np.array_equal(teq[: len(l)].numpy(), jeq)
    per_launch = tk.resident_smj_amortized(l, r, iters=4, repeats=2, prepared=trun)
    assert per_launch is not None and per_launch > 0
    # declines: an empty side, a wide tile, an overflowing key range
    rng = np.random.default_rng(4)
    r_big = np.sort(rng.integers(0, 10**6, 200_000)).astype(np.int64)
    wide = np.sort(rng.choice(r_big, 8192))
    wide[:1024] = rng.permutation(rng.choice(r_big, 1024))  # one tile spans all
    for ll, rr in ((l[:0], r), (wide, r_big), (np.array([0, 2**40]), np.array([1, 5]))):
        assert jk.resident_sorted_intersect(ll, rr) is None
        assert tk.resident_sorted_intersect(ll, rr, device="cpu") is None
        assert jk.resident_smj_amortized(ll, rr, 3, lambda f, k: (0, 0), 1) is None
        assert tk.resident_smj_amortized(ll, rr, 3, device="cpu") is None
    for mod in (jk, tk):
        with pytest.raises(ValueError, match="iters >= 2"):
            mod.resident_smj_amortized(l, r, 1, *((lambda f, k: (0, 0), 1) if mod is jk else ()))


def _agg_ref(l_keys, r_keys, r_vals, groups, n_g):
    lo = np.searchsorted(r_keys, l_keys, side="left")
    hi = np.searchsorted(r_keys, l_keys, side="right")
    rvc = np.concatenate([[0], np.cumsum(r_vals.astype(np.int64))])
    exp_c = np.zeros(n_g, dtype=np.int64)
    exp_s = np.zeros(n_g, dtype=np.int64)
    np.add.at(exp_c, groups.astype(np.int64), hi - lo)
    np.add.at(exp_s, groups.astype(np.int64), rvc[hi] - rvc[lo])
    return exp_c, exp_s


def _agg_cases():
    """tests/test_kernels.py's fused-aggregate cases: duplicates on both
    sides with empty groups, tiny inputs with one group, disjoint key
    ranges, negative keys and sums, uint32 keys, and a key range too wide
    for int32 narrowing (the torch arm)."""
    rng = np.random.default_rng(5)
    yield (rng.integers(0, 2000, 5000).astype(np.int64),
           np.sort(rng.integers(0, 2000, 3000)).astype(np.int64),
           rng.integers(-(1 << 20), 1 << 20, 3000).astype(np.int64),
           rng.integers(0, 64, 5000).astype(np.int64), 64)
    rng = np.random.default_rng(11)
    yield (np.array([5, 1, 9], dtype=np.int64), np.array([1, 1, 5, 7], dtype=np.int64),
           np.array([10, -20, 30, 40], dtype=np.int64), np.zeros(3, dtype=np.int64), 1)
    yield (rng.integers(0, 100, 500).astype(np.int64),
           np.sort(rng.integers(10_000, 20_000, 400)).astype(np.int64),
           rng.integers(-50, 50, 400).astype(np.int64), rng.integers(0, 8, 500).astype(np.int64), 8)
    yield (rng.integers(-5000, -1000, 2000).astype(np.int64),
           np.sort(rng.integers(-5000, -1000, 1500)).astype(np.int64),
           rng.integers(-(1 << 30), 1 << 30, 1500).astype(np.int64),
           rng.integers(0, 16, 2000).astype(np.int64), 16)
    yield (rng.integers(0, 1 << 31, 1000).astype(np.uint32),
           np.sort(rng.integers(0, 1 << 31, 800).astype(np.uint32)),
           rng.integers(0, 100, 800).astype(np.int64), rng.integers(0, 4, 1000).astype(np.int64), 4)
    yield (rng.integers(0, 1 << 33, 1000).astype(np.int64),
           np.sort(rng.integers(0, 1 << 33, 900)).astype(np.int64),
           rng.integers(-100, 100, 900).astype(np.int64), rng.integers(0, 7, 1000).astype(np.int64), 7)


@pytest.mark.parametrize("i", range(6))
def test_fused_agg_over_join_matches_reference(i):
    import jax

    from hyperspace_tpu_torch.telemetry.metrics import metrics

    lk, rk, rv, g, ng = list(_agg_cases())[i]
    metrics.reset()
    run = tk.resident_fused_agg_over_join(lk, rk, rv, g, ng, device="cpu")
    assert run is not None
    gc, gs = run()
    assert gc.dtype == gs.dtype == torch.int64
    exp_c, exp_s = _agg_ref(np.asarray(lk, dtype=np.int64), np.asarray(rk, dtype=np.int64), rv, g, ng)
    assert np.array_equal(gc.numpy(), exp_c) and np.array_equal(gs.numpy(), exp_s)
    arm = "torch" if i == 5 else "kernel"  # only the wide key range declines K2
    assert metrics.get(f"join.fused_agg.path.{arm}") == 1
    if i in (0, 5):
        jc, js = (np.asarray(a) for a in jax.block_until_ready(
            jk.resident_fused_agg_over_join(lk, rk, rv, g, ng)()))
        assert np.array_equal(gc.numpy(), jc) and np.array_equal(gs.numpy(), js)


def test_fused_agg_refusals_match_reference():
    lk, rk, rv, g, ng = next(_agg_cases())
    bad = g.copy()
    bad[0] = ng
    cases = [
        (lk[:0], rk, rv, g[:0], ng),  # empty side
        (lk, rk, rv.astype(np.float64), g, ng),  # float values
        (lk, rk, rv, bad, ng),  # group code out of range
        (lk, rk, rv, g, 0),  # no groups
        (lk, rk, rv[:-1], g, ng),  # ragged values
        (lk, rk, rv, g[:-1], ng),  # ragged groups
        (np.arange(4, dtype=np.int64), np.arange(4, dtype=np.int64),
         np.full(4, 1 << 63, dtype=np.uint64), np.zeros(4, dtype=np.int64), 1),
        (np.arange(2, dtype=np.int64), np.array([0, np.iinfo(np.int64).max]),
         np.ones(2, dtype=np.int64), np.zeros(2, dtype=np.int64), 1),
    ]
    for args in cases:
        assert jk.resident_fused_agg_over_join(*args) is None
        assert tk.resident_fused_agg_over_join(*args, device="cpu") is None


def _range_pred():
    c = texpr.col
    return ((c("p") >= -40) & (c("p") < 40) & (c("q") < 10) & (c("r") >= -30)
            & (c("r") < 50))


def _in_chain(n_values=300):
    e = texpr.col("p") == 0
    for v in range(1, n_values):  # the 599-instruction IN-style chain
        e = texpr.Or(texpr.col("p") == v, e)
    return e


def _deep_program(depth, n_cols=2):
    """A hand-written postfix program that fills ``depth`` stack slots:
    ``depth`` compares (one negated), then alternating AND / OR."""
    prog = [(tk.OP_CMP_LIT, i % n_cols, i % 6, (i * 7) % 50 - 25) for i in range(depth)]
    prog.insert(3, (tk.OP_NOT, 0, 0, 0))
    prog += [(tk.OP_AND if i % 2 else tk.OP_OR, 0, 0, 0) for i in range(depth - 1)]
    return np.array(prog, dtype=np.int32)


def _cu_source():
    from pathlib import Path

    return (Path(tk.__file__).resolve().parent.parent / "csrc" / "predicate_mask.cu").read_text()


def test_k1_param_block_layout_matches_the_kernel_source():
    """The parameter block the wrapper packs is the kernel's ``Params``:
    same caps, same field offsets and size (read from the source's
    static_asserts), and a packed block decodes to its inputs."""
    import re

    src = _cu_source()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["MAX_COLS"]) == tk.K1_MAX_COLS
    assert int(consts["MAX_PARAM_INSTR"]) == tk.K1_MAX_PARAM_INSTR
    assert int(consts["STACK_SLOTS"]) == tk.K1_STACK_SLOTS
    offs = dict(re.findall(r"offsetof\(Params, (\w+)\) == (\d+)", src))
    assert {k: int(v) for k, v in offs.items()} == {
        k: tk._PARAM_DTYPE.fields[k][1] for k in offs}
    size = int(re.search(r"sizeof\(Params\) == (\d+)", src).group(1))
    assert tk._PARAM_DTYPE.itemsize == size <= 4096  # the classic parameter limit

    names = ("p", "q", "r")
    program = tk.K1Program(tk.lower_predicate(_range_pred(), names), 3)
    assert len(program.prog) == 9 and program.depth == 2 and not program.staged
    blob = program.params([0x1000, 0x2010, 0x3020], 6_001_215, 0xABC0)
    assert len(blob) == size
    rec = np.frombuffer(blob, dtype=tk._PARAM_DTYPE)[0]
    assert np.array_equal(rec["prog"][:9], program.prog) and not rec["prog"][9:].any()
    assert rec["cols"][:3].tolist() == [0x1000, 0x2010, 0x3020] and not rec["cols"][3:].any()
    assert (rec["staged"], rec["n_rows"], rec["out"]) == (0, 6_001_215, 0xABC0)
    assert (rec["n_cols"], rec["n_instr"], rec["depth"]) == (3, 9, 2)
    assert rec["col_table"] == 0  # the addresses fit the block


@pytest.mark.parametrize("case", ["one", "at_cap", "over_cap", "in_chain", "deep64",
                                  "cols_17", "beyond_both", "no_cols", "too_deep",
                                  "underflow", "missing_col"])
def test_k1_program_caps(case):
    """Which programs ride in the parameter block, which are staged (copied
    to the card once, loaded into shared memory per CTA), which take their
    column addresses from a device array, and which raise."""
    alternating = lambda n: np.array(  # noqa: E731  n compares ORed: depth 2
        [(tk.OP_CMP_LIT, 0, 0, 0)] + [r for i in range(1, n) for r in
                                      ((tk.OP_CMP_LIT, 0, 0, i), (tk.OP_OR, 0, 0, 0))],
        dtype=np.int32)
    ok = {
        "one": (np.array([(tk.OP_CMP_LIT, 0, 2, 5)], dtype=np.int32), 1, False, 1),
        "at_cap": (np.concatenate([alternating(120), [(tk.OP_NOT, 0, 0, 0)]]).astype(np.int32),
                   1, False, 2),
        "over_cap": (alternating(121), 1, True, 2),
        "in_chain": (tk.lower_predicate(_in_chain(), ("p",)), 1, True, 2),
        "deep64": (_deep_program(64), 2, False, 64),
        "cols_17": (np.array([(tk.OP_CMP_LIT, 0, 4, 0)] + [
            r for i in range(1, 17) for r in ((tk.OP_CMP_LIT, i, 4, 0), (tk.OP_AND, 0, 0, 0))],
            dtype=np.int32), 17, False, 2),
    }
    bad = {
        "beyond_both": (alternating(7600), 1, "fits neither"),
        "no_cols": (np.array([(tk.OP_CMP_LIT, 0, 0, 1)], dtype=np.int32), 0, "no columns"),
        "too_deep": (_deep_program(65), 2, "stack slots"),
        "underflow": (np.array([(tk.OP_CMP_LIT, 0, 0, 1), (tk.OP_AND, 0, 0, 0)],
                               dtype=np.int32), 1, "underflows"),
        "missing_col": (np.array([(tk.OP_CMP_COL, 0, 0, 2)], dtype=np.int32), 2, "missing"),
    }
    if case in bad:
        prog, n_cols, msg = bad[case]
        with pytest.raises(HyperspaceException, match=msg):
            tk.K1Program(prog, n_cols)
        return
    prog, n_cols, staged, depth = ok[case]
    program = tk.K1Program(prog, n_cols)
    assert len(program.prog) == len(prog)
    assert program.staged is staged and program.depth == depth
    assert len(prog) == {"at_cap": tk.K1_MAX_PARAM_INSTR, "over_cap": 241,
                         "in_chain": 599}.get(case, len(prog))
    rec = np.frombuffer(program.template, dtype=tk._PARAM_DTYPE)[0]
    assert rec["n_instr"] == len(prog)
    assert np.array_equal(rec["prog"][: len(prog)], prog) != staged
    if staged:
        with pytest.raises(HyperspaceException, match="staged"):
            program.params([0x100] * n_cols, 10, 0x200)
        dev = program.on_device(torch.device("cpu"))
        assert dev is program.on_device(torch.device("cpu"))  # copied once
        assert np.array_equal(dev.numpy(), prog)
        blob = program.params([0x100] * n_cols, 10, 0x200, dev.data_ptr())
        assert np.frombuffer(blob, dtype=tk._PARAM_DTYPE)[0]["staged"] == dev.data_ptr()
    addrs = [0x100 * (i + 1) for i in range(n_cols)]
    staged_addr = 0x9000 if staged else 0
    wide = n_cols > tk.K1_MAX_COLS
    with pytest.raises(HyperspaceException, match="address table"):
        program.params(addrs, 10, 0x200, staged_addr, 0 if wide else 0x7000)
    rec = np.frombuffer(program.params(addrs, 10, 0x200, staged_addr, 0x7000 if wide else 0),
                        dtype=tk._PARAM_DTYPE)[0]
    assert rec["col_table"] == (0x7000 if wide else 0)
    assert rec["cols"].tolist() == ([0] * tk.K1_MAX_COLS if wide else
                                    addrs + [0] * (tk.K1_MAX_COLS - n_cols))
    assert tk.k1_smem_bytes(len(prog), depth, tk.K1C_THREADS) <= tk.K1_MAX_SMEM


def test_lowering_cache_is_keyed_and_bounded(monkeypatch):
    monkeypatch.setattr(tk, "_LOWERED", type(tk._LOWERED)())
    names = ("p", "q", "r")
    a = tk.lowered_predicate(_range_pred(), names)
    assert tk.lowered_predicate(_range_pred(), names) is a  # an equal expression hits
    assert tk.lowered_predicate(_range_pred(), ("p", "q", "r", "s")) is not a
    for v in range(300):
        tk.lowered_predicate(texpr.col("p") == v, ("p",))
        tk.lowered_predicate(_range_pred(), names)  # kept hot
    assert len(tk._LOWERED) == tk._LOWER_CACHE_SIZE
    assert tk.lowered_predicate(_range_pred(), names) is a
    assert np.array_equal(a.prog, tk.lower_predicate(_range_pred(), names))


def test_k1_column_checks_raise():
    base = torch.zeros(64, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0
    assert tk.k1_column_addrs([base[:32], base[32:]], "K1") == [
        base.data_ptr(), base.data_ptr() + 128]
    with pytest.raises(HyperspaceException, match="16-byte aligned"):
        tk.k1_column_addrs([base[1:33], base[32:]], "K1")
    with pytest.raises(HyperspaceException, match="ragged"):
        tk.k1_column_addrs([base[:32], base[:31]], "K1")
    program = tk.K1Program(np.array([(tk.OP_CMP_COL, 0, 2, 1)], dtype=np.int32), 2)
    with pytest.raises(HyperspaceException, match="columns for a program over 2"):
        program.params([base.data_ptr()], 32, base.data_ptr())
    with pytest.raises(HyperspaceException, match="multiple of 8192"):
        tk.program_block_counts_tensor(program, [base, base])


@pytest.mark.parametrize("case", ["deep64", "in_chain", "range"])
def test_program_entry_points_plain_versions(case):
    """The raw-program entry points on CPU tensors: their plain versions
    against numpy, for a depth-64 hand-written program, the IN chain and
    the range predicate (mask and per-block counts)."""
    rng = np.random.default_rng(12)
    n = 3 * tk.BLOCK_ROWS
    a = {k: rng.integers(-60, 60, n).astype(np.int32) for k in ("p", "q", "r")}
    if case == "deep64":
        prog = _deep_program(64)
        names = ("p", "q")
        want = None
    elif case == "in_chain":
        names = ("p",)
        prog = tk.lower_predicate(_in_chain(), names)
        want = (a["p"] >= 0) & (a["p"] < 300)
    else:
        names = ("p", "q", "r")
        prog = tk.lower_predicate(_range_pred(), names)
        p, q, r = a["p"], a["q"], a["r"]
        want = (p >= -40) & (p < 40) & (q < 10) & (r >= -30) & (r < 50)
    if want is None:  # evaluate the postfix program with numpy
        ops = [np.equal, np.not_equal, np.less, np.less_equal, np.greater, np.greater_equal]
        stack = []
        for opc, x, b, c in prog.tolist():
            if opc == tk.OP_CMP_LIT:
                stack.append(ops[b](a[names[x]], c))
            elif opc == tk.OP_NOT:
                stack.append(~stack.pop())
            else:
                t, u = stack.pop(), stack.pop()
                stack.append(t & u if opc == tk.OP_AND else t | u)
        want = stack.pop()
    program = tk.K1Program(prog, len(names))
    cols = [torch.from_numpy(a[k]) for k in names]
    reset_launch_counts()
    got = tk.program_mask_tensor(program, cols)
    assert np.array_equal(got.numpy(), want)
    counts = tk.program_block_counts_tensor(program, cols)
    assert counts.dtype == torch.int32
    assert np.array_equal(counts.numpy(), want.reshape(-1, tk.BLOCK_ROWS).sum(1))
    assert launch_counts() == {}


def test_predicates_over_more_columns_than_the_parameters_hold_stay_on_k1():
    """A predicate naming more columns than K1's parameter block holds
    still narrows and lowers for K1 (its addresses then travel in a device
    array); the plain version's mask is the numpy one."""
    rng = np.random.default_rng(13)
    names = [f"c{i:02d}" for i in range(tk.K1_MAX_COLS + 4)]
    arrs = {k: rng.integers(0, 9, 500).astype(np.int32) for k in names}
    wide = texpr.col(names[0]) > 3
    for k in names[1:]:
        wide = wide & (texpr.col(k) >= 1)
    want = (arrs["c00"] > 3) & np.logical_and.reduce([arrs[k] >= 1 for k in names[1:]])
    narrowed, got_names, _ = tk.prepare_predicate(wide, arrs)
    assert tk.lowered_predicate(narrowed, got_names).n_cols == len(names)
    assert np.array_equal(tk.predicate_mask(wide, arrs, 500, device="cpu"), want)
    dispatch, cols = tk.resident_mask_fn(wide, arrs, device="cpu")
    assert np.array_equal(dispatch(cols).numpy(), want) and 0 < want.sum() < 500


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    reset_launch_counts()
    for i, p in enumerate(_preds(texpr)):
        arrs = _arrays(200_003, seed=i)
        n = len(arrs["a"])
        want = tk.predicate_mask(p, arrs, n, device="cpu")
        assert np.array_equal(tk.predicate_mask(p, arrs, n, device="cuda"), want)
    l, r = _clustered(300_000, 90_000, 16, 7)
    want = tk.sorted_intersect_counts(l, r, device="cpu")
    got = tk.sorted_intersect_counts(l, r, device="cuda")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    # K2's edge cases: the counts against numpy, and the padded outputs
    # against K2's span semantics on every row (pad rows included)
    for name, (l, r) in k2_cases.k2_edge_cases(0).items():
        got = tk.sorted_intersect_counts(l, r, device="cuda")
        lt = np.searchsorted(r, l, side="left")
        assert np.array_equal(got[0], lt), name
        assert np.array_equal(got[1], np.searchsorted(r, l, side="right") - lt), name
        plan = tk._plan_sorted_intersect(l, r)
        args = [torch.from_numpy(a).cuda() for a in plan[:5]]
        lt_d, eq_d = tk.sorted_intersect_tensors(*args, max_span=int(plan[1].max()))
        want_lt, want_eq = tk.sorted_intersect_span_reference(*args)
        assert torch.equal(lt_d, want_lt) and torch.equal(eq_d, want_eq), name
    n_k2 = 1 + 2 * len(k2_cases.CASES)
    with pytest.raises(HyperspaceException, match="16-byte aligned"):
        padded = torch.zeros(len(args[4]) + 1, dtype=torch.int32, device="cuda")
        tk.sorted_intersect_tensors(*args[:4], padded[1:1 + len(args[4])])
    wide_span = args[1].clone()
    wide_span[0] = tk.SMJ_MAX_SPAN_TILES + 1
    with pytest.raises(HyperspaceException, match="span of 65"):
        tk.sorted_intersect_tensors(args[0], wide_span, *args[2:])
    rng = np.random.default_rng(8)
    cols = [torch.from_numpy(rng.integers(-99, 99, 25 * tk.BLOCK_ROWS).astype(np.int32))
            for _ in range(2)]
    for p in ((texpr.col("p") <= 10) & ~(texpr.col("q") == 3), texpr.col("p") < texpr.col("q")):
        want = tk.predicate_block_counts_tensor(p, ("p", "q"), cols)
        got = tk.predicate_block_counts_tensor(p, ("p", "q"), [c.cuda() for c in cols])
        assert torch.equal(got.cpu(), want)
    # ragged lengths x programs of 1, 9 and 599 instructions, col-col + NOT,
    # a hand-written program 64 stack slots deep, and programs over 6
    # columns (more than the kernel holds in registers) and over 20 (more
    # addresses than the parameter block holds), in the parameters and
    # staged: masks, and block counts where the length is a multiple of
    # the block
    c = texpr.col
    six = ("p", "q", "r", "s", "t", "u")
    wide = (c("p") < c("q")) & ~(c("r") == 7) | (c("s") >= c("t")) & (c("u") != 3)
    twenty = six + tuple(f"v{i:02d}" for i in range(14))
    over = wide
    for name in twenty[6:]:
        over = over & (c(name) > -50)
    programs = [
        tk.K1Program(np.array([(tk.OP_CMP_LIT, 0, 3, 10)], dtype=np.int32), 3),
        tk.lowered_predicate(_range_pred(), ("p", "q", "r")),
        tk.K1Program(tk.lower_predicate(_in_chain(), ("p",)), 1),
        tk.lowered_predicate(~(c("p") < c("q")) | ((c("r") != c("p")) & ~(c("q") >= 3)),
                             ("p", "q", "r")),
        tk.K1Program(_deep_program(64, n_cols=3), 3),
        tk.lowered_predicate(wide, six),
        tk.lowered_predicate(_in_chain() | wide, six),
        tk.lowered_predicate(over, twenty),
        tk.lowered_predicate(_in_chain() | over, twenty),
    ]
    assert [len(pg.prog) for pg in programs[:3]] == [1, 9, 599] and programs[4].depth == 64
    assert [(pg.n_cols, pg.staged) for pg in programs[5:]] == [
        (6, False), (6, True), (20, False), (20, True)]
    n_masks = n_counts = 0
    for n in (1, 31, 4095, 4097, 30_006, 200_003, 2 * tk.BLOCK_ROWS):
        host = [torch.from_numpy(rng.integers(-60, 320, n).astype(np.int32)) for _ in range(20)]
        dev = [t.cuda() for t in host]
        for pg in programs:
            k = pg.n_cols
            got = tk.program_mask_tensor(pg, dev[:k])
            assert torch.equal(got.cpu(), tk.program_mask_tensor(pg, host[:k])), (n, len(pg.prog))
            n_masks += 1
            if n % tk.BLOCK_ROWS == 0:
                got = tk.program_block_counts_tensor(pg, dev[:k])
                assert torch.equal(got.cpu(), tk.program_block_counts_tensor(pg, host[:k]))
                n_counts += 1
    big = torch.zeros(4097, dtype=torch.int32, device="cuda")
    with pytest.raises(HyperspaceException, match="16-byte aligned"):
        tk.program_mask_tensor(programs[0], [big[1:], big[1:], big[1:]])
    assert launch_counts() == {tk.K1: 6 + n_masks, tk.K2: n_k2, tk.K2F: n_k2,
                               tk.K1C: 2 + n_counts}


@pytest.mark.gpu
def test_cuda_k1_long_not_in_program_matches_plain_version():
    """Hybrid Scan's lineage filter over hundreds of deleted file ids: the
    NOT IN narrows to a staged program of over 500 instructions, and K1 on
    the card gives the plain version's mask at a ragged and a large
    length, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(31)
    ids = sorted(rng.choice(4000, 300, replace=False).tolist())
    pred = (texpr.col("k") >= 500) & ~texpr.is_in(texpr.col("_data_file_id"), ids)
    reset_launch_counts()
    for n in (4097, 1_000_003):
        arrs = {"_data_file_id": rng.integers(0, 4000, n).astype(np.int64),
                "k": rng.integers(0, 10**6, n).astype(np.int64)}
        narrowed, names, _ = tk.prepare_predicate(pred, arrs)
        assert tk.lowered_predicate(narrowed, names).staged
        want = tk.predicate_mask(pred, arrs, n, device="cpu")
        got = tk.predicate_mask(pred, arrs, n, device="cuda")
        assert np.array_equal(got, want) and 0 < want.sum() < n
    assert launch_counts() == {tk.K1: 2}


# ---------------------------------------------------------------------------
# K1p (packed planes) and K1h (base + delta): plain versions on the CPU
# against the reference's XLA programs, and on a card against the kernels
# ---------------------------------------------------------------------------
def _packed_planes(n, seed, widths=(1, 3, 6, 12, 16)):
    """One plain-packed plane per width (vpw 32, 8, 4, 2, 2), frames with
    negative ``ref0``, plus a raw plane; values are numpy int64."""
    from hyperspace_tpu_torch.ops import bitpack as tb

    rng = np.random.default_rng(seed)
    vals, words, specs = {}, {}, {}
    for b in widths:
        lo = -int(rng.integers(0, 3000))
        v = rng.integers(lo, lo + (1 << b), n).astype(np.int64)
        spec = tb.pack_spec(lo, lo + (1 << b) - 1, n)
        name = f"p{b:02d}"
        vals[name], words[name], specs[name] = v, tb.pack_plain(v, spec), spec
    vals["r"] = rng.integers(-1000, 1000, n).astype(np.int64)
    words["r"], specs["r"] = vals["r"].astype(np.int32), None
    return vals, words, specs


def _packed_preds(m, vals):
    c = m.col
    return [
        (c("p01") == 1) & (c("p06") >= int(np.median(vals["p06"]))),
        # literals below and above every frame
        (c("p03") < -5000) | (c("p12") > 10**6) | (c("p16") == int(vals["p16"][7])),
        m.is_in(c("p06"), [int(x) for x in vals["p06"][:40]]) & ~(c("r") > 0),
        (c("p12") < c("p16")) & (c("r") <= 100) & (c("p03") != int(vals["p03"][0])),
    ]


@pytest.mark.parametrize("i", range(4))
def test_packed_block_counts_plain_version_matches_reference(i):
    """K1p's plain version (``unpack_plain_torch`` then K1c's plain
    version) against the reference's compressed arm of ``_counts_fn``
    (``_flatten_operands`` through ``unpack_plain_jnp``), over a table
    whose rows end mid-word: the pad rows decode to ``ref0`` on both
    sides."""
    from hyperspace_tpu.exec import hbm_cache as jh
    from hyperspace_tpu.ops import bitpack as jb

    n_pad, n_real = 32768, 32768 - 4097
    vals, _w, specs = _packed_planes(n_real, i)
    names = tuple(sorted(vals))
    host, jspecs = {}, {}
    for nm in names:
        s = specs[nm]
        if s is None:
            host[nm] = np.zeros(n_pad, dtype=np.int32)
            host[nm][:n_real] = vals[nm]
            jspecs[nm] = None
            continue
        padded = np.full(n_pad, s.ref0, dtype=np.int64)
        padded[:n_real] = vals[nm]
        specs[nm] = type(s)(s.bits, s.vpw, n_pad, s.ref0)
        jspecs[nm] = jb.pack_spec(s.ref0, s.ref0 + (1 << s.bits) - 1, n_pad)
        host[nm] = jb.pack_plain(padded, jspecs[nm])
    jn = jk.narrow_expr_to_i32(_packed_preds(jexpr, vals)[i])
    tn = tk.narrow_expr_to_i32(_packed_preds(texpr, vals)[i])
    used = tuple(sorted(tn.columns()))
    fn = jh._counts_fn(jn, used, n_pad // jk.LANES, False, tuple(jspecs[u] for u in used))
    with jk._x32():
        want = np.asarray(fn([host[u] if jspecs[u] else host[u].reshape(-1, jk.LANES)
                              for u in used]))
    reset_launch_counts()
    got = tk.predicate_block_counts_packed_tensor(
        tn, used, [torch.from_numpy(host[u]) for u in used], [specs[u] for u in used], n_pad)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert launch_counts() == {}
    # the real rows' matches, from numpy, are all counted
    from hyperspace_tpu.storage.columnar import Column, ColumnarBatch

    batch = ColumnarBatch({k: Column("int64", v) for k, v in vals.items()})
    mask = np.asarray(jexpr.eval_mask(_packed_preds(jexpr, vals)[i], batch))
    assert int(got.sum()) >= int(mask.sum())


def test_packed_program_descriptors_and_checks():
    from hyperspace_tpu_torch.ops import bitpack as tb

    spec = tb.pack_spec(-7, 20, 8192)
    pred = (texpr.col("a") > 3) & (texpr.col("b") < 9)
    prog = tk.packed_program(pred, ("a", "b"), [spec, None])
    assert prog.code[:2].tolist() == [[tk.OP_PACK, 5, 4, -7], [tk.OP_PACK, 0, 1, 0]]
    assert np.array_equal(prog.code[2:], tk.lower_predicate(pred, ("a", "b")))
    assert prog.n_cols == 2 and not prog.staged
    assert tk.packed_program(pred, ("a", "b"), [spec, None]) is prog  # cached
    # 239 instructions fit the parameters, but not with their 2 descriptors
    chain = texpr.is_in(texpr.col("a"), list(range(120)))
    narrowed = tk.narrow_expr_to_i32(chain & (texpr.col("b") < 9))
    assert len(tk.lower_predicate(narrowed, ("a", "b"))) == 241
    assert tk.packed_program(narrowed, ("a", "b"), [spec, None]).staged
    words = torch.from_numpy(tb.pack_plain(np.zeros(8192, dtype=np.int64) - 7, spec))
    raw = torch.zeros(8192, dtype=torch.int32)
    with pytest.raises(HyperspaceException, match="where 2048 belong"):
        tk.predicate_block_counts_packed_tensor(pred, ("a", "b"), [words[:-1], raw],
                                                [spec, None], 8192)
    with pytest.raises(HyperspaceException, match="multiple of 8192"):
        tk.predicate_block_counts_packed_tensor(pred, ("a", "b"), [words, raw],
                                                [spec, None], 4096)
    with pytest.raises(HyperspaceException, match="cannot decode"):
        tk._pack_descriptor(tb.PackSpec(bits=5, vpw=4, n=8192, block=128))
    with pytest.raises(HyperspaceException, match="OP_PACK"):
        tk.K1Program(tk.lower_predicate(pred, ("a", "b")), 2, np.zeros((1, 4), np.int32))


# K1p's launch plan: what it stages a sub-tile at and its shared memory,
# for every mix of widths, 1 to 18 planes, short, staged and 64-slot-deep
# programs
_PLAN_PROGRAMS = {"short": (9, 2), "staged": (599, 2), "deep64": (128, 64)}


def _vpw_mixes(n_cols, seed):
    """Every width alone over ``n_cols`` planes, then random mixes."""
    rng = np.random.default_rng(seed)
    vpws = (1, 2, 4, 8, 16, 32)
    return [[v] * n_cols for v in vpws] + [
        rng.choice(vpws, n_cols).tolist() for _ in range(12)]


@pytest.mark.parametrize("program", sorted(_PLAN_PROGRAMS))
@pytest.mark.parametrize("n_cols", range(1, 19))
def test_k1p_plan_fits_shared_memory_and_copies_in_16_bytes(n_cols, program):
    n_instr, depth = _PLAN_PROGRAMS[program]
    n_instr += n_cols  # the descriptors ride ahead of the program
    for vpws in _vpw_mixes(n_cols, 100 * n_cols + n_instr):
        plan = tk.k1p_plan(vpws, n_instr, depth)
        rest = tk.K1P_SLICE_BYTES * n_cols + tk.k1_smem_bytes(n_instr, depth, tk.K1C_THREADS)
        assert tk.BLOCK_ROWS % plan.sub_rows == 0 and plan.sub_rows in tk.K1P_SUB_ROWS
        assert plan.slice_bytes == tuple(4 * plan.sub_rows // v for v in vpws)
        assert all(b > 0 and b % 16 == 0 for b in plan.slice_bytes), vpws
        assert plan.stage_bytes == sum(plan.slice_bytes)
        assert plan.smem == 2 * plan.stage_bytes + rest <= tk.K1_MAX_SMEM
        # the largest sub-tile whose two stages fit
        bigger = 2 * plan.sub_rows
        assert bigger > tk.BLOCK_ROWS or 2 * 4 * sum(bigger // v for v in vpws) + rest > \
            tk.K1_MAX_SMEM
        assert struct.unpack("<2i", plan.params()) == (plan.sub_rows, plan.stage_bytes)
        # a forced sub-tile is planned where its two stages fit, and raises
        # where they do not
        for rows in tk.K1P_SUB_ROWS:
            ring = 2 * 4 * sum(rows // v for v in vpws)
            if ring + rest <= tk.K1_MAX_SMEM:
                assert rows <= plan.sub_rows
                assert tk.k1p_plan(vpws, n_instr, depth, rows).smem == ring + rest
            else:
                assert rows > plan.sub_rows
                with pytest.raises(HyperspaceException, match="fit no ring"):
                    tk.k1p_plan(vpws, n_instr, depth, rows)


def test_k1p_plan_mirrors_the_kernel_source_and_raises_when_nothing_fits():
    import re

    src = _cu_source()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["MIN_SUB_ROWS"]) == tk.K1P_SUB_ROWS[-1]
    assert int(consts["K1P_STAGES"]) == tk.K1P_STAGES == 2
    assert int(consts["BLOCK_ROWS"]) == tk.BLOCK_ROWS == tk.K1P_SUB_ROWS[0]
    assert re.search(r"static_assert\(sizeof\(Slice\) == (\d+)", src).group(1) == str(
        tk.K1P_SLICE_BYTES)
    fields = re.search(r"struct PackedPlan \{([^}]*)\}", src).group(1)
    assert re.findall(r"int (\w+);", fields) == ["sub_rows", "stage_bytes"]
    # li_st's planes: l_orderkey raw, l_quantity at vpw 4, l_shipdate at 2
    plan = tk.k1p_plan([1, 4, 2], 12, 2)
    assert (plan.sub_rows, plan.stage_bytes) == (8192, 57344)
    assert plan.smem == 2 * 57344 + 3 * 16 + 2 * 1024
    assert tk.k1p_plan([1, 4, 2], 12, 2, 4096).smem == 2 * 28672 + 3 * 16 + 2 * 1024
    # 300 raw planes fit no ring of 128-row sub-tiles
    with pytest.raises(HyperspaceException, match="fit no ring"):
        tk.k1p_plan([1] * 300, 900, 2)
    with pytest.raises(HyperspaceException, match="no sub-tile"):
        tk.k1p_plan([1, 4], 9, 2, 3000)
    # 40 raw planes: two stages of 512 rows fit, of 1024 rows do not
    assert tk.k1p_plan([1] * 40, 49, 2).sub_rows == 512
    with pytest.raises(HyperspaceException, match="fit no ring"):
        tk.k1p_plan([1] * 40, 49, 2, 1024)


def test_program_block_counts_packed_plain_version():
    """The program-level K1p entry on the CPU: a lowered program gives the
    predicate-level counts; a hand-written 64-slot-deep program over packed
    planes gives its postfix interpretation over the decoded planes; a
    program whose descriptors do not match the planes raises."""
    from hyperspace_tpu_torch.ops import bitpack as tb

    n_pad, n_real = 3 * tk.BLOCK_ROWS, 3 * tk.BLOCK_ROWS - 5
    vals, words, specs = _packed_planes(n_real, 9, widths=(3, 12))
    names = tuple(sorted(vals))
    cols, sps = [], []
    for nm in names:
        s = specs[nm]
        if s is None:
            cols.append(torch.from_numpy(np.pad(words[nm], (0, n_pad - n_real))))
        else:
            s = tb.PackSpec(s.bits, s.vpw, n_pad, s.ref0)
            padded = np.full(n_pad, s.ref0, dtype=np.int64)
            padded[:n_real] = vals[nm]
            cols.append(torch.from_numpy(tb.pack_plain(padded, s)))
        sps.append(s)
    narrowed = tk.narrow_expr_to_i32((texpr.col("p03") >= int(vals["p03"][1]))
                                     & (texpr.col("r") < 300) & ~(texpr.col("p12") == 7))
    used = tuple(sorted(narrowed.columns()))
    assert used == names
    program = tk.packed_program(narrowed, names, sps)
    assert torch.equal(tk.program_block_counts_packed_tensor(program, cols, sps, n_pad),
                       tk.predicate_block_counts_packed_tensor(narrowed, names, cols, sps, n_pad))
    deep = tk.K1Program(_deep_program(64, n_cols=3), 3, tk.packed_header(sps))
    assert deep.depth == 64 and deep.plan.sub_rows == 8192
    got = tk.program_block_counts_packed_tensor(deep, cols, sps, n_pad)
    flat = [tb.unpack_plain_torch(c, s) if s is not None else c for c, s in zip(cols, sps)]
    want = tk.run_postfix_reference(deep.prog, flat).view(-1, tk.BLOCK_ROWS).sum(
        1, dtype=torch.int32)
    assert torch.equal(got, want) and 0 < int(got.sum()) < n_pad
    assert torch.equal(got, tk.program_block_counts_packed_reference(deep, cols, sps, n_pad))
    with pytest.raises(HyperspaceException, match="descriptors do not match"):
        tk.program_block_counts_packed_tensor(deep, cols, [None, None, None], n_pad)
    with pytest.raises(HyperspaceException, match="descriptors do not match"):
        tk.program_block_counts_packed_tensor(tk.K1Program(_deep_program(8, n_cols=3), 3),
                                              cols, sps, n_pad)


def test_row_bitmask_layout():
    """Row r = b*8192 + w*1024 + k*128 + l*4 + j is bit 4k + j of word
    b*256 + w*32 + l: the 32 rows K1h's thread w*32 + l owns in block b."""
    rng = np.random.default_rng(5)
    rows = rng.random(3 * tk.BLOCK_ROWS) < 0.4
    words = tk.pack_row_bitmask(rows)
    assert words.dtype == np.int32 and words.shape == (3 * tk.BLOCK_ROWS // 32,)
    u = words.view(np.uint32)
    for r in rng.choice(len(rows), 500, replace=False).tolist() + [0, len(rows) - 1]:
        b, w, k, lane, j = (r // 8192, r % 8192 // 1024, r % 1024 // 128, r % 128 // 4, r % 4)
        bit = (int(u[b * 256 + w * 32 + lane]) >> (4 * k + j)) & 1
        assert bit == int(rows[r]), r
    back = tk.unpack_row_bitmask(torch.from_numpy(words), len(rows)).numpy()
    assert np.array_equal(back, rows)
    with pytest.raises(HyperspaceException, match="multiple of 8192"):
        tk.pack_row_bitmask(rows[:-1])


@pytest.mark.parametrize("has_mask", [False, True])
def test_hybrid_block_counts_plain_version_matches_reference(has_mask):
    """K1h's plain version against the reference's ``_hybrid_counts_fn``
    (base counts with the deleted rows' int32 0/1 plane applied, then the
    delta's, one vector), the mask here one bit a row."""
    from hyperspace_tpu.exec import hbm_cache as jh

    rng = np.random.default_rng(11)
    nb, nd = 3 * 32768, 32768
    names = ("a", "b")
    base = {c: rng.integers(-300, 300, nb).astype(np.int32) for c in names}
    delta = {c: rng.integers(-300, 300, nd).astype(np.int32) for c in names}
    deleted = (rng.random(nb) < 0.25).astype(np.int32)
    for mk in (lambda m: (m.col("a") <= 10) & (m.col("b") > -30),
               lambda m: m.is_in(m.col("a"), [1, 2, 3]) | ~(m.col("b") < 250)):
        jn = jk.narrow_expr_to_i32(mk(jexpr))
        fn = jh._hybrid_counts_fn(jn, names, nb // jk.LANES, nd // jk.LANES, has_mask)
        args = [[base[c].reshape(-1, jk.LANES) for c in names],
                [delta[c].reshape(-1, jk.LANES) for c in names]]
        if has_mask:
            args.append(deleted.reshape(-1, jk.LANES))
        with jk._x32():
            want = np.asarray(fn(*args))
        mask = torch.from_numpy(tk.pack_row_bitmask(deleted)) if has_mask else None
        got = tk.hybrid_block_counts_tensor(
            tk.narrow_expr_to_i32(mk(texpr)), names, [torch.from_numpy(base[c]) for c in names],
            [torch.from_numpy(delta[c]) for c in names], mask)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    with pytest.raises(HyperspaceException, match="deletion mask"):
        tk.hybrid_block_counts_tensor(texpr.col("a") > 0, ("a",), [torch.from_numpy(base["a"])],
                                      [torch.from_numpy(delta["a"])],
                                      torch.zeros(7, dtype=torch.int32))


@pytest.mark.gpu
def test_cuda_packed_and_hybrid_kernels_match_plain_versions():
    """K1p over every width, raw and f64-sized planes mixed, a staged
    program and more columns than the registers hold, a streaming window's
    shape, every sub-tile its plan could choose, 12 raw + 4 packed
    planes and a 64-slot-deep program; K1h with no mask
    and masks of none, all and random rows, deltas of 1 and several
    blocks, and more addresses than the parameters hold: each against its
    plain version on the card, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    reset_launch_counts()
    n = 5 * tk.BLOCK_ROWS
    calls_p = 0
    for bits in range(1, 17):
        vals, words, specs = _packed_planes(n, bits, widths=(bits, 1 + bits % 16, 9, 16))
        names = tuple(sorted(vals))
        for p in _packed_preds_any(texpr, vals, names):
            narrowed = tk.narrow_expr_to_i32(p)
            used = tuple(sorted(narrowed.columns()))
            host = [torch.from_numpy(words[u]) for u in used]
            sp = [specs[u] for u in used]
            want = tk.predicate_block_counts_packed_tensor(narrowed, used, host, sp, n)
            got = tk.predicate_block_counts_packed_tensor(narrowed, used,
                                                          [h.cuda() for h in host], sp, n)
            assert torch.equal(got.cpu(), want), (bits, p)
            calls_p += 1
    calls_p += _cuda_packed_window_and_subtile_cases()
    rng = np.random.default_rng(2)
    calls_h = 0
    for n_cols in (1, 3, 9):
        names = tuple(f"c{i}" for i in range(n_cols))
        pred = texpr.col("c0") < 40
        for nm in names[1:]:
            pred = pred & (texpr.col(nm) > -40)
        for nb, nd in ((3, 1), (2, 4)):
            base = [torch.from_numpy(rng.integers(-99, 99, nb * tk.BLOCK_ROWS).astype(np.int32))
                    for _ in names]
            delta = [torch.from_numpy(rng.integers(-99, 99, nd * tk.BLOCK_ROWS).astype(np.int32))
                     for _ in names]
            for rows in (None, np.zeros(nb * tk.BLOCK_ROWS, bool),
                         np.ones(nb * tk.BLOCK_ROWS, bool), rng.random(nb * tk.BLOCK_ROWS) < 0.3):
                mask = None if rows is None else torch.from_numpy(tk.pack_row_bitmask(rows))
                want = tk.hybrid_block_counts_tensor(pred, names, base, delta, mask)
                got = tk.hybrid_block_counts_tensor(
                    pred, names, [t.cuda() for t in base], [t.cuda() for t in delta],
                    None if mask is None else mask.cuda())
                assert torch.equal(got.cpu(), want), (n_cols, nb, nd)
                calls_h += 1
    assert launch_counts() == {tk.K1P: calls_p, tk.K1H: calls_h}


def _cuda_packed_window_and_subtile_cases():
    """K1p on the card at a streaming window's shape (2^20 rows, 128
    blocks), under every sub-tile a 3-plane table fits,
    over 12 raw + 4 packed planes (a sub-tile plan) and under a 64-slot
    program; each against the plain version. Returns the launches."""
    from hyperspace_tpu_torch.ops import bitpack as tb

    calls = 0

    def on_card(n_pad, widths, n_raw, seed):
        vals, words, specs = _packed_planes(n_pad, seed, widths=widths)
        rng = np.random.default_rng(seed)
        for i in range(1, n_raw):
            vals[f"r{i:02d}"] = rng.integers(-1000, 1000, n_pad).astype(np.int64)
            words[f"r{i:02d}"], specs[f"r{i:02d}"] = vals[f"r{i:02d}"].astype(np.int32), None
        names = tuple(sorted(vals))
        host = [torch.from_numpy(words[nm]) for nm in names]
        return vals, names, host, [h.cuda() for h in host], [specs[nm] for nm in names]

    # a window of li_st's shape: raw, 6 bits at vpw 4, 12 bits at vpw 2
    n = 1 << 20
    vals, names, host, dev, sp = on_card(n, (6, 12), 1, 21)
    pred = tk.narrow_expr_to_i32((texpr.col("r") < 0) & (texpr.col("p06") < int(vals["p06"][0]))
                                 & (texpr.col("p12") >= int(np.median(vals["p12"]))))
    want = tk.predicate_block_counts_packed_tensor(pred, names, host, sp, n)
    assert torch.equal(tk.predicate_block_counts_packed_tensor(pred, names, dev, sp, n).cpu(),
                       want)
    calls += 1
    # every sub-tile over 5 blocks of the same planes, and a hand-written
    # program 64 stack slots deep
    n = 5 * tk.BLOCK_ROWS
    vals, names, host, dev, sp = on_card(n, (6, 12), 1, 22)
    program = tk.packed_program(pred, names, sp)
    want = tk.predicate_block_counts_packed_tensor(pred, names, host, sp, n)
    assert program.plan.sub_rows == tk.BLOCK_ROWS
    for rows in tk.K1P_SUB_ROWS:
        got = tk.program_block_counts_packed_tensor(program, dev, sp, n, rows)
        assert torch.equal(got.cpu(), want), rows
        calls += 1
    deep = tk.K1Program(_deep_program(64, n_cols=3), 3, tk.packed_header(sp))
    assert torch.equal(tk.program_block_counts_packed_tensor(deep, dev, sp, n).cpu(),
                       tk.program_block_counts_packed_tensor(deep, host, sp, n))
    calls += 1
    # 12 raw + 4 packed planes: two stages fit only as sub-tiles
    vals, names, host, dev, sp = on_card(n, (3, 6, 12, 16), 12, 23)
    pred = None
    for nm in names:
        c = texpr.col(nm) >= int(np.percentile(vals[nm], 10))
        pred = c if pred is None else pred & c
    pred = tk.narrow_expr_to_i32(pred)
    assert tk.packed_program(pred, names, sp).plan.sub_rows < tk.BLOCK_ROWS
    assert torch.equal(tk.predicate_block_counts_packed_tensor(pred, names, dev, sp, n).cpu(),
                       tk.predicate_block_counts_packed_tensor(pred, names, host, sp, n))
    assert tb.MAX_PACK_BITS == 16
    return calls + 1


def _packed_preds_any(m, vals, names):
    """Predicates over whatever planes ``_packed_planes`` made."""
    c = m.col
    packed = [nm for nm in names if nm != "r"]
    first, last = packed[0], packed[-1]
    chain = m.is_in(c(first), [int(x) for x in vals[first][:130]])
    return [
        (c(first) >= int(np.median(vals[first]))) & (c("r") < 0),
        (c(last) < -10**6) | (c(last) > 10**6) | (c(first) == int(vals[first][3])),
        chain & (c(last) != int(vals[last][1])),  # over 240 instructions: staged
        # every plane: more columns than K1p holds in registers
        (c(first) < c(last)) & (c("r") > -500) & (c(packed[1]) >= int(vals[packed[1]][5]))
        & (c(packed[2]) != int(vals[packed[2]][2])) & (c(first) != 1),
    ]


# ---------------------------------------------------------------------------
# K2p: K2 over FoR-packed right keys (the resident join regions)
# ---------------------------------------------------------------------------
def _k2p_operands(l, r):
    """K2's plan of (l, r) and K2p's right operands: (s_tile, span, base,
    l_p) as tensors, words, refs, fences, the FoR spec, lo_all and the
    plan's padded raw right keys."""
    from hyperspace_tpu_torch.ops import bitpack as tb

    plan = tk._plan_sorted_intersect(l, r)
    s_tile, span, base, l_p, r_p = plan[:5]
    spec = tb.for_spec(r, block=128)
    words, refs = tk.packed_right_operands(r, spec, len(r_p))
    lo_all = min(int(l.min()), int(r.min()))
    t = [torch.from_numpy(a) for a in (s_tile, span, base, l_p)]
    return (t, torch.from_numpy(words), torch.from_numpy(refs),
            torch.from_numpy(np.ascontiguousarray(r_p[:: tk.K2_FENCE])), spec, lo_all,
            torch.from_numpy(r_p), plan)


@pytest.mark.parametrize("bits", range(1, 17))
def test_unpack_for_torch_matches_unpack_for_jnp(bits):
    """K2p's decode, plain: sorted values whose widest 128-value block
    needs exactly ``bits`` bits, decoded by both packages from the same
    words and refs (the port's words padded past the spec)."""
    from hyperspace_tpu.ops import bitpack as jb

    from hyperspace_tpu_torch.ops import bitpack as tb

    rng = np.random.default_rng(bits)
    n = 128 * 9 + 37
    off = np.sort(rng.integers(0, 1 << bits, (10, 128)), axis=1)
    off[:, 0], off[0, -1] = 0, (1 << bits) - 1
    v = (np.cumsum(off[:, -1] + 3)[:, None] - 40_000 + off).reshape(-1)[:n]
    v = np.sort(v).astype(np.int64)
    js, ts = jb.for_spec(v, block=128), tb.for_spec(v, block=128)
    assert (ts.bits, ts.vpw, ts.n, ts.block) == (js.bits, js.vpw, js.n, js.block)
    assert ts.bits == bits
    words, refs = tb.pack_for(v, ts)
    jw, jr = jb.pack_for(v, js)
    assert np.array_equal(words, jw) and np.array_equal(refs, jr)
    want = np.asarray(jb.unpack_for_jnp(jw, jr, js))
    padded = np.concatenate([words, np.full(5, -1, dtype=np.int32)])
    got = tb.unpack_for_torch(torch.from_numpy(padded), torch.from_numpy(refs), ts)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, v)


@pytest.mark.parametrize("name", [f"vpw_{v}" for v in k2_cases.K2P_BITS])
def test_k2p_plain_version_matches_numpy(name):
    """K2p's plain version (``unpack_for_torch``, narrowed by the plan's
    lo_all, then K2's span semantics) on its edge cases: runs of equal
    keys across a line and across a FoR block, keys on fences, an
    all-pad tail. Real rows equal numpy's searchsorted over the decoded
    keys; every padded row equals K2's span semantics over the raw keys;
    the CPU wrapper takes the plain version and launches nothing."""
    l, r = k2_cases.k2p_edge_cases(0)[name]
    (t, words, refs, fences, spec, lo_all, r_p, plan) = _k2p_operands(l, r)
    assert spec.vpw == int(name.split("_")[1]) and not plan[-1].any()
    reset_launch_counts()
    lt, eq = tk.sorted_intersect_packed_tensors(*t, words, refs, fences, spec, lo_all,
                                                groups=_k2p_groups(plan, spec))
    assert launch_counts() == {}
    n = len(l)
    want_lt = np.searchsorted(r, l, side="left")
    assert np.array_equal(lt[:n].numpy(), want_lt)
    assert np.array_equal(eq[:n].numpy(), np.searchsorted(r, l, side="right") - want_lt)
    s_lt, s_eq = tk.sorted_intersect_span_reference(*t, r_p)
    assert torch.equal(lt, s_lt) and torch.equal(eq, s_eq)


def test_k2p_plain_version_on_the_index_layout_with_wide_tiles():
    """The resident region's shape: left keys in bucket layout (tiles that
    straddle buckets are wide), right keys sorted globally. K2p's plain
    version equals K2's on every padded row, wide tiles as their base."""
    l, r = _clustered(40_000, 100_000, 4, 5)
    r = np.sort(np.concatenate([r, r[::7]]))  # duplicate right keys
    (t, words, refs, fences, spec, lo_all, r_p, plan) = _k2p_operands(l, r)
    assert plan[-1].any() and spec is not None
    groups = _k2p_groups(plan, spec)
    lt, eq = tk.sorted_intersect_packed_tensors(*t, words, refs, fences, spec, lo_all,
                                                groups=groups)
    s_lt, s_eq = tk.sorted_intersect_span_reference(*t, r_p)
    assert torch.equal(lt, s_lt) and torch.equal(eq, s_eq)
    with pytest.raises(HyperspaceException, match="do not cover"):
        tk.sorted_intersect_packed_tensors(*t, words, refs[:1], fences, spec, lo_all,
                                           groups=groups)


def _k2p_groups(plan, spec, target=tk.K2P_GROUPS_PER_SM * tk.H100_SMS, capacity=None):
    return tk.plan_k2p_groups(plan[0], plan[1], spec.vpw, target, capacity=capacity)


@functools.lru_cache(maxsize=None)
def _k2p_plan_source(source):
    """A K2 host plan the group plan is cut from: the region's index
    layout at a small size, tiles spanning the 64-tile cap, or skewed keys
    (a hot key range most tiles fall in)."""
    if source in ("index_layout", "span_64"):
        l, r = k2_cases.k2p_region_cases(0)["index_vpw2" if source == "index_layout" else
                                            "span_cap"]
    else:
        rng = np.random.default_rng(11)
        r = np.sort(rng.choice(np.arange(2_000_000, dtype=np.int64), 120_000, replace=False))
        l = np.concatenate([rng.choice(r[40_000:52_000], 150_000), rng.choice(r, 30_000)])
        l = l[np.lexsort((l, (l * 2654435761) % 24))]
    plan = tk._plan_sorted_intersect(l, r)
    assert plan is not None
    return plan


@pytest.mark.parametrize("source", ["index_layout", "skewed", "span_64"])
@pytest.mark.parametrize("vpw", [2, 4, 8, 16, 32])
def test_k2p_group_plan_covers_every_tile_in_windows_that_fit(source, vpw):
    """``plan_k2p_groups`` over K2's host plans at every vpw: each tile in
    exactly one group, each active tile's span inside its group's window,
    every window within what a CTA's shared memory holds at that vpw
    (the capacity mirrored from the kernel source), span-0 and wide tiles
    spread over the groups after each group's own tiles, never widening a
    window; a forced minimal capacity (the plan's
    largest span) gives at least as many groups, more where a window was
    wider, and still covers everything."""
    s_tile, span = _k2p_plan_source(source)[:2]
    cap = tk.k2p_window_capacity(vpw)
    for target in (1, 7, 132):
        g = tk.plan_k2p_groups(s_tile, span, vpw, target)
        assert g.vpw == vpw and g.n_tiles == len(span)
        for a in g.arrays():
            assert a.dtype == np.int32
        assert np.array_equal(np.sort(g.order), np.arange(len(span)))
        sizes = np.diff(g.offsets)
        assert g.offsets[0] == 0 and g.offsets[-1] == len(span) and (sizes > 0).all()
        grp = np.repeat(np.arange(g.n_groups), sizes)
        st, sp = s_tile[g.order], span[g.order]
        lo, ln = g.win_lo[grp], g.win_len[grp]
        act = sp > 0
        per = -(-int(act.sum()) // target)
        assert np.bincount(grp[act], minlength=g.n_groups).max() <= per
        assert g.n_groups == len(np.unique(grp[act]))  # idle tiles add no group
        assert ((st >= lo) & (st + sp <= lo + ln))[act].all() and (ln[act] > 0).all()
        # each group's span-0 tiles come after its tiles with a span, spread evenly
        for k in range(g.n_groups):
            a = act[g.offsets[k]:g.offsets[k + 1]]
            assert not (a[1:] & ~a[:-1]).any()
        n_idle = np.bincount(grp[~act], minlength=g.n_groups)
        assert n_idle.max() - n_idle.min() <= 1
        assert g.max_window == int(g.win_len.max()) <= cap
        assert g.smem_bytes <= tk.K2P_SMEM_MAX
        # a window is the union of its tiles' spans, no wider
        for k in range(g.n_groups):
            a = slice(g.offsets[k], g.offsets[k + 1])
            if act[a].any():
                assert g.win_lo[k] == st[a][act[a]].min()
                assert g.win_lo[k] + g.win_len[k] == (st[a] + sp[a])[act[a]].max()
        tight = tk.plan_k2p_groups(s_tile, span, vpw, target, capacity=int(span.max()))
        assert tight.n_groups >= g.n_groups and tight.max_window <= int(span.max())
        if g.max_window > int(span.max()):
            assert tight.n_groups > g.n_groups
        assert np.array_equal(np.sort(tight.order), np.arange(len(span)))
    with pytest.raises(HyperspaceException, match="a window holds"):
        tk.plan_k2p_groups(s_tile, span, vpw, capacity=int(span.max()) - 1)
    with pytest.raises(HyperspaceException, match="does not fit"):
        tk.plan_k2p_groups(s_tile, span, vpw, capacity=cap + 1)


def test_k2p_window_constants_match_the_kernel_source():
    """K2p's CTA, FoR block and shared-memory sizes are the kernel
    source's, and so is the bytes a window tile takes; a window of the
    plan's 64-tile span cap fits at vpw 2 (the widest packing), where raw
    right keys would not."""
    import re
    from pathlib import Path

    src = (Path(tk.__file__).resolve().parent.parent / "csrc" / "sorted_intersect.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["K2P_THREADS"] == tk.K2P_THREADS
    assert consts["FOR_BLOCK"] == tk.K2P_FOR_BLOCK
    assert consts["K2P_SMEM_MAX"] == tk.K2P_SMEM_MAX
    assert consts["K2P_SMEM_FIXED"] == tk.K2P_SMEM_FIXED
    assert "return 4 * (TILE / vpw + TILE / FENCE + TILE / FOR_BLOCK);" in src
    assert [tk.k2p_tile_bytes(v) for v in (2, 4, 8, 16, 32)] == [2592, 1568, 1056, 800, 672]
    assert tk.k2p_window_capacity(2) >= tk.SMJ_MAX_SPAN_TILES
    raw_tile = 4 * (tk.SMJ_TILE + tk.SMJ_TILE // tk.K2_FENCE)
    assert tk.K2P_SMEM_FIXED + tk.SMJ_MAX_SPAN_TILES * raw_tile > tk.K2P_SMEM_MAX


def test_k2p_wrapper_raises_on_a_group_plan_that_is_not_its_own():
    """The wrapper takes the group plan as given and checks it: a window
    past a CTA's shared memory, another vpw's plan, another plan's tiles
    or windows past the right side raise, on the CPU as on the card."""
    import dataclasses

    l, r = k2_cases.k2p_region_cases(0)["span_cap"]
    (t, words, refs, fences, spec, lo_all, _r_p, plan) = _k2p_operands(l, r)
    g = _k2p_groups(plan, spec, 4)
    cap = tk.k2p_window_capacity(spec.vpw)
    bad = dataclasses.replace(g, max_window=cap + 1)
    with pytest.raises(HyperspaceException, match="shared memory"):
        tk.sorted_intersect_packed_tensors(*t, words, refs, fences, spec, lo_all, groups=bad)
    for bad in (tk.plan_k2p_groups(plan[0], plan[1], 2 * spec.vpw),
                tk.plan_k2p_groups(plan[0][:-1], plan[1][:-1], spec.vpw),
                dataclasses.replace(g, window_end=len(fences) // 128 + 1)):
        with pytest.raises(HyperspaceException, match="not this launch's"):
            tk.sorted_intersect_packed_tensors(*t, words, refs, fences, spec, lo_all,
                                               groups=bad)


@pytest.mark.parametrize("name", list(k2_cases.K2P_REGION_VPW))
def test_k2p_region_cases_plain_version(name):
    """K2p's region cases (``k2_cases.k2p_region_cases``) through the CPU
    wrapper under three group plans (the default target, a target of 4,
    the forced minimal capacity): real rows of tiles the plan does not
    mark wide equal numpy's searchsorted, every padded row equals K2's
    span semantics over the raw keys, span-0 and wide tiles keep base and
    0. The plain version ignores the groups: what this holds is the case,
    for the card test and ``chip_smoke.py`` to hold the kernel to."""
    l, r = k2_cases.k2p_region_cases(0)[name]
    (t, words, refs, fences, spec, lo_all, r_p, plan) = _k2p_operands(l, r)
    assert spec.vpw == k2_cases.K2P_REGION_VPW[name]
    n = len(l)
    keep = ~np.repeat(plan[-1], tk.SMJ_TILE)[:n]
    want_lt = np.searchsorted(r, l, side="left")
    want_eq = np.searchsorted(r, l, side="right") - want_lt
    s_lt, s_eq = tk.sorted_intersect_span_reference(*t, r_p)
    idle = np.repeat(plan[1] == 0, tk.SMJ_TILE)
    for groups in (_k2p_groups(plan, spec), _k2p_groups(plan, spec, 4),
                   _k2p_groups(plan, spec, 4, capacity=int(plan[1].max()))):
        lt, eq = tk.sorted_intersect_packed_tensors(*t, words, refs, fences, spec, lo_all,
                                                    groups=groups)
        assert np.array_equal(lt[:n].numpy()[keep], want_lt[keep])
        assert np.array_equal(eq[:n].numpy()[keep], want_eq[keep])
        assert torch.equal(lt, s_lt) and torch.equal(eq, s_eq)
        assert np.array_equal(lt.numpy()[idle], np.repeat(plan[2], tk.SMJ_TILE)[idle])
        assert not eq.numpy()[idle].any()
    if name == "wide_and_idle":
        assert plan[-1].sum() == 3 and (plan[1] == 0).sum() == 7
    if name == "span_cap":
        assert int(plan[1].max()) == tk.SMJ_MAX_SPAN_TILES
    if name == "ragged":
        assert len(r) % tk.K2_FENCE and len(r) % tk.SMJ_TILE and n % tk.SMJ_TILE


def _k2p_cuda_inputs():
    """The card test's inputs: K2p's edge cases at every vpw, the index
    layout with wide tiles and duplicate right keys, and the region cases;
    each with its group plans (the default target, then for the region
    cases a target of 4 and the forced minimal capacity)."""
    inputs = [(l, r, (None,)) for l, r in k2_cases.k2p_edge_cases(0).values()]
    l, r = _clustered(300_000, 90_000, 16, 7)
    inputs.append((l, np.sort(np.concatenate([r, r[::5]])), (None,)))
    for l, r in k2_cases.k2p_region_cases(0).values():
        inputs.append((l, r, (None, 4, "tight")))
    return inputs


@pytest.mark.gpu
def test_cuda_k2p_matches_plain_version():
    """K2p on the card against its plain version on every padded row: the
    edge cases at every vpw, the index layout with wide tiles and the
    region cases under three group plans (the default target, a target of
    4, the forced minimal capacity), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    reset_launch_counts()
    launches = 0
    for l, r, plans in _k2p_cuda_inputs():
        (t, words, refs, fences, spec, lo_all, _r_p, plan) = _k2p_operands(l, r)
        for how in plans:
            groups = (_k2p_groups(plan, spec) if how is None else
                      _k2p_groups(plan, spec, 4, capacity=int(plan[1].max()))
                      if how == "tight" else _k2p_groups(plan, spec, how))
            want = tk.sorted_intersect_packed_tensors(*t, words, refs, fences, spec, lo_all,
                                                      groups=groups)
            got = tk.sorted_intersect_packed_tensors(*(x.cuda() for x in t), words.cuda(),
                                                     refs.cuda(), fences.cuda(), spec, lo_all,
                                                     groups=groups.to("cuda"))
            launches += 1
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), \
                (spec.vpw, len(l), how)
    assert launch_counts() == {tk.K2P: launches}
