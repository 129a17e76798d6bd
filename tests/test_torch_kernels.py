"""Kernel parity: the port's K1 (predicate mask) and K2 (sorted-intersect)
wrappers on the CPU — where they run the kernels' plain torch versions —
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs. Also K1c's plain version against the reference's fused
mask + block count, the f64 two-plane expansion, the resident entry
points (``resident_mask_fn``, ``resident_sorted_intersect``,
``resident_smj_amortized``, ``resident_fused_agg_over_join``) and their
declines, the postfix lowering K1's CUDA kernel interprets, the join span
planning, and the CUDA kernels themselves on a card (marked ``gpu``;
skipped without one). Tolerance: exact throughout.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops import kernels as jk
from hyperspace_tpu.plan import expr as jexpr

from hyperspace_tpu_torch.exceptions import HyperspaceException
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
    assert metrics.get(f"fused_agg.path.{arm}") == 1
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
    assert launch_counts() == {tk.K1: 6 + n_masks, tk.K2: 1, tk.K1C: 2 + n_counts}
