"""Kernel parity: the port's K1 (predicate mask) and K2 (sorted-intersect)
wrappers on the CPU — where they run the kernels' plain torch versions —
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs. Also the postfix lowering K1's CUDA kernel interprets, the
join span planning, and the CUDA kernels themselves on a card (marked
``gpu``; skipped without one). Tolerance: exact throughout.
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
    assert launch_counts() == {tk.K1: 6, tk.K2: 1}
