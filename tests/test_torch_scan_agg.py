"""Parity of the port's device programs of the serving layer with the JAX
package's, on the CPU: the device aggregate over one resident table
(``exec/scan_agg.py`` through ``hbm_cache.agg_scan``: its plan and
declines, its groups) and the batched counts (``block_counts_batch`` on
raw and packed planes, ``hybrid_block_counts_batch``,
``stream_block_counts_batch``) against the reference's
``_batched_counts_fn`` / ``_hybrid_batched_counts_fn`` programs, on the
same numpy-made TCB files. The port runs the plain versions of K1, K1b
and K1hb here (``gpu``-marked tests hold the kernels on a card). Mirrors
``tests/test_device_agg.py`` and the batched-count cases of
``tests/test_serve.py``. Tolerance: counts, group sets and integer
aggregates exact; float64 aggregates ``rtol=1e-9`` (the device sums in
another order).
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.exec import hbm_cache as jh
from hyperspace_tpu.plan import aggregates as jagg
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.residency import knobs as jknobs
from hyperspace_tpu.storage import layout
from hyperspace_tpu.storage.columnar import Column, ColumnarBatch

from hyperspace_tpu_torch.config import ResidencyConf
from hyperspace_tpu_torch.exec import hbm_cache as th
from hyperspace_tpu_torch.exec import scan_agg as tsa
from hyperspace_tpu_torch.ops import k1b_cases
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.plan import aggregates as tagg
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

FORCE = ResidencyConf(mode="force", min_rows=1, max_block_frac=1.0)
EXPR = {"jax": jexpr, "torch": texpr}
AGG = {"jax": jagg, "torch": tagg}


@pytest.fixture(autouse=True)
def _force_residency(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MIN_ROWS", "1")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MAX_BLOCK_FRAC", "1.0")
    monkeypatch.setenv("HYPERSPACE_TPU_KERNELS", "interpret")
    for var in ("HYPERSPACE_TPU_RESIDENCY_COMPRESSION", "HYPERSPACE_TPU_HBM_BUDGET_MB",
                "HYPERSPACE_TPU_RESIDENCY_STREAMING", "HYPERSPACE_TPU_RESIDENCY_WINDOW_ROWS"):
        monkeypatch.delenv(var, raising=False)
    jknobs.reset_conf_defaults()
    jh.hbm_cache.reset()
    th.hbm_cache.reset()
    yield
    jh.hbm_cache.reset()
    th.hbm_cache.reset()
    jknobs.reset_conf_defaults()


def _files(tmp_path, n_files=3, rows=6000, seed=0):
    """Key-sorted TCB files with every resident encoding: int64 (sums past
    2^31), a dense int group key, float32, float64 and a string column
    with per-file dictionaries and NULLs."""
    rng = np.random.default_rng(seed)
    words = [np.array([b"aa", b"bb", b"cc"], dtype=object),
             np.array([b"bb", b"dd", b"ee"], dtype=object),
             np.array([b"aa", b"ff"], dtype=object)]
    paths = []
    for i in range(n_files):
        codes = rng.integers(0, len(words[i % 3]), rows).astype(np.int32)
        codes[::7] = -1
        cols = {
            "k": Column("int64", np.sort(rng.integers(i * 10_000, (i + 1) * 10_000, rows))),
            "v": Column("int64", rng.integers(-(1 << 30), 1 << 30, rows)),
            "g": Column("int64", rng.integers(0, 40, rows)),
            "f": Column("float32", rng.uniform(-5.0, 5.0, rows).astype(np.float32)),
            "d": Column("float64", np.round(rng.uniform(0.0, 100.0, rows), 3)),
            "s": Column("string", codes, words[i % 3]),
            "w": Column("int64", rng.integers(0, 1 << 40, rows)),
        }
        p = tmp_path / f"b{i:05d}-cafe{i:04x}.tcb"
        layout.write_batch(p, ColumnarBatch(cols), sorted_by=["k"], bucket=i)
        paths.append(p)
    return paths


def _tables(paths, columns, conf=FORCE):
    jt = jh.hbm_cache.prefetch(paths, columns)
    tt = th.hbm_cache.prefetch(paths, columns, device="cpu", conf=conf)
    assert jt is not None and tt is not None
    return jt, tt


def assert_groups(got, exp):
    """Group tables equal: names, dtypes, rows in ascending key order;
    float64 to rtol 1e-9, everything else exact (strings by value)."""
    assert got.column_names == exp.column_names
    assert got.num_rows == exp.num_rows
    for n in exp.column_names:
        g, e = got.columns[n], exp.columns[n]
        assert g.dtype_str == e.dtype_str, n
        gv, ev = g.to_values(), e.to_values()
        if e.data.dtype.kind == "f":
            np.testing.assert_allclose(gv.astype(np.float64), ev.astype(np.float64),
                                       rtol=1e-9, equal_nan=True, err_msg=n)
        else:
            assert [repr(x) for x in gv] == [repr(x) for x in ev], n


ALL_FNS = lambda m: [  # noqa: E731
    m.agg_sum("v", "sv"), m.agg_count(), m.agg_count("f", "cf"), m.agg_min("v", "mv"),
    m.agg_max("v", "xv"), m.agg_min("f", "mf"), m.agg_max("d", "xd"), m.agg_avg("d", "ad"),
    m.agg_sum("f", "sf"), m.agg_min("s", "ms"), m.agg_max("s", "xs"), m.agg_count("s", "cs")]


@pytest.mark.parametrize("group", ["g", "s", "k"])
def test_device_agg_groups_equal_the_reference(tmp_path, group):
    """Every function over every encoding, grouped by a dense int key, by
    a string key (NULL its own group), and by the sort key (a span of
    30,000 slots): groups, order and values as the reference's device
    aggregate computes them."""
    jt, tt = _tables(_files(tmp_path), ["k", "v", "g", "f", "d", "s"])
    out = {}
    for pkg, t, cache in (("jax", jt, jh.hbm_cache), ("torch", tt, th.hbm_cache)):
        m = EXPR[pkg]
        pred = (m.col("k") >= 3000) & (m.col("v") != 17)
        out[pkg] = cache.agg_scan(t, pred, [group], ALL_FNS(AGG[pkg]))
    assert out["torch"][1] == out["jax"][1] == "ok"
    assert_groups(out["torch"][0], out["jax"][0])
    assert out["torch"][0].num_rows > 2


def test_device_agg_over_compressed_planes(tmp_path, monkeypatch):
    """The compressed tier: packed group and value planes decode on the
    way in (the reference's fused decode); groups equal."""
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_COMPRESSION", "force")
    jknobs.reset_conf_defaults()
    paths = _files(tmp_path)
    jt, tt = _tables(paths, ["k", "v", "g", "s"],
                     ResidencyConf(mode="force", min_rows=1, compression="force"))
    assert jt.tier == tt.tier == "compressed" and tt.columns["g"].pack is not None
    got = th.hbm_cache.agg_scan(tt, texpr.col("g") < 30, ["g"],
                                [tagg.agg_sum("v"), tagg.agg_min("g", "mg"), tagg.agg_count()])
    exp = jh.hbm_cache.agg_scan(jt, jexpr.col("g") < 30, ["g"],
                                [jagg.agg_sum("v"), jagg.agg_min("g", "mg"), jagg.agg_count()])
    assert got[1] == exp[1] == "ok"
    assert_groups(got[0], exp[0])


DECLINES = {  # name: (group_by, aggs as a function of the aggregates module)
    "multi_key": (["g", "k"], lambda m: [m.agg_count()]),
    "float_key": (["d"], lambda m: [m.agg_count()]),
    "unresident_key": (["w"], lambda m: [m.agg_count()]),
    "unresident_value": (["g"], lambda m: [m.agg_sum("w")]),
    "string_sum": (["g"], lambda m: [m.agg_sum("s")]),
    "wide_span": (["v"], lambda m: [m.agg_count()]),
}


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_scan_agg_plan_declines_as_the_reference(tmp_path, case):
    """``scan_agg_plan``'s reasons (shape, dtype, column, span) on the same
    table, and ``agg_scan`` returning them without a launch."""
    from hyperspace_tpu.exec import scan_agg as jsa

    jt, tt = _tables(_files(tmp_path), ["k", "v", "g", "d", "s"])
    group_by, aggs = DECLINES[case]
    jplan, jreason = jsa.scan_agg_plan(jt, group_by, aggs(jagg))
    tplan, treason = tsa.scan_agg_plan(tt, group_by, aggs(tagg))
    assert jplan is None and tplan is None and treason == jreason
    got = th.hbm_cache.agg_scan(tt, texpr.col("k") > 0, group_by, aggs(tagg))
    assert got == (None, jreason)


def test_scan_agg_plan_matches_the_reference(tmp_path):
    """An accepted plan: group offset, span and the per-column ops."""
    from hyperspace_tpu.exec import scan_agg as jsa

    jt, tt = _tables(_files(tmp_path), ["k", "v", "g", "f", "d", "s"])
    jp, _ = jsa.scan_agg_plan(jt, ["s"], ALL_FNS(jagg))
    tp, _ = tsa.scan_agg_plan(tt, ["s"], ALL_FNS(tagg))
    assert (tp.group, tp.group_enc, tp.mn, tp.span) == (jp.group, jp.group_enc, jp.mn, jp.span)
    assert [(c.name, c.enc, c.arity, c.ops) for c in tp.cols] == \
        [(c.name, c.enc, c.arity, c.ops) for c in jp.cols]
    assert tsa.plan_plane_names(tp) == jsa.plan_plane_names(jp)


def _preds(m, rng, n):
    """N predicates of different structures and depths over k, g, f, d, s."""
    out = []
    for i in range(n):
        lo = int(rng.integers(0, 25_000))
        shape = i % 4
        if shape == 0:
            p = m.col("k") == int(rng.integers(0, 30_000))
        elif shape == 1:
            p = (m.col("k") >= lo) & (m.col("k") < lo + 3000) & (m.col("g") != i % 40)
        elif shape == 2:
            p = ((m.col("d") > float(rng.uniform(0, 90))) | (m.col("f") < -4.5)) & \
                (m.col("k") < lo + 9000)
        else:
            p = m.is_in(m.col("g"), [1, 2, i % 40]) & (m.col("s") >= "bb")
        out.append(p)
    return out


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "packed"])
def test_block_counts_batch_matches_batched_counts_fn(tmp_path, monkeypatch, compressed):
    """The (N, n_blocks) matrix of N predicates of mixed structure and
    depth, over raw, packed and f64 planes: the reference's one batched
    program against K1b's plain version, counted under serve.batch.*; and
    N = 1, the compiled pipelines' single (K1c/K1p), under compile.fused.*."""
    conf = FORCE
    if compressed:
        monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_COMPRESSION", "force")
        jknobs.reset_conf_defaults()
        conf = ResidencyConf(mode="force", min_rows=1, max_block_frac=1.0, compression="force")
    jt, tt = _tables(_files(tmp_path), ["k", "g", "f", "d", "s"], conf)
    assert tt.tier == ("compressed" if compressed else "resident")
    preds = {pkg: _preds(EXPR[pkg], np.random.default_rng(3), 9) for pkg in EXPR}
    tmetrics.reset()
    got = th.hbm_cache.block_counts_batch(tt, preds["torch"])
    exp = jh.hbm_cache.block_counts_batch(jt, preds["jax"])
    assert got.shape == exp.shape and np.array_equal(got, exp)
    assert (tmetrics.get("serve.batch.dispatches"), tmetrics.get("serve.batch.queries")) == (1, 9)
    one = th.hbm_cache.block_counts_batch(tt, preds["torch"][1:2], metric_ns="compile.fused")
    assert np.array_equal(one, exp[1:2])
    assert tmetrics.get("compile.fused.dispatches") == 1
    assert np.array_equal(one[0], th.hbm_cache.block_counts(tt, preds["torch"][1]))


def test_block_counts_batch_declines_as_the_reference(tmp_path):
    """A predicate that does not narrow to the resident encodings (a
    column not resident) declines the whole batch in both packages."""
    jt, tt = _tables(_files(tmp_path), ["k", "g"])
    assert th.hbm_cache.block_counts_batch(
        tt, [texpr.col("k") > 3, texpr.col("v") > 0]) is None
    assert jh.hbm_cache.block_counts_batch(
        jt, [jexpr.col("k") > 3, jexpr.col("v") > 0]) is None


def test_stream_block_counts_batch_window_by_window(tmp_path):
    """A streaming table (raw planes over the budget, compression off):
    the batch goes window by window, one K1b launch a window, and the
    matrix equals the reference's resident batched counts."""
    paths = _files(tmp_path, n_files=2, rows=70_000)
    jt = jh.hbm_cache.prefetch(paths, ["k", "g"])
    conf = ResidencyConf(mode="force", min_rows=1, budget_mb=1, compression="off",
                         window_rows=16_384)
    tt = th.hbm_cache.prefetch(paths, ["k", "g"], device="cpu", conf=conf)
    assert tt.tier == "streaming" and tt.n_windows == 9 and tt.window_gen == 0
    preds = {pkg: _preds(EXPR[pkg], np.random.default_rng(5), 4)[:2] + [EXPR[pkg].col("g") == 7]
             for pkg in EXPR}
    tmetrics.reset()
    got = th.hbm_cache.block_counts_batch(tt, preds["torch"])
    assert np.array_equal(got, jh.hbm_cache.block_counts_batch(jt, preds["jax"]))
    assert tmetrics.get("residency.stream.windows") == 9
    assert tmetrics.get("serve.batch.dispatches") == 1


def _hybrid_planes(rng, names, nb, nd_real):
    B = tk.BLOCK_ROWS
    base = [torch.from_numpy(rng.integers(-99, 99, nb * B).astype(np.int32)) for _ in names]
    delta = [torch.zeros(-(-nd_real // B) * B, dtype=torch.int32) for _ in names]
    for t in delta:
        t[:nd_real] = torch.from_numpy(rng.integers(-99, 99, nd_real).astype(np.int32))
    return base, delta


@pytest.mark.parametrize("mask", ["none", "all", "random"])
def test_hybrid_batch_matches_hybrid_batched_counts_fn(mask):
    """K1hb's plain version against the reference's batched hybrid program
    over the same base and delta planes and deletion rows: N predicates
    of different depths, (N, base + delta blocks)."""
    from hyperspace_tpu.exec.hbm_cache import _expr_literals, _expr_structure, \
        _hybrid_batched_counts_fn

    rng = np.random.default_rng(11)
    names = ("a", "b", "c")
    base, delta = _hybrid_planes(rng, names, 3, 9000)
    rows = {"none": np.zeros(3 * tk.BLOCK_ROWS, bool), "all": np.ones(3 * tk.BLOCK_ROWS, bool),
            "random": rng.random(3 * tk.BLOCK_ROWS) < 0.3}[mask]
    words = torch.from_numpy(tk.pack_row_bitmask(rows))
    preds = {}
    for pkg, m in EXPR.items():
        preds[pkg] = [m.col("a") < 40, (m.col("a") > -10) & (m.col("b") < 5),
                      ((m.col("a") > 0) | (m.col("c") == 3)) & ~(m.col("b") == 1)]
    prepared = [(tk.narrow_expr_to_i32(p), tuple(sorted(p.columns()))) for p in preds["torch"]]
    got = tk.hybrid_block_counts_batch_tensor(prepared, names, base, delta, words).numpy()
    jprep = [(p, tuple(sorted(p.columns()))) for p in preds["jax"]]
    fn = _hybrid_batched_counts_fn(
        tuple(_expr_structure(n) for n, _ in jprep), tuple(nm for _, nm in jprep),
        [n for n, _ in jprep], 3 * tk.BLOCK_ROWS // 128, delta[0].numel() // 128, True)
    lits = []
    for n, _ in jprep:
        vals: list = []
        _expr_literals(n, vals)
        lits.append(np.asarray(vals, dtype=np.int32))
    cols_b = {n: t.numpy() for n, t in zip(names, base)}
    cols_d = {n: t.numpy() for n, t in zip(names, delta)}
    exp = np.asarray(fn(cols_b, cols_d, tuple(lits), rows.astype(np.int32)))
    assert np.array_equal(got, exp)


def test_k1b_programs_of_many_depths_and_wide_batches():
    """K1b's program-level entry over N = 1, 2 and 100 programs of
    different depths over a raw and a packed plane equals its single plain
    versions, row by row; the launch plan fits 300 programs of 13
    instructions beside the deepest stack in two CTAs an SM, their blob
    staged, the two blocks cut into 2048-row sub-tiles."""
    from hyperspace_tpu_torch.ops import bitpack

    rng = np.random.default_rng(2)
    n = 2 * tk.BLOCK_ROWS
    raw = rng.integers(-1000, 1000, n).astype(np.int32)
    spec = bitpack.pack_spec(3, 59, n)
    cols = [torch.from_numpy(raw),
            torch.from_numpy(bitpack.pack_plain(rng.integers(3, 60, n), spec))]
    specs = [None, spec]
    progs = []
    for i in range(100):
        e = texpr.col("r") < int(rng.integers(-1000, 1000))
        for _ in range(i % 6):
            e = (e | (texpr.col("q") == int(rng.integers(3, 60)))) & (texpr.col("r") != i)
        progs.append(tk.lower_predicate(tk.narrow_expr_to_i32(e), ("r", "q")))
    wide = tk.program_block_counts_batch_tensor(progs, cols, specs, n)
    for N in (1, 2):
        assert torch.equal(tk.program_block_counts_batch_tensor(progs[:N], cols, specs, n),
                           wide[:N])
    for i in (0, 5, 99):
        want = tk.program_block_counts_packed_reference(
            tk.K1Program(progs[i], 2, tk.packed_header(specs)), cols, specs, n)
        assert torch.equal(wide[i], want)
    plan = tk.k1b_plan([1, spec.vpw], 300, 7, 300 * 13, n // tk.BLOCK_ROWS)
    assert plan.staged and plan.sub_rows == 2048 and plan.smem <= tk.K1B_CTA_SMEM


_CMP = (lambda x, y: x == y, lambda x, y: x != y, lambda x, y: x < y, lambda x, y: x <= y,
        lambda x, y: x > y, lambda x, y: x >= y)


def _range_test_preds(m, names, lits):
    """One package's predicates over the range-test planes ``names``:
    every compare of the first and last plane at ``lits`` (chunk minima and
    maxima and one past each, the int32 extremes' neighbours), column
    compares and mixes of NOT, AND and OR."""
    a, b, c = m.col(names[0]), m.col(names[1]), m.col(names[-1])
    out = []
    for i, x in enumerate(lits):
        out += [_CMP[i % 6](a, x), _CMP[(i + 3) % 6](c, x)]
    return out + [a < c, c != c, b >= a, ~((a < lits[2]) & (b == lits[1])),
                  ((a >= lits[1]) & (a < lits[-2])) | (b != lits[0]), ~(c == lits[3]) & (a > lits[4])]


@pytest.mark.parametrize("case", ["raw", "packed"] + [f"hybrid_{d}" for d in k1b_cases.DELETIONS])
def test_batched_counts_on_range_test_data_match_the_reference(case):
    """K1b's and K1hb's plain versions against the reference's
    ``_batched_counts_fn`` / ``_hybrid_batched_counts_fn`` on the planes the
    card test aims at the kernels' range test (``ops/k1b_cases.py``:
    constant chunks, chunk-edge literals, int32 extremes in the data, pad
    rows, packed widths 1-16 with ref0 below zero, deletions of whole and
    partial chunks)."""
    from hyperspace_tpu.exec.hbm_cache import (_batched_counts_fn, _expr_literals,
                                               _expr_structure, _hybrid_batched_counts_fn)
    from hyperspace_tpu.ops import bitpack as jbitpack

    cases = k1b_cases.k1b_range_cases(0)
    n = k1b_cases.N_BLOCKS * tk.BLOCK_ROWS
    if case == "packed":
        c = cases["packed"]
        names = tuple(f"p{b:02d}" for b in range(1, 17))
        pick = (0, 6, 15)  # widths 1, 7 (sorted) and 16 (random)
        lits = [x for i in pick for x in (c["specs"][i].ref0, c["specs"][i].ref0 - 1,
                                          c["specs"][i].ref0 + (1 << (i + 1)) - 1,
                                          c["specs"][i].ref0 + (1 << (i + 1)))]
        used = tuple(names[i] for i in pick)
    else:
        c = cases["raw"]
        names = used = ("a", "b", "c")
        lits = [x for x in k1b_cases._edge_literals(c["values"][0])
                if k1b_cases.I32_MIN < x < k1b_cases.I32_MAX]
    preds = {pkg: _range_test_preds(m, used, lits) for pkg, m in EXPR.items()}
    prepared = [(tk.narrow_expr_to_i32(p), tuple(sorted(p.columns()))) for p in preds["torch"]]
    assert all(b is not None for b, _ in prepared)
    jprep = [(p, tuple(sorted(p.columns()))) for p in preds["jax"]]
    structures = tuple(_expr_structure(e) for e, _ in jprep)
    lit_vecs = []
    for e, _ in jprep:
        vals: list = []
        _expr_literals(e, vals)
        lit_vecs.append(np.asarray(vals, dtype=np.int32))
    if case.startswith("hybrid_"):
        h = cases["hybrid"]
        rows = k1b_cases.deletion_rows(case[len("hybrid_"):], h["n_base"])
        base = [torch.from_numpy(x) for x in h["base"]]
        delta = [torch.from_numpy(x) for x in h["delta"]]
        got = tk.hybrid_block_counts_batch_tensor(
            prepared, names, base, delta, torch.from_numpy(tk.pack_row_bitmask(rows))).numpy()
        fn = _hybrid_batched_counts_fn(structures, tuple(nm for _, nm in jprep),
                                       [e for e, _ in jprep], h["n_base"] // 128,
                                       delta[0].numel() // 128, True)
        exp = np.asarray(fn(dict(zip(names, h["base"])), dict(zip(names, h["delta"])),
                            tuple(lit_vecs), rows.astype(np.int32)))
    else:
        planes = [torch.from_numpy(p) for p in c["planes"]]
        got = tk.predicate_block_counts_batch_tensor(prepared, names, planes, c["specs"], n).numpy()
        spec_map = None if case == "raw" else tuple(
            (nm, jbitpack.PackSpec(bits=s.bits, vpw=s.vpw, n=s.n, ref0=s.ref0))
            for nm, s in zip(names, c["specs"]))
        fn = _batched_counts_fn(structures, tuple(nm for _, nm in jprep), [e for e, _ in jprep],
                                n // 128, spec_map)
        exp = np.asarray(fn(dict(zip(names, c["planes"])), tuple(lit_vecs)))
    assert got.shape == exp.shape and np.array_equal(got, exp)
    assert 0 < got.sum() < got.size * tk.BLOCK_ROWS  # neither empty nor everything
