"""HBM residency parity: the port's resident cache and scan
(``hyperspace_tpu_torch/exec/hbm_cache.py``, the resident arm of
``exec/scan.py``) against the JAX package's, on the same numpy-made TCB
files. The JAX side runs with residency forced and its mask kernel in the
Pallas interpreter; the port runs on the CPU with ``mode=force``, where
K1c's plain version computes the block counts. Mirrors
``tests/test_hbm_cache.py`` case by case. Tolerance: exact throughout.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.exec import hbm_cache as jh
from hyperspace_tpu.exec.scan import index_scan as jscan
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu.storage import layout
from hyperspace_tpu.storage.columnar import Column, ColumnarBatch

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.config import ResidencyConf
from hyperspace_tpu_torch.exec import hbm_cache as th
from hyperspace_tpu_torch.exec.scan import index_scan as tscan
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.ops import launch_counts, reset_launch_counts
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

FORCE = ResidencyConf(mode="force", min_rows=1)
BLOCK = th.BLOCK_ROWS


@pytest.fixture(autouse=True)
def _force_residency(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_HBM", "force")
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MIN_ROWS", "1")
    monkeypatch.setenv("HYPERSPACE_TPU_KERNELS", "interpret")
    jh.hbm_cache.reset()
    th.hbm_cache.reset()
    yield
    jh.hbm_cache.reset()
    th.hbm_cache.reset()


def _write(tmp_path, batches, tag="aaaa"):
    paths = []
    for i, cols in enumerate(batches):
        p = tmp_path / f"b{i:05d}-{tag}{i:04x}.tcb"
        layout.write_batch(p, ColumnarBatch(cols), sorted_by=["k"], bucket=i)
        paths.append(p)
    return paths


def _index_files(tmp_path, n_files=3, rows_per_file=3000, seed=0):
    """Key-sorted TCB files, the layout the build produces."""
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(n_files):
        base = i * 100_000
        batches.append({
            "k": Column("int64", np.sort(rng.integers(base, base + 100_000, rows_per_file))),
            "v": Column("int64", rng.integers(0, 1000, rows_per_file)),
            "f": Column("float32", rng.normal(0, 1, rows_per_file).astype(np.float32)),
        })
    return _write(tmp_path, batches)


def _f64_files(tmp_path):
    rng = np.random.default_rng(0)
    n = 4000
    d = np.round(rng.normal(0, 100.0, n), 3)
    d[:5] = [0.0, -0.0, -250.125, 1e-300, 7.5]
    return _write(tmp_path, [{
        "s": Column.from_values(np.array([b"x", b"y", b"z"], dtype=object)[rng.integers(0, 3, n)]),
        "d": Column("float64", d),
        "k": Column("int64", np.sort(rng.integers(0, 10_000, n))),
    }], tag="feed")


def _string_files(tmp_path):
    """Different per-file dictionaries, with NULLs (code -1)."""
    rng = np.random.default_rng(7)
    vocabs = [
        np.array([b"apple", b"cherry", b"mango"], dtype=object),
        np.array([b"banana", b"cherry", b"zucchini"], dtype=object),
        np.array([b"apple", b"kiwi"], dtype=object),
    ]
    batches = []
    for i, vv in enumerate(vocabs):
        n = 4000
        codes = rng.integers(0, len(vv), n).astype(np.int32)
        codes[::5] = -1
        batches.append({
            "k": Column("int64", np.sort(rng.integers(i * 10_000, (i + 1) * 10_000, n))),
            "s": Column("string", codes, vv),
            "v": Column("int64", rng.integers(0, 100, n)),
        })
    return _write(tmp_path, batches, tag="cafe")


# (files, resident columns, predicates as functions of a package's expr)
CASES = {
    "int": (_index_files, ["k", "v"], [
        lambda m: (m.col("k") >= 5_000) & (m.col("k") <= 9_000),
        lambda m: ~(m.col("v") == 3) & (m.col("k") < 150_000),
    ]),
    "float32": (_index_files, ["k", "f"], [
        lambda m: (m.col("f") > 1.5) & (m.col("k") < 50_000),
        lambda m: m.is_in(m.col("f"), [0.5, -1.25]) | (m.col("f") <= -2.0),
    ]),
    "f64_two_plane": (_f64_files, ["s", "d", "k"], [
        lambda m: (m.col("d") >= -50.0) & (m.col("d") < 75.25) & (m.col("k") < 8000),
        lambda m: (m.col("d") != 0.0) & (m.col("d") <= 0.5),
        lambda m: m.is_in(m.col("d"), [7.5, -250.125, 123456.789]),
    ]),
    "strings_nulls": (_string_files, ["s", "k"], [
        lambda m: (m.col("s") >= "banana") & (m.col("s") < "mango"),
        lambda m: (m.col("s") != "apple") & (m.col("k") < 15_000),
        lambda m: m.col("s") == "nope-not-present",
    ]),
    # v <= 10 holds for the zero pad rows: the tail block counts them
    "tail_pads_match": (_index_files, ["v"], [lambda m: m.col("v") <= 10]),
}


def _prefetch_both(paths, cols):
    jt = jh.hbm_cache.prefetch(paths, cols)
    tt = th.hbm_cache.prefetch(paths, cols, device="cpu", conf=FORCE)
    assert jt is not None and tt is not None
    assert set(jt.columns) == set(tt.columns) and tt.n_rows == jt.n_rows
    assert tt.n_pad % BLOCK == 0 and tt.n_pad - tt.n_rows < BLOCK
    return jt, tt


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_counts_match_reference(tmp_path, case):
    make, cols, preds = CASES[case]
    paths = make(tmp_path)
    jt, tt = _prefetch_both(paths, cols)
    for mk in preds:
        want = jh.hbm_cache.block_counts(jt, mk(jexpr))
        got = th.hbm_cache.block_counts(tt, mk(texpr))
        assert want is not None and got is not None
        assert got.dtype == np.int32 and np.array_equal(got, want), case
    if case == "tail_pads_match":
        pads = tt.n_pad - tt.n_rows
        real_tail = int((tt.columns["v"].data[(len(got) - 1) * BLOCK: tt.n_rows] <= 10).sum())
        assert pads > 0 and got[-1] == real_tail + pads


def test_zone_block_fraction_matches_reference(tmp_path):
    paths = _index_files(tmp_path, rows_per_file=2 * BLOCK)
    jt, tt = _prefetch_both(paths, ["k", "v"])
    assert set(tt.zones) == set(jt.zones) == {"k", "v"}
    for mk in (
        lambda m: (m.col("k") >= 5_000) & (m.col("k") <= 9_000),
        lambda m: (m.col("k") >= 0) & (m.col("v") >= 0),
        lambda m: m.col("k") != 3,
        lambda m: (m.col("k") > 150_000.5) & (m.col("v") < 7),
    ):
        assert th.zone_block_fraction(tt, mk(texpr)) == jh.zone_block_fraction(jt, mk(jexpr))
    d_paths = _f64_files(tmp_path / "f64")
    jt, tt = _prefetch_both(d_paths, ["d", "k"])
    assert tt.zones["d"][0] == "f64ord"
    for mk in (lambda m: (m.col("d") >= -3.5) & (m.col("d") <= 12.25),
               lambda m: m.col("d") > 2**60):
        assert th.zone_block_fraction(tt, mk(texpr)) == jh.zone_block_fraction(jt, mk(jexpr))


def _rows(batch, cols):
    arrs = [np.asarray(batch.columns[c].data) for c in cols]
    order = np.lexsort(tuple(reversed(arrs)))
    return [a[order] for a in arrs]


@pytest.mark.parametrize("case", ["int", "f64_two_plane", "strings_nulls"])
def test_resident_scan_rows_match_reference_and_per_file(tmp_path, monkeypatch, case):
    # the f64 data is unclustered: the zone gate would route host, so it
    # is off here on both sides (the gate has its own test)
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MAX_BLOCK_FRAC", "1.0")
    gate_off = ResidencyConf(mode="force", max_block_frac=1.0)
    make, cols, preds = CASES[case]
    paths = make(tmp_path)
    _prefetch_both(paths, cols)
    out = ["k", "d"] if case == "f64_two_plane" else ["k", "v"]
    off = ResidencyConf(mode="off")
    for mk in preds:
        tmetrics.reset()
        got = tscan(paths, out, mk(texpr), device="cpu", residency=gate_off)
        assert tmetrics.get("scan.path.resident_device") == 1, case
        touched = tmetrics.get("scan.resident.blocks_touched")
        assert touched <= tmetrics.get("scan.resident.blocks_total")
        per_file = tscan(paths, out, mk(texpr), device="cpu", residency=off)
        assert tmetrics.get("scan.path.resident_device") == 1  # off: not served
        want = jscan(paths, out, mk(jexpr), device=True)
        for g, p, w in zip(_rows(got, out), _rows(per_file, out), _rows(want, out)):
            assert np.array_equal(g, w) and np.array_equal(p, w), case
        assert list(got.column_names) == out


def test_resident_subset_of_files_and_empty_result(tmp_path):
    paths = _index_files(tmp_path)
    _prefetch_both(paths, ["k"])
    pred = texpr.col("k") <= 40_000  # zone maps prune to file 0
    tmetrics.reset()
    got = tscan(paths, ["k"], pred, device="cpu", residency=FORCE)
    assert tmetrics.get("scan.path.resident_device") == 1
    want = jscan(paths, ["k"], jexpr.col("k") <= 40_000, device=True)
    assert got.num_rows == want.num_rows > 0
    empty = tscan(paths, ["k", "v"], texpr.col("k") == -77, device="cpu",
                  dtypes={"k": "int64", "v": "int64"}, residency=FORCE)
    assert empty.num_rows == 0 and set(empty.columns) == {"k", "v"}


def test_selectivity_gate_routes_host_where_reference_does(tmp_path, monkeypatch):
    paths = _index_files(tmp_path, rows_per_file=2 * BLOCK)
    _prefetch_both(paths, ["k", "v"])
    for mk, routed_host in (
        (lambda m: (m.col("k") >= 0) & (m.col("v") >= 0), True),
        (lambda m: (m.col("k") >= 5_000) & (m.col("k") <= 9_000), False),
    ):
        jh.metrics.reset()
        jscan(paths, ["k", "v"], mk(jexpr), device=True)
        jsnap = jh.metrics.snapshot()["counters"]
        tmetrics.reset()
        tscan(paths, ["k", "v"], mk(texpr), device="cpu", residency=FORCE)
        assert (jsnap.get("scan.gate.resident_selectivity") == 1) is routed_host
        assert tmetrics.get("scan.gate.resident_selectivity") == int(routed_host)
        assert tmetrics.get("scan.path.resident_device") == int(not routed_host)
        assert jsnap.get("scan.path.resident_device", 0) == int(not routed_host)
    # a 1.0 threshold disables the gate, as the reference's knob does
    tmetrics.reset()
    broad = (texpr.col("k") >= 0) & (texpr.col("v") >= 0)
    tscan(paths, ["k", "v"], broad, device="cpu",
          residency=ResidencyConf(mode="force", max_block_frac=1.0))
    assert tmetrics.get("scan.path.resident_device") == 1


def _nan_f32(tmp_path):
    rng = np.random.default_rng(1)
    f = rng.normal(0, 1, 3000).astype(np.float32)
    f[::7] = np.nan
    return _write(tmp_path, [{"f": Column("float32", f),
                              "k": Column("int64", np.sort(rng.integers(0, 10_000, 3000)))}])


def _nan_f64(tmp_path):
    rng = np.random.default_rng(1)
    d = rng.normal(0, 1, 2000)
    d[7] = np.nan
    return _write(tmp_path, [{"d": Column("float64", d),
                              "k": Column("int64", np.sort(rng.integers(0, 10_000, 2000)))}])


def _mixed_dtypes(tmp_path):
    return _write(tmp_path, [
        {"c": Column.from_values(np.array([b"x", b"y"] * 50, dtype=object)),
         "k": Column("int64", np.arange(100, dtype=np.int64))},
        {"c": Column("int64", np.arange(100, dtype=np.int64)),
         "k": Column("int64", np.arange(100, 200, dtype=np.int64))},
    ])


@pytest.mark.parametrize("make,cols,pred", [
    (_nan_f32, ["f", "k"], lambda m: m.col("f") > 0.5),
    (_nan_f64, ["d", "k"], lambda m: (m.col("d") > 0.0) & (m.col("k") < 9000)),
    (_mixed_dtypes, ["c", "k"], lambda m: m.col("k") < 150),
    (_index_files, ["k"], lambda m: m.col("k") < (1 << 40)),  # unnarrowable literal
])
def test_declines_match_reference(tmp_path, make, cols, pred):
    paths = make(tmp_path)
    jt, tt = _prefetch_both(paths, cols)
    jh.metrics.reset()
    want = jscan(paths, ["k"], pred(jexpr), device=True)
    tmetrics.reset()
    got = tscan(paths, ["k"], pred(texpr), device="cpu", residency=FORCE)
    served = jh.metrics.snapshot()["counters"].get("scan.path.resident_device", 0)
    assert tmetrics.get("scan.path.resident_device") == served
    assert np.array_equal(_rows(got, ["k"])[0], _rows(want, ["k"])[0])
    if make is _nan_f64:
        assert th.hbm_cache.prefetch(paths, ["d"], device="cpu", conf=FORCE) is None
        assert jh.hbm_cache.prefetch(paths, ["d"]) is None


def test_string_col_col_declines_without_dropping_table(tmp_path):
    rng = np.random.default_rng(9)
    n = 2000
    v1 = np.array([b"p", b"q", b"r"], dtype=object)
    v2 = np.array([b"q", b"r", b"zz"], dtype=object)
    paths = _write(tmp_path, [{
        "s1": Column.from_values(v1[rng.integers(0, 3, n)]),
        "s2": Column.from_values(v2[rng.integers(0, 3, n)]),
        "k": Column("int64", np.sort(rng.integers(0, 10_000, n))),
    }])
    _, tt = _prefetch_both(paths, ["s1", "s2", "k"])
    pred = texpr.col("s1") == texpr.col("s2")
    tmetrics.reset()
    with pytest.raises(hs_torch.HyperspaceException, match="unified dictionary"):
        tscan(paths, ["k"], pred, device="cpu", residency=FORCE)
    assert tmetrics.get("scan.path.resident_device") == 0
    assert tmetrics.get("hbm.predicate_unbindable") == 1
    assert th.hbm_cache.resident_for(paths, ["s1"], "cpu", FORCE) is tt


def _wide_files(tmp_path, n_int, n_f64):
    """One file of ``n_int`` int64 and ``n_f64`` float64 columns (an f64
    column is two resident planes) beside the key."""
    rng = np.random.default_rng(n_int + 10 * n_f64)
    n = 3000
    cols = {f"i{j:02d}": Column("int64", rng.integers(0, 1000, n)) for j in range(n_int)}
    cols.update({f"d{j}": Column("float64", np.round(rng.normal(0, 100.0, n), 3))
                 for j in range(n_f64)})
    cols["k"] = Column("int64", np.sort(rng.integers(0, 10_000, n)))
    return _write(tmp_path, [cols], tag="beef")


def _wide_pred(m, names):
    pred = m.col("k") >= 0
    for name in names:
        pred = pred & (m.col(name) > (-150.123 if name.startswith("d") else 50))
    return pred


@pytest.mark.parametrize("n_int,n_f64", [(15, 0), (16, 0), (7, 4), (8, 5)])
def test_predicate_over_more_planes_than_the_parameters_hold_stays_resident(
        tmp_path, monkeypatch, n_int, n_f64):
    """K1c's parameter block holds 16 column addresses (an f64 column takes
    two planes); beyond that the kernel reads them from a device array. The
    predicate stays on the resident path either way, rows as the
    reference's."""
    monkeypatch.setenv("HYPERSPACE_TPU_HBM_MAX_BLOCK_FRAC", "1.0")
    paths = _wide_files(tmp_path, n_int, n_f64)
    names = [f"i{j:02d}" for j in range(n_int)] + [f"d{j}" for j in range(n_f64)]
    _, tt = _prefetch_both(paths, names + ["k"])
    narrowed, planes = th.prepare_resident_predicate(tt.columns, _wide_pred(texpr, names))
    assert len(planes) == n_int + 2 * n_f64 + 1  # the key's plane too
    assert tk.lowered_predicate(narrowed, planes).n_cols == len(planes)
    tmetrics.reset()
    got = tscan(paths, ["k"], _wide_pred(texpr, names), device="cpu",
                residency=ResidencyConf(mode="force", max_block_frac=1.0))
    assert tmetrics.get("scan.path.resident_device") == 1
    want = jscan(paths, ["k"], _wide_pred(jexpr, names), device=True)
    assert 0 < got.num_rows < 3000
    assert np.array_equal(_rows(got, ["k"])[0], _rows(want, ["k"])[0])


@pytest.mark.gpu
def test_cuda_block_counts_over_many_planes_match_plain_version(tmp_path):
    """K1c on the card over 18 int32 planes, 10 of them from five f64
    columns: more addresses than the parameter block holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    paths = _wide_files(tmp_path, 7, 5)
    names = [f"i{j:02d}" for j in range(7)] + [f"d{j}" for j in range(5)]
    cpu = th.hbm_cache.prefetch(paths, names + ["k"], device="cpu", conf=FORCE)
    th.hbm_cache.reset()
    card = th.hbm_cache.prefetch(paths, names + ["k"], device="cuda", conf=FORCE)
    pred = _wide_pred(texpr, names)
    assert len(th.prepare_resident_predicate(card.columns, pred)[1]) == 18
    reset_launch_counts()
    got = th.hbm_cache.block_counts(card, pred)
    assert launch_counts() == {tk.K1C: 1}
    want = th.hbm_cache.block_counts(cpu, pred)
    assert 0 < want.sum() and np.array_equal(got, want)


def test_version_identity_invalidates(tmp_path):
    paths = _index_files(tmp_path, n_files=1)
    _prefetch_both(paths, ["k"])
    batch = ColumnarBatch({"k": Column("int64", np.arange(50, dtype=np.int64))})
    layout.write_batch(paths[0], batch, sorted_by=["k"], bucket=0)
    assert jh.hbm_cache.resident_for(paths, ["k"]) is None
    assert th.hbm_cache.resident_for(paths, ["k"], "cpu", FORCE) is None


def test_lru_eviction_under_small_budget(tmp_path):
    cache = th.HbmIndexCache()
    a = _index_files(tmp_path / "a", n_files=1, rows_per_file=45_000)
    b = _index_files(tmp_path / "b", n_files=1, rows_per_file=45_000, seed=1)
    ta = cache.prefetch(a, ["k", "v", "f"], "cpu", FORCE)
    assert ta is not None
    # holds one 3-column table but not two: inserting b evicts a (LRU)
    small = ResidencyConf(mode="force", budget_mb=1)
    assert ta.nbytes * 3 // 2 < small.budget_bytes < 2 * ta.nbytes
    tb = cache.prefetch(b, ["k", "v", "f"], "cpu", small)
    assert tb is not None
    assert cache.resident_for(b, ["k"], "cpu", small) is tb
    assert cache.resident_for(a, ["k"], "cpu", small) is None
    assert [t["rows"] for t in cache.snapshot_residency()["tables"]] == [45_000]
    assert tmetrics.timings()["hbm.prefetch"][1] >= 2  # one build timed per table
    # a table over the whole budget is refused before any upload
    tmetrics.reset()
    assert cache.prefetch(a, ["k", "v", "f"], "cpu", ResidencyConf(budget_mb=0)) is None
    assert tmetrics.get("hbm.over_budget_refused") == 1


def test_note_touch_populates_in_background(tmp_path):
    paths = _index_files(tmp_path)
    pred = texpr.col("k") == 5_000
    tmetrics.reset()
    first = tscan(paths, ["k", "v"], pred, device="cpu", residency=FORCE)
    assert tmetrics.get("scan.path.resident_device") == 0  # cold: per-file
    th.hbm_cache.wait_background()
    assert th.hbm_cache.resident_for(paths, ["k"], "cpu", FORCE) is not None
    again = tscan(paths, ["k", "v"], pred, device="cpu", residency=FORCE)
    assert tmetrics.get("scan.path.resident_device") == 1
    assert again.num_rows == first.num_rows
    # auto populates only on the card; below minRows never
    th.hbm_cache.reset()
    tscan(paths, ["k", "v"], pred, device="cpu", residency=ResidencyConf(min_rows=1))
    tscan(paths, ["k", "v"], pred, device="cpu",
          residency=ResidencyConf(mode="force", min_rows=10_000))
    th.hbm_cache.wait_background()
    assert th.hbm_cache.resident_for(paths, ["k"], "cpu", FORCE) is None


def test_background_upload_error_surfaces_on_query_thread(tmp_path, monkeypatch):
    paths = _index_files(tmp_path)

    def broken(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(th, "_upload_planes", broken)
    tscan(paths, ["k"], texpr.col("k") < 50_000, device="cpu", residency=FORCE)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        th.hbm_cache.wait_background()
    # raised once, and the failure is not memoized: a later touch retries
    th.hbm_cache.wait_background()
    monkeypatch.undo()
    th.hbm_cache.note_touch(paths, ["k"], "cpu", FORCE)
    th.hbm_cache.wait_background()
    assert th.hbm_cache.resident_for(paths, ["k"], "cpu", FORCE) is not None
    # the synchronous path raises directly
    monkeypatch.setattr(th, "_upload_planes", broken)
    th.hbm_cache.reset()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        th.hbm_cache.prefetch(paths, ["k"], "cpu", FORCE)


def _session(tmp_path, mod, conf):
    from hyperspace_tpu.storage import parquet_io

    rng = np.random.default_rng(5)
    n = 50_000
    src = tmp_path / "src"
    if not src.exists():
        src.mkdir()
        batch = ColumnarBatch({
            "k": Column("int64", rng.integers(0, 100_000, n)),
            "v": Column("int64", rng.integers(0, 100, n)),
        })
        parquet_io.write_parquet(src / "p.parquet", batch)
    session = mod.HyperspaceSession(mod.HyperspaceConf(conf))
    return session, mod.Hyperspace(session), str(src)


def test_prefetch_index_only_for_active_covering_index(tmp_path):
    import hyperspace_tpu as hs_jax

    js, jhs, src = _session(tmp_path, hs_jax, {
        "hyperspace.system.path": str(tmp_path / "ix_jax"), "hyperspace.index.numBuckets": 4})
    ts, ths, _ = _session(tmp_path, hs_torch, {
        "hyperspace.system.path": str(tmp_path / "ix_torch"), "hyperspace.index.numBuckets": 4,
        "hyperspace.torch.device": "cpu", "hyperspace.torch.hbm.mode": "force"})
    jhs.create_index(js.read.parquet(src), hs_jax.IndexConfig("pi", ["k"], ["v"]))
    ths.create_index(ts.read.parquet(src), hs_torch.IndexConfig("pi", ["k"], ["v"]))
    assert ths.prefetch_index("pi") is jhs.prefetch_index("pi") is True
    assert ths.prefetch_index("PI", ["K", "V"]) is True  # case resolves
    with pytest.raises(hs_torch.HyperspaceException, match="could not be found"):
        ths.prefetch_index("nope")
    # a DELETED index does not qualify (its log's latest stable state)
    from hyperspace_tpu_torch.actions import states

    mgr = ts.collection_manager._existing_log_manager("pi")
    entry = mgr.get_latest_stable_log()
    entry.state = states.DELETED
    new_id = mgr.get_latest_id() + 1
    assert mgr.write_log(new_id, entry) and mgr.create_latest_stable_log(new_id)
    assert ths.prefetch_index("pi") is False

    th.hbm_cache.reset()
    ts2, ths2, _ = _session(tmp_path, hs_torch, {
        "hyperspace.system.path": str(tmp_path / "ix_jax"),
        "hyperspace.torch.device": "cpu", "hyperspace.torch.hbm.mode": "force"})
    assert ths2.prefetch_index("pi") is True  # the JAX package's index tree
    ts2.enable_hyperspace()
    js.enable_hyperspace()
    reset_launch_counts()
    tmetrics.reset()
    got = ts2.read.parquet(src).filter(texpr.col("k") == 123).select("k", "v").collect()
    want = js.read.parquet(src).filter(jexpr.col("k") == 123).select("k", "v").collect()
    assert tmetrics.get("scan.path.resident_device") == 1
    assert got.num_rows == want.num_rows
    assert launch_counts() == {}  # CPU: K1c's plain version, no launch


def test_concurrent_touches_register_one_table(tmp_path):
    """Many query threads missing on the same file set at once: one
    background population, one registered table, every result exact."""
    import sys
    import threading

    paths = _index_files(tmp_path)
    pred = (texpr.col("k") >= 5_000) & (texpr.col("k") <= 90_000)
    want = tscan(paths, ["k", "v"], pred, device="cpu", residency=ResidencyConf(mode="off"))
    tmetrics.reset()
    results, errors = [], []

    def query():
        try:
            for _ in range(3):
                results.append(tscan(paths, ["k", "v"], pred, device="cpu", residency=FORCE).num_rows)
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=query) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        th.hbm_cache.wait_background()
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert results == [want.num_rows] * 48
    assert tmetrics.get("hbm.tables_registered") == 1
    assert len(th.hbm_cache.snapshot_residency()["tables"]) == 1
