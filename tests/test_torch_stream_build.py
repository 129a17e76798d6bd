"""Parity of the port's streaming build with the JAX package on the CPU:
the staged device programs (``stage_chunk_packed``, ``merge_staged_chunks``),
the host engine, the pipelined ``StreamingIndexWriter`` in both finalize
modes and both engines, the worker-pool layer, the auto engine probe, the
chunked source reads and the create action's routing into the streaming
build.

Every test feeds the same numpy input, made from a seed, through both
packages (JAX on the CPU) and compares orders, counts, log entries and the
index bytes file by file — files matched by bucket or run sequence, not by
their random suffix. Mirrors test_stream_build.py and
test_build_pipeline.py. Tolerance: exact.
"""

import json
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.index import stream_builder as jsb
from hyperspace_tpu.ops import build as jbuild
from hyperspace_tpu.parallel import pool as jpool
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage import parquet_io as jpq
from hyperspace_tpu.storage.columnar import ColumnarBatch as JB

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.index import stream_builder as tsb
from hyperspace_tpu_torch.ops import build as tbuild
from hyperspace_tpu_torch.parallel import pool as tpool
from hyperspace_tpu_torch.residency import slabs as tslabs
from hyperspace_tpu_torch.storage import parquet_io as tpq
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

SB = {"jax": jsb, "torch": tsb}
BATCH = {"jax": JB, "torch": TB}
PKGS = {"jax": hs_jax, "torch": hs_torch}
SCHEMA = {"k": "int64", "k2": "int32", "q": "int32", "f": "float64", "s": "string"}


@pytest.fixture(autouse=True)
def _hermetic_probe(monkeypatch):
    """The engine probe's verdicts come from this process alone: no cache
    file, and an empty in-process memo in both packages."""
    monkeypatch.setenv("HYPERSPACE_TPU_PROBE_CACHE", "")
    monkeypatch.setenv("HYPERSPACE_TPU_TORCH_PROBE_CACHE", "")
    jsb._ENGINE_CACHE.clear()
    tsb._ENGINE_CACHE.clear()
    yield
    jsb._ENGINE_CACHE.clear()
    tsb._ENGINE_CACHE.clear()


def _table(n, seed, key_hi=5000, wide=False):
    """Rows with ties on the keys; ``wide`` spreads the keys so a run's
    union of chunk bounds overflows the 63-bit pack."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, key_hi, n).astype(np.int64)
    if wide:
        k = k + (np.arange(n) // 4096).astype(np.int64) * (1 << 40)
    f = np.round(rng.standard_normal(n) * 100, 2)
    f[::13] = -0.0
    return {
        "k": k,
        "k2": rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32),
        "q": rng.integers(1, 51, n).astype(np.int32),
        "f": f,
        "s": rng.choice(["A", "N", "R"], n).astype(object),
    }


def _chunks(key, table, size):
    n = len(table["k"])
    for s in range(0, n, size):
        yield BATCH[key].from_pydict({c: v[s:s + size] for c, v in table.items()}, schema=SCHEMA)


_NAME = re.compile(r"^([br])(\d{5,})-[0-9a-f]{12}\.tcb$")


def _files_by_slot(paths):
    """{("b"|"r", bucket or run seq): bytes} of a list of index files."""
    out = {}
    for p in paths:
        m = _NAME.match(Path(p).name)
        assert m, p
        out[(m.group(1), int(m.group(2)))] = Path(p).read_bytes()
    return out


def _build(key, root, table, keys, chunk=4096, chunk_rows=3000, **kw):
    sb = SB[key]
    kw = dict(kw)
    dev = kw.pop("device_build", None)
    if key == "jax":
        if dev is not None:
            kw["device"] = jsb.DeviceBuildConfig(
                double_buffer=dev.double_buffer, run_chunks=dev.run_chunks)
    else:
        kw["device"] = "cpu"
        if dev is not None:
            kw["device_build"] = dev
    return sb.write_index_data_streaming(
        _chunks(key, table, chunk_rows), keys, 8, root / key, chunk,
        extra_meta={"indexName": "ix"}, **kw)


# ---------------------------------------------------------------------------
# the staged device programs
# ---------------------------------------------------------------------------
def _staged_case(mod, tables, keys, nb, run_plan_bounds):
    """Stage each chunk on its own plan, merge them on the run's plan:
    (order, counts, per-chunk counts) as numpy."""
    staged = []
    for t in tables:
        dtypes = {k: SCHEMA[k] for k in keys}
        bufs = {k: t[k] for k in keys}
        bounds = [(int(t[k].min()), int(t[k].max())) for k in keys]
        plan = mod.run_pack_plan(bounds, nb)
        if mod is tbuild:
            s, _ = mod.stage_chunk_packed(bufs, dtypes, keys, nb, plan, device="cpu")
        else:
            s, _ = mod.stage_chunk_packed(bufs, dtypes, keys, nb, plan)
        staged.append(s)
    run_plan = mod.run_pack_plan(run_plan_bounds, nb)
    if mod is tbuild:
        order, counts = mod.merge_staged_chunks(staged, run_plan, nb).wait()
    else:
        order_dev, counts_dev = mod.merge_staged_chunks(staged, run_plan, nb)
        order, counts = np.asarray(order_dev), np.asarray(counts_dev)
    return np.asarray(order), np.asarray(counts)[:nb]


@pytest.mark.parametrize("keys,r,nb", [(["k"], 4, 8), (["k", "k2"], 3, 200), (["k2"], 2, 1)],
                         ids=["one_key_r4", "two_keys_r3", "one_bucket_r2"])
def test_staged_programs_match_reference(keys, r, nb):
    """R chunks with their own mins and shifts, ties inside and across
    chunks, re-packed on the run's union plan: the merged order (left run
    wins ties) and the summed counts are the reference's exactly, and equal
    a stable argsort of the run's rows by (bucket, keys)."""
    tables = [_table(1024, 10 * r + c, key_hi=300 + 100 * c) for c in range(r)]
    bounds = [(min(int(t[k].min()) for t in tables), max(int(t[k].max()) for t in tables))
              for k in keys]
    jo, jc = _staged_case(jbuild, tables, keys, nb, bounds)
    to, tc = _staged_case(tbuild, tables, keys, nb, bounds)
    assert to.dtype == np.int32 and np.array_equal(jo, to)
    assert np.array_equal(jc, tc) and int(tc.sum()) == 1024 * r
    whole = TB.from_pydict({c: np.concatenate([t[c] for t in tables]) for c in SCHEMA},
                           schema=SCHEMA)
    want, want_counts = tbuild.build_partition_host(whole.select(keys + ["q"]), keys, nb)
    got = whole.take(to.astype(np.int64))
    for k in keys + ["q"]:
        assert np.array_equal(got.columns[k].data, want.columns[k].data)
    assert np.array_equal(want_counts, tc)


def test_staged_merge_handles_63_bit_shifts():
    """One key spanning 62 bits above a one-bit bucket field: the composite
    fills all 63 bits, and the unpack masks and shifts must stay exact."""
    rng = np.random.default_rng(3)
    tables = []
    for c in range(2):
        k = rng.integers(-(1 << 61), 1 << 61, 512).astype(np.int64)
        k[:8] = k[8:16]  # ties
        tables.append({"k": k})
    bounds = [(min(int(t["k"].min()) for t in tables), max(int(t["k"].max()) for t in tables))]
    assert tbuild.run_pack_plan(bounds, 1)[0][1] == 62
    jo, jc = _staged_case(jbuild, tables, ["k"], 1, bounds)
    to, tc = _staged_case(tbuild, tables, ["k"], 1, bounds)
    assert np.array_equal(jo, to) and np.array_equal(jc, tc)


@pytest.mark.parametrize("workers", [1, 3])
def test_host_engine_matches_reference_and_device(workers):
    """build_partition_host(_parallel): the reference's order, counts and
    bytes, and the device build's, float keys with -0.0 and string keys
    included."""
    t = _table(70000, 5)
    for keys in (["k"], ["f", "q"], ["s", "k"]):
        jb = JB.from_pydict(t, schema=SCHEMA)
        tb = TB.from_pydict(t, schema=SCHEMA)
        j_out, j_counts = jbuild.build_partition_host_parallel(jb, keys, 16, workers)
        t_out, t_counts = tbuild.build_partition_host_parallel(tb, keys, 16, workers)
        d_out, d_counts = tbuild.build_partition_single(tb, keys, 16, device="cpu")
        assert np.array_equal(j_counts, t_counts) and np.array_equal(t_counts, d_counts)
        for c in SCHEMA:
            assert np.array_equal(j_out.columns[c].to_values(), t_out.columns[c].to_values())
            assert np.array_equal(t_out.columns[c].to_values(), d_out.columns[c].to_values())


# ---------------------------------------------------------------------------
# the streaming writer: bytes equal the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("finalize_mode", ["merge", "runs"])
@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("run_chunks", [1, 2, 4])
def test_streaming_build_bytes_match_reference(tmp_path, finalize_mode, engine, run_chunks):
    """20,000 rows in 3,000-row source batches at chunk capacity 4096: four
    full chunks and a tail, so R=2 gives two staged runs and R=4 one, then
    the per-chunk tail. Both engines, both finalize modes: every index file
    equals the reference's byte for byte."""
    t = _table(20000, run_chunks)
    dev = tsb.DeviceBuildConfig(run_chunks=run_chunks)
    outs = {k: _build(k, tmp_path, t, ["k"], engine=engine, finalize_mode=finalize_mode,
                      device_build=dev) for k in SB}
    j, to = _files_by_slot(outs["jax"]), _files_by_slot(outs["torch"])
    assert j == to
    kinds = {k for k, _ in to}
    assert kinds == ({"r"} if finalize_mode == "runs" else {"b"})
    assert not (tmp_path / "torch" / tsb.SPILL_DIR_NAME).exists()


def test_staged_runs_flush_on_pack_overflow_and_count(tmp_path):
    """Keys whose union across chunks passes 63 bits flush the pending run
    early (``build.device.run_flush_overflow``); string keys decline
    staging; the counters and the run files equal the reference's."""
    from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

    t = _table(4096 * 5 + 100, 7, key_hi=1 << 20, wide=True)
    dev = tsb.DeviceBuildConfig(run_chunks=4)
    names = ("build.device.run_flush_overflow", "build.device.staged_chunks",
             "build.device.staged_runs", "build.device.staging_declined.tail",
             "build.stream.chunks", "build.stream.d2h_calls")
    got = {}
    for k, m, read in (("jax", jmetrics, jmetrics.counter), ("torch", tmetrics, tmetrics.get)):
        m.reset()
        paths = _build(k, tmp_path, t, ["k", "k2"], chunk_rows=5000, engine="device",
                       finalize_mode="runs", device_build=dev)
        got[k] = ({n: read(n) for n in names}, _files_by_slot(paths))
    assert got["jax"] == got["torch"]
    assert got["torch"][0]["build.device.run_flush_overflow"] >= 1
    assert got["torch"][0]["build.device.staged_chunks"] == 5
    # string keys: staging declines, the bytes still match
    outs = {k: _build(k, tmp_path / "s", t, ["s"], engine="device", device_build=dev)
            for k in SB}
    assert _files_by_slot(outs["jax"]) == _files_by_slot(outs["torch"])


@pytest.mark.parametrize("seed", range(6))
def test_streaming_build_fuzz_matches_reference(tmp_path, seed):
    """Random sizes, chunk capacities, run depths, keys, finalize modes,
    engines and pipeline shapes: the index files equal the reference's."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 9000))
    t = _table(n, seed, key_hi=int(rng.choice([7, 500, 1 << 30])), wide=bool(seed % 3 == 2))
    keys = [["k"], ["k", "k2"], ["q", "f"], ["s"]][seed % 4]
    cap = int(rng.choice([512, 1000, 2048]))
    rows = int(rng.integers(1, 3000))
    dev = tsb.DeviceBuildConfig(double_buffer=bool(seed % 2), run_chunks=int(rng.integers(1, 5)))
    pipe = {"torch": tsb.BuildPipelineConfig.serial() if seed % 3 == 0
            else tsb.BuildPipelineConfig(True, 2, 2, 2, 2, 2)}
    pipe["jax"] = jsb.BuildPipelineConfig(**pipe["torch"].__dict__)
    kw = dict(engine=["device", "host"][seed % 2], finalize_mode=["merge", "runs"][(seed // 2) % 2])
    outs = {k: _build(k, tmp_path, t, keys, chunk=cap, chunk_rows=rows, pipeline=pipe[k],
                      device_build=dev, **kw) for k in SB}
    assert _files_by_slot(outs["jax"]) == _files_by_slot(outs["torch"])


def test_budget_refusal_takes_the_per_chunk_device_path(tmp_path):
    """A reservation the budget refuses routes every chunk through the
    per-chunk device path, counted, never the CPU engine; the reservation
    is released at the end; the bytes equal a staged build's."""
    t = _table(4096 * 3, 9)
    tmetrics.reset()
    tiny = tsb.DeviceBuildConfig(run_chunks=2, hbm_budget_bytes=1 << 20)
    refused = _build("torch", tmp_path / "a", t, ["k"], engine="device", device_build=tiny)
    assert tmetrics.get("build.device.staging_declined.budget") == 3
    assert tmetrics.get("build.device.staged_chunks") == 0
    assert tmetrics.get("build.engine.host") == 0
    assert tmetrics.get("build.engine.device") == 3
    assert tslabs.held_bytes() == 0
    staged = _build("torch", tmp_path / "b", t, ["k"], engine="device",
                    device_build=tsb.DeviceBuildConfig(run_chunks=2))
    assert tmetrics.get("build.device.staged_runs") == 2  # 2 chunks, then 1
    assert _files_by_slot(refused) == _files_by_slot(staged)


def test_slab_budget_accounting_and_cache_subtraction():
    from hyperspace_tpu_torch.config import ResidencyConf
    from hyperspace_tpu_torch.exec.hbm_cache import _budget_bytes

    conf = ResidencyConf(budget_mb=100)
    assert tslabs.try_reserve("a", 30 << 20, conf.budget_bytes)
    assert not tslabs.try_reserve("b", 30 << 20, conf.budget_bytes)  # over half
    assert _budget_bytes(conf) == (70 << 20)
    assert tslabs.try_reserve("a", 10 << 20, conf.budget_bytes)  # replaces
    tslabs.release("a")
    tslabs.release("a")
    assert tslabs.held_bytes() == 0 and _budget_bytes(conf) == conf.budget_bytes


# ---------------------------------------------------------------------------
# the writer's own behaviour (mirrors test_stream_build.py)
# ---------------------------------------------------------------------------
def test_writer_coalesces_splits_and_reports_stats(tmp_path):
    """Small batches coalesce, a large one splits: chunk counts and stats
    equal the reference's; a finalized writer refuses more."""
    out = {}
    for k in SB:
        kw = {"device": "cpu"} if k == "torch" else {}
        w = SB[k].StreamingIndexWriter(["k"], 4, tmp_path / k, 1000, engine="host",
                                       pipeline=SB[k].BuildPipelineConfig.serial(), **kw)
        t = _table(5000, 1)
        for s in (0, 10, 30, 300):
            w.add_chunk(BATCH[k].from_pydict({c: v[s:s + 10] for c, v in t.items()}, schema=SCHEMA))
        w.add_chunk(BATCH[k].from_pydict({c: v[:4000] for c, v in t.items()}, schema=SCHEMA))
        files = w.finalize()
        st = w.stats
        out[k] = (st["rows"], st["chunks"], st["chunk_capacity"], _files_by_slot(files))
        with pytest.raises(Exception, match="finalized"):
            w.add_chunk(BATCH[k].from_pydict({c: v[:1] for c, v in t.items()}, schema=SCHEMA))
    assert out["jax"] == out["torch"]
    assert out["torch"][:3] == (4040.0, 4.0, 1024.0)
    with pytest.raises(hs_torch.HyperspaceException):
        tsb.StreamingIndexWriter(["k"], 4, tmp_path / "x", 0, device="cpu")
    with pytest.raises(hs_torch.HyperspaceException):
        tsb.StreamingIndexWriter(["k"], 4, tmp_path / "x", 8, finalize_mode="x", device="cpu")


def test_failure_tears_the_pipeline_down(tmp_path, monkeypatch):
    """A spill write that fails mid-build re-raises the first error on the
    caller's thread, joins every worker and leaves no spill file, as in
    the reference; an aborted writer can be aborted again."""
    calls = {"n": 0}
    real = tsb.layout.write_batch

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        return real(*a, **kw)

    monkeypatch.setattr(tsb.layout, "write_batch", flaky)
    with pytest.raises(OSError, match="disk full"):
        _build("torch", tmp_path, _table(9000, 2), ["k"], chunk=1024, engine="device",
               pipeline=tsb.BuildPipelineConfig(True, 1, 2, 2, 2, 2))
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.name.startswith(("spill-", "ingest", "bucket-merge", "chunk-prefetch"))
            and t.is_alive() for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name.startswith(("spill-", "bucket-merge")) and t.is_alive()
                   for t in threading.enumerate())
    assert not list((tmp_path / "torch").rglob("*.tcb"))
    assert tslabs.held_bytes() == 0


# ---------------------------------------------------------------------------
# the worker pool (mirrors test_build_pipeline.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["jax", "torch"])
def test_pool_primitives_behave_alike(key):
    pool = jpool if key == "jax" else tpool
    out = list(pool.ordered_map(lambda x: (time.sleep(0.001 * (x % 3)), x * x)[1],
                                range(40), 4, window=6))
    assert out == [x * x for x in range(40)]
    assert pool.run_parallel([lambda i=i: i + 1 for i in range(10)], 3) == list(range(1, 11))

    def boom(x):
        if x == 5:
            raise ValueError("five")
        return x

    with pytest.raises(ValueError, match="five"):
        list(pool.ordered_map(boom, range(20), 3, window=4))
    fe = pool.FirstError()
    fe.fail(KeyError("first"))
    fe.fail(KeyError("second"))
    with pytest.raises(KeyError, match="first"):
        fe.check()
    wp = pool.WorkerPool(2, "t", queue_depth=1)
    wp.submit(lambda: (_ for _ in ()).throw(RuntimeError("x")))
    wp.close()
    assert isinstance(wp.failure.error, RuntimeError)
    assert wp.submit(lambda: None) is False


# ---------------------------------------------------------------------------
# the auto engine probe
# ---------------------------------------------------------------------------
def test_auto_engine_probes_then_routes_and_persists(tmp_path, monkeypatch):
    """Auto: chunk 0 the host probe, chunk 1 the device, chunk 2 the timed
    device probe, the rest the winner; the verdict lands in this package's
    own cache file under the same key layout as the reference's, and a
    later build reads it back. The bytes equal a fixed engine's."""
    cache = tmp_path / "probe.json"
    monkeypatch.setenv("HYPERSPACE_TPU_TORCH_PROBE_CACHE", str(cache))
    # the link check would settle it on chunk 0 on a CPU-only machine
    monkeypatch.setattr(tsb.StreamingIndexWriter, "_link_rules_out_device",
                        lambda self, sample: False)
    t = _table(1024 * 6, 4)
    tmetrics.reset()
    auto = _build("torch", tmp_path / "a", t, ["k"], chunk=1024, engine="auto")
    assert tmetrics.get("build.engine.device") >= 2  # chunk 1 and the probe
    assert tmetrics.get("build.engine.host") >= 1  # chunk 0
    assert tmetrics.get("build.device.staging_declined.probe") >= 1
    chose = tmetrics.get("build.engine.auto_chose_host") + tmetrics.get(
        "build.engine.auto_chose_device")
    assert chose == 1
    data = json.loads(cache.read_text())
    (key, verdict), = data.items()
    assert key.startswith("cpu:1024:") and key.endswith(":db1-r4")
    assert verdict["winner"] in ("host", "device")
    fixed = _build("torch", tmp_path / "f", t, ["k"], chunk=1024, engine="host")
    assert _files_by_slot(auto) == _files_by_slot(fixed)
    tsb._ENGINE_CACHE.clear()
    tmetrics.reset()
    _build("torch", tmp_path / "b", t, ["k"], chunk=1024, engine="auto")
    assert tmetrics.get("build.engine.winner_from_disk_cache") == 1


def test_probe_cache_key_separates_widths_and_modes():
    a = tsb._engine_cache_key(1 << 21, 1, "db1-r4", "cuda")
    b = tsb._engine_cache_key(1 << 21, 8, "db1-r4", "cuda")
    c = tsb._engine_cache_key(1 << 21, 1, "db0-r1", "cuda")
    assert len({a, b, c}) == 3
    assert tsb._engine_cache_key(1 << 21) == tsb._engine_cache_key(
        1 << 21, tsb.BuildPipelineConfig.default().host_width(),
        tsb.DeviceBuildConfig.default().mode_token())
    assert jsb.DeviceBuildConfig().mode_token() == tsb.DeviceBuildConfig().mode_token()


# ---------------------------------------------------------------------------
# chunked source reads and the create action's routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["avro", "parquet"])
def test_chunked_reads_match_reference(tmp_path, fmt):
    if fmt == "parquet":
        pytest.importorskip("pyarrow")
    t = _table(2500, 6)
    path = tmp_path / f"x.{fmt}"
    batch = JB.from_pydict(t, schema=SCHEMA)
    if fmt == "avro":
        jax_avro.write_avro(path, batch)
    else:
        jpq.write_parquet(path, batch)
    for cols in (None, ["q", "k"]):
        j = [b.to_pydict() for b in jpq.iter_file_batches(fmt, path, cols, chunk_rows=700)]
        to = [b.to_pydict() for b in tpq.iter_file_batches(fmt, path, cols, chunk_rows=700)]
        tasks = [b.to_pydict() for task in tpq.file_chunk_tasks(fmt, path, cols, 700)
                 for b in task()]
        assert len(j) == len(to) == 4
        for a, b, c in zip(j, to, tasks):
            assert a.keys() == b.keys() == c.keys()
            for n in a:
                assert np.array_equal(np.asarray(a[n]), np.asarray(b[n]))
                assert np.array_equal(np.asarray(b[n]), np.asarray(c[n]))


def _entry_view(entry, root):
    d = entry.to_json_dict()
    d.pop("timestamp")
    text = json.dumps(d, sort_keys=True, default=str)
    text = re.sub(r"([br]\d{5,})-[0-9a-f]{12}\.tcb", r"\1.tcb", text)
    text = re.sub(r'"modifiedTime": \d+', '"modifiedTime": 0', text)
    return text.replace(str(root), "<ix>").replace(f'"{Path(root).name}"', '"<ix>"')


@pytest.mark.parametrize("finalize_mode", ["merge", "runs"])
def test_create_routes_auto_over_threshold_to_streaming(tmp_path, finalize_mode):
    """``build.mode=auto`` streams a source over the threshold in both
    packages, with lineage: the log entries and the index bytes are equal;
    under the threshold it builds in memory."""
    src = tmp_path / "src"
    for i in range(3):
        jax_avro.write_avro(src / f"p-{i}.avro", JB.from_pydict(_table(3000, 20 + i), schema=SCHEMA))
    conf = {"hyperspace.index.numBuckets": 8, "hyperspace.index.lineage.enabled": True,
            "hyperspace.index.build.chunkRows": 2048,
            "hyperspace.index.build.finalizeMode": finalize_mode,
            "hyperspace.index.build.streamingThresholdBytes": 1000}
    views, data = {}, {}
    for k, mod in PKGS.items():
        c = dict(conf, **{"hyperspace.system.path": str(tmp_path / f"ix_{k}")})
        if k == "torch":
            c["hyperspace.torch.device"] = "cpu"
        s = mod.HyperspaceSession(mod.HyperspaceConf(c))
        tmetrics.reset()
        mod.Hyperspace(s).create_index(s.read.avro(str(src)), mod.IndexConfig("li", ["k"], ["q", "s"]))
        if k == "torch":
            assert tmetrics.get("build.stream.rows") == 9000
        entry = s.collection_manager.get_indexes()[0]
        views[k] = _entry_view(entry, tmp_path / f"ix_{k}")
        data[k] = _files_by_slot((tmp_path / f"ix_{k}" / "li").glob("v__=0/*.tcb"))
    assert views["jax"] == views["torch"]
    assert data["jax"] == data["torch"]
    assert {kind for kind, _ in data["torch"]} == ({"r"} if finalize_mode == "runs" else {"b"})
    # under the threshold: in memory, one file a bucket
    ts = hs_torch.HyperspaceSession(hs_torch.HyperspaceConf(
        dict(conf, **{"hyperspace.system.path": str(tmp_path / "ix_small"),
                      "hyperspace.torch.device": "cpu",
                      "hyperspace.index.build.streamingThresholdBytes": 1 << 30})))
    tmetrics.reset()
    hs_torch.Hyperspace(ts).create_index(ts.read.avro(str(src)),
                                         hs_torch.IndexConfig("li", ["k"], ["q"]))
    assert tmetrics.get("build.stream.rows") == 0
    assert tmetrics.get("build.engine.device") == 1


def test_conf_build_keys_parse_as_the_reference():
    from hyperspace_tpu.config import HyperspaceConf as JC
    from hyperspace_tpu_torch.config import HyperspaceConf as TC

    for values in ({}, {"hyperspace.index.build.pipeline": "off"},
                   {"hyperspace.index.build.ingestWorkers": "3",
                    "hyperspace.index.build.queueDepth": "5",
                    "hyperspace.index.build.device.runChunks": "0",
                    "hyperspace.index.build.device.doubleBuffer": "false",
                    "hyperspace.index.build.mode": "STREAMING",
                    "hyperspace.index.build.finalizeMode": "runs",
                    "hyperspace.index.build.engine": "host"}):
        j, t = JC(dict(values)), TC(dict(values))
        assert j.build_mode() == t.build_mode()
        assert j.build_chunk_rows() == t.build_chunk_rows()
        assert j.build_finalize_mode() == t.build_finalize_mode()
        assert j.build_engine() == t.build_engine()
        assert j.build_streaming_threshold_bytes() == t.build_streaming_threshold_bytes()
        assert j.build_pipeline().__dict__ == t.build_pipeline().__dict__
        jd, td = j.build_device(), t.build_device()
        assert (jd.double_buffer, jd.run_chunks) == (td.double_buffer, td.run_chunks)
        assert j.compaction_buckets_per_step() == t.compaction_buckets_per_step()
        assert j.segment_io_mode() == t.segment_io_mode()
    for bad in ({"hyperspace.index.build.mode": "x"}, {"hyperspace.index.build.engine": "x"},
                {"hyperspace.index.build.finalizeMode": "x"},
                {"hyperspace.index.build.pipeline": "x"}):
        with pytest.raises(hs_torch.HyperspaceException):
            t = TC(bad)
            t.build_mode(), t.build_engine(), t.build_finalize_mode(), t.build_pipeline()
