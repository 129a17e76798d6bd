"""The device-loss degrade of the port against the JAX package's, on CPU
tensors.

A runtime error out of a launch in a resident arm (the resident scan, the
streaming window loop, the hybrid arm, the two join arms, the device
aggregate, the served batch) drops the table or region, is counted under
the reference's names and the query answers through the route with no
resident table: on the card the per-file route (K1, K2); the reference's
host engine. Here both packages run one burst per arm with the error
injected at each of its dispatch points in turn, at the Python boundary
as the reference's chaos tests inject it; the rows, the degrade counters,
the server's ``degraded`` surface and the registry must be equal. A kernel
that cannot build propagates, and a device-probe verdict of False fails
tickets at submit. Mirrors ``test_failure_injection.py`` and
``test_reliability_chaos.py``'s serve device-loss cases. Tolerance: rows
exact (float aggregates ``rtol=1e-9``).
"""

import numpy as np
import pytest

from hyperspace_tpu.exec import hbm_cache as jh
from hyperspace_tpu.residency import knobs as jknobs
from hyperspace_tpu.residency import streaming as jstream
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

from hyperspace_tpu_torch.exceptions import DeviceUnavailableError, KernelBuildError
from hyperspace_tpu_torch.exec import hbm_cache as th
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.residency import streaming as tstream
from hyperspace_tpu_torch.storage.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics
from hyperspace_tpu_torch.utils import deviceprobe

from tests.test_torch_aggregate import assert_same
from tests.test_torch_compile import PKGS, QUERIES, _fresh, lookup, make_env  # noqa: F401

CACHE = {"jax": jh, "torch": th}
METRICS = {"jax": jmetrics, "torch": tmetrics}
DEGRADE = ("scan.resident.device_failed", "scan.resident_join.device_failed",
           "residency.stream.window_failed", "compile.pipeline.dropped_on_device_loss",
           "serve.degraded", "compile.agg.declined.device")


def _count(pkg, name):
    return jmetrics.counter(name) if pkg == "jax" else tmetrics.get(name)


def _degrade_counts(pkg):
    return {k: _count(pkg, k) for k in DEGRADE}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory.mktemp("loss"))


@pytest.fixture(scope="module")
def henv(tmp_path_factory):
    """An index whose source gained a file since: every filter is hybrid."""
    from hyperspace_tpu_torch.storage import avro_io

    e = make_env(tmp_path_factory.mktemp("loss_hybrid"), hybrid=True)
    extra = ColumnarBatch({"k": Column("int64", np.arange(0, 8000, 37)),
                           "v": Column("int64", np.arange(0, 8000, 37) * 3),
                           "g": Column("int64", np.arange(0, 8000, 37) % 40),
                           "d": Column("float64", np.full(217, 1.5))})
    avro_io.write_avro(e.root / "data" / "part-9.avro", extra)
    return e


@pytest.fixture(scope="module")
def senv(tmp_path_factory):
    """30,000 rows: four 8192-row windows, so a slab pair (two windows)
    fits a budget the whole table does not."""
    import hyperspace_tpu_torch as hs_torch
    from hyperspace_tpu_torch.storage import avro_io

    from tests.test_torch_compile import Env, source_batch

    root = tmp_path_factory.mktemp("loss_stream")
    e = Env(root)
    avro_io.write_avro(root / "data" / "part-0.avro", source_batch(n=30_000))
    s = e.session("torch")
    hs_torch.Hyperspace(s).create_index(e.read(s), hs_torch.IndexConfig("idx", ["k"], ["v"]))
    return e


def _patch_cache(monkeypatch, cache, attr, fn):
    """Set ``attr`` of a cache to ``fn`` and leave no instance attribute
    behind: on the instance where one is there already (an undone
    ``monkeypatch.setattr`` on an instance leaves its bound method), else on
    the class, where the undo restores the class's own."""
    owner = cache if attr in vars(cache) else type(cache)
    if owner is cache:
        monkeypatch.setattr(cache, attr, fn)
    else:
        monkeypatch.setattr(owner, attr, lambda self, *a, **k: fn(*a, **k))


def _lossy(monkeypatch, pkg, attr, point):
    """Make ``attr`` of the package's cache raise a RuntimeError on its
    ``point``-th call; returns the call counter."""
    cache = CACHE[pkg].hbm_cache
    real = getattr(cache, attr)
    calls = {"n": 0}

    def lossy(*a, **k):
        i = calls["n"]
        calls["n"] += 1
        if i == point:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(*a, **k)

    _patch_cache(monkeypatch, cache, attr, lossy)
    return calls


def _range(e, s, m, lo):
    return e.read(s).filter((m.col("k") >= lo) & (m.col("k") < lo + 400)).select("k", "v")


ARMS = {  # name: (cache method the arm launches through, burst, warm-up)
    "resident_scan": ("block_counts_batch",
                      [lambda e, s, m, lo=lo: _range(e, s, m, lo) for lo in (0, 3000, 6000)],
                      None),
    "agg_scan": ("agg_scan",
                 [lambda e, s, m, lo=lo: e.read(s).filter(m.col("k") >= lo).group_by("g")
                  .agg(m.agg_sum("v"), m.agg_count()) for lo in (100, 4000, 7000)],
                 None),
    "join_agg": ("join_agg", [QUERIES["join_agg"]] * 3, QUERIES["join_agg"]),
    "join_ranges": ("join_ranges", [QUERIES["join"]] * 3, QUERIES["join"]),
}
POINTS = [(arm, p) for arm in ARMS for p in range(3)]


def _run_arm(env, pkg, arm, point, monkeypatch):
    mod = PKGS[pkg]
    s = env.session(pkg)
    env.prefetch(pkg, s)
    attr, burst, warm = ARMS[arm]
    if warm is not None:  # the join region registers in the background
        warm(env, s, mod).collect()
        CACHE[pkg].hbm_cache.wait_background()
    METRICS[pkg].reset()
    calls = _lossy(monkeypatch, pkg, attr, point)
    rows, registry = _burst(CACHE[pkg].hbm_cache, [lambda q=q: q(env, s, mod) for q in burst],
                            calls, point)
    monkeypatch.undo()
    return rows, _degrade_counts(pkg), registry


def _burst(cache, queries, calls, point):
    """Collect ``queries`` in turn; the registry (tables, join regions,
    deltas) is read once the failing query and the background population
    it scheduled are done, before a later query can schedule another."""
    rows, registry = [], None
    for q in queries:
        rows.append(q().collect())
        if registry is None and calls["n"] > point:
            cache.wait_background()
            snap = cache.snapshot()
            registry = (snap["tables"], snap["joins"], snap["deltas"])
    assert registry is not None, f"the arm never reached point {point}"
    return rows, registry


@pytest.mark.parametrize("arm,point", POINTS)
def test_resident_arm_degrades_like_the_reference(env, monkeypatch, arm, point):
    out = {pkg: _run_arm(env, pkg, arm, point, monkeypatch) for pkg in PKGS}
    for a, b in zip(out["torch"][0], out["jax"][0]):
        assert_same(a, b, ordered=False, keys=sorted(b.column_names))
    assert out["torch"][1:] == out["jax"][1:]
    failed = ("scan.resident_join.device_failed" if arm.startswith("join")
              else "scan.resident.device_failed")
    assert out["torch"][1][failed] == 1


@pytest.mark.parametrize("point", range(3))
def test_hybrid_arm_degrades_like_the_reference(henv, monkeypatch, point):
    out = {}
    for pkg, mod in PKGS.items():
        s = henv.session(pkg)
        henv.prefetch(pkg, s)
        qs = [lambda lo=lo, s=s, mod=mod: _range(henv, s, mod, lo) for lo in (0, 3000, 6000)]
        qs[0]().collect()  # the delta populates on this miss
        CACHE[pkg].hbm_cache.wait_background()
        METRICS[pkg].reset()
        calls = _lossy(monkeypatch, pkg, "hybrid_block_counts_batch", point)
        rows, registry = _burst(CACHE[pkg].hbm_cache, qs, calls, point)
        monkeypatch.undo()
        out[pkg] = (rows, _degrade_counts(pkg), registry)
    for a, b in zip(out["torch"][0], out["jax"][0]):
        assert_same(a, b, ordered=False, keys=["k", "v"])
    assert out["torch"][1:] == out["jax"][1:]
    assert out["torch"][1]["scan.resident.device_failed"] == 1
    assert out["torch"][2][2] == 0  # the delta went with its base


@pytest.mark.parametrize("window", [0, 3])
def test_window_loop_degrades_like_the_reference(senv, monkeypatch, window):
    """A streaming table (a 100 kB budget, compression off, 8192-row
    windows: four windows) whose window ``window`` dies mid-upload: the
    generation moves, the table drops, the rows come from the per-file
    route."""
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_COMPRESSION", "off")
    monkeypatch.setenv("HYPERSPACE_TPU_RESIDENCY_WINDOW_ROWS", "8192")
    jknobs.reset_conf_defaults()
    monkeypatch.setattr(jh, "_budget_bytes", lambda *a: 100_000)
    monkeypatch.setattr(th, "_budget_bytes", lambda *a: 100_000)
    # the port's knobs as session conf; the reference's from the
    # environment only (its sessions adopt residency conf as process-wide
    # defaults, which would outlive this test)
    conf = {"hyperspace.residency.compression": "off",
            "hyperspace.residency.streaming.windowRows": 8192}
    out = {}
    for pkg, mod in PKGS.items():
        s = senv.session(pkg, **(conf if pkg == "torch" else {}))
        senv.prefetch(pkg, s, columns=("k",))
        table = CACHE[pkg].hbm_cache._tables[0]
        assert table.tier == "streaming" and table.n_windows == 4
        METRICS[pkg].reset()
        owner, attr = (jstream, "_upload_window") if pkg == "jax" else (tstream, "_window_slice")
        real = getattr(owner, attr)
        fired = []

        def lossy(*a, _real=real, _pkg=pkg, **k):
            w = a[-1] if _pkg == "jax" else a[1]
            if w == window and not fired:
                fired.append(w)
                raise RuntimeError("CUDA error: unspecified launch failure")
            return _real(*a, **k)

        monkeypatch.setattr(owner, attr, lossy)
        rows = [_range(senv, s, mod, lo).collect() for lo in (0, 3000)]
        monkeypatch.setattr(owner, attr, real)
        out[pkg] = (rows, _degrade_counts(pkg), table.window_gen,
                    any(t is table for t in CACHE[pkg].hbm_cache._tables))
    for a, b in zip(out["torch"][0], out["jax"][0]):
        assert_same(a, b, ordered=False, keys=["k", "v"])
    assert out["torch"][1:] == out["jax"][1:]
    assert out["torch"][1]["residency.stream.window_failed"] == 1
    assert out["torch"][2:] == (1, False)


def _serve_burst(env, pkg, point, monkeypatch):
    from hyperspace_tpu import serve as jserve
    from hyperspace_tpu_torch import serve as tserve

    serve = jserve if pkg == "jax" else tserve
    mod = PKGS[pkg]
    s = env.session(pkg)
    env.prefetch(pkg, s)
    keys = [3, 70, 700, 1234, 4000, 7999]
    serial = [lookup(env, s, mod, k).collect() for k in keys]
    METRICS[pkg].reset()
    calls = _lossy(monkeypatch, pkg, "block_counts_batch", point)
    server = serve.QueryServer(s, serve.ServeConfig(max_workers=1, batch_max=2,
                                                    autostart=False))
    tickets = [server.submit(lookup(env, s, mod, k)) for k in keys]
    server.start()
    served = [t.result(timeout=60) for t in tickets]
    stats = server.stats()
    server.close()
    monkeypatch.undo()
    assert calls["n"] == point + 1  # no batch after the loss
    for a, b in zip(serial, served):
        assert_same(b, a, ordered=False, keys=["k", "v"])
    tables = CACHE[pkg].hbm_cache.snapshot()["tables"]
    return served, {k: stats[k] for k in ("degraded", "submitted", "completed", "failed",
                                          "batch_dispatches")}, \
        "illegal memory access" in stats["degraded_reason"], _degrade_counts(pkg), tables


@pytest.mark.parametrize("point", range(3))
def test_batch_device_loss_latches_degraded_like_the_reference(env, monkeypatch, point):
    """Six lookups, two a batch: the batched launch dies at batch
    ``point``; the server latches degraded with the error's reason, drops
    the table, re-serves that batch and every later query one by one
    through the per-file route, and no ticket fails."""
    out = {pkg: _serve_burst(env, pkg, point, monkeypatch) for pkg in PKGS}
    for a, b in zip(out["torch"][0], out["jax"][0]):
        assert_same(a, b, ordered=False, keys=["k", "v"])
    assert out["torch"][1:] == out["jax"][1:]
    assert out["torch"][1] == {"degraded": True, "submitted": 6, "completed": 6,
                               "failed": 0, "batch_dispatches": point}
    assert out["torch"][3]["serve.degraded"] == 1 and out["torch"][4] == 0


def test_kernel_build_error_propagates(env, monkeypatch, tmp_path):
    """A kernel library that does not load raises KernelBuildError where it
    loads; no resident arm and no server catches it, nothing drops."""
    bogus = tmp_path / "libk1-bogus.so"
    bogus.write_bytes(b"not a shared library")
    monkeypatch.setattr(tk, "_lib_path", lambda n: (bogus, bogus))
    monkeypatch.setattr(tk, "_LIBS", {})
    with pytest.raises(KernelBuildError, match="does not load"):
        tk.build_kernels((tk.K1,))
    monkeypatch.undo()

    from hyperspace_tpu_torch import serve as tserve

    s = env.session("torch")
    env.prefetch("torch", s)

    def broken(*a, **k):
        raise KernelBuildError("nvcc failed: predicate_mask.cu")

    for attr in ("block_counts_batch", "agg_scan"):
        _patch_cache(monkeypatch, th.hbm_cache, attr, broken)
    tmetrics.reset()
    with pytest.raises(KernelBuildError):
        _range(env, s, PKGS["torch"], 0).collect()
    with pytest.raises(KernelBuildError):
        QUERIES["agg"](env, s, PKGS["torch"]).collect()
    server = tserve.QueryServer(s, tserve.ServeConfig(max_workers=1, autostart=False))
    tickets = [server.submit(lookup(env, s, PKGS["torch"], k)) for k in (3, 70)]
    server.start()
    for t in tickets:
        with pytest.raises(KernelBuildError):
            t.result(timeout=60)
    assert server.stats()["degraded"] is False
    server.close()
    assert th.hbm_cache.snapshot()["tables"] == 1
    assert _degrade_counts("torch") == dict.fromkeys(DEGRADE, 0)


def test_unreachable_card_fails_tickets_at_submit(env, monkeypatch):
    """A probe verdict of False latches the server (serve.degraded once),
    and each ticket submitted then fails with DeviceUnavailableError whose
    text is the probe's reason as the server latched it; the reference
    serves its host engine instead."""
    from hyperspace_tpu_torch import serve as tserve

    s = env.session("torch")
    monkeypatch.setattr(deviceprobe, "_FIRST_TOUCH",
                        {"ok": False, "error": "RuntimeError('no CUDA-capable device')"})
    tmetrics.reset()
    server = tserve.QueryServer(s, tserve.ServeConfig(max_workers=1))
    tickets = [server.submit(lookup(env, s, PKGS["torch"], k)) for k in (3, 70)]
    for t in tickets:
        with pytest.raises(DeviceUnavailableError, match="no CUDA-capable device") as e:
            t.result(timeout=60)
        assert str(e.value) == str(DeviceUnavailableError(deviceprobe.unavailable_reason()))
    stats = server.stats()
    server.close()
    assert stats["degraded"] is True and stats["failed"] == 2
    assert tmetrics.get("serve.degraded") == 1
    # the probe's call sites raise the same error on a CUDA device (K2's
    # caller consults the latch, where the reference's turns to the host's
    # searchsorted), and leave the CPU, asked for, alone
    import torch

    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch.exec import joins

    with pytest.raises(DeviceUnavailableError):
        deviceprobe.require_device("cuda")
    monkeypatch.setattr(ops, "resolve_device", lambda d=None: torch.device("cuda"))
    with pytest.raises(DeviceUnavailableError):
        joins._k2_counts(np.arange(4), np.arange(4), "cuda")
    monkeypatch.undo()
    deviceprobe.require_device("cpu")


@pytest.mark.gpu
def test_probe_and_batch_degrade_on_the_card(env, monkeypatch):
    """On a card: the probe's touch is True, and a batch whose K1b launch
    raises degrades to per-file K1 launches with the same rows."""
    import torch

    from hyperspace_tpu_torch import ops
    from hyperspace_tpu_torch import serve as tserve

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(deviceprobe, "_FIRST_TOUCH", {})
    monkeypatch.setattr(deviceprobe, "_FIRST_TOUCH_DONE", type(deviceprobe._FIRST_TOUCH_DONE)())
    assert deviceprobe.first_device_touch_ok(timeout_s=60.0) is True
    import hyperspace_tpu_torch as hs_torch

    s = hs_torch.HyperspaceSession(hs_torch.HyperspaceConf({
        **env.conf, "hyperspace.torch.device": "cuda", "hyperspace.torch.hbm.mode": "force",
        "hyperspace.torch.hbm.minRows": 1, "hyperspace.torch.hbm.maxBlockFrac": 1.0,
    })).enable_hyperspace()
    assert s.device.type == "cuda"
    env.prefetch("torch", s)
    keys = [3, 70, 700, 1234]
    serial = [lookup(env, s, PKGS["torch"], k).collect() for k in keys]
    _lossy(monkeypatch, "torch", "block_counts_batch", 0)
    ops.reset_launch_counts()
    server = tserve.QueryServer(s, tserve.ServeConfig(max_workers=1, autostart=False))
    tickets = [server.submit(lookup(env, s, PKGS["torch"], k)) for k in keys]
    server.start()
    for t, want in zip(tickets, serial):
        assert_same(t.result(timeout=120), want, ordered=False, keys=["k", "v"])
    assert server.stats()["degraded"] is True
    server.close()
    assert ops.launch_counts() == {ops.K1: len(keys)}  # one file a lookup, no K1b
