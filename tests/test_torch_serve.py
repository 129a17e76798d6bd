"""Parity of the port's query server (``hyperspace_tpu_torch/serve/``) with
the JAX package's, on the CPU: paused servers (``autostart=False``: a
burst sits queued before ``start()``, so the first worker's drain is
deterministic), one index tree served by both packages with residency
forced. Batch sizes, dispatches and the ``serve.batch.*`` counters must be
equal between the packages and every ticket's rows equal the same query's
``collect()`` in both. The port's batches run K1b's and K1hb's plain
versions here; ``gpu``-marked tests hold the kernels against them on a
card. Also: the tenancy recurrence, admission, the client's backoff, and
how an error that is no device error (a kernel that cannot build) fails a
batch's tickets (the device-loss degrade: test_torch_device_loss.py). Mirrors ``tests/test_serve.py``,
``test_serve_multitenant.py`` and ``test_batched_join.py``'s serve cases.
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu import serve as jserve
from hyperspace_tpu.exec import hbm_cache as jh
from hyperspace_tpu.serve import tenancy as jten
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

from hyperspace_tpu_torch import serve as tserve
from hyperspace_tpu_torch.exec import hbm_cache as th
from hyperspace_tpu_torch.ops import bitpack, k1b_cases
from hyperspace_tpu_torch.ops import kernels as tk
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.serve import tenancy as tten
from hyperspace_tpu_torch.storage import avro_io
from hyperspace_tpu_torch.storage.columnar import Column, ColumnarBatch
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_aggregate import assert_same
from tests.test_torch_compile import PKGS, QUERIES, _fresh, lookup, make_env  # noqa: F401

SERVE = {"jax": jserve, "torch": tserve}
METRICS = {"jax": jmetrics, "torch": tmetrics}
CACHE = {"jax": jh, "torch": th}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory.mktemp("serve"))


def _count(pkg, name):
    """A counter of either package's registry (the reference's ``counter``,
    the port's ``get``)."""
    return jmetrics.counter(name) if pkg == "jax" else tmetrics.get(name)


def burst(env, make, **server_conf):
    """Each package: the queries ``make(env, session, module)`` collected
    one by one, then submitted to a paused server and served. Returns
    {pkg: (serial results, served results, stats, serve.batch counters)}."""
    out = {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg)
        env.prefetch(pkg, s)
        queries = make(env, s, mod)
        serial = [q.collect() for q in queries]
        METRICS[pkg].reset()
        server = SERVE[pkg].QueryServer(
            s, SERVE[pkg].ServeConfig(max_workers=2, autostart=False, **server_conf))
        tickets = [server.submit(q) for q in queries]
        server.start()
        served = [t.result(timeout=60) for t in tickets]
        stats = server.stats()
        server.close()
        out[pkg] = (serial, served, stats,
                    {k: _count(pkg, k) for k in ("serve.batch.dispatches", "serve.batch.queries",
                                                 "serve.batch.coalesced", "serve.batch.declined")})
    return out


def assert_burst(out, keys):
    for pkg in PKGS:
        serial, served, _stats, _c = out[pkg]
        for a, b in zip(serial, served):
            assert_same(b, a, ordered=False, keys=keys)
    for a, b in zip(out["torch"][1], out["jax"][1]):
        assert_same(a, b, ordered=False, keys=keys)
    for key in ("batch_dispatches", "batched_queries", "batch_size_hist", "completed", "failed"):
        assert out["torch"][2][key] == out["jax"][2][key], key
    assert out["torch"][3] == out["jax"][3]


def test_lookup_burst_coalesces_into_one_dispatch(env):
    keys = [int(k) for k in np.random.default_rng(1).choice(8000, 16, replace=False)]
    out = burst(env, lambda e, s, m: [lookup(e, s, m, k) for k in keys])
    assert_burst(out, ["k", "v"])
    assert out["torch"][2]["batch_size_hist"] == {16: 1}
    assert out["torch"][3]["serve.batch.dispatches"] == 1
    assert out["torch"][3]["serve.batch.queries"] == 16


def test_mixed_burst_batches_only_compatible_queries(env):
    """Lookups, ranges over other columns and an aggregate in one queue:
    each compatible class rides its own launch, the aggregate runs alone."""
    def make(e, s, m):
        qs = [lookup(e, s, m, k) for k in (3, 70, 700)]
        qs += [e.read(s).filter((m.col("k") >= lo) & (m.col("g") < 9)).select("k", "v")
               for lo in (100, 2000, 5000, 7000)]
        qs.append(QUERIES["agg"](e, s, m))
        return qs

    out = burst(env, make)
    for pkg in PKGS:
        serial, served, _s, _c = out[pkg]
        for a, b in zip(serial, served):
            assert_same(b, a, ordered=False, keys=b.column_names)
    for key in ("batch_dispatches", "batched_queries", "batch_size_hist"):
        assert out["torch"][2][key] == out["jax"][2][key], key
    assert out["torch"][2]["batch_size_hist"] == {3: 1, 4: 1}


def test_join_agg_burst_rides_one_region_launch(env):
    """Copies of one aggregate-join over a resident region: one dispatch
    serves the batch (scan.path.resident_join_agg per query)."""
    out = {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg)
        q = QUERIES["join_agg"](env, s, mod)
        q.collect()
        CACHE[pkg].hbm_cache.wait_background()  # the region registered
        want = q.collect()
        METRICS[pkg].reset()
        server = SERVE[pkg].QueryServer(s, SERVE[pkg].ServeConfig(autostart=False))
        tickets = [server.submit(QUERIES["join_agg"](env, s, mod)) for _ in range(4)]
        server.start()
        got = [t.result(timeout=60) for t in tickets]
        stats = server.stats()
        server.close()
        for g in got:
            assert_same(g, want, ordered=False, keys=["k"])
        out[pkg] = (got[0], stats["batch_size_hist"],
                    _count(pkg, "scan.path.resident_join_agg"),
                    _count(pkg, "serve.batch.coalesced"))
    assert_same(out["torch"][0], out["jax"][0], ordered=False, keys=["k"])
    assert out["torch"][1:] == out["jax"][1:] == ({4: 1}, 4, 4)


def test_hybrid_burst_rides_one_launch(tmp_path):
    """Filters over an index whose source gained a file, base and delta
    resident: one batched launch over base, delta and the deletion mask."""
    env = make_env(tmp_path, hybrid=True)
    extra = ColumnarBatch({"k": Column("int64", np.arange(0, 8000, 37)),
                           "v": Column("int64", np.arange(0, 8000, 37) * 3),
                           "g": Column("int64", np.arange(0, 8000, 37) % 40),
                           "d": Column("float64", np.full(217, 1.5))})
    avro_io.write_avro(env.root / "data" / "part-9.avro", extra)
    out = {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg)
        env.prefetch(pkg, s)
        make = [lambda lo=lo: env.read(s).filter((mod.col("k") >= lo) & (mod.col("k") < lo + 300))
                .select("k", "v") for lo in (0, 1000, 3000, 6000)]
        make[0]().collect()  # the delta populates on this miss
        CACHE[pkg].hbm_cache.wait_background()
        serial = [f().collect() for f in make]
        METRICS[pkg].reset()
        server = SERVE[pkg].QueryServer(s, SERVE[pkg].ServeConfig(autostart=False))
        tickets = [server.submit(f()) for f in make]
        server.start()
        served = [t.result(timeout=60) for t in tickets]
        hist = server.stats()["batch_size_hist"]
        server.close()
        for a, b in zip(serial, served):
            assert_same(b, a, ordered=False, keys=["k", "v"])
        out[pkg] = (served, hist, _count(pkg, "scan.path.resident_hybrid"),
                    _count(pkg, "serve.batch.dispatches"))
    for a, b in zip(out["torch"][0], out["jax"][0]):
        assert_same(a, b, ordered=False, keys=["k", "v"])
    assert out["torch"][1:] == out["jax"][1:] == ({4: 1}, 4, 1)


def test_declined_batch_serves_query_by_query(env, monkeypatch):
    """A batched launch that declines (not an error) falls back to each
    query's own path, counted serve.batch.declined, in both packages."""
    for pkg in PKGS:
        # on the class: an undone patch on the instance would leave its
        # bound method there, shadowing later class patches of other tests
        monkeypatch.setattr(type(CACHE[pkg].hbm_cache), "block_counts_batch",
                            lambda *a, **k: None)
    keys = [3, 70, 700]
    out = burst(env, lambda e, s, m: [lookup(e, s, m, k) for k in keys])
    assert_burst(out, ["k", "v"])
    assert out["torch"][3]["serve.batch.declined"] == 1
    assert out["torch"][2]["batch_dispatches"] == 0


def test_device_error_fails_every_ticket_of_the_batch(env, monkeypatch):
    """A batch error that is no device error (a kernel that cannot build)
    fails each of the batch's tickets with that error (serve.batch.error)
    and latches nothing; the server keeps serving. A device error (a
    RuntimeError) degrades instead: tests/test_torch_device_loss.py."""
    from hyperspace_tpu_torch.exceptions import KernelBuildError

    s = env.session("torch")
    env.prefetch("torch", s)

    def boom(*a, **k):
        raise KernelBuildError("nvcc failed: predicate_mask.cu")

    monkeypatch.setattr(th.HbmIndexCache, "block_counts_batch", boom)
    server = tserve.QueryServer(s, tserve.ServeConfig(autostart=False))
    tickets = [server.submit(lookup(env, s, texpr, k)) for k in (3, 70, 700)]
    server.start()
    for t in tickets:
        with pytest.raises(KernelBuildError, match="nvcc failed"):
            t.result(timeout=60)
    monkeypatch.undo()
    assert tmetrics.get("serve.batch.error") == 1
    assert server.stats()["failed"] == 3
    assert server.stats()["degraded"] is False
    assert server.submit(lookup(env, s, texpr, 3)).result(timeout=60).num_rows >= 0
    server.close()


def test_admission_rejects_on_a_full_queue(env):
    for pkg, mod in PKGS.items():
        s = env.session(pkg)
        server = SERVE[pkg].QueryServer(
            s, SERVE[pkg].ServeConfig(max_queue=2, autostart=False))
        server.submit(lookup(env, s, mod, 1))
        server.submit(lookup(env, s, mod, 2))
        with pytest.raises(SERVE[pkg].AdmissionRejected) as e:
            server.submit(lookup(env, s, mod, 3))
        assert e.value.reason == "queue_full" and e.value.queue_depth == 2
        server.close()
        with pytest.raises(SERVE[pkg].ServerClosed):
            server.submit(lookup(env, s, mod, 4))


def test_weighted_fair_dispatch_order_matches():
    """The smooth weighted round-robin: the same tenants, weights and
    backlogs give the same dispatch sequence."""
    order = {}
    for pkg, ten in (("jax", jten), ("torch", tten)):
        tenants = {}
        for name, w in (("a", 1.0), ("b", 3.0), ("c", 0.5)):
            t = ten.TenantState(name, ten.TenantPolicy(weight=w),
                                ten.CircuitBreaker(3, 1.0), 10.0)
            t.queue.extend(range(20))
            tenants[name] = t
        seq = []
        for _ in range(30):
            t = ten.pick_tenant_locked(tenants)
            t.queue.popleft()
            seq.append(t.name)
        order[pkg] = seq
    assert order["torch"] == order["jax"] and order["torch"].count("b") > 15


def test_client_retry_backoff_matches(env):
    """submit_with_retry: the delays it sleeps after two rejections are
    the reference's (deterministic jitter)."""
    sleeps = {}
    for pkg in PKGS:
        mod = SERVE[pkg]

        class Flaky:
            n = 0

            def submit(self, df, deadline_s=None, tenant="default"):
                Flaky.n += 1
                if Flaky.n < 3:
                    raise mod.AdmissionRejected(5, 0.001, tenant=tenant, tenant_depth=5)
                return "ticket"

        got = []
        df = object()
        assert mod.submit_with_retry(Flaky(), df, tenant="t1", sleep=got.append) == "ticket"
        sleeps[pkg] = [round(x, 12) for x in got]
    assert len(sleeps["torch"]) == 2
    # the seed holds the DataFrame's id, so only the policy's envelope is shared
    for a, b in zip(sleeps["torch"], sleeps["jax"]):
        assert 0.0375 <= a <= 0.25 and 0.0375 <= b <= 0.25


def test_session_submit_and_stats_surface(env):
    """session.submit / last_serve_info, and the stats() families an
    operator reads (with a clean Prometheus rendering)."""
    from hyperspace_tpu_torch.telemetry import export

    s = env.session("torch")
    env.prefetch("torch", s)
    ticket = s.submit(lookup(env, s, texpr, 77), tenant="t9")
    assert ticket.result(timeout=60).num_rows >= 0
    assert s.last_serve_info["tenant"] == "t9"
    assert ticket.metrics["counters"].get("compile.run.scan") == 1
    stats = s.serve().stats()
    for key in ("batch_size_hist", "tenants", "overload", "serve_counters", "plan_cache",
                "compile", "result_cache", "join_regions", "residency", "export"):
        assert key in stats, key
    assert stats["tenants"]["t9"]["completed"] == 1 and "latency_p50_ms" in stats
    assert export.check_prometheus(stats["export"]["prometheus"]) == []
    s.serve().close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_session_facade_verbs(env, pkg):
    """Mirrors ``tests/test_serve.py::test_session_facade_verbs`` in each
    package: ``Hyperspace.serve`` is the session's server, options after
    its creation refuse, a closed server is replaced; the facade's
    server answers a lookup with the rows of the same query's collect()."""
    from hyperspace_tpu.exceptions import HyperspaceException as JErr
    from hyperspace_tpu_torch.exceptions import HyperspaceException as TErr

    mod = PKGS[pkg]
    s = env.session(pkg)
    hsp = mod.Hyperspace(s)
    server = s.serve(max_workers=1)
    assert s.serve() is server  # idempotent
    assert hsp.serve() is server
    for verb in (s.serve, hsp.serve):
        with pytest.raises(JErr if pkg == "jax" else TErr):
            verb(max_workers=3)  # options after creation refuse
    q = lookup(env, s, mod, 77)
    want = q.collect()
    assert_same(hsp.serve().submit(q).result(timeout=60), want, ordered=False, keys=["k", "v"])
    server.close()
    # a closed server is replaced on the next serve() call, the facade's too
    fresh = hsp.serve()
    assert fresh is not server and s.serve() is fresh
    fresh.close()


@pytest.mark.gpu
def test_cuda_k1b_and_k1hb_match_plain_versions():
    """K1b and K1hb on the card against their plain versions, exactly: N
    from 1 to 300 programs of different depths, raw, packed and f64
    planes in one batch, widths 1-16, a sub-tile under 1024 rows, and K1hb
    with no mask, every row deleted and random deletions; then the cases
    aimed at the range test (``ops/k1b_cases.py``: constant chunks,
    literals at chunk minima and maxima and one past, the int32 extremes,
    pad rows in resolved chunks, packed widths 1-16 with ref0 below zero,
    deletions of whole and partial chunks) at N = 1, 2, 16, 64 (the
    parameter block) and 300 (staged), under every sub-tile and ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(4)
    B = tk.BLOCK_ROWS
    n = 4 * B
    planes, specs, names = [], [], []
    for bits in range(1, 17):
        lo = -int(rng.integers(0, 900))
        v = rng.integers(lo, lo + (1 << bits), n)
        sp = bitpack.pack_spec(lo, lo + (1 << bits) - 1, n)
        planes.append(torch.from_numpy(bitpack.pack_plain(v, sp)).cuda())
        specs.append(sp)
        names.append(f"p{bits:02d}")
    for i in range(3):  # raw planes (an f64 column's two planes ride raw)
        planes.append(torch.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int32)).cuda())
        specs.append(None)
        names.append(f"r{i}")
    progs = []
    for i in range(300):
        a, b = names[i % len(names)], names[(7 * i + 3) % len(names)]
        e = (texpr.col(a) > int(rng.integers(-900, 900))) | (texpr.col(b) == 0)
        for _ in range(i % 5):
            e = e & ~(texpr.col(names[(i + 5) % len(names)]) < int(rng.integers(-500, 500)))
        progs.append(tk.lower_predicate(tk.narrow_expr_to_i32(e), tuple(names)))
    cpu = [p.cpu() for p in planes]
    for N in (1, 2, 16, 64, 300):
        got = tk.program_block_counts_batch_tensor(progs[:N], planes, specs, n)
        want = tk.program_block_counts_batch_tensor(progs[:N], cpu, specs, n)
        assert torch.equal(got.cpu(), want)
    base = [torch.from_numpy(rng.integers(-99, 99, 3 * B).astype(np.int32)).cuda()
            for _ in range(3)]
    delta = [torch.from_numpy(rng.integers(-99, 99, B).astype(np.int32)).cuda()
             for _ in range(3)]
    hprogs = [tk.lower_predicate(tk.narrow_expr_to_i32(
        (texpr.col("a") < int(x)) & (texpr.col("c") != 3)), ("a", "b", "c"))
        for x in rng.integers(-99, 99, 40)]
    for rows in (None, np.ones(3 * B, bool), rng.random(3 * B) < 0.3):
        words = None if rows is None else torch.from_numpy(tk.pack_row_bitmask(rows)).cuda()
        got = tk.program_hybrid_counts_batch_tensor(hprogs, base, delta, words)
        want = tk.program_hybrid_counts_batch_tensor(
            hprogs, [t.cpu() for t in base], [t.cpu() for t in delta],
            None if words is None else words.cpu())
        assert torch.equal(got.cpu(), want)

    cases = k1b_cases.k1b_range_cases(0)
    n = k1b_cases.N_BLOCKS * B
    for kind in ("raw", "packed"):
        c = cases[kind]
        cpu = [torch.from_numpy(p) for p in c["planes"]]
        planes = [p.cuda() for p in cpu]
        for N in (1, 2, 16, 64, 300):
            want = tk.program_block_counts_batch_tensor(c["progs"][:N], cpu, c["specs"], n)
            for sub, stages in k1b_cases.PLANS[kind]:
                got = tk.program_block_counts_batch_tensor(c["progs"][:N], planes, c["specs"], n,
                                                           sub_rows=sub, stages=stages)
                assert torch.equal(got.cpu(), want), (kind, N, sub, stages)
    h = cases["hybrid"]
    base_cpu = [torch.from_numpy(p) for p in h["base"]]
    delta_cpu = [torch.from_numpy(p) for p in h["delta"]]
    for name in k1b_cases.DELETIONS:
        words = torch.from_numpy(tk.pack_row_bitmask(k1b_cases.deletion_rows(name, h["n_base"])))
        want = tk.program_hybrid_counts_batch_tensor(h["progs"], base_cpu, delta_cpu, words)
        for sub in (None, 2048, 512):
            got = tk.program_hybrid_counts_batch_tensor(
                h["progs"], [t.cuda() for t in base_cpu], [t.cuda() for t in delta_cpu],
                words.cuda(), sub_rows=sub)
            assert torch.equal(got.cpu(), want), (name, sub)
