"""Parity of the port's tracing and telemetry (``telemetry/trace.py``,
``recorder.py``, ``export.py``, the scoped registries of ``metrics.py``)
with the JAX package's, on the CPU: the span tree a collect() records,
the flight recorder's rings and snapshots, the Prometheus and JSON-lines
renderings of the same recordings, and the scoped registries that follow
a context into threads. Mirrors ``tests/test_trace.py`` and
``tests/test_observability.py``. Tolerance: exact.
"""

import json
import threading

import pytest

from hyperspace_tpu.telemetry import export as jexport
from hyperspace_tpu.telemetry import recorder as jrec
from hyperspace_tpu.telemetry import trace as jtrace
from hyperspace_tpu.telemetry.metrics import MetricsRegistry

from hyperspace_tpu_torch.parallel.pool import WorkerPool, run_parallel
from hyperspace_tpu_torch.plan import expr as texpr
from hyperspace_tpu_torch.telemetry import export as texport
from hyperspace_tpu_torch.telemetry import recorder as trec
from hyperspace_tpu_torch.telemetry import trace as ttrace
from hyperspace_tpu_torch.telemetry.metrics import Metrics, metrics as tmetrics

from tests.test_torch_aggregate import assert_same
from tests.test_torch_compile import PKGS, _fresh, lookup, make_env  # noqa: F401


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory.mktemp("trace"))


def _shape(span):
    """A span tree's names and label keys, without times or values."""
    return (span.name, tuple(sorted(span.labels)), tuple(_shape(c) for c in span.children))


def test_collect_records_the_reference_span_tree(env):
    """A resident lookup's trace, first run (pipeline cache miss: the
    lowering span) and second: the same span tree and label keys."""
    trees = {}
    for pkg, mod in PKGS.items():
        s = env.session(pkg)
        env.prefetch(pkg, s)
        got = []
        for key in (5, 6):
            lookup(env, s, mod, key).collect()
            got.append(_shape(s.last_trace.root))
        assert s.last_pipeline_info["kind"] == "scan"
        assert s.last_query_metrics["counters"]["compile.run.scan"] == 1
        assert s.last_traces(1)[0] is s.last_trace
        trees[pkg] = got
    assert trees["torch"] == trees["jax"]
    names = [n for n, _l, _c in trees["torch"][0][2]]
    assert names == ["plan.optimize", "query.execute"]


def test_tracing_off_clears_the_attribution(env):
    s = env.session("torch", **{"hyperspace.telemetry.tracing": "off"})
    lookup(env, s, texpr, 5).collect()
    assert s.last_trace is None and s.last_pipeline_info is None


def test_failed_query_is_recorded_errored(env):
    s = env.session("torch")
    trec.flight_recorder.reset()
    with pytest.raises(Exception):
        env.read(s).filter(texpr.col("nope") == 1).collect()
    (t,) = trec.flight_recorder.last()
    assert t.root.status == "error" and t.complete


def test_spans_never_cross_threads():
    """Two threads, two traces: each records only its own spans; a copied
    context carries the span, an unrelated thread records nothing."""
    out = {}

    def work(tag):
        with ttrace.start_trace(f"q{tag}") as tr:
            with ttrace.span(f"s{tag}"):
                ttrace.annotate(tag=tag)
            out[tag] = tr

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out[0].spans() == ["q0", "s0"] and out[1].spans() == ["q1", "s1"]
    assert out[1].find("s1").labels == {"tag": 1}
    with ttrace.start_trace("outer") as tr:
        with ttrace.span("parent"):
            run_parallel([lambda: ttrace.span("child").__enter__() and None] * 2, 2)
            threading.Thread(target=lambda: ttrace.annotate(stray=1)).start()
    assert tr.spans().count("child") == 2 and "stray" not in tr.find("parent").labels


def test_scoped_metrics_follow_the_context_into_pool_threads():
    """A scoped registry sees what the pool's workers record for it
    (run_parallel, WorkerPool), nests once per scope, and leaves an
    unrelated scope untouched."""
    with tmetrics.scoped() as outer, tmetrics.scoped() as inner:
        run_parallel([lambda: tmetrics.incr("t.fanout")] * 4, 2)
        pool = WorkerPool(2, "t")
        for _ in range(3):
            pool.submit(lambda: tmetrics.record_time("t.pool", 0.5))
        pool.close()
        tmetrics.observe("t.latency_seconds", 0.02)
    with tmetrics.scoped() as other:
        pass
    assert inner.get("t.fanout") == outer.get("t.fanout") == 4
    assert inner.timings()["t.pool"] == (1.5, 3) == outer.timings()["t.pool"]
    assert inner.report()["histograms"]["t.latency_seconds"]["count"] == 1
    assert other.snapshot() == {}


def _record(m):
    m.incr("serve.shed", 3)
    m.gauge("serve.queue_depth", 7)
    m.record_time("compile.lower", 0.25)
    m.record_time("compile.lower", 0.5)
    m.observe("serve.latency_seconds", 0.004)
    m.observe("serve.latency_seconds", 3.0)
    m.observe("hbm.h2d_bytes", 70_000)


def test_exporters_render_as_the_reference():
    jm, tm = MetricsRegistry(), Metrics()
    _record(jm)
    _record(tm)
    assert texport.render_prometheus(tm) == jexport.render_prometheus(jm)
    assert texport.render_jsonl(tm) == jexport.render_jsonl(jm)
    assert texport.check_prometheus(texport.render_prometheus(tm)) == []
    assert texport.check_prometheus("bad name 1\n") != []


def test_export_to_dir_rotates(tmp_path):
    tm = Metrics()
    _record(tm)
    for _ in range(4):
        texport.export_to_dir(str(tmp_path), rotate_bytes=64, keep=2, registry=tm)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "metrics.jsonl", "metrics.jsonl.1", "metrics.jsonl.2"]


def test_flight_recorder_matches_the_reference():
    """Ring bounds, newest-first reads, snapshots rate-limited per reason
    and rendered with their in-flight traces."""
    dumps = {}
    for name, rec_mod, tr_mod in (("jax", jrec, jtrace), ("torch", trec, ttrace)):
        fr = rec_mod.FlightRecorder(entries=3, snapshots=2)
        for i in range(5):
            t = tr_mod.QueryTrace(f"q{i}", n=i)
            t.finish()
            fr.record(t)
        live = tr_mod.QueryTrace("inflight")
        first = fr.snapshot("shed", extra_traces=[live, None])
        again = fr.snapshot("shed")
        other = fr.snapshot("breaker_open")
        assert first is not None and again is None and other is not None
        d = fr.dump()
        dumps[name] = ([t.root.name for t in fr.last()], d["entries"],
                       [(s["reason"], [t["root"]["name"] for t in s["traces"]],
                         [t["root"]["name"] for t in s["inflight"]]) for s in d["snapshots"]])
    assert dumps["torch"] == dumps["jax"]
    assert dumps["torch"][0] == ["q4", "q3", "q2"]


def test_profile_dir_writes_one_trace_a_query(env, tmp_path):
    """Conf ``hyperspace.tpu.profile.dir`` (the reference's key, where it
    starts ``jax.profiler.trace``): each collect() with it set leaves one
    Chrome trace of the query's execution in the directory, with CPU
    activity on a CPU session; without it, none. Rows are the same either
    way, and the reference's."""
    from hyperspace_tpu import constants as jC
    from hyperspace_tpu_torch import constants as tC

    assert tC.TPU_PROFILE_DIR == jC.TPU_PROFILE_DIR == "hyperspace.tpu.profile.dir"
    prof = tmp_path / "prof"
    plain_s = env.session("torch")
    assert plain_s.conf.profile_dir() is None
    plain = lookup(env, plain_s, texpr, 77).collect()
    assert not prof.exists()
    s = env.session("torch", **{tC.TPU_PROFILE_DIR: str(prof)})
    assert s.conf.profile_dir() == str(prof)
    traced = lookup(env, s, texpr, 77).collect()
    (trace,) = prof.glob("query-*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert events and not any(e.get("cat") == "kernel" for e in events)
    lookup(env, plain_s, texpr, 78).collect()
    assert len(list(prof.glob("query-*.pt.trace.json"))) == 1
    jmod = PKGS["jax"]
    want = lookup(env, env.session("jax"), jmod, 77).collect()
    assert_same(traced, plain, ordered=False, keys=["k", "v"])
    assert_same(traced, want, ordered=False, keys=["k", "v"])


def test_profile_dir_on_a_cuda_session_needs_cuda_activity(tmp_path, monkeypatch):
    """A CUDA session whose torch cannot record CUDA activity refuses to
    profile rather than trace the CPU alone."""
    import torch

    from hyperspace_tpu_torch.dataframe import _query_profile
    from hyperspace_tpu_torch.exceptions import HyperspaceException

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(HyperspaceException, match="CUDA activity"):
        with _query_profile(str(tmp_path / "p"), torch.device("cuda")):
            pass
    assert not (tmp_path / "p").exists()
    with _query_profile(None, torch.device("cuda")) as prof:
        assert prof is None


def test_missing_kernel_records_are_detected():
    """The per-query profiler's check: a trace with more kernel launches on
    the host than kernel records on the device lost records (a copy's
    record on the device is no kernel's)."""
    from types import SimpleNamespace as Ev

    from torch.autograd import DeviceType

    from hyperspace_tpu_torch.dataframe import kernel_records_missing

    launch = Ev(name="cudaLaunchKernel", device_type=DeviceType.CPU)
    kernel = Ev(name="predicate_mask_kernel", device_type=DeviceType.CUDA)
    copy = Ev(name="Memcpy DtoH (Device -> Pageable)", device_type=DeviceType.CUDA)
    host = Ev(name="aten::add", device_type=DeviceType.CPU)
    assert kernel_records_missing([host, launch])
    assert kernel_records_missing([host, launch, copy])
    assert kernel_records_missing([launch, launch, kernel, copy])
    assert not kernel_records_missing([host, launch, kernel, copy])
    assert not kernel_records_missing([host, copy])
