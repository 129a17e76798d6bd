"""Parity of the router's failure domains in the port
(``distributed/health.py``, ``reliability/chaos.py``) with the JAX
package's, on the CPU: the host state machine (healthy, suspect, dead,
probation, readmitted) on an injected clock, the chaos proxy's crash,
flap, slow and stall on an injected clock, and end to end over two real
servers per package (``tests/test_torch_router.py``'s fleet): readmission
of a flapping host, hedges against a slow host, failover under the
remaining deadline budget, the admission retry-after, ``make_router``,
``revive_host`` and ``ping``. Every scenario runs in both packages;
results, states, stats and the ``router.*`` and ``serve.chaos.*``
counters must be equal.

No outcome rests on a wall-clock margin: the flap and chaos schedules
run on an injected clock the test advances, with hedging off
(``hedging=False``) where it is not the subject, a slow host's legs
are withheld on a frozen clock (they complete only once cancelled, so
the hedge wins whatever the load), the hedge delay is pinned at 2.5 s,
25 times or more a healthy leg's wall under load, and the deadline tests
sleep past their budget. Mirrors
``tests/test_router_health.py`` (15 tests). Tolerance: exact.
"""

import time
from types import SimpleNamespace

import pytest

from hyperspace_tpu.distributed import health as jhealth
from hyperspace_tpu.reliability import chaos as jchaos
from hyperspace_tpu.reliability.retry import RetryPolicy as JRetry
from hyperspace_tpu.serve import server as jserver

from hyperspace_tpu_torch.distributed import health as thealth
from hyperspace_tpu_torch.reliability import chaos as tchaos
from hyperspace_tpu_torch.reliability.retry import RetryPolicy as TRetry
from hyperspace_tpu_torch.serve import server as tserver

from tests.test_torch_router import PKG, Fleet, agg_builder, counter, counters, reset

SPLIT = 8_000
HEALTH = {
    "jax": SimpleNamespace(health=jhealth, chaos=jchaos, server=jserver, retry=JRetry),
    "torch": SimpleNamespace(health=thealth, chaos=tchaos, server=tserver, retry=TRetry),
}


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def each(fn):
    """``fn(pkg)`` for both packages from reset counters; their results and
    ``router.*``/``serve.chaos.*`` counters must be equal."""
    out = {}
    for pkg in PKG:
        reset(pkg)
        out[pkg] = (fn(pkg), counters(pkg, ("router.", "serve.chaos.")))
    assert out["torch"] == out["jax"]
    return out["torch"]


# === HealthDirector (injected clock, no servers) ============================
def _director(pkg, **kw):
    h = HEALTH[pkg].health
    clock = Clock()
    policy = h.HealthPolicy(suspect_after=1, dead_after=2, probation_cooldown_s=10.0, **kw)
    return h, h.HealthDirector(["a", "b"], policy=policy, clock=clock), clock


def test_health_lifecycle_dead_probation_readmitted():
    def run(pkg):
        h, d, clock = _director(pkg)
        seen = [d.state("a"), d.admit_leg("a")]
        d.note_failure("a", "lost_hedge")
        seen.append(d.state("a"))
        d.note_failure("a", "lost_hedge")
        seen += [d.state("a"), d.usable("a"), d.admit_leg("a")]
        clock.t += 11.0
        seen += [d.admit_leg("a"), d.state("a"), d.admit_leg("a")]  # one probe at a time
        d.note_success("a", 0.02, probe=True)
        seen += [d.state("a"), d.usable("a"), d.stats()]
        assert any(s["reason"].startswith("router_host_readmitted: a")
                   for s in PKG[pkg].recorder.snapshots())
        return seen

    seen, c = each(run)
    assert seen[:10] == ["healthy", (True, False), "suspect", "dead", False, (False, False),
                         (True, True), "probation", (False, False), "healthy"]
    assert seen[-1]["a"]["readmissions"] == 1 and c["router.health.readmitted"] == 1


def test_health_probe_failure_restarts_the_cooldown():
    def run(pkg):
        h, d, clock = _director(pkg)
        d.mark_dead("b", "closed_in_flight")
        clock.t += 11.0
        seen = [d.admit_leg("b")]
        d.note_failure("b", "closed_in_flight", probe=True)
        seen += [d.state("b"), d.stats()["b"]["probe_failures"], d.admit_leg("b")]
        clock.t += 11.0
        return seen + [d.admit_leg("b")]

    seen, _c = each(run)
    assert seen == [(True, True), "dead", 1, (False, False), (True, True)]


def test_health_success_resets_streak_and_recovers_suspect():
    def run(pkg):
        h, d, _ = _director(pkg)
        d.note_failure("a", "x")
        seen = [d.state("a")]
        d.note_success("a", 0.01)
        seen.append(d.state("a"))
        d.note_failure("a", "x")  # the streak reset: suspect again, not dead
        return seen + [d.state("a")]

    assert each(run)[0] == ["suspect", "healthy", "suspect"]


def test_hedge_delay_is_the_hosts_own_tail_quantile():
    def run(pkg):
        h, d, _ = _director(pkg, hedge_min_samples=4, hedge_min_delay_s=0.001,
                            hedge_max_delay_s=0.5)
        seen = [d.hedge_delay_s("a")]  # no evidence, no hedging
        for lat in (0.010, 0.011, 0.012, 0.200):
            d.note_success("a", lat)
        seen.append(d.hedge_delay_s("a"))  # p95 of 4 samples: the max
        h, d2, _ = _director(pkg, hedge_min_samples=1, hedge_max_delay_s=0.05)
        d2.note_success("a", 3.0)
        return seen + [d2.hedge_delay_s("a")]  # clamped by the ceiling

    assert each(run)[0] == [None, pytest.approx(0.200), pytest.approx(0.05)]


def test_mark_dead_is_idempotent_and_keeps_first_death_time():
    def run(pkg):
        h, d, clock = _director(pkg)
        d.mark_dead("a", "one")
        clock.t += 6.0
        d.mark_dead("a", "two")  # re-marking must NOT restart the cooldown
        clock.t += 5.0  # 11 s after the first death
        return d.admit_leg("a")

    assert each(run)[0] == (True, True)


# === chaos proxy (fake server, injected clock) ==============================
class _FakeTicket:
    def __init__(self, tag):
        self.tag = tag

    def done(self):
        return True

    def result(self, timeout=None):
        return self.tag

    def cancel(self):
        return False


class _FakeServer:
    def __init__(self, pkg, log):
        self._closed, self.log, self.closed_exc = False, log, HEALTH[pkg].server.ServerClosed

    @property
    def session(self):
        return None

    @property
    def closed(self):
        return self._closed

    def submit(self, df, deadline_s=None, tenant="default"):
        if self._closed:
            raise self.closed_exc("fake server closed")
        self.log.append(df)
        return _FakeTicket(df)

    def start(self):
        return self

    def close(self, timeout_s=10.0):
        self._closed = True

    def ping(self):
        if self._closed:
            raise self.closed_exc("fake server closed")
        return {}


def _proxy(pkg, rules, factory=None, clock=None):
    ch = HEALTH[pkg].chaos
    plan = ch.FaultPlan([ch.HostFault(*r[:2], **r[2]) for r in rules])
    return ch.ChaosHostProxy("h", factory or (lambda: _FakeServer(pkg, [])), plan.for_host("h"),
                             **({} if clock is None else {"clock": clock}))


def test_chaos_crash_fires_at_the_scheduled_submission_and_is_replayable():
    def run(pkg):
        closed = HEALTH[pkg].server.ServerClosed
        runs = []
        for _ in range(2):
            proxy = _proxy(pkg, [("crash", "h", {"at_query": 2})])
            seen = []
            for q in range(5):
                try:
                    proxy.submit(f"q{q}")
                    seen.append("ok")
                except closed:
                    seen.append("closed")
            runs.append(seen)
        return runs

    first, second = each(run)[0]
    assert first == second == ["ok", "ok", "closed", "closed", "closed"]


def test_chaos_flap_revives_through_the_factory():
    def run(pkg):
        made, clock = [], Clock()

        def factory():
            made.append(_FakeServer(pkg, []))
            return made[-1]

        proxy = _proxy(pkg, [("flap", "h", {"at_query": 1, "duration_s": 0.05})], factory, clock)
        proxy.submit("q0")
        with pytest.raises(HEALTH[pkg].server.ServerClosed):
            proxy.submit("q1")  # the flap
        seen = [proxy.closed]
        clock.t += 0.08
        seen.append(proxy.closed)  # lazily revived past the outage...
        return seen + [len(made), proxy.submit("q2").result(), proxy.revivals]

    assert each(run)[0] == [True, False, 2, "q2", 1]  # ... through a FRESH server


def test_chaos_slow_and_stall_withhold_real_results():
    def run(pkg):
        clock = Clock()
        proxy = _proxy(pkg, [("slow", "h", {"at_query": 1, "delay_s": 0.08, "times": 1})],
                       clock=clock)
        seen = [proxy.submit("q0").result()]  # before the window: at once
        t1 = proxy.submit("q1")
        seen.append(t1.done())
        with pytest.raises(TimeoutError):
            t1.result(timeout=0.01)
        seen += [t1.result(timeout=1.0), proxy.submit("q2").result()]  # late, then over
        stall = _proxy(pkg, [("stall", "h", {"at_query": 0, "duration_s": 0.06})], clock=clock)
        t = stall.submit("s0")
        return seen + [t.done(), t.result(timeout=1.0)]

    assert each(run)[0] == ["q0", False, "q1", "q2", False, "s0"]


# === end to end over real servers ===========================================
@pytest.fixture
def fleet(tmp_path):
    return Fleet(tmp_path, n=16_000, k_hi=16_000, g_hi=20)


def _sum_count(pkg):
    hs = PKG[pkg].hs
    return hs.agg_sum("v", "sv"), hs.agg_count(None, "n")


def _build(fleet, pkg):
    return agg_builder(fleet, pkg, aggs=_sum_count, split=SPLIT)


def _rows(batch):
    return sorted(zip(*(batch.columns[c].data.tolist() for c in ("g", "sv", "n"))))


def _expected(fleet, pkg, session):
    return _rows(fleet.read(session).group_by("g").agg(*_sum_count(pkg)).collect())


def _server(pkg, session, **cfg):
    s = PKG[pkg].serve
    return s.QueryServer(session, s.ServeConfig(max_workers=2, **cfg))


def _chaos_host(pkg, session, rules, clock):
    ch = HEALTH[pkg].chaos
    plan = ch.FaultPlan([ch.HostFault(kind, "b", **kw) for kind, kw in rules])
    return ch.ChaosHostProxy("b", lambda: _server(pkg, session), plan.for_host("b"), clock=clock)


def _router(pkg, hosts, clock=None, hedging=True, **policy):
    h = HEALTH[pkg]
    router = PKG[pkg].dist.QueryRouter(hosts, health_policy=h.health.HealthPolicy(**policy),
                                       retry_policy=h.retry(max_attempts=3, base_delay_s=0.01,
                                                            max_delay_s=0.1),
                                       hedging=hedging)
    if clock is not None:  # the director on the test's clock
        router.health = h.health.HealthDirector(list(hosts), policy=router.health.policy,
                                                clock=clock)
    return router


def test_router_readmits_flapping_host_with_zero_failed_tickets(fleet):
    """Host b dies mid-burst, is readmitted through a probation probe once
    its replacement is up, then dies AGAIN: 14 queries complete with zero
    failed tickets; readmission shows in counters, health stats and the
    flight recorder. Outage and cooldown run on the test's clock, 0.06 s
    a query; no leg is hedged, so no leg's wall time moves the schedule."""
    def run(pkg, a, b):
        clock = Clock()
        hosts = {"a": _server(pkg, a),
                 "b": _chaos_host(pkg, b, [("flap", {"at_query": 1, "duration_s": 0.2}),
                                           ("flap", {"at_query": 4, "duration_s": 0.2})], clock)}
        router = _router(pkg, hosts, clock, hedging=False,
                         probation_cooldown_s=0.05).start()
        expected = _expected(fleet, pkg, a)
        try:
            for q in range(14):
                got = router.submit(_build(fleet, pkg)).result(timeout=120)
                assert _rows(got) == expected, f"query {q} lost rows"
                clock.t += 0.06
        finally:
            stats = router.stats()
            router.close()
        return stats["health"]["b"], [s["reason"] for s in PKG[pkg].recorder.snapshots()]

    out = {}
    for pkg in PKG:
        reset(pkg)
        out[pkg] = (run(pkg, *fleet.hosts(pkg)), counters(pkg, ("router.", "serve.chaos.")))
    assert out["torch"][0][0] == out["jax"][0][0]
    assert out["torch"][1] == out["jax"][1]
    b, reasons = out["torch"][0]
    assert b["readmissions"] >= 1 and b["deaths"] >= 2  # died, came back, died again
    assert out["torch"][1]["router.health.readmitted"] >= 1
    assert any(r.startswith("router_host_dead: b") for r in reasons)
    assert any(r.startswith("router_host_readmitted: b") for r in reasons)
    assert any(r.startswith("router_host_lost: b") and "survivors=a" in r for r in reasons)


def test_router_hedges_a_slow_host_and_takes_the_first_result(fleet):
    """A slow (not dead) host: once its leg outlives the hedge delay (pinned
    at 2.5 s) the partition is re-issued on the survivor and the winner
    merged. Host b's slow leg is withheld on a frozen clock, so the hedge
    wins whatever the machine's load."""
    def run(pkg, a, b):
        hosts = {"a": _server(pkg, a),
                 "b": _chaos_host(pkg, b, [("slow", {"at_query": 3, "delay_s": 1e9, "times": 1})],
                                  Clock())}
        router = _router(pkg, hosts, hedge_min_samples=2, hedge_min_delay_s=2.5,
                         hedge_max_delay_s=2.5).start()
        expected = _expected(fleet, pkg, a)
        try:
            for q in range(5):  # q == 3 is the slow one on host b
                got = router.submit(_build(fleet, pkg)).result(timeout=120)
                assert _rows(got) == expected, f"query {q} lost rows"
        finally:
            stats = router.stats()
            router.close()
        return stats["hedges_won"], stats["health"]["b"]["state"]

    out = {}
    for pkg in PKG:
        reset(pkg)
        out[pkg] = (run(pkg, *fleet.hosts(pkg)), counters(pkg, ("router.", "serve.chaos.")))
    assert out["torch"] == out["jax"]
    (won, b_state), c = out["torch"]
    assert won == 1 and c["router.hedge.issued"] == c["router.hedge.won"] == 1
    # losing its own hedge is a soft strike: b drifted to suspect, and its
    # next clean leg (q == 4) recovered it
    assert (c["router.health.suspect"], c["router.health.recovered"], b_state) == \
        (1, 1, "healthy")


class _RecordingHost:
    """Duck-typed host that records the deadline every submission
    carries: the seam for the retry-budget assertions."""

    def __init__(self, inner):
        self.inner = inner
        self.deadlines = []

    @property
    def session(self):
        return self.inner.session

    @property
    def closed(self):
        return self.inner.closed

    def submit(self, df, deadline_s=None, tenant="default"):
        self.deadlines.append(deadline_s)
        return self.inner.submit(df, deadline_s=deadline_s, tenant=tenant)

    def start(self):
        self.inner.start()
        return self

    def close(self, timeout_s=10.0):
        self.inner.close(timeout_s)


def _e2e(fleet, run):
    """``run(pkg, a, b)`` in both packages; results and counters equal."""
    out = {}
    for pkg in PKG:
        reset(pkg)
        out[pkg] = (run(pkg, *fleet.hosts(pkg)), counters(pkg, ("router.", "serve.chaos.")))
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_failover_resubmits_with_the_remaining_deadline_budget(fleet):
    """A re-issued leg carries deadline minus elapsed, never the caller's
    full deadline."""
    def run(pkg, a, b):
        rec = _RecordingHost(_server(pkg, a))
        router = _router(pkg, {"a": rec, "b": _server(pkg, b, autostart=False)}).start()
        try:
            router.hosts["b"].close()
            ticket = router.submit(_build(fleet, pkg), deadline_s=30.0)
            time.sleep(0.4)  # burn budget between fan-out and resolution
            assert _rows(ticket.result(timeout=120)) == _expected(fleet, pkg, a)
        finally:
            router.close()
        # submission 0: a's own leg (full deadline), 1: b's failed-over leg
        assert rec.deadlines[0] == pytest.approx(30.0)
        assert 0 < rec.deadlines[1] < 29.6
        return len(rec.deadlines)

    assert _e2e(fleet, run)[0] == 2


def test_failover_raises_once_the_retry_budget_is_spent(fleet):
    def run(pkg, a, b):
        router = _router(pkg, {"a": _server(pkg, a), "b": _server(pkg, b, autostart=False)}).start()
        try:
            router.hosts["b"].close()
            ticket = router.submit(_build(fleet, pkg), deadline_s=0.2)
            time.sleep(0.35)  # the whole budget is gone before resolution
            with pytest.raises(HEALTH[pkg].server.DeadlineExceeded):
                ticket.result(timeout=120)
        finally:
            router.close()
        return counter(pkg, "router.retry.budget_exhausted")

    assert _e2e(fleet, run)[0] == 1


class _RejectOnceHost(_RecordingHost):
    """The first failed-over submission is rejected with a retry_after the
    router must honour; the retry then succeeds."""

    def __init__(self, inner, rejected):
        super().__init__(inner)
        self.rejected = rejected
        self.rejections_left = 0

    def submit(self, df, deadline_s=None, tenant="default"):
        if self.rejections_left > 0:
            self.rejections_left -= 1
            raise self.rejected(queue_depth=1, retry_after_s=0.05, tenant=tenant,
                                reason="queue_full")
        return super().submit(df, deadline_s=deadline_s, tenant=tenant)


def test_failover_honors_admission_retry_after_instead_of_stampeding(fleet):
    def run(pkg, a, b):
        rej = _RejectOnceHost(_server(pkg, a), HEALTH[pkg].server.AdmissionRejected)
        router = _router(pkg, {"a": rej, "b": _server(pkg, b, autostart=False)}).start()
        try:
            router.hosts["b"].close()
            ticket = router.submit(_build(fleet, pkg))
            rej.rejections_left = 1  # reject exactly the failed-over leg
            assert _rows(ticket.result(timeout=120)) == _expected(fleet, pkg, a)
        finally:
            router.close()
        return counter(pkg, "router.retry.admission_wait"), counter(pkg, "router.retried")

    assert _e2e(fleet, run)[0] == (1, 1)


def test_fabric_make_router_stands_up_the_health_directed_front(fleet):
    def run(pkg, a, b):
        h = HEALTH[pkg]
        fabric = PKG[pkg].dist.QueryFabric()
        router = fabric.make_router(
            {"a": a, "b": b}, serve_config=PKG[pkg].serve.ServeConfig(max_workers=2),
            health_policy=h.health.HealthPolicy(probation_cooldown_s=0.05),
            hedging=False).start()
        try:
            assert _rows(router.submit(_build(fleet, pkg)).result(timeout=120)) == \
                _expected(fleet, pkg, a)
            assert router._hedging is False  # the fabric passes hedging through
            return sorted(router.stats()["health"])
        finally:
            router.close()

    assert _e2e(fleet, run)[0] == ["a", "b"]


def test_revive_host_swaps_a_restarted_server_in(fleet):
    """revive_host offers a fresh server for a dead name; the next fan-out
    probes it (ping, then the leg) and readmits it on success, despite a
    30 s cooldown."""
    def run(pkg, a, b):
        router = _router(pkg, {"a": _server(pkg, a), "b": _server(pkg, b)},
                         probation_cooldown_s=30.0).start()
        expected = _expected(fleet, pkg, a)
        try:
            router.hosts["b"].close()
            with pytest.raises(HEALTH[pkg].server.ServerClosed):
                router.hosts["b"].ping()
            assert _rows(router.submit(_build(fleet, pkg)).result(timeout=120)) == expected
            seen = [router.health.state("b")]
            fresh = _server(pkg, b)
            assert fresh.ping() == {"workers": 2, "queue_depth": 0}
            router.revive_host("b", fresh)
            assert _rows(router.submit(_build(fleet, pkg)).result(timeout=120)) == expected
            return seen + [router.health.state("b")]
        finally:
            router.close()

    assert _e2e(fleet, run)[0] == ["dead", "healthy"]
