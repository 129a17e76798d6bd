"""Parity of the port's reliability layer (``hyperspace_tpu_torch/
reliability/``) with the JAX package's, on the CPU: storage retry, writer
leases with epoch fencing, crash recovery, the doctor and its command line.

The same exception list classifies alike; the same policies give the same
delays; one ``FaultRule`` schedule gives the same ``storage.retry.*``
counts. Leases share their on-disk records: a lease written by one package
is read, expired, recovered and fenced by the other over one index tree,
in both directions, and the ``epoch-N`` files of one verb sequence agree
in every field but the owner and the times. Recovery, the doctor's issue
kinds and its repairs agree on the same trees. Lease expiry moves each
package's ``lease._now_ms`` clock; nothing sleeps past a lease. Mirrors
``tests/test_reliability.py`` and ``test_concurrency.py``'s lease cases.
Tolerance: exact.
"""

import json
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu import constants as JC
from hyperspace_tpu import exceptions as jexc
from hyperspace_tpu.config import HyperspaceConf as JaxConf
from hyperspace_tpu.index import collection_manager as jax_cm
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLog
from hyperspace_tpu.reliability import faults as jax_faults
from hyperspace_tpu.reliability import lease as jax_lease
from hyperspace_tpu.reliability import recovery as jax_recovery
from hyperspace_tpu.reliability import retry as jax_retry
from hyperspace_tpu.reliability.doctor import doctor as jax_doctor
from hyperspace_tpu.storage import avro_io
from hyperspace_tpu.storage.columnar import ColumnarBatch
from hyperspace_tpu.storage.filesystem import FakeGcsFileSystem as JaxGcs
from hyperspace_tpu.storage.filesystem import PosixFileSystem as JaxPosix
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch import constants as TC
from hyperspace_tpu_torch import exceptions as texc
from hyperspace_tpu_torch.config import HyperspaceConf as TorchConf
from hyperspace_tpu_torch.index import collection_manager as torch_cm
from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl as TorchLog
from hyperspace_tpu_torch.reliability import faults as torch_faults
from hyperspace_tpu_torch.reliability import lease as torch_lease
from hyperspace_tpu_torch.reliability import recovery as torch_recovery
from hyperspace_tpu_torch.reliability import retry as torch_retry
from hyperspace_tpu_torch.reliability.doctor import doctor as torch_doctor
from hyperspace_tpu_torch.reliability.doctor import main as doctor_main
from hyperspace_tpu_torch.storage.filesystem import FakeGcsFileSystem as TorchGcs
from hyperspace_tpu_torch.storage.filesystem import PosixFileSystem as TorchPosix
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

REPO = Path(__file__).resolve().parent.parent
PKG = {
    "jax": dict(mod=hs_jax, exc=jexc, retry=jax_retry, lease=jax_lease, faults=jax_faults,
                recovery=jax_recovery, doctor=jax_doctor, Log=JaxLog, Posix=JaxPosix,
                Gcs=JaxGcs, cm=jax_cm, metrics=jmetrics),
    "torch": dict(mod=hs_torch, exc=texc, retry=torch_retry, lease=torch_lease,
                  faults=torch_faults, recovery=torch_recovery, doctor=torch_doctor,
                  Log=TorchLog, Posix=TorchPosix, Gcs=TorchGcs, cm=torch_cm, metrics=tmetrics),
}
OTHER = {"jax": "torch", "torch": "jax"}


def _count(pkg, name):
    return jmetrics.counter(name) if pkg == "jax" else tmetrics.get(name)


# ---------------------------------------------------------------------------
# conf, classification, policy
# ---------------------------------------------------------------------------
def test_reliability_keys_and_defaults_match():
    names = [n for n in dir(JC) if n.startswith("RELIABILITY_") or n == "HYPERSPACE_LEASE"]
    assert names and all(getattr(TC, n) == getattr(JC, n) for n in names)
    conf = {JC.RELIABILITY_LEASE_DURATION_SECONDS: "2.5", JC.RELIABILITY_AUTO_RECOVERY: "false",
            JC.RELIABILITY_RETRY_MAX_ATTEMPTS: 7}
    for c in ({}, conf):
        j, t = JaxConf(dict(c)), TorchConf(dict(c))
        assert t.lease_duration_seconds() == j.lease_duration_seconds()
        assert t.auto_recovery_enabled() == j.auto_recovery_enabled()
        assert vars(t.retry_policy()) == vars(j.retry_policy())


def _errors(exc):
    return [exc.TransientStorageError("x"), TimeoutError(), ConnectionResetError(),
            OSError("EIO"), InterruptedError(), exc.PermanentStorageError("x"),
            exc.PreconditionFailedError("x"), FileNotFoundError(), FileExistsError(),
            PermissionError(), IsADirectoryError(), NotADirectoryError(),
            exc.HyperspaceException("x"), exc.LeaseFencedError("x"), ValueError(), KeyError()]


def test_error_classification_matches():
    got = {pkg: [PKG[pkg]["retry"].classify_error(e) for e in _errors(PKG[pkg]["exc"])]
           for pkg in PKG}
    assert got["torch"] == got["jax"]
    assert got["torch"][:5] == ["transient"] * 5 and set(got["torch"][5:]) == {"permanent"}


@pytest.mark.parametrize("attempts,base,cap,jitter", [(5, 0.1, 0.5, 0.25), (4, 0.05, 2.0, 0.0),
                                                     (8, 0.01, 0.3, 0.5)])
def test_retry_delays_match(attempts, base, cap, jitter):
    for key in ("op:/some/path", "write:/x/_hyperspace_log/3", ""):
        want = [jax_retry.RetryPolicy(attempts, base, cap, jitter).delay_for(i, key)
                for i in range(1, attempts + 1)]
        got = [torch_retry.RetryPolicy(attempts, base, cap, jitter).delay_for(i, key)
               for i in range(1, attempts + 1)]
        assert got == want


FAST = dict(max_attempts=4, base_delay_s=0.001, max_delay_s=0.002)


def _retry_trace(pkg, tmp):
    """Calls, results and counters of one FaultRule schedule through the
    retrying file system and call_with_retries."""
    P = PKG[pkg]
    m = P["metrics"]
    m.reset()
    policy = P["retry"].RetryPolicy(**FAST)
    inner = P["faults"].FaultInjectingFileSystem(
        P["Posix"](), [P["faults"].FaultRule(kind="fail", op="read", times=2),
                       P["faults"].FaultRule(kind="fail", op="write", after=1, times=1)])
    fs = P["retry"].RetryingFileSystem(inner, policy)
    out = []
    for i in range(3):
        fs.write(str(tmp / f"f{i}"), b"payload-%d" % i)
    out.append(fs.read(str(tmp / "f1")))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise P["exc"].TransientStorageError("flake")
        return "ok"

    out.append(P["retry"].call_with_retries(flaky, op="t", key="k", policy=policy))
    try:
        P["retry"].call_with_retries(lambda: (_ for _ in ()).throw(
            P["exc"].TransientStorageError("down")), op="t", policy=policy)
    except P["exc"].TransientStorageError:
        out.append("exhausted")
    try:
        P["retry"].call_with_retries(lambda: (_ for _ in ()).throw(
            P["exc"].PermanentStorageError("no")), op="t", policy=policy)
    except P["exc"].PermanentStorageError:
        out.append("permanent")
    names = ["storage.retry.attempts", "storage.retry.read", "storage.retry.write",
             "storage.retry.t", "storage.retry.exhausted"]
    out.append({n: _count(pkg, n) for n in names})
    out.append([op for op, _p in inner.ops])
    return out


def test_retry_counts_under_one_schedule_match(tmp_path):
    got = {}
    for pkg in PKG:
        (tmp_path / pkg).mkdir()
        got[pkg] = _retry_trace(pkg, tmp_path / pkg)
    assert got["torch"] == got["jax"]
    assert got["torch"][4] == {"storage.retry.attempts": 8, "storage.retry.read": 2,
                               "storage.retry.write": 1, "storage.retry.t": 5,
                               "storage.retry.exhausted": 1}


def test_claim_self_win_and_wrap_rules_match():
    got = {}
    for pkg, P in PKG.items():
        class AppliesThenDies(P["Gcs"]):
            died = False

            def create_if_absent(self, path, data, _P=P):
                won = super().create_if_absent(path, data)
                if won and not self.died:
                    self.died = True
                    raise _P["exc"].TransientStorageError("reset after the PUT applied")
                return won

        P["metrics"].reset()
        fs = P["retry"].RetryingFileSystem(AppliesThenDies(), P["retry"].RetryPolicy(**FAST))
        wrapped = P["retry"].wrap_with_retries(P["Posix"]())
        got[pkg] = (fs.create_if_absent("b/o", b"writer-unique"),
                    fs.create_if_absent("b/o", b"another-writer"),
                    _count(pkg, "storage.retry.claim_self_win"),
                    P["retry"].wrap_with_retries(wrapped) is wrapped,
                    fs.supports_generation_preconditions,
                    P["retry"].RetryingFileSystem(P["Posix"]()).supports_generation_preconditions)
    assert got["torch"] == got["jax"] == (True, False, 1, True, True, False)


def test_log_manager_runs_under_retries(tmp_path):
    """Every log RPC goes through the retry wrap: a log manager over a
    file system failing each call once still reads and claims."""
    from tests.test_log_entry import make_entry
    from hyperspace_tpu_torch.index.log_entry import IndexLogEntry

    fault = torch_faults.FaultInjectingFileSystem(
        TorchPosix(), [torch_faults.FaultRule(kind="fail", op="*", every=2)])
    mgr = TorchLog(tmp_path / "idx", fs=fault,
                   retry_policy=torch_retry.RetryPolicy(**FAST))
    e = IndexLogEntry.from_json_dict(make_entry().to_json_dict())
    e.id, e.state = 0, "ACTIVE"
    assert mgr.write_log(0, e) and mgr.create_latest_stable_log(0)
    assert mgr.get_latest_id() == 0 and mgr.get_latest_stable_log().state == "ACTIVE"
    assert isinstance(mgr._fs, torch_retry.RetryingFileSystem)


def test_per_file_reads_retry(tmp_path, monkeypatch):
    """A source read that fails once with a transient error re-reads."""
    from hyperspace_tpu_torch.storage import avro_io as tavro

    src = tmp_path / "a.avro"
    avro_io.write_avro(src, ColumnarBatch.from_pydict({"k": np.arange(5, dtype=np.int64)}))
    real, calls = tavro._read_one, {"n": 0}

    def flaky(p):
        calls["n"] += 1
        if calls["n"] == 1:
            raise TimeoutError("read timed out")
        return real(p)

    monkeypatch.setattr(tavro, "_read_one", flaky)
    tmetrics.reset()
    assert tavro.read_avro([src]).columns["k"].data.tolist() == [0, 1, 2, 3, 4]
    assert tmetrics.get("storage.retry.avro.read") == 1


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------
@contextmanager
def _clock(pkg, offset_ms):
    """Move the package's lease clock by ``offset_ms``."""
    mod = PKG[pkg]["lease"]
    real = mod._now_ms
    mod._now_ms = lambda: real() + offset_ms
    try:
        yield
    finally:
        mod._now_ms = real


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lease_written_by_one_package_is_recovered_and_fenced_by_the_other(tmp_path, writer):
    reader = OTHER[writer]
    idx = tmp_path / "idx"
    W, R = PKG[writer], PKG[reader]
    zombie = W["lease"].LeaseManager(idx, W["Posix"]()).acquire(duration_s=30.0, action="T")
    rmgr = R["lease"].LeaseManager(idx, R["Posix"]())
    cur = rmgr.current()
    assert (cur.epoch, cur.state, cur.action, cur.is_live(), cur.is_abandoned()) == (
        1, "live", "T", True, False)
    with pytest.raises(R["exc"].ConcurrentModificationException):
        rmgr.acquire(duration_s=30.0)  # a live lease of the other package
    zombie._stop.set()  # the writer stalls: no more heartbeats
    zombie._thread.join(5.0)
    with _clock(reader, 60_000):
        assert rmgr.current().is_abandoned()
        recoverer = rmgr.acquire(duration_s=30.0, force=True)
    assert recoverer.epoch == 2
    with pytest.raises(W["exc"].LeaseFencedError):
        zombie.check_fenced()  # epoch 2 exists: the zombie may not commit
    assert W["lease"].LeaseManager(idx, W["Posix"]()).epochs() == [1, 2]
    recoverer.release()
    assert W["lease"].LeaseManager(idx, W["Posix"]()).current().state == "released"
    assert not zombie._thread.is_alive() and not recoverer._thread.is_alive()


def _norm_epoch(raw: bytes) -> str:
    d = json.loads(raw)
    for k in ("owner", "acquiredAtMs", "expiresAtMs"):
        d[k] = "<" + k + ">"
    return json.dumps(d)


def _env(pkg, root, **conf):
    values = {"hyperspace.system.path": str(root / "ix"), "hyperspace.index.numBuckets": 2,
              **conf}
    if pkg == "torch":
        values["hyperspace.torch.device"] = "cpu"
    mod = PKG[pkg]["mod"]
    s = mod.HyperspaceSession(mod.HyperspaceConf(values))
    return s, mod.Hyperspace(s)


def _source(root, n=300, seed=0, name="part-0.avro"):
    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True, exist_ok=True)
    avro_io.write_avro(root / "data" / name, ColumnarBatch.from_pydict(
        {"k": rng.integers(0, 50, n).astype(np.int64),
         "v": rng.integers(0, 1000, n).astype(np.int64)}))


def test_epoch_files_agree_but_for_owner_and_times(tmp_path):
    """One verb sequence per package over the same source: the lease
    directories hold the same epochs with the same bytes once owner and
    times are masked (the key order and every other field included)."""
    got = {}
    for pkg in PKG:
        root = tmp_path / pkg
        _source(root)
        s, h = _env(pkg, root)
        h.create_index(s.read.avro(str(root / "data")), PKG[pkg]["mod"].IndexConfig(
            "lx", ["k"], ["v"]))
        _source(root, 40, 3, "part-1.avro")
        h.refresh_index("lx", "incremental")
        h.delete_index("lx")
        h.restore_index("lx")
        lease_dir = root / "ix" / "lx" / "_hyperspace_lease"
        got[pkg] = {p.name: _norm_epoch(p.read_bytes()) for p in sorted(lease_dir.iterdir())}
        raw = json.loads((lease_dir / "epoch-1").read_bytes())
        assert raw["owner"].split("-")[0] == str(os.getpid())
    assert got["torch"] == got["jax"]
    assert sorted(got["torch"]) == ["epoch-1", "epoch-2", "epoch-3", "epoch-4"]


def test_heartbeat_extends_and_stops_on_release_abort_and_fence():
    got = {}
    for pkg, P in PKG.items():
        mgr = P["lease"].LeaseManager("idx", P["Gcs"]())
        held = mgr.acquire(duration_s=0.15)  # heartbeat every 50 ms
        first = mgr.current().expires_at_ms
        deadline = time.monotonic() + 5.0
        while mgr.current().expires_at_ms == first and time.monotonic() < deadline:
            time.sleep(0.01)
        extended = mgr.current().expires_at_ms > first
        held.release()
        aborted = mgr.acquire(duration_s=30.0)
        aborted.abort()
        zombie = mgr.acquire(duration_s=0.15)
        mgr.acquire(duration_s=30.0, force=True).release()
        deadline = time.monotonic() + 5.0
        while not zombie.fenced and time.monotonic() < deadline:
            time.sleep(0.01)
        zombie._thread.join(5.0)
        got[pkg] = (extended, [mgr.read(e).state for e in mgr.epochs()], zombie.fenced,
                    [t._thread.is_alive() for t in (held, aborted, zombie)])
    assert got["torch"] == got["jax"] == (
        True, ["released", "aborted", "fenced", "released"], True, [False] * 3)


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------
@contextmanager
def _log_fs(pkg, fs):
    cm = PKG[pkg]["cm"].IndexCollectionManager
    orig = cm._log_manager
    cm._log_manager = lambda self, name: PKG[pkg]["Log"](self.path_resolver.get_index_path(name),
                                                         fs=fs)
    try:
        yield
    finally:
        cm._log_manager = orig


def _crashed_create(pkg, root, name="vx"):
    """A create that dies before its final entry (create_if_absent #2)."""
    P = PKG[pkg]
    _source(root)
    s, h = _env(pkg, root)
    fault = P["faults"].FaultInjectingFileSystem(P["Posix"](), [P["faults"].crash_at(
        "create_if_absent", 2)])
    with _log_fs(pkg, fault), pytest.raises(P["faults"].InjectedCrash):
        h.create_index(s.read.avro(str(root / "data")), P["mod"].IndexConfig(name, ["k"], ["v"]))
    return root / "ix" / name


def _states(pkg, idx):
    mgr = PKG[pkg]["Log"](idx)
    ids = sorted(int(p.name) for p in (idx / "_hyperspace_log").iterdir() if p.name.isdigit())
    return [mgr.get_log(i).state for i in ids]


def test_dead_writer_recovers_on_the_next_action(tmp_path):
    got = {}
    for pkg, P in PKG.items():
        root = tmp_path / pkg
        idx = _crashed_create(pkg, root)
        stuck = _states(pkg, idx)
        P["metrics"].reset()
        s, h = _env(pkg, root)
        with _clock(pkg, 120_000):
            h.create_index(s.read.avro(str(root / "data")), P["mod"].IndexConfig(
                "vx", ["k"], ["v"]))
        got[pkg] = (stuck, _states(pkg, idx), _count(pkg, "recovery.auto_rollback"))
    assert got["torch"] == got["jax"] == (
        ["CREATING"], ["CREATING", "CANCELLING", "DOESNOTEXIST", "CREATING", "ACTIVE"], 1)


@pytest.mark.parametrize("crasher", ["jax", "torch"])
def test_session_attach_recovers_the_other_packages_dead_writer(tmp_path, crasher):
    """A listing by a new session of either package heals a create the
    other package died in; before the lease expires it is left alone."""
    healer = OTHER[crasher]
    idx = _crashed_create(crasher, tmp_path)
    _s, h = _env(healer, tmp_path)
    assert [i.name for i in h.indexes()] == ["vx"]  # in flight: untouched
    assert _states(healer, idx) == ["CREATING"]
    PKG[healer]["metrics"].reset()
    with _clock(healer, 120_000):
        _s, h = _env(healer, tmp_path)
        assert [i.name for i in h.indexes()] == []
    assert _states(crasher, idx) == ["CREATING", "CANCELLING", "DOESNOTEXIST"]
    assert _count(healer, "recovery.auto_rollback") == 1


def test_in_process_failure_keeps_manual_cancel(tmp_path, monkeypatch):
    """An action that fails in-process aborts its lease: no auto-recovery,
    however old; cancel() rolls it back."""
    got = {}
    for pkg, P in PKG.items():
        root = tmp_path / pkg
        _source(root)
        s, h = _env(pkg, root)
        h.create_index(s.read.avro(str(root / "data")), P["mod"].IndexConfig("m", ["k"], ["v"]))
        _source(root, 40, 7, "part-x.avro")
        refresh = __import__(f"{P['mod'].__name__}.actions.refresh", fromlist=["x"])
        monkeypatch.setattr(refresh.RefreshIncrementalAction, "op",
                            lambda self: (_ for _ in ()).throw(RuntimeError("failed in-process")))
        with pytest.raises(RuntimeError):
            h.refresh_index("m", "incremental")
        monkeypatch.undo()
        idx = root / "ix" / "m"
        lease = P["lease"].LeaseManager(idx, P["Posix"]()).current().state
        with _clock(pkg, 3_600_000):
            recovered = P["recovery"].maybe_auto_recover(P["Log"](idx), conf=s.conf)
        refused = ""
        try:
            h.refresh_index("m", "full")
        except P["exc"].HyperspaceException as e:
            refused = type(e).__name__
        h.cancel("m")
        got[pkg] = (lease, recovered, refused, _states(pkg, idx))
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == ("aborted", False, "HyperspaceException")
    assert got["torch"][3][-2:] == ["CANCELLING", "ACTIVE"]


def test_forced_cancel_fences_a_stalled_writer(tmp_path):
    """A writer whose heartbeat stopped is overtaken by a forced cancel:
    its _end raises LeaseFencedError, the log stays as the cancel wrote
    it, and lease.fenced_writer_refused counts it."""
    got = {}
    for pkg, P in PKG.items():
        root = tmp_path / pkg
        _source(root)
        s, h = _env(pkg, root)
        h.create_index(s.read.avro(str(root / "data")), P["mod"].IndexConfig("z", ["k"], ["v"]))
        _source(root, 40, 5, "part-1.avro")
        idx = root / "ix" / "z"
        base = __import__(f"{P['mod'].__name__}.actions.refresh", fromlist=["x"])
        dm = __import__(f"{P['mod'].__name__}.index.data_manager", fromlist=["x"])
        action = base.RefreshAction(s, P["Log"](idx), dm.IndexDataManagerImpl(idx))
        action.validate()
        action._begin()
        action._held_lease._stop.set()  # the writer stalls
        action._held_lease._thread.join(5.0)
        h.cancel("z")
        after_cancel = _states(pkg, idx)
        P["metrics"].reset()
        action.op()
        with pytest.raises(P["exc"].LeaseFencedError):
            action._end()
        got[pkg] = (after_cancel, _states(pkg, idx),
                    _count(pkg, "lease.fenced_writer_refused"))
    assert got["torch"] == got["jax"] == (
        ["CREATING", "ACTIVE", "REFRESHING", "CANCELLING", "ACTIVE"],
        ["CREATING", "ACTIVE", "REFRESHING", "CANCELLING", "ACTIVE"], 1)


def test_tmp_sweep_age_guard_matches(tmp_path):
    got = {}
    for pkg, P in PKG.items():
        log_dir = tmp_path / pkg
        log_dir.mkdir()
        (log_dir / ".3.tmp.1.aa").write_bytes(b"x")
        old = log_dir / ".4.tmp.1.bb"
        old.write_bytes(b"x")
        os.utime(old, (time.time() - 300, time.time() - 300))
        got[pkg] = (P["recovery"].sweep_orphan_tmp_files(log_dir), sorted(
            p.name for p in log_dir.iterdir()))
    assert got["torch"] == got["jax"] == ([".4.tmp.1.bb"], [".3.tmp.1.aa"])


def test_serve_submit_consults_recovery(tmp_path):
    """The query server's submit path runs a throttled recovery sweep in
    the background: an index another process died in heals while the
    server serves, and stats() shows the sweep."""
    idx = _crashed_create("jax", tmp_path, name="sv")  # another process died
    _source(tmp_path, 100, 1, "part-1.avro")
    s, h = _env("torch", tmp_path)
    tmetrics.reset()
    with _clock("torch", 120_000):
        server = s.serve(max_workers=1)
        try:
            t = server.submit(s.read.avro(str(tmp_path / "data")).filter(
                hs_torch.col("k") == 3).select("k", "v"))
            assert t.result(timeout=60).num_rows >= 0
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if server.stats()["reliability"]["server_recovery_sweeps"] >= 1:
                    break
                time.sleep(0.02)
            stats = server.stats()
        finally:
            server.close()
    assert _states("torch", idx)[-1] == "DOESNOTEXIST"
    assert stats["reliability"]["server_recovery_sweeps"] >= 1
    assert stats["reliability"]["auto_rollbacks"] == 1
    assert stats["degraded"] is False and stats["degraded_reason"] is None


# ---------------------------------------------------------------------------
# the doctor
# ---------------------------------------------------------------------------
def _litter(idx):
    log_dir = idx / "_hyperspace_log"
    (log_dir / ".2.tmp.9999.deadbeef").write_bytes(b"{}")
    (idx / "v__=7").mkdir()
    (idx / "v__=7" / "stray.tcb").write_bytes(b"x" * 64)
    (log_dir / "latestStable").write_text("{ torn", encoding="utf-8")


_TCB = re.compile(r"-[0-9a-f]{12}\.tcb$")


def _report(pkg, path, root, **kw):
    """(ok, indexes checked, issues) with paths relative to ``root`` and
    index file names without their uuids."""
    r = PKG[pkg]["doctor"](path, **kw)
    return (r.ok, r.indexes_checked,
            sorted((i.kind, _TCB.sub(".tcb", str(Path(i.path).relative_to(root))),
                    i.repairable, i.repaired, i.informational) for i in r.issues))


def test_doctor_reports_and_repairs_alike(tmp_path):
    """The same littered tree (a crashed claim's temp, a torn build's
    version dir, a torn latestStable, superseded lease epochs), doctored
    by each package on its own copy: the same issues, the same repairs, a
    clean rescan."""
    import shutil

    base = tmp_path / "base"
    _source(base)
    s, h = _env("jax", base)
    h.create_index(s.read.avro(str(base / "data")), hs_jax.IndexConfig("d", ["k"], ["v"]))
    _source(base, 40, 5, "part-1.avro")
    h.refresh_index("d", "full")
    _litter(base / "ix" / "d")
    got = {}
    for pkg in PKG:
        root = tmp_path / "ws"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(base, root)
        got[pkg] = (_report(pkg, root / "ix", root), _report(pkg, root / "ix", root, repair=True),
                    _report(pkg, root / "ix" / "d", root),
                    PKG[pkg]["Log"](root / "ix" / "d").get_latest_stable_log().state)
    assert got["torch"] == got["jax"]
    before, _repaired, after, stable = got["torch"]
    assert {k for k, *_ in before[2]} == {"orphan-temp", "orphan-version-dir",
                                          "latest-stable-bad", "stale-lease"}
    assert not before[0] and after == (True, 1, []) and stable == "ACTIVE"


def test_doctor_flags_missing_data_and_stands_down_for_a_live_writer(tmp_path):
    got = {}
    for pkg, P in PKG.items():
        root = tmp_path / pkg
        _source(root)
        s, h = _env(pkg, root)
        h.create_index(s.read.avro(str(root / "data")), P["mod"].IndexConfig("d", ["k"], ["v"]))
        idx = root / "ix" / "d"
        mgr = P["Log"](idx)
        head = mgr.get_latest_log()
        head.state = "REFRESHING"
        assert mgr.write_log(head.id + 1, head)
        held = P["lease"].LeaseManager(idx, P["Posix"]()).acquire(duration_s=60.0)
        (idx / "v__=1").mkdir()
        (idx / "v__=1" / "in-progress.tcb").write_bytes(b"half a build")
        live = _report(pkg, idx, root, repair=True)
        held.release()
        still = (idx / "v__=1" / "in-progress.tcb").exists()
        Path(mgr.get_latest_stable_log().content.files()[0]).unlink()
        got[pkg] = (live, still, _report(pkg, idx, root))
    assert got["torch"] == got["jax"]
    live, still, lost = got["torch"]
    assert live[0] and any(k == "writer-in-flight" for k, *_ in live[2]) and still
    assert not lost[0] and any(k == "missing-data-file" for k, *_ in lost[2])


def test_doctor_command_line(tmp_path, capsys):
    """``python -m hyperspace_tpu_torch.reliability.doctor``: JSON and exit
    codes over a clean tree (0), one with litter (1), the repaired one (0)
    and a bad argument (2), as the reference's script."""
    _source(tmp_path)
    s, h = _env("torch", tmp_path)
    h.create_index(s.read.avro(str(tmp_path / "data")), hs_torch.IndexConfig("c", ["k"], ["v"]))
    idx = tmp_path / "ix" / "c"
    proc = subprocess.run([sys.executable, "-m", "hyperspace_tpu_torch.reliability.doctor",
                           str(idx.parent), "--json"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    clean = json.loads(proc.stdout)
    assert clean["ok"] is True and clean["indexesChecked"] == 1
    (idx / "_hyperspace_log" / ".5.tmp.1.ff").write_bytes(b"{}")
    assert doctor_main([str(idx), "--json"]) == 1
    dirty = json.loads(capsys.readouterr().out)
    assert [i["kind"] for i in dirty["issues"]] == ["orphan-temp"]
    assert doctor_main([str(idx), "--repair"]) == 0
    assert "clean" in capsys.readouterr().out
    assert doctor_main([str(idx), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["issueCount"] == 0
    with pytest.raises(SystemExit) as e:
        doctor_main(["--no-such-flag"])
    assert e.value.code == 2
    # the session and the facade reach the same doctor
    assert s.doctor().ok and hs_torch.Hyperspace(s).doctor(repair=True).ok
