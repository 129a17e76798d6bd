"""The crash sweep of the port against the JAX package's, on the CPU.

For create, incremental refresh and quick optimize, a clean run under
``RecordingFileSystem`` enumerates the operation log's mutating storage
calls (the same journal in both packages). Then, for each of them, one
baseline tree (built once by the JAX package and copied back to the same
path before each run) is handed to each package in turn, which dies at
that call (``InjectedCrash``, a BaseException: no ``except Exception``
sees it, the file system goes dead as a killed process would) or tears
the metadata overwrite there. The lease clock moves past expiry and each
package recovers its own copy: a fresh session's first listing rolls the
dead writer back. Compared between the packages: the log entries' ids and
states, the doctor's issue kinds and paths relative to the root before
repair, a clean doctor after repair, what re-running the verb does, and
the rows of a query afterwards (which must also equal the source's). A
weather sweep fails every storage call once; the retry layer must carry
each verb to the same final state with the same retry counts. Mirrors
``test_reliability_chaos.py``. Tolerance: exact.
"""

import shutil
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.index import collection_manager as jax_cm
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLog
from hyperspace_tpu.reliability.doctor import doctor as jax_doctor
from hyperspace_tpu.reliability import faults as jax_faults
from hyperspace_tpu.reliability import lease as jax_lease
from hyperspace_tpu.storage import avro_io
from hyperspace_tpu.storage.columnar import ColumnarBatch
from hyperspace_tpu.storage.filesystem import PosixFileSystem as JaxPosix
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.index import collection_manager as torch_cm
from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl as TorchLog
from hyperspace_tpu_torch.reliability.doctor import doctor as torch_doctor
from hyperspace_tpu_torch.reliability import faults as torch_faults
from hyperspace_tpu_torch.reliability import lease as torch_lease
from hyperspace_tpu_torch.storage.filesystem import PosixFileSystem as TorchPosix
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

PKG = {
    "jax": dict(mod=hs_jax, cm=jax_cm, Log=JaxLog, doctor=jax_doctor, faults=jax_faults,
                lease=jax_lease, Posix=JaxPosix),
    "torch": dict(mod=hs_torch, cm=torch_cm, Log=TorchLog, doctor=torch_doctor,
                  faults=torch_faults, lease=torch_lease, Posix=TorchPosix),
}
IDX = "chaos"
KEY = 7
VERBS = ("create", "refresh", "optimize")
# the journal of each verb (op index among all its storage calls, op): the
# lease claim, the transient entry, the final entry, latestStable, the
# lease's release
JOURNAL = [(3, "create_if_absent"), (5, "create_if_absent"), (8, "create_if_absent"),
           (10, "write"), (11, "write")]
OFFSET = {"create": 0, "refresh": 5, "optimize": 6}  # reads before the claim
MUTATING = {v: [(i + OFFSET[v], op) for i, op in JOURNAL] for v in VERBS}


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    return ColumnarBatch.from_pydict({"k": rng.integers(0, 20, n).astype(np.int64),
                                      "v": rng.integers(0, 1000, n).astype(np.int64)})


def _session(pkg, ws):
    values = {"hyperspace.system.path": str(ws / "ix"), "hyperspace.index.numBuckets": 2,
              "hyperspace.reliability.retry.baseDelaySeconds": 0.001,
              "hyperspace.reliability.retry.maxDelaySeconds": 0.002}
    if pkg == "torch":
        values["hyperspace.torch.device"] = "cpu"
    mod = PKG[pkg]["mod"]
    s = mod.HyperspaceSession(mod.HyperspaceConf(values))
    return s, mod.Hyperspace(s)


def _verb(pkg, verb, ws):
    s, h = _session(pkg, ws)
    src = str(ws / "data")
    if verb == "create":
        h.create_index(s.read.avro(src), PKG[pkg]["mod"].IndexConfig(IDX, ["k"], ["v"]))
    elif verb == "refresh":
        h.refresh_index(IDX, "incremental")
    else:
        h.optimize_index(IDX, "quick")


def _baseline(ws, verb):
    """The tree before ``verb``: the source, and for refresh and optimize
    the index and an appended file (and for optimize its refresh)."""
    src = ws / "data"
    src.mkdir(parents=True)
    avro_io.write_avro(src / "part-0.avro", _batch(0, 200))
    if verb == "create":
        return
    _verb("jax", "create", ws)
    avro_io.write_avro(src / "part-1.avro", _batch(3, 80))
    if verb == "optimize":
        _verb("jax", "refresh", ws)


@contextmanager
def _log_fs(pkg, fs):
    """Route the package's collection-manager log managers through ``fs``."""
    cm = PKG[pkg]["cm"].IndexCollectionManager
    orig = cm._log_manager

    def patched(self, name):
        return PKG[pkg]["Log"](self.path_resolver.get_index_path(name), fs=fs,
                               retry_policy=self.conf.retry_policy())

    cm._log_manager = patched
    try:
        yield
    finally:
        cm._log_manager = orig


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One baseline tree per verb, kept aside; ``restore(verb)`` copies it
    back to the one work path every run uses (entries hold absolute
    paths)."""
    root = tmp_path_factory.mktemp("crash")
    ws = root / "ws"
    saved = {}
    for verb in VERBS:
        _baseline(ws, verb)
        saved[verb] = root / f"base-{verb}"
        shutil.copytree(ws, saved[verb])
        shutil.rmtree(ws)

    def restore(verb):
        shutil.rmtree(ws, ignore_errors=True)
        shutil.copytree(saved[verb], ws)
        return ws

    return restore


def test_recorded_journals_match(trees):
    """The enumerated fault points: the same journal in both packages, and
    the one the sweep below is parametrised over."""
    for verb in VERBS:
        got = {}
        for pkg in PKG:
            ws = trees(verb)
            rec = PKG[pkg]["faults"].RecordingFileSystem(PKG[pkg]["Posix"]())
            with _log_fs(pkg, rec):
                _verb(pkg, verb, ws)
            got[pkg] = [(i, op, str(Path(p).relative_to(ws)))
                        for i, (op, p) in enumerate(rec.ops)
                        if op in PKG[pkg]["faults"].MUTATING_OPS]
        assert got["torch"] == got["jax"]
        assert [(i, op) for i, op, _ in got["torch"]] == MUTATING[verb]


def _entries(pkg, ws):
    log = ws / "ix" / IDX / "_hyperspace_log"
    if not log.is_dir():
        return []
    mgr = PKG[pkg]["Log"](ws / "ix" / IDX)
    ids = sorted(int(p.name) for p in log.iterdir() if p.name.isdigit())
    return [(i, mgr.get_log(i).state) for i in ids]


def _issues(report, ws):
    return sorted((i.kind, str(Path(i.path).relative_to(ws)), i.repaired) for i in report.issues)


def _rows(pkg, ws):
    s, _h = _session(pkg, ws)
    mod = PKG[pkg]["mod"]
    q = lambda: s.read.avro(str(ws / "data")).filter(mod.col("k") == KEY).select("k", "v")  # noqa: E731
    s.enable_hyperspace()
    got = q().collect()
    s.disable_hyperspace()
    want = q().collect()
    rows = sorted(got.columns["v"].data.tolist())
    assert rows == sorted(want.columns["v"].data.tolist())
    return rows


def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - compared across packages
        return f"{type(e).__name__}: {e}"


def _crash_and_recover(pkg, verb, ws, rule, monkeypatch):
    P = PKG[pkg]
    fault = P["faults"].FaultInjectingFileSystem(P["Posix"](), [rule])
    with _log_fs(pkg, fault):
        with pytest.raises(P["faults"].InjectedCrash):
            _verb(pkg, verb, ws)
    assert fault.dead
    # the dead writer's lease expires: the clock moves, nothing sleeps
    real_now = P["lease"]._now_ms
    monkeypatch.setattr(P["lease"], "_now_ms", lambda: real_now() + 3_600_000)
    before = _issues(P["doctor"](ws / "ix"), ws)
    _s, h = _session(pkg, ws)
    h.indexes()  # a fresh session's first listing recovers
    recovered = _entries(pkg, ws)
    P["doctor"](ws / "ix", repair=True)
    clean = P["doctor"](ws / "ix").ok
    rerun = _outcome(lambda: _verb(pkg, verb, ws)).replace(str(ws), "<ws>")
    out = (recovered, before, clean, rerun, _entries(pkg, ws), _rows(pkg, ws))
    monkeypatch.undo()
    return out


CASES = [(verb, i, op) for verb in VERBS for i, op in MUTATING[verb]]


@pytest.mark.parametrize("verb,call,op", CASES)
def test_crash_at_every_mutating_call_recovers_alike(trees, monkeypatch, verb, call, op):
    out = {}
    for pkg in PKG:
        ws = trees(verb)
        rule = PKG[pkg]["faults"].FaultRule(kind="crash", op="*", after=call)
        out[pkg] = _crash_and_recover(pkg, verb, ws, rule, monkeypatch)
    assert out["torch"] == out["jax"]
    recovered, _before, clean, _rerun, final, _rows_ = out["torch"]
    assert clean
    assert not recovered or recovered[-1][1] in ("ACTIVE", "DOESNOTEXIST")
    assert final[-1][1] == "ACTIVE"


TORN = [(verb, i) for verb in VERBS for i, op in MUTATING[verb] if op == "write"]


@pytest.mark.parametrize("verb,call", TORN)
def test_torn_overwrite_recovers_alike(trees, monkeypatch, verb, call):
    """Half of a metadata overwrite lands, then the process dies: neither
    package reads the torn bytes as a commit, and both repair alike."""
    out = {}
    for pkg in PKG:
        ws = trees(verb)
        rule = PKG[pkg]["faults"].FaultRule(kind="torn", op="*", after=call)
        out[pkg] = _crash_and_recover(pkg, verb, ws, rule, monkeypatch)
    assert out["torch"] == out["jax"]
    assert out["torch"][2]


@pytest.mark.parametrize("verb", VERBS)
def test_storage_weather_every_call_flakes_once(trees, verb):
    """Every storage call fails once with a transient error: the verb
    commits in both packages, through the same number of retries."""
    out = {}
    for pkg in PKG:
        ws = trees(verb)
        P = PKG[pkg]
        m = jmetrics if pkg == "jax" else tmetrics
        m.reset()
        fault = P["faults"].FaultInjectingFileSystem(
            P["Posix"](), [P["faults"].FaultRule(kind="fail", op="*", every=2)])
        with _log_fs(pkg, fault):
            _verb(pkg, verb, ws)
        retries = m.counter("storage.retry.attempts") if pkg == "jax" else m.get(
            "storage.retry.attempts")
        out[pkg] = (_entries(pkg, ws), retries, P["doctor"](ws / "ix").ok, _rows(pkg, ws))
    assert out["torch"] == out["jax"]
    assert out["torch"][0][-1][1] == "ACTIVE" and out["torch"][1] > 0 and out["torch"][2]
