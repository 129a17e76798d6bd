"""Parity of the port's object-store backends with the JAX package on the
CPU: ``FakeGcsFileSystem`` (in memory) and ``GcsFileSystem`` (the JSON-API
client, talking to tests/fake_gcs_server.py on loopback; no network).

Each package runs the same seam calls, operation-log protocol and lease
cycle on its own backend, and the outcomes must be equal; then each
package's log and leases, written through the HTTP client, are read,
claimed over and fenced by the other package on the same server. Mirrors
test_object_store.py and test_gcs_backend.py. Tolerance: exact.
"""

import threading

import numpy as np
import pytest

from hyperspace_tpu.actions import states as jax_states
from hyperspace_tpu.exceptions import LeaseFencedError as JaxFenced
from hyperspace_tpu.exceptions import PreconditionFailedError as JaxPrecondition
from hyperspace_tpu.index.log_entry import IndexLogEntry as JaxEntry
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLog
from hyperspace_tpu.reliability.lease import LeaseManager as JaxLease
from hyperspace_tpu.storage import filesystem as jax_fs
from hyperspace_tpu.storage import gcs as jax_gcs
from hyperspace_tpu.storage import layout as jax_layout
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch

from hyperspace_tpu_torch.exceptions import LeaseFencedError as TorchFenced
from hyperspace_tpu_torch.exceptions import PreconditionFailedError as TorchPrecondition
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry as TorchEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl as TorchLog
from hyperspace_tpu_torch.reliability import retry as torch_retry
from hyperspace_tpu_torch.reliability.lease import LeaseManager as TorchLease
from hyperspace_tpu_torch.storage import filesystem as torch_fs
from hyperspace_tpu_torch.storage import gcs as torch_gcs
from hyperspace_tpu_torch.storage import layout as torch_layout

from tests.fake_gcs_server import FakeGcsServer
from tests.test_log_entry import make_entry

PKG = {
    "jax": dict(Log=JaxLog, Lease=JaxLease, fs=jax_fs, gcs=jax_gcs, layout=jax_layout,
                Entry=lambda e: e, Precondition=JaxPrecondition, Fenced=JaxFenced),
    "torch": dict(Log=TorchLog, Lease=TorchLease, fs=torch_fs, gcs=torch_gcs,
                  layout=torch_layout,
                  Entry=lambda e: TorchEntry.from_json_dict(e.to_json_dict()),
                  Precondition=TorchPrecondition, Fenced=TorchFenced),
}


@pytest.fixture(scope="module")
def server():
    """One local server for the module; each test writes under its own
    object prefixes."""
    with FakeGcsServer() as srv:
        yield srv


def _backend(pkg, kind, srv):
    if kind == "memory":
        return PKG[pkg]["fs"].FakeGcsFileSystem()
    return PKG[pkg]["gcs"].GcsFileSystem("testbucket", endpoint=srv.endpoint)


def _entry(pkg, id, state):
    e = PKG[pkg]["Entry"](make_entry())
    e.id = id
    e.state = state
    return e


def _seam_trace(fs, precondition, pfx):
    """Every seam answer in order, for one backend, under object prefix
    ``pfx``."""
    fs = _Prefixed(fs, pfx)
    out = [fs.exists("a/b/c")]
    try:
        fs.read("a/b/c")
    except FileNotFoundError:
        out.append("missing")
    out += [fs.create_if_absent("a/b/c", b"first"), fs.create_if_absent("a/b/c", b"second"),
            fs.read("a/b/c")]
    fs.write("a/b/c", b"v2")
    out += [fs.generation("a/b/c"), fs.read("a/b/c", 1, 1), fs.read("a/b/c", 99, 1)]
    fs.write("a/b/d", b"x")
    fs.write("a/zz", b"y")
    out += [fs.list("a/b"), fs.list("a"), fs.size("a/b/c")]
    gen = fs.generation("a/b/c")
    fs.write("a/b/c", b"v3", if_generation_match=gen)
    try:
        fs.write("a/b/c", b"stale", if_generation_match=gen)
    except precondition:
        out.append("refused")
    fs.write("a/new", b"n", if_generation_match=0)
    out.append(fs.read("a/b/c"))
    fs.delete("a/b/c")
    fs.delete("a/b/c")
    out.append(fs.exists("a/b/c"))
    return out


class _Prefixed:
    """A backend seen under an object prefix (one server, two packages)."""

    def __init__(self, fs, pfx):
        self._fs, self._pfx = fs, pfx

    def __getattr__(self, name):
        attr = getattr(self._fs, name)
        if callable(attr):
            return lambda p, *a, **k: attr(self._pfx + p, *a, **k)
        return attr


@pytest.mark.parametrize("kind", ["memory", "http"])
def test_seam_semantics_match(server, kind):
    got = {}
    for pkg in PKG:
        got[pkg] = _seam_trace(_backend(pkg, kind, server), PKG[pkg]["Precondition"],
                               f"{pkg}/")
    assert got["torch"] == got["jax"]
    assert "refused" in got["torch"] and got["torch"][-1] is False


def _log_trace(mgr, entry):
    out = [mgr.get_latest_id(), mgr.write_log(0, entry(0, jax_states.CREATING)),
           mgr.write_log(0, entry(0, jax_states.ACTIVE)), mgr.get_log(0).state,
           mgr.write_log(1, entry(1, jax_states.ACTIVE)), mgr.get_latest_id(),
           mgr.create_latest_stable_log(1), mgr.get_latest_stable_log().id,
           mgr.write_log(2, entry(2, jax_states.REFRESHING)), mgr.get_latest_id()]
    mgr.delete_latest_stable_log()
    out.append(mgr.get_latest_stable_log().id)
    return out


@pytest.mark.parametrize("kind", ["memory", "http"])
def test_log_protocol_matches(server, kind):
    got = {}
    for pkg in PKG:
        mgr = PKG[pkg]["Log"](f"{pkg}/indexes/myidx", fs=_backend(pkg, kind, server))
        got[pkg] = _log_trace(mgr, lambda i, s, p=pkg: _entry(p, i, s))
    assert got["torch"] == got["jax"] == [None, True, False, jax_states.CREATING, True, 1,
                                          True, 1, True, 2, 1]


@pytest.mark.parametrize("kind", ["memory", "http"])
def test_log_claim_once_under_racers(server, kind):
    """Eight racers of each package claim the same id on ONE store: one
    wins, across both packages."""
    fs = {pkg: _backend(pkg, kind, server) for pkg in PKG}
    if kind == "memory":
        fs["jax"] = fs["torch"]  # one in-memory store shared by both
    n = 8
    barrier = threading.Barrier(2 * n)
    results = {}

    def racer(pkg, i):
        mgr = PKG[pkg]["Log"]("b/idx", fs=fs[pkg])
        e = _entry(pkg, 5, jax_states.CREATING)
        e.properties["racer"] = f"{pkg}-{i}"
        barrier.wait()
        results[(pkg, i)] = mgr.write_log(5, e)

    threads = [threading.Thread(target=racer, args=(pkg, i)) for pkg in PKG for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    winners = [k for k, v in results.items() if v]
    assert len(winners) == 1
    for pkg in PKG:
        got = PKG[pkg]["Log"]("b/idx", fs=fs[pkg]).get_log(5).properties["racer"]
        assert got == f"{winners[0][0]}-{winners[0][1]}"


def test_log_written_by_one_package_reads_in_the_other(server):
    """A log and a TCB file written by each package through the HTTP client
    read the same in the other."""
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        wfs = _backend(writer, "http", server)
        rfs = _backend(reader, "http", server)
        root = f"x-{writer}/idx"
        w = PKG[writer]["Log"](root, fs=wfs)
        assert w.write_log(0, _entry(writer, 0, jax_states.CREATING))
        assert w.write_log(1, _entry(writer, 1, jax_states.ACTIVE))
        assert w.create_latest_stable_log(1)
        r = PKG[reader]["Log"](root, fs=rfs)
        assert r.get_latest_id() == 1
        assert r.get_latest_stable_log().to_json_dict() == w.get_latest_stable_log().to_json_dict()
        assert not r.write_log(1, _entry(reader, 1, jax_states.DELETED))  # claimed
        rng = np.random.default_rng(2)
        b = JaxBatch.from_pydict({"k": rng.integers(0, 100, 500).astype(np.int64),
                                  "p": rng.random(500)}, {"k": "int64", "p": "float64"})
        path = f"x-{writer}/v__=0/b00001-abc.tcb"
        if writer == "jax":
            jax_layout.write_batch(path, b, sorted_by=["k"], bucket=1, fs=wfs)
        else:
            from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB

            tb = TB.from_pydict({"k": b.columns["k"].data, "p": b.columns["p"].data},
                                {"k": "int64", "p": "float64"})
            torch_layout.write_batch(path, tb, sorted_by=["k"], bucket=1, fs=wfs)
        back = PKG[reader]["layout"].TcbReader(path, fs=rfs).read(row_range=(100, 200))
        assert np.array_equal(back.columns["k"].data, b.columns["k"].data[100:200])


def test_client_retries_and_self_win_match(server, monkeypatch):
    """Transient 503s retry inside the client; an upload applied before its
    reply was lost is recognized as our own claim; a persistent failure
    raises OSError. Both clients answer alike."""
    got = {}
    for pkg in PKG:
        fs = _backend(pkg, "http", server)
        fs.write(f"{pkg}/x", b"payload")
        server.state.fail_next = 2
        out = [fs.read(f"{pkg}/x")]
        server.state.fail_next = 2
        out.append(fs.create_if_absent(f"{pkg}/y", b"second"))
        real = fs._request

        def lossy(method, url, real=real, **kw):
            status, body = real(method, url, **kw)
            if method == "POST" and "ifGenerationMatch" in url and status != 412:
                if kw.get("retried_out") is not None:
                    kw["retried_out"].append(True)
                return 412, b'{"error": {"message": "conditionNotMet"}}'
            return status, body

        monkeypatch.setattr(fs, "_request", lossy)
        out.append(fs.create_if_absent(f"{pkg}/claims/7", b"mine"))
        monkeypatch.setattr(fs, "_request", real)
        out.append(fs.create_if_absent(f"{pkg}/claims/7", b"other"))
        fs.max_retries = 1
        server.state.fail_next = 10
        try:
            fs.read(f"{pkg}/nope")
        except OSError:
            out.append("oserror")
        server.state.fail_next = 0
        got[pkg] = out
    assert got["torch"] == got["jax"] == [b"payload", True, True, False, "oserror"]
    # the client retries inside: the seam's retry layer does not wrap it
    gcs = torch_gcs.GcsFileSystem("b", endpoint="http://127.0.0.1:1")
    assert torch_retry.wrap_with_retries(gcs) is gcs


def test_lease_generation_fencing_across_packages(server):
    """One package's lease (heartbeating every ~66 ms on generation
    preconditions) is claimed over by the other's forced acquire; the
    zombie's own heartbeat sees the fence and its commit check refuses.
    Both directions, one store."""
    import time

    for zpkg, rpkg in (("jax", "torch"), ("torch", "jax")):
        root = f"leased-{zpkg}"
        zombie = PKG[zpkg]["Lease"](root, _backend(zpkg, "http", server)).acquire(duration_s=0.2)
        rmgr = PKG[rpkg]["Lease"](root, _backend(rpkg, "http", server))
        recoverer = rmgr.acquire(duration_s=30.0, force=True)
        assert recoverer.epoch == zombie.epoch + 1
        deadline = time.monotonic() + 10.0
        while not zombie.fenced and time.monotonic() < deadline:
            time.sleep(0.02)
        assert zombie.fenced
        with pytest.raises(PKG[zpkg]["Fenced"]):
            zombie.check_fenced()
        assert rmgr.read(zombie.epoch).state == "fenced"
        recoverer.release()
        assert PKG[zpkg]["Lease"](root, _backend(zpkg, "http", server)).current().state == "released"
