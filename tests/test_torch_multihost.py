"""The port's multi-process sharded build (``ops/build.py:
build_partition_sharded_multihost`` through ``QueryFabric``): two real OS
processes, four CPU shards each, one ``gloo`` group through a ``file://``
store, one global 8-shard mesh. Each process feeds ONLY its own rows
(``tests/torch_mh_build_worker.py``, which imports only the port) and
writes ONLY the buckets its shards own; the union of the files must equal
the JAX package's single-process ``build_partition_sharded`` on its
8-device CPU mesh over the whole table: global counts exactly, each
bucket's rows as a sorted multiset, each file's keys non-decreasing.
Mirrors ``tests/test_multihost.py`` (there ``xfail``: ``jax.distributed``'s
rendezvous does not complete in this container; a gloo group does), with
cases for differing string dictionaries, negative keys in one process
only, a process with no rows, and processes that bring different shard
counts. The gpu-marked case runs 2 processes x 2 cards on NCCL against
the port's CPU single-controller build. Tolerance: exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hyperspace_tpu.ops import build as jbuild
from hyperspace_tpu.parallel.mesh import make_mesh as jax_mesh
from hyperspace_tpu.storage.columnar import Column as JC
from hyperspace_tpu.storage.columnar import ColumnarBatch as JB

from hyperspace_tpu_torch.ops import build as tbuild
from hyperspace_tpu_torch.parallel import mesh as tmesh
from hyperspace_tpu_torch.storage import layout
from hyperspace_tpu_torch.storage.columnar import Column as TC
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB

from tests import torch_mh_build_worker as worker

REPO = Path(__file__).resolve().parent.parent


def _run_workers(tmp_path, case, device="cpu", local_shards=4, backend="gloo", nproc=2):
    """Both workers at once (they meet in the group); returns their exit
    codes, logs and output directory. A worker left running is killed."""
    out = tmp_path / "out"
    out.mkdir()
    env = {**os.environ,
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    args = [str(tmp_path / "pg_init"), str(out), case, device, str(local_shards), backend]
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_mh_build_worker.py"),
                               str(pid), str(nproc)] + args,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid in range(nproc)]
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=120)
            logs.append(stdout.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], "\n".join(logs), out


def _whole(case, pkg):
    t = worker.table(case)
    C, B = (JC, JB) if pkg == "jax" else (TC, TB)
    return B({"orderkey": C.from_values(t["orderkey"]), "qty": C.from_values(t["qty"]),
              "mode": C.from_values(t["mode"], "string")})


def _rows(batch, bucket_ids=None, bucket=None):
    rows = batch if bucket is None else batch.take(np.flatnonzero(bucket_ids == bucket))
    return list(zip(rows.columns["orderkey"].data.tolist(), rows.columns["qty"].data.tolist(),
                    rows.columns["mode"].to_values().tolist()))


def _by_bucket(per_shard, ordered=False):
    got = {}
    for batch, bucket_ids in per_shard:
        for b in np.unique(bucket_ids):
            got.setdefault(int(b), []).extend(_rows(batch, bucket_ids, b))
    return got if ordered else {b: sorted(v) for b, v in got.items()}


def _files(out):
    """{bucket: rows in file order} of the workers' files; each file's keys
    must not decrease."""
    got = {}
    for f in sorted(out.glob("*.tcb")):
        fb = layout.read_batch(f)
        keys = fb.columns["orderkey"].data
        assert np.all(keys[1:] >= keys[:-1]), f.name
        got[layout.bucket_of_file(f)] = _rows(fb)
    return got


def _check_workers(out, nproc, D, want_counts):
    L = D // nproc
    for pid in range(nproc):
        rec = json.loads((out / f"counts-{pid}.json").read_text())
        assert rec["global_counts"] == [int(c) for c in want_counts], pid
        assert all((b % D) // L == pid for b in rec["buckets"]), (pid, rec["buckets"])


@pytest.mark.parametrize("case", ["base", "vocab", "negative", "empty"])
def test_two_process_build_matches_single(tmp_path, case):
    """2 processes x 4 CPU shards against the reference's single-process
    build on its 8-device mesh: global counts exact, each bucket's rows as
    a sorted multiset, only the owner's buckets written by each worker."""
    rcs, log, out = _run_workers(tmp_path, case)
    assert rcs == [0, 0], log
    want, want_counts = jbuild.build_partition_sharded(
        _whole(case, "jax"), ["orderkey"], worker.NUM_BUCKETS, jax_mesh(8))
    _check_workers(out, 2, 8, np.asarray(want_counts))
    got = {b: sorted(v) for b, v in _files(out).items()}
    assert got == _by_bucket(want)
    assert sum(len(v) for v in got.values()) == worker.TOTAL
    if case == "vocab":  # the union of {AIR, SHIP, RAIL} and {RAIL, MAIL, TRUCK}
        modes = {m for rows in got.values() for _k, _q, m in rows}
        assert modes == {m.decode() for m in worker.MODES}


def test_mismatched_local_shards_raise(tmp_path):
    """Processes that bring different shard counts (4 and 3) both refuse
    at connect, before any build."""
    rcs, log, out = _run_workers(tmp_path, "mismatch")
    assert rcs == [3, 3], log
    assert log.count("Every process must bring the same number of local shards") == 2, log
    assert not list(out.glob("*.tcb"))


@pytest.mark.parametrize("case", ["lost", "astray"])
def test_lost_or_astray_rows_raise_on_every_process(tmp_path, case):
    """Rows the exchange drops (each source shard's first) or sends to
    another shard than the host counted (an owner map shifted by one) fail
    the build on every process, with nothing written: the valid rows each
    shard received, summed over the group, are held against the rows sent
    and each shard's agreed receive count."""
    rcs, log, out = _run_workers(tmp_path, case)
    assert rcs == [3, 3], log
    assert log.count("Multihost shuffle lost rows") == 2, log
    assert not list(out.glob("*.tcb"))


def test_single_process_mesh_is_local(tmp_path):
    """Without a group the global mesh is process 0 of 1: its collectives
    are the local ones and the multi-process build is the single-
    controller build, row for row."""
    local = tmesh.make_mesh(4, device="cpu")
    m = tmesh.ProcessMesh(local)
    assert (m.process_index, m.process_count, m.size, m.local_size) == (0, 1, 4, 4)
    assert list(m.local_shards()) == [0, 1, 2, 3]
    assert m.consensus([3, -2], "max") == [3, -2]
    assert tmesh.process_info(local) == {"process_index": 0, "process_count": 1,
                                         "local_devices": 4, "global_devices": 4}
    whole = _whole("vocab", "torch")
    got, got_counts = tbuild.build_partition_sharded_multihost(whole, ["orderkey"], 16, m,
                                                                   scratch_dir=tmp_path)
    want, want_counts = tbuild.build_partition_sharded(whole, ["orderkey"], 16, local)
    assert np.array_equal(got_counts, want_counts)
    assert _by_bucket(got, ordered=True) == _by_bucket(want, ordered=True)


@pytest.mark.gpu
def test_two_process_build_across_cards(tmp_path):
    """On four cards: 2 processes x 2 cards on NCCL, exact against the
    port's single-controller build on a 4-shard CPU mesh (rows in order
    within each bucket)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    rcs, log, out = _run_workers(tmp_path, "vocab", device="cuda", local_shards=2,
                                 backend="nccl")
    assert rcs == [0, 0], log
    want, want_counts = tbuild.build_partition_sharded(
        _whole("vocab", "torch"), ["orderkey"], worker.NUM_BUCKETS,
        tmesh.make_mesh(4, device="cpu"))
    _check_workers(out, 2, 4, want_counts)
    assert _files(out) == _by_bucket(want, ordered=True)
