"""The port's ``QueryFabric`` (``distributed/fabric.py``) in a job of one
process, on ``make_mesh(8, device="cpu")``, beside the JAX package's on
its 8-device CPU mesh: connect (no process group), placement against the
shared ``owner_of_bucket`` rule and the reference's device order,
``local_buckets``, and ``build_sharded`` (the multi-process build with
P = 1) against both packages' single-controller builds. Mirrors
``tests/test_distributed_fabric.py``. Tolerance: exact.
"""

import numpy as np
import pytest

from hyperspace_tpu.distributed import QueryFabric as JFabric
from hyperspace_tpu.ops.build import build_partition_sharded as j_sharded
from hyperspace_tpu.parallel.mesh import make_mesh as jax_mesh
from hyperspace_tpu.storage.columnar import Column as JC
from hyperspace_tpu.storage.columnar import ColumnarBatch as JB

from hyperspace_tpu_torch.distributed import QueryFabric
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.ops.build import build_partition_sharded as t_sharded
from hyperspace_tpu_torch.parallel.mesh import make_mesh, owner_of_bucket
from hyperspace_tpu_torch.storage.columnar import Column as TC
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB
from hyperspace_tpu_torch.telemetry.metrics import metrics


@pytest.fixture(scope="module")
def fabric():
    return QueryFabric(local_mesh=make_mesh(8, device="cpu")).connect()


def test_fabric_requires_connect():
    f = QueryFabric(local_mesh=make_mesh(8, device="cpu"))
    assert not f.connected
    with pytest.raises(HyperspaceException):
        _ = f.mesh


def _rows_by_bucket(per_device):
    got = {}
    for dev_batch, bucket_ids in per_device:
        for b in np.unique(bucket_ids):
            rows = dev_batch.take(np.flatnonzero(bucket_ids == b))
            got.setdefault(int(b), []).extend(
                zip(rows.columns["k"].data.tolist(), rows.columns["q"].data.tolist(),
                    rows.columns["m"].to_values().tolist()))
    return got


def test_fabric_single_process_build(tmp_path):
    """connect() with no coordinator is the single-process fabric: no
    group, the mesh is the 8 local shards, and build_sharded equals the
    single-controller builds of both packages, row for row."""
    before = metrics.get("mesh.fabric.connected")
    f = QueryFabric(local_mesh=make_mesh(8, device="cpu")).connect()
    assert metrics.get("mesh.fabric.connected") == before + 1
    assert f.connected
    assert (f.mesh.size, f.mesh.process_count) == (8, 1)
    info = f.info()
    assert (info["process_count"], info["process_index"], info["global_devices"]) == (1, 0, 8)

    rng = np.random.default_rng(29)
    n, nb = 2500, 16
    data = {"k": rng.integers(0, 10**9, n).astype(np.int64),
            "q": rng.integers(0, 50, n).astype(np.int64),
            "m": np.array([b"AIR", b"SHIP", b"RAIL"], dtype=object)[rng.integers(0, 3, n)]}

    def batch(C, B):
        return B({"k": C.from_values(data["k"]), "q": C.from_values(data["q"]),
                  "m": C.from_values(data["m"], "string")})

    per_fabric, counts_fabric = f.build_sharded(batch(TC, TB), ["k"], nb,
                                                scratch_dir=tmp_path / ".vocab")
    per_plain, counts_plain = t_sharded(batch(TC, TB), ["k"], nb, make_mesh(8, device="cpu"))
    per_ref, counts_ref = j_sharded(batch(JC, JB), ["k"], nb, jax_mesh(8))
    np.testing.assert_array_equal(counts_fabric, counts_plain)
    np.testing.assert_array_equal(counts_fabric, np.asarray(counts_ref))
    assert int(counts_fabric.sum()) == n
    got = _rows_by_bucket(per_fabric)
    assert got == _rows_by_bucket(per_plain) == _rows_by_bucket(per_ref)


def test_fabric_placement_matches_shared_rule(fabric):
    """Shard and process placement come from the one owner_of_bucket rule,
    and the shard is the reference's device in its mesh's order."""
    ref = JFabric().connect()
    flat = list(ref.mesh.devices.reshape(-1))
    for b in range(32):
        p = fabric.owner_device_of_bucket(b)
        assert p.shard == owner_of_bucket(b, 8) == flat.index(ref.owner_device_of_bucket(b))
        assert p.device == fabric.mesh.local.devices[p.shard]
        assert fabric.owner_process_of_bucket(b) == p.process_index == \
            ref.owner_process_of_bucket(b) == 0


def test_fabric_local_buckets_cover_all_single_process(fabric):
    # one process owns every shard, hence every bucket
    assert fabric.local_buckets(16) == JFabric().connect().local_buckets(16) == list(range(16))
