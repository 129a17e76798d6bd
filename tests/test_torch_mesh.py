"""The port's bucket mesh (``hyperspace_tpu_torch/parallel/mesh.py``)
against the JAX package's: the placement rule in its three forms, the
single-controller process info, and the collectives: ``all_to_all`` over
random blocks against ``lax.all_to_all`` under ``shard_map`` on the
8-device CPU mesh, ``all_reduce`` against ``psum``/``pmin``/``pmax``.
Same numpy inputs on both sides; exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec

from hyperspace_tpu.parallel import mesh as jmesh
from hyperspace_tpu.utils.jaxcompat import shard_map

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch import constants as C
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.parallel import mesh as tmesh

D = 8


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(D)


def test_make_mesh_on_one_device():
    m = tmesh.make_mesh(D, device="cpu")
    assert m.size == D
    assert m.devices == (torch.device("cpu"),) * D and m.device_type == "cpu"
    assert tmesh.make_mesh(device="cpu").size == 1


def test_make_mesh_without_cards_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(ValueError):
        tmesh.make_mesh(2)
    with pytest.raises(HyperspaceException):
        tmesh.make_mesh(2, device="cuda:0")


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_owner_of_bucket_forms_agree(n_devices):
    buckets = np.arange(0, 401, dtype=np.int64)
    want = np.array([jmesh.owner_of_bucket(int(b), n_devices) for b in buckets])
    assert [tmesh.owner_of_bucket(int(b), n_devices) for b in buckets] == want.tolist()
    assert np.array_equal(tmesh.owner_of_bucket_array(buckets, n_devices), want)
    assert np.array_equal(jmesh.owner_of_bucket_array(buckets, n_devices), want)
    got = tmesh.owner_of_bucket_device(torch.from_numpy(buckets), n_devices).numpy()
    assert np.array_equal(got, want)


def test_process_info_single_controller():
    info = tmesh.process_info()
    assert (info["process_index"], info["process_count"]) == (0, 1)
    ref = jmesh.process_info()
    assert (ref["process_index"], ref["process_count"]) == (0, 1)


def _jax_all_to_all(blocks: np.ndarray, mesh) -> np.ndarray:
    """The reference's exchange: each shard's (D, cap, ...) block through
    lax.all_to_all(split 0, concat 0, untiled), then its reshape."""
    axis = mesh.axis_names[0]

    def shard_fn(x):
        x = x.reshape(x.shape[1:])
        out = lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)
        return out.reshape((1, -1) + x.shape[2:])

    fn = jax.jit(shard_map(shard_fn, mesh=mesh, in_specs=(PartitionSpec(axis),),
                           out_specs=PartitionSpec(axis)))
    sh = NamedSharding(mesh, PartitionSpec(axis))
    return np.asarray(fn(jax.device_put(blocks, sh)))


@pytest.mark.parametrize("shape,dtype", [((5,), np.int64), ((3,), np.int32),
                                         ((4, 2), np.float64), ((6,), np.bool_)])
def test_all_to_all_matches_lax(jax_mesh, shape, dtype):
    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    blocks = rng.integers(-1000, 1000, (D, D) + shape).astype(dtype)
    want = _jax_all_to_all(blocks, jax_mesh)  # (D, D * cap, ...)
    m = tmesh.make_mesh(D, device="cpu")
    got = tmesh.all_to_all([torch.from_numpy(blocks[s]) for s in range(D)], m)
    assert len(got) == D
    for d in range(D):
        assert got[d].device == m.devices[d]
        assert np.array_equal(got[d].numpy(), want[d].reshape((D * shape[0],) + shape[1:]))


def test_all_to_all_checks_its_blocks():
    m = tmesh.make_mesh(4, device="cpu")
    with pytest.raises(HyperspaceException):
        tmesh.all_to_all([torch.zeros(4, 2)] * 3, m)


@pytest.mark.parametrize("op,jop", [("sum", lax.psum), ("min", lax.pmin), ("max", lax.pmax)])
def test_all_reduce_matches_lax(jax_mesh, op, jop):
    rng = np.random.default_rng(7)
    parts = rng.integers(-50, 50, (D, 9)).astype(np.int64)
    axis = jax_mesh.axis_names[0]
    fn = jax.jit(shard_map(lambda x: jop(x, axis), mesh=jax_mesh,
                           in_specs=(PartitionSpec(axis),), out_specs=PartitionSpec(axis)))
    want = np.asarray(fn(jax.device_put(jnp.asarray(parts), NamedSharding(
        jax_mesh, PartitionSpec(axis)))))
    m = tmesh.make_mesh(D, device="cpu")
    got = tmesh.all_reduce([torch.from_numpy(parts[s]) for s in range(D)], op, m)
    for d in range(D):
        assert np.array_equal(got[d].numpy(), want[d])
    with pytest.raises(HyperspaceException):
        tmesh.all_reduce([torch.from_numpy(p) for p in parts], "mean", m)


def test_session_holds_the_mesh_and_checks_its_kind(tmp_path):
    conf = {"hyperspace.system.path": str(tmp_path), "hyperspace.torch.device": "cpu",
            C.TPU_DISTRIBUTED_MIN_ROWS: 7}
    m = tmesh.make_mesh(4, device="cpu")
    s = hs_torch.HyperspaceSession(HyperspaceConf(dict(conf)), mesh=m)
    assert s.mesh is m
    assert s.conf.distributed_min_rows() == 7
    assert hs_torch.HyperspaceSession(HyperspaceConf(dict(conf))).mesh is None

    class CudaMesh:
        device_type = "cuda"
        size = 2

    with pytest.raises(HyperspaceException, match="mesh"):
        hs_torch.HyperspaceSession(HyperspaceConf(dict(conf)), mesh=CudaMesh())


def test_executor_counts_a_one_shard_mesh_as_none():
    from hyperspace_tpu_torch.exec.executor import Executor

    assert Executor("cpu", mesh=tmesh.make_mesh(1, device="cpu")).mesh is None
    ex = Executor("cpu", mesh=tmesh.make_mesh(2, device="cpu"), dist_min_rows=5)
    assert ex.mesh.size == 2 and ex.dist_min_rows == 5
    assert Executor("cpu").dist_min_rows == C.TPU_DISTRIBUTED_MIN_ROWS_DEFAULT
