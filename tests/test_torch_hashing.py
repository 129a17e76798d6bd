"""Bucket-id parity: the port's torch hashing against the JAX package's
host (numpy) and device (jnp) hashing, on the same numpy inputs. Tolerance:
exact — a single differing bucket id would silently break bucketed joins.
"""

import numpy as np
import pytest

from hyperspace_tpu.ops import build as jax_build
from hyperspace_tpu.ops import hashing as jax_hashing
from hyperspace_tpu.storage.columnar import Column as JaxColumn

import torch

from hyperspace_tpu_torch.ops import build as t_build
from hyperspace_tpu_torch.ops import hashing as t_hashing
from hyperspace_tpu_torch.storage.columnar import Column as TColumn

N_BUCKETS = (1, 7, 200, 4096)


def _columns(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    i64 = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    i64[:6] = [0, -1, 1, 2**63 - 1, -(2**63), 2**32]
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45]
    f64 = rng.standard_normal(n) * 1e6
    f64[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324]
    strs = rng.choice(["", "a", "héllo", "TPC-H", "x" * 40], n).astype(object)
    strs[:3] = [None, "", None]
    return {
        "int64": ("int64", i64),
        "int32": ("int32", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)),
        "date32": ("date32", rng.integers(-1000, 20000, n).astype(np.int32)),
        "bool": ("bool", rng.integers(0, 2, n).astype(bool)),
        "float32": ("float32", f32),
        "float64": ("float64", f64),
        "string": ("string", strs),
    }


def _col(mod_col, dtype, values):
    if dtype == "string":
        return mod_col.from_optional_values(list(values))
    return mod_col(dtype, values)


def _torch_bucket_ids(cols, num_buckets):
    arrays, dtypes, vh = {}, {}, {}
    for name, c in cols.items():
        arrays[name] = torch.from_numpy(t_build.encode_for_device(c).copy())
        dtypes[name] = c.dtype_str
        if c.dtype_str == "string":
            vh[name] = torch.from_numpy(t_build.vocab_hashes(c))
    return t_build.device_bucket_ids(arrays, dtypes, list(cols), vh, num_buckets).numpy()


def _jax_device_bucket_ids(cols, num_buckets):
    import jax.numpy as jnp

    arrays, dtypes, vh = {}, {}, {}
    for name, c in cols.items():
        arrays[name] = jnp.asarray(jax_build.encode_for_device(c))
        dtypes[name] = c.dtype_str
        if c.dtype_str == "string":
            vh[name] = jnp.asarray(jax_build.vocab_hashes(c))
    return np.asarray(
        jax_build.device_bucket_ids(arrays, dtypes, list(cols), vh, num_buckets)
    )


@pytest.mark.parametrize("dtype", list(_columns()))
@pytest.mark.parametrize("num_buckets", N_BUCKETS)
def test_single_column_bucket_ids(dtype, num_buckets):
    dt, values = _columns(seed=1)[dtype]
    jcol, tcol = _col(JaxColumn, dt, values), _col(TColumn, dt, values)
    assert np.array_equal(t_hashing.key_repr(tcol), jax_hashing.key_repr(jcol))
    want = jax_hashing.bucket_ids_host([jax_hashing.key_repr(jcol)], num_buckets)
    got = _torch_bucket_ids({"k": tcol}, num_buckets)
    assert np.array_equal(got, want)
    # the reference's own XLA-CPU twin flushes float32 subnormals to zero
    # (its host contract does not), so that one value is held to the host
    keep = np.ones(len(values), dtype=bool)
    if dt == "float32":
        keep = ~((values != 0) & (np.abs(values) < np.finfo(np.float32).tiny))
    dev = _jax_device_bucket_ids({"k": jcol}, num_buckets)
    assert np.array_equal(got[keep], dev[keep])


@pytest.mark.parametrize(
    "names", [("int64", "string"), ("float32", "date32", "bool"), ("float64", "int32", "string", "int64")]
)
def test_multi_column_bucket_ids(names):
    cols = _columns(seed=2)
    jcols = {n: _col(JaxColumn, *cols[n]) for n in names}
    tcols = {n: _col(TColumn, *cols[n]) for n in names}
    want = jax_hashing.bucket_ids_host(
        [jax_hashing.key_repr(c) for c in jcols.values()], 200
    )
    assert np.array_equal(_torch_bucket_ids(tcols, 200), want)


def test_scalar_bucket_of_values_matches():
    for vals, dts in (
        ((7,), ("int64",)),
        ((-0.0,), ("float64",)),
        ((1.5,), ("float32",)),
        (("héllo", 3), ("string", "int32")),
    ):
        assert t_hashing.bucket_of_values(vals, dts, 200) == jax_hashing.bucket_of_values(
            vals, dts, 200
        )


def test_hash32_device_is_uint32_exact():
    rng = np.random.default_rng(5)
    reprs = [rng.integers(-(2**63), 2**63 - 1, 1000, dtype=np.int64) for _ in range(3)]
    want = jax_hashing.hash32_host(reprs).astype(np.int64)
    got = t_hashing.hash32_device([torch.from_numpy(r) for r in reprs]).numpy()
    assert got.dtype == np.int64 and np.array_equal(got, want)
