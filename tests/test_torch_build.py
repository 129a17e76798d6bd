"""Build parity: the port's torch build against the JAX package's
``build_partition_single`` (permutation and bucket counts) and
``write_index_data`` (TCB bytes), on the same numpy inputs. Tolerance:
exact.
"""

import numpy as np
import pytest

from hyperspace_tpu.index import builder as jax_builder
from hyperspace_tpu.ops import build as jax_build
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch

from hyperspace_tpu_torch.index import builder as t_builder
from hyperspace_tpu_torch.ops import build as t_build
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TBatch
from hyperspace_tpu_torch.telemetry.metrics import metrics


def _data(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    f32 = rng.integers(-20, 20, n).astype(np.float32) / 4
    f32[::97] = -0.0
    f64 = rng.integers(-20, 20, n).astype(np.float64) / 8
    f64[::89] = -0.0
    return {
        "k64": rng.integers(-(2**40), 2**40, n).astype(np.int64),
        "small": rng.integers(0, 30, n).astype(np.int64),
        "d": rng.integers(8000, 10600, n).astype(np.int32),
        "f32": f32,
        "f64": f64,
        "s": rng.choice(["x", "yy", "zzz", ""], n).astype(object),
        "payload": np.arange(n, dtype=np.int64),
    }


_SCHEMA = {
    "k64": "int64", "small": "int64", "d": "date32", "f32": "float32",
    "f64": "float64", "s": "string", "payload": "int64",
}

# (keys, the port's sort route)
KEY_SETS = [
    (["k64"], "device_radix"),
    (["small", "d"], "device_radix"),
    (["s", "small"], "device_radix"),
    (["f32"], "device_sortfull"),
    (["f64", "small"], "device_sortfull"),
    (["small", "f32", "s"], "device_sortfull"),
]


def _batches(seed=0):
    data = _data(seed=seed)
    return JaxBatch.from_pydict(data, schema=_SCHEMA), TBatch.from_pydict(data, schema=_SCHEMA)


def _same_batch(a, b):
    assert a.column_names == b.column_names
    for n in a.column_names:
        ca, cb = a.columns[n], b.columns[n]
        assert ca.dtype_str == cb.dtype_str
        assert np.array_equal(ca.data.view(np.uint8), cb.data.view(np.uint8)), n
        if ca.vocab is not None:
            assert list(ca.vocab) == list(cb.vocab)


@pytest.mark.parametrize("keys,route", KEY_SETS)
@pytest.mark.parametrize("num_buckets", [1, 8, 200])
def test_build_partition_single_matches(keys, route, num_buckets):
    jb, tb = _batches(seed=num_buckets)
    want, want_counts = jax_build.build_partition_single(jb, keys, num_buckets)
    metrics.reset()
    got, got_counts = t_build.build_partition_single(tb, keys, num_buckets, device="cpu")
    assert metrics.get(f"build.engine.{route}") == 1
    assert np.array_equal(np.asarray(got_counts), np.asarray(want_counts))
    _same_batch(got, want)  # payload = original row id: the permutation


def test_build_partition_single_empty_batch():
    data = {k: v[:0] for k, v in _data().items()}
    got, counts = t_build.build_partition_single(
        TBatch.from_pydict(data, schema=_SCHEMA), ["k64"], 8, device="cpu"
    )
    assert got.num_rows == 0 and counts.tolist() == [0] * 8


@pytest.mark.parametrize("keys", [["k64"], ["s", "small"], ["f32"]])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_write_index_data_bytes_identical(tmp_path, keys, engine):
    jb, tb = _batches(seed=3)
    meta = {"indexName": "ix"}
    jfiles = jax_builder.write_index_data(
        jb, keys, 16, tmp_path / "jax", extra_meta=meta, engine=engine
    )
    tfiles = t_builder.write_index_data(
        tb, keys, 16, tmp_path / "torch", extra_meta=meta, device="cpu"
    )
    by_bucket = lambda fs: {f.name.split("-")[0]: f.read_bytes() for f in fs}  # noqa: E731
    jmap, tmap = by_bucket(jfiles), by_bucket(tfiles)
    assert sorted(jmap) == sorted(tmap) and len(jmap) > 1
    for b in jmap:
        assert jmap[b] == tmap[b], b
