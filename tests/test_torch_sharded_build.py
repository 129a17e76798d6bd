"""The port's sharded build (``ops/build.py:build_partition_sharded``, the
mesh arms of ``index/builder.py``, the create action and the streaming
writer) against the JAX package's on the 8-device CPU mesh, and against
the port's single-device build.

The same numpy rows, heavy in duplicate keys (ties straddle the shards'
row ranges), with string, float32, float64 (+-inf, -0.0, NaN) and date32
columns, go through both packages at D in {2, 3, 8} (3 does not divide
the bucket counts): the per-shard batches and bucket ids, the global
counts, and the index files byte for byte, matched by bucket. Mirrors
``tests/test_build.py:82,177,186`` and ``tests/test_stream_build.py:310``.
Tolerance: exact.
"""

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.index import builder as jbuilder
from hyperspace_tpu.index import stream_builder as jsb
from hyperspace_tpu.ops import build as jbuild
from hyperspace_tpu.parallel.mesh import make_mesh as jax_mesh
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage.columnar import ColumnarBatch as JB

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.index import builder as tbuilder
from hyperspace_tpu_torch.index import stream_builder as tsb
from hyperspace_tpu_torch.ops import build as tbuild
from hyperspace_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_stream_build import _files_by_slot

SCHEMA = {"k": "int64", "s": "string", "f32": "float32", "f64": "float64", "d": "date32",
          "p": "int64"}


def _table(n=2500, seed=0):
    rng = np.random.default_rng(seed)
    f64 = rng.integers(-8, 8, n).astype(np.float64) / 4
    f64[::37] = -0.0
    f64[5::101] = np.inf
    f64[9::103] = -np.inf
    f64[13::211] = np.nan
    f32 = (rng.integers(-6, 6, n).astype(np.float32) / 2)
    f32[::41] = -0.0
    return {
        "k": rng.integers(0, 30, n).astype(np.int64),  # ~80 rows a key
        "s": rng.choice(["x", "yy", "zzz", ""], n).astype(object),
        "f32": f32,
        "f64": f64,
        "d": rng.integers(8000, 8040, n).astype(np.int32),
        "p": np.arange(n, dtype=np.int64),
    }


def _pair(seed=0, n=2500):
    t = _table(n, seed)
    return JB.from_pydict(t, schema=SCHEMA), TB.from_pydict(t, schema=SCHEMA)


def _same_batch(a, b):
    assert a.column_names == b.column_names
    for n in a.column_names:
        ca, cb = a.columns[n], b.columns[n]
        assert ca.dtype_str == cb.dtype_str
        assert np.array_equal(np.asarray(ca.data).view(np.uint8),
                              np.asarray(cb.data).view(np.uint8)), n
        if ca.vocab is not None:
            assert list(ca.vocab) == list(cb.vocab)


KEYS = [["k"], ["s", "k"], ["f64"], ["f32", "d"]]


@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("D", [2, 3, 8])
def test_build_partition_sharded_matches_reference(keys, D):
    jb, tb = _pair(seed=D)
    nb = 12
    want, want_counts = jbuild.build_partition_sharded(jb, keys, nb, jax_mesh(D))
    got, got_counts = tbuild.build_partition_sharded(tb, keys, nb, torch_mesh(D, device="cpu"))
    assert np.array_equal(np.asarray(got_counts), np.asarray(want_counts))
    assert len(got) == len(want) == D
    for d, ((gb, gbid), (wb, wbid)) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(gbid), np.asarray(wbid)), d
        assert set(np.unique(np.asarray(gbid)) % D) <= {d}
        _same_batch(gb, wb)
    # each bucket's rows are the single-device build's, in its order
    single, counts = tbuild.build_partition_single(tb, keys, nb, device="cpu")
    assert np.array_equal(counts, np.asarray(got_counts))
    offs = np.concatenate([[0], np.cumsum(counts)])
    for gb, gbid in got:
        for b in np.unique(gbid):
            rows = gb.columns["p"].data[gbid == b]
            assert np.array_equal(rows, single.columns["p"].data[offs[b]:offs[b + 1]])


def test_build_partition_sharded_small_and_empty_shards():
    """Fewer rows than shards: most source ranges are empty, as are most
    destinations."""
    jb, tb = _pair(seed=3, n=5)
    want, wc = jbuild.build_partition_sharded(jb, ["k"], 200, jax_mesh(8))
    got, gc = tbuild.build_partition_sharded(tb, ["k"], 200, torch_mesh(8, device="cpu"))
    assert np.array_equal(np.asarray(gc), np.asarray(wc))
    for (gb, gbid), (wb, wbid) in zip(got, want):
        assert np.array_equal(np.asarray(gbid), np.asarray(wbid))
        _same_batch(gb, wb)


def _write(pkg, root, batch, keys, nb, mesh=None, **kw):
    mod = jbuilder if pkg == "jax" else tbuilder
    if pkg == "torch":
        kw["device"] = "cpu"
    return mod.write_index_data(batch, keys, nb, root / pkg, extra_meta={"indexName": "ix"},
                                mesh=mesh, **kw)


@pytest.mark.parametrize("D", [2, 3, 8])
@pytest.mark.parametrize("keys,nb", [(["k"], 200), (["s", "f64"], 16), (["d"], 7)])
def test_write_index_data_mesh_bytes(tmp_path, D, keys, nb):
    """Index files of the sharded write: equal to the reference's mesh
    build and to the port's single-device build, byte for byte."""
    jb, tb = _pair(seed=D + nb)
    j = _files_by_slot(_write("jax", tmp_path, jb, keys, nb, jax_mesh(D)))
    t = _files_by_slot(_write("torch", tmp_path, tb, keys, nb, torch_mesh(D, device="cpu")))
    single = _files_by_slot(_write("torch", tmp_path / "single", tb, keys, nb))
    assert t == j == single
    assert len(t) == len({int(b) for b in np.unique(np.asarray(
        jbuild.bucket_ids_host([jbuild.key_repr(jb.columns[k]) for k in keys], nb)))})


def test_one_shard_mesh_takes_the_single_build(tmp_path):
    _, tb = _pair(seed=1, n=100)
    tmetrics.reset()
    files = _write("torch", tmp_path, tb, ["k"], 4, torch_mesh(1, device="cpu"))
    assert tmetrics.get("build.engine.device") == 1
    assert sum(tbuilder.layout.read_footer(f)["numRows"] for f in files) == 100


@pytest.mark.parametrize("finalize_mode", ["merge", "runs"])
def test_streaming_sharded_mesh_matches_reference(tmp_path, finalize_mode):
    """The streaming writer's mesh arm: each chunk sharded, each shard's
    rows spilled as a run; merged (or promoted) files equal the
    reference's byte for byte, and merged ones the in-memory build's."""
    t = _table(3000, seed=7)

    def chunks(B):
        for s in range(0, 3000, 640):
            yield B.from_pydict({c: v[s:s + 640] for c, v in t.items()}, schema=SCHEMA)

    j = jsb.write_index_data_streaming(chunks(JB), ["k"], 8, tmp_path / "jax", 640,
                                       extra_meta={"indexName": "ix"}, mesh=jax_mesh(8),
                                       finalize_mode=finalize_mode)
    tmetrics.reset()
    got = tsb.write_index_data_streaming(chunks(TB), ["k"], 8, tmp_path / "torch", 640,
                                         extra_meta={"indexName": "ix"},
                                         mesh=torch_mesh(8, device="cpu"), device="cpu",
                                         finalize_mode=finalize_mode)
    assert tmetrics.get("build.stream.rows") == 3000
    assert tmetrics.get("build.stream.chunks") == 3  # 1024-row chunks (640 rounded up)
    assert _files_by_slot(got) == _files_by_slot(j)
    if finalize_mode == "merge":
        single = _write("torch", tmp_path / "single", TB.from_pydict(t, schema=SCHEMA), ["k"], 8)
        assert _files_by_slot(got) == _files_by_slot(single)


@pytest.mark.parametrize("D", [3, 8])
def test_create_index_on_a_mesh_session(tmp_path, D):
    """The create action hands the session's mesh to the build: the index
    files of both packages' mesh sessions and of the port's single-device
    session are equal byte for byte."""
    src = tmp_path / "src"
    avro_schema = {c: t for c, t in SCHEMA.items() if c != "d"}  # avro holds no date32
    for i in range(2):
        t = {c: v for c, v in _table(1500, 40 + i).items() if c != "d"}
        jax_avro.write_avro(src / f"p-{i}.avro", JB.from_pydict(t, schema=avro_schema))
    data = {}
    for key, mod, mesh in (("jax", hs_jax, jax_mesh(D)),
                           ("torch", hs_torch, torch_mesh(D, device="cpu")),
                           ("single", hs_torch, None)):
        conf = {"hyperspace.system.path": str(tmp_path / f"ix_{key}"),
                "hyperspace.index.numBuckets": 10}
        if mod is hs_torch:
            conf["hyperspace.torch.device"] = "cpu"
        s = mod.HyperspaceSession(mod.HyperspaceConf(conf), mesh=mesh)
        mod.Hyperspace(s).create_index(s.read.avro(str(src)),
                                       mod.IndexConfig("li", ["k", "s"], ["f64", "f32", "p"]))
        data[key] = _files_by_slot((tmp_path / f"ix_{key}" / "li").glob("v__=0/*.tcb"))
    assert data["torch"] == data["jax"] == data["single"]
    assert len(data["torch"]) == 10
