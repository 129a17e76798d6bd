"""Parity of the port's index lifecycle after create with the JAX package on
the CPU: refresh (full, incremental, quick), optimize (quick, full),
delete, restore, vacuum and cancel.

Both packages keep their indexes over ONE source directory in one
``tmp_path`` and run the same verb sequence; after every step the log
entries (ids, states, source snapshot, lineage ids, recorded deltas; index
file names, times and content ids aside), the index bytes per version
directory and bucket, and the query rows must be equal, and the rows must
equal the source scan's. Each package also serves the tree the other one
refreshed and optimized. Mirrors test_lifecycle.py, test_actions.py, the
refresh cases of test_data_skipping.py and test_partitioned_source.py, the
per-bucket-file optimize case of test_compactor.py and
test_fuzz_parity.py's lifecycle fuzz (hybrid scan off). Tolerance: exact.
"""

import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.actions import base as jax_base
from hyperspace_tpu.actions import metadata_actions as jax_meta
from hyperspace_tpu.index import compactor as jax_compactor
from hyperspace_tpu.index import stream_builder as jax_sb
from hyperspace_tpu.index.data_manager import IndexDataManagerImpl as JaxData
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLog
from hyperspace_tpu.plan import ir as jax_ir
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage.columnar import Column as JaxColumn
from hyperspace_tpu.storage.columnar import ColumnarBatch as JaxBatch

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.actions import base as torch_base
from hyperspace_tpu_torch.actions import metadata_actions as torch_meta
from hyperspace_tpu_torch.index import compactor as torch_compactor
from hyperspace_tpu_torch.index import stream_builder as torch_sb
from hyperspace_tpu_torch.index.collection_manager import CachingIndexCollectionManager
from hyperspace_tpu_torch.index.data_manager import IndexDataManagerImpl as TorchData
from hyperspace_tpu_torch.index.interop import open_index_tree
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry as TorchEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl as TorchLog
from hyperspace_tpu_torch.plan import ir as torch_ir
from hyperspace_tpu_torch.storage.columnar import Column as TorchColumn
from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TorchBatch

from tests.test_log_entry import make_entry

PKGS = {"jax": hs_jax, "torch": hs_torch}
IRS = {"jax": jax_ir, "torch": torch_ir}
N_BUCKETS = 4
_LI = {"k": "int64", "q": "int32", "p": "float32", "f": "float64", "s": "string"}
_OD = {"ok": "int64", "c": "int64"}


def _li_batch(n, seed, key_hi=120, key_base=None):
    """``key_base`` set: distinct keys in [key_base, key_base + 1000)."""
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal(n) * 100).astype(np.float32)
    p[:: 17] = -0.0
    k = (rng.integers(0, key_hi, n) if key_base is None
         else key_base + rng.choice(1000, n, replace=False))
    return JaxBatch.from_pydict({
        "k": k.astype(np.int64),
        "q": rng.integers(1, 51, n).astype(np.int32),
        "p": p,
        "f": np.round(rng.random(n) * 1000, 2),
        "s": rng.choice(["A", "N", "R"], n).astype(object),
    }, schema=_LI)


def _session(mod, system_path, **conf):
    values = {"hyperspace.system.path": str(system_path),
              "hyperspace.index.numBuckets": N_BUCKETS, **conf}
    if mod is hs_torch:
        values["hyperspace.torch.device"] = "cpu"
    return mod.HyperspaceSession(mod.HyperspaceConf(values))


def _rows(batch):
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    return names, sorted(zip(*[[repr(v) for v in c] for c in cols]))


def _outcome(fn):
    """What a verb did: "ok", or its exception's class and message."""
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - compared across packages
        return f"{type(e).__name__}: {e}"


_TCB = re.compile(r"b(\d{5})-[0-9a-f]{12}\.tcb")


def _norm_dir(d):
    """A content tree without index file names' uuids, times and ids."""
    files = sorted((_TCB.sub(r"b\1.tcb", f["name"]), f["size"]) for f in d["files"])
    return {"name": d["name"], "files": files,
            "subDirs": [_norm_dir(s) for s in d["subDirs"]]}


def _entry_json(entry, system_path):
    d = entry.to_json_dict()
    d.pop("timestamp")
    d["content"] = _norm_dir(d["content"]["root"])
    text = json.dumps(d, sort_keys=True, default=str).replace(str(system_path), "<ix>")
    return text.replace(f'"{Path(system_path).name}"', '"<ix>"')


def _version_bytes(system_path: Path, index: str):
    """{(version dir, bucket): sorted file bytes} under one index."""
    out = {}
    for f in (system_path / index).glob("v__=*/*.tcb"):
        key = (f.parent.name, int(f.name[1:].split("-")[0]))
        out.setdefault(key, []).append(f.read_bytes())
    return {k: sorted(v) for k, v in out.items()}


class Pair:
    """The two packages, each with its own index tree, over one source."""

    def __init__(self, root: Path, **conf):
        self.root = root
        self.src = root / "src"
        self.od = root / "orders"
        self.trees = {k: root / f"ix_{k}" for k in PKGS}
        self.s = {k: _session(m, self.trees[k], **conf) for k, m in PKGS.items()}
        self.hs = {k: m.Hyperspace(self.s[k]) for k, m in PKGS.items()}

    def write(self, name, n, seed, **kw):
        jax_avro.write_avro(self.src / f"{name}.avro", _li_batch(n, seed, **kw))

    def write_orders(self, name, keys):
        jax_avro.write_avro(self.od / f"{name}.avro", JaxBatch.from_pydict(
            {"ok": np.asarray(keys, dtype=np.int64),
             "c": (np.asarray(keys, dtype=np.int64) * 7) % 13}, schema=_OD))

    def remove(self, name, table="src"):
        (getattr(self, table) / f"{name}.avro").unlink()

    def verb(self, name, *args):
        """Run one facade verb on both packages; both must end alike."""
        out = {k: _outcome(lambda k=k: getattr(self.hs[k], name)(*args)) for k in PKGS}
        assert out["jax"] == out["torch"], (name, args, out)
        return out["jax"]

    def queries(self, key):
        s, mod = self.s[key], PKGS[key]
        col = mod.col
        li = s.read.avro(str(self.src))
        out = {
            "point": li.filter(mod.is_in(col("k"), [7, 1007, 2011, 5003])).select("k", "q", "s"),
            "range": li.filter((col("k") >= 20) & (col("k") < 4700) & (col("q") < 30))
            .select("k", "q", "p", "f"),
            "string": li.filter((col("s") == "N") & (col("k") > 90)).select("k", "s"),
        }
        if self.od.is_dir():
            out["join"] = li.filter(col("q") > 10).select("k", "q").join(
                s.read.avro(str(self.od)).select("ok", "c"), col("k") == col("ok"))
        return out

    def rows(self, key, enabled=True):
        s = self.s[key]
        s.enable_hyperspace() if enabled else s.disable_hyperspace()
        qs = self.queries(key)
        res = {n: _rows(q.collect()) for n, q in qs.items()}
        used = {n: bool(q.optimized_plan().collect(
            lambda x: isinstance(x, IRS[key].IndexScan))) for n, q in qs.items()}
        s.disable_hyperspace()
        return res, used

    def check(self, index="li"):
        """Entries, bytes per version and rows equal across packages, and
        the rows equal to the source scan's. Returns which queries each
        package rewrote."""
        views = {}
        for k in PKGS:
            mgr = self.s[k].collection_manager
            views[k] = sorted(_entry_json(e, self.trees[k]) for e in mgr.get_indexes())
        assert views["jax"] == views["torch"]
        assert _version_bytes(self.trees["jax"], index) == \
            _version_bytes(self.trees["torch"], index)
        off, _ = self.rows("jax", enabled=False)
        used = {}
        for k in PKGS:
            on, used[k] = self.rows(k)
            assert on == off, k
        return used


def _files(tree, index):
    return sorted(p.parent.name for p in (tree / index).glob("v__=*/*.tcb"))


@pytest.mark.parametrize("lineage", [True, False], ids=["lineage", "no_lineage"])
def test_lifecycle_sequence_matches(tmp_path, lineage):
    """create → RF1-style appends refreshed incrementally → an RF2-style
    delete → optimize quick and full → quick refresh → full refresh →
    delete, restore, delete, vacuum; the no-op and refused verbs too. The
    keys are distinct, as TPC-H's order keys are: equal keys in two files
    of one version directory would merge in file-name order, and a file
    name holds a random uuid in both packages."""
    p = Pair(tmp_path, **{"hyperspace.index.lineage.enabled": lineage})
    for i in range(3):
        p.write(f"part-{i}", 300, i, key_base=1000 * i)
    p.write_orders("o-0", np.arange(0, 6000, 5))
    for k in PKGS:
        s = p.s[k]
        p.hs[k].create_index(s.read.avro(str(p.src)), PKGS[k].IndexConfig("li", ["k"], ["q", "p", "f", "s"]))
        p.hs[k].create_index(s.read.avro(str(p.od)), PKGS[k].IndexConfig("od", ["ok"], ["c"]))
    assert all(p.check().values())
    assert p.verb("refresh_index", "li", "full") == "ok"  # nothing changed: a no-op
    assert p.verb("optimize_index", "li", "quick") == "ok"  # one file a bucket: a no-op
    assert "bogus" in p.verb("optimize_index", "li", "bogus")
    assert "Unsupported refresh mode" in p.verb("refresh_index", "li", "bogus")
    assert len(os.listdir(p.trees["torch"] / "li" / "_hyperspace_log")) == 3

    p.write("rf1-a", 120, 10, key_base=3000)
    p.write_orders("o-a", np.arange(6001, 9000, 7))
    used = p.check()
    assert not any(used["torch"].values())  # the signature no longer matches
    assert p.verb("refresh_index", "li", "incremental") == "ok"
    assert p.verb("refresh_index", "od", "incremental") == "ok"
    assert all(p.check()["torch"].values())
    p.write("rf1-b", 90, 11, key_base=4000)
    assert p.verb("refresh_index", "li", "incremental") == "ok"
    assert all(p.check()["torch"].values())
    assert _files(p.trees["torch"], "li").count("v__=2") == N_BUCKETS

    p.remove("rf1-a")  # RF2
    out = p.verb("refresh_index", "li", "incremental")
    if not lineage:
        assert "requires lineage" in out
        p.verb("refresh_index", "li", "full")
    p.check()
    assert p.verb("optimize_index", "li", "quick") == "ok"
    assert p.verb("optimize_index", "li", "full") == "ok"
    used = p.check()
    assert all(used["torch"].values())
    entry = TorchLog(p.trees["torch"] / "li").get_latest_stable_log()
    assert len(entry.content.files()) == N_BUCKETS

    p.write("rf1-a", 120, 10, key_base=3000)
    assert p.verb("refresh_index", "li", "quick") == "ok"
    used = p.check()
    assert TorchLog(p.trees["torch"] / "li").get_latest_stable_log().source_update() is not None
    assert p.verb("refresh_index", "li", "full") == "ok"
    assert all(p.check()["torch"].values())

    assert p.verb("delete_index", "li") == "ok"
    used = p.check()
    assert not used["torch"]["range"] and used["torch"]["join"] is False
    assert "only supported in ACTIVE" in p.verb("delete_index", "li")
    assert "only supported in DELETED" in p.verb("vacuum_index", "od")
    assert p.verb("restore_index", "li") == "ok"
    assert all(p.check()["torch"].values())
    assert p.verb("delete_index", "li") == "ok"
    assert p.verb("vacuum_index", "li") == "ok"
    p.check()
    for k in PKGS:
        assert not list((p.trees[k] / "li").glob("v__=*"))
        assert [s.name for s in p.hs[k].indexes()] == ["od"]
    assert "could not be found" in p.verb("refresh_index", "nope")


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_each_package_serves_the_others_lifecycle_tree(tmp_path, built_by):
    """A tree refreshed (append, then an RF2 delete through lineage) and
    optimized by one package serves the other with equal rows."""
    p = Pair(tmp_path, **{"hyperspace.index.lineage.enabled": True})
    for i in range(2):
        p.write(f"part-{i}", 250, 20 + i)
    p.write_orders("o-0", np.arange(0, 120, 3))
    s, mod, hs = p.s[built_by], PKGS[built_by], p.hs[built_by]
    hs.create_index(s.read.avro(str(p.src)), mod.IndexConfig("li", ["k"], ["q", "p", "f", "s"]))
    hs.create_index(s.read.avro(str(p.od)), mod.IndexConfig("od", ["ok"], ["c"]))
    p.write("rf1", 100, 30)
    hs.refresh_index("li", "incremental")
    p.remove("part-0")
    hs.refresh_index("li", "incremental")
    hs.optimize_index("li", "full")
    tree = p.trees[built_by]
    assert set(open_index_tree(tree)) == {"li", "od"}
    other = "torch" if built_by == "jax" else "jax"
    p.s[other] = _session(PKGS[other], tree)
    off, _ = p.rows("jax", enabled=False)
    for k in PKGS:
        on, used = p.rows(k)
        assert on == off and all(used.values()), k


# ---------------------------------------------------------------------------
# the action protocol (mirrors test_actions.py)
# ---------------------------------------------------------------------------
def _seeded(Log, Entry, root, state="ACTIVE"):
    mgr = Log(root / "idx")
    for i, st in enumerate(("CREATING", state)):
        e = Entry(make_entry())
        e.state = st
        assert mgr.write_log(i, e)
    if state in ("ACTIVE", "DELETED", "DOESNOTEXIST"):
        mgr.create_latest_stable_log(1)
    return mgr


def _stuck(mgr, Entry, state):
    e = Entry(make_entry())
    e.state = state
    assert mgr.write_log(mgr.get_latest_id() + 1, e)


_PKG_ACTIONS = {
    "jax": (jax_base, jax_meta, JaxLog, JaxData, lambda e: e),
    "torch": (torch_base, torch_meta, TorchLog, TorchData,
              lambda e: TorchEntry.from_json_dict(e.to_json_dict())),
}


def _protocol_case(key, case, root):
    base, meta, Log, Data, Entry = _PKG_ACTIONS[key]
    from importlib import import_module

    exc = import_module(f"{'hyperspace_tpu' if key == 'jax' else 'hyperspace_tpu_torch'}.exceptions")

    class Recording(base.Action):
        transient_state, final_state = "CREATING", "ACTIVE"

        def __init__(self, mgr, fail=False, no_changes=False):
            super().__init__(mgr)
            self.fail, self.no_changes, self.ops = fail, no_changes, 0

        def validate(self):
            if self.no_changes:
                raise exc.NoChangesException("nothing to do")

        def op(self):
            self.ops += 1
            if self.fail:
                raise RuntimeError("boom")

        def log_entry(self):
            return Entry(make_entry())

    log = []
    if case in ("begin_op_end", "failure", "no_changes", "conflict"):
        mgr = Log(root / "idx")
        if case == "conflict":
            a1, a2 = Recording(mgr), Recording(mgr)
            _ = a1.base_id, a2.base_id
            a1.run()
            log.append(_outcome(a2.run))
            log.append(a2.ops)
        else:
            a = Recording(mgr, fail=case == "failure", no_changes=case == "no_changes")
            log.append(_outcome(a.run))
            log.append(a.ops)
    elif case == "delete_restore":
        mgr = _seeded(Log, Entry, root)
        for act in (meta.DeleteAction, meta.RestoreAction, meta.RestoreAction):
            log.append(_outcome(act(mgr).run))
    elif case == "vacuum":
        mgr = _seeded(Log, Entry, root, "DELETED")
        data = Data(root / "idx")
        for v in (0, 1):
            data.get_path(v).mkdir(parents=True)
            (data.get_path(v) / "b0.tcb").write_bytes(b"x")
        log.append(_outcome(meta.VacuumAction(mgr, data).run))
        log.append(data.get_latest_version_id())
    elif case == "vacuum_requires_deleted":
        mgr = _seeded(Log, Entry, root)
        log.append(_outcome(meta.VacuumAction(mgr, Data(root / "idx")).run))
    elif case == "cancel_rolls_back":
        mgr = _seeded(Log, Entry, root)
        _stuck(mgr, Entry, "REFRESHING")
        log.append(_outcome(meta.CancelAction(mgr).run))
    elif case == "cancel_refuses_stable":
        mgr = _seeded(Log, Entry, root)
        log.append(_outcome(meta.CancelAction(mgr).run))
    elif case == "cancel_vacuuming":
        mgr = _seeded(Log, Entry, root, "DELETED")
        _stuck(mgr, Entry, "VACUUMING")
        log.append(_outcome(meta.CancelAction(mgr).run))
    elif case == "cancel_no_stable":
        mgr = Log(root / "idx")
        e = Entry(make_entry())
        e.state = "CREATING"
        mgr.write_log(0, e)
        log.append(_outcome(meta.CancelAction(mgr).run))
    elif case == "missing_index":
        log.append(_outcome(lambda: base._load_latest_entry(Log(root / "none"))))
    latest, stable = mgr.get_latest_log() if case != "missing_index" else None, None
    if latest is not None:
        stable = mgr.get_latest_stable_log()
        log += [latest.id, latest.state, stable and (stable.id, stable.state)]
    return log


@pytest.mark.parametrize("case", [
    "begin_op_end", "failure", "no_changes", "conflict", "delete_restore", "vacuum",
    "vacuum_requires_deleted", "cancel_rolls_back", "cancel_refuses_stable",
    "cancel_vacuuming", "cancel_no_stable", "missing_index",
])
def test_action_protocol_matches(tmp_path, case):
    out = {k: _protocol_case(k, case, tmp_path / k) for k in PKGS}
    assert out["jax"] == out["torch"]


def test_cancel_serves_stable_snapshot_then_returns_to_active(tmp_path):
    """A writer that died mid-refresh leaves REFRESHING at the head: queries
    keep the stable snapshot, a second writer is refused, and cancel
    returns the index to ACTIVE (the caching manager sees it at once)."""
    p = Pair(tmp_path)
    p.write("part-0", 200, 40)
    p.write_orders("o-0", np.arange(0, 120, 2))
    for k in PKGS:
        s = p.s[k]
        p.hs[k].create_index(s.read.avro(str(p.src)), PKGS[k].IndexConfig("li", ["k"], ["q", "p", "f", "s"]))
        p.hs[k].create_index(s.read.avro(str(p.od)), PKGS[k].IndexConfig("od", ["ok"], ["c"]))
        mgr = p.s[k].collection_manager._existing_log_manager("li")
        head = mgr.get_latest_log()
        head.id += 1
        head.state = "REFRESHING"
        assert mgr.write_log(head.id, head)
        p.s[k].collection_manager._enumerate()  # the head was written behind the cache
    assert isinstance(p.s["torch"].collection_manager, CachingIndexCollectionManager)
    p.s["torch"].collection_manager.clear_cache()
    p.s["jax"].collection_manager.clear_cache()
    p.write("rf1", 50, 41)
    assert "only supported in ACTIVE" in p.verb("refresh_index", "li", "incremental")
    p.remove("rf1")
    assert all(p.check()["torch"].values())
    assert [s.state for s in p.hs["torch"].indexes()] == ["REFRESHING", "ACTIVE"]
    assert p.verb("cancel", "li") == "ok"
    assert [s.state for s in p.hs["torch"].indexes()] == ["ACTIVE", "ACTIVE"]
    assert "not supported in a stable state" in p.verb("cancel", "li")
    assert all(p.check()["torch"].values())


# ---------------------------------------------------------------------------
# optimize's merge and the float sort order (test_lifecycle.py:319)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_optimize_keeps_float_sort_order(tmp_path, dtype):
    """Optimize's merge orders float keys by the ordered encodings, -0.0
    and NaN included; the merged bytes are the reference's."""
    src = tmp_path / "src"

    def write(i):
        r = np.random.default_rng(50 + i)
        p = (r.standard_normal(200) * 100).astype(dtype)
        p[::13], p[5::29], p[7::31] = -0.0, 0.0, np.nan
        jax_avro.write_avro(src / f"part-{i}.avro", JaxBatch.from_pydict(
            {"p": p, "v": r.integers(0, 1000, 200).astype(np.int64)},
            schema={"p": dtype, "v": "int64"}))

    write(0)
    trees = {k: tmp_path / f"ix_{k}" for k in PKGS}
    for k, mod in PKGS.items():
        s = _session(mod, trees[k])
        mod.Hyperspace(s).create_index(s.read.avro(str(src)), mod.IndexConfig("fi", ["p"], ["v"]))
    write(1)
    for k, mod in PKGS.items():
        hsp = mod.Hyperspace(_session(mod, trees[k]))
        hsp.refresh_index("fi", "incremental")
        hsp.optimize_index("fi", "full")
    assert _version_bytes(trees["jax"], "fi") == _version_bytes(trees["torch"], "fi")
    entry = TorchLog(trees["torch"] / "fi").get_latest_stable_log()
    from hyperspace_tpu_torch.storage import layout

    assert len(entry.content.files()) == N_BUCKETS
    for f in entry.content.files():
        enc = torch_sb.sort_encoding(layout.read_batch(f).columns["p"])
        assert (enc[1:] >= enc[:-1]).all(), f


_MERGE_CASES = {
    "int64": lambda r, n: r.integers(-50, 50, n).astype(np.int64),
    "int32": lambda r, n: r.integers(-50, 50, n).astype(np.int32),
    "float32": lambda r, n: np.where(r.random(n) < 0.1, -0.0, r.standard_normal(n)).astype(np.float32),
    "float64": lambda r, n: np.where(r.random(n) < 0.1, np.nan, r.standard_normal(n).round(1)),
    "string": lambda r, n: r.choice(["x", "yy", "a", "zz"], n).astype(object),
}


@pytest.mark.parametrize("dtype", sorted(_MERGE_CASES))
@pytest.mark.parametrize("two_keys", [False, True], ids=["one_key", "two_keys"])
def test_merge_bucket_parts_matches(dtype, two_keys):
    """Sorted parts merged by the tournament, unsorted ones re-sorted:
    the same rows in the same order as the reference's merge."""
    r = np.random.default_rng(len(dtype) + two_keys)
    outs = {}
    for key, (Col, Batch, comp) in {"jax": (JaxColumn, JaxBatch, jax_compactor),
                                     "torch": (TorchColumn, TorchBatch, torch_compactor)}.items():
        r = np.random.default_rng(len(dtype) + two_keys)
        parts = []
        for n in (40, 1, 25):
            cols = {"a": Col.from_values(_MERGE_CASES[dtype](r, n)),
                    "b": Col.from_values(r.integers(0, 3, n).astype(np.int64)),
                    "row": Col.from_values(np.arange(n, dtype=np.int64) + 1000 * len(parts))}
            parts.append(Batch(cols))
        keys = ["a", "b"] if two_keys else ["a"]
        res = []
        for is_sorted in (True, False):
            ps = parts
            if is_sorted:
                sb = jax_sb if key == "jax" else torch_sb
                ps = [b.take(np.lexsort([sb.sort_encoding(b.columns[c]) for c in reversed(keys)]))
                      for b in parts]
            m = comp.merge_bucket_parts(ps, is_sorted, keys)
            res.append([list(m.columns[c].to_values().astype(str)) for c in ("a", "b", "row")])
        outs[key] = res
    assert outs["jax"] == outs["torch"]


def test_partition_compactable_matches(tmp_path):
    """optimize(quick)'s partition rule on per-bucket files
    (test_compactor.py:542), and full mode's; a run file, refused here
    until the runs layout was ported, is now always compactable and its
    buckets join the eligible set, as in the reference."""
    from types import SimpleNamespace

    fi = lambda name, size: SimpleNamespace(name=name, size=size)  # noqa: E731
    infos = [fi("b00002-aaaaaaaaaaaa.tcb", 5000), fi("b00003-bbbbbbbbbbbb.tcb", 10),
             fi("b00003-cccccccccccc.tcb", 20), fi("b00004-dddddddddddd.tcb", 10),
             fi("b00002-eeeeeeeeeeee.tcb", 30)]
    for quick in (True, False):
        got = [m.partition_compactable(infos, 1000, quick=quick)
               for m in (jax_compactor, torch_compactor)]
        view = [({b: [f.name for f in v] for b, v in g[0].items()}, g[1], g[2],
                 sorted(f.name for f in g[3])) for g in got]
        assert view[0] == view[1]
    run = tmp_path / "r00000-aaaaaaaaaaaa.tcb"
    from hyperspace_tpu_torch.storage import layout as torch_layout

    torch_layout.write_batch(run, TorchBatch.from_pydict({"k": np.arange(3, dtype=np.int64)}),
                             extra={"bucketCounts": [0, 3, 0, 0]})
    got = [m.partition_compactable([fi(str(run), 10)], 1000, True)
           for m in (jax_compactor, torch_compactor)]
    assert [(g[0], [f.name for f in g[1]], g[2], g[3]) for g in got] == \
        [({}, [str(run)], {1}, [])] * 2


# ---------------------------------------------------------------------------
# quick refresh: with hybrid scan off, the recorded update is served through
# the hybrid transformation in both packages
# ---------------------------------------------------------------------------
def test_quick_refresh_rows_match_and_port_stays_on_source(tmp_path):
    """Both packages rewrite the quick-refreshed index to the same hybrid
    plan (the appended file's Union, the deleted file's lineage NOT IN),
    with the source scan's rows; none stays on its source."""
    p = Pair(tmp_path, **{"hyperspace.index.lineage.enabled": True})
    for i in range(2):
        p.write(f"part-{i}", 200, 60 + i)
    for k in PKGS:
        s = p.s[k]
        p.hs[k].create_index(s.read.avro(str(p.src)), PKGS[k].IndexConfig("li", ["k"], ["q", "p", "f", "s"]))
    p.write("rf1", 80, 62)
    p.remove("part-0")
    assert p.verb("refresh_index", "li", "quick") == "ok"
    used = p.check()
    assert all(used["torch"].values()) and all(used["jax"].values())
    trees = {}
    for k in PKGS:
        p.s[k].enable_hyperspace()
        plans = [q.optimized_plan() for q in p.queries(k).values()]
        p.s[k].disable_hyperspace()
        trees[k] = [pl.tree_string() for pl in plans]
        kinds = {type(n).__name__ for pl in plans for n in pl.collect(lambda n: True)}
        assert {"Union", "IndexScan"} <= kinds, k
    assert trees["torch"] == trees["jax"]
    assert all("_data_file_id" in t for t in trees["torch"])


# ---------------------------------------------------------------------------
# data-skipping refresh (test_data_skipping.py:182,224)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["incremental", "full"])
def test_skipping_refresh_matches(tmp_path, mode):
    src = tmp_path / "src"

    def write(name, lo, hi):
        jax_avro.write_avro(src / f"{name}.avro", JaxBatch.from_pydict(
            {"k": np.arange(lo, hi, dtype=np.int64), "v": np.arange(lo, hi, dtype=np.int64) * 2},
            schema={"k": "int64", "v": "int64"}))

    for i in range(4):
        write(f"part-{i}", i * 100, (i + 1) * 100)
    trees = {k: tmp_path / f"ix_{k}" for k in PKGS}

    def hsp(k):
        return PKGS[k].Hyperspace(_session(PKGS[k], trees[k]))

    for k, mod in PKGS.items():
        s = _session(mod, trees[k])
        mod.Hyperspace(s).create_index(s.read.avro(str(src)), mod.DataSkippingIndexConfig(
            "sk", [mod.MinMaxSketch("k")]))
    write("part-4", 400, 500)
    write("part-0", 1000, 1100)  # rewritten in place: re-sketched
    st = (src / "part-0.avro").stat()
    os.utime(src / "part-0.avro", ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    (src / "part-2.avro").unlink()
    for k in PKGS:
        hsp(k).refresh_index("sk", mode)
    sk = {k: (trees[k] / "sk" / "v__=1" / "sketches.json").read_bytes() for k in PKGS}
    assert sk["jax"] == sk["torch"] and len(json.loads(sk["jax"])["files"]) == 4
    out = {}
    for k, mod in PKGS.items():
        s = _session(mod, trees[k])
        s.enable_hyperspace()
        res = []
        for key in (450, 1050, 250, 150):
            q = s.read.avro(str(src)).filter(mod.col("k") == key).select("k", "v")
            scan = q.optimized_plan().collect(lambda n: isinstance(n, IRS[k].Scan))[0]
            res.append((len(scan.relation.files), _rows(q.collect())))
        out[k] = res
    assert out["jax"] == out["torch"]
    assert [n for n, _ in out["torch"]] == [1, 1, 0, 1]
    assert [len(r[1]) for _, r in out["torch"]] == [1, 1, 0, 1]


# ---------------------------------------------------------------------------
# partitioned sources (test_partitioned_source.py:302,361)
# ---------------------------------------------------------------------------
def _part(n, seed):
    rng = np.random.default_rng(seed)
    return JaxBatch.from_pydict({"orderkey": rng.integers(0, 30, n).astype(np.int64),
                                 "qty": rng.integers(1, 51, n).astype(np.int64)},
                                schema={"orderkey": "int64", "qty": "int64"})


@pytest.mark.parametrize("case", ["partitioned_incremental", "new_kv_dirs_unpartitioned"])
def test_partitioned_refresh_matches(tmp_path, case):
    src = tmp_path / "src"
    if case == "partitioned_incremental":
        for region in ("eu", "us"):
            for day in (1, 2):
                jax_avro.write_avro(src / f"region={region}" / f"day={day}" / "part-0.avro",
                                    _part(60, hash((region, day)) % 100))
        incl = ["qty", "region"]
    else:
        jax_avro.write_avro(src / "a.avro", _part(80, 1))
        incl = ["qty"]
    trees = {k: tmp_path / f"ix_{k}" for k in PKGS}
    conf = {"hyperspace.index.lineage.enabled": "true"}
    for k, mod in PKGS.items():
        s = _session(mod, trees[k], **conf)
        mod.Hyperspace(s).create_index(s.read.avro(str(src)), mod.IndexConfig("pi", ["orderkey"], incl))
    if case == "partitioned_incremental":
        jax_avro.write_avro(src / "region=ap" / "day=3" / "part-0.avro", _part(40, 11))
        (src / "region=eu" / "day=2" / "part-0.avro").unlink()
    else:
        jax_avro.write_avro(src / "qty=999" / "b.avro", _part(50, 2))
    out = {}
    for k, mod in PKGS.items():
        s = _session(mod, trees[k], **conf)
        mod.Hyperspace(s).refresh_index("pi", "incremental")
        reader = s.read if case == "partitioned_incremental" else \
            s.read.option("hyperspace.source.partitionInference", "false")
        q = reader.avro(str(src)).filter(mod.col("orderkey") == 7).select("orderkey", *incl)
        off = _rows(q.collect())
        s.enable_hyperspace()
        on = _rows(q.collect())
        assert on == off and q.optimized_plan().collect(lambda n: isinstance(n, IRS[k].IndexScan))
        out[k] = (on, _entry_json(s.collection_manager.get_indexes()[0], trees[k]))
    assert out["jax"] == out["torch"]
    assert _version_bytes(trees["jax"], "pi") == _version_bytes(trees["torch"], "pi")
    if case == "new_kv_dirs_unpartitioned":
        assert "'999'" not in str(out["torch"][0]) and "999" not in str(out["torch"][0][1])


# ---------------------------------------------------------------------------
# the facade's small pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("calls", [
    (("index_name", "a"), ("index_by", "x", "y"), ("include", "z")),
    (("index_name", "a"), ("index_name", "b")),
    (("index_name", ""),),
    (("index_name", "a"), ("index_by",)),
    (("index_by", "x"), ("index_by", "y")),
    (("index_name", "a"), ("index_by", "x"), ("include", "z"), ("include", "w")),
])
def test_index_config_builder_matches(calls):
    out = {}
    for k, mod in PKGS.items():
        def build(mod=mod):
            b = mod.IndexConfig.builder()
            for name, *args in calls:
                b = getattr(b, name)(*args)
            c = b.create()
            return repr(c), c == mod.IndexConfig("A", ["X", "y"], ["z"])
        try:
            out[k] = build()
        except Exception as e:  # noqa: BLE001 - compared across packages
            out[k] = f"{type(e).__name__}: {e}"
    assert out["jax"] == out["torch"]


def test_conf_unset_and_cache_expiry(tmp_path):
    """``unset`` drops a key back to its default; the caching manager's
    listing lives for ``expiryDurationInSeconds`` and every verb clears it."""
    for mod in PKGS.values():
        conf = mod.HyperspaceConf({"hyperspace.index.cache.expiryDurationInSeconds": 0})
        assert conf.cache_expiry_seconds() == 0
        conf.unset("hyperspace.index.cache.expiryDurationInSeconds").unset("absent")
        assert conf.cache_expiry_seconds() == 300
        assert conf.optimize_file_size_threshold() == 256 * 1024 * 1024
    p = Pair(tmp_path)
    p.write("part-0", 100, 70)
    for k in PKGS:
        s = p.s[k]
        p.hs[k].create_index(s.read.avro(str(p.src)), PKGS[k].IndexConfig("li", ["k"], ["q"]))
        assert [x.state for x in p.hs[k].indexes()] == ["ACTIVE"]
        # a writer behind this session's back stays unseen until expiry
        mgr = PKGS[k].HyperspaceSession(p.s[k].conf).collection_manager
        mgr.delete("li")
        assert [x.state for x in p.hs[k].indexes()] == ["ACTIVE"]
        p.s[k].conf.set("hyperspace.index.cache.expiryDurationInSeconds", -1)
        assert [x.state for x in p.hs[k].indexes()] == ["DELETED"]


def test_lifecycle_events_match(tmp_path):
    import tests.mock_logger as ml

    kinds = {}
    for k, mod in PKGS.items():
        ml.EVENTS.clear()
        s = _session(mod, tmp_path / f"ix_{k}",
                     **{"hyperspace.eventLoggerClass": "tests.mock_logger:MockEventLogger"})
        src = tmp_path / f"src_{k}"
        jax_avro.write_avro(src / "part-0.avro", _li_batch(50, 80))
        hsp = mod.Hyperspace(s)
        hsp.create_index(s.read.avro(str(src)), mod.IndexConfig("li", ["k"], ["q"]))
        jax_avro.write_avro(src / "part-1.avro", _li_batch(50, 81))
        hsp.refresh_index("li", "incremental")
        hsp.optimize_index("li", "full")
        jax_avro.write_avro(src / "part-2.avro", _li_batch(50, 82))
        hsp.refresh_index("li", "quick")
        hsp.refresh_index("li", "full")
        hsp.delete_index("li")
        hsp.restore_index("li")
        hsp.delete_index("li")
        hsp.vacuum_index("li")
        kinds[k] = [(type(e).__name__, e.message, e.state) for e in ml.EVENTS]
    assert kinds["jax"] == kinds["torch"] and len(kinds["jax"]) == 18


# ---------------------------------------------------------------------------
# a small cross-package lifecycle fuzz (test_fuzz_parity.py:409, hybrid off)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_lifecycle_fuzz_matches(tmp_path, seed):
    rng = np.random.default_rng(3000 + seed)
    lineage = bool(rng.random() < 0.7)
    nb = int(rng.choice([2, 8]))
    src = tmp_path / "src"
    trees = {k: tmp_path / f"ix_{k}" for k in PKGS}
    conf = {"hyperspace.index.lineage.enabled": lineage, "hyperspace.index.numBuckets": nb}
    sessions = {k: _session(m, trees[k], **conf) for k, m in PKGS.items()}
    hss = {k: PKGS[k].Hyperspace(sessions[k]) for k in PKGS}
    counter = [0]

    def add_file(n):
        b = JaxBatch.from_pydict({"k": rng.integers(0, 150, n).astype(np.int64),
                                  "v": rng.integers(-10**6, 10**6, n).astype(np.int64)})
        jax_avro.write_avro(src / f"p{counter[0]:03d}.avro", b)
        counter[0] += 1

    for _ in range(4):
        add_file(int(rng.integers(50, 300)))
    for k, mod in PKGS.items():
        hss[k].create_index(sessions[k].read.avro(str(src)), mod.IndexConfig("lc", ["k"], ["v"]))

    def check(tag):
        key = int(rng.integers(0, 150))
        res = {}
        for k, mod in PKGS.items():
            col, s = mod.col, sessions[k]
            out = []
            for pred in (col("k") == key, (col("k") > key - 10) & (col("k") <= key + 10)):
                q = s.read.avro(str(src)).filter(pred).select("k", "v")
                s.disable_hyperspace()
                off = _rows(q.collect())
                s.enable_hyperspace()
                on = _rows(q.collect())
                assert on == off, (seed, tag, k)
                out.append(on)
            res[k] = out
        assert res["jax"] == res["torch"], (seed, tag)
        views = {k: sorted(_entry_json(e, trees[k]) for e in sessions[k].collection_manager
                           .get_indexes()) for k in PKGS}
        assert views["jax"] == views["torch"], (seed, tag)

    check("initial")
    for step in range(8):
        action = rng.choice(["append", "delete", "refresh_full", "refresh_incr",
                             "refresh_quick", "optimize"])
        if action == "append":
            add_file(int(rng.integers(20, 200)))
        elif action == "delete":
            existing = sorted(src.glob("p*.avro"))
            if len(existing) > 1:
                existing[int(rng.integers(0, len(existing)))].unlink()
        else:
            args = {"refresh_full": ("refresh_index", "full"),
                    "refresh_incr": ("refresh_index", "incremental"),
                    "refresh_quick": ("refresh_index", "quick"),
                    "optimize": ("optimize_index", str(rng.choice(["quick", "full"])))}[action]
            outs = {k: _outcome(lambda k=k: getattr(hss[k], args[0])("lc", args[1])) for k in PKGS}
            assert outs["jax"] == outs["torch"], (seed, step, action)
            assert "Concurrent" not in outs["jax"]
        check(f"step{step}:{action}")


def test_globbing_pattern_refresh_matches(tmp_path):
    """An index over a glob pattern picks up a new matching directory on
    incremental refresh (test_lifecycle.py's globbing case)."""
    jax_avro.write_avro(tmp_path / "data" / "part-0.avro", _li_batch(100, 90))
    jax_avro.write_avro(tmp_path / "data" / "part-1.avro", _li_batch(100, 91))
    pattern = str(tmp_path / "data*")
    out = {}
    for k, mod in PKGS.items():
        s = _session(mod, tmp_path / f"ix_{k}")
        df = s.read.option("hyperspace.source.globbingPattern", pattern).avro(str(tmp_path / "data"))
        mod.Hyperspace(s).create_index(df, mod.IndexConfig("gidx", ["k"], ["q"]))
    jax_avro.write_avro(tmp_path / "data2" / "part-0.avro", _li_batch(60, 92))
    for k, mod in PKGS.items():
        s = _session(mod, tmp_path / f"ix_{k}")
        hsp = mod.Hyperspace(s)
        hsp.refresh_index("gidx", "incremental")
        entry = s.collection_manager.get_indexes()[0]
        out[k] = (hsp.index("gidx").source_files, entry.relation.root_paths,
                  _entry_json(entry, tmp_path / f"ix_{k}"))
    assert out["jax"] == out["torch"] and out["torch"][:2] == (3, [pattern])
    assert _version_bytes(tmp_path / "ix_jax", "gidx") == _version_bytes(tmp_path / "ix_torch", "gidx")
