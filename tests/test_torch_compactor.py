"""Parity of the port's run-file maintenance with the JAX package on the
CPU: the lineage rewrite of incremental refresh over run files, optimize
over run files, and the background compactor (``CompactionStep``,
``IndexCompactor``, ``Hyperspace.compact_index``) step by step.

Both packages build their own runs-layout index over ONE avro source (the
bytes are equal from the start) and run the same verbs; after every step
the log entries (file names' random suffixes, times and ids aside), the
index bytes per ``v__=N`` directory and file slot (bucket or run sequence)
and the query rows must be equal, and the rows must equal the source
scan's. Mirrors the run-file cases of test_compactor.py and
test_runs_layout.py. Tolerance: exact.
"""

import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import hyperspace_tpu as hs_jax
from hyperspace_tpu.index import compactor as jax_compactor
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLog
from hyperspace_tpu.storage import avro_io as jax_avro
from hyperspace_tpu.storage import layout as jlayout
from hyperspace_tpu.storage.columnar import ColumnarBatch as JB

import hyperspace_tpu_torch as hs_torch
from hyperspace_tpu_torch.index import compactor as torch_compactor
from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl as TorchLog
from hyperspace_tpu_torch.plan import ir as torch_ir
from hyperspace_tpu_torch.storage import layout as tlayout
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

PKGS = {"jax": hs_jax, "torch": hs_torch}
N_BUCKETS = 8
_LI = {"k": "int64", "v": "int64", "s": "string"}


@pytest.fixture(autouse=True)
def _hermetic_probe(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_PROBE_CACHE", "")
    monkeypatch.setenv("HYPERSPACE_TPU_TORCH_PROBE_CACHE", "")


_SLOT = re.compile(r"([br]\d{5,})-[0-9a-f]{12}\.tcb")


def _entry_json(entry, system_path):
    d = entry.to_json_dict()
    d.pop("timestamp")
    text = json.dumps(d, sort_keys=True, default=str)
    text = _SLOT.sub(r"\1.tcb", text)
    text = re.sub(r'"modifiedTime": \d+', '"modifiedTime": 0', text)
    return text.replace(str(system_path), "<ix>").replace(
        f'"{Path(system_path).name}"', '"<ix>"')


def _version_bytes(tree: Path, index: str):
    """{(version dir, slot): sorted file bytes} under one index."""
    out = {}
    for f in (tree / index).glob("v__=*/*.tcb"):
        key = (f.parent.name, _SLOT.match(f.name).group(1))
        out.setdefault(key, []).append(f.read_bytes())
    return {k: sorted(v) for k, v in out.items()}


def _rows(batch):
    names = sorted(batch.column_names)
    cols = [batch.columns[n].to_values() for n in names]
    return names, sorted(zip(*[[repr(v) for v in c] for c in cols]))


class Pair:
    """Both packages, each with its own runs-layout tree, over one source."""

    def __init__(self, root: Path, **conf):
        self.src = root / "src"
        self.trees = {k: root / f"ix_{k}" for k in PKGS}
        base = {"hyperspace.index.numBuckets": N_BUCKETS,
                "hyperspace.index.lineage.enabled": True,
                "hyperspace.index.build.mode": "streaming",
                "hyperspace.index.build.chunkRows": 1 << 11,
                "hyperspace.index.build.finalizeMode": "runs",
                "hyperspace.index.build.engine": "device",
                "hyperspace.index.build.device.runChunks": 2,
                "hyperspace.index.compaction.bucketsPerStep": 3, **conf}
        self.s = {}
        for k, mod in PKGS.items():
            c = dict(base, **{"hyperspace.system.path": str(self.trees[k])})
            if k == "torch":
                c["hyperspace.torch.device"] = "cpu"
            self.s[k] = mod.HyperspaceSession(mod.HyperspaceConf(c))
        self.hs = {k: mod.Hyperspace(self.s[k]) for k, mod in PKGS.items()}

    def write(self, name, n, seed, key_base=0):
        rng = np.random.default_rng(seed)
        jax_avro.write_avro(self.src / f"{name}.avro", JB.from_pydict({
            "k": (key_base + rng.integers(0, 6000, n)).astype(np.int64),
            "v": rng.integers(0, 1000, n).astype(np.int64),
            "s": rng.choice(["aa", "bb", "cc"], n).astype(object)}, schema=_LI))

    def create(self):
        for k, mod in PKGS.items():
            self.hs[k].create_index(self.s[k].read.avro(str(self.src)),
                                    mod.IndexConfig("li", ["k"], ["v", "s"]))

    def verb(self, name, *args):
        out = {}
        for k in PKGS:
            try:
                out[k] = getattr(self.hs[k], name)(*args)
            except Exception as e:  # noqa: BLE001 - compared across packages
                out[k] = f"{type(e).__name__}: {e}"
        assert out["jax"] == out["torch"], (name, args, out)
        return out["torch"]

    def rows(self, k, enabled=True):
        s, mod = self.s[k], PKGS[k]
        s.enable_hyperspace() if enabled else s.disable_hyperspace()
        col = mod.col
        li = s.read.avro(str(self.src))
        qs = {"point": li.filter(col("k") == 4321).select("k", "v", "s"),
              "range": li.filter((col("k") >= 100) & (col("k") < 5000)).select("k", "v")}
        out = {n: _rows(q.collect()) for n, q in qs.items()}
        if k == "torch" and enabled:
            for n in qs:
                assert qs[n].optimized_plan().collect(
                    lambda x: isinstance(x, torch_ir.IndexScan)), n
        s.disable_hyperspace()
        return out

    def check(self):
        views = {k: sorted(_entry_json(e, self.trees[k])
                           for e in self.s[k].collection_manager.get_indexes())
                 for k in PKGS}
        assert views["jax"] == views["torch"]
        vb = {k: _version_bytes(self.trees[k], "li") for k in PKGS}
        assert vb["jax"] == vb["torch"]
        truth = self.rows("jax", enabled=False)
        for k in PKGS:
            assert self.rows(k) == truth, k
        return vb["torch"]

    def files(self):
        return TorchLog(self.trees["torch"] / "li").get_latest_stable_log().content.files()


def test_refresh_lineage_rewrite_over_run_files_matches(tmp_path):
    """RF1 appended (streamed as new run files), then RF2 removes a base
    file: the lineage rewrite reads every run through the segment planner,
    drops the deleted file's rows, and rewrites each run with recomputed
    bucketCounts and its other footer extras carried over; then a full
    refresh streams the whole source again — the same entries, bytes and
    rows as the reference."""
    p = Pair(tmp_path)
    for i in range(3):
        p.write(f"p{i}", 2500, i)
    p.create()
    p.check()
    p.write("rf1", 700, 9, key_base=6000)
    assert p.verb("refresh_index", "li", "incremental") is None
    p.check()
    (p.src / "p1.avro").unlink()
    tmetrics.reset()
    assert p.verb("refresh_index", "li", "incremental") is None
    assert tmetrics.get("io.segment.sweeps") >= 1
    vb = p.check()
    latest = max(v for v, _ in vb)
    runs = [f for f in p.files() if tlayout.is_run_file(f)]
    assert runs and all(Path(f).parent.name == latest for f in runs)
    for f in runs:
        footer = tlayout.read_footer(f)
        assert footer["extra"]["indexName"] == "li"
        assert sum(footer["extra"]["bucketCounts"]) == footer["numRows"]
    # a full refresh rebuilds the whole source through the streaming build
    p.write("rf1b", 500, 10, key_base=7000)
    tmetrics.reset()
    assert p.verb("refresh_index", "li", "full") is None
    assert tmetrics.get("build.stream.rows") == 2 * 2500 + 700 + 500
    p.check()


def test_optimize_over_run_files_matches(tmp_path):
    """optimize(quick) compacts every run into per-bucket files through the
    merge pool: the same entries, bytes and rows as the reference."""
    p = Pair(tmp_path, **{"hyperspace.index.build.mergeWorkers": 3})
    for i in range(2):
        p.write(f"p{i}", 3000, 10 + i)
    p.create()
    assert p.verb("optimize_index", "li", "quick") is None
    vb = p.check()
    files = p.files()
    assert len(files) == N_BUCKETS and not any(tlayout.is_run_file(f) for f in files)
    assert max(v for v, _ in vb) == "v__=1"


def test_compact_index_step_by_step_matches_and_converges(tmp_path):
    """compact_index with 3 buckets a step over 8 buckets: each step's log
    entry and each v__=N directory's bytes equal the reference's (checked
    after every step through max_steps=1), the rows stay the source's, and
    the converged layout has no run file and equals optimize(quick)'s."""
    p = Pair(tmp_path)
    for i in range(3):
        p.write(f"p{i}", 2000, 20 + i)
    p.create()
    p.check()
    steps = []
    while True:
        tmetrics.reset()
        out = p.verb("compact_index", "li", 1)
        p.check()
        if out["steps"] == 0:
            assert out == {"steps": 0, "converged": True}
            break
        steps.append((out, tmetrics.get("compaction.buckets"),
                      tmetrics.get("compaction.runs_rewritten"),
                      tmetrics.get("compaction.runs_consumed")))
        assert "compaction.step_wall" in tmetrics.timings()
    assert [s[0]["steps"] for s in steps] == [1, 1, 1]
    assert [s[1] for s in steps] == [3, 3, 2]
    assert steps[-1][0]["converged"] and steps[-1][3] > 0
    files = p.files()
    assert not any(tlayout.is_run_file(f) for f in files)
    log = TorchLog(p.trees["torch"] / "li")
    assert log.get_latest_log().state == "ACTIVE"
    # the converged layout is optimize(quick)'s
    q = Pair(tmp_path / "opt")
    q.src = p.src
    q.create()
    q.verb("optimize_index", "li", "quick")
    conv = {int(Path(f).name[1:6]): tlayout.read_batch(f) for f in files}
    opt = {int(Path(f).name[1:6]): tlayout.read_batch(f) for f in q.files()}
    assert sorted(conv) == sorted(opt)
    for b in conv:
        for c in ("k", "v", "s", "_data_file_id"):
            assert np.array_equal(conv[b].columns[c].to_values(), opt[b].columns[c].to_values())


def test_compactor_outcomes_match(tmp_path):
    """step's outcomes in both packages: "conflict" while another writer
    holds a transient head, "committed" after cancel, "converged" once no
    run file is left; sweep advances every eligible index by one step."""
    p = Pair(tmp_path)
    p.write("p0", 3000, 30)
    p.create()
    comps = {"jax": jax_compactor.IndexCompactor(p.s["jax"]),
             "torch": torch_compactor.IndexCompactor(p.s["torch"])}

    def step(name):
        out = {k: c.step(name) for k, c in comps.items()}
        assert out["jax"] == out["torch"], out
        return out["torch"]

    # a writer died mid-refresh: its transient head is a conflict
    for k in PKGS:
        mod_log = (TorchLog if k == "torch" else JaxLog)(p.trees[k] / "li")
        head = mod_log.get_latest_log()
        head.id += 1
        head.state = "REFRESHING"
        assert mod_log.write_log(head.id, head)
    assert step("li") == "conflict"
    for k in PKGS:
        p.hs[k].cancel("li")
    assert step("li") == "committed"
    sweeps = {k: c.sweep() for k, c in comps.items()}
    assert sweeps["jax"] == sweeps["torch"] == {"li": {"steps": 1, "converged": False}}
    while step("li") == "committed":
        pass
    assert step("li") == "converged"
    p.check()


def test_partition_compactable_with_run_files_matches(tmp_path):
    """optimize(quick)'s partition rule with run files among per-bucket
    files: run files are always compactable and their buckets join the
    eligible set, in both packages alike."""
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch as TB

    run = tmp_path / "v__=0" / tlayout.run_file_name(0)
    tlayout.write_batch(run, TB.from_pydict({"k": np.arange(6, dtype=np.int64)}),
                        extra={"bucketCounts": [0, 2, 0, 4, 0, 0, 0, 0]})
    fi = lambda name, size: SimpleNamespace(name=name, size=size)  # noqa: E731
    infos = [fi(str(run), 10), fi("b00002-aaaaaaaaaaaa.tcb", 5000),
             fi("b00003-bbbbbbbbbbbb.tcb", 10), fi("b00004-dddddddddddd.tcb", 10),
             fi("b00004-eeeeeeeeeeee.tcb", 30)]
    for quick in (True, False):
        got = [m.partition_compactable(infos, 1000, quick=quick)
               for m in (jax_compactor, torch_compactor)]
        view = [({b: [f.name for f in v] for b, v in g[0].items()},
                 [f.name for f in g[1]], g[2], sorted(f.name for f in g[3])) for g in got]
        assert view[0] == view[1]
        assert view[1][2] == {1, 3}
    assert jlayout.plan_segment_reads([run])[0].ranges == \
        tlayout.plan_segment_reads([run])[0].ranges
