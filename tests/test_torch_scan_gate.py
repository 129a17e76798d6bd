"""Parity of the port's scan-gate counters and bucket heat
(``hyperspace_tpu_torch/exec/scan_gate.py``) with the JAX package's on
the CPU: heat per index root and the cap of 64 roots, the resident-bypass
counters per kind (direct, and from the resident scan's plain and
compressed tiers), the heat a run-file lookup and a join over run files
note, and the compactor's bucket order under the same heat. The routing
half of the reference's gate (its probe ladder) is not ported, so the
port's ``snapshot()`` is empty. Mirrors the counter and heat cases of
``tests/test_scan_gate.py`` and ``tests/test_compactor.py``. Tolerance:
exact.
"""

from pathlib import Path

import numpy as np
import pytest

from hyperspace_tpu.exec import scan_gate as jgate
from hyperspace_tpu.index.log_manager import IndexLogManagerImpl as JaxLog
from hyperspace_tpu.telemetry.metrics import metrics as jmetrics

from hyperspace_tpu_torch.config import ResidencyConf
from hyperspace_tpu_torch.exec import scan_gate as tgate
from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
from hyperspace_tpu_torch.exec.scan import index_scan
from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl as TorchLog
from hyperspace_tpu_torch.plan.expr import col
from hyperspace_tpu_torch.storage import layout as tlayout
from hyperspace_tpu_torch.telemetry.metrics import metrics as tmetrics

from tests.test_torch_compactor import PKGS, Pair

GATES = {"jax": jgate, "torch": tgate}
LOGS = {"jax": JaxLog, "torch": TorchLog}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("HYPERSPACE_TPU_PROBE_CACHE", "")
    monkeypatch.setenv("HYPERSPACE_TPU_TORCH_PROBE_CACHE", "")
    for g in GATES.values():
        g.scan_gate.reset()
    hbm_cache.reset()
    yield
    for g in GATES.values():
        g.scan_gate.reset()
    hbm_cache.reset()


def test_heat_per_root_matches_the_reference():
    touches = [("/ix/a", [3, 1, 3]), ("/ix/b", [0]), ("/ix/a", [1, 7]), (None, [5]),
               (Path("/ix/b"), np.array([0, 2]))]
    for g in GATES.values():
        for root, buckets in touches:
            g.note_bucket_heat(root, buckets)
    for root in ("/ix/a", "/ix/b", "/ix/c", Path("/ix/a")):
        assert tgate.bucket_heat(root) == jgate.bucket_heat(root)
    assert tgate.bucket_heat("/ix/a") == {3: 2, 1: 2, 7: 1}
    assert tgate.bucket_heat("/ix/b") == {0: 2, 2: 1}
    copy = tgate.bucket_heat("/ix/a")
    copy[3] = 99
    assert tgate.bucket_heat("/ix/a")[3] == 2  # a copy, not the live dict
    tgate.scan_gate.reset()
    assert tgate.bucket_heat("/ix/a") == {}


def test_root_cap_of_64_drops_the_oldest_root():
    for g in GATES.values():
        for i in range(70):
            g.note_bucket_heat(f"/ix/r{i:02d}", [i % 5])
        g.note_bucket_heat("/ix/r69", [1])
    assert tgate._HEAT_ROOT_CAP == jgate._HEAT_ROOT_CAP == 64
    for i in range(70):
        root = f"/ix/r{i:02d}"
        assert tgate.bucket_heat(root) == jgate.bucket_heat(root), root
    assert tgate.bucket_heat("/ix/r05") == {} and tgate.bucket_heat("/ix/r06") == {1: 1}
    assert tgate.bucket_heat("/ix/r69") == {4: 1, 1: 1}


def test_bypass_counters_per_kind_match_the_reference():
    kinds = ("plain", "compressed", "streaming", "hybrid", "join", "plain")
    tmetrics.reset()
    jmetrics.reset()
    for g in GATES.values():
        for k in kinds:
            g.scan_gate.note_resident_bypass(k)
    want = {f"scan.gate.resident_bypass_{k}": kinds.count(k) for k in set(kinds)}
    got = {k: v for k, v in tmetrics.snapshot().items() if k.startswith("scan.gate.")}
    ref = {k: v for k, v in jmetrics.snapshot()["counters"].items()
           if k.startswith("scan.gate.resident_bypass")}
    assert got == ref == want
    assert tgate.scan_gate.snapshot() == {}


@pytest.mark.parametrize("compression,kind", [("off", "plain"), ("force", "compressed")])
def test_resident_scan_counts_its_tier(tmp_path, compression, kind):
    """The resident scan notes its tier's bypass, once a query, and the
    per-file path notes none."""
    p = Pair(tmp_path, **{"hyperspace.index.build.finalizeMode": "merge"})
    p.write("p0", 3000, 1)
    p.create()
    files = p.files()
    conf = ResidencyConf(mode="force", min_rows=1, max_block_frac=1.0, compression=compression)
    pred = (col("k") >= 100) & (col("k") < 900)
    tmetrics.reset()
    off = index_scan(files, ["k", "v"], pred, device="cpu",
                     residency=ResidencyConf(mode="off"))
    assert not any(k.startswith("scan.gate.") for k in tmetrics.snapshot())
    table = hbm_cache.prefetch(files, ["k"], "cpu", conf)
    assert table is not None and table.tier == ("resident" if kind == "plain" else kind)
    tmetrics.reset()
    on = index_scan(files, ["k", "v"], pred, device="cpu", residency=conf)
    assert tmetrics.get(f"scan.gate.resident_bypass_{kind}") == 1
    assert sorted(on.columns["k"].data.tolist()) == sorted(off.columns["k"].data.tolist())


def test_lookups_and_joins_over_run_files_note_heat(tmp_path):
    """An equality lookup over run files notes its pinned bucket in both
    packages alike; a join over run files notes every bucket it read."""
    p = Pair(tmp_path)
    p.write("p0", 3000, 2)
    p.create()
    roots = {k: str(p.trees[k] / "li") for k in p.trees}
    for k, mod in PKGS.items():
        s = p.s[k]
        s.enable_hyperspace()
        s.read.avro(str(p.src)).filter(mod.col("k") == 4321).select("k", "v").collect()
        s.disable_hyperspace()
    heat = {k: GATES[k].bucket_heat(roots[k]) for k in roots}
    assert heat["torch"] == heat["jax"] and len(heat["torch"]) == 1
    from hyperspace_tpu_torch.exec.executor import Executor

    Executor._read_groups_by_bucket(p.files(), ["k"])
    after = tgate.bucket_heat(roots["torch"])
    assert set(after) == set(range(8)) and sum(after.values()) == 8 + 1


def test_compactor_takes_the_hottest_buckets_first_as_the_reference(tmp_path):
    p = Pair(tmp_path, **{"hyperspace.index.compaction.bucketsPerStep": 2})
    for i in range(2):
        p.write(f"p{i}", 2000, 40 + i)
    p.create()
    hot = [5, 2]
    for k in p.trees:
        root = str(p.trees[k] / "li")
        for _ in range(3):
            GATES[k].note_bucket_heat(root, hot)
        GATES[k].note_bucket_heat(root, [6])
    p.verb("compact_index", "li", 1)
    p.check()
    for k in p.trees:
        entry = LOGS[k](p.trees[k] / "li").get_latest_stable_log()
        buckets = sorted(tlayout.bucket_of_file(f) for f in entry.content.files()
                         if not tlayout.is_run_file(f))
        assert buckets == sorted(hot), k
