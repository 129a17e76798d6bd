"""Parity of the port's static analyzer (``hyperspace_tpu_torch/analysis``)
with the JAX package's, on the CPU.

* The rules that name no JAX (HS002-HS006, HS008, HS014) and the
  suppression parser: every fixture source of the reference's rule tests
  (``tests/test_analysis_rules.py``, read from that file) goes through
  both ``analyze_source`` — the reference at a ``hyperspace_tpu/`` path,
  the port at a ``hyperspace_tpu_torch/`` path — and the findings (code,
  line, column, suppressed, message) must be equal; then both analyzers
  run those rules over every module of both packages.
* HS001 and HS007 carry a torch/CUDA device model: each reference test
  has its fixture translated to torch here, with the expected findings.
* The reporters render the same findings alike, and the finding cache
  hits, misses on an edit of a linted file or of an analyzer source.

Tolerance: exact.
"""

import ast
import json
import re
import shutil
import textwrap
from pathlib import Path

import pytest

from hyperspace_tpu.analysis import core as jcore
from hyperspace_tpu.analysis import reporter as jreporter
from hyperspace_tpu.analysis import rules as jrules

from hyperspace_tpu_torch.analysis import analyze_file, analyze_source, summarize
from hyperspace_tpu_torch.analysis import cache as tcache
from hyperspace_tpu_torch.analysis import core as tcore
from hyperspace_tpu_torch.analysis import reporter as treporter
from hyperspace_tpu_torch.analysis import rules as trules
from hyperspace_tpu_torch.analysis.rules import hs014_metric_names as t14

REPO = Path(__file__).resolve().parent.parent
SHARED = ("HS002", "HS003", "HS004", "HS005", "HS006", "HS008", "HS014")
J_RULES = [r for r in jrules.REGISTRY if r.code in SHARED]
T_RULES = [r for r in trules.REGISTRY if r.code in SHARED]
PORT_ONLY_PREFIXES = t14.SUBSYSTEM_PREFIXES - jrules.hs014_metric_names.SUBSYSTEM_PREFIXES
_UNKNOWN_PREFIX = re.compile(r"\('([a-z0-9_]+)' unknown\)")


def view(findings):
    return [(f.code, f.line, f.col, f.suppressed, f.message) for f in findings]


def run(src: str, path: str = "hyperspace_tpu_torch/exec/mod.py"):
    return analyze_source(textwrap.dedent(src), path)


def codes(findings, only=None):
    return [f.code for f in findings
            if not f.suppressed and (only is None or f.code == only)]


# ---------------------------------------------------------------------------
# the rules that name no JAX: the reference's fixtures through both
# ---------------------------------------------------------------------------
def _reference_fixtures():
    """Every multi-line source in the reference's tests of HS002-HS006,
    HS008, HS014 and the suppression parser that parses as Python (the
    tests' docstrings do not)."""
    tree = ast.parse((REPO / "tests" / "test_analysis_rules.py").read_text())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and re.match(r"test_(hs00[2-68]|hs014|suppress)", fn.name)):
            continue
        n = 0
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and "\n" in node.value):
                continue
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out.append(pytest.param(src, id=f"{fn.name}-{n}"))
            n += 1
    return out


FIXTURES = _reference_fixtures()


def test_reference_fixtures_were_found():
    """Every reference test of the shared rules gave at least one source."""
    names = {p.id.rsplit("-", 1)[0] for p in FIXTURES}
    tree = ast.parse((REPO / "tests" / "test_analysis_rules.py").read_text())
    want = {fn.name for fn in tree.body if isinstance(fn, ast.FunctionDef)
            and re.match(r"test_(hs00[2-68]|hs014)", fn.name)}
    assert want <= names, want - names
    assert len(FIXTURES) >= 30


@pytest.mark.parametrize("src", FIXTURES)
def test_shared_rules_match_the_reference_on_its_fixtures(src):
    got = analyze_source(src, "hyperspace_tpu_torch/exec/mod.py", T_RULES)
    want = jcore.analyze_source(src, "hyperspace_tpu/exec/mod.py", J_RULES)
    assert view(got) == view(want)
    assert tcore.parse_suppressions(src) == jcore.parse_suppressions(src)
    assert tcore.iter_suppression_markers(src) == jcore.iter_suppression_markers(src)


def _tree_files(root: str):
    return list(tcore.iter_python_files([REPO / root]))


def _comparable(findings):
    """HS014 findings of a prefix only the port declares are left out: the
    reference flags those names by design."""
    out = []
    for f in findings:
        m = _UNKNOWN_PREFIX.search(f.message) if f.code == "HS014" else None
        if m and m.group(1) in PORT_ONLY_PREFIXES:
            continue
        out.append(f)
    return view(out)


@pytest.mark.parametrize("root", ["hyperspace_tpu", "hyperspace_tpu_torch"])
def test_shared_rules_match_the_reference_over_both_trees(root):
    """Both analyzers' shared rules over every module of ``root``, the
    reference at the module's ``hyperspace_tpu/`` path and the port at its
    ``hyperspace_tpu_torch/`` path: equal findings, equal suppressions."""
    files = _tree_files(root)
    assert len(files) > 100
    for f in files:
        src = f.read_text(encoding="utf-8")
        rel = f.relative_to(REPO / root).as_posix()
        got = analyze_source(src, f"hyperspace_tpu_torch/{rel}", T_RULES)
        want = jcore.analyze_source(src, f"hyperspace_tpu/{rel}", J_RULES)
        assert _comparable(got) == _comparable(want), f
        assert tcore.parse_suppressions(src) == jcore.parse_suppressions(src), f


def test_core_helpers_match_the_reference():
    src = textwrap.dedent("""
        import numpy as np
        import os.path
        from time import sleep as nap
        from ..ops import kernels
        from . import fence

        def f(a):
            np.asarray(a).item()
            kernels.predicate_mask(a)
            self_lock = a._lock
    """)
    tree = ast.parse(src)
    assert tcore.build_aliases(tree) == jcore.build_aliases(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Name, ast.Attribute)):
            assert tcore.dotted_name(node, tcore.build_aliases(tree)) == jcore.dotted_name(
                node, jcore.build_aliases(tree))
            assert tcore.terminal_name(node) == jcore.terminal_name(node)


def test_suppressions_parse_trailing_and_standalone():
    src = textwrap.dedent(
        """
        x = 1  # hslint: disable=HS001,HS002
        # hslint: disable=HS004 - justification text
        # continuation of the justification
        y = 2
        z = 3  # hslint: disable
        s = "# hslint: disable=HS003 (in a string, not a comment)"
        """
    )
    sup = tcore.parse_suppressions(src)
    assert sup == {2: {"HS001", "HS002"}, 5: {"HS004"}, 6: None}
    assert sup == jcore.parse_suppressions(src)


def test_syntax_error_becomes_hs000_finding(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n", encoding="utf-8")
    findings = analyze_file(p)
    assert [f.code for f in findings] == ["HS000"]
    assert not findings[0].suppressed
    assert view(findings) == view(jcore.analyze_file(p))
    assert view(tcore.run_analysis([p])) == view(findings)


def test_suppressed_findings_are_reported_not_dropped():
    src = """
    def hot(dev):
        return dev.item()  # hslint: disable=HS001
    """
    findings = run(src)
    s = summarize(findings)
    assert s["suppressed"] == 1 and s["unsuppressed"] == 0
    assert "(suppressed)" in findings[0].render()


def test_registry_holds_the_per_file_rules_in_code_order():
    """HS001-HS020 in code order: the per-file rules and, HS009-HS013
    and HS015-HS020, the project rules (``tests/test_torch_project.py``
    and ``tests/test_torch_dataflow.py`` hold those)."""
    assert [r.code for r in trules.REGISTRY] == [f"HS{n:03d}" for n in range(1, 21)]
    assert [r.code for r in trules.REGISTRY if isinstance(r, tcore.ProjectRule)] == [
        "HS009", "HS010", "HS011", "HS012", "HS013",
        "HS015", "HS016", "HS017", "HS018", "HS019", "HS020"]
    by_code = {r.code: r for r in jrules.REGISTRY}
    for r in T_RULES:
        assert (r.name, r.description) == (by_code[r.code].name, by_code[r.code].description)


def test_port_prefixes_extend_the_reference_set():
    assert jrules.hs014_metric_names.SUBSYSTEM_PREFIXES < t14.SUBSYSTEM_PREFIXES
    assert PORT_ONLY_PREFIXES == {"device"}
    src = """
    def record(metrics):
        metrics.incr("device.unreachable")
    """
    assert codes(run(src), "HS014") == []
    got = jcore.analyze_source(textwrap.dedent(src), "hyperspace_tpu/x.py", J_RULES)
    assert [f.code for f in got] == ["HS014"]


# ---------------------------------------------------------------------------
# HS001 under the torch device model (one case per reference test)
# ---------------------------------------------------------------------------
def test_hs001_fires_on_readback_idioms_in_scope():
    src = """
    import numpy as np
    import torch

    def hot(arr, dev, ev):
        a = dev.item()
        b = dev.cpu()
        c = dev.tolist()
        d = dev.numpy()
        torch.cuda.synchronize()
        ev.synchronize()
        e = np.asarray(dev)
        f = int(arr[0])
        return a, b, c, d, e, f
    """
    got = [f for f in run(src) if f.code == "HS001"]
    assert [f.line for f in got] == [6, 7, 8, 9, 10, 11, 12, 13]
    assert not any(f.suppressed for f in got)


def test_hs001_clean_outside_scope_and_in_boundary_module():
    src = """
    import numpy as np
    import torch

    def hot(dev):
        torch.cuda.synchronize()
        return dev.item(), dev.cpu(), np.asarray(dev)
    """
    assert codes(run(src, "hyperspace_tpu_torch/storage/mod.py"), "HS001") == []
    assert codes(run(src, "hyperspace_tpu_torch/exec/scan.py"), "HS001") == []
    assert codes(run(src, "hyperspace_tpu_torch/ops/k2_cases.py"), "HS001") == []
    # the reference's tree is out of the port rule's scope, and back
    assert codes(run(src, "hyperspace_tpu/exec/mod.py"), "HS001") == []
    assert len(codes(run(src, "hyperspace_tpu_torch/plan/mod.py"), "HS001")) == 4


def test_hs001_plain_casts_and_argumented_calls_not_flagged():
    src = """
    import numpy as np

    def hot(a, b, t):
        x = t.cpu(memory_format=None)  # an argument: not the bare readback
        return int(np.searchsorted(a, b)), float(a_scalar), t.to("cpu"), x
    """
    assert codes(run(src), "HS001") == []


def test_hs001_suppressed():
    src = """
    def hot(dev, ev):
        ev.synchronize()  # hslint: disable=HS001 - the region's upload
        return dev.cpu()  # hslint: disable=HS001
    """
    findings = run(src)
    assert codes(findings, "HS001") == []
    assert [f.code for f in findings if f.suppressed] == ["HS001", "HS001"]


# ---------------------------------------------------------------------------
# HS007 under the torch device model (one case per reference test)
# ---------------------------------------------------------------------------
def test_hs007_fires_on_unfenced_dispatch_in_span():
    torch_op = """
    import time
    import torch

    def timed_upload(arr):
        t0 = time.perf_counter()
        dev = torch.as_tensor(arr, device="cuda")
        return time.perf_counter() - t0
    """
    got = [f for f in run(torch_op) if f.code == "HS007"]
    assert [(f.line, f.suppressed) for f in got] == [(7, False)]
    assert "'torch.as_tensor' dispatch" in got[0].message
    wrapper = """
    import time

    from ..ops import kernels as K
    from ..ops.kernels import sorted_intersect_tensors

    def timed_counts(prog, cols):
        t0 = time.perf_counter()
        out = K.resident_counts_tensor(prog, cols)
        dt = time.perf_counter() - t0
        t1 = time.perf_counter()
        lt, eq = sorted_intersect_tensors(cols[0], cols[1])
        return out, dt, time.perf_counter() - t1
    """
    got = [f for f in run(wrapper) if f.code == "HS007"]
    assert [f.line for f in got] == [9, 12]
    assert "'K.resident_counts_tensor'" in got[0].message


@pytest.mark.parametrize("fence", [
    "fence(dev.device)",
    "ops.fence(dev.device)",
    "torch.cuda.synchronize()",
    "torch.cuda.current_stream().synchronize()",
    "dev.cpu()",
    "dev.sum().item()",
    "dev.tolist()",
    "np.asarray(dev)",
    "fetch.wait()",
    "DeviceFetch([dev]).wait()",
])
def test_hs007_clean_with_fence_or_readback_in_span(fence):
    src = f"""
    import time
    import numpy as np
    import torch

    from .. import ops
    from ..ops import fence
    from ..ops.build import DeviceFetch

    def timed_upload(arr, fetch):
        t0 = time.perf_counter()
        dev = torch.as_tensor(arr, device="cuda")
        {fence}
        return time.perf_counter() - t0
    """
    assert codes(run(src), "HS007") == []


def test_hs007_recorded_event_is_not_a_fence():
    """The counterpart of the reference's "block_until_ready is not a
    fence": recording an event queues a marker and waits for nothing, and
    a ``wait()`` on a receiver that is no fetch (a condition, a thread
    event) waits for no device work."""
    src = """
    import time
    import torch

    def timed_upload(arr, cond):
        t0 = time.perf_counter()
        dev = torch.as_tensor(arr, device="cuda")
        ev = torch.cuda.Event()
        ev.record()
        cond.wait()
        return time.perf_counter() - t0
    """
    assert codes(run(src), "HS007") == ["HS007"]


def test_hs007_out_of_scope_host_only_and_dispatch_outside_span_clean():
    src = """
    import time
    import torch

    def timed_upload(arr):
        t0 = time.perf_counter()
        dev = torch.as_tensor(arr, device="cuda")
        return time.perf_counter() - t0
    """
    assert codes(run(src, "hyperspace_tpu_torch/storage/mod.py"), "HS007") == []
    assert codes(run(src, "hyperspace_tpu_torch/parallel/mod.py"), "HS007") == ["HS007"]
    src2 = """
    import time
    import torch

    def upload_then_time(arr):
        dev = torch.as_tensor(arr, device="cuda")
        t0 = time.perf_counter()
        host_work()
        return time.perf_counter() - t0
    """
    assert codes(run(src2), "HS007") == []
    host_only = """
    import time
    import torch

    def host_side(arr):
        t0 = time.perf_counter()
        d = torch.device("cuda")
        h = torch.from_numpy(arr)
        ev = torch.cuda.Event()
        s = torch.cuda.current_stream(d)
        ok = torch.cuda.is_available()
        return time.perf_counter() - t0
    """
    assert codes(run(host_only), "HS007") == []


def test_hs007_nested_def_is_its_own_scope():
    src = """
    import time
    import torch

    def outer(arr):
        t0 = time.perf_counter()

        def later():
            return torch.as_tensor(arr, device="cuda")  # deferred: outside the span

        host_work()
        return time.perf_counter() - t0, later
    """
    assert codes(run(src), "HS007") == []


def test_hs007_suppressed():
    src = """
    import time
    import torch

    def timed_upload(arr):
        t0 = time.perf_counter()
        dev = torch.as_tensor(arr, device="cuda")  # hslint: disable=HS007
        return time.perf_counter() - t0
    """
    findings = run(src)
    assert codes(findings, "HS007") == []
    assert any(f.suppressed and f.code == "HS007" for f in findings)


def test_hs007_wrappers_are_the_launching_functions_of_kernels():
    """``KERNEL_WRAPPERS`` holds exactly the public functions of
    ``ops/kernels.py`` that reach ``count_launch`` through the module's own
    calls: a new wrapper must be added there, a removed one taken out."""
    from hyperspace_tpu_torch.analysis.rules import hs007_unfenced_device_timing as t7

    tree = ast.parse((REPO / "hyperspace_tpu_torch" / "ops" / "kernels.py").read_text())
    fns = {f.name: f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)}
    calls = {}
    for name, f in fns.items():
        calls[name] = {tcore.terminal_name(c.func) for c in ast.walk(f)
                       if isinstance(c, ast.Call)} & (set(fns) | {"count_launch"})
    launching = {"count_launch"}
    while True:
        more = {n for n, cs in calls.items() if cs & launching} - launching
        if not more:
            break
        launching |= more
    public = {n for n in launching - {"count_launch"} if not n.startswith("_")
              and any(f.name == n for f in tree.body if isinstance(f, ast.FunctionDef))}
    # the timing helpers launch only what they are handed
    public -= {"resident_smj_amortized"}
    assert public == set(t7.KERNEL_WRAPPERS)


# ---------------------------------------------------------------------------
# reporters and the finding cache
# ---------------------------------------------------------------------------
SAMPLE = [
    ("HS006", "module-level cache 'C' grows here", "hyperspace_tpu_torch/a.py", 3, 4, False),
    ("HS014", "metric/span name 'x' is bad", "hyperspace_tpu_torch/b.py", 10, 0, True),
    ("HS001", ".item() copies a tensor", "chip_smoke.py", 7, 8, False),
]


@pytest.mark.parametrize("show_suppressed", [False, True])
def test_text_and_json_renderings_match_the_reference(show_suppressed):
    t = [tcore.Finding(*row) for row in SAMPLE]
    j = [jcore.Finding(*row) for row in SAMPLE]
    assert treporter.render_text(t, show_suppressed) == jreporter.render_text(j, show_suppressed)
    assert treporter.render_json(t) == jreporter.render_json(j)
    assert treporter.summarize(t) == jreporter.summarize(j)


def test_sarif_matches_the_reference_but_for_its_catalog():
    """Under one rule list the documents differ only in the driver's
    ``informationUri`` (the port's rule catalog, not the reference's docs
    page); under each package's own registry the results differ only in
    ``ruleIndex``, which points into each package's own catalog. The tool
    name is ``hslint`` in both."""
    t = [tcore.Finding(*row) for row in SAMPLE]
    j = [jcore.Finding(*row) for row in SAMPLE]
    got = json.loads(treporter.render_sarif(t, jrules.REGISTRY, base=REPO))
    want = json.loads(jreporter.render_sarif(j, jrules.REGISTRY, base=REPO))
    gd, wd = got["runs"][0]["tool"]["driver"], want["runs"][0]["tool"]["driver"]
    assert gd.pop("informationUri") == "hyperspace_tpu_torch/analysis/rules/__init__.py"
    assert wd.pop("informationUri") == "docs/09-static-analysis.md"
    assert got == want
    own = json.loads(treporter.render_sarif(t, base=REPO))
    ref = json.loads(jreporter.render_sarif(j, base=REPO))
    assert own["runs"][0]["tool"]["driver"]["name"] == "hslint"
    catalog = [r["id"] for r in own["runs"][0]["tool"]["driver"]["rules"]]
    assert catalog == [r.code for r in trules.REGISTRY]
    strip = [{k: v for k, v in r.items() if k != "ruleIndex"} for r in own["runs"][0]["results"]]
    assert strip == [{k: v for k, v in r.items() if k != "ruleIndex"}
                     for r in ref["runs"][0]["results"]]
    for r in own["runs"][0]["results"]:
        assert catalog[r["ruleIndex"]] == r["ruleId"]
        assert r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"].endswith(".py")


def test_cache_hits_and_invalidates_on_a_linted_file_and_on_the_analyzer(tmp_path, monkeypatch):
    target = tmp_path / "mod.py"
    target.write_text("CACHE = {}\ndef put(k, v):\n    CACHE[k] = v\n", encoding="utf-8")
    cache_dir = tmp_path / "cache"

    def key():
        return tcache.cache_key(tcache.file_hashes([target]), tcache.analyzer_signature(),
                                argv=[str(target)])

    findings = tcore.run_analysis([target])
    assert [f.code for f in findings] == ["HS006"]
    k1 = key()
    assert tcache.load(cache_dir, k1) is None
    tcache.store(cache_dir, k1, findings)
    assert tcache.load(cache_dir, k1) == findings
    # an edit of the linted file: a new key
    target.write_text(target.read_text() + "# touched\n", encoding="utf-8")
    k2 = key()
    assert k2 != k1 and tcache.load(cache_dir, k2) is None
    # an edit of an analyzer source: a new signature, so a new key
    copy = tmp_path / "analysis"
    shutil.copytree(Path(tcache.__file__).parent, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(tcache, "__file__", str(copy / "cache.py"))
    assert key() == k2
    rule = copy / "rules" / "hs006_unbounded_cache.py"
    rule.write_text(rule.read_text() + "\n# edited\n", encoding="utf-8")
    assert key() != k2
    # a corrupt entry is a miss, never an error
    (cache_dir / f"{k1}.json").write_text("{not json", encoding="utf-8")
    assert tcache.load(cache_dir, k1) is None
