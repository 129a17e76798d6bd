"""Parity of the port's project phase (``hyperspace_tpu_torch/analysis/
project.py`` and HS009-HS013) with the JAX package's, on the CPU.

* Every reference test of the project rules, the project model and the
  review regressions (``tests/test_analysis_rules.py``) runs here with
  its fixture entry points wrapped: each virtual tree goes through both
  ``analyze_project_sources`` (the reference with its HS009-HS013 only)
  and both ``build_project_from_sources``, the findings (code, path,
  line, column, suppressed, message) and the models must be equal, and
  the reference test's own assertions then run on the PORT's result.
* Where the port's device model differs — HS011's device-dispatch
  endpoint and the fences HS012 accepts for an epoch guard — the fixture
  is written out in torch here, with its expected findings.
* Both packages' models over both real trees are equal (modules,
  classes, functions, call sites, lock inventory, acquisitions, field
  accesses and blocking endpoints but device dispatch, which each side
  names in its own model), and HS009, HS010, HS012 and HS013 find the
  same over both.

Tolerance: exact.
"""

import ast
import functools
import importlib.util
import re
import textwrap
from pathlib import Path

import pytest

from hyperspace_tpu.analysis import core as jcore
from hyperspace_tpu.analysis import project as jproject
from hyperspace_tpu.analysis import rules as jrules

from hyperspace_tpu_torch.analysis import analyze_project_sources
from hyperspace_tpu_torch.analysis import core as tcore
from hyperspace_tpu_torch.analysis import project as tproject
from hyperspace_tpu_torch.analysis import rules as trules

REPO = Path(__file__).resolve().parent.parent
PROJECT_CODES = ("HS009", "HS010", "HS011", "HS012", "HS013")
J_PROJECT = [r for r in jrules.REGISTRY if r.code in PROJECT_CODES]
T_PROJECT = [r for r in trules.REGISTRY if isinstance(r, tcore.ProjectRule)]
DEVICE = " device dispatch"


def view(findings):
    return [(f.code, f.path, f.line, f.col, f.suppressed, f.message) for f in findings]


def run_project(sources):
    return analyze_project_sources({p: textwrap.dedent(s) for p, s in sources.items()})


def codes(findings, only=None):
    return [f.code for f in findings
            if not f.suppressed and (only is None or f.code == only)]


def model_view(m):
    """Everything both models share, device dispatch left out of the
    blocking endpoints (each side names its own device)."""
    funcs = {}
    for q, f in m.functions.items():
        funcs[q] = (
            f.module, f.cls, f.name, f.path, f.line, f.epoch_guard,
            [(s.callee, s.raw, s.line, s.col, s.held, s.const_args) for s in f.calls],
            [(a.lock, a.line, a.col, a.held) for a in f.acquires],
            [(a.attr, a.write, a.line, a.col, a.held, a.mutcall) for a in f.accesses],
            [b for b in f.blocking if not b[2].endswith(DEVICE)],
        )
    classes = {q: (c.path, c.line, c.bases, sorted(c.methods), c.lock_attrs, sorted(c.sync_attrs))
               for q, c in m.classes.items()}
    modules = {n: (i.path, i.is_package, i.aliases, sorted(i.functions), sorted(i.classes),
                   i.locks, i.singletons) for n, i in m.modules.items()}
    locks = sorted({lid for i in m.modules.values() for lid in i.locks.values()}
                   | {lid for c in m.classes.values() for lid in c.lock_attrs.values()})
    return {"modules": modules, "classes": classes, "functions": funcs, "locks": locks}


# ---------------------------------------------------------------------------
# the reference's project tests, through both analyzers
# ---------------------------------------------------------------------------
def _reference_tests():
    spec = importlib.util.spec_from_file_location(
        "_ref_analysis_rules", REPO / "tests" / "test_analysis_rules.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tests()
# the project rules' tests, the model's, and the review regressions
REF_TESTS = sorted(
    n for n in vars(REF)
    if re.match(r"test_hs0(09|1[0-3])_", n)
    or n in ("test_call_graph_resolution_over_synthetic_package",
             "test_lock_inventory_identity_is_the_defining_owner",
             "test_blocking_closure_handles_self_recursion")
)
# fixtures that name the reference's fences: written out in torch below
TRANSLATED = {"test_hs012_fence_substitutes_for_epoch_guard"}


def test_reference_project_tests_were_found():
    assert len(REF_TESTS) == 30
    assert TRANSLATED <= set(REF_TESTS)


@pytest.mark.parametrize("name", sorted(set(REF_TESTS) - TRANSLATED))
def test_reference_project_test_runs_on_the_port(name, monkeypatch):
    ref_sources = jcore.analyze_project_sources
    ref_model = jproject.build_project_from_sources
    seen = []

    def both_analyzers(sources, rules=None):
        want = ref_sources(sources, J_PROJECT)
        got = tcore.analyze_project_sources(sources)
        assert view(got) == view(want)
        seen.append("findings")
        return got

    def both_models(sources):
        want = ref_model(sources)
        got = tproject.build_project_from_sources(sources)
        assert model_view(got) == model_view(want)
        seen.append("model")
        return got

    monkeypatch.setattr(REF, "analyze_project_sources", both_analyzers)
    monkeypatch.setattr(jproject, "build_project_from_sources", both_models)
    getattr(REF, name)()
    assert seen, f"{name} reached neither fixture entry point"


def test_project_rules_carry_the_reference_names():
    assert [r.code for r in T_PROJECT] == list(PROJECT_CODES)
    by_code = {r.code: r for r in J_PROJECT}
    for r in T_PROJECT:
        assert (r.name, r.description) == (by_code[r.code].name, by_code[r.code].description)


def test_helpers_match_the_reference():
    src = textwrap.dedent("""
        import numpy as np
        from . import sib
        from .. import ops
        from ..ops.kernels import predicate_mask as pm
        from .sub import thing

        def f(x):
            g(x, 3, 2.5, True, "s", k=7, flag=False)
    """)
    tree = ast.parse(src)
    for module, is_pkg in (("pkg.exec.mod", False), ("pkg.exec", True), ("top", False)):
        assert (tproject.module_aliases(tree, module, is_pkg)
                == jproject.module_aliases(tree, module, is_pkg))
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call))
    assert tproject._const_args(call) == jproject._const_args(call) == ((1, 3), (2, 2.5), ("k", 7))
    for path, root in (("hyperspace_tpu_torch/exec/scan.py", ""),
                       ("/r/hyperspace_tpu_torch/ops/__init__.py", "/r"),
                       ("chip_smoke.py", ""), ("./x/y.py", ".")):
        assert tproject.path_to_module(path, root) == jproject.path_to_module(path, root)


# ---------------------------------------------------------------------------
# HS011 under the torch device model
# ---------------------------------------------------------------------------
_LOCKED_CALLER = """
    import threading

    from . import helper

    _LOCK = threading.Lock()

    def tick(x):
        with _LOCK:
            helper.step(x)
    """


@pytest.mark.parametrize("body, endpoint", [
    ("import torch\n\ndef step(x):\n    return torch.as_tensor(x, device='cuda')\n",
     "'torch.as_tensor' device dispatch"),
    ("import torch\n\ndef step(x):\n    torch.cuda.synchronize()\n",
     "'torch.cuda.synchronize' device dispatch"),
    ("from torch import cuda\n\ndef step(x):\n    cuda.synchronize()\n",
     "'torch.cuda.synchronize' device dispatch"),
])
def test_hs011_torch_call_is_a_device_endpoint(body, endpoint):
    sources = {"pkg/work.py": _LOCKED_CALLER, "pkg/helper.py": body}
    got = [f for f in run_project(sources) if f.code == "HS011"]
    assert [(f.path, f.line, f.suppressed) for f in got] == [("pkg/work.py", 10, False)]
    assert endpoint in got[0].message


def test_hs011_host_only_torch_and_jax_are_not_endpoints():
    """HS007's host-only calls queue nothing on the card, and a ``jax.*``
    call — the reference's device — is no dispatch of the port."""
    host = """
    import jax
    import torch

    def step(x):
        dev = torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available():
            return torch.from_numpy(x), torch.cuda.get_device_name(dev)
        return jax.device_put(x)
    """
    sources = {"pkg/work.py": _LOCKED_CALLER, "pkg/helper.py": host}
    assert codes(run_project(sources), "HS011") == []
    ref = jcore.analyze_project_sources(
        {p: textwrap.dedent(s) for p, s in sources.items()}, J_PROJECT)
    assert [f.code for f in ref] == ["HS011"] and "'jax.device_put'" in ref[0].message


_KERNELS = """
    def predicate_mask(planes, program):
        return planes

    def _helper(planes):
        return planes
    """


@pytest.mark.parametrize("imports, call, fires", [
    ("from ..ops import kernels", "kernels.predicate_mask(x, None)", True),
    ("from ..ops import kernels as K", "K.predicate_mask(x, None)", True),
    ("from ..ops.kernels import predicate_mask", "predicate_mask(x, None)", True),
    ("import hyperspace_tpu_torch.ops.kernels as K", "K.predicate_mask(x, None)", True),
    ("from .. import ops", "ops.hybrid_block_counts_tensor(x)", True),
    # a private helper of kernels.py is no launching wrapper, and a
    # function of another module that shares a wrapper's name is matched
    # by its module, not its name
    ("from ..ops import kernels", "kernels._helper(x)", False),
    ("from . import other", "other.predicate_mask(x, None)", False),
])
def test_hs011_kernel_wrappers_are_matched_exactly(imports, call, fires):
    work = f"""
    import threading

    {imports}

    _LOCK = threading.Lock()

    def launch(x):
        return {call}

    def tick(x):
        with _LOCK:
            launch(x)
    """
    sources = {
        "hyperspace_tpu_torch/__init__.py": "",
        "hyperspace_tpu_torch/ops/__init__.py": "from .kernels import hybrid_block_counts_tensor\n",
        "hyperspace_tpu_torch/ops/kernels.py": _KERNELS,
        "hyperspace_tpu_torch/exec/__init__.py": "",
        "hyperspace_tpu_torch/exec/other.py": _KERNELS,
        "hyperspace_tpu_torch/exec/work.py": work,
    }
    got = [f for f in run_project(sources) if f.code == "HS011"]
    assert len(got) == int(fires), [f.message for f in got]
    if fires:
        assert got[0].line == 13 and DEVICE in got[0].message
        assert "'hyperspace_tpu_torch.ops." in got[0].message


def test_hs011_direct_dispatch_under_a_lock_is_hs002s_not_hs011s():
    sources = {"pkg/m.py": """
    import threading
    import torch

    _LOCK = threading.Lock()

    def tick(x):
        with _LOCK:
            return torch.as_tensor(x, device="cuda")
    """}
    assert codes(run_project(sources), "HS011") == []


def test_hs011_device_dispatch_suppressed():
    sources = {
        "pkg/work.py": _LOCKED_CALLER.replace(
            "helper.step(x)", "helper.step(x)  # hslint: disable=HS011 - fixture"),
        "pkg/helper.py": "import torch\n\ndef step(x):\n    return torch.zeros(4, device='cuda')\n",
    }
    findings = run_project(sources)
    assert codes(findings, "HS011") == []
    assert [(f.code, f.suppressed) for f in findings] == [("HS011", True)]


# ---------------------------------------------------------------------------
# HS012's fences under the torch device model (the reference's
# test_hs012_fence_substitutes_for_epoch_guard, translated)
# ---------------------------------------------------------------------------
def _with_method(method: str) -> dict:
    return {"pkg/cache.py": REF._HS012_GOOD + textwrap.dedent(method).replace("\n", "\n        ")}


@pytest.mark.parametrize("fence", [
    "from .ops import fence\n\nfence(t.device)",
    "from . import ops\n\nops.fence(t.device)",
    "import torch\n\ntorch.cuda.synchronize()",
    "import torch\n\ntorch.cuda.current_stream().synchronize()",
    "ev.synchronize()",
])
def test_hs012_fence_substitutes_for_epoch_guard(fence):
    body = textwrap.indent(fence, "        ")
    sources = _with_method(f"""
    def register_fenced(self, t, ev=None):
{body}
        with self._lock:
            self._tables.append(t)
    """)
    assert codes(run_project(sources), "HS012") == []


def test_hs012_reference_fence_names_are_no_fence_of_the_port():
    """``fence_chain`` is the reference's fence; the port has none of that
    name, so the registration is unguarded here while the reference
    accepts it — and the port's ``fence`` is no fence of the reference."""
    ref_fence = _with_method("""
    def register_fenced(self, t):
        from .ops import fence_chain

        fence_chain([t])
        with self._lock:
            self._tables.append(t)
    """)
    got = [f for f in run_project(ref_fence) if f.code == "HS012"]
    assert len(got) == 1 and "no epoch guard or fence" in got[0].message
    assert jcore.analyze_project_sources(
        {p: textwrap.dedent(s) for p, s in ref_fence.items()}, J_PROJECT) == []
    port_fence = _with_method("""
    def register_fenced(self, t):
        from .ops import fence

        fence(t.device)
        with self._lock:
            self._tables.append(t)
    """)
    assert codes(run_project(port_fence), "HS012") == []
    want = jcore.analyze_project_sources(
        {p: textwrap.dedent(s) for p, s in port_fence.items()}, J_PROJECT)
    assert [(f.code, f.line) for f in want] == [("HS012", got[0].line)]


# ---------------------------------------------------------------------------
# both models over both real trees
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _models(root: str) -> dict:
    """Both packages' models over one real tree, built once per module
    from the port's traversal of it (which, unlike the reference's,
    skips the git-ignored ``_build/``)."""
    port = tproject.contexts_from_paths([REPO / root])
    ref = [(jcore.ModuleContext(c.source, c.path), n, p) for c, n, p in port]
    return {
        "root": root,
        "ref": jproject.build_project(ref),
        "port": tproject.build_project(port),
    }


@pytest.fixture(scope="module", params=["hyperspace_tpu", "hyperspace_tpu_torch"])
def trees(request):
    yield _models(request.param)
    _models.cache_clear()


def test_models_match_over_both_trees(trees):
    ref, port = model_view(trees["ref"]), model_view(trees["port"])
    assert len(port["modules"]) > 100 and len(port["functions"]) > 1000
    assert sorted(port["modules"]) == sorted(ref["modules"])
    assert port["classes"] == ref["classes"]
    assert port["locks"] == ref["locks"]
    assert sorted(port["functions"]) == sorted(ref["functions"])
    for q in ref["functions"]:
        assert port["functions"][q] == ref["functions"][q], q
    assert port == ref


def _tree_findings(model, rules, parse_suppressions):
    sups = {}
    out = []
    for rule in rules:
        for path, line, col, msg in rule.check_project(model):
            if path not in sups:
                sups[path] = parse_suppressions(Path(path).read_text(encoding="utf-8"))
            codes_ = sups[path].get(line, "absent")
            suppressed = codes_ != "absent" and (codes_ is None or rule.code in codes_)
            out.append((rule.code, path, line, col, suppressed, msg))
    return sorted(out)


@pytest.mark.parametrize("code", ["HS009", "HS010", "HS012", "HS013"])
def test_project_rules_match_over_both_trees(trees, code):
    want = _tree_findings(trees["ref"], [r for r in J_PROJECT if r.code == code],
                          jcore.parse_suppressions)
    got = _tree_findings(trees["port"], [r for r in T_PROJECT if r.code == code],
                         tcore.parse_suppressions)
    assert got == want


def test_device_endpoints_follow_the_ports_device_model(trees):
    """Each side names device dispatch in its own model: the port's are
    torch calls outside HS007's host-only list and the launching
    wrappers, the reference's ``jax.*`` calls."""
    from hyperspace_tpu_torch.analysis.rules.hs007_unfenced_device_timing import (
        HOST_ONLY, KERNEL_WRAPPERS)

    port = [d for f in trees["port"].functions.values() for _l, _c, d in f.blocking
            if d.endswith(DEVICE)]
    for d in port:
        raw = d[1:-len(DEVICE) - 1]
        wrapper = raw.rpartition(".")[2] in KERNEL_WRAPPERS and raw.startswith(
            "hyperspace_tpu_torch.ops.")
        assert (raw.startswith("torch.") and raw not in HOST_ONLY) or wrapper, d
    ref = [d for f in trees["ref"].functions.values() for _l, _c, d in f.blocking
           if d.endswith(DEVICE)]
    assert all(d.startswith("'jax.") for d in ref)
    if trees["root"] == "hyperspace_tpu_torch":
        assert port and not ref
        assert any(d.startswith("'hyperspace_tpu_torch.ops.") for d in port)
    else:
        assert ref and not port


def test_session_server_creation_under_its_lock_reaches_no_blocking():
    """``HyperspaceSession.serve`` builds the ``QueryServer`` under
    ``_server_lock``; what the construction reaches of torch is host-only
    (a device handle, ``is_available``, ``current_device``), so the lock
    covers no device dispatch and HS011 rightly stays silent there."""
    m = _models("hyperspace_tpu_torch")["port"]
    serve = m.functions["hyperspace_tpu_torch.session:HyperspaceSession.serve"]
    (site,) = [s for s in serve.calls
               if s.callee == "hyperspace_tpu_torch.serve.server:QueryServer.__init__"]
    assert site.held == ("hyperspace_tpu_torch.session:HyperspaceSession._server_lock",)
    assert m.closure("blocking")[site.callee] == set()
