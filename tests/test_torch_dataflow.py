"""Parity of the port's value-flow phase (``hyperspace_tpu_torch/analysis/
dataflow.py`` and HS015-HS020) with the JAX package's, on the CPU.

* HS018 and HS020 name no device: every reference test of them
  (``tests/test_analysis_rules.py``) runs here with its fixture entry
  point wrapped, each virtual tree through both analyzers (each with its
  HS018 and HS020 only); the findings (code, path, line, column,
  suppressed, message) must be equal, and the reference test's own
  assertions then run on the PORT's result.
* HS015, HS016, HS017 and HS019 read the value flow's device model,
  which is torch's here: each reference test has a torch translation of
  its fixture below with the same expected findings (HS017's lexical
  scope, which torch has not, is the recorded exception), and each case
  of the device model has a fixture of its own.
* Over both real trees the reach sets (``traced_reach``,
  ``declined_reach``, ``degrade_reach``) and each function's
  ``traces_bytes``, ``declined_incr`` and ``degrade_incr`` are equal
  between the analyzers, HS018 and HS020 find the same, and the port's
  repairs stay pinned in its flow.

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
from hyperspace_tpu.analysis import dataflow as jflow
from hyperspace_tpu.analysis import project as jproject
from hyperspace_tpu.analysis import rules as jrules

from hyperspace_tpu_torch.analysis import analyze_project_sources
from hyperspace_tpu_torch.analysis import core as tcore
from hyperspace_tpu_torch.analysis import dataflow as tflow
from hyperspace_tpu_torch.analysis import project as tproject
from hyperspace_tpu_torch.analysis import rules as trules

REPO = Path(__file__).resolve().parent.parent
AS_WRITTEN = ("HS018", "HS020")
J_WRITTEN = [r for r in jrules.REGISTRY if r.code in AS_WRITTEN]
T_WRITTEN = [r for r in trules.REGISTRY if r.code in AS_WRITTEN]


def view(findings):
    return [(f.code, f.path, f.line, f.col, f.suppressed, f.message) for f in findings]


def run_project(sources):
    return analyze_project_sources({p: textwrap.dedent(s) for p, s in sources.items()})


def codes(findings, only=None):
    return [f.code for f in findings
            if not f.suppressed and (only is None or f.code == only)]


def flow_of(sources):
    model = tproject.build_project_from_sources(
        {p: textwrap.dedent(s) for p, s in sources.items()})
    return model.device_flow()


# ---------------------------------------------------------------------------
# HS018 and HS020: the reference's tests through both analyzers
# ---------------------------------------------------------------------------
def _reference_tests():
    spec = importlib.util.spec_from_file_location(
        "_ref_analysis_rules_flow", REPO / "tests" / "test_analysis_rules.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tests()
REF_WRITTEN = sorted(n for n in vars(REF) if re.match(r"test_hs0(18|20)_", n))
REF_TRANSLATED = sorted(n for n in vars(REF) if re.match(r"test_hs01[5679]_", n))


def test_reference_flow_tests_were_found():
    """Nine reference tests run as written; each of the other 21 has a
    torch translation of the same name in this module."""
    assert len(REF_WRITTEN) == 9
    assert len(REF_TRANSLATED) == 21
    missing = [n for n in REF_TRANSLATED if not callable(globals().get(n))]
    assert missing == []


@pytest.mark.parametrize("name", REF_WRITTEN)
def test_reference_hs018_hs020_test_runs_on_the_port(name, monkeypatch):
    seen = []

    def both_analyzers(sources, rules=None):
        want = jcore.analyze_project_sources(sources, J_WRITTEN)
        got = tcore.analyze_project_sources(sources, T_WRITTEN)
        assert view(got) == view(want)
        seen.append(len(got))
        return got

    monkeypatch.setattr(REF, "analyze_project_sources", both_analyzers)
    getattr(REF, name)()
    assert seen, f"{name} reached no fixture entry point"


def test_rules_carry_the_reference_names():
    """HS015, HS016, HS018, HS019 and HS020 keep the reference's names;
    HS017 guards torch's default float dtype and is named for it.
    Descriptions name the port's device."""
    by_code = {r.code: r for r in jrules.REGISTRY}
    port = {r.code: r for r in trules.REGISTRY}
    for code in ("HS015", "HS016", "HS018", "HS019", "HS020"):
        assert port[code].name == by_code[code].name
    for code in AS_WRITTEN:
        assert port[code].description == by_code[code].description
    assert port["HS017"].name == "float-narrowed-by-default-dtype"
    assert isinstance(port["HS017"], tcore.ProjectRule)


def test_shared_helpers_match_the_reference():
    assert tflow.DEGRADE_NEEDLES == jflow.DEGRADE_NEEDLES
    assert tflow._STRUCTURAL_PARAM_RE.pattern == jflow._STRUCTURAL_PARAM_RE.pattern
    src = textwrap.dedent("""
        def f(a, b=1, *c, d, **e):
            g = lambda x: x + a + z
            return [y for y in b] + w
        class K:
            def m(self, p, q):
                return p
        metrics.incr(f"serve.{x}.declined.lost")
        metrics.incr("hbm." + "declined")
    """)
    tree = ast.parse(src)
    fn, klass = tree.body[0], tree.body[1]
    assert tflow.param_names(fn, False) == jflow.param_names(fn, False) == ["a", "b"]
    meth = klass.body[0]
    assert tflow.param_names(meth, True) == jflow.param_names(meth, True) == ["p", "q"]
    assert tflow._free_names(fn) == jflow._free_names(fn) >= {"z", "w"}
    for call in (tree.body[2].value, tree.body[3].value):
        for needle in ("declined", "lost", "hbm", "shed"):
            assert (tflow._str_contains(call.args[0], needle)
                    == jflow._str_contains(call.args[0], needle))


# ---------------------------------------------------------------------------
# HS015 under the torch device model (the reference's fixtures, translated)
# ---------------------------------------------------------------------------
def test_hs015_fires_on_cast_of_proven_device_value():
    sources = {
        "pkg/hot.py": """
        import torch

        def hot(x):
            dev = torch.as_tensor(x, device="cuda").square()
            return float(dev)
        """
    }
    assert codes(run_project(sources), "HS015") == ["HS015"]


def test_hs015_interprocedural_device_return():
    sources = {
        "pkg/a.py": """
        import torch

        def make(x):
            return torch.square(x.cuda())
        """,
        "pkg/b.py": """
        from . import a

        def hot(x):
            return int(a.make(x))
        """,
    }
    assert codes(run_project(sources), "HS015") == ["HS015"]


def test_hs015_clean_on_host_values_boundary_and_traced():
    sources = {
        # host values: never classified device, must not invent
        "pkg/host.py": """
        import numpy as np
        import torch

        def f(xs):
            t = torch.from_numpy(np.asarray(xs))
            return float(np.max(np.asarray(xs))) + float(t.sum())
        """,
        # boundary module: exec.* is where materializing is the job
        "pkg/exec/leg.py": """
        import torch
        from ..tel import add_bytes

        def leg(x, device):
            out = float(torch.square(x.to(device)).sum())
            add_bytes("d2h_bytes", 8)
            return out
        """,
        # traced: the D2H is declared and accounted — excused
        "pkg/traced.py": """
        import torch
        from .tel import add_bytes

        def declared(x):
            out = float(torch.square(x.cuda()).sum())
            add_bytes("d2h_bytes", 8)
            return out
        """,
        "pkg/tel.py": """
        def add_bytes(key, n):
            pass
        """,
    }
    assert codes(run_project(sources), "HS015") == []


def test_hs015_container_of_device_values_iterates_free():
    sources = {
        "pkg/lists.py": """
        import torch

        def per_lane(xs, dev):
            lanes = [torch.square(x.to(dev)) for x in xs]
            acc = 0.0
            for lane in lanes:
                acc = acc + lane
            return acc
        """
    }
    assert codes(run_project(sources), "HS015") == []


def test_hs015_rebind_to_host_clears_device_judgement():
    # after lo = lo.cpu() the name is host-valued; only the .cpu() site
    # itself is the readback
    sources = {
        "pkg/rebind.py": """
        import torch

        def fetch(x):
            lo = torch.square(x.cuda())
            lo = lo.cpu()
            return float(lo)
        """
    }
    found = [f for f in run_project(sources) if f.code == "HS015"]
    assert [(f.line, f.suppressed) for f in found] == [(6, False)]
    assert ".cpu() copies" in found[0].message


def test_hs015_suppressed():
    sources = {
        "pkg/hot.py": """
        import torch

        def hot(x):
            dev = torch.as_tensor(x, device="cuda").square()
            return float(dev)  # hslint: disable=HS015 - fixture
        """
    }
    found = [f for f in run_project(sources) if f.code == "HS015"]
    assert [f.suppressed for f in found] == [True]


@pytest.mark.parametrize("module, skipped", [
    ("pkg/hot.py", False),
    ("chip_smoke.py", True),
    ("hyperspace_tpu_torch/tools/probe.py", True),
    ("hyperspace_tpu_torch/ops/k2_cases.py", True),
    ("hyperspace_tpu_torch/ops/k1b_cases.py", True),
    ("hyperspace_tpu_torch/ops/__init__.py", True),
    ("hyperspace_tpu_torch/ops/hashing.py", False),
    ("hyperspace_tpu_torch/residency/tiers.py", True),
])
def test_hs015_boundary_and_skipped_modules_of_the_port(module, skipped):
    src = """
    import torch

    def readback(n):
        return torch.arange(n, device="cuda").sum().item()
    """
    assert codes(run_project({module: src}), "HS015") == ([] if skipped else ["HS015"])


# ---------------------------------------------------------------------------
# HS016 on torch's compilers (the reference's fixtures, translated)
# ---------------------------------------------------------------------------
_HS016_FACTORY_BAKES_LITERAL = """
    import torch

    _CACHE = {}

    def counts_fn(lo, n_rows):
        key = (lo, n_rows)
        if key not in _CACHE:
            def body(x):
                return x + lo
            _CACHE[key] = torch.compile(body)
        return _CACHE[key]
"""

_HS016_FACTORY_TRACED_OPERAND = """
    import torch

    _CACHE = {}

    def counts_fn(n_rows):
        key = (n_rows,)
        if key not in _CACHE:
            def body(x, lo):
                return x + lo
            _CACHE[key] = torch.compile(body)
        return _CACHE[key]
"""


def test_hs016_fires_at_the_literal_binding_call_site():
    sources = {
        "pkg/fac.py": _HS016_FACTORY_BAKES_LITERAL,
        "pkg/use.py": """
        from .fac import counts_fn

        def run(x):
            fn = counts_fn(3, 128)
            return fn(x)
        """,
    }
    found = [f for f in run_project(sources) if f.code == "HS016"]
    # lo is the hazard; n_rows is structural by name and exempt
    assert len(found) == 1
    assert found[0].path == "pkg/use.py"
    assert "'lo'" in found[0].message


def test_hs016_clean_when_literal_ships_as_traced_operand():
    sources = {
        "pkg/fac.py": _HS016_FACTORY_TRACED_OPERAND,
        "pkg/use.py": """
        from .fac import counts_fn

        def run(x):
            fn = counts_fn(128)
            return fn(x, 3)
        """,
    }
    assert codes(run_project(sources), "HS016") == []


def test_hs016_runtime_values_never_fire():
    sources = {
        "pkg/fac.py": _HS016_FACTORY_BAKES_LITERAL,
        "pkg/use.py": """
        from .fac import counts_fn

        def run(x, bound):
            fn = counts_fn(bound, 128)
            return fn(x)
        """,
    }
    assert codes(run_project(sources), "HS016") == []


def test_hs016_uncached_factory_is_not_a_hazard():
    sources = {
        "pkg/fac.py": """
        import torch

        def counts_fn(lo):
            def body(x):
                return x + lo
            return torch.compile(body)
        """,
        "pkg/use.py": """
        from .fac import counts_fn

        def run(x):
            return counts_fn(3)(x)
        """,
    }
    assert codes(run_project(sources), "HS016") == []


def test_hs016_suppressed():
    sources = {
        "pkg/fac.py": _HS016_FACTORY_BAKES_LITERAL,
        "pkg/use.py": """
        from .fac import counts_fn

        def run(x):
            fn = counts_fn(3, 128)  # hslint: disable=HS016 - fixture
            return fn(x)
        """,
    }
    found = [f for f in run_project(sources) if f.code == "HS016"]
    assert [f.suppressed for f in found] == [True]


@pytest.mark.parametrize("wrap", [
    "torch.compile(body)", "torch.jit.script(body)", "torch.jit.trace(body, (x0,))",
    "torch.cuda.make_graphed_callables(body, (x0,))",
])
def test_hs016_every_torch_compiler_is_a_factory(wrap):
    fac = _HS016_FACTORY_BAKES_LITERAL.replace(
        "def counts_fn(lo, n_rows):", "def counts_fn(lo, n_rows, x0=None):").replace(
        "torch.compile(body)", wrap)
    sources = {"pkg/fac.py": fac, "pkg/use.py": """
        from .fac import counts_fn

        def run(x):
            return counts_fn(3, 128)(x)
        """}
    assert codes(run_project(sources), "HS016") == ["HS016"]
    (jf,) = flow_of(sources).flows["pkg.fac:counts_fn"].jit_factories
    assert (jf.body, jf.closure_params, jf.key_params, jf.cached) == (
        "body", ("lo",), ("lo", "n_rows"), True)


def test_hs016_compiled_callable_call_is_a_device_value():
    """Calling what a factory returns is the compiled program's result:
    device, as calling the reference's jitted callable is."""
    sources = {"pkg/fac.py": """
        import torch

        def counts_fn(lo):
            def body(x):
                return x + lo
            return torch.compile(body)
        """, "pkg/use.py": """
        from .fac import counts_fn

        def run(x):
            fn = counts_fn(3)
            out = fn(x)
            return float(out)
        """}
    fl = flow_of(sources)
    assert fl.flows["pkg.fac:counts_fn"].returns_jit
    assert [e.kind for e in fl.flows["pkg.use:run"].d2h] == ["float"]
    assert codes(run_project(sources), "HS015") == ["HS015"]


# ---------------------------------------------------------------------------
# HS017: torch's default float dtype (the reference's x64 fixtures,
# translated; torch has no lexical scope — the recorded decision)
# ---------------------------------------------------------------------------
def test_hs017_fires_on_bare_int64_reference():
    sources = {
        "pkg/m.py": """
        import torch

        def widen(n):
            return torch.full((n,), 0.1)
        """
    }
    assert codes(run_project(sources), "HS017") == ["HS017"]


def test_hs017_lexical_and_module_scopes_are_clean():
    """Module scope: ``set_default_dtype(torch.float64)`` at import, in the
    module or an ancestor package's ``__init__``. Torch has no lexical
    scope (no counterpart of ``with enable_x64(True)``); the site's own
    cover is ``dtype=``."""
    sources = {
        "pkg/site.py": """
        import torch

        def widen(n):
            return torch.full((n,), 0.1, dtype=torch.float64)
        """,
        "pkg/mod.py": """
        import torch

        torch.set_default_dtype(torch.float64)

        def widen(n):
            return torch.tensor([0.5, 1.5]) + torch.arange(0.0, n, 0.5)
        """,
        "pkg/sub/__init__.py": """
        import torch

        torch.set_default_dtype(torch.double)
        """,
        "pkg/sub/leaf.py": """
        import torch

        def widen(n):
            return torch.linspace(0.0, 1.0, n)
        """,
        # an integer literal keeps int64: nothing to narrow
        "pkg/ints.py": """
        import torch

        def count(n):
            return torch.full((n,), 7) + torch.arange(n)
        """,
    }
    assert codes(run_project(sources), "HS017") == []


def test_hs017_enable_x64_false_region_does_not_cover():
    """``set_default_dtype(torch.float32)`` covers nothing (as
    ``enable_x64(False)`` does not), and neither does a float64 default
    set inside a function: it is no import-time scope."""
    sources = {
        "pkg/m.py": """
        import torch

        torch.set_default_dtype(torch.float32)

        def narrow(n):
            return torch.full((n,), 0.1)
        """,
        "pkg/late.py": """
        import torch

        def narrow(n):
            torch.set_default_dtype(torch.float64)
            return torch.as_tensor([0.25, 0.5])
        """,
    }
    found = [f for f in run_project(sources) if f.code == "HS017"]
    assert sorted(f.path for f in found) == ["pkg/late.py", "pkg/m.py"]


def test_hs017_caller_coverage_is_interprocedural():
    covered = {
        "pkg/h.py": """
        import torch

        def helper(n):
            return torch.full((n,), 0.1)
        """,
        "pkg/entry.py": """
        import torch
        from . import h

        torch.set_default_dtype(torch.float64)

        def entry(n):
            return h.helper(n)
        """,
    }
    assert codes(run_project(covered), "HS017") == []
    uncovered = dict(covered)
    uncovered["pkg/entry.py"] = """
        from . import h

        def entry(n):
            return h.helper(n)
        """
    assert codes(run_project(uncovered), "HS017") == ["HS017"]


def test_hs017_suppressed():
    sources = {
        "pkg/m.py": """
        import torch

        def widen(n):
            return torch.full((n,), 0.1)  # hslint: disable=HS017 - fixture
        """
    }
    found = [f for f in run_project(sources) if f.code == "HS017"]
    assert [f.suppressed for f in found] == [True]


def test_hs017_nested_def_is_attributed_to_its_enclosing_function():
    sources = {"pkg/m.py": """
        import torch

        def outer(n):
            def inner():
                return torch.tensor(2.5)
            return inner
        """}
    fl = flow_of(sources).flows["pkg.m:outer"]
    assert [(ln, sp) for ln, _c, sp in fl.dtype64] == [(6, "torch.tensor")]
    assert codes(run_project(sources), "HS017") == ["HS017"]


# ---------------------------------------------------------------------------
# HS019 under the torch device model (the reference's fixtures, translated)
# ---------------------------------------------------------------------------
def test_hs019_fires_on_untraced_device_put_in_exec():
    sources = {
        "pkg/exec/leg.py": """
        import torch

        def upload(arr, device):
            return torch.from_numpy(arr).to(device)
        """
    }
    assert codes(run_project(sources), "HS019") == ["HS019"]


def test_hs019_clean_when_traced_or_out_of_scope():
    sources = {
        "pkg/exec/ok.py": """
        import torch
        from ..tel import add_bytes

        def upload(arr):
            dev = torch.from_numpy(arr).cuda()
            add_bytes("h2d_bytes", arr.nbytes)
            return dev
        """,
        "pkg/exec/via.py": """
        import torch
        from ..tel import add_bytes

        def _account(n):
            add_bytes("h2d_bytes", n)

        def upload(arr, dev):
            out = torch.as_tensor(arr, device=dev)
            _account(arr.nbytes)
            return out
        """,
        "pkg/other.py": """
        import torch

        def upload(arr):
            return torch.from_numpy(arr).cuda()
        """,
        "pkg/tel.py": """
        def add_bytes(key, n):
            pass
        """,
    }
    assert codes(run_project(sources), "HS019") == []


def test_hs019_scalar_item_is_not_a_bandwidth_event():
    sources = {
        "pkg/exec/probe.py": """
        import torch

        def peek(n):
            return torch.arange(n, device="cuda").max().item()
        """
    }
    assert codes(run_project(sources), "HS019") == []


def test_hs019_one_finding_per_direction_per_function():
    sources = {
        "pkg/exec/multi.py": """
        import torch

        def upload_all(a, b, c):
            return a.cuda(), b.cuda(), torch.as_tensor(c, device="cuda")
        """
    }
    assert codes(run_project(sources), "HS019") == ["HS019"]


def test_hs019_suppressed():
    sources = {
        "pkg/exec/probe.py": """
        import torch

        def time_link(arr):
            return torch.from_numpy(arr).cuda()  # hslint: disable=HS019 - fixture
        """
    }
    found = [f for f in run_project(sources) if f.code == "HS019"]
    assert [f.suppressed for f in found] == [True]


def test_hs019_fetches_count_as_their_own_direction():
    sources = {
        "pkg/residency/legs.py": """
        import numpy as np
        import torch

        def round_trip(arr, dev):
            t = torch.from_numpy(arr).to(dev)
            back = t.cpu()
            host = np.asarray(torch.square(t))
            return back, host, t.to("cpu")
        """
    }
    found = [f for f in run_project(sources) if f.code == "HS019"]
    assert [(f.line, "uploads" in f.message) for f in found] == [(6, True), (7, False)]
    fl = flow_of(sources).flows["pkg.residency.legs:round_trip"]
    assert [(t.direction, t.api, t.line) for t in fl.transfers] == [
        ("h2d", "to", 6), ("d2h", "cpu", 7), ("d2h", "to", 9)]
    assert [(e.kind, e.line) for e in fl.d2h] == [("cpu", 7), ("asarray", 8), ("cpu", 9)]


# ---------------------------------------------------------------------------
# the torch device model, case by case
# ---------------------------------------------------------------------------
def test_model_dtype_cast_is_no_transfer():
    sources = {"pkg/exec/casts.py": """
        import torch

        def widen(x, device):
            t = torch.as_tensor(x, device=device)
            a = t.to(torch.int64)
            b = t.to(dtype=torch.float32)
            c = t.to(a.dtype)
            return a, b, c

        def unknown(t, target):
            return t.to(target)
        """}
    flow = flow_of(sources)
    fl = flow.flows["pkg.exec.casts:widen"]
    assert [(t.direction, t.api, t.line) for t in fl.transfers] == [("h2d", "as_tensor", 5)]
    assert fl.device_return
    un = flow.flows["pkg.exec.casts:unknown"]
    assert not un.transfers and not un.device_return


@pytest.mark.parametrize("spelling, device", [
    ("dev", True), ("device", True), ('"cuda:1"', True), ('torch.device("cuda", 0)', True),
    ("resolve_device(where)", True), ("other.device", True), ("t.device", False),
    ('"cpu"', False), ('torch.device("cpu")', False), ("where", False),
])
def test_model_device_spellings(spelling, device):
    """``device=`` makes a device value when it names the card: the
    names ``dev``/``device``, a ``"cuda…"`` string, ``torch.device`` of
    one, ``ops.resolve_device``, and the ``.device`` of a device value —
    not the CPU, an unknown name, or the device of an unknown value."""
    sources = {
        "hyperspace_tpu_torch/ops/__init__.py": "def resolve_device(d=None):\n    return d\n",
        "hyperspace_tpu_torch/exec/m.py": f"""
        import torch
        from ..ops import resolve_device

        def make(n, t, where, dev=None, device=None):
            other = torch.zeros(1, device="cuda")
            return torch.zeros(n, device={spelling})
        """,
    }
    fl = flow_of(sources).flows["hyperspace_tpu_torch.exec.m:make"]
    assert fl.device_return is device


def test_model_device_name_bound_to_the_cpu_is_host():
    sources = {"pkg/m.py": """
        import torch

        def make(n):
            dev = torch.device("cpu")
            return torch.zeros(n, device=dev)
        """}
    assert not flow_of(sources).flows["pkg.m:make"].device_return


def test_model_cpu_is_a_d2h():
    sources = {"pkg/m.py": """
        import torch

        def fetch(n):
            t = torch.arange(n, device="cuda")
            return t.cpu(), t.numpy(), t.cpu().numpy()
        """}
    fl = flow_of(sources).flows["pkg.m:fetch"]
    assert [(e.kind, e.detail) for e in fl.d2h] == [("cpu", "t"), ("numpy", "t"), ("cpu", "t")]
    assert [(t.direction, t.api) for t in fl.transfers] == [("d2h", "cpu"), ("d2h", "cpu")]
    assert not fl.device_return
    assert codes(run_project(sources), "HS015") == ["HS015"] * 3


def test_model_device_fetch_wait_is_host():
    sources = {"pkg/m.py": """
        import torch
        from .build import DeviceFetch

        def fetch(n):
            t = torch.arange(n, device="cuda")
            (h,) = DeviceFetch([t]).wait()
            return float(h[0]), int(t.numel()), t.size(0)
        """, "pkg/build.py": """
        class DeviceFetch:
            def __init__(self, tensors):
                self._src = list(tensors)

            def wait(self):
                return [t for t in self._src]
        """}
    fl = flow_of(sources).flows["pkg.m:fetch"]
    assert fl.d2h == [] and fl.transfers == []
    assert codes(run_project(sources), "HS015") == []


_KERNELS = """
    def predicate_mask_tensor(bound, names, cols):
        return cols

    def predicate_mask(bound, arrays, n_rows, device=None):
        return arrays

    def resident_sorted_intersect(l_keys, r_sorted, device=None):
        return None
    """


def test_model_kernel_wrapper_result_is_a_device_value():
    """A launching wrapper's result is device; ``predicate_mask`` hands
    back host arrays and ``resident_sorted_intersect`` a callable whose
    call launches — matched by module and name, as the project model
    matches them."""
    sources = {
        "hyperspace_tpu_torch/__init__.py": "",
        "hyperspace_tpu_torch/ops/__init__.py": "",
        "hyperspace_tpu_torch/ops/kernels.py": _KERNELS,
        "hyperspace_tpu_torch/plan/use.py": """
        from ..ops import kernels as K
        from . import other

        def masks(bound, names, cols, arrays, l, r):
            m = K.predicate_mask_tensor(bound, names, cols)
            h = K.predicate_mask(bound, arrays, 4)
            run = K.resident_sorted_intersect(l, r)
            lt = run()
            o = other.predicate_mask_tensor(bound, names, cols)
            return int(m.sum()), int(h.sum()), int(lt.sum()), int(o.sum())
        """,
        "hyperspace_tpu_torch/plan/other.py": _KERNELS,
    }
    fl = flow_of(sources).flows["hyperspace_tpu_torch.plan.use:masks"]
    assert [e.detail for e in fl.d2h] == ["m.sum()", "lt.sum()"]
    assert codes(run_project(sources), "HS015") == ["HS015", "HS015"]


def test_model_copy_into_a_device_tensor_is_an_upload():
    sources = {"pkg/exec/m.py": """
        import torch

        def stage(arr, dev):
            dst = torch.empty(arr.shape[0], device=dev)
            dst.copy_(torch.from_numpy(arr), non_blocking=True)
            same = torch.zeros_like(dst)
            same.copy_(dst)
            return dst
        """}
    fl = flow_of(sources).flows["pkg.exec.m:stage"]
    assert [(t.direction, t.api, t.line) for t in fl.transfers] == [("h2d", "copy_", 6)]


def test_model_device_arguments_propagate_into_callees():
    sources = {"pkg/m.py": """
        import torch

        def inner(t):
            return t.sum()

        def outer(n):
            return float(inner(torch.ones(n, device="cuda")))

        def host_only(n):
            return inner(torch.ones(n))
        """}
    flow = flow_of(sources)
    assert flow.flows["pkg.m:inner"].device_params == {"t"}
    assert flow.flows["pkg.m:inner"].device_return
    assert [e.kind for e in flow.flows["pkg.m:outer"].d2h] == ["float"]


# ---------------------------------------------------------------------------
# both analyzers over both real trees
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _flows(root: str) -> dict:
    """Both packages' models and value flows over one real tree, built
    once per module from the port's traversal of it."""
    port = tproject.contexts_from_paths([REPO / root])
    ref = [(jcore.ModuleContext(c.source, c.path), n, p) for c, n, p in port]
    jm, tm = jproject.build_project(ref), tproject.build_project(port)
    return {"root": root, "ref": jm, "port": tm,
            "ref_flow": jm.device_flow(), "port_flow": tm.device_flow()}


@pytest.fixture(scope="module", autouse=True)
def _drop_tree_models():
    yield
    _flows.cache_clear()


@pytest.fixture(scope="module", params=["hyperspace_tpu", "hyperspace_tpu_torch"])
def trees(request):
    return _flows(request.param)


@pytest.mark.parametrize("reach", ["traced_reach", "declined_reach", "degrade_reach"])
def test_reach_sets_match_over_both_trees(trees, reach):
    want = getattr(trees["ref_flow"], reach)()
    got = getattr(trees["port_flow"], reach)()
    assert got and got == want


def test_lexical_facts_match_over_both_trees(trees):
    ref, port = trees["ref_flow"].flows, trees["port_flow"].flows
    assert sorted(port) == sorted(ref)
    for q, fl in ref.items():
        p = port[q]
        assert (p.traces_bytes, p.declined_incr, p.degrade_incr) == (
            fl.traces_bytes, fl.declined_incr, fl.degrade_incr), q


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


@pytest.mark.parametrize("code", AS_WRITTEN)
def test_hs018_hs020_match_over_both_trees(trees, code):
    want = _tree_findings(trees["ref"], [r for r in J_WRITTEN if r.code == code],
                          jcore.parse_suppressions)
    got = _tree_findings(trees["port"], [r for r in T_WRITTEN if r.code == code],
                         tcore.parse_suppressions)
    assert got == want


def test_real_fixes_are_pinned_in_the_flow_model():
    """The port's repairs for HS018 and HS019 stay in its flow: every
    transfer leg of the reference's pinned list reaches trace.add_bytes
    (the streaming upload serves the single-card and the mesh tables'
    lanes alike), and the silent tails count their reasons."""
    flow = _flows("hyperspace_tpu_torch")["port_flow"]
    traced = flow.traced_reach()
    for qual in (
        "hyperspace_tpu_torch.exec.distributed:distributed_filter",
        "hyperspace_tpu_torch.exec.distributed:distributed_filter_aggregate",
        "hyperspace_tpu_torch.exec.distributed:distributed_bucketed_join",
        "hyperspace_tpu_torch.exec.hbm_cache:HbmIndexCache._build",
        "hyperspace_tpu_torch.exec.mesh_cache:MeshHbmCache._build",
        "hyperspace_tpu_torch.residency.streaming:_upload_window",
        "hyperspace_tpu_torch.residency.streaming:_windowed_counts_locked",
    ):
        assert qual in traced, f"{qual} lost its trace.add_bytes"
    for qual in (
        "hyperspace_tpu_torch.exec.scan:_resident_scan",
        "hyperspace_tpu_torch.index.stream_builder:StreamingIndexWriter._try_stage_chunk",
        "hyperspace_tpu_torch.exec.delta:prepare_hybrid_predicate",
    ):
        fl = flow.flows.get(qual)
        assert fl is not None and fl.declined_incr, f"{qual} no longer counts declines"
    # the zone gate's host route falls through to the function's one exit
    (hs018,) = [r for r in trules.REGISTRY if r.code == "HS018"]
    model = _flows("hyperspace_tpu_torch")["port"]
    assert [t for t in hs018.check_project(model) if t[0].endswith("exec/scan.py")] == []


def test_port_tree_flow_sees_the_transfer_sites():
    """The device model sees the port's uploads and fetches: exec/ and
    residency/ hold transfer sites, each in a function that reaches
    trace.add_bytes, and HS015-HS017 and HS019 find nothing
    unsuppressed over the tree."""
    t = _flows("hyperspace_tpu_torch")
    flow, model = t["port_flow"], t["port"]
    traced = flow.traced_reach()
    seam = [q for q, fl in flow.flows.items() if fl.transfers
            and {"exec", "residency"} & set(model.functions[q].module.split("."))]
    assert seam and all(q in traced for q in seam)
    rules = [r for r in trules.REGISTRY if r.code in ("HS015", "HS016", "HS017", "HS019")]
    got = _tree_findings(model, rules, tcore.parse_suppressions)
    assert [(c, Path(p).name, s) for c, p, _l, _c, s, _m in got] == [
        ("HS015", "deviceprobe.py", True)]
