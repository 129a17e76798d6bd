"""hslint phase 3: device-boundary value flow over the project model.

The project model resolves WHO calls WHOM; this module resolves WHAT
crosses the device boundary. It classifies expressions as
*device-valued* — tensors on the card, results of the hand-written
kernels' wrappers, values flowing out of functions whose inferred return
is device-valued — and propagates that classification interprocedurally
through the resolved call graph (returns forward into callers, arguments
forward into callee parameters). On top of the classification it
extracts the fact families the device-boundary rules (HS015-HS020) run
on:

* **D2H coercions** — ``float()/int()/bool()`` of a device value,
  ``np.asarray``/``np.array`` of one, ``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()`` on one, iteration over one: each is a
  device->host readback;
* **transfer sites** — uploads (``.cuda()``, ``.to(<device>)`` of a value
  not judged device, a ``torch.tensor``/``as_tensor``/``asarray`` with
  ``device=<device>`` over host data, ``<device value>.copy_(<host
  value>)``) and fetches (``.cpu()``, ``.to("cpu")`` of a device value),
  plus whether the enclosing function reaches a ``trace.add_bytes`` call
  (lexically or transitively) — the byte-tracing discipline;
* **jit factories** — each ``torch.compile(body)`` (or
  ``torch.jit.script``/``trace``, ``torch.cuda.make_graphed_callables``)
  site with the body's free variables split into closure-captured
  factory parameters and the memo-key parameters, the facts behind the
  structure-keyed-cache discipline (HS016);
* **float64 facts** — a Python float literal given to ``torch.tensor``/
  ``as_tensor``/``asarray``/``full``/``arange``/``linspace`` with no
  ``dtype=``, which torch's default dtype silently makes float32, plus
  module-level float64 (a ``torch.set_default_dtype(torch.float64)`` at
  import, own module or ancestor package ``__init__``);
* **decline facts** — whether a function lexically (or transitively)
  increments a ``…declined…`` metric, the HS018 "no silent tail" seam;
* **degrade facts** — the wider HS020 seam: whether a function
  increments ANY degrade-evidence metric (``DEGRADE_NEEDLES`` — lost /
  retried / hedge / shed / …), the proof a failover branch was counted.

The torch device model. Torch runs the same calls on host and card, so a
value is device only on positive evidence:

* a DEVICE SPELLING is a ``"cuda…"`` string, ``torch.device(<device
  spelling>)``, a result of ``ops.resolve_device(…)``, a parameter or
  local named ``device``/``dev`` (the port's convention: entry points
  default to the card) unless bound here to a CPU spelling, or the
  ``.device`` of a device value;
* a DEVICE VALUE is the result of ``.cuda()``, of ``.to(<device
  spelling>)``, of a ``torch.*`` call with ``device=<device spelling>``
  or a device-valued argument, of a method call on a device value (but
  the tensor methods that answer on the host: ``numel``, ``size``, …),
  of one of ``ops/kernels.py``'s launching wrappers (HS007's
  ``KERNEL_WRAPPERS``, matched exactly as the project model matches
  them; ``predicate_mask`` and ``sorted_intersect_counts[_deferred]``
  hand back host arrays, and ``resident_mask_fn``,
  ``resident_sorted_intersect`` and ``resident_fused_agg_over_join`` a
  callable whose call launches), or of calling a compiled callable;
* ``.to(torch.<dtype>)``, ``.to(<x>.dtype)`` and ``.to(dtype=…)`` are
  casts (the receiver's judgement carries over), never transfers; a bare
  ``.to(<name>)`` whose name is no device spelling is unknown;
* HOST values: ``torch.from_numpy``, any ``torch.*`` call with a CPU
  ``device=`` or with no device argument at all, HS007's host-only
  calls, ``torch.cuda.*``, and the results of ``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``.item()`` and ``.wait()`` (``DeviceFetch.wait()``,
  the port's declared readback).

Resolution inherits the project model's contract — conservative, "may
miss, must not invent": a value the judge cannot classify is host/
unknown, never device, so every HS015-HS019 finding is anchored on a
positive classification. Documented blind spots: device tensors stored
on object ATTRIBUTES (``table.planes``) are invisible (no field typing),
and so are devices held on attributes (``self.device``); dtypes spelled
as strings are invisible; a D2H laundered through an unresolved helper
call is invisible.

Counterpart of ``hyperspace_tpu.analysis.dataflow``: the same records,
fixpoint, reach sets and helpers; the reach sets and the per-function
``traces_bytes``/``declined_incr``/``degrade_incr`` facts come from the
same ``add_bytes``/``incr``/``counter`` calls, so both analyzers give
equal ones over any tree. Torch has no scoped 64-bit switch, so the
float64 cover is module-level and through callers only. One repair: a
DEFINITE device argument makes the callee's parameter device (the
reference forwards only the conditional ones — its definite ones carry
an empty dep set, which never holds).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .core import dotted_name, terminal_name

# metric-name substrings that count as DEGRADE EVIDENCE: a failover or
# degradation branch that bumps a counter whose name carries any of
# these is observably counted (HS020). Deliberately broad — the rule's
# job is to catch SILENT failure branches, not to police naming taste.
DEGRADE_NEEDLES = (
    "declined",
    "degraded",
    "deferred",
    "lost",
    "retr",  # retried / retry / retries
    "hedge",
    "failover",
    "fallback",
    "shed",
    "exhausted",
    "failed",
    "failure",
    "rejected",
    "killed",
    "crashed",
    "cancelled",
    "missed",
    "probe",
    "respawn",
    "revived",
    "stalled",
    "recovered",
    "readmitted",
    "evicted",
    "dead",
    "suspect",
)

# callables returning a CALLABLE that runs compiled device work when
# invoked — torch's compilers
_JIT_WRAPPERS = {
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
}

_D2H_METHODS = {"item", "tolist", "cpu", "numpy"}
_CAST_NAMES = {"float", "int", "bool"}
# tensor methods that answer on the host (shape and layout queries, the
# DeviceFetch wait): a method call on a device value is otherwise device
_HOST_METHODS = {
    "size",
    "numel",
    "nelement",
    "dim",
    "ndimension",
    "stride",
    "element_size",
    "data_ptr",
    "storage_offset",
    "is_contiguous",
    "is_pinned",
    "is_floating_point",
    "is_complex",
    "get_device",
    "wait",
}
# torch calls whose result is a host value whatever their arguments
_HOST_TORCH_CALLS = {
    "torch.from_numpy",
    "torch.equal",
    "torch.numel",
    "torch.is_floating_point",
    "torch.set_default_dtype",
    "torch.get_default_dtype",
}
# torch constructors that copy their data argument: with a device
# spelling they are an upload of that data
_DATA_CTORS = {"torch.tensor", "torch.as_tensor", "torch.asarray"}
# torch calls that make a Python float float32 unless ``dtype=`` is given
_FLOAT_DEFAULT_CALLS = _DATA_CTORS | {"torch.full", "torch.arange", "torch.linspace"}
_TORCH_DTYPES = {
    "bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32",
    "int64", "float16", "bfloat16", "float32", "float64", "half", "float",
    "double", "short", "int", "long", "complex64", "complex128",
}
_DEVICE_NAMES = {"device", "dev"}

# factory parameters that are STRUCTURAL by convention (shapes, modes,
# arities, signatures) — legitimately folded into both a jit closure and
# its memo key. The recompile-hazard check skips them; a value-like
# parameter hiding behind a structural name is a documented blind spot.
_STRUCTURAL_PARAM_RE = re.compile(
    r"^(n|num|len|cap|pad|span|width|height|depth|rank|arity|size|shape"
    r"|dim|dims|block|blocks|bits|mode|kind|enc|tag|sig|structure|seed"
    r"|axis|order)(_|\d|$)"
    r"|_(mode|bits|pad|cap|rows|cols|size|shape|len|count|arity)$"
    r"|^(use|is|has|with)_"
)

# the distinguished judgement for "a jitted callable" (calling it
# dispatches to device); distinct from True = "a device value"
_JIT = "jit"
# the device-spelling judgement for "the host" (``"cpu"``,
# ``torch.device("cpu")``)
_CPU = "cpu"


@dataclass(frozen=True)
class D2HEvent:
    """One device->host coercion."""

    line: int
    col: int
    kind: str  # "float"|"int"|"bool"|"asarray"|"item"|"tolist"|"cpu"|"numpy"|"iter"
    detail: str  # source spelling of the coerced operand


@dataclass(frozen=True)
class TransferEvent:
    """One explicit H2D/D2H transfer call."""

    line: int
    col: int
    direction: str  # "h2d" | "d2h"
    api: str  # "cuda" | "to" | "tensor" | "as_tensor" | "asarray" | "copy_" | "cpu"


@dataclass(frozen=True)
class JitFactory:
    """One ``torch.compile(body)`` site inside a factory function."""

    line: int
    col: int
    body: str  # local def / lambda name
    closure_params: Tuple[str, ...]  # factory params free in the body
    key_params: Tuple[str, ...]  # factory params folded into the memo key
    cached: bool  # the compiled fn is stored under that key


@dataclass
class FunctionFlow:
    """Per-function value-flow facts."""

    qual: str
    device_return: bool = False
    returns_jit: bool = False
    device_params: Set[str] = field(default_factory=set)
    d2h: List[D2HEvent] = field(default_factory=list)
    transfers: List[TransferEvent] = field(default_factory=list)
    traces_bytes: bool = False  # lexical trace.add_bytes call
    declined_incr: bool = False  # lexical metrics.incr("…declined…")
    degrade_incr: bool = False  # lexical metrics.incr of any degrade-evidence name
    # (line, col, spelling): a Python float literal made float32 by the
    # default dtype — the value that wants 64 bits
    dtype64: List[Tuple[int, int, str]] = field(default_factory=list)
    jit_factories: List[JitFactory] = field(default_factory=list)


# dep kinds:
#   ("ret", q)     — device value if q's return is device-valued
#   ("param", q, n) — device value if q's parameter n is device-valued
#   ("jit", q)     — IS a jitted callable if q returns one
#   ("jitcall", q) — device value if q returns a jitted callable (this
#                    value is the result of CALLING that callable)
Dep = Tuple
Judgement = object  # True | None | _JIT | FrozenSet[Dep]


def _cont(inner: Judgement) -> Judgement:
    """A host CONTAINER (tuple/list/set literal) of possibly-device
    elements. Iterating or passing it is host-free; subscripting or
    unpacking it recovers the element judgement. Distinct from a device
    value so that iterating a list of tensors is never called a D2H
    fetch."""
    return ("cont", inner) if inner is not None else None


def _is_cont(j: Judgement) -> bool:
    return isinstance(j, tuple) and len(j) == 2 and j[0] == "cont"


def _elem(j: Judgement) -> Judgement:
    """Element judgement of a container; identity otherwise."""
    return j[1] if _is_cont(j) else j


def _merge(a: Judgement, b: Judgement) -> Judgement:
    if _is_cont(a) or _is_cont(b):
        ia = a[1] if _is_cont(a) else a
        ib = b[1] if _is_cont(b) else b
        return _cont(_merge(ia, ib))
    if a is True or b is True:
        return True
    if a is _JIT or b is _JIT:
        return _JIT
    deps: Set[Dep] = set()
    for j in (a, b):
        if isinstance(j, frozenset):
            deps |= j
    return frozenset(deps) if deps else None


class DeviceFlow:
    """The value-flow model: build once per ProjectModel, query per
    function. ``flows[qual]`` holds every per-function fact; the
    ``*_reach`` helpers answer the transitive questions."""

    def __init__(self, model):
        # the device model's lists are HS007's and the project model's;
        # the rules package imports this module, so they are bound here
        from .project import _KERNEL_MODULES
        from .rules.hs007_unfenced_device_timing import HOST_ONLY, KERNEL_WRAPPERS

        self.host_only = HOST_ONLY
        self.kernel_wrappers = KERNEL_WRAPPERS
        self.kernel_modules = _KERNEL_MODULES
        self.model = model
        self.flows: Dict[str, FunctionFlow] = {}
        self._module_x64_own: Dict[str, bool] = {}
        # (qual, event, deps, unless): emitted when deps hold (None:
        # always) and unless does not
        self._pending_events: List[Tuple[str, object, Optional[FrozenSet[Dep]], Judgement]] = []
        self._ret_deps: Dict[str, Set[Dep]] = {}
        self._jit_ret_deps: Dict[str, Set[Dep]] = {}
        self._arg_props: List[Tuple[str, str, Optional[FrozenSet[Dep]]]] = []
        self._traced_reach: Optional[Set[str]] = None
        self._declined_reach: Optional[Set[str]] = None
        self._degrade_reach: Optional[Set[str]] = None
        self._x64_covered: Optional[Dict[str, bool]] = None
        self._build()

    # -- module-level float64 ------------------------------------------------
    def module_x64(self, module: str) -> bool:
        """True when the module (or an ancestor package ``__init__``)
        sets torch's default dtype to float64 at import — every float
        made after that import is 64-bit."""
        if self._module_x64_own.get(module):
            return True
        parts = module.split(".")
        return any(
            self._module_x64_own.get(".".join(parts[:i]))
            for i in range(1, len(parts))
        )

    # -- transitive facts ----------------------------------------------------
    def traced_reach(self) -> Set[str]:
        """Quals that lexically call ``add_bytes`` or transitively call
        a function that does — the set HS019 credits."""
        if self._traced_reach is None:
            self._traced_reach = self._reach_closure(
                {q for q, fl in self.flows.items() if fl.traces_bytes}
            )
        return self._traced_reach

    def declined_reach(self) -> Set[str]:
        """Quals that lexically increment a ``…declined…`` metric or
        transitively call a function that does."""
        if self._declined_reach is None:
            self._declined_reach = self._reach_closure(
                {q for q, fl in self.flows.items() if fl.declined_incr}
            )
        return self._declined_reach

    def degrade_reach(self) -> Set[str]:
        """Quals that lexically increment a DEGRADE-EVIDENCE metric
        (any ``DEGRADE_NEEDLES`` substring — lost/retried/hedge/shed/…)
        or transitively call a function that does — the set HS020
        credits a failover branch for reaching."""
        if self._degrade_reach is None:
            self._degrade_reach = self._reach_closure(
                {q for q, fl in self.flows.items() if fl.degrade_incr}
            )
        return self._degrade_reach

    def _reach_closure(self, seed: Set[str]) -> Set[str]:
        """``seed`` plus every function that transitively calls into it:
        a backward walk over the reverse call graph, one visit per
        function."""
        callers = self.model.callers_of()
        out = set(seed)
        stack = list(seed)
        while stack:
            for caller, _site in callers.get(stack.pop(), ()):
                if caller.qual not in out:
                    out.add(caller.qual)
                    stack.append(caller.qual)
        return out

    def x64_covered(self) -> Dict[str, bool]:
        """Greatest-fixpoint float64 cover per function: covered when
        the module sets the float64 default at import, or EVERY resolved
        call site reaching the function sits in a covered module or
        caller. Functions with no resolved callers are NOT covered (an
        entry point must establish its own scope). Torch has no lexical
        scope: ``set_default_dtype`` is process-wide."""
        if self._x64_covered is not None:
            return self._x64_covered
        callers = self.model.callers_of()
        covered = {qual: True for qual in self.model.functions}  # carve down
        changed = True
        while changed:
            changed = False
            for qual, f in self.model.functions.items():
                if not covered[qual] or self.module_x64(f.module):
                    continue
                sites = callers.get(qual, [])
                ok = bool(sites) and all(
                    self.module_x64(caller.module) or covered[caller.qual]
                    for caller, _site in sites
                )
                if not ok:
                    covered[qual] = False
                    changed = True
        self._x64_covered = covered
        return covered

    # -- dump ----------------------------------------------------------------
    def dump_function(self, qual: str) -> Dict[str, object]:
        """JSON-ready value-flow facts for one function (the
        --call-graph-dump extension); {} when nothing interesting."""
        fl = self.flows.get(qual)
        if fl is None:
            return {}
        out: Dict[str, object] = {}
        if fl.device_return:
            out["device_return"] = True
        if fl.returns_jit:
            out["returns_jit"] = True
        if fl.device_params:
            out["device_params"] = sorted(fl.device_params)
        if fl.d2h:
            out["d2h"] = [f"{e.kind}({e.detail})@{e.line}" for e in fl.d2h]
        if fl.transfers:
            out["transfers"] = [
                f"{t.direction}:{t.api}@{t.line}" for t in fl.transfers
            ]
        if fl.traces_bytes:
            out["traces_bytes"] = True
        if fl.declined_incr:
            out["declined_incr"] = True
        if fl.degrade_incr:
            out["degrade_incr"] = True
        if fl.dtype64:
            out["dtype64"] = [f"{sp}@{ln}" for ln, _c, sp in fl.dtype64]
        if fl.jit_factories:
            out["jit_factories"] = [
                {
                    "body": jf.body,
                    "line": jf.line,
                    "closure_params": list(jf.closure_params),
                    "key_params": list(jf.key_params),
                    "cached": jf.cached,
                }
                for jf in fl.jit_factories
            ]
        return out

    # -- build ---------------------------------------------------------------
    def _build(self) -> None:
        for name, info in self.model.modules.items():
            self._module_x64_own[name] = _module_sets_x64(
                info.ctx.tree, info.aliases
            )
        # local pass per function: two sweeps so later-established
        # device locals are seen by earlier uses (flow-insensitive
        # within the function, like the lock walker)
        for qual, f in self.model.functions.items():
            node = getattr(f, "_node", None)
            if node is None:
                continue  # <module> pseudo-functions carry no body node
            flow = FunctionFlow(qual=qual)
            self.flows[qual] = flow
            walker = _FlowWalker(self, f, node, flow)
            walker.run()
            self._ret_deps[qual] = walker.ret_deps
            self._jit_ret_deps[qual] = walker.jit_ret_deps
            self._pending_events.extend(walker.pending_events)
            self._arg_props.extend(walker.arg_props)
        self._fixpoint()
        # finalize pending (dep-conditioned) events
        for qual, event, deps, unless in self._pending_events:
            if deps is not None and not self._eval_deps(deps):
                continue
            if unless is True or (
                isinstance(unless, frozenset) and self._eval_deps(unless)
            ):
                continue
            fl = self.flows[qual]
            if isinstance(event, D2HEvent):
                fl.d2h.append(event)
            else:
                fl.transfers.append(event)
        for fl in self.flows.values():
            fl.d2h.sort(key=lambda e: (e.line, e.col))
            fl.transfers.sort(key=lambda e: (e.line, e.col))

    def _eval_dep(self, dep: Dep) -> bool:
        kind = dep[0]
        if kind == "ret":
            fl = self.flows.get(dep[1])
            return bool(fl and fl.device_return)
        if kind in ("jit", "jitcall"):
            fl = self.flows.get(dep[1])
            return bool(fl and fl.returns_jit)
        if kind == "param":
            fl = self.flows.get(dep[1])
            return bool(fl and dep[2] in fl.device_params)
        return False

    def _eval_deps(self, deps: FrozenSet[Dep]) -> bool:
        return any(self._eval_dep(d) for d in deps)

    def _fixpoint(self) -> None:
        """Propagate device-ness through returns and call arguments to a
        fixpoint — the interprocedural half of the model. Each dep set is
        frozen once; a fact only ever turns on, so a set already found
        true is not evaluated again."""
        ret = [(self.flows[q], frozenset(d)) for q, d in self._ret_deps.items() if d]
        jit = [(self.flows[q], frozenset(d)) for q, d in self._jit_ret_deps.items() if d]
        props = [
            (self.flows[c], p, d)
            for c, p, d in self._arg_props
            if c in self.flows
        ]
        changed = True
        while changed:
            changed = False
            for fl, deps in ret:
                if not fl.device_return and self._eval_deps(deps):
                    fl.device_return = True
                    changed = True
            for fl, deps in jit:
                if not fl.returns_jit and self._eval_deps(deps):
                    fl.returns_jit = True
                    changed = True
            for fl, pname, deps in props:
                if pname not in fl.device_params and (
                    deps is None or self._eval_deps(deps)
                ):
                    fl.device_params.add(pname)
                    changed = True


def _module_sets_x64(tree: ast.AST, aliases: Dict[str, str]) -> bool:
    """Import-time float64 default: a top-level
    ``torch.set_default_dtype(torch.float64)`` (or ``torch.double``)."""
    for node in tree.body:
        if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
            continue
        call = node.value
        if (
            dotted_name(call.func, aliases) == "torch.set_default_dtype"
            and call.args
            and dotted_name(call.args[0], aliases)
            in ("torch.float64", "torch.double")
        ):
            return True
    return False


def param_names(fnnode: ast.AST, is_method: bool) -> List[str]:
    """Positional parameter names of a def, self/cls stripped for
    methods — the call-site argument mapping HS016 and the argument
    propagation both use."""
    args = fnnode.args
    names = [a.arg for a in args.posonlyargs + args.args]
    if is_method and names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


def _free_names(fnnode: ast.AST) -> Set[str]:
    """Names a def/lambda loads but does not bind — the closure capture
    set of a jit body."""
    bound: Set[str] = set()
    loads: Set[str] = set()
    args = fnnode.args
    for a in (
        args.posonlyargs
        + args.args
        + args.kwonlyargs
        + ([args.vararg] if args.vararg else [])
        + ([args.kwarg] if args.kwarg else [])
    ):
        bound.add(a.arg)
    body = fnnode.body if isinstance(fnnode.body, list) else [fnnode.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.add(node.id)
                else:
                    bound.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                bound.add(node.name)
            elif isinstance(node, ast.comprehension):
                for t in ast.walk(node.target):
                    if isinstance(t, ast.Name):
                        bound.add(t.id)
    return loads - bound


class _FlowWalker:
    """One function's local value-flow pass. Two sweeps: the first only
    builds the local judgement environment, the second emits facts."""

    def __init__(self, dflow: DeviceFlow, finfo, node: ast.AST, flow):
        self.dflow = dflow
        self.model = dflow.model
        self.f = finfo
        self.node = node
        self.flow = flow
        info = self.model.modules.get(finfo.module)
        self.aliases = info.aliases if info else {}
        self.params = set(param_names(node, finfo.cls is not None))
        self.env: Dict[str, Judgement] = {}
        # locals bound to a device spelling (or to the CPU's)
        self.spec_env: Dict[str, Judgement] = {}
        self._nested: Optional[Dict[str, ast.AST]] = None
        self.callmap = {(s.line, s.col): s for s in finfo.calls}
        self.ret_deps: Set[Dep] = set()
        self.jit_ret_deps: Set[Dep] = set()
        self.pending_events: List[Tuple[str, object, Optional[FrozenSet[Dep]], Judgement]] = []
        self.arg_props: List[Tuple[str, str, Optional[FrozenSet[Dep]]]] = []
        # key-tuple facts for the jit-factory extraction
        self.tuple_params: Dict[str, Set[str]] = {}  # var -> params in tuple
        self.cache_key_vars: Set[str] = set()
        self.emit = False

    @property
    def nested(self) -> Dict[str, ast.AST]:
        """The defs nested in this function by name (built on first use:
        only a compiler call reads it)."""
        if self._nested is None:
            self._nested = {
                st.name: st
                for st in ast.walk(self.node)
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))
                and st is not self.node
            }
        return self._nested

    def run(self) -> None:
        body = list(getattr(self.node, "body", []))
        self.emit = False
        self._stmts(body)
        self.emit = True
        self._stmts(body)

    # -- statements ----------------------------------------------------------
    def _stmts(self, stmts: List[ast.stmt]) -> None:
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested scope: not walked for flow, but float literals
            # inside it are attributed here, and a @torch.compile
            # decorator marks a factory site
            if self.emit:
                self._scan_dtype64(st)
                for dec in st.decorator_list:
                    if dotted_name(dec, self.aliases) in _JIT_WRAPPERS:
                        self._note_jit_factory(st, st.name, st.lineno, st.col_offset)
            return
        if isinstance(st, ast.Assign):
            j = self._expr(st.value)
            for t in st.targets:
                self._bind(t, j, st.value)
            return
        if isinstance(st, ast.AnnAssign):
            if st.value is not None:
                j = self._expr(st.value)
                self._bind(st.target, j, st.value)
            return
        if isinstance(st, ast.AugAssign):
            j = self._expr(st.value)
            if isinstance(st.target, ast.Name):
                self.env[st.target.id] = _merge(
                    self.env.get(st.target.id), j
                )
            return
        if isinstance(st, ast.Return):
            if st.value is not None:
                j = self._expr(st.value)
                # returning a container of device values: callers unpack
                # or subscript it, so the elements' judgement is what the
                # return carries (container-ness itself does not survive
                # the call boundary — documented imprecision)
                j = _elem(j)
                if j is True:
                    self.flow.device_return = True
                elif j is _JIT:
                    self.flow.returns_jit = True
                elif isinstance(j, frozenset):
                    for dep in j:
                        if dep[0] == "jit":
                            # returning a value that IS a (conditional)
                            # jit callable: our return is one too
                            self.jit_ret_deps.add(dep)
                        else:
                            self.ret_deps.add(dep)
                            # returning the direct result of calling q:
                            # if q returns a jit callable, so do we
                            if dep[0] == "ret":
                                self.jit_ret_deps.add(("jit", dep[1]))
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            j = self._expr(st.iter)
            if self.emit and not _is_cont(j) and _devicey(j):
                # iterating a device TENSOR fetches it element-by-element;
                # iterating a host container of device values is free
                self._emit_d2h_at(
                    st.iter.lineno, st.iter.col_offset, "iter", st.iter, j
                )
            self._bind(st.target, _elem(j), st.iter)
            self._stmts(st.body)
            self._stmts(st.orelse)
            return
        if isinstance(st, (ast.While, ast.If)):
            self._expr(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
            return
        if isinstance(st, ast.With):
            for item in st.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, None, item.context_expr)
            self._stmts(st.body)
            return
        if isinstance(st, ast.Try):
            self._stmts(st.body)
            for h in st.handlers:
                self._stmts(h.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)
            return
        if isinstance(st, ast.Expr):
            self._expr(st.value)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child)
            elif isinstance(child, ast.stmt):
                self._stmt(child)

    def _bind(self, target: ast.AST, j: Judgement, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            # REPLACE, don't merge: ``lo = lo.cpu()`` is the canonical
            # boundary idiom — after the rebind the name is host-valued.
            # (The second sweep starts from the first sweep's final env,
            # so loop-carried device values are still seen at uses
            # textually before their binding.)
            self.env[target.id] = j
            spec = self._spec(value)
            if spec is None:
                self.spec_env.pop(target.id, None)
            else:
                self.spec_env[target.id] = spec
            # remember tuple literals of params — memo-key candidates
            if isinstance(value, ast.Tuple):
                inside = {
                    n.id
                    for n in ast.walk(value)
                    if isinstance(n, ast.Name) and n.id in self.params
                }
                if inside:
                    self.tuple_params[target.id] = (
                        self.tuple_params.get(target.id, set()) | inside
                    )
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, _elem(j), value)
        elif isinstance(target, ast.Subscript):
            # cache[key] = fn — a cache-key store
            if isinstance(target.slice, ast.Name):
                self.cache_key_vars.add(target.slice.id)
            self._expr(target.value)

    # -- device spellings ----------------------------------------------------
    def _spec(self, node: ast.AST) -> Judgement:
        """The device an expression names: True (the card), ``_CPU``, a
        dep set (the device of a possibly-device value), or None (not a
        device spelling, or unknown)."""
        if isinstance(node, ast.Constant):
            if isinstance(node.value, str):
                if node.value.startswith("cuda"):
                    return True
                if node.value.startswith("cpu"):
                    return _CPU
            return None
        if isinstance(node, ast.Name):
            if node.id in self.spec_env:
                return self.spec_env[node.id]
            return True if node.id in _DEVICE_NAMES else None
        if isinstance(node, ast.IfExp):
            a, b = self._spec(node.body), self._spec(node.orelse)
            return a if a == b else None
        if isinstance(node, ast.Attribute):
            if node.attr != "device":
                return None
            # read the owner's judgement without evaluating it again (its
            # calls were walked where it stands): a name, or a name's item
            owner = node.value
            while isinstance(owner, ast.Subscript):
                owner = owner.value
            if not isinstance(owner, ast.Name):
                return None
            j = _elem(self._expr(owner))
            if j is True:
                return True
            return _as_deps(j) or None
        if isinstance(node, ast.Call):
            d = dotted_name(node.func, self.aliases) or ""
            if d == "torch.device" and node.args:
                return self._spec(node.args[0])
            if d == "resolve_device" or d.endswith(".resolve_device"):
                return True
        return None

    def _is_dtype(self, node: ast.AST) -> bool:
        """``torch.<dtype>`` or ``<x>.dtype``: the argument of a cast."""
        if not isinstance(node, ast.Attribute):
            return False
        if node.attr == "dtype":
            return True
        d = dotted_name(node, self.aliases) or ""
        return d.startswith("torch.") and node.attr in _TORCH_DTYPES

    # -- expressions ---------------------------------------------------------
    def _expr(self, node: ast.AST) -> Judgement:
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in self.params:
                if node.id in self.flow.device_params:
                    return True
                return frozenset({("param", self.f.qual, node.id)})
            return None
        if isinstance(node, ast.Attribute):
            self._expr(node.value)
            return None  # attribute values: untracked (documented)
        if isinstance(node, ast.Subscript):
            j = self._expr(node.value)
            self._expr(node.slice)
            return _elem(j)
        if isinstance(node, ast.BinOp):
            return _merge(self._expr(node.left), self._expr(node.right))
        if isinstance(node, ast.UnaryOp):
            return self._expr(node.operand)
        if isinstance(node, ast.BoolOp):
            j: Judgement = None
            for v in node.values:
                j = _merge(j, self._expr(v))
            return j
        if isinstance(node, ast.Compare):
            j = self._expr(node.left)
            for c in node.comparators:
                j = _merge(j, self._expr(c))
            return j
        if isinstance(node, ast.IfExp):
            self._expr(node.test)
            return _merge(self._expr(node.body), self._expr(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            j = None
            for el in node.elts:
                j = _merge(j, self._expr(el))
            # a literal container OF device values is itself host data:
            # iterating/passing it moves nothing; unpack/subscript below
            # recover the element judgement
            return _cont(_elem(j))
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None:
                    self._expr(k)
            for v in node.values:
                self._expr(v)
            return None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            saved = dict(self.env)
            for gen in node.generators:
                gj = self._expr(gen.iter)
                self._bind(gen.target, _elem(gj), gen.iter)
                for cond in gen.ifs:
                    self._expr(cond)
            j = self._expr(node.elt)
            self.env = saved
            # a comprehension builds a host container; its ELEMENTS carry
            # the elt judgement (recovered on unpack/subscript/iteration)
            return _cont(_elem(j))
        if isinstance(node, ast.DictComp):
            saved = dict(self.env)
            for gen in node.generators:
                gj = self._expr(gen.iter)
                self._bind(gen.target, _elem(gj), gen.iter)
                for cond in gen.ifs:
                    self._expr(cond)
            self._expr(node.key)
            self._expr(node.value)
            self.env = saved
            return None
        if isinstance(node, ast.Starred):
            return self._expr(node.value)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._expr(child)
            return None
        if isinstance(node, ast.Lambda):
            return None  # separate scope
        if isinstance(node, ast.NamedExpr):
            j = self._expr(node.value)
            self._bind(node.target, j, node.value)
            return j
        if isinstance(node, ast.Await):
            return self._expr(node.value)
        if isinstance(node, ast.Constant):
            return None
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)
        return None

    def _call(self, call: ast.Call) -> Judgement:
        func = call.func
        d = dotted_name(func, self.aliases)
        arg_js = [self._expr(a) for a in call.args]
        kw_js = {
            kw.arg: self._expr(kw.value)
            for kw in call.keywords
            if kw.arg is not None
        }
        for kw in call.keywords:
            if kw.arg is None:
                self._expr(kw.value)
        method = func.attr if isinstance(func, ast.Attribute) else None
        recv_j = self._expr(func.value) if method is not None else None

        # byte-tracing / decline-metric facts
        term = terminal_name(func)
        spelled = d or term or ""
        if self.emit and (
            spelled == "add_bytes" or spelled.endswith(".add_bytes")
        ):
            self.flow.traces_bytes = True
        if self.emit and term in ("incr", "counter") and call.args:
            if _str_contains(call.args[0], "declined"):
                self.flow.declined_incr = True
            if any(
                _str_contains(call.args[0], n) for n in DEGRADE_NEEDLES
            ):
                self.flow.degrade_incr = True

        # compiler wrapper: factory fact + jit-callable judgement
        if d in _JIT_WRAPPERS:
            if self.emit and call.args:
                body = call.args[0]
                name = None
                if isinstance(body, ast.Name) and body.id in self.nested:
                    name = body.id
                elif isinstance(body, ast.Lambda):
                    name = "<lambda>"
                if name is not None:
                    self._note_jit_factory(
                        self.nested[name] if name in self.nested else body,
                        name,
                        call.lineno,
                        call.col_offset,
                    )
            return _JIT

        # D2H coercions
        if (
            isinstance(func, ast.Name)
            and func.id in _CAST_NAMES
            and len(call.args) == 1
            and not call.keywords
        ):
            self._emit_d2h(call, func.id, call.args[0], arg_js[0])
            return None
        if d in ("numpy.asarray", "numpy.array") and call.args:
            self._emit_d2h(call, "asarray", call.args[0], arg_js[0])
            return None
        if method in _D2H_METHODS and not call.args:
            self._emit_d2h(call, method, func.value, recv_j)
            if method == "cpu":
                self._emit_transfer(call, "d2h", "cpu", recv_j, None)
            return None

        # transfers and casts of a tensor
        if method == "cuda":
            self._emit_transfer(call, "h2d", "cuda", True, recv_j)
            return True
        if method == "to":
            return self._to(call, recv_j)
        if method == "copy_" and call.args:
            self._emit_transfer(call, "h2d", "copy_", recv_j, arg_js[0])
            return recv_j if _devicey(recv_j) else None

        # the hand-written kernels' wrappers
        kernel = self._kernel_result(d)

        # method call on a device value returns a device value
        if method is not None and kernel is None:
            if method in _HOST_METHODS:
                return None
            if recv_j is True:
                return True
            if isinstance(recv_j, frozenset) and recv_j:
                return recv_j

        # torch.* calls: device by a device= spelling or a device argument
        if d and d.startswith("torch.") and d not in self.dflow.host_only:
            return self._torch_call(call, d, arg_js, kw_js)

        # calling a local var that holds a jitted callable: the RESULT
        # is a device value (conditionally, when jit-ness is conditional)
        if isinstance(func, ast.Name):
            fj = self.env.get(func.id)
            if fj is _JIT:
                return True
            if isinstance(fj, frozenset):
                jitdeps = frozenset(
                    ("jitcall", dp[1]) for dp in fj if dp[0] == "jit"
                )
                if jitdeps:
                    return jitdeps

        # resolved in-package callee: device if its return is; propagate
        # device arguments into its parameters
        site = self.callmap.get((call.lineno, call.col_offset))
        callee = site.callee if site is not None else None
        if callee is not None:
            cf = self.model.functions.get(callee)
            cnode = getattr(cf, "_node", None) if cf else None
            if self.emit and cnode is not None:
                pnames = param_names(cnode, cf.cls is not None)
                # a definite device argument makes the parameter device
                # unconditionally (None: no deps to wait for)
                for i, j in enumerate(arg_js):
                    if i < len(pnames) and _devicey(j):
                        self.arg_props.append(
                            (callee, pnames[i], None if j is True else _as_deps(j))
                        )
                for kwname, j in kw_js.items():
                    if kwname in pnames and _devicey(j):
                        self.arg_props.append(
                            (callee, kwname, None if j is True else _as_deps(j))
                        )
            if kernel is not None:
                return kernel[0]
            return frozenset({("ret", callee), ("jit", callee)})
        return kernel[0] if kernel is not None else None

    def _kernel_result(self, d: Optional[str]) -> Optional[Tuple[Judgement]]:
        """``(judgement,)`` for a call to a launching wrapper of
        ``ops/kernels.py`` (matched exactly, by module and name), else
        None."""
        if not d:
            return None
        mod, _, name = d.rpartition(".")
        if mod not in self.dflow.kernel_modules or name not in self.dflow.kernel_wrappers:
            return None
        if name in _KERNEL_HOST_RESULTS:
            return (None,)
        if name in _KERNEL_LAUNCHERS:
            return (_JIT,)
        return (True,)

    def _to(self, call: ast.Call, recv_j: Judgement) -> Judgement:
        """``<x>.to(...)``: a cast keeps the receiver's judgement, a move
        to a device spelling is an upload unless the receiver is already
        device, a move to the CPU is a fetch of a device value."""
        kws = {kw.arg: kw.value for kw in call.keywords if kw.arg}
        target = call.args[0] if call.args else kws.get("device")
        if target is None or self._is_dtype(target):
            # .to(dtype=...) / .to(torch.int64) / .to(x.dtype): a cast
            return recv_j if _devicey(recv_j) else None
        spec = self._spec(target)
        if spec is _CPU:
            self._emit_d2h(call, "cpu", call.func.value, recv_j)
            self._emit_transfer(call, "d2h", "to", recv_j, None)
            return None
        if spec is None:
            return None  # .to(<name>): no device spelling — unknown
        self._emit_transfer(call, "h2d", "to", spec, recv_j)
        return spec

    def _torch_call(self, call, d: str, arg_js, kw_js) -> Judgement:
        if self.emit:
            self._note_float_default(call, d)
        if d.startswith("torch.cuda.") or d in _HOST_TORCH_CALLS:
            return None
        dev_kw = next(
            (kw.value for kw in call.keywords if kw.arg == "device"), None
        )
        if dev_kw is not None:
            spec = self._spec(dev_kw)
            if spec is None or spec is _CPU:
                return None
            if d in _DATA_CTORS and call.args:
                self._emit_transfer(call, "h2d", d[len("torch."):], spec, arg_js[0])
            return spec
        j: Judgement = None
        for a in list(arg_js) + [v for k, v in kw_js.items() if k != "out"]:
            j = _merge(j, _elem(a))
        if j is True:
            return True
        return _as_deps(j) or None

    # -- fact emission -------------------------------------------------------
    def _emit_d2h(
        self, call: ast.Call, kind: str, operand: ast.AST, j: Judgement
    ) -> None:
        if not self.emit or not _devicey(j):
            return
        self._emit_d2h_at(call.lineno, call.col_offset, kind, operand, j)

    def _emit_d2h_at(
        self, line: int, col: int, kind: str, operand: ast.AST, j: Judgement
    ) -> None:
        detail = _spelling(operand)
        ev = D2HEvent(line, col, kind, detail)
        if j is True:
            self.flow.d2h.append(ev)
        else:
            self.pending_events.append((self.f.qual, ev, _as_deps(j), None))

    def _emit_transfer(
        self, call: ast.Call, direction: str, api: str,
        when: Judgement, unless: Judgement,
    ) -> None:
        """A transfer at ``call`` when ``when`` is device (True, or a
        dep set that the fixpoint proves) and ``unless`` is not: a move
        of a value already on the card is no transfer."""
        if not self.emit or not _devicey(when) or unless is True:
            return
        ev = TransferEvent(call.lineno, call.col_offset, direction, api)
        unless_deps = _as_deps(unless) if _devicey(unless) else None
        if when is True and not unless_deps:
            self.flow.transfers.append(ev)
        else:
            deps = None if when is True else _as_deps(when)
            self.pending_events.append((self.f.qual, ev, deps, unless_deps))

    def _note_jit_factory(
        self, body: ast.AST, name: str, line: int, col: int
    ) -> None:
        free = _free_names(body)
        closure_params = tuple(sorted(free & self.params))
        key_params: Set[str] = set()
        cached = False
        for var in self.cache_key_vars:
            if var in self.tuple_params:
                cached = True
                key_params |= self.tuple_params[var]
        self.flow.jit_factories.append(
            JitFactory(
                line,
                col,
                name,
                closure_params,
                tuple(sorted(key_params)),
                cached,
            )
        )

    def _note_float_default(self, call: ast.Call, d: str) -> None:
        """A Python float literal given to a default-dtype call with no
        ``dtype=``: torch makes it float32."""
        if d not in _FLOAT_DEFAULT_CALLS:
            return
        if any(kw.arg == "dtype" for kw in call.keywords):
            return
        values = list(call.args) + [
            kw.value for kw in call.keywords if kw.arg not in ("device", "out")
        ]
        if any(
            isinstance(n, ast.Constant) and type(n.value) is float
            for v in values
            for n in ast.walk(v)
        ):
            self.flow.dtype64.append((call.lineno, call.col_offset, d))

    def _scan_dtype64(self, fnnode: ast.AST) -> None:
        """Float literals inside a NESTED def (it runs when called;
        attribute its default-dtype calls to the enclosing function,
        whose cover decides)."""
        for node in ast.walk(fnnode):
            if isinstance(node, ast.Call):
                d = dotted_name(node.func, self.aliases)
                if d:
                    self._note_float_default(node, d)


# ops/kernels.py wrappers that hand back host arrays (their readback is
# inside, at the boundary) and those that hand back a callable whose call
# launches (``resident_mask_fn``'s ``(dispatch, cols)`` pair included)
_KERNEL_HOST_RESULTS = {
    "predicate_mask",
    "sorted_intersect_counts",
    "sorted_intersect_counts_deferred",
}
_KERNEL_LAUNCHERS = {
    "resident_mask_fn",
    "resident_sorted_intersect",
    "resident_fused_agg_over_join",
}


def _devicey(j: Judgement) -> bool:
    """Possibly a device VALUE. A depset of only ("jit", …) deps is a
    callable, not tensor data — not devicey."""
    return j is True or (
        isinstance(j, frozenset)
        and any(dp[0] != "jit" for dp in j)
    )


def _as_deps(j: Judgement) -> FrozenSet[Dep]:
    if not isinstance(j, frozenset):
        return frozenset()
    return frozenset(dp for dp in j if dp[0] != "jit")


def _spelling(node: ast.AST) -> str:
    try:
        return ast.unparse(node)[:40]
    except (ValueError, RecursionError):
        return "<expr>"


def _str_contains(node: ast.AST, needle: str) -> bool:
    """True when a string literal — including any literal part of an
    f-string or a ``"lit" + var`` concatenation — contains ``needle``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return needle in node.value
    if isinstance(node, ast.JoinedStr):
        return any(
            isinstance(v, ast.Constant)
            and isinstance(v.value, str)
            and needle in v.value
            for v in node.values
        )
    if isinstance(node, ast.BinOp):
        return _str_contains(node.left, needle) or _str_contains(
            node.right, needle
        )
    return False
