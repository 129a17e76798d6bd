"""hslint phase 1: the whole-program project model.

Per-file rules see one file's AST at a time, but the invariants
protecting this code base's concurrency — lock ordering across modules,
which lock guards which field, whether a lock region transitively
reaches blocking work — are properties of the PROGRAM, not of any single
module. This module builds the shared model the cross-module rules
(HS009-HS013) run on:

* **module symbol table** — every module's top-level functions, classes
  (with methods and in-package base resolution), module-level locks, and
  module-level singletons (``hbm_cache = HbmCache()``);
* **resolved call graph** — intra-package edges from every call site a
  static resolver can bind: module functions through (relative) import
  aliases, ``self.m()``/``cls.m()``/``super().m()`` through the MRO,
  singleton methods (``hbm_cache.drop()``), and locally-constructed
  instances (``Executor(conf).execute(plan)``);
* **lock inventory** — every ``threading.Lock/RLock/Condition/Semaphore``
  bound to a class attribute or module global, identified by its
  DEFINING owner (``module:Class.attr``), so two subclasses sharing a
  base-class lock attribute map to one lock identity;
* **per-function facts** — lock acquisition events with the lexically
  held set at each, every call site with the held set, every
  ``self.field`` access with the held set, direct blocking endpoints
  (the HS002 detector plus queue put/get and device dispatch under the
  torch/CUDA device model), and epoch-guard / fence-call markers for the
  residency rules.

Everything is stdlib ``ast``; resolution is deliberately conservative —
an edge the resolver cannot bind is dropped, never guessed, so project
rules inherit "may miss, must not invent" (each rule documents the
resulting blind spots).

Counterpart of ``hyperspace_tpu.analysis.project`` with the same model,
resolution and facts. Where the reference names JAX, this model has the
port's device: a device dispatch is a torch call outside HS007's
host-only list or a call to one of ``ops/kernels.py``'s launching
wrappers, and the fences that stand in for an epoch guard are
``ops.fence`` and ``synchronize()``. The reference's 64-bit-scope facts
serve only its value-flow rules and are left out here.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import ModuleContext, dotted_name, terminal_name
from .rules.hs002_lock_blocking import blocking_reason
from .rules.hs007_unfenced_device_timing import HOST_ONLY, KERNEL_WRAPPERS

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
}
# attrs assigned one of these are self-synchronizing — never "fields" for
# guarded-field inference (an Event or Queue needs no external lock)
_SYNC_CTORS = _LOCK_CTORS | {
    "threading.Event",
    "threading.Thread",
    "queue.Queue",
    "queue.SimpleQueue",
    "queue.LifoQueue",
    "queue.PriorityQueue",
}
_QUEUEISH_RE = re.compile(r"(queue|_q)$", re.I)
# the calls that wait for the card's queued work, which HS012 accepts in
# place of an epoch guard: ``ops.fence`` (any import spelling) and any
# ``synchronize()`` — ``torch.cuda.synchronize``, a stream's or an
# event's. Matched by terminal name, as the reference matches its fences
_FENCE_NAMES = {"fence", "synchronize"}
# the modules whose wrappers launch a hand-written kernel: ``ops.kernels``
# and the ``ops`` package, which re-exports some of them
_KERNEL_MODULES = ("hyperspace_tpu_torch.ops.kernels", "hyperspace_tpu_torch.ops")


def _const_args(call: ast.Call) -> Tuple[Tuple[object, object], ...]:
    """Numeric (non-bool) constants bound at a call site, as
    ``(position-or-keyword, value)`` pairs. Bool/str/None constants are
    structural by convention (mode flags, names) and excluded — the
    recompile-storm class HS016 hunts is numeric per-call literals."""
    out: List[Tuple[object, object]] = []
    for i, a in enumerate(call.args):
        if (
            isinstance(a, ast.Constant)
            and type(a.value) in (int, float)
        ):
            out.append((i, a.value))
    for kw in call.keywords:
        if (
            kw.arg is not None
            and isinstance(kw.value, ast.Constant)
            and type(kw.value.value) in (int, float)
        ):
            out.append((kw.arg, kw.value.value))
    return tuple(out)


# ---------------------------------------------------------------------------
# per-function facts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Acquire:
    """One lock acquisition event and what was already held there."""

    lock: str  # lock id, e.g. "hyperspace_tpu_torch.exec.hbm_cache:ResidentCacheBase._lock"
    line: int
    col: int
    held: Tuple[str, ...]  # lock ids held when this acquisition ran


@dataclass(frozen=True)
class CallSite:
    callee: Optional[str]  # resolved function qualname, or None
    raw: str  # the dotted/attribute spelling at the site (for dumps)
    line: int
    col: int
    held: Tuple[str, ...]
    # numeric (non-bool) constants bound at this site, as
    # ``(position-or-keyword, value)`` pairs — the per-call-site-literal
    # facts HS016's recompile-hazard check reads
    const_args: Tuple[Tuple[object, object], ...] = ()


@dataclass(frozen=True)
class FieldAccess:
    attr: str
    write: bool  # Store/AugAssign/mutating-method-call
    line: int
    col: int
    held: Tuple[str, ...]
    mutcall: Optional[str] = None  # ".append" etc. when write came from a call


@dataclass
class FunctionInfo:
    qual: str  # "module:func" or "module:Class.method"
    module: str
    cls: Optional[str]
    name: str
    path: str
    line: int
    acquires: List[Acquire] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    accesses: List[FieldAccess] = field(default_factory=list)
    blocking: List[Tuple[int, int, str]] = field(default_factory=list)
    epoch_guard: bool = False  # compares against self._epoch / current_epoch()
    fence_call: bool = False  # calls ops.fence / a synchronize()


@dataclass
class ClassInfo:
    module: str
    name: str
    path: str
    line: int
    bases: List[str] = field(default_factory=list)  # raw dotted base spellings
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr -> lock id
    sync_attrs: Set[str] = field(default_factory=set)  # Event/Queue/Thread attrs

    @property
    def qual(self) -> str:
        return f"{self.module}:{self.name}"


@dataclass
class ModuleInfo:
    name: str  # dotted module name
    path: str
    ctx: ModuleContext
    is_package: bool
    aliases: Dict[str, str] = field(default_factory=dict)  # absolute origins
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    locks: Dict[str, str] = field(default_factory=dict)  # global name -> lock id
    singletons: Dict[str, str] = field(default_factory=dict)  # name -> class qual
    config_keys: List[Tuple[str, int, int]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# alias resolution (relative imports included — core.build_aliases skips
# them, but intra-package imports here are almost all relative)
# ---------------------------------------------------------------------------


def module_aliases(
    tree: ast.AST, module: str, is_package: bool
) -> Dict[str, str]:
    """Local name -> ABSOLUTE dotted origin for every import, including
    relative ones resolved against ``module``. Function-level imports are
    collapsed into module scope (the codebase idiom is heavy deferred
    importing; a rare shadowing local import would mis-resolve — accepted)."""
    parts = module.split(".")
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                # relative: level 1 = this package, 2 = parent, ...
                keep = len(parts) - node.level + (1 if is_package else 0)
                if keep < 0:
                    continue  # escapes the modeled tree
                base = ".".join(parts[:keep])
                if node.module:
                    base = f"{base}.{node.module}" if base else node.module
            for a in node.names:
                origin = f"{base}.{a.name}" if base else a.name
                aliases[a.asname or a.name] = origin
    return aliases


def path_to_module(posix_path: str, root_parent: str) -> Tuple[str, bool]:
    """(dotted module name, is_package) for a source path relative to the
    directory CONTAINING the lint root (so ``hyperspace_tpu_torch/exec/scan.py``
    names ``hyperspace_tpu_torch.exec.scan`` whether the caller passed the repo
    root, the package dir, or a virtual fixture path)."""
    rel = posix_path
    if root_parent and rel.startswith(root_parent.rstrip("/") + "/"):
        rel = rel[len(root_parent.rstrip("/")) + 1 :]
    rel = rel[:-3] if rel.endswith(".py") else rel
    parts = [p for p in rel.split("/") if p and p != "."]
    is_package = bool(parts) and parts[-1] == "__init__"
    if is_package:
        parts = parts[:-1]
    return ".".join(parts) or "__main__", is_package


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class ProjectModel:
    """Symbol table + call graph + lock inventory over one set of parsed
    modules. Build with :func:`build_project`."""

    def __init__(self, modules: Dict[str, ModuleInfo]):
        self.modules = modules  # dotted name -> ModuleInfo
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        for m in modules.values():
            for f in m.functions.values():
                self.functions[f.qual] = f
            for c in m.classes.values():
                self.classes[c.qual] = c
                for meth in c.methods.values():
                    self.functions[meth.qual] = meth
        self._mro_cache: Dict[str, List[ClassInfo]] = {}
        self._closure_cache: Dict[str, Dict[str, set]] = {}

    # -- class resolution ----------------------------------------------------
    def resolve_class(self, dotted: str) -> Optional[ClassInfo]:
        """ClassInfo for an absolute dotted spelling ``pkg.mod.Class``,
        following one re-export hop through a package __init__."""
        mod, _, cls = dotted.rpartition(".")
        info = self.modules.get(mod)
        if info is None:
            return None
        if cls in info.classes:
            return info.classes[cls]
        origin = info.aliases.get(cls)
        if origin is not None and origin != dotted:
            mod2, _, cls2 = origin.rpartition(".")
            info2 = self.modules.get(mod2)
            if info2 is not None and cls2 in info2.classes:
                return info2.classes[cls2]
        return None

    def mro(self, cls: ClassInfo) -> List[ClassInfo]:
        """The class plus its in-package bases, nearest first (linearized
        depth-first; diamond bases deduped). Out-of-package bases vanish."""
        if cls.qual in self._mro_cache:
            return self._mro_cache[cls.qual]
        out: List[ClassInfo] = []
        seen: Set[str] = set()

        def walk(c: ClassInfo) -> None:
            if c.qual in seen:
                return
            seen.add(c.qual)
            out.append(c)
            mod = self.modules.get(c.module)
            aliases = mod.aliases if mod else {}
            for b in c.bases:
                resolved = aliases.get(b.split(".")[0])
                if resolved and "." in b:
                    resolved = resolved + "." + b.split(".", 1)[1]
                target = self.resolve_class(resolved or b)
                if target is None and mod is not None and b in mod.classes:
                    target = mod.classes[b]
                if target is not None:
                    walk(target)

        walk(cls)
        self._mro_cache[cls.qual] = out
        return out

    def method_in_mro(
        self, cls: ClassInfo, name: str, skip_self: bool = False
    ) -> Optional[FunctionInfo]:
        for c in self.mro(cls):
            if skip_self and c is cls:
                continue
            if name in c.methods:
                return c.methods[name]
        return None

    def lock_id_in_mro(self, cls: ClassInfo, attr: str) -> Optional[str]:
        for c in self.mro(cls):
            if attr in c.lock_attrs:
                return c.lock_attrs[attr]
        return None

    def sync_attr_in_mro(self, cls: ClassInfo, attr: str) -> bool:
        return any(attr in c.sync_attrs for c in self.mro(cls))

    # -- transitive closures -------------------------------------------------
    def closure(self, kind: str) -> Dict[str, set]:
        """Fixpoint closure over the call graph. ``kind``:
        ``"locks"`` — lock ids acquired by a function or anything it
        transitively calls; ``"blocking"`` — (endpoint description,
        via-qualname) pairs transitively reachable (via = the DIRECT
        callee through which the endpoint is reached; the function's own
        endpoints carry via=None)."""
        if kind in self._closure_cache:
            return self._closure_cache[kind]
        out: Dict[str, set] = {}
        for qual, f in self.functions.items():
            if kind == "locks":
                out[qual] = {a.lock for a in f.acquires}
            else:
                out[qual] = {(desc, None) for _l, _c, desc in f.blocking}
        changed = True
        while changed:
            changed = False
            for qual, f in self.functions.items():
                cur = out[qual]
                for site in f.calls:
                    if site.callee is None or site.callee not in out:
                        continue
                    # snapshot: on a self-recursive call cur IS the
                    # callee's set, and adding while iterating raises
                    for item in list(out[site.callee]):
                        add = (
                            item
                            if kind == "locks"
                            else (item[0], item[1] or site.callee)
                        )
                        if add not in cur:
                            cur.add(add)
                            changed = True
        self._closure_cache[kind] = out
        return out

    def callers_of(self) -> Dict[str, List[Tuple[FunctionInfo, CallSite]]]:
        """Reverse call graph: callee qual -> [(caller, site), ...]."""
        out: Dict[str, List[Tuple[FunctionInfo, CallSite]]] = {}
        for f in self.functions.values():
            for site in f.calls:
                if site.callee is not None:
                    out.setdefault(site.callee, []).append((f, site))
        return out

    # -- debug artifact ------------------------------------------------------
    def dump(self) -> Dict[str, object]:
        """JSON-ready call-graph artifact (``python -m
        hyperspace_tpu_torch.tools.lint --call-graph-dump``): the module
        list, the lock inventory, and per function its resolved edges,
        unresolved call spellings, lock events and direct blocking
        endpoints — the thing to read when a rule's verdict surprises
        you."""
        funcs = {}
        for qual, f in sorted(self.functions.items()):
            funcs[qual] = {
                "path": f.path,
                "line": f.line,
                "calls": sorted(
                    {s.callee for s in f.calls if s.callee is not None}
                ),
                "unresolved": sorted(
                    {s.raw for s in f.calls if s.callee is None and s.raw}
                ),
                "acquires": [
                    {"lock": a.lock, "line": a.line, "held": list(a.held)}
                    for a in f.acquires
                ],
                "blocking": [d for _l, _c, d in f.blocking],
            }
        locks = sorted(
            {
                lid
                for m in self.modules.values()
                for lid in list(m.locks.values())
            }
            | {
                lid
                for c in self.classes.values()
                for lid in c.lock_attrs.values()
            }
        )
        return {
            "modules": sorted(self.modules),
            "locks": locks,
            "functions": funcs,
        }


# ---------------------------------------------------------------------------
# building the model
# ---------------------------------------------------------------------------


def build_project(
    contexts: Sequence[Tuple[ModuleContext, str, bool]]
) -> ProjectModel:
    """Build the model from ``(ctx, module_name, is_package)`` triples.
    Two passes: collect symbols first (so cross-module resolution sees
    every target), then walk function bodies resolving calls and locks."""
    modules: Dict[str, ModuleInfo] = {}
    for ctx, name, is_pkg in contexts:
        info = ModuleInfo(
            name=name,
            path=ctx.path,
            ctx=ctx,
            is_package=is_pkg,
            aliases=module_aliases(ctx.tree, name, is_pkg),
        )
        _collect_symbols(info)
        modules[name] = info
    model = ProjectModel(modules)
    for info in modules.values():
        _resolve_inherited_locks(model, info)
    for info in modules.values():
        walker = _FunctionWalker(model, info)
        for f, node, cls in _iter_functions(info):
            walker.walk(f, node, cls)
        walker.walk_module_level(info)
    return model


def _iter_functions(info: ModuleInfo):
    for f in info.functions.values():
        yield f, f._node, None  # type: ignore[attr-defined]
    for c in info.classes.values():
        for m in c.methods.values():
            yield m, m._node, c  # type: ignore[attr-defined]


def _ctor_name(value: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    if isinstance(value, ast.Call):
        return dotted_name(value.func, aliases)
    return None


def _collect_symbols(info: ModuleInfo) -> None:
    for node in info.ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            f = FunctionInfo(
                qual=f"{info.name}:{node.name}",
                module=info.name,
                cls=None,
                name=node.name,
                path=info.path,
                line=node.lineno,
            )
            f._node = node  # type: ignore[attr-defined]
            info.functions[node.name] = f
        elif isinstance(node, ast.ClassDef):
            cls = ClassInfo(
                module=info.name,
                name=node.name,
                path=info.path,
                line=node.lineno,
                bases=[
                    d
                    for b in node.bases
                    if (d := _base_spelling(b)) is not None
                ],
            )
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    m = FunctionInfo(
                        qual=f"{info.name}:{node.name}.{sub.name}",
                        module=info.name,
                        cls=node.name,
                        name=sub.name,
                        path=info.path,
                        line=sub.lineno,
                    )
                    m._node = sub  # type: ignore[attr-defined]
                    cls.methods[sub.name] = m
            # self.<attr> = threading.Lock()/Event()/... anywhere in the
            # class's methods feeds the lock/sync inventories
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                ctor = _ctor_name(sub.value, info.aliases)
                if ctor is None:
                    continue
                for t in sub.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        if ctor in _LOCK_CTORS:
                            cls.lock_attrs[t.attr] = (
                                f"{info.name}:{node.name}.{t.attr}"
                            )
                        if ctor in _SYNC_CTORS:
                            cls.sync_attrs.add(t.attr)
            info.classes[node.name] = cls
        elif isinstance(node, ast.Assign):
            ctor = _ctor_name(node.value, info.aliases)
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if ctor in _LOCK_CTORS:
                    info.locks[t.id] = f"{info.name}:{t.id}"
                elif ctor is not None:
                    # module-level singleton: resolved to a class later
                    info.singletons[t.id] = ctor


def _base_spelling(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def _resolve_inherited_locks(model: ProjectModel, info: ModuleInfo) -> None:
    """Rewrite singleton ctor spellings to class quals (needs the full
    symbol table, hence a second pass)."""
    resolved: Dict[str, str] = {}
    for name, ctor in info.singletons.items():
        cls = _resolve_dotted_class(model, info, ctor)
        if cls is not None:
            resolved[name] = cls.qual
    info.singletons = resolved


def _resolve_dotted_class(
    model: ProjectModel, info: ModuleInfo, dotted: str
) -> Optional[ClassInfo]:
    """A class from a dotted spelling as seen in ``info``: local class,
    alias to an in-package class, or absolute path."""
    if dotted in info.classes:
        return info.classes[dotted]
    head, _, rest = dotted.partition(".")
    origin = info.aliases.get(head)
    full = f"{origin}.{rest}" if origin and rest else (origin or dotted)
    cls = model.resolve_class(full)
    if cls is not None:
        return cls
    return model.resolve_class(dotted)


# ---------------------------------------------------------------------------
# function-body walker: held-lock tracking + resolution
# ---------------------------------------------------------------------------


class _FunctionWalker:
    def __init__(self, model: ProjectModel, info: ModuleInfo):
        self.model = model
        self.info = info

    # -- entry points --------------------------------------------------------
    def walk(
        self, f: FunctionInfo, node: ast.AST, cls: Optional[ClassInfo]
    ) -> None:
        self.f = f
        self.cls = cls
        self.local_types: Dict[str, str] = {}  # var -> class qual
        self.thread_vars: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
                d = dotted_name(sub.value.func, self.info.aliases) or ""
                if d.endswith(("Thread", "Popen", "Process")):
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            self.thread_vars.add(t.id)
                loc = self._resolve_ctor_class(sub.value)
                if loc is not None:
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            self.local_types[t.id] = loc.qual
        self._body(list(getattr(node, "body", [])), ())

    def walk_module_level(self, info: ModuleInfo) -> None:
        """Module top-level statements as a pseudo-function — singleton
        construction and import-time calls appear in the graph."""
        f = FunctionInfo(
            qual=f"{info.name}:<module>",
            module=info.name,
            cls=None,
            name="<module>",
            path=info.path,
            line=1,
        )
        self.f = f
        self.cls = None
        self.local_types = {}
        self.thread_vars = set()
        body = [
            st
            for st in info.ctx.tree.body
            if not isinstance(
                st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            )
        ]
        self._body(body, ())
        self.model.functions[f.qual] = f

    # -- lock resolution -----------------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        """Lock id of an acquisition expression, or None when it does not
        resolve into the inventory (a parameter named ``lock``, an
        attribute of an untyped receiver — HS002 still sees those
        lexically)."""
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in self.info.locks:
                return self.info.locks[name]
            origin = self.info.aliases.get(name)
            if origin:
                mod, _, attr = origin.rpartition(".")
                m = self.model.modules.get(mod)
                if m and attr in m.locks:
                    return m.locks[attr]
            return None
        if isinstance(expr, ast.Attribute):
            recv = expr.value
            if isinstance(recv, ast.Name) and recv.id == "self" and self.cls:
                return self.model.lock_id_in_mro(self.cls, expr.attr)
            # module-global lock through an import: mod.LOCK_NAME
            d = dotted_name(recv, self.info.aliases)
            if d:
                m = self.model.modules.get(d)
                if m and expr.attr in m.locks:
                    return m.locks[expr.attr]
            # singleton attribute: hbm_cache._lock
            owner = self._class_of_expr(recv)
            if owner is not None:
                return self.model.lock_id_in_mro(owner, expr.attr)
        return None

    def _class_of_expr(self, expr: ast.AST) -> Optional[ClassInfo]:
        """Static type of a receiver expression when derivable: ``self``,
        a local constructed instance, or a module-level singleton
        (possibly imported)."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and self.cls is not None:
                return self.cls
            if expr.id in self.local_types:
                return self.model.classes.get(self.local_types[expr.id])
            if expr.id in self.info.singletons:
                return self.model.classes.get(self.info.singletons[expr.id])
            origin = self.info.aliases.get(expr.id)
            if origin:
                mod, _, attr = origin.rpartition(".")
                m = self.model.modules.get(mod)
                if m and attr in m.singletons:
                    return self.model.classes.get(m.singletons[attr])
        elif isinstance(expr, ast.Attribute):
            d = dotted_name(expr, self.info.aliases)
            if d:
                mod, _, attr = d.rpartition(".")
                m = self.model.modules.get(mod)
                if m and attr in m.singletons:
                    return self.model.classes.get(m.singletons[attr])
        return None

    def _resolve_ctor_class(self, call: ast.Call) -> Optional[ClassInfo]:
        d = dotted_name(call.func, self.info.aliases)
        if d is None:
            return None
        return _resolve_dotted_class(self.model, self.info, d)

    # -- call resolution -----------------------------------------------------
    def _resolve_call(self, call: ast.Call) -> Tuple[Optional[str], str]:
        func = call.func
        raw = dotted_name(func, self.info.aliases) or ""
        # name(): local module function or alias of an in-package function
        if isinstance(func, ast.Name):
            if func.id in self.info.functions:
                return self.info.functions[func.id].qual, raw
            origin = self.info.aliases.get(func.id)
            if origin:
                q = self._qual_for_dotted(origin)
                if q is not None:
                    return q, raw
            cls = _resolve_dotted_class(self.model, self.info, func.id)
            if cls is not None:
                init = self.model.method_in_mro(cls, "__init__")
                return (init.qual if init else None), raw
            return None, raw
        if isinstance(func, ast.Attribute):
            recv = func.value
            # super().m()
            if (
                isinstance(recv, ast.Call)
                and isinstance(recv.func, ast.Name)
                and recv.func.id == "super"
                and self.cls is not None
            ):
                m = self.model.method_in_mro(self.cls, func.attr, skip_self=True)
                return (m.qual if m else None), raw
            owner = self._class_of_expr(recv)
            if owner is None and isinstance(recv, ast.Name):
                # ClassName.method(...)
                owner = _resolve_dotted_class(self.model, self.info, recv.id)
            if owner is not None:
                m = self.model.method_in_mro(owner, func.attr)
                if m is not None:
                    return m.qual, raw
                return None, raw
            if raw:
                q = self._qual_for_dotted(raw)
                if q is not None:
                    return q, raw
        return None, raw

    def _qual_for_dotted(self, dotted: str) -> Optional[str]:
        """Function/method qual for an absolute dotted spelling:
        ``pkg.mod.func``, ``pkg.mod.Class`` (ctor), or
        ``pkg.mod.singleton.method``."""
        mod, _, last = dotted.rpartition(".")
        m = self.model.modules.get(mod)
        if m is not None:
            if last in m.functions:
                return m.functions[last].qual
            if last in m.classes:
                init = self.model.method_in_mro(m.classes[last], "__init__")
                return init.qual if init else None
            if last in m.singletons:
                return None  # a bare singleton reference, not a call target
        # pkg.mod.singleton.method / pkg.mod.Class.method
        mod2, _, obj = mod.rpartition(".")
        m2 = self.model.modules.get(mod2)
        if m2 is not None:
            owner: Optional[ClassInfo] = None
            if obj in m2.singletons:
                owner = self.model.classes.get(m2.singletons[obj])
            elif obj in m2.classes:
                owner = m2.classes[obj]
            if owner is not None:
                meth = self.model.method_in_mro(owner, last)
                if meth is not None:
                    return meth.qual
        return None

    # -- body walk with held-lock tracking ------------------------------------
    def _body(self, stmts: List[ast.stmt], held: Tuple[str, ...]) -> None:
        held = tuple(held)
        for st in stmts:
            # lock.acquire()/release() toggling in this statement list
            if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
                f = st.value.func
                if isinstance(f, ast.Attribute) and f.attr in (
                    "acquire",
                    "release",
                ):
                    lid = self._lock_of(f.value)
                    if lid is not None:
                        # the call itself runs held-as-is
                        self._exprs(st, held)
                        if f.attr == "acquire":
                            self.f.acquires.append(
                                Acquire(lid, st.lineno, st.col_offset, held)
                            )
                            held = held + (lid,)
                        elif lid in held:
                            out = list(held)
                            out.remove(lid)
                            held = tuple(out)
                        continue
            if isinstance(st, ast.With):
                inner = held
                for item in st.items:
                    self._exprs(item.context_expr, inner)
                    lid = self._lock_of(item.context_expr)
                    if lid is not None:
                        self.f.acquires.append(
                            Acquire(
                                lid,
                                item.context_expr.lineno,
                                item.context_expr.col_offset,
                                inner,
                            )
                        )
                        inner = inner + (lid,)
                self._body(st.body, inner)
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested def: deferred, its own (unmodeled) scope
            if isinstance(st, (ast.For, ast.AsyncFor)):
                self._exprs(st.iter, held)
                self._body(st.body, held)
                self._body(st.orelse, held)
                continue
            if isinstance(st, ast.While):
                self._exprs(st.test, held)
                self._body(st.body, held)
                self._body(st.orelse, held)
                continue
            if isinstance(st, ast.If):
                self._exprs(st.test, held)
                self._body(st.body, held)
                self._body(st.orelse, held)
                continue
            if isinstance(st, ast.Try):
                self._body(st.body, held)
                for h in st.handlers:
                    self._body(h.body, held)
                self._body(st.orelse, held)
                self._body(st.finalbody, held)
                continue
            self._exprs(st, held)

    def _exprs(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        """Record calls / field accesses / blocking endpoints in one
        statement's expressions (nested def/lambda bodies pruned — they
        run later, outside the lexical lock region)."""
        stack: List[ast.AST] = [node]
        while stack:
            sub = stack.pop()
            for child in ast.iter_child_nodes(sub):
                if not isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    stack.append(child)
            if isinstance(sub, ast.Call):
                self._record_call(sub, held)
            elif isinstance(sub, ast.Attribute):
                self._record_access(sub, held)
            elif isinstance(sub, ast.Compare):
                self._note_epoch_guard(sub)

    _MUTATORS = {
        "append",
        "extend",
        "remove",
        "clear",
        "pop",
        "popleft",
        "add",
        "discard",
        "update",
        "insert",
        "setdefault",
    }

    def _record_call(self, call: ast.Call, held: Tuple[str, ...]) -> None:
        callee, raw = self._resolve_call(call)
        self.f.calls.append(
            CallSite(
                callee,
                raw,
                call.lineno,
                call.col_offset,
                held,
                _const_args(call),
            )
        )
        term = (
            terminal_name(call.func)
            if isinstance(call.func, (ast.Attribute, ast.Name))
            else None
        )
        if term in _FENCE_NAMES:
            self.f.fence_call = True
        if term == "current_epoch":
            self.f.epoch_guard = True
        # mutating method call on a self field: self._tables.append(...)
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in self._MUTATORS
            and isinstance(call.func.value, ast.Attribute)
            and isinstance(call.func.value.value, ast.Name)
            and call.func.value.value.id == "self"
        ):
            self.f.accesses.append(
                FieldAccess(
                    call.func.value.attr,
                    True,
                    call.lineno,
                    call.col_offset,
                    held,
                    mutcall=call.func.attr,
                )
            )
        why = self._blocking_endpoint(call, raw)
        if why is not None:
            self.f.blocking.append((call.lineno, call.col_offset, why))

    def _blocking_endpoint(self, call: ast.Call, raw: str) -> Optional[str]:
        """Direct blocking endpoints for HS011: the HS002 detector plus
        queue put/get (a bounded queue blocks on full/empty) and device
        dispatch (device work under a host lock convoys every other
        thread behind the card).

        A device dispatch is a resolved ``torch.*`` call outside HS007's
        host-only list, or a call to one of ``ops/kernels.py``'s
        launching wrappers (HS007's ``KERNEL_WRAPPERS``; both lists are
        HS007's, so one list holds the device model). The wrappers are
        matched EXACTLY, as ``hyperspace_tpu_torch.ops.kernels.<name>``
        or the ``ops`` package's re-export of one: ``module_aliases``
        resolves the port's relative imports to absolute names, so unlike
        HS007's per-file pass (which sees ``kernels.x`` as spelled and
        matches by name suffix) the model never credits a same-named
        function of another module."""
        why = blocking_reason(call, self.info.aliases, self.thread_vars)
        if why is not None:
            return why
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            recv_name = terminal_name(call.func.value)
            if (
                attr in ("put", "get")
                and recv_name
                and _QUEUEISH_RE.search(recv_name)
            ):
                return f"'{recv_name}.{attr}()'"
        if raw.startswith("torch.") and raw not in HOST_ONLY:
            return f"'{raw}' device dispatch"
        mod, _, name = raw.rpartition(".")
        if mod in _KERNEL_MODULES and name in KERNEL_WRAPPERS:
            return f"'{raw}' device dispatch"
        return None

    def _record_access(
        self, attr: ast.Attribute, held: Tuple[str, ...]
    ) -> None:
        if not (isinstance(attr.value, ast.Name) and attr.value.id == "self"):
            return
        write = isinstance(attr.ctx, (ast.Store, ast.Del))
        self.f.accesses.append(
            FieldAccess(attr.attr, write, attr.lineno, attr.col_offset, held)
        )

    def _note_epoch_guard(self, cmp: ast.Compare) -> None:
        for side in [cmp.left, *cmp.comparators]:
            if (
                isinstance(side, ast.Attribute)
                and side.attr == "_epoch"
                and isinstance(side.value, ast.Name)
                and side.value.id == "self"
            ):
                self.f.epoch_guard = True


# ---------------------------------------------------------------------------
# convenience entry points
# ---------------------------------------------------------------------------


def contexts_from_paths(
    paths: Iterable[Path],
) -> List[Tuple[ModuleContext, str, bool]]:
    """Parse every ``.py`` under ``paths`` into build_project inputs.
    Module names are derived relative to each root's parent, so passing
    ``repo/hyperspace_tpu_torch repo/chip_smoke.py`` yields
    ``hyperspace_tpu_torch.*`` and ``chip_smoke``. Unparseable files
    are skipped here — per-file analysis reports them as HS000."""
    from .core import iter_python_files

    out: List[Tuple[ModuleContext, str, bool]] = []
    for root in paths:
        root = Path(root)
        base = root.parent.as_posix()
        for f in iter_python_files([root]):
            try:
                ctx = ModuleContext(
                    f.read_text(encoding="utf-8"), str(f)
                )
            except (SyntaxError, OSError):
                continue
            name, is_pkg = path_to_module(f.as_posix(), base)
            out.append((ctx, name, is_pkg))
    return out


def build_project_from_sources(
    sources: Dict[str, str]
) -> ProjectModel:
    """Model over virtual ``{posix path: source}`` trees — the fixture
    entry point (tests hand a synthetic package, no filesystem)."""
    contexts = []
    for path, src in sources.items():
        ctx = ModuleContext(src, path)
        name, is_pkg = path_to_module(Path(path).as_posix(), "")
        contexts.append((ctx, name, is_pkg))
    return build_project(contexts)
