"""HS003 — cache keys built from un-normalized path arguments.

The bug class: a metadata memo keyed on a raw ``path``
parameter that arrives as ``str`` at some call sites and ``pathlib.Path``
at others — one file occupies two cache slots and silently halves the
effective capacity. Annotations do not protect against this (the seed
function was annotated ``path: str`` and still received ``Path``), so the
rule demands an explicit ``path = str(path)`` / ``os.fspath`` rebind in
any function that folds a path-like parameter into a memo key.

Detection:
  * path-like parameter: name contains ``path`` (case-insensitive), is
    one of ``fname``/``filename``/``fpath``, or the annotation source
    mentions ``Path``;
  * normalization: an assignment ``p = str(p)`` / ``p = os.fspath(p)``
    anywhere in the function;
  * key sites: the key argument of ``bounded_memo_put``; subscript
    stores / ``.get`` calls on names containing ``memo``/``cache``; and
    assignments to ``*key*`` variables in functions that reference a
    memo/cache name;
  * a reference inside ``str(...)``/``os.fspath(...)``/``repr(...)`` or
    inside a comprehension (whose element is typically normalized
    per-item) does not count as raw.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Set, Tuple

from ..core import ModuleContext, Rule, dotted_name, terminal_name

_PATHISH_RE = re.compile(r"path", re.I)
_PATHISH_EXTRA = {"fname", "filename", "fpath"}
_MEMOISH_RE = re.compile(r"memo|cache", re.I)
_KEYISH_RE = re.compile(r"key", re.I)
_NORMALIZERS = {"str", "os.fspath", "repr", "bytes"}


def _pathish_params(fn: ast.AST) -> Set[str]:
    args = fn.args
    out: Set[str] = set()
    for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
        name = a.arg
        ann = ast.dump(a.annotation) if a.annotation is not None else ""
        if (
            _PATHISH_RE.search(name)
            or name in _PATHISH_EXTRA
            or "Path" in ann
        ):
            out.add(name)
    return out


def _normalized_params(fn: ast.AST, params: Set[str], aliases) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Name) and t.id in params):
            continue
        v = node.value
        if (
            isinstance(v, ast.Call)
            and (dotted_name(v.func, aliases) or "") in _NORMALIZERS
            and len(v.args) == 1
            and isinstance(v.args[0], ast.Name)
            and v.args[0].id == t.id
        ):
            out.add(t.id)
    return out


def _raw_refs(expr: ast.AST, pending: Set[str], aliases) -> List[ast.Name]:
    """Name references to ``pending`` params not wrapped in a normalizer
    call and not inside a comprehension."""
    out: List[ast.Name] = []

    def walk(n: ast.AST, wrapped: bool) -> None:
        if isinstance(n, ast.Call):
            d = dotted_name(n.func, aliases) or ""
            w = wrapped or d in _NORMALIZERS
            for c in ast.iter_child_nodes(n):
                walk(c, w)
            return
        if isinstance(n, (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)):
            for c in ast.iter_child_nodes(n):
                walk(c, True)
            return
        if isinstance(n, ast.Name) and n.id in pending and not wrapped:
            out.append(n)
        for c in ast.iter_child_nodes(n):
            walk(c, wrapped)

    walk(expr, False)
    return out


class PathKeyRule(Rule):
    code = "HS003"
    name = "unnormalized-path-cache-key"
    description = (
        "a memo/cache key is built from a path-like parameter without "
        "str()/os.fspath() normalization (str/Path aliasing splits cache "
        "slots)"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = _pathish_params(fn)
            if not params:
                continue
            pending = params - _normalized_params(fn, params, ctx.aliases)
            if not pending:
                continue
            memoish = any(
                isinstance(n, (ast.Name, ast.Attribute))
                and _MEMOISH_RE.search(terminal_name(n) or "")
                for n in ast.walk(fn)
            )
            for line, col, name in self._key_site_refs(
                fn, pending, memoish, ctx
            ):
                yield (
                    line,
                    col,
                    f"cache key uses path-like parameter '{name}' without "
                    f"normalization; rebind '{name} = str({name})' (or "
                    "os.fspath) before building the key",
                )

    def _key_site_refs(
        self,
        fn: ast.AST,
        pending: Set[str],
        memoish_in_fn: bool,
        ctx: ModuleContext,
    ):
        for node in ast.walk(fn):
            key_exprs: List[ast.AST] = []
            if isinstance(node, ast.Call):
                d = dotted_name(node.func, ctx.aliases) or ""
                t = terminal_name(node.func) or ""
                if t == "bounded_memo_put" or d.endswith("bounded_memo_put"):
                    if len(node.args) >= 2:
                        key_exprs.append(node.args[1])
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "setdefault", "pop")
                    and _MEMOISH_RE.search(terminal_name(node.func.value) or "")
                    and node.args
                ):
                    key_exprs.append(node.args[0])
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and _MEMOISH_RE.search(
                        terminal_name(t.value) or ""
                    ):
                        key_exprs.append(t.slice)
                if (
                    memoish_in_fn
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _KEYISH_RE.search(node.targets[0].id)
                ):
                    key_exprs.append(node.value)
            for expr in key_exprs:
                for ref in _raw_refs(expr, pending, ctx.aliases):
                    yield ref.lineno, ref.col_offset, ref.id
