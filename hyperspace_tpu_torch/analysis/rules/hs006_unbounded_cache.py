"""HS006 — module-level caches that only ever grow.

The bug class: content-hash-named native libraries that accumulate in a
cache directory forever (one per source revision). The in-process twin of that bug is a module-level dict/list
named like a cache that functions insert into with no eviction path —
a long-lived serving process (the north-star deployment) leaks host
memory one entry per distinct key until OOM.

Detection:
  * cache object: a module-level assignment ``NAME = {}``/``dict()``/
    ``[]``/``list()``/``OrderedDict()`` where NAME matches ``memo`` or
    ``cache`` (case-insensitive);
  * growth site: inside a function, ``NAME[k] = v``, ``NAME.append``,
    ``NAME.add``, or ``NAME.setdefault``;
  * eviction evidence (module-wide, any of): ``NAME.pop``/``popitem``/
    ``clear``, ``del NAME[...]``, NAME reassigned inside a function,
    NAME passed to any call whose name contains ``bounded`` or ``evict``
    (the repo's ``bounded_memo_put`` helper), or a ``len(NAME)``
    comparison (a size guard implies a bounding branch);
  * a growth site with no eviction evidence anywhere in the module is
    flagged. Registries that are *meant* to be append-only (rule
    registries, format tables) simply avoid cache-ish names.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Set, Tuple

from ..core import ModuleContext, Rule, terminal_name

_CACHEISH_RE = re.compile(r"memo|cache", re.I)
_GROW_ATTRS = {"append", "add", "setdefault"}
_EVICT_ATTRS = {"pop", "popitem", "clear"}
_BOUNDED_CALL_RE = re.compile(r"bounded|evict|prune|trim", re.I)
_CTOR_NAMES = {"dict", "list", "set", "OrderedDict", "defaultdict"}


def _module_level_caches(tree: ast.Module) -> Dict[str, int]:
    """name -> lineno of module-level cache-named container bindings."""
    out: Dict[str, int] = {}
    for st in tree.body:
        targets: List[ast.expr] = []
        value = None
        if isinstance(st, ast.Assign):
            targets, value = st.targets, st.value
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            targets, value = [st.target], st.value
        for t in targets:
            if not isinstance(t, ast.Name) or not _CACHEISH_RE.search(t.id):
                continue
            if isinstance(value, (ast.Dict, ast.List, ast.Set)):
                out[t.id] = st.lineno
            elif isinstance(value, ast.Call) and (
                (terminal_name(value.func) or "") in _CTOR_NAMES
            ):
                out[t.id] = st.lineno
    return out


class UnboundedCacheRule(Rule):
    code = "HS006"
    name = "unbounded-module-cache"
    description = (
        "a module-level cache/memo container is grown inside functions "
        "with no eviction path anywhere in the module"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        tree = ctx.tree
        caches = _module_level_caches(tree)
        if not caches:
            return
        evicted: Set[str] = set()
        grow_sites: List[Tuple[str, int, int]] = []
        in_function: Set[int] = set()  # line spans are simpler via walk

        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                # growth
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in caches
                        ):
                            grow_sites.append((t.value.id, node.lineno, node.col_offset))
                        # reassignment inside a function resets the cache
                        if isinstance(t, ast.Name) and t.id in caches:
                            evicted.add(t.id)
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in caches
                ):
                    if node.func.attr in _GROW_ATTRS:
                        grow_sites.append(
                            (node.func.value.id, node.lineno, node.col_offset)
                        )
                    elif node.func.attr in _EVICT_ATTRS:
                        evicted.add(node.func.value.id)

        # module-wide eviction evidence (any scope)
        for node in ast.walk(tree):
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in caches
                    ):
                        evicted.add(t.value.id)
            if isinstance(node, ast.Call):
                fname = terminal_name(node.func) or ""
                if _BOUNDED_CALL_RE.search(fname):
                    for a in node.args:
                        if isinstance(a, ast.Name) and a.id in caches:
                            evicted.add(a.id)
                if fname == "len":
                    # len(NAME) in a comparison = a size guard somewhere
                    for a in node.args:
                        if isinstance(a, ast.Name) and a.id in caches:
                            evicted.add(a.id)

        seen: Set[Tuple[str, int, int]] = set()
        for name, line, col in grow_sites:
            if name in evicted or (name, line, col) in seen:
                continue
            seen.add((name, line, col))
            yield (
                line,
                col,
                f"module-level cache '{name}' grows here with no eviction "
                "path in this module; bound it (utils.memo.bounded_memo_put)"
                " or add an explicit eviction branch",
            )
