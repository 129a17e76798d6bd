"""HS005 — non-deterministic iteration feeding a stable-hash sink.

Signatures and fingerprints (``utils/hashing.md5_hex``, the signature
providers, ``sketch_key``) promise *stability across processes*: an index
built yesterday must match the same plan today. Python ``set`` iteration
order varies run to run (string hashes are salted per process), so a set
— or an unsorted dict view whose insertion order is caller-dependent —
folded into a hash input silently yields a signature that never matches
again: the index just stops applying, with no error anywhere.

Detection (syntactic; documented blind spots):
  * hash sinks: calls resolving to ``md5_hex`` (any import spelling),
    ``sketch_key``, or ``hashlib.<algo>(...)``/``.update(...)`` argument
    expressions;
  * inside a sink argument, flag: a set literal ``{a, b}``, a
    ``set(...)``/``frozenset(...)`` call, or a ``.keys()/.values()/
    .items()`` dict-view call — unless wrapped (at any enclosing level
    inside the argument) in ``sorted(...)``, ``min``/``max``, ``sum``,
    ``len``, or ``json.dumps(..., sort_keys=True)``;
  * ``json.dumps`` CALLS passed straight to a sink without
    ``sort_keys=True`` are flagged too — dict order is insertion order,
    which for config-shaped dicts depends on the caller.

Blind spot: a set iterated into a local list that is *later* hashed is
not tracked across statements (intra-expression only).
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from ..core import ModuleContext, Rule, dotted_name, terminal_name

_SINK_SUFFIXES = ("md5_hex", "sketch_key")
_DICT_VIEWS = {"keys", "values", "items"}
_ORDER_NEUTRALIZERS = {"sorted", "min", "max", "sum", "len", "frozenset.intersection"}
_HASHLIB_ALGOS = {
    "md5",
    "sha1",
    "sha224",
    "sha256",
    "sha384",
    "sha512",
    "blake2b",
    "blake2s",
}


def _is_sink(call: ast.Call, ctx: ModuleContext) -> bool:
    d = dotted_name(call.func, ctx.aliases) or ""
    if d.endswith(_SINK_SUFFIXES):
        return True
    if d.startswith("hashlib.") and d.split(".")[-1] in _HASHLIB_ALGOS:
        return True
    if isinstance(call.func, ast.Attribute) and call.func.attr == "update":
        # conservative: only receivers that look hash-like (h/hasher/digest)
        recv = terminal_name(call.func.value) or ""
        return recv in {"h", "hasher", "md5", "sha", "digest"}
    return False


def _sorted_dumps(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "sort_keys" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


class NondeterministicHashRule(Rule):
    code = "HS005"
    name = "nondeterministic-hash-input"
    description = (
        "a set or unsorted dict view feeds a stable-hash sink (md5_hex/"
        "sketch_key/hashlib); iteration order varies across processes, so "
        "the fingerprint silently never matches again"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and _is_sink(node, ctx):
                for arg in [*node.args, *[k.value for k in node.keywords]]:
                    yield from self._unordered_in(arg, ctx)

    def _unordered_in(
        self, expr: ast.AST, ctx: ModuleContext
    ) -> Iterator[Tuple[int, int, str]]:
        def walk(n: ast.AST, neutralized: bool):
            if isinstance(n, ast.Call):
                d = dotted_name(n.func, ctx.aliases) or ""
                t = terminal_name(n.func) or ""
                if t in ("sorted",) or d in _ORDER_NEUTRALIZERS or t in (
                    "min",
                    "max",
                    "sum",
                    "len",
                ):
                    for c in ast.iter_child_nodes(n):
                        yield from walk(c, True)
                    return
                if d in ("json.dumps",) and not neutralized:
                    if not _sorted_dumps(n):
                        yield (
                            n.lineno,
                            n.col_offset,
                            "json.dumps without sort_keys=True feeds a "
                            "stable-hash sink; dict insertion order is "
                            "caller-dependent — pass sort_keys=True",
                        )
                    # a sorted dumps neutralizes everything inside it
                    for c in ast.iter_child_nodes(n):
                        yield from walk(c, _sorted_dumps(n) or neutralized)
                    return
                if not neutralized and (t in ("set", "frozenset") or d in ("set", "frozenset")):
                    yield (
                        n.lineno,
                        n.col_offset,
                        "set() iteration order is process-salted; sort it "
                        "(sorted(...)) before hashing",
                    )
                if (
                    not neutralized
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _DICT_VIEWS
                    and not n.args
                ):
                    yield (
                        n.lineno,
                        n.col_offset,
                        f".{n.func.attr}() order is insertion order (caller-"
                        "dependent); wrap in sorted(...) before hashing",
                    )
                for c in ast.iter_child_nodes(n):
                    yield from walk(c, neutralized)
                return
            if isinstance(n, ast.Set) and not neutralized:
                yield (
                    n.lineno,
                    n.col_offset,
                    "set literal iteration order is process-salted; use a "
                    "sorted sequence before hashing",
                )
            for c in ast.iter_child_nodes(n):
                yield from walk(c, neutralized)

        yield from walk(expr, False)
