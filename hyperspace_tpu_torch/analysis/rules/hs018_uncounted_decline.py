"""HS018 — eligibility decline with no counter (the silent tail).

The decline discipline: when an eligibility function routes a request
off the fast path, the reason is counted
(``metrics.incr("….declined.…")``) so a fleet that silently degrades
to the slow path shows up in dashboards instead of in latency graphs.
This rule enforces the discipline's SELF-CONSISTENCY: it runs only on
functions that already count at least one decline (opting into the
discipline), and flags every early ``return None``/``return False``
branch of an ``if`` that reaches no decline counter — the branch the
next refactor forgets.

A branch is counted when, before the return, it either increments a
``…declined…`` metric lexically or calls a function that (transitively)
does — the helper-counts-for-me pattern. Plain top-level returns (the
function's main exit) and ``raise`` branches are out of scope: an
exception is loud by itself, the silent tail is the quiet ``None``.

The reference rule as written: it names no device."""

from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from ..core import ProjectRule, terminal_name
from ..dataflow import _str_contains


def _is_decline_incr(call: ast.Call) -> bool:
    # the same literal matcher the flow pass uses for declined_incr, so
    # lexical counting here and reach-based counting there agree on what
    # a decline counter IS (plain, f-string, or concatenated spelling)
    if terminal_name(call.func) not in ("incr", "counter") or not call.args:
        return False
    return _str_contains(call.args[0], "declined")


def _sentinel(ret: ast.Return) -> bool:
    if ret.value is None:
        return True
    return isinstance(ret.value, ast.Constant) and (
        ret.value.value is None or ret.value.value is False
    )


class UncountedDeclineRule(ProjectRule):
    code = "HS018"
    name = "uncounted-decline"
    description = (
        "an eligibility function that counts some declines has an early "
        "return None/False branch reaching no metrics.incr('…declined…') "
        "— the silent tail the decline discipline bans"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        flow = project.device_flow()
        reach = flow.declined_reach()
        for qual, fl in sorted(flow.flows.items()):
            if not fl.declined_incr:
                continue
            f = project.functions[qual]
            node = getattr(f, "_node", None)
            if node is None:
                continue
            callmap = {
                (s.line, s.col): s.callee
                for s in f.calls
                if s.callee is not None
            }

            def counted(prefix: List[ast.stmt]) -> bool:
                for st in prefix:
                    for sub in ast.walk(st):
                        if not isinstance(sub, ast.Call):
                            continue
                        if _is_decline_incr(sub):
                            return True
                        callee = callmap.get(
                            (sub.lineno, sub.col_offset)
                        )
                        if callee is not None and callee in reach:
                            return True
                return False

            def scan(stmts: List[ast.stmt]) -> Iterator[ast.Return]:
                for st in stmts:
                    if isinstance(st, ast.If):
                        for suite in (st.body, st.orelse):
                            for i, s in enumerate(suite):
                                if isinstance(s, ast.Return) and _sentinel(
                                    s
                                ):
                                    if not counted(suite[: i + 1]):
                                        yield s
                            yield from scan(suite)
                    elif isinstance(st, (ast.For, ast.While, ast.With)):
                        yield from scan(st.body)
                        yield from scan(getattr(st, "orelse", []) or [])
                    elif isinstance(st, ast.Try):
                        yield from scan(st.body)
                        for h in st.handlers:
                            yield from scan(h.body)
                        yield from scan(st.orelse)
                        yield from scan(st.finalbody)

            for ret in scan(node.body):
                yield (
                    f.path,
                    ret.lineno,
                    ret.col_offset,
                    f"{f.name}() counts other declines but this early "
                    "return reaches no metrics.incr('…declined.…') — "
                    "the silent tail: count the reason before routing "
                    "off the fast path",
                )
