"""HS004 — swallowed exceptions that silently disable behavior.

The bug class: ``DataSkippingFilterRule`` swallows every
exception (by design — a rule must never fail the query), so when a
``SketchSpec`` subclass raised ``NotImplementedError`` from the new
``prepare_test`` extension point, skipping was *silently disabled* for
every query — no log line, no metric, no failing test. The reference
rules swallow too (FilterIndexRule.scala:79-83), but they emit an event
first; "silent" is the bug, not "swallow".

Detection:
  * a handler catching ``Exception``/``BaseException`` or a bare
    ``except`` whose body contains NO raise and NO telemetry — telemetry
    being a logging call (``.debug/.info/.warning/.error/.exception/
    .critical/.log/.warn``), a metrics call (``metrics.incr`` or any
    ``.incr``/``.observe``/``.timing``), a ``warnings.warn``, or an event
    ``emit``;
  * a ``raise`` anywhere in the handler body (including nested ifs)
    counts as re-raising;
  * a handler that *references its bound exception* (``except Exception
    as e:`` then ``e`` used — stashed in a result dict, formatted into a
    report, appended to a failure slot that re-raises later) is telling
    someone and is not flagged; the bug class is the exception being
    DISCARDED unused;
  * narrow handlers (``except KeyError:`` etc.) are never flagged —
    catching a *specific* exception silently is a deliberate local
    decision, not the bug class;
  * handlers inside ``tests/`` fixtures are out of scope via the lint
    entry points (tests are not linted), not via this rule.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from ..core import ModuleContext, Rule, dotted_name, terminal_name

_BROAD = {"Exception", "BaseException"}
_LOG_ATTRS = {
    "debug",
    "info",
    "warning",
    "error",
    "exception",
    "critical",
    "log",
    "warn",
}
_METRIC_ATTRS = {"incr", "observe", "timing", "emit"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    if isinstance(t, (ast.Name, ast.Attribute)):
        return (terminal_name(t) or "") in _BROAD
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, (ast.Name, ast.Attribute))
            and (terminal_name(e) or "") in _BROAD
            for e in t.elts
        )
    return False


def _handler_tells_someone(handler: ast.ExceptHandler, ctx: ModuleContext) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _LOG_ATTRS | _METRIC_ATTRS:
                return True
            d = dotted_name(f, ctx.aliases) or ""
            if d == "warnings.warn" or d.endswith(".warn"):
                return True
        if (
            handler.name
            and isinstance(node, ast.Name)
            and node.id == handler.name
            and isinstance(node.ctx, ast.Load)
        ):
            return True  # the exception is used, not discarded
    return False


class SwallowedExceptionRule(Rule):
    code = "HS004"
    name = "silently-swallowed-exception"
    description = (
        "a broad except (Exception/bare) neither re-raises nor emits "
        "telemetry, so the failure silently disables behavior"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node):
                continue
            if _handler_tells_someone(node, ctx):
                continue
            yield (
                node.lineno,
                node.col_offset,
                "broad except swallows the failure silently; log it, count "
                "it (telemetry.metrics), or re-raise — a swallowed error "
                "here silently disables the behavior it guards",
            )
