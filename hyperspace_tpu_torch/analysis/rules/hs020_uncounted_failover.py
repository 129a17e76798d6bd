"""HS020 — failover/degradation branch with no degrade counter.

The serving tier's failure-domain story rests on one invariant: every
branch that absorbs a failure — a dead host's ``ServerClosed``, a
survivor's ``AdmissionRejected``, a timed-out leg — must leave
EVIDENCE in the metrics registry, because a router that silently eats
failures looks healthy right up until the burst that kills it. This
extends HS018's uncounted-tail analysis from early ``return None``
declines to exception-absorbing failover branches, scoped to the
modules that own the degradation ladder (``distributed/`` and
``serve/``).

A finding is an ``except`` handler that (a) names a FAILURE exception
(ServerClosed, AdmissionRejected, DeadlineExceeded, TimeoutError,
InjectedCrash, TransientStorageError, ConnectionError), (b) does not
re-raise — a propagated failure is loud by itself — and (c) reaches no
degrade-evidence counter, neither lexically nor through a callee that
(transitively) counts one (``DeviceFlow.degrade_reach`` — the
helper-counts-for-me pattern, same closure discipline as HS018).
Bare ``except``/``except Exception`` handlers are out of scope here
(HS004 polices swallowing in general); HS020 is specifically about the
branches that CHOSE to absorb a known failure mode.

The reference rule as written: it names no device, and the port raises
the same exception names."""

from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from ..core import ProjectRule, terminal_name
from ..dataflow import DEGRADE_NEEDLES, _str_contains

# the failure modes the degradation ladder absorbs on purpose — a
# handler naming one of these IS a failover/degradation branch
FAILURE_EXCEPTIONS = frozenset(
    {
        "ServerClosed",
        "AdmissionRejected",
        "DeadlineExceeded",
        "TimeoutError",
        "InjectedCrash",
        "TransientStorageError",
        "ConnectionError",
        "BrokenPipeError",
    }
)

# directory names owning the distributed degradation ladder
_SCOPED_DIRS = ("distributed", "serve")


def _handler_names(h: ast.ExceptHandler) -> List[str]:
    t = h.type
    if t is None:
        return []
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for e in elts:
        name = terminal_name(e)
        if name:
            out.append(name)
    return out


def _is_degrade_incr(call: ast.Call) -> bool:
    # the same literal matcher the flow pass uses for degrade_incr, so
    # lexical counting here and reach-based counting there agree
    if terminal_name(call.func) not in ("incr", "counter") or not call.args:
        return False
    return any(_str_contains(call.args[0], n) for n in DEGRADE_NEEDLES)


def _in_scope(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return any(d in parts for d in _SCOPED_DIRS)


class UncountedFailoverRule(ProjectRule):
    code = "HS020"
    name = "uncounted-failover"
    description = (
        "a failover/degradation branch in distributed/ or serve/ absorbs "
        "a failure exception without bumping a degrade/decline counter — "
        "silent failure absorption the failure-domain discipline bans"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        flow = project.device_flow()
        reach = flow.degrade_reach()
        for qual in sorted(project.functions):
            f = project.functions[qual]
            if not _in_scope(f.path):
                continue
            node = getattr(f, "_node", None)
            if node is None:
                continue
            callmap = {
                (s.line, s.col): s.callee
                for s in f.calls
                if s.callee is not None
            }

            def counted_or_loud(h: ast.ExceptHandler) -> bool:
                for st in h.body:
                    for sub in ast.walk(st):
                        if isinstance(sub, ast.Raise):
                            return True  # propagates: loud by itself
                        if not isinstance(sub, ast.Call):
                            continue
                        if _is_degrade_incr(sub):
                            return True
                        callee = callmap.get((sub.lineno, sub.col_offset))
                        if callee is not None and callee in reach:
                            return True
                return False

            for sub in ast.walk(node):
                if not isinstance(sub, ast.ExceptHandler):
                    continue
                caught = [
                    n for n in _handler_names(sub) if n in FAILURE_EXCEPTIONS
                ]
                if not caught:
                    continue
                if counted_or_loud(sub):
                    continue
                yield (
                    f.path,
                    sub.lineno,
                    sub.col_offset,
                    f"{f.name}() absorbs {'/'.join(sorted(set(caught)))} "
                    "without bumping a degrade counter — count the "
                    "failover (metrics.incr of a lost/retried/hedge/… "
                    "metric, directly or via a counting helper) or "
                    "re-raise",
                )
