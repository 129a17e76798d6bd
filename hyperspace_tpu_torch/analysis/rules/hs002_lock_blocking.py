"""HS002 — lock held across a blocking call.

The bug class: the device probe once held its first-touch lock
across a 120 s watchdog join, so a second thread's first touch blocked
uninterruptibly on the mutex with no way to honor its own timeout. A
tensor-runtime query engine runs union sides and prefetch stages on
threads; one lock held across IO turns a bounded stall into a convoy.

Detection (intra-procedural, documented blind spots):
  * a lock region is a ``with <lock>:`` body, or the statements between
    ``<lock>.acquire()`` and ``<lock>.release()`` in the same statement
    list, where the lock expression's terminal identifier ends with
    ``lock`` or ``mutex`` (case-insensitive);
  * blocking calls: ``time.sleep``; ``subprocess.*``; ``socket.*`` /
    ``requests.*`` / ``urllib.*`` / ``http.client.*``; builtin ``open``;
    ``Path.read_text/read_bytes/write_text/write_bytes`` (and ``.stat``
    is deliberately NOT flagged — it is sub-microsecond); ``.communicate``;
    ``.join(...)`` on a receiver bound from ``threading.Thread(...)`` or
    whose name looks thread-like; ``.wait(...)`` on an event/future/
    process-like receiver.
  * nested ``def``/``lambda`` bodies inside a lock region are skipped —
    they execute later, not under the lock;
  * calls INTO helper functions that block are not followed
    (intra-procedural only).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import ModuleContext, Rule, dotted_name, terminal_name

_LOCKISH_RE = re.compile(r"(lock|mutex)$", re.I)
_THREADISH_RE = re.compile(r"thread|worker|watchdog|proc", re.I)
_WAITISH_RE = re.compile(r"event|done|fut|proc|child|barrier|latch", re.I)
_BLOCKING_PREFIXES = (
    "subprocess.",
    "requests.",
    "urllib.",
    "socket.",
    "http.client.",
)
_FILE_IO_ATTRS = {
    "read_text",
    "read_bytes",
    "write_text",
    "write_bytes",
    "communicate",
}


def _lock_name(expr: ast.AST) -> Optional[str]:
    t = terminal_name(expr)
    if t and _LOCKISH_RE.search(t):
        return t
    return None


def blocking_reason(
    call: ast.Call, aliases: Dict[str, str], thread_vars: Set[str]
) -> Optional[str]:
    """Why ``call`` is a DIRECT blocking call, or None. The shared
    detector: HS002 applies it lexically inside one function's lock
    regions; a whole-program pass can apply it to every function to
    follow blocking reachability through the call graph."""
    d = dotted_name(call.func, aliases)
    if d:
        if d == "time.sleep" or d == "open":
            return f"'{d}'"
        if d.startswith(_BLOCKING_PREFIXES):
            return f"'{d}'"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        recv = call.func.value
        recv_name = terminal_name(recv)
        if attr in _FILE_IO_ATTRS:
            return f"'.{attr}()'"
        if attr == "join":
            if (recv_name and recv_name in thread_vars) or (
                recv_name and _THREADISH_RE.search(recv_name)
            ):
                return f"'{recv_name}.join()'"
        if attr == "wait":
            if (recv_name and recv_name in thread_vars) or (
                recv_name and _WAITISH_RE.search(recv_name)
            ):
                return f"'{recv_name}.wait()'"
    return None


class LockBlockingRule(Rule):
    code = "HS002"
    name = "lock-held-across-blocking-call"
    description = (
        "a blocking call (join/sleep/wait/subprocess/file or network IO) "
        "runs while a lock is held"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        findings: List[Tuple[int, int, str]] = []
        for scope in self._scopes(ctx.tree):
            thread_vars = self._thread_vars(scope, ctx)
            self._scan_body(
                getattr(scope, "body", []), [], ctx, thread_vars, findings
            )
        seen: Set[Tuple[int, int, str]] = set()
        for f in findings:
            if f not in seen:
                seen.add(f)
                yield f

    # -- scope discovery -----------------------------------------------------
    def _scopes(self, tree: ast.AST):
        yield tree  # module top level
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def _thread_vars(self, scope: ast.AST, ctx: ModuleContext) -> Set[str]:
        """Names bound (anywhere in the scope) from Thread(...)/Popen(...)
        construction — their .join()/.wait() is the thread kind, not
        str.join."""
        out: Set[str] = set()
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                d = dotted_name(node.value.func, ctx.aliases) or ""
                if d.endswith("Thread") or d.endswith("Popen") or d.endswith("Process"):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            out.add(t.id)
        return out

    # -- lock-region tracking ------------------------------------------------
    def _scan_body(
        self,
        stmts: List[ast.stmt],
        held: List[str],
        ctx: ModuleContext,
        thread_vars: Set[str],
        findings: List[Tuple[int, int, str]],
    ) -> None:
        held = list(held)
        for st in stmts:
            # acquire()/release() toggling within this statement list
            if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
                f = st.value.func
                if isinstance(f, ast.Attribute) and f.attr == "acquire":
                    ln = _lock_name(f.value)
                    if ln:
                        held.append(ln)
                        continue
                if isinstance(f, ast.Attribute) and f.attr == "release":
                    ln = _lock_name(f.value)
                    if ln and ln in held:
                        held.remove(ln)
                        continue
            if isinstance(st, ast.With):
                new_held = list(held)
                for item in st.items:
                    ln = _lock_name(item.context_expr)
                    if ln:
                        new_held.append(ln)
                if held:  # the with-item expressions run under outer locks
                    for item in st.items:
                        self._check_expr(
                            item.context_expr, held, ctx, thread_vars, findings
                        )
                self._scan_body(st.body, new_held, ctx, thread_vars, findings)
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested def runs later, not under this lock
            if isinstance(st, (ast.For, ast.AsyncFor)):
                if held:
                    self._check_expr(st.iter, held, ctx, thread_vars, findings)
                self._scan_body(st.body, held, ctx, thread_vars, findings)
                self._scan_body(st.orelse, held, ctx, thread_vars, findings)
                continue
            if isinstance(st, ast.While):
                if held:
                    self._check_expr(st.test, held, ctx, thread_vars, findings)
                self._scan_body(st.body, held, ctx, thread_vars, findings)
                self._scan_body(st.orelse, held, ctx, thread_vars, findings)
                continue
            if isinstance(st, ast.If):
                if held:
                    self._check_expr(st.test, held, ctx, thread_vars, findings)
                self._scan_body(st.body, held, ctx, thread_vars, findings)
                self._scan_body(st.orelse, held, ctx, thread_vars, findings)
                continue
            if isinstance(st, ast.Try):
                self._scan_body(st.body, held, ctx, thread_vars, findings)
                for h in st.handlers:
                    self._scan_body(h.body, held, ctx, thread_vars, findings)
                self._scan_body(st.orelse, held, ctx, thread_vars, findings)
                self._scan_body(st.finalbody, held, ctx, thread_vars, findings)
                continue
            if held:
                self._check_expr(st, held, ctx, thread_vars, findings)

    def _check_expr(
        self,
        node: ast.AST,
        held: List[str],
        ctx: ModuleContext,
        thread_vars: Set[str],
        findings: List[Tuple[int, int, str]],
    ) -> None:
        stack: List[ast.AST] = [node]
        while stack:
            sub = stack.pop()
            for child in ast.iter_child_nodes(sub):
                # deferred bodies (nested def/lambda) execute after the
                # lock region, so their calls are pruned from the walk
                if not isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    stack.append(child)
            if isinstance(sub, ast.Call):
                why = self._blocking(sub, ctx, thread_vars)
                if why:
                    findings.append(
                        (
                            sub.lineno,
                            sub.col_offset,
                            f"blocking call {why} while holding lock "
                            f"'{held[-1]}'; restructure so the lock is "
                            "released first (e.g. latch via threading.Event)",
                        )
                    )

    def _blocking(
        self, call: ast.Call, ctx: ModuleContext, thread_vars: Set[str]
    ) -> Optional[str]:
        return blocking_reason(call, ctx.aliases, thread_vars)
