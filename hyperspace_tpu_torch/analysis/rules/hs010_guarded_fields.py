"""HS010 — inconsistently-guarded field.

The bug class behind the serve-layer review findings: a class
establishes, by repetition, that some ``self._field`` is guarded by a
lock (every write sits inside ``with self._lock:``) — and then one site
reads or writes it lock-free, usually a stats accessor or a hot-path
fast check added later. Under free-threading that is a data race; even
under the GIL it reads torn multi-field state (a count and a histogram
updated under the lock observed mid-update).

Detection (whole-program, documented blind spots):
  * a field is an underscore attribute of a class (``self._x``),
    excluding the lock inventory itself and attributes bound to
    self-synchronizing objects (Event/Queue/Thread — they need no
    external lock);
  * the GUARD is inferred: the lock identity held at the majority of the
    field's write sites; the convention needs at least
    ``MIN_GUARDED_WRITES`` distinct guarded write lines to count
    (one guarded write is coincidence, two is a discipline);
  * a site is GUARDED when the lock is lexically held, when it sits in
    ``__init__`` (construction happens-before publication), when the
    method's name ends with ``_locked`` (the repo convention for
    called-with-lock-held helpers), or when EVERY resolved in-package
    call site of its method holds the guard (transitively — computed as
    a greatest fixpoint over the call graph);
  * remaining lock-free sites are findings. Methods the call graph
    cannot see into (public API called only by tests/users) stay
    conservative: their lock-free accesses are reported, because "the
    caller probably locks" is exactly the assumption this rule exists to
    check — suppress with the justification when a field is
    monotonic/latch-like by design.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List, Set, Tuple

from ..core import ProjectRule

MIN_GUARDED_WRITES = 2


class GuardedFieldRule(ProjectRule):
    code = "HS010"
    name = "inconsistently-guarded-field"
    description = (
        "a field written under one lock at several sites is read or "
        "written lock-free elsewhere in the class (guard inferred from "
        "the write sites; call-graph-aware)"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        emitted: Set[Tuple[str, int, int, str]] = set()
        always_locked_memo: Dict[str, Set[str]] = {}
        for cls in project.classes.values():
            yield from self._check_class(
                project, cls, emitted, always_locked_memo
            )

    def _check_class(
        self, project, cls, emitted, always_locked_memo
    ) -> Iterator[Tuple[str, int, int, str]]:
        family = project.mro(cls)
        methods = {m.qual: m for c in family for m in c.methods.values()}
        # field -> [(access, method)] over the whole mro family: a base
        # class's discipline binds the subclass's accesses and vice versa
        by_field: Dict[str, List[Tuple[object, object]]] = {}
        for m in methods.values():
            for acc in m.accesses:
                if not acc.attr.startswith("_") or acc.attr.startswith("__"):
                    continue
                if project.lock_id_in_mro(cls, acc.attr) is not None:
                    continue
                if project.sync_attr_in_mro(cls, acc.attr):
                    continue
                by_field.setdefault(acc.attr, []).append((acc, m))
        for attr, sites in sorted(by_field.items()):
            writes = [
                (acc, m)
                for acc, m in sites
                if acc.write and m.name != "__init__"
            ]
            guard_votes = Counter(
                lock for acc, _m in writes for lock in acc.held
            )
            if not guard_votes:
                continue
            guard, _n = guard_votes.most_common(1)[0]
            guarded_lines = {
                acc.line for acc, _m in writes if guard in acc.held
            }
            if len(guarded_lines) < MIN_GUARDED_WRITES:
                continue
            always = always_locked_memo.get(guard)
            if always is None:
                always = _always_called_with(project, guard)
                always_locked_memo[guard] = always
            for acc, m in sites:
                if guard in acc.held:
                    continue
                if m.name == "__init__" or m.name.endswith("_locked"):
                    continue
                if m.qual in always:
                    continue
                kind = "written" if acc.write else "read"
                key = (m.path, acc.line, acc.col, attr)
                if key in emitted:
                    continue
                emitted.add(key)
                yield (
                    m.path,
                    acc.line,
                    acc.col,
                    f"field '{attr}' of {cls.module}:{cls.name} is "
                    f"written under '{guard}' at "
                    f"{len(guarded_lines)} sites but {kind} lock-free "
                    f"here ({m.qual}); take the lock (or justify-and-"
                    "suppress a deliberate latch/monotonic read)",
                )


def _always_called_with(project, lock: str) -> Set[str]:
    """Functions whose EVERY resolved in-package call site holds ``lock``
    — lexically, or from a caller already proven guarded. LEAST fixpoint
    grown from lexically lock-held sites: a mutually-recursive cycle
    whose only callers are each other never enters the set (a greatest
    fixpoint would admit such self-supporting cycles and hide their
    lock-free accesses). Functions with no resolved callers stay out:
    unseen callers cannot be assumed to lock."""
    callers = project.callers_of()
    guarded: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for q in project.functions:
            if q in guarded:
                continue
            sites = callers.get(q)
            if not sites:
                continue
            if all(
                lock in site.held or caller.qual in guarded
                for caller, site in sites
            ):
                guarded.add(q)
                changed = True
    return guarded
