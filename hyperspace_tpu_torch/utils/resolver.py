"""Case-(in)sensitive column-name resolution.

Parity: com/microsoft/hyperspace/util/ResolverUtils.scala:25-73. The
reference delegates to Spark's session ``Resolver``; SURVEY.md §7 flags this
as a correctness trap ("Plan-rewrite correctness without Catalyst's
resolver"), so resolution is centralized here and used by every rule and
action that touches user-supplied column names.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence


def resolve(
    required: str, available: Sequence[str], case_sensitive: bool = False
) -> Optional[str]:
    """Return the *available* spelling matching ``required``, or None.

    Mirrors ResolverUtils.resolve: the canonical (stored) spelling is the one
    from ``available`` — e.g. a user asking for ``Query`` against a schema
    column ``query`` resolves to ``query`` (CreateActionBase.scala:142-162).
    """
    if case_sensitive:
        return required if required in available else None
    low = required.lower()
    for a in available:
        if a.lower() == low:
            return a
    return None


def resolve_all(
    required: Iterable[str], available: Sequence[str], case_sensitive: bool = False
) -> Optional[List[str]]:
    """Resolve every name or return None if any fails
    (ResolverUtils.scala:49-73)."""
    out: List[str] = []
    for r in required:
        m = resolve(r, available, case_sensitive)
        if m is None:
            return None
        out.append(m)
    return out
