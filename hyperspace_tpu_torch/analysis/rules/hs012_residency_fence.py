"""HS012 — residency cache registry mutated outside the lock/epoch
discipline.

Review findings of the residency layer, generalized into a rule. The
residency caches (hbm_cache / mesh_cache and their delta/join regions)
have a hard-won discipline:

  1. every mutation of the registry state — ``_tables`` / ``_deltas`` /
     ``_joins``, the ``_pending`` / ``_failed`` memos, ``_join_version``
     and ``_epoch`` — happens under the cache's ``_lock`` (budget math
     reads the same fields in the same regions);
  2. every REGISTRATION (an ``append`` onto a registry list) is guarded
     against staleness: the populate path captures the epoch before its
     slow work and compares it against ``self._epoch`` before
     registering (or waits for the upload with ``ops.fence`` /
     ``torch.cuda.synchronize`` / a stream's or event's
     ``synchronize()`` first, on paths where the fence subsumes the
     race) — otherwise a background populate scheduled before ``reset()``
     registers a dead-device region into the fresh registry.

Detection (whole-program, documented blind spots):
  * a RESIDENCY CACHE CLASS is any class whose MRO owns a ``_lock`` in
    the lock inventory AND writes a ``self._epoch`` field — structural,
    so fixtures and future caches are covered without a name list; a
    whole-plan compile cache (compile.cache.PipelineCache /
    compile.result_cache.ResultCache) opts into the same scope by
    carrying an ``_epoch`` — the port's two carry none, so they stay
    out of it;
  * registry fields are matched by name:
    ``_tables/_deltas/_joins/_pending/_failed/_join_version/_epoch``,
    ``_budget*``, and the compile-cache registries
    ``_pipelines``/``_results``;
  * check 1 fires on any write/mutating call on a registry field with
    the cache's ``_lock`` not lexically held (``__init__`` excluded —
    construction precedes sharing; ``*_locked`` helper methods excluded
    by the repo convention, their callers hold the lock);
  * check 2 fires on a registration ``append`` whose enclosing function
    neither compares ``self._epoch`` (or calls ``current_epoch``) nor
    calls a fence (``fence``, or any ``synchronize``, by terminal
    name) — flow-insensitive: the guard anywhere in the
    function satisfies it, its ordering relative to the append is NOT
    checked.

The messages are the reference rule's word for word, so both analyzers
report one finding alike; the ``fence_chain`` they name is ``ops.fence``
in this package.
"""

from __future__ import annotations

import re
from typing import Iterator, Set, Tuple

from ..core import ProjectRule

_REGISTRY_FIELD_RE = re.compile(
    r"^_(tables|deltas|joins|pending|failed|join_version|epoch|budget\w*"
    r"|pipelines|results)$"
)
_REGISTRATION_LISTS = {"_tables", "_deltas", "_joins"}


class ResidencyFenceRule(ProjectRule):
    code = "HS012"
    name = "unfenced-residency-mutation"
    description = (
        "a residency cache registry/epoch/budget field is mutated "
        "outside the cache lock, or a region is registered without an "
        "epoch guard / fence"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        emitted: Set[Tuple[str, int, int]] = set()
        for cls in project.classes.values():
            lock = project.lock_id_in_mro(cls, "_lock")
            if lock is None:
                continue
            family = project.mro(cls)
            methods = [m for c in family for m in c.methods.values()]
            if not any(
                acc.attr == "_epoch" and acc.write
                for m in methods
                for acc in m.accesses
            ):
                continue  # a lock-owning class, but not a residency cache
            for m in methods:
                if m.name == "__init__" or m.name.endswith("_locked"):
                    continue
                for acc in m.accesses:
                    if not _REGISTRY_FIELD_RE.match(acc.attr):
                        continue
                    if acc.write and lock not in acc.held:
                        key = (m.path, acc.line, acc.col)
                        if key not in emitted:
                            emitted.add(key)
                            yield (
                                m.path,
                                acc.line,
                                acc.col,
                                f"residency registry field '{acc.attr}' "
                                f"mutated outside '{lock}' in {m.qual}; "
                                "every registry/epoch/budget mutation "
                                "takes the cache lock",
                            )
                    if (
                        acc.mutcall == "append"
                        and acc.attr in _REGISTRATION_LISTS
                        and not (m.epoch_guard or m.fence_call)
                    ):
                        key = (m.path, acc.line, acc.col)
                        if key not in emitted:
                            emitted.add(key)
                            yield (
                                m.path,
                                acc.line,
                                acc.col,
                                f"registration onto '{acc.attr}' in "
                                f"{m.qual} with no epoch guard or fence: "
                                "a populate scheduled before reset() can "
                                "register a stale region — capture the "
                                "epoch before the slow work and compare "
                                "against self._epoch (or fence_chain the "
                                "upload) before appending",
                            )
