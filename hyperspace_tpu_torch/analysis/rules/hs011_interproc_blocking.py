"""HS011 — blocking work transitively reached while a lock is held.

HS002 catches ``time.sleep`` under ``with lock:`` in the SAME function —
but the seed bug class routinely hides one call deep: a lock region
calls a tidy helper, and the helper does the IO. With the serve worker
pool, lease heartbeats, residency population, and the build pipeline all
sharing locks, a blocking call one hop away turns a bounded critical
section into a convoy (or, against the device, serializes every thread
behind one dispatch).

Detection (whole-program, documented blind spots):
  * BLOCKING ENDPOINTS are the HS002 set (sleep / subprocess / network /
    file IO / thread join / event wait) plus ``<queue-ish>.put/get``
    (bounded queues block on full/empty) and device dispatch under a
    host lock: a resolved ``torch.*`` call outside HS007's host-only
    list, or a call to one of ``ops/kernels.py``'s launching wrappers
    (the project model's ``_blocking_endpoint`` gives the matching);
  * for every function the transitive endpoint set is computed over the
    resolved call graph (fixpoint); a finding fires at a CALL SITE made
    while a lock is held (resolved into the lock inventory) whose callee
    transitively reaches an endpoint;
  * only INTERPROCEDURAL reach is reported — a direct blocking call
    under a lock is HS002's finding, not a duplicate here;
  * flow-insensitive: an endpoint on a branch the locked caller can
    never take still counts (suppress with the justification naming the
    branch condition);
  * unresolved callees contribute nothing — a blocking helper reached
    through a callback or an un-typed receiver is invisible (HS002's
    lexical pass is the backstop).
"""

from __future__ import annotations

from typing import Iterator, Tuple

from ..core import ProjectRule


class InterprocBlockingRule(ProjectRule):
    code = "HS011"
    name = "interprocedural-blocking-under-lock"
    description = (
        "a call made while holding a lock transitively reaches a "
        "blocking endpoint (IO/sleep/join/queue/device dispatch) "
        "through the resolved call graph"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        blocking = project.closure("blocking")
        for f in project.functions.values():
            for site in f.calls:
                if not site.held or site.callee is None:
                    continue
                reach = blocking.get(site.callee)
                if not reach:
                    continue
                # deepest-lock message reads best; every held lock is
                # equally convoyed
                lock = site.held[-1]
                desc, via = sorted(reach, key=lambda it: (it[0], it[1] or ""))[0]
                chain = (
                    f" (via {via})"
                    if via is not None and via != site.callee
                    else ""
                )
                yield (
                    f.path,
                    site.line,
                    site.col,
                    f"call to '{site.callee}' while holding '{lock}' "
                    f"transitively reaches blocking {desc}{chain}; "
                    "restructure so the lock is released before the "
                    "blocking work (snapshot under the lock, act after)",
                )
