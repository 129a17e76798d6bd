"""Distributed execution above the bucket mesh.

Counterpart of ``hyperspace_tpu.distributed``:

* ``shuffle`` — the one-round all_to_all repartition that lets two
  indexes built with different bucket counts join on the mesh;
* ``planner`` — the movement decision of a bucketed join (direct /
  shuffle the smaller side / host), memoized per placement and
  bucket-histogram class, recorded as a ``shuffle.plan`` span that
  explain(verbose) renders;
* ``fabric`` — ``QueryFabric``, one process's handle on a job of several
  processes: the ``torch.distributed`` group, the global mesh, bucket to
  process placement, the multi-process build;
* ``router`` — ``QueryRouter``, the serve front that fans one logical
  query out over per-host servers and merges their partials;
* ``health`` — the per-host failure lifecycle (healthy, suspect, dead,
  probation, readmitted) the router dispatches, hedges and fails over
  against.

Imports stay lazy.
"""

from __future__ import annotations

__all__ = [
    "HealthDirector",
    "HealthPolicy",
    "MovementDecision",
    "plan_movement",
    "QueryFabric",
    "QueryRouter",
    "RouterTicket",
    "repartition_by_bucket",
    "try_shuffle_join",
]


def __getattr__(name):
    if name in ("MovementDecision", "plan_movement"):
        from . import planner

        return getattr(planner, name)
    if name in ("repartition_by_bucket", "try_shuffle_join"):
        from . import shuffle

        return getattr(shuffle, name)
    if name in ("QueryRouter", "RouterTicket"):
        from . import router

        return getattr(router, name)
    if name in ("HealthDirector", "HealthPolicy"):
        from . import health

        return getattr(health, name)
    if name == "QueryFabric":
        from .fabric import QueryFabric

        return QueryFabric
    raise AttributeError(name)
