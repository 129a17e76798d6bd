"""Distributed execution above the bucket mesh.

Counterpart of ``hyperspace_tpu.distributed`` (its single-controller
part):

* ``planner`` — the movement decision of a bucketed join (direct /
  shuffle the smaller side / host), memoized per placement and
  bucket-histogram class, recorded as a ``shuffle.plan`` span that
  explain(verbose) renders;
* ``shuffle`` — the one-round all_to_all repartition that lets two
  indexes built with different bucket counts join on the mesh.

Imports stay lazy. The multi-controller tier (router, fabric, health) is
not part of this package yet.
"""

from __future__ import annotations

__all__ = [
    "MovementDecision",
    "plan_movement",
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
    raise AttributeError(name)
