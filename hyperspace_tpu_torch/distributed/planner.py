"""Shuffle planner: how rows move between shards for one bucketed join.

Counterpart of ``hyperspace_tpu.distributed.planner``. Given the
per-bucket row counts of the two sides it picks one of three paths:

* ``direct``  — the sides are co-partitioned (equal ``num_buckets`` under
  the shared ``owner_of_bucket`` placement, parallel/mesh.py): no
  movement, the shuffle-free join serves as it is;
* ``shuffle`` — the sides disagree on bucket count: the SMALLER side is
  repartitioned into the larger side's bucket space over one all_to_all
  round (distributed/shuffle.py), then the co-partitioned arms serve;
* ``host``    — movement cannot pay (tiny inputs, an empty side) or there
  is no mesh: the exact join answers.

Decisions are memoized per (placement, bucket-histogram class): the
placement is (left num_buckets, right num_buckets, shards) and the class
quantizes each side's total and largest-bucket row count to powers of
two, so repeat joins over similarly shaped data reuse the decision. Each
decision is counted (``shuffle.plan.<path>``, ``shuffle.plan.memo_hit``)
and recorded on the active query trace as a ``shuffle.plan`` span, which
explain(verbose) renders as the movement-plan table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..parallel.mesh import owner_of_bucket
from ..telemetry.metrics import metrics
from ..telemetry.trace import span

__all__ = ["MovementDecision", "plan_movement", "reset_plan_memo"]


@dataclass(frozen=True)
class MovementDecision:
    """One join's movement plan. ``path`` is direct | shuffle | host;
    ``moved_side`` names the side the shuffle repartitions (None unless
    path == shuffle); ``est_moved_bytes`` is the transport estimate the
    decision weighed (moved rows x planes x 8)."""

    path: str
    reason: str
    moved_side: Optional[str] = None
    target_num_buckets: int = 0
    est_moved_bytes: int = 0
    memo_hit: bool = False


# decisions per (placement, histogram class), bounded as every
# cross-query memo is
_PLAN_MEMO: Dict[tuple, MovementDecision] = {}
_PLAN_MEMO_CAP = 256


def reset_plan_memo() -> None:
    _PLAN_MEMO.clear()


def _pow2_class(n: int) -> int:
    """log2 class of a row count: the histogram-class quantizer."""
    return max(int(n).bit_length(), 0)


def _histogram_class(counts: Dict[int, int]) -> tuple:
    total = sum(counts.values())
    peak = max(counts.values(), default=0)
    return (_pow2_class(total), _pow2_class(peak))


def _record(decision: MovementDecision, l_rows: int, r_rows: int,
            l_nb: int, r_nb: int, n_devices: int) -> MovementDecision:
    """Count the decision and freeze it on the active trace: the one
    record explain(verbose)'s movement-plan section renders from."""
    metrics.incr(f"shuffle.plan.{decision.path}")
    if decision.memo_hit:
        metrics.incr("shuffle.plan.memo_hit")
    with span(
        "shuffle.plan",
        decision=decision.path,
        reason=decision.reason,
        moved_side=decision.moved_side or "-",
        left_buckets=l_nb,
        right_buckets=r_nb,
        left_rows=l_rows,
        right_rows=r_rows,
        devices=n_devices,
        est_moved_bytes=decision.est_moved_bytes,
        memo_hit=decision.memo_hit,
    ):
        pass
    return decision


def plan_movement(
    l_counts: Dict[int, int],
    r_counts: Dict[int, int],
    l_num_buckets: int,
    r_num_buckets: int,
    n_devices: int,
    min_shuffle_rows: int,
    n_payload_planes: int = 2,
) -> MovementDecision:
    """Choose direct / shuffle / host for one bucketed join.

    ``l_counts``/``r_counts`` are the loaded sides' per-bucket row counts;
    ``min_shuffle_rows`` is the executor's distributed floor (below it the
    exchange's fixed cost cannot pay, the ``dist_min_rows`` gate);
    ``n_payload_planes`` is the moved side's column count."""
    # the placement rule through its one shared helper, so a change of
    # placement reroutes the planner too
    assert owner_of_bucket(0, n_devices) == 0
    l_rows = sum(l_counts.values())
    r_rows = sum(r_counts.values())

    def done(d: MovementDecision) -> MovementDecision:
        return _record(d, l_rows, r_rows, l_num_buckets, r_num_buckets, n_devices)

    if l_num_buckets == r_num_buckets:
        return done(MovementDecision("direct", "co_partitioned"))
    if n_devices <= 1:
        return done(MovementDecision("host", "no_mesh"))
    if l_rows == 0 or r_rows == 0:
        return done(MovementDecision("host", "empty_side"))

    key = (
        l_num_buckets,
        r_num_buckets,
        n_devices,
        min_shuffle_rows,
        n_payload_planes,
        _histogram_class(l_counts),
        _histogram_class(r_counts),
    )
    hit = _PLAN_MEMO.get(key)
    if hit is not None:
        return done(MovementDecision(
            hit.path, hit.reason, hit.moved_side, hit.target_num_buckets,
            hit.est_moved_bytes, memo_hit=True,
        ))

    moved_side = "left" if l_rows <= r_rows else "right"
    moved_rows = min(l_rows, r_rows)
    target_nb = r_num_buckets if moved_side == "left" else l_num_buckets
    est_bytes = moved_rows * n_payload_planes * 8
    if l_rows + r_rows < min_shuffle_rows:
        decision = MovementDecision("host", "below_min_rows", None, 0, est_bytes)
    else:
        decision = MovementDecision(
            "shuffle", f"repartition_{moved_side}", moved_side, target_nb, est_bytes,
        )
    if len(_PLAN_MEMO) >= _PLAN_MEMO_CAP:
        _PLAN_MEMO.pop(next(iter(_PLAN_MEMO)))
    _PLAN_MEMO[key] = decision
    return done(decision)
