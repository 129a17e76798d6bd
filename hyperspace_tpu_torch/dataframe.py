"""DataFrame: the user-facing lazy query handle over a logical plan.

``collect()`` runs the rewrite rules (when the session has Hyperspace
enabled) and executes on the session's device. Index usage telemetry is
emitted exactly when a rewrite fired (HyperspaceEvent.scala:150-156).
The reference's predicate-pushdown and column-pruning normalization
passes are not ported: write side filters below the join, as the join
rule needs linear sides.
"""

from __future__ import annotations

from typing import List

from .exceptions import HyperspaceException
from .plan.expr import Expr
from .plan.ir import Filter, Join, LogicalPlan, Project
from .session import HyperspaceSession
from .storage.columnar import ColumnarBatch
from .telemetry import HyperspaceIndexUsageEvent
from .telemetry.logging import EventLogging


class DataFrame(EventLogging):
    def __init__(self, session: HyperspaceSession, plan: LogicalPlan):
        self.session = session
        self.plan = plan

    # -- transformations -----------------------------------------------------
    def filter(self, condition: Expr) -> "DataFrame":
        # Col references resolve to the child schema's canonical case
        from .plan.expr import resolve_expr_columns

        condition = resolve_expr_columns(condition, self.plan.output_columns())
        return DataFrame(self.session, Filter(condition, self.plan))

    where = filter

    def select(self, *columns: str) -> "DataFrame":
        out = self.plan.output_columns()
        lower = {o.lower() for o in out}
        missing = [c for c in columns if c.lower() not in lower]
        if missing:
            raise HyperspaceException(f"Unknown columns: {missing}.")
        resolved = [next(o for o in out if o.lower() == c.lower()) for c in columns]
        return DataFrame(self.session, Project(tuple(resolved), self.plan))

    def join(self, other: "DataFrame", condition: Expr, how: str = "inner") -> "DataFrame":
        if self.session is not other.session:
            raise HyperspaceException("Cannot join DataFrames from different sessions.")
        from .plan.expr import resolve_expr_columns

        condition = resolve_expr_columns(
            condition,
            list(self.plan.output_columns()) + list(other.plan.output_columns()),
        )
        return DataFrame(self.session, Join(self.plan, other.plan, condition, how))

    # -- actions -------------------------------------------------------------
    def optimized_plan(self, log_usage: bool = False) -> LogicalPlan:
        """The plan after the Hyperspace rule batch (identity when
        disabled)."""
        if not self.session.is_hyperspace_enabled():
            return self.plan
        from .actions import states
        from .plan.rules import apply_hyperspace_rules

        indexes = self.session.collection_manager.get_indexes(
            [states.ACTIVE], prefer_stable=True
        )
        new_plan, applied = apply_hyperspace_rules(self.plan, indexes, self.session.conf)
        if applied and log_usage:
            self.log_event(
                self.session.conf,
                HyperspaceIndexUsageEvent(
                    indexes=[e.name for e in applied],
                    plan_before=self.plan.tree_string(),
                    plan_after=new_plan.tree_string(),
                ),
            )
        return new_plan

    def collect(self) -> ColumnarBatch:
        from .exec.executor import Executor

        plan = self.optimized_plan(log_usage=True)
        return Executor(
            self.session.device, self.session.conf.residency()
        ).execute(plan)

    def count(self) -> int:
        return self.collect().num_rows

    def columns(self) -> List[str]:
        return self.plan.output_columns()

    def explain(self) -> str:
        """The logical plan and, with Hyperspace enabled, the plan the
        rules rewrote it to (IndexScan nodes name the indexes used)."""
        lines = ["== Plan ==", self.plan.tree_string()]
        if self.session.is_hyperspace_enabled():
            lines += ["== Plan with Hyperspace ==", self.optimized_plan().tree_string()]
        return "\n".join(lines)
