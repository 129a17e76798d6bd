"""DataFrame: the user-facing lazy query handle over a logical plan.

``collect()`` runs the normalization passes (predicate pushdown through
joins, then column pruning) and, when the session has Hyperspace enabled,
the rewrite rules, and executes on the session's device. Index usage
telemetry is emitted exactly when a rewrite fired
(HyperspaceEvent.scala:150-156).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List

import numpy as np

from .exceptions import HyperspaceException
from .plan.expr import Expr
from .plan.ir import Filter, Join, LogicalPlan, Project
from .session import HyperspaceSession
from .storage.columnar import ColumnarBatch
from .telemetry import HyperspaceIndexUsageEvent
from .telemetry.logging import EventLogging


@contextmanager
def _query_profile(profile_dir, device):
    """Run the enclosed query execution under ``torch.profiler`` when
    ``profile_dir`` is set, and write its Chrome trace there as
    ``query-<ns>-<pid>.pt.trace.json``: CPU activity always, CUDA activity
    (the kernels, named by the launches' ``record_function`` ranges and by
    the device functions) on a CUDA ``device``. A CUDA session whose torch
    cannot record CUDA activity raises rather than trace the CPU alone, and
    a trace that holds more kernel launches than kernel records on the
    device (the profiler drops a record whose card timestamp falls outside
    its window, as where the host's and the card's clocks disagree) warns
    and counts ``trace.profile.device_records_missing``. One profiler runs
    in a process at a time, so concurrent profiled queries are not
    supported."""
    if not profile_dir:
        yield None
        return
    import os
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    on_cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise HyperspaceException(
                f"conf hyperspace.tpu.profile.dir is set on a {device} session, but this "
                "torch cannot record CUDA activity; unset it or use a build with CUPTI."
            )
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_cuda:
            # CUPTI hands over a kernel's record only once it is complete,
            # and leaves waiting for the device to the caller
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"query-{time.time_ns()}-{os.getpid()}.pt.trace.json"))
    if on_cuda and kernel_records_missing(prof.events()):
        import warnings

        from .telemetry.metrics import metrics

        metrics.incr("trace.profile.device_records_missing")
        warnings.warn(
            "the query's profile holds more CUDA kernel launches than kernel records on "
            "the device: the profiler dropped records as outside its window (the card's "
            "timestamps disagree with the host's)", RuntimeWarning, stacklevel=3)


_LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                           "cuLaunchKernelEx"})


def kernel_records_missing(events) -> bool:
    """True when profiled ``events`` (``torch.profiler``'s) hold more CUDA
    kernel launches on the host than kernel records on the device (each
    launch has one; copies and memsets on the device are not kernels)."""
    from torch.autograd import DeviceType

    launches = sum(1 for e in events if e.name in _LAUNCH_CALLS)
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    return kernels < launches


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

    def create_or_replace_temp_view(self, name: str) -> None:
        """Register this DataFrame's logical plan under ``name``
        (Spark's createOrReplaceTempView): ``session.table(name)``
        queries rewrite against indexes exactly like this DataFrame."""
        self.session.catalog.create_or_replace_temp_view(name, self)

    def group_by(self, *columns: str) -> "GroupedData":
        """Hash-aggregate entry point: ``df.group_by("k").agg(agg_sum("v"))``
        (specs from plan.aggregates). No columns = global aggregate."""
        from .utils import resolver

        out = self.plan.output_columns()
        resolved = []
        for c in columns:
            match = resolver.resolve(c, out)
            if match is None:
                raise HyperspaceException(f"Unknown group-by column: {c}.")
            resolved.append(match)
        return GroupedData(self, tuple(resolved))

    groupBy = group_by

    # -- actions -------------------------------------------------------------
    def normalized_plan(self) -> LogicalPlan:
        """The plan after the normalization passes that run before the
        Hyperspace rules see it, as Catalyst's do: side predicates move
        through inner joins (so filtered-join shapes stay linear for the
        index rules), then column pruning narrows every join side."""
        from .plan.rules.column_pruning import prune_columns
        from .plan.rules.predicate_pushdown import push_filters_through_joins

        return prune_columns(push_filters_through_joins(self.plan))

    def optimized_plan(self, log_usage: bool = False) -> LogicalPlan:
        """The plan after the normalization passes and the Hyperspace rule
        batch (the passes alone when disabled). Usage telemetry is emitted
        only from executed queries (``log_usage=True``, set by collect())
        — one event per execution, as in HyperspaceEvent.scala:150-156."""
        pruned = self.normalized_plan()
        if not self.session.is_hyperspace_enabled():
            return pruned
        from .actions import states
        from .plan.rules import apply_hyperspace_rules

        indexes = self.session.collection_manager.get_indexes(
            [states.ACTIVE], prefer_stable=True
        )
        new_plan, applied = apply_hyperspace_rules(pruned, indexes, self.session.conf)
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
        """Optimize and execute, under a per-query trace (conf
        ``hyperspace.telemetry.tracing``): the plan and execute stages as
        spans, the query's scoped metrics and its compiled pipeline on the
        trace's meta (what ``session.last_trace`` and explain(verbose)
        read), the finished trace rung into the flight recorder. With conf
        ``hyperspace.tpu.profile.dir`` set, the execution also runs under
        ``torch.profiler`` and its Chrome trace lands in that directory
        (``_query_profile``)."""
        import contextlib

        from .exec.executor import Executor
        from .telemetry.metrics import metrics
        from .telemetry.recorder import flight_recorder
        from .telemetry.trace import span, start_trace

        conf = self.session.conf
        executor = Executor(self.session.device, conf.residency(), conf, mesh=self.session.mesh)
        tracing = conf.telemetry_tracing_enabled()
        with (start_trace("query.collect") if tracing else contextlib.nullcontext()) as qtrace:
            try:
                with span("plan.optimize"):
                    plan = self.optimized_plan(log_usage=True)
                with (_query_profile(conf.profile_dir(), self.session.device),
                      metrics.scoped() as query_metrics, span("query.execute")):
                    result = executor.execute(plan)
            except BaseException as e:
                # a failed query's trace is the one a post-mortem needs
                if qtrace is not None:
                    qtrace.finish(e)
                    flight_recorder.record(qtrace)
                raise
        if qtrace is not None:
            qtrace.meta["metrics"] = query_metrics.report()
            pipeline = executor.last_pipeline
            qtrace.meta["pipeline"] = pipeline.describe() if pipeline is not None else None
            qtrace.finish()
            self.session.last_trace = qtrace
            flight_recorder.record(qtrace)
        else:
            # tracing off: no attribution rather than a previous query's
            self.session.last_trace = None
        return result

    def to_pandas(self):
        """The collected rows as a pandas DataFrame (needs ``pandas``,
        imported only here)."""
        return self.collect().to_pandas()

    def show(self, n: int = 20) -> None:
        """Print the first ``n`` rows (the df.show() notebook idiom). Only
        the shown rows are converted to pandas."""
        batch = self.collect()
        head = batch.take(np.arange(min(n, batch.num_rows)))
        print(head.to_pandas().to_string(index=False))
        if batch.num_rows > n:
            print(f"... ({batch.num_rows - n} more rows)")

    def count(self) -> int:
        return self.collect().num_rows

    def columns(self) -> List[str]:
        return self.plan.output_columns()

    def explain(self, verbose: bool = False) -> str:
        from .plananalysis.plan_analyzer import explain_string

        return explain_string(self, verbose=verbose)


class GroupedData:
    """``df.group_by(...)`` result: call ``agg`` with AggSpecs (or use the
    ``count`` shorthand) to get the aggregated DataFrame."""

    def __init__(self, df: DataFrame, group_by):
        self._df = df
        self._group_by = group_by

    def agg(self, *specs) -> DataFrame:
        from dataclasses import replace

        from .plan.aggregates import AggSpec, validate_specs
        from .plan.ir import Aggregate
        from .utils import resolver

        if not specs:
            raise HyperspaceException("agg() needs at least one AggSpec.")
        out = self._df.plan.output_columns()
        resolved = []
        for s in specs:
            if not isinstance(s, AggSpec):
                raise HyperspaceException(f"Not an AggSpec: {s!r}.")
            if s.column is not None:
                match = resolver.resolve(s.column, out)
                if match is None:
                    raise HyperspaceException(
                        f"Unknown aggregate column: {s.column}."
                    )
                s = replace(s, column=match)
            resolved.append(s)
        validate_specs(tuple(resolved), self._group_by)
        return DataFrame(
            self._df.session,
            Aggregate(self._group_by, tuple(resolved), self._df.plan),
        )

    def count(self) -> DataFrame:
        from .plan.aggregates import agg_count

        return self.agg(agg_count())
