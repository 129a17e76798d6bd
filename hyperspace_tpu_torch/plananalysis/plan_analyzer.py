"""Explain engine: show a query's plan with and without Hyperspace, which
indexes fire, and (verbose) an operator-count diff.

Parity: com/microsoft/hyperspace/index/plananalysis/PlanAnalyzer.scala,
as ``hyperspace_tpu.plananalysis.plan_analyzer`` carries it: the plan is
built twice — Hyperspace disabled / enabled — differing subtrees are
highlighted in the session's display mode, an "Indexes used" section lists
applied indexes, and verbose mode appends the physical-operator comparison
and the engine metrics of this process (telemetry.metrics).

The reference's verbose mode goes on with sections read from the last
query's trace (serve tier, compiled pipeline, shuffle plan, span tree,
scoped metrics). This package records no query trace yet, so they render
as the reference renders them with tracing off: not at all.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Tuple

from ..actions import states
from ..plan.ir import LogicalPlan
from ..plan.rules import apply_hyperspace_rules
from ..telemetry.metrics import metrics
from .buffer_stream import BufferStream
from .display_mode import DisplayMode, display_mode_from_conf

_BANNER = "============================================================="


def _plan_lines(plan: LogicalPlan, other: LogicalPlan) -> List[Tuple[str, bool]]:
    """``(line, differs)`` tree lines of ``plan``; a line differs when its
    subtree does not appear in ``other`` (queue-walk diff of
    PlanAnalyzer.scala:60-105)."""
    other_subtrees = set()

    def collect(node: LogicalPlan) -> None:
        other_subtrees.add(node.tree_string())
        for c in node.children:
            collect(c)

    collect(other)

    lines: List[Tuple[str, bool]] = []

    def walk(node: LogicalPlan, indent: int) -> None:
        subtree = node.tree_string()
        lines.append(("  " * indent + node.describe(), subtree not in other_subtrees))
        for c in node.children:
            walk(c, indent + 1)

    walk(plan, 0)
    return lines


def _operator_counts(plan: LogicalPlan) -> Counter:
    counts: Counter = Counter()

    def walk(node: LogicalPlan) -> None:
        counts[node.node_name] += 1
        for c in node.children:
            walk(c)

    walk(plan)
    return counts


def _write_plan(buf: BufferStream, title: str, lines: List[Tuple[str, bool]]) -> None:
    buf.write_line(_BANNER)
    buf.write_line(title)
    buf.write_line(_BANNER)
    for line, differs in lines:
        if differs:
            buf.highlight_line(line)
        else:
            buf.write_line(line)
    buf.write_line()


def explain_string(
    df, verbose: bool = False, display_mode: Optional[DisplayMode] = None
) -> str:
    """(PlanAnalyzer.explainString). Works whether or not the session has
    Hyperspace enabled — both plans are compiled here."""
    session = df.session
    mode = display_mode or display_mode_from_conf(session.conf)
    indexes = session.collection_manager.get_indexes(
        [states.ACTIVE], prefer_stable=True
    )
    # the same normalization passes execution runs: explain shows the plan
    # the executor would see
    plan_off = df.normalized_plan()
    plan_on, applied = apply_hyperspace_rules(plan_off, indexes, session.conf)

    buf = BufferStream(mode)
    _write_plan(buf, "Plan with indexes:", _plan_lines(plan_on, plan_off))
    _write_plan(buf, "Plan without indexes:", _plan_lines(plan_off, plan_on))

    buf.write_line(_BANNER)
    buf.write_line("Indexes used:")
    buf.write_line(_BANNER)
    for e in applied:
        loc = e.content.files()
        loc_str = loc[0].rsplit("/", 1)[0] if loc else ""
        buf.write_line(f"{e.name}:{loc_str}")
    buf.write_line()

    if verbose:
        on_counts = _operator_counts(plan_on)
        off_counts = _operator_counts(plan_off)
        buf.write_line(_BANNER)
        buf.write_line("Physical operator stats:")
        buf.write_line(_BANNER)
        buf.write_line(
            f"{'Physical Operator':<30}{'Hyperspace(On)':>15}"
            f"{'Hyperspace(Off)':>16}{'Difference':>11}"
        )
        for op in sorted(set(on_counts) | set(off_counts)):
            on_c, off_c = on_counts.get(op, 0), off_counts.get(op, 0)
            buf.write_line(f"{op:<30}{on_c:>15}{off_c:>16}{on_c - off_c:>11}")
        buf.write_line()

        # which engine paths have run in this process (kernel, plain
        # version, host) with cumulative timers
        counters = metrics.snapshot()
        timers = metrics.timings()
        buf.write_line(_BANNER)
        buf.write_line("Engine metrics (cumulative, this process):")
        buf.write_line(_BANNER)
        if not counters and not timers:
            buf.write_line("(no queries executed yet)")
        for name in sorted(counters):
            buf.write_line(f"{name:<40}{counters[name]:>12}")
        for name in sorted(timers):
            total_s, calls = timers[name]
            buf.write_line(f"{name:<40}{total_s:>10.4f}s{calls:>8} call(s)")
        buf.write_line()
        _write_last_query(buf, session)
    return buf.with_tag()


def _write_last_query(buf: BufferStream, session) -> None:
    """The last query's sections, all rendered from ONE record, its trace
    (``session.last_trace``: serve attribution, compiled pipeline, scoped
    metrics, spans), so they always describe the same query. (The
    reference's shuffle-plan section comes with multi-device.)"""
    last_trace = getattr(session, "last_trace", None)
    if last_trace is None:
        return
    serve_info = last_trace.meta.get("serve")
    pipe_info = last_trace.meta.get("pipeline")
    last = last_trace.meta.get("metrics")
    if serve_info is not None:
        buf.write_line(_BANNER)
        buf.write_line("Last served query (serve tier):")
        buf.write_line(_BANNER)
        buf.write_line(f"Tenant: {serve_info.get('tenant')}")
        buf.write_line(f"Pinned log version: {serve_info.get('pinned_log_version')}")
        buf.write_line()
    if pipe_info is not None:
        buf.write_line(_BANNER)
        buf.write_line("Whole-plan compilation (last query):")
        buf.write_line(_BANNER)
        buf.write_line(f"Pipeline kind: {pipe_info.get('kind')}")
        buf.write_line(f"Residency tier at lowering: {pipe_info.get('tier')}")
        for line in pipe_info.get("boundary", ()):
            buf.write_line(line)
        buf.write_line(f"Pipeline runs: {pipe_info.get('runs')}"
                       f" (fused dispatches: {pipe_info.get('fused_dispatches')})")
        # where the aggregate ran, from the trace's scoped counters: the
        # device paths count their own, anything else is the host hash
        if pipe_info.get("kind") in ("agg_scan", "join_agg") and last:
            c = last["counters"]
            if c.get("scan.path.resident_agg"):
                where = "device segment-sum"
            elif c.get("scan.path.resident_join_agg"):
                where = "device segment-sum (join region)"
            else:
                where = "host hash"
            buf.write_line(f"Aggregate ran: {where}")
        buf.write_line()
    # where the last query's wall time went, stage by stage
    buf.write_line(_BANNER)
    buf.write_line("Last query trace (spans):")
    buf.write_line(_BANNER)
    for line in last_trace.root.render():
        buf.write_line(line)
    buf.write_line()
    if last is not None:
        buf.write_line(_BANNER)
        buf.write_line("Last query metrics (scoped to that query):")
        buf.write_line(_BANNER)
        tier_paths = (
            ("scan.path.resident_streaming", "streaming"),
            ("scan.path.resident_compressed", "compressed"),
            ("scan.path.resident_device", "resident"),
            ("scan.path.resident_hybrid", "resident (hybrid)"),
        )
        served = [label for key, label in tier_paths if last["counters"].get(key)]
        buf.write_line("Residency tier served: " + (", ".join(served) if served else "host"))
        for name in sorted(last["counters"]):
            buf.write_line(f"{name:<40}{last['counters'][name]:>12}")
        for name in sorted(last["timers_s"]):
            calls = last["timer_counts"].get(name, 0)
            buf.write_line(f"{name:<40}{last['timers_s'][name]:>10.4f}s{calls:>8} call(s)")
        buf.write_line()
