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
    return buf.with_tag()
