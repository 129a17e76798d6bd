"""hslint — repo-tuned static analysis of the port's invariants.

Two phases. Per-file rules (HS001-HS008, HS014) each encode a bug class
of this code base: host-device syncs in hot paths and unfenced device
timings (under a torch/CUDA device model), locks held across blocking
calls, un-normalized path cache keys, silently swallowed exceptions,
non-deterministic hash inputs, unbounded module caches, raw writes of
log/metadata paths, and metric-name discipline. Project rules
(HS009-HS013) run on a whole-program model — symbol table, resolved
intra-package call graph, lock inventory (analysis/project.py) — and
machine-check the cross-module concurrency invariants: lock ordering,
guarded fields, blocking reachability (device dispatch included),
residency fence/epoch discipline and the config-key registry. Entry
points:

    from hyperspace_tpu_torch.analysis import run_analysis, analyze_source
    findings = run_analysis([Path("hyperspace_tpu_torch")])  # both phases

or the CLI: ``python -m hyperspace_tpu_torch.tools.lint`` (defaults to
the port's package and ``chip_smoke.py``). Suppress intentional boundary
violations per line with ``# hslint: disable=HSxxx`` plus a
justification comment.

Counterpart of ``hyperspace_tpu.analysis`` without its value-flow phase;
stdlib only, it imports neither torch nor anything of the engine.
"""

from __future__ import annotations

from .core import (
    Finding,
    ModuleContext,
    ProjectRule,
    Rule,
    analyze_file,
    analyze_project_sources,
    analyze_source,
    iter_python_files,
    iter_suppression_markers,
    run_analysis,
)
from .reporter import render_json, render_sarif, render_text, summarize

__all__ = [
    "Finding",
    "ModuleContext",
    "ProjectRule",
    "Rule",
    "analyze_file",
    "analyze_project_sources",
    "analyze_source",
    "iter_python_files",
    "iter_suppression_markers",
    "run_analysis",
    "render_json",
    "render_sarif",
    "render_text",
    "summarize",
]
