"""hslint CLI — run the port's static analyzer.

Usage:
    python -m hyperspace_tpu_torch.tools.lint            # default targets, both phases
    python -m hyperspace_tpu_torch.tools.lint hyperspace_tpu_torch chip_smoke.py
    python -m hyperspace_tpu_torch.tools.lint --format json hyperspace_tpu_torch
    python -m hyperspace_tpu_torch.tools.lint --no-project somefile.py  # per-file rules only
    python -m hyperspace_tpu_torch.tools.lint --changed HEAD~1  # full model, report changed
    python -m hyperspace_tpu_torch.tools.lint --format sarif > hslint.sarif
    python -m hyperspace_tpu_torch.tools.lint --check-suppressions --budget 16
    python -m hyperspace_tpu_torch.tools.lint --no-cache
    python -m hyperspace_tpu_torch.tools.lint --call-graph-dump cg.json --timings
    python -m hyperspace_tpu_torch.tools.lint --list-rules

The default targets are the port's package and ``chip_smoke.py``. The
whole-program phase (HS009-HS013) is ON by default: it builds one
project model over every given path, so even ``--changed`` pre-commit
runs see cross-module effects of a local edit. Exit status: 0 when no
unsuppressed findings (in the reported set), 1 otherwise (2 on usage
error). Suppressed findings never fail the run; ``--show-suppressed``
prints them for auditing. The port's tests hold the default targets at
zero through this same entry point.

Counterpart of the reference's ``scripts/lint.py``; the finding cache
lives in ``.hslint_torch_cache/`` at the repo root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from ..analysis import (
    iter_python_files,
    iter_suppression_markers,
    render_json,
    render_sarif,
    render_text,
    run_analysis,
)
from ..analysis import cache as _cache
from ..analysis.rules import REGISTRY

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent

# what a bare run lints and what the port's tests hold at zero
# unsuppressed findings: the package and the card's smoke script
DEFAULT_TARGETS = ("hyperspace_tpu_torch", "chip_smoke.py")
DEFAULT_CACHE_DIR = _REPO_ROOT / ".hslint_torch_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hslint", description="repo-tuned static analysis of the port"
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files or directories to lint (default: "
        + " ".join(DEFAULT_TARGETS)
        + " from the repo root)",
    )
    ap.add_argument(
        "--format",
        choices=("text", "json", "sarif"),
        default="text",
        dest="fmt",
    )
    ap.add_argument(
        "--show-suppressed",
        action="store_true",
        help="include suppressed findings in text output",
    )
    ap.add_argument(
        "--project",
        dest="project",
        action="store_true",
        default=True,
        help="run the whole-program phase (HS009-HS013) — the default",
    )
    ap.add_argument(
        "--no-project",
        dest="project",
        action="store_false",
        help="skip the whole-program phase; per-file rules only",
    )
    ap.add_argument(
        "--timings",
        action="store_true",
        help="print per-rule wall seconds (project model build included)",
    )
    ap.add_argument(
        "--call-graph-dump",
        metavar="PATH",
        help="write the project model (resolved call graph, lock "
        "inventory, per-function lock events) as JSON — the debug "
        "artifact for surprising HS009-HS012 verdicts",
    )
    ap.add_argument(
        "--changed",
        metavar="GIT_REF",
        help="build the FULL project model but report findings only in "
        "files changed since GIT_REF (plus untracked files) — the fast "
        "pre-commit mode",
    )
    ap.add_argument(
        "--check-suppressions",
        action="store_true",
        help="audit mode: report every '# hslint: disable' marker whose "
        "rule no longer fires on its line (stale suppressions get "
        "deleted, not inherited); exits 1 when any are stale",
    )
    ap.add_argument(
        "--budget",
        type=int,
        metavar="N",
        help="with --check-suppressions: fail when more than N "
        "suppressions exist — the ratchet that keeps 'suppress it' "
        "from becoming the path of least resistance",
    )
    ap.add_argument(
        "--cache-dir",
        metavar="DIR",
        default=str(DEFAULT_CACHE_DIR),
        help="finding-cache directory (default: .hslint_torch_cache/ at "
        "the repo root); a hit skips the whole analysis when neither the "
        "linted files nor the analyzer changed",
    )
    ap.add_argument(
        "--no-cache",
        action="store_true",
        help="always run the full analysis (and do not write the cache)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in REGISTRY:
            print(f"{rule.code} {rule.name}: {rule.description}")
        return 0
    paths = args.paths or [str(_REPO_ROOT / t) for t in DEFAULT_TARGETS]

    missing = [p for p in paths if not Path(p).exists()]
    if missing:
        print(f"hslint: no such path: {', '.join(missing)}", file=sys.stderr)
        return 2

    if args.budget is not None and not args.check_suppressions:
        ap.error("--budget only applies to --check-suppressions")
    if not args.project and args.check_suppressions:
        # the audit must see every rule a marker can name — auditing
        # with project rules off would report live HS009+ suppressions
        # as stale and tell the user to delete them
        ap.error("--check-suppressions requires the project phase "
                 "(drop --no-project)")
    if not args.project and args.call_graph_dump:
        ap.error("--call-graph-dump is a project-phase artifact "
                 "(drop --no-project)")

    changed = None
    if args.changed is not None:
        # resolved BEFORE the analysis so a typo'd ref fails fast
        changed = _changed_files(args.changed)
        if changed is None:
            print(
                f"hslint: cannot resolve --changed {args.changed!r} "
                "(not a git checkout, or unknown ref)",
                file=sys.stderr,
            )
            return 2

    timings: dict = {}
    models: list = []
    t0 = time.perf_counter()
    # cache: a hit replays the stored findings of an identical run.
    # --call-graph-dump needs the live model, --no-project runs a
    # different (smaller) finding set than the cached full run, and
    # --timings measures the analyzer (a replay's timings would be
    # noise) — all three bypass. The key covers the linted bytes AND the
    # analyzer sources, so neither a source edit nor a rule edit can
    # replay stale verdicts.
    use_cache = (
        not args.no_cache
        and args.project
        and not args.call_graph_dump
        and not args.timings
    )
    findings = None
    key = None
    if use_cache:
        key = _cache.cache_key(
            _cache.file_hashes([Path(p) for p in paths]),
            _cache.analyzer_signature(),
            argv=[str(p) for p in paths],
        )
        findings = _cache.load(Path(args.cache_dir), key)
    if findings is None:
        findings = run_analysis(
            [Path(p) for p in paths],
            project=args.project,
            timings=timings if args.timings else None,
            model_sink=models if args.call_graph_dump else None,
        )
        if use_cache and key is not None:
            _cache.store(Path(args.cache_dir), key, findings)
    wall = time.perf_counter() - t0

    if args.call_graph_dump and models:
        Path(args.call_graph_dump).write_text(
            json.dumps(models[0].dump(), indent=2, sort_keys=True),
            encoding="utf-8",
        )
        # on stderr: a --format json or sarif run's stdout stays one document
        print(f"hslint: call graph written to {args.call_graph_dump}", file=sys.stderr)

    if args.check_suppressions:
        return _check_suppressions(paths, findings, args.budget)

    if changed is not None:
        findings = [
            f for f in findings if Path(f.path).resolve() in changed
        ]

    if args.fmt == "json":
        print(render_json(findings))
    elif args.fmt == "sarif":
        print(render_sarif(findings, REGISTRY, base=_REPO_ROOT))
    else:
        print(render_text(findings, show_suppressed=args.show_suppressed))
    if args.timings:
        for code, dt in sorted(timings.items()):
            print(f"  {code}: {dt * 1e3:.1f} ms", file=sys.stderr)
        print(f"  total: {wall:.2f} s", file=sys.stderr)
    return 1 if any(not f.suppressed for f in findings) else 0


def _changed_files(ref: str) -> "set | None":
    """Absolute paths changed since ``ref`` plus untracked files, or None
    when git cannot answer (the caller turns that into a usage error
    rather than silently linting nothing)."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", ref, "--"],
            cwd=_REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=30,
        )
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=_REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    if diff.returncode != 0 or untracked.returncode != 0:
        return None
    out = set()
    for line in diff.stdout.splitlines() + untracked.stdout.splitlines():
        line = line.strip()
        if line:
            out.add((_REPO_ROOT / line).resolve())
    return out


def _check_suppressions(paths, findings, budget=None) -> int:
    """Report markers whose codes never fire on their bound line. A bare
    ``disable`` is stale when NO finding lands on its line; a coded
    marker is stale per code. With ``budget``, additionally fail when
    the live suppression count exceeds it — the tests pin the budget at
    the audited current count, so every NEW suppression must either
    retire an old one or raise the pin in the same diff (with the
    justification that implies)."""
    by_site: dict = {}
    for f in findings:
        by_site.setdefault((str(Path(f.path)), f.line), set()).add(f.code)
    stale = 0
    checked = 0
    for root in paths:
        for fpath in iter_python_files([Path(root)]):
            source = fpath.read_text(encoding="utf-8")
            for marker_line, bound_line, codes in iter_suppression_markers(
                source
            ):
                fired = by_site.get((str(fpath), bound_line), set())
                if codes is None:
                    checked += 1
                    if not fired:
                        stale += 1
                        print(
                            f"{fpath}:{marker_line}: stale suppression — "
                            "no rule fires on the suppressed line"
                        )
                    continue
                for code in sorted(codes):
                    checked += 1
                    if code not in fired:
                        stale += 1
                        print(
                            f"{fpath}:{marker_line}: stale suppression — "
                            f"{code} no longer fires on the suppressed line"
                        )
    print(
        f"hslint: {checked} suppression(s) audited, {stale} stale"
    )
    if budget is not None and checked > budget:
        print(
            f"hslint: suppression budget exceeded — {checked} > {budget}; "
            "fix the finding or retire another suppression instead"
        )
        return 1
    return 1 if stale else 0


if __name__ == "__main__":
    sys.exit(main())
