"""hslint CLI — run the port's static analyzer.

Usage:
    python -m hyperspace_tpu_torch.tools.lint            # default targets
    python -m hyperspace_tpu_torch.tools.lint hyperspace_tpu_torch chip_smoke.py
    python -m hyperspace_tpu_torch.tools.lint --format json hyperspace_tpu_torch
    python -m hyperspace_tpu_torch.tools.lint --changed HEAD~1
    python -m hyperspace_tpu_torch.tools.lint --format sarif > hslint.sarif
    python -m hyperspace_tpu_torch.tools.lint --check-suppressions --budget 15
    python -m hyperspace_tpu_torch.tools.lint --no-cache
    python -m hyperspace_tpu_torch.tools.lint --timings
    python -m hyperspace_tpu_torch.tools.lint --list-rules

The default targets are the port's package and ``chip_smoke.py``.
Exit status: 0 when no unsuppressed findings (in the reported set), 1
otherwise (2 on usage error). Suppressed findings never fail the run;
``--show-suppressed`` prints them for auditing. The port's tests hold
the default targets at zero through this same entry point.

Counterpart of the reference's ``scripts/lint.py`` with its per-file
rules; the finding cache lives in ``.hslint_torch_cache/`` at the repo
root.
"""

from __future__ import annotations

import argparse
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
        "--timings",
        action="store_true",
        help="print per-rule wall seconds",
    )
    ap.add_argument(
        "--changed",
        metavar="GIT_REF",
        help="analyze every path but report findings only in files "
        "changed since GIT_REF (plus untracked files) — the fast "
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
    t0 = time.perf_counter()
    # cache: a hit replays the stored findings of an identical run.
    # --timings measures the analyzer (a replay's timings would be
    # noise), so it bypasses. The key covers the linted bytes AND the
    # analyzer sources, so neither a source edit nor a rule edit can
    # replay stale verdicts.
    use_cache = not args.no_cache and not args.timings
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
            timings=timings if args.timings else None,
        )
        if use_cache and key is not None:
            _cache.store(Path(args.cache_dir), key, findings)
    wall = time.perf_counter() - t0

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
