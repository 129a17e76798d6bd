"""hslint core: module parsing, rule protocol, suppressions, findings.

The analyzer is self-contained — stdlib ``ast`` only, no third-party
dependency — so it runs anywhere the package imports, a machine without
a CUDA card included. Rules are *repo-tuned heuristics*, not a type
system: each one encodes a bug class of this code base (the rule
modules' docstrings give the heuristic and its blind spots). Intentional
violations at genuine host/device or IO boundaries carry a per-line
``# hslint: disable=HSxxx`` suppression with a justification comment.

Counterpart of ``hyperspace_tpu.analysis.core``: the same finding,
context, rule, alias, suppression and traversal surface, and the same
two phases (per-file rules, then the project rules on the whole-program
model of ``project.py``), so one source tree yields the same findings
under both analyzers.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# a comment ``hslint: disable=HS001,HS003`` suppresses those codes on its
# line; with no ``=codes`` every rule is suppressed on that line.
_SUPPRESS_RE = re.compile(
    r"#\s*hslint:\s*disable(?:=(?P<codes>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*))?"
)

_SKIP_DIR_NAMES = {
    ".git",
    "__pycache__",
    "build",
    # the port's git-ignored build output (kernel libraries, throwaway
    # runners): never part of a checkout, so never linted
    "_build",
    ".venv",
    "venv",
    "node_modules",
    ".eggs",
}


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    code: str
    message: str
    path: str
    line: int
    col: int
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}{tag}"

    def to_json_dict(self) -> Dict[str, object]:
        return {
            "code": self.code,
            "message": self.message,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "suppressed": self.suppressed,
        }


class ModuleContext:
    """Everything a rule needs about one parsed module."""

    def __init__(self, source: str, path: str) -> None:
        self.source = source
        self.path = path
        # posix form so rules can scope on "hyperspace_tpu_torch/exec/"
        # whatever the OS separator or the caller's spelling of the path
        self.posix = Path(path).as_posix()
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.aliases = build_aliases(self.tree)

    def text_at(self, line: int) -> str:
        return self.lines[line - 1] if 1 <= line <= len(self.lines) else ""


class Rule:
    """One analysis pass. Subclasses set ``code``/``name``/``description``
    and implement ``check`` yielding ``(line, col, message)`` tuples."""

    code: str = "HS000"
    name: str = "base"
    description: str = ""

    def applies_to(self, posix_path: str) -> bool:
        return True

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        raise NotImplementedError


class ProjectRule(Rule):
    """Phase-2 analysis pass over the whole-program model
    (analysis/project.py) instead of one module's AST. Subclasses
    implement ``check_project`` yielding ``(path, line, col, message)``
    tuples — path included because a cross-module property anchors its
    finding wherever the witness site lives. Project rules run only when
    the analysis builds a project model (``run_analysis(project=True)``,
    the default); ``analyze_source`` skips them."""

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        return iter(())  # per-file phase: nothing — the model phase reports

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        raise NotImplementedError


def build_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name → dotted origin for every absolute import in the module,
    so rules match ``np.asarray`` and ``from time import sleep`` alike.
    Relative imports are not mapped: ``from ..ops import kernels`` leaves
    ``kernels.x`` as spelled, and rules that must see such calls match
    them by name suffix."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.level == 0:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_name(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Resolved dotted name of a Name/Attribute chain (``np.asarray`` →
    ``numpy.asarray``), or None when the chain is rooted in a call,
    subscript, or other expression."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(aliases.get(cur.id, cur.id))
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last identifier of a Name/Attribute expression (``self._lock``
    → ``_lock``), or None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def parse_suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """Line → suppressed codes (None means all codes) from hslint
    comments. A trailing marker suppresses its own line; a STANDALONE
    comment line carrying the marker suppresses the next code line — the
    idiom for a suppression whose justification deserves a full line:

        # hslint: disable=HS004 - the decline is recorded in the row
        except Exception:
            ...

    Further comment-only lines may sit between the marker and the code
    line (multi-line justifications). Markers are matched in COMMENT
    tokens only (``tokenize``-classified): a docstring or help text that
    merely mentions the marker is neither a suppression nor a
    ``--check-suppressions`` audit subject. On files tokenize cannot
    process the classification falls back to any-line textual matching
    (lint-control channel: fail open)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for _marker_line, bound_line, codes in iter_suppression_markers(source):
        if codes is None:
            out[bound_line] = None
            continue
        prev = out.get(bound_line, set())
        out[bound_line] = None if prev is None else (prev or set()) | codes
    return out


def iter_suppression_markers(
    source: str,
) -> List[Tuple[int, int, Optional[Set[str]]]]:
    """Every suppression marker in a module as ``(marker line, bound
    line, codes)`` — codes None for a bare ``disable``. The bound line is
    where findings are matched (a trailing marker binds to its own line,
    a standalone comment marker to the next code line);
    ``--check-suppressions`` reports stale markers at the MARKER line,
    which is where the delete happens."""
    out: List[Tuple[int, int, Optional[Set[str]]]] = []
    if "hslint" not in source:
        return out
    lines = source.splitlines()
    comment_lines = _comment_lines(source)
    for i, line in enumerate(lines, start=1):
        if "hslint" not in line:
            continue
        if comment_lines is not None and i not in comment_lines:
            continue
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        raw = m.group("codes")
        codes = (
            None
            if raw is None
            else {c.strip() for c in raw.split(",") if c.strip()}
        )
        if line.lstrip().startswith("#"):
            # standalone marker: bind to the next non-comment, non-blank
            # line (skipping the justification's continuation comments)
            j = i
            while j < len(lines):
                nxt = lines[j].strip()
                if nxt and not nxt.startswith("#"):
                    out.append((i, j + 1, codes))
                    break
                j += 1
        else:
            out.append((i, i, codes))
    return out


def _comment_lines(source: str) -> Optional[Set[int]]:
    """Line numbers carrying a ``#`` comment token, or None when
    tokenize cannot process the source (caller falls back to textual
    matching on every line)."""
    import io
    import tokenize

    out: Set[int] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.add(tok.start[0])
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return None
    return out


def _suppressed(
    suppressions: Dict[int, Optional[Set[str]]], line: int, code: str
) -> bool:
    """A marker on ``line`` names ``code``, or names no rule."""
    codes = suppressions.get(line, "absent")
    return codes != "absent" and (codes is None or code in codes)


def _findings(
    ctx: ModuleContext,
    rule: Rule,
    suppressions: Dict[int, Optional[Set[str]]],
) -> Iterator[Finding]:
    """``rule``'s findings on one module, each flagged suppressed when a
    marker on its line names the rule (or names no rule)."""
    for line, col, message in rule.check(ctx):
        yield Finding(
            rule.code, message, ctx.path, line, col,
            _suppressed(suppressions, line, rule.code),
        )


def _project_findings(
    model,
    rule: ProjectRule,
    suppressions_by_path: Dict[str, Dict[int, Optional[Set[str]]]],
) -> Iterator[Finding]:
    """``rule``'s findings on the whole-program model, each flagged
    suppressed by the markers of the module it lands in."""
    for path, line, col, message in rule.check_project(model):
        yield Finding(
            rule.code, message, path, line, col,
            _suppressed(suppressions_by_path.get(path, {}), line, rule.code),
        )


def _syntax_error(path: str, e: SyntaxError) -> Finding:
    return Finding(
        "HS000",
        f"syntax error prevents analysis: {e.msg}",
        path,
        e.lineno or 1,
        (e.offset or 1) - 1,
    )


def _sorted(findings: List[Finding]) -> List[Finding]:
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


def analyze_source(
    source: str, path: str, rules: Optional[Sequence[Rule]] = None
) -> List[Finding]:
    """All findings (suppressed ones flagged, not dropped) for one module's
    source text. ``path`` drives per-rule scoping, so fixture tests can
    place a snippet anywhere in the virtual tree."""
    if rules is None:
        from .rules import REGISTRY

        rules = REGISTRY
    ctx = ModuleContext(source, path)
    suppressions = parse_suppressions(source)
    findings: List[Finding] = []
    for rule in rules:
        if rule.applies_to(ctx.posix):
            findings.extend(_findings(ctx, rule, suppressions))
    return _sorted(findings)


def analyze_file(path: Path, rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    source = path.read_text(encoding="utf-8")
    try:
        return analyze_source(source, str(path), rules)
    except SyntaxError as e:
        return [_syntax_error(str(path), e)]


def iter_python_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_file():
            if p.suffix == ".py":
                yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIR_NAMES for part in f.parts):
                    yield f


def run_analysis(
    paths: Iterable[Path],
    rules: Optional[Sequence[Rule]] = None,
    project: bool = True,
    timings: Optional[Dict[str, float]] = None,
    model_sink: Optional[list] = None,
) -> List[Finding]:
    """Lint every ``.py`` under ``paths`` (files or directories) and return
    the combined findings list.

    Two phases: per-file rules run on each module's AST; with
    ``project=True`` (the default) a whole-program model is then built
    over ALL the parsed modules and the cross-module rules (HS009+)
    run on it, HS015-HS020 on the model's value flow. Module names are
    derived relative to each path's parent (``project.path_to_module``).
    ``timings`` — when a dict is passed, it is filled with per-rule wall
    seconds plus ``"project-model"`` for the model build and
    ``"device-flow"`` for the value flow's (the ``--timings`` CLI
    surface). ``model_sink`` — when a
    list is passed and the project phase runs, the built ProjectModel is
    appended to it (the ``--call-graph-dump`` surface: the model is
    expensive enough that the CLI must not build it twice)."""
    import time as _time

    if rules is None:
        from .rules import REGISTRY

        rules = REGISTRY
    file_rules = [r for r in rules if not isinstance(r, ProjectRule)]
    project_rules = [r for r in rules if isinstance(r, ProjectRule)] if project else []
    if project_rules:
        # project.py imports this module: bound here, not at import
        from .project import build_project, path_to_module

    def note(code: str, dt: float) -> None:
        if timings is not None:
            timings[code] = timings.get(code, 0.0) + dt

    findings: List[Finding] = []
    entries: List[Tuple[ModuleContext, str, bool]] = []
    suppressions_by_path: Dict[str, Dict[int, Optional[Set[str]]]] = {}
    for root in paths:
        root = Path(root)
        base = root.parent.as_posix()
        for f in iter_python_files([root]):
            source = f.read_text(encoding="utf-8")
            try:
                ctx = ModuleContext(source, str(f))
            except SyntaxError as e:
                findings.append(_syntax_error(str(f), e))
                continue
            suppressions = parse_suppressions(source)
            suppressions_by_path[ctx.path] = suppressions
            if project_rules:
                name, is_pkg = path_to_module(f.as_posix(), base)
                entries.append((ctx, name, is_pkg))
            for rule in file_rules:
                if not rule.applies_to(ctx.posix):
                    continue
                t0 = _time.perf_counter()
                findings.extend(_findings(ctx, rule, suppressions))
                note(rule.code, _time.perf_counter() - t0)
    if project_rules and entries:
        t0 = _time.perf_counter()
        model = build_project(entries)
        note("project-model", _time.perf_counter() - t0)
        if model_sink is not None:
            model_sink.append(model)
        t0 = _time.perf_counter()
        # prebuild the device-value flow so the HS015+ rules share one
        # fixpoint and its cost shows under its own timings key instead
        # of inflating whichever rule touches it first
        model.device_flow()
        note("device-flow", _time.perf_counter() - t0)
        for rule in project_rules:
            t0 = _time.perf_counter()
            findings.extend(_project_findings(model, rule, suppressions_by_path))
            note(rule.code, _time.perf_counter() - t0)
    return _sorted(findings)


def analyze_project_sources(
    sources: Dict[str, str], rules: Optional[Sequence[Rule]] = None
) -> List[Finding]:
    """Project-rule findings over a virtual ``{posix path: source}`` tree
    — the fixture entry point: tests hand a synthetic multi-module
    package and get cross-module findings with suppressions applied, no
    filesystem involved."""
    from .project import build_project_from_sources

    if rules is None:
        from .rules import REGISTRY

        rules = REGISTRY
    model = build_project_from_sources(sources)
    sups = {path: parse_suppressions(src) for path, src in sources.items()}
    findings: List[Finding] = []
    for rule in rules:
        if isinstance(rule, ProjectRule):
            findings.extend(_project_findings(model, rule, sups))
    return _sorted(findings)
