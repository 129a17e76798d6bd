"""HS008 — raw ``fs.write`` of operation-log/metadata paths.

The operation log's crash consistency hangs on ONE primitive: the
atomic ``create_if_absent`` claim (``utils.file_utils.atomic_create`` /
the seam's generation-0 precondition). A plain ``fs.write`` aimed at a
log or metadata path bypasses that claim: it can silently overwrite a
concurrent writer's committed entry — the exact lost-update the OCC
protocol exists to prevent, reintroduced one convenience call at a
time. This rule flags filesystem ``.write(...)`` calls whose path
expression mentions the log/metadata namespace, unless the call carries
an ``if_generation_match=`` precondition (the sanctioned overwrite
guard for generation-aware backends).

Detection:
  * receiver is fs-ish: the attribute chain's terminal name before
    ``.write`` matches ``fs`` / ``_fs`` / ``*_fs`` / ``filesystem``
    (``self._fs.write``, ``fs.write``, ``DEFAULT_FS.write``);
  * the first positional argument's SOURCE TEXT mentions a metadata
    marker: ``HYPERSPACE_LOG`` / ``_hyperspace_log``, ``LATEST_STABLE``
    / ``latestStable``, ``HYPERSPACE_LEASE`` / ``_hyperspace_lease``,
    ``log_dir``, or ``_path_of`` — the way log/metadata paths are
    actually spelled in this tree;
  * a ``if_generation_match=`` keyword clears the finding.

Blind spots (by design of a textual path heuristic): a metadata path
laundered through an unmarked local variable is invisible, as is a
write routed through a helper. The rule polices the idiom at the sites
where the namespace is named.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Tuple

from ..core import ModuleContext, Rule, terminal_name

_FSISH_RE = re.compile(r"^(_?fs|.*_fs|filesystem|default_fs)$", re.I)
_MARKERS = (
    "HYPERSPACE_LOG",
    "_hyperspace_log",
    "LATEST_STABLE",
    "latestStable",
    "HYPERSPACE_LEASE",
    "_hyperspace_lease",
    "log_dir",
    "_path_of",
)


class RawMetadataWriteRule(Rule):
    code = "HS008"
    name = "raw-metadata-write"
    description = (
        "a filesystem .write() targets an operation-log/metadata path "
        "without a generation precondition; log/metadata claims must go "
        "through atomic_create/create_if_absent (or carry "
        "if_generation_match) or concurrent writers silently lose updates"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr == "write"):
                continue
            recv = terminal_name(fn.value) or ""
            if not _FSISH_RE.match(recv):
                continue
            if not node.args:
                continue
            if any(kw.arg == "if_generation_match" for kw in node.keywords):
                continue
            arg_src = ast.get_source_segment(ctx.source, node.args[0]) or ""
            hit = next((m for m in _MARKERS if m in arg_src), None)
            if hit is None:
                continue
            yield (
                node.lineno,
                node.col_offset,
                f"raw fs write of metadata path (mentions {hit!r}); use "
                "atomic_create/create_if_absent for claims, or pass "
                "if_generation_match= for a guarded overwrite",
            )
