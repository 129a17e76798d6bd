"""HS013 — undeclared config key.

The build alone reads a handful of knobs; the failure mode this rule
closes is the typo'd knob that is SILENTLY ignored: ``conf.get()``
returns the default for any unknown key, so
``hyperspace.index.build.ingestWorker`` (missing ``s``) configures
nothing and nobody notices until a benchmark lies. Every ``hyperspace.*``
key string read anywhere in the project must exist in the declared
registry (``constants.py``, which ``config.py``'s typed accessors read).

Detection (whole-program, documented blind spots):
  * the REGISTRY is every string literal looking like a config key
    (full-string match of ``hyperspace.<dotted.path>``) in any project
    module named ``constants`` or ``config`` — declaring a key there IS
    the registration act;
  * a USAGE is any other module's string literal that full-string-
    matches the key shape; partial strings (docstrings, log messages,
    glob patterns) never match, and keys BUILT at runtime
    (f-strings, concatenation) are invisible — declare such families
    with an explicit prefix constant instead;
  * when the linted path set contains no registry module the rule stays
    silent rather than flagging every key (single-file runs).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Set, Tuple

from ..core import ProjectRule

_KEY_RE = re.compile(r"^hyperspace(\.[A-Za-z0-9_]+)+$")
_REGISTRY_MODULES = {"constants", "config"}


def _key_literals(tree: ast.AST) -> List[Tuple[str, int, int]]:
    out = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and _KEY_RE.match(node.value)
        ):
            out.append((node.value, node.lineno, node.col_offset))
    return out


class ConfigKeyRule(ProjectRule):
    code = "HS013"
    name = "undeclared-config-key"
    description = (
        "a hyperspace.* config key string is used but not declared in "
        "the constants/config registry — a typo'd knob would be "
        "silently ignored"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        declared: Set[str] = set()
        registries = []
        usages = []
        for mod in project.modules.values():
            basename = mod.name.rsplit(".", 1)[-1]
            literals = _key_literals(mod.ctx.tree)
            if basename in _REGISTRY_MODULES:
                registries.append(mod.name)
                declared.update(v for v, _l, _c in literals)
            else:
                usages.append((mod, literals))
        if not registries:
            return
        registry_names = ", ".join(sorted(registries))
        for mod, literals in usages:
            for value, line, col in literals:
                if value in declared:
                    continue
                yield (
                    mod.path,
                    line,
                    col,
                    f"config key '{value}' is not declared in the "
                    f"registry ({registry_names}); an unknown key is "
                    "silently ignored by conf.get() — declare it (or "
                    "fix the typo)",
                )
