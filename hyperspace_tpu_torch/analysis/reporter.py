"""hslint reporters: human text, machine JSON, and SARIF 2.1.0
renderings of findings. SARIF is the interchange surface — code-review
UIs (GitHub code scanning among them) ingest it directly, so
``python -m hyperspace_tpu_torch.tools.lint --format sarif`` turns every
HS finding into an inline review annotation with no adapter in between.

Counterpart of ``hyperspace_tpu.analysis.reporter``: the same text, JSON
and SARIF renderings, with the SARIF driver's ``informationUri`` pointing
at this package's rule catalog."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

from .core import Finding

_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


# the rule catalog: each rule module's docstring states its heuristic
# and blind spots
_INFORMATION_URI = "hyperspace_tpu_torch/analysis/rules/__init__.py"


def summarize(findings: Sequence[Finding]) -> Dict[str, object]:
    by_code: Dict[str, int] = {}
    for f in findings:
        if not f.suppressed:
            by_code[f.code] = by_code.get(f.code, 0) + 1
    return {
        "total": len(findings),
        "unsuppressed": sum(1 for f in findings if not f.suppressed),
        "suppressed": sum(1 for f in findings if f.suppressed),
        "by_code": dict(sorted(by_code.items())),
    }


def render_text(findings: Sequence[Finding], show_suppressed: bool = False) -> str:
    shown = [f for f in findings if show_suppressed or not f.suppressed]
    lines = [f.render() for f in shown]
    s = summarize(findings)
    lines.append(
        f"hslint: {s['unsuppressed']} finding(s), {s['suppressed']} suppressed"
    )
    if s["by_code"]:
        lines.append(
            "  " + ", ".join(f"{c}: {n}" for c, n in s["by_code"].items())
        )
    return "\n".join(lines)


def render_json(findings: Sequence[Finding]) -> str:
    return json.dumps(
        {
            "findings": [f.to_json_dict() for f in findings],
            "summary": summarize(findings),
        },
        indent=2,
        sort_keys=True,
    )


def render_sarif(
    findings: Sequence[Finding],
    rules: Optional[Sequence] = None,
    base: Optional[Path] = None,
) -> str:
    """SARIF 2.1.0 document for ``findings``.

    ``rules`` (default: the registry) populates the driver's rule
    catalog so viewers show each code's description, and every result
    carries a ``ruleIndex`` into it. Suppressed findings are EMITTED
    with an ``inSource`` suppression object rather than dropped — SARIF
    consumers hide them by default but auditors can surface them, which
    is the same contract as ``--show-suppressed``. Paths are emitted
    relative to ``base`` (default: the repo root two levels up) with
    POSIX separators; SARIF columns are 1-based where hslint's are
    0-based, converted here and nowhere else."""
    if rules is None:
        from .rules import REGISTRY

        rules = REGISTRY
    if base is None:
        base = Path(__file__).resolve().parent.parent.parent
    rule_index = {r.code: i for i, r in enumerate(rules)}
    results = []
    for f in findings:
        uri = Path(f.path)
        try:
            uri = uri.resolve().relative_to(Path(base).resolve())
        except ValueError:
            pass  # outside the base: absolute URI is still valid SARIF
        result = {
            "ruleId": f.code,
            "level": "warning",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": uri.as_posix()},
                        "region": {
                            "startLine": f.line,
                            "startColumn": f.col + 1,
                        },
                    }
                }
            ],
        }
        if f.code in rule_index:
            result["ruleIndex"] = rule_index[f.code]
        if f.suppressed:
            result["suppressions"] = [{"kind": "inSource"}]
        results.append(result)
    doc = {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "hslint",
                        "informationUri": _INFORMATION_URI,
                        "rules": [
                            {
                                "id": r.code,
                                "name": r.name,
                                "shortDescription": {
                                    "text": r.description
                                },
                            }
                            for r in rules
                        ],
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": results,
            }
        ],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
