"""hslint finding cache — skip the analysis when nothing changed.

A pre-commit hook pays the whole analysis on every invocation even when
the tree is byte-identical to the last run. This cache stores the
FINDINGS of a whole run keyed by (a) the sha256 of every linted file's
content and (b) a signature over the analyzer's own
sources — so editing any linted file OR any rule invalidates the entry,
and a hit is exactly "the same analyzer saw the same bytes".

Findings are cached, not parsed ASTs: unpickling an AST forest is no
faster than parsing the sources again, so the win is skipping the whole
analysis, or nothing.

Entries live under ``--cache-dir`` (default ``.hslint_torch_cache/`` at
the repo root, git-ignored; the reference analyzer keeps its own
``.hslint_cache/``) as one JSON file per key; the newest
``_MAX_ENTRIES`` are kept so branch-hopping doesn't thrash a single
slot. Corrupt or unreadable entries are treated as misses — the cache
can never change a lint verdict, only skip recomputing it.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from .core import Finding, iter_python_files

_MAX_ENTRIES = 8
_FORMAT = 1  # bump to orphan every existing entry


def analyzer_signature() -> str:
    """sha256 over the analyzer's own sources (this package, rules
    included) — a rule edit must invalidate every cached verdict."""
    pkg = Path(__file__).resolve().parent
    h = hashlib.sha256()
    h.update(f"format={_FORMAT}".encode())
    for f in sorted(pkg.rglob("*.py")):
        h.update(f.relative_to(pkg).as_posix().encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def file_hashes(paths: Iterable[Path]) -> Dict[str, str]:
    """{resolved posix path: sha256} for every .py file a run would
    lint — the same traversal ``run_analysis`` uses, so the key covers
    exactly the analyzed bytes."""
    out: Dict[str, str] = {}
    for root in paths:
        for f in iter_python_files([Path(root)]):
            out[f.resolve().as_posix()] = hashlib.sha256(
                f.read_bytes()
            ).hexdigest()
    return out


def cache_key(
    hashes: Dict[str, str], signature: str, argv: Iterable[str] = ()
) -> str:
    """``argv`` is the path arguments AS SPELLED on the command line:
    findings carry those spellings (a relative invocation prints relative
    paths), so a replay keyed only on resolved content would echo another
    invocation's spellings — same verdicts, wrong rendering, and a
    mismatch for consumers that join findings back to paths."""
    payload = json.dumps(
        {"sig": signature, "files": hashes, "argv": list(argv)},
        sort_keys=True,
    ).encode()
    return hashlib.sha256(payload).hexdigest()


def load(cache_dir: Path, key: str) -> Optional[List[Finding]]:
    """The cached findings for ``key``, or None on miss/corruption."""
    entry = Path(cache_dir) / f"{key}.json"
    try:
        payload = json.loads(entry.read_text(encoding="utf-8"))
        findings = [Finding(**d) for d in payload["findings"]]
    except (OSError, ValueError, TypeError, KeyError):
        return None
    entry.touch()  # LRU recency for prune()
    return findings


def store(cache_dir: Path, key: str, findings: List[Finding]) -> None:
    """Write-through; failures are silent (a broken cache dir must not
    fail the lint run) but never partial (atomic rename)."""
    cache_dir = Path(cache_dir)
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
        entry = cache_dir / f"{key}.json"
        tmp = cache_dir / f".{key}.tmp"
        tmp.write_text(
            json.dumps(
                {"findings": [f.to_json_dict() for f in findings]},
                sort_keys=True,
            ),
            encoding="utf-8",
        )
        os.replace(tmp, entry)
        _prune(cache_dir)
    except OSError:
        return


def _prune(cache_dir: Path) -> None:
    entries = sorted(
        cache_dir.glob("*.json"),
        key=lambda p: p.stat().st_mtime,
        reverse=True,
    )
    for stale in entries[_MAX_ENTRIES:]:
        try:
            stale.unlink()
        except OSError:
            pass
