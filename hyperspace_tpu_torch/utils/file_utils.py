"""Filesystem helpers over the local/POSIX filesystem.

Parity: com/microsoft/hyperspace/util/FileUtils.scala:28-123. The reference
goes through the Hadoop FileSystem API; here plain POSIX is the storage
substrate (object-store backends slot in behind the same functions later —
see SURVEY.md §7 "Atomic-rename OCC on object stores").
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Iterable, List


def delete(path: str | Path) -> None:
    """Recursive delete that tolerates absence (FileUtils.scala:76-90)."""
    p = Path(path)
    if p.is_dir() and not p.is_symlink():
        shutil.rmtree(p, ignore_errors=True)
    elif p.exists() or p.is_symlink():
        p.unlink(missing_ok=True)


def expand_globs(paths: Iterable[str | Path]) -> List[Path]:
    """Expand glob wildcards in paths; non-pattern paths pass through
    (the analog of Spark's globPathIfNecessary used by the reference's
    globbing support, DefaultFileBasedSource.scala:90-118)."""
    import glob as _glob

    out: List[Path] = []
    for p in paths:
        s = str(p)
        # A path that exists literally is never treated as a pattern, so
        # directories with glob metacharacters in their names (legal on
        # POSIX) keep working for non-globbing callers.
        if _glob.has_magic(s) and not os.path.exists(s):
            out.extend(Path(m) for m in sorted(_glob.glob(s)))
        else:
            out.append(Path(p))
    return out


def list_leaf_files(paths: Iterable[str | Path]) -> List[Path]:
    """Recursively list data files under ``paths``, skipping hidden/underscore
    entries the way the reference's DataPathFilter does (PathUtils.scala:22-39).
    A path that is itself a file is returned as-is; glob patterns are
    expanded first."""
    out: List[Path] = []
    for p in expand_globs(paths):
        if p.is_file():
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = [d for d in dirs if not d.startswith((".", "_"))]
            for f in sorted(files):
                if not f.startswith((".", "_")):
                    out.append(Path(root) / f)
    return sorted(out)


def atomic_create(path: str | Path, content: str) -> bool:
    """Atomically create ``path`` with ``content`` iff it does not exist:
    the optimistic-concurrency commit point (IndexLogManager.scala:149-165),
    through the filesystem seam's ``create_if_absent``."""
    from ..storage.filesystem import DEFAULT_FS

    return DEFAULT_FS.create_if_absent(str(path), content.encode("utf-8"))
