"""Resolve index names to paths under the system path.

Parity: com/microsoft/hyperspace/index/PathResolver.scala:30-76 — the
system path comes from config; index-name lookup is case-insensitive
against existing directories so ``myIndex`` and ``MYINDEX`` refer to the
same index.
"""

from __future__ import annotations

from pathlib import Path

from ..config import HyperspaceConf


class PathResolver:
    def __init__(self, conf: HyperspaceConf):
        self._conf = conf

    @property
    def system_path(self) -> Path:
        """(PathResolver.scala:65-70)."""
        return Path(self._conf.system_path()).absolute()

    def get_index_path(self, name: str) -> Path:
        """Case-insensitive directory match, else the exact-cased new path
        (PathResolver.scala:39-60)."""
        root = self.system_path
        if root.is_dir():
            for p in root.iterdir():
                if p.is_dir() and p.name.lower() == name.lower():
                    return p
        return root / name
