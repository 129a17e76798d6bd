"""Open an index tree written by either package.

Both packages keep all of an index's state on disk in the same formats:
the JSON operation log (``<index>/_hyperspace_log/<id>`` and
``latestStable``) and the TCB data files under ``<index>/v__=<k>/``. A
session of this package whose ``hyperspace.system.path`` points at a tree
``hyperspace_tpu`` built therefore serves queries from it directly;
``open_index_tree`` loads and checks such a tree up front.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

from ..actions import states
from ..exceptions import HyperspaceException
from ..storage import layout
from .log_entry import IndexLogEntry
from .log_manager import IndexLogManagerImpl


def open_index_tree(system_path: str | Path) -> Dict[str, IndexLogEntry]:
    """The latest stable ACTIVE entry of every index under
    ``system_path``, keyed by index name, with every data file's footer
    read through the shared reader cache (so the first query pays no
    footer parse). Per-bucket files and the streaming build's multi-bucket
    run files are both read; raises when a logged data file is missing, is
    not a TCB data file, or is a run file without its ``bucketCounts``."""
    root = Path(system_path)
    out: Dict[str, IndexLogEntry] = {}
    if not root.is_dir():
        return out
    for d in sorted(root.iterdir()):
        if not d.is_dir():
            continue
        entry = IndexLogManagerImpl(d).get_latest_stable_log()
        if entry is None or entry.state != states.ACTIVE:
            continue
        for f in entry.content.files():
            run = layout.is_run_file(f)
            if not run:
                layout.bucket_of_file(f)  # raises on a foreign file name
            if not Path(f).is_file():
                raise HyperspaceException(
                    f"Index {entry.name}: logged data file {f} is missing."
                )
            layout.cached_reader(f)
            if run:
                layout.run_offsets_checked(f)
        out[entry.name] = entry
    return out
