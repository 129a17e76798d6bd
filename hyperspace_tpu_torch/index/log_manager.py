"""The operation log: versioned JSON entries with optimistic concurrency.

Parity: com/microsoft/hyperspace/index/IndexLogManager.scala:33-165. Layout
under each index directory:

    <index>/_hyperspace_log/0          JSON IndexLogEntry, id 0
    <index>/_hyperspace_log/1          ...
    <index>/_hyperspace_log/latestStable   copy of the latest stable entry

``write_log(id, entry)`` returns False if the id is already claimed — the
filesystem's temp-file + atomic-link claim (storage.filesystem
``create_if_absent``) makes the id claim linearizable, which is the whole concurrency-control story
(IndexLogManager.scala:149-165; design lineage: Delta's OCC, README.md:30-33).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from .. import constants as C
from ..exceptions import HyperspaceException
from ..utils import json_utils
from .log_entry import IndexLogEntry, LogEntry
from ..actions import states

logger = logging.getLogger(__name__)

LATEST_STABLE = "latestStable"


class IndexLogManager:
    """Abstract interface (reference trait IndexLogManager.scala:33-55)."""

    def get_log(self, id: int) -> Optional[IndexLogEntry]:
        raise NotImplementedError

    def get_latest_id(self) -> Optional[int]:
        raise NotImplementedError

    def get_latest_log(self) -> Optional[IndexLogEntry]:
        raise NotImplementedError

    def get_latest_stable_log(self) -> Optional[IndexLogEntry]:
        raise NotImplementedError

    def write_log(self, id: int, entry: LogEntry) -> bool:
        raise NotImplementedError

    def create_latest_stable_log(self, id: int) -> bool:
        raise NotImplementedError

    def delete_latest_stable_log(self) -> bool:
        raise NotImplementedError


class IndexLogManagerImpl(IndexLogManager):
    """Operation log over any storage backend. ``fs`` defaults to the
    local POSIX filesystem; passing an object-store FileSystem (e.g. a GCS
    backend with if-generation-match creates) runs the identical protocol
    against flat blob storage — the claim primitive is the seam's
    ``create_if_absent`` either way (SURVEY.md §7 hard part 4)."""

    def __init__(self, index_path: str | Path, fs=None, retry_policy=None):
        from ..reliability.retry import wrap_with_retries
        from ..storage.filesystem import DEFAULT_FS

        self._index_path = Path(index_path)
        self._log_dir = self._index_path / C.HYPERSPACE_LOG
        # every log RPC runs under the retry policy (reliability/retry.py):
        # a flaky object-store call no longer fails a whole action, and
        # the wrap is idempotent so callers may pass a pre-wrapped fs
        self._fs = wrap_with_retries(
            fs if fs is not None else DEFAULT_FS, retry_policy
        )

    @property
    def index_path(self) -> Path:
        """The index directory this log belongs to (the lease and doctor
        machinery anchor next to the log from here)."""
        return self._index_path

    @property
    def log_dir(self) -> Path:
        return self._log_dir

    def _path_of(self, id: int) -> Path:
        return self._log_dir / str(id)

    def _read(self, path: Path) -> Optional[IndexLogEntry]:
        # read-and-catch, not exists-then-read: one RPC on object stores
        # and no TOCTOU window against concurrent deleters
        try:
            raw = self._fs.read(str(path))
        except (FileNotFoundError, IsADirectoryError):
            return None
        try:
            return IndexLogEntry.from_json_dict(
                json_utils.from_json(raw.decode("utf-8"))
            )
        except (ValueError, KeyError, TypeError) as e:
            # a truncated/garbled entry must name its file — a bare
            # JSONDecodeError from deep inside index enumeration is
            # undebuggable (and the OCC protocol means a *committed* entry
            # is never partially written: corruption here is storage rot
            # or outside interference, worth a loud, precise error)
            raise HyperspaceException(f"Corrupt index log entry at {path}: {e}")

    def get_log(self, id: int) -> Optional[IndexLogEntry]:
        return self._read(self._path_of(id))

    def get_latest_id(self) -> Optional[int]:
        """Highest numeric entry name in the log dir
        (IndexLogManager.scala:83-92)."""
        ids = [int(n) for n in self._fs.list(str(self._log_dir)) if n.isdigit()]
        return max(ids) if ids else None

    def get_latest_log(self) -> Optional[IndexLogEntry]:
        latest = self.get_latest_id()
        return self.get_log(latest) if latest is not None else None

    def get_latest_stable_log(self) -> Optional[IndexLogEntry]:
        """Prefer the latestStable copy; fall back to a backward scan for a
        stable-state entry (IndexLogManager.scala:94-113)."""
        entry = self._read(self._log_dir / LATEST_STABLE)
        if entry is not None:
            if entry.state not in states.STABLE_STATES:
                raise HyperspaceException(
                    f"Corrupt latestStable with non-stable state {entry.state}"
                )
            return entry
        latest = self.get_latest_id()
        if latest is None:
            return None
        for id in range(latest, -1, -1):
            e = self.get_log(id)
            if e is not None and e.state in states.STABLE_STATES:
                return e
        return None

    def write_log(self, id: int, entry: LogEntry) -> bool:
        """Atomically claim log id ``id``; False if already taken
        (IndexLogManager.scala:149-165). No exists() pre-check: the claim
        primitive is the sole linearizable test, and a pre-check would be
        an extra RPC plus a TOCTOU window on object stores."""
        return self._fs.create_if_absent(
            str(self._path_of(id)), json_utils.to_json(entry).encode("utf-8")
        )

    def create_latest_stable_log(self, id: int) -> bool:
        """Copy entry ``id`` to latestStable (IndexLogManager.scala:115-133).
        Overwrites any previous latestStable (an atomic whole-object write
        on both POSIX and object stores)."""
        entry = self.get_log(id)
        if entry is None:
            logger.warning("create_latest_stable_log: no entry with id %s", id)
            return False
        if entry.state not in states.STABLE_STATES:
            logger.warning(
                "create_latest_stable_log: entry %s has unstable state %s",
                id,
                entry.state,
            )
            return False
        # hslint: disable=HS008 - latestStable is the ONE sanctioned
        # overwrite: a rebuildable cache of a committed chain entry (same
        # id -> same bytes), never a claim; fenced writers are stopped at
        # _end() before reaching it, and doctor() rebuilds a torn copy
        self._fs.write(
            str(self._log_dir / LATEST_STABLE), json_utils.to_json(entry).encode("utf-8")
        )
        return True

    def delete_latest_stable_log(self) -> bool:
        self._fs.delete(str(self._log_dir / LATEST_STABLE))
        return True
