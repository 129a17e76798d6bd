"""The Action protocol: a transactional begin → op → end state machine over
the operation log.

``run()``:

  1. ``validate()`` — preconditions; may raise NoChangesException to make
     the whole action a successful no-op.
  2. ``begin()`` — write a *transient*-state entry at id ``base_id + 1``.
     A failed write means another writer got there first → concurrency
     error.
  3. ``op()`` — the actual work (the index build).
  4. ``end()`` — write the *final*-state entry at ``base_id + 2`` and
     recreate ``latestStable``.

Crash consistency (reliability/): ``_begin()`` also acquires a
heartbeated writer lease next to the log, and ``_end()`` refuses to commit
if the lease was fenced (a newer epoch exists: the writer stalled past its
lease and recovery or a new writer took over). A writer that fails
in-process marks its lease aborted and leaves the transient entry for
``cancel()`` (actions/metadata_actions.py), since an operator saw the
exception; a writer that dies leaves its lease to expire, and ``run()``'s
recovery consult rolls the index back to its last stable state before the
next action validates.
"""

from __future__ import annotations

import time
from typing import Optional

from ..exceptions import (
    ConcurrentModificationException,
    HyperspaceException,
    NoChangesException,
)
from ..index.log_entry import IndexLogEntry, LogEntry
from ..index.log_manager import IndexLogManager
from ..telemetry import EventLogging, HyperspaceEvent
from . import states


class Action(EventLogging):
    # CancelAction opts out: it operates on the transient state (a prior
    # auto-recovery would leave it nothing to cancel), and it is the
    # break-glass that may fence a live lease (force)
    auto_recover = True
    lease_force = False

    def __init__(self, log_manager: IndexLogManager):
        self.log_manager = log_manager
        self._base_id: Optional[int] = None
        self._held_lease = None

    # -- to be provided by subclasses ---------------------------------------
    @property
    def transient_state(self) -> str:
        raise NotImplementedError

    @property
    def final_state(self) -> str:
        raise NotImplementedError

    def validate(self) -> None:
        """Precondition check; raise HyperspaceException on invalid state,
        NoChangesException for a no-op."""

    def op(self) -> None:
        """The action's work (may be a metadata-only no-op)."""

    def log_entry(self) -> LogEntry:
        """The entry to persist (called for both begin and end)."""
        raise NotImplementedError

    def event(self, message: str) -> Optional[HyperspaceEvent]:
        """Telemetry event for this action; None disables emission."""
        return None

    # -- protocol ------------------------------------------------------------
    @property
    def base_id(self) -> int:
        """Latest log id at action start, or -1 (Action.scala:35)."""
        if self._base_id is None:
            latest = self.log_manager.get_latest_id()
            self._base_id = latest if latest is not None else -1
        return self._base_id

    def _emit(self, message: str) -> None:
        ev = self.event(message)
        if ev is not None and hasattr(self, "conf"):
            self.log_event(self.conf, ev)  # type: ignore[attr-defined]

    # -- leasing (reliability/lease.py) --------------------------------------
    def _lease_manager(self):
        """LeaseManager for this index, or None when the log manager has no
        filesystem/path surface (bare test fakes keep the lease-free
        protocol)."""
        index_path = getattr(self.log_manager, "index_path", None)
        fs = getattr(self.log_manager, "_fs", None)
        if index_path is None or fs is None:
            return None
        from ..reliability.lease import LeaseManager

        return LeaseManager(index_path, fs)

    def _lease_duration_s(self) -> float:
        conf = getattr(self, "conf", None)
        if conf is not None and hasattr(conf, "lease_duration_seconds"):
            return conf.lease_duration_seconds()
        from ..reliability.lease import DEFAULT_LEASE_DURATION_S

        return DEFAULT_LEASE_DURATION_S

    def run(self) -> None:
        if self.auto_recover:
            from ..reliability.recovery import maybe_auto_recover

            if maybe_auto_recover(
                self.log_manager,
                data_manager=getattr(self, "data_manager", None),
                conf=getattr(self, "conf", None),
            ):
                # the log changed under us: re-snapshot the base id and
                # any cached previous entry before validating
                self._base_id = None
                if hasattr(self, "_previous"):
                    self._previous = None
        try:
            self.validate()
        except NoChangesException:
            self._emit("Operation became a no-op.")
            return
        self._emit("Operation started.")
        try:
            self._begin()
            self.op()
            self._end()
        except Exception:
            self._emit("Operation failed.")
            # in-process failure: the transient entry stays for cancel(),
            # and the aborted tombstone tells recovery this is no dead
            # writer (a real crash never reaches here: its lease expires)
            if self._held_lease is not None:
                self._held_lease.abort()
            raise
        if self._held_lease is not None:
            self._held_lease.release()
        self._emit("Operation succeeded.")

    def _stamp(self, entry: LogEntry, id: int, state: str) -> LogEntry:
        entry.id = id
        entry.state = state
        entry.timestamp = int(time.time() * 1000)
        return entry

    def _begin(self) -> None:
        manager = self._lease_manager()
        if manager is not None:
            self._held_lease = manager.acquire(
                duration_s=self._lease_duration_s(),
                action=type(self).__name__,
                force=self.lease_force,
            )
        entry = self._stamp(self.log_entry(), self.base_id + 1, self.transient_state)
        if not self.log_manager.write_log(entry.id, entry):
            raise ConcurrentModificationException(
                "Could not acquire proper state for index modification; "
                "another operation is in flight."
            )

    def _end(self) -> None:
        if self._held_lease is not None:
            # fencing: a writer that stalled past its lease finds a newer
            # epoch (or its own tombstone) and must not commit
            self._held_lease.check_fenced()
        entry = self._stamp(self.log_entry(), self.base_id + 2, self.final_state)
        if not self.log_manager.write_log(entry.id, entry):
            raise ConcurrentModificationException(
                "Could not commit final state; log id already claimed."
            )
        if self.final_state in states.STABLE_STATES:
            self.log_manager.create_latest_stable_log(entry.id)


def _load_latest_entry(log_manager: IndexLogManager) -> IndexLogEntry:
    """The LATEST log entry, not the latest stable one: modifying actions
    validate against ``getLog(baseId)`` (RefreshActionBase.scala:43-55), so
    an index stuck in a transient state refuses further modification until
    cancel() rolls it back."""
    entry = log_manager.get_latest_log()
    if entry is None:
        raise HyperspaceException("Index does not exist.")
    return entry


class MaintenanceActionBase:
    """Shared by actions that rebuild index *data* from an existing entry
    (the refresh family, optimize): the previous entry plus the next
    data-version directory."""

    log_manager: IndexLogManager
    _previous: Optional[IndexLogEntry]

    @property
    def previous_entry(self) -> IndexLogEntry:
        if self._previous is None:
            self._previous = _load_latest_entry(self.log_manager)
        return self._previous

    def next_version_dir(self):
        """Path of the next ``v__=<k>`` data directory (a new immutable
        snapshot per rebuild, CreateActionBase.scala:33-38)."""
        return self.data_manager.get_path(  # type: ignore[attr-defined]
            (self.data_manager.get_latest_version_id() or 0) + 1  # type: ignore[attr-defined]
        )


class IndexAction(Action):
    """Base for actions operating on an *existing* index: loads the previous
    entry and validates its state (DeleteAction.scala and its siblings)."""

    def __init__(self, log_manager: IndexLogManager):
        super().__init__(log_manager)
        self._previous: Optional[IndexLogEntry] = None

    @property
    def allowed_previous_states(self) -> tuple:
        raise NotImplementedError

    @property
    def previous_entry(self) -> IndexLogEntry:
        if self._previous is None:
            self._previous = _load_latest_entry(self.log_manager)
        return self._previous

    def validate(self) -> None:
        if self.previous_entry.state not in self.allowed_previous_states:
            raise HyperspaceException(
                f"{type(self).__name__} is only supported in "
                f"{'/'.join(self.allowed_previous_states)} states; current state "
                f"is {self.previous_entry.state}."
            )

    def log_entry(self) -> LogEntry:
        return self.previous_entry
