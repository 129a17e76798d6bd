"""Metadata-only lifecycle actions: delete, restore, vacuum, cancel.

Parity: ``hyperspace_tpu.actions.metadata_actions``:
  DeleteAction  — ACTIVE → DELETING → DELETED, op() no-op
                  (actions/DeleteAction.scala:24-48)
  RestoreAction — DELETED → RESTORING → ACTIVE, op() no-op
                  (actions/RestoreAction.scala:24-48)
  VacuumAction  — DELETED → VACUUMING → DOESNOTEXIST, op() deletes every
                  data version dir (actions/VacuumAction.scala:29-57)
  CancelAction  — rolls a stuck transient state back to the last stable
                  entry (actions/CancelAction.scala:35-76)
"""

from __future__ import annotations

import shutil
from typing import Optional

from .. import constants as C
from ..config import HyperspaceConf
from ..exceptions import HyperspaceException
from ..index.data_manager import IndexDataManager
from ..index.log_entry import IndexLogEntry, LogEntry
from ..index.log_manager import IndexLogManager
from ..telemetry import (
    CancelActionEvent,
    DeleteActionEvent,
    RestoreActionEvent,
    VacuumActionEvent,
)
from . import states
from .base import IndexAction


class DeleteAction(IndexAction):
    def __init__(self, log_manager: IndexLogManager, conf: Optional[HyperspaceConf] = None):
        super().__init__(log_manager)
        self.conf = conf or HyperspaceConf()

    transient_state = states.DELETING
    final_state = states.DELETED
    allowed_previous_states = (states.ACTIVE,)

    def event(self, message: str):
        return DeleteActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )


class RestoreAction(IndexAction):
    def __init__(self, log_manager: IndexLogManager, conf: Optional[HyperspaceConf] = None):
        super().__init__(log_manager)
        self.conf = conf or HyperspaceConf()

    transient_state = states.RESTORING
    final_state = states.ACTIVE
    allowed_previous_states = (states.DELETED,)

    def event(self, message: str):
        return RestoreActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )


class VacuumAction(IndexAction):
    def __init__(
        self,
        log_manager: IndexLogManager,
        data_manager: IndexDataManager,
        conf: Optional[HyperspaceConf] = None,
    ):
        super().__init__(log_manager)
        self.data_manager = data_manager
        self.conf = conf or HyperspaceConf()

    transient_state = states.VACUUMING
    final_state = states.DOESNOTEXIST
    allowed_previous_states = (states.DELETED,)

    def op(self) -> None:
        """Physically delete every data version directory
        (VacuumAction.scala:46-52)."""
        for vid in self.data_manager.get_all_version_ids():
            self.data_manager.delete(vid)

    def event(self, message: str):
        return VacuumActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )


class CancelAction(IndexAction):
    """Recovery from a stuck transient state: write a new entry restoring the
    last *stable* state (CancelAction.scala:35-72). Refuses if the index is
    already stable (:55-60). If no stable entry exists (e.g. the first
    create failed), the index goes to DOESNOTEXIST.

    ``op()`` removes ``.spill`` scratch trees from version dirs the
    restored entry does not reference, as the reference does for a
    streaming build that died mid-flight (this package's in-memory build
    writes none); the committed versions' data is never touched."""

    # cancel IS the recovery: it operates on the transient state (a prior
    # auto-recovery would leave nothing to cancel) and may fence a live
    # lease, the operator's break-glass against a stalled-but-beating
    # writer (reliability/lease.py)
    auto_recover = False
    lease_force = True

    def __init__(
        self,
        log_manager: IndexLogManager,
        conf: Optional[HyperspaceConf] = None,
        data_manager: Optional[IndexDataManager] = None,
    ):
        super().__init__(log_manager)
        self.conf = conf or HyperspaceConf()
        self.data_manager = data_manager

    def op(self) -> None:
        if self.data_manager is None:
            return
        prefix = C.INDEX_VERSION_DIRECTORY_PREFIX + "="
        stable = self.log_manager.get_latest_stable_log()
        referenced = set()
        if stable is not None and hasattr(stable, "content"):
            for f in stable.content.files():
                for part in str(f).split("/"):
                    if part.startswith(prefix):
                        referenced.add(int(part[len(prefix):]))
        for vid in self.data_manager.get_all_version_ids():
            if vid in referenced:
                continue
            spill = self.data_manager.get_path(vid) / ".spill"
            if spill.is_dir():
                shutil.rmtree(spill, ignore_errors=True)

    transient_state = states.CANCELLING

    @property
    def final_state(self) -> str:
        """Last stable log's state; VACUUMING rolls forward to DOESNOTEXIST
        (CancelAction.scala:48-64)."""
        if self.previous_entry.state == states.VACUUMING:
            return states.DOESNOTEXIST
        stable = self.log_manager.get_latest_stable_log()
        return stable.state if stable is not None else states.DOESNOTEXIST

    def validate(self) -> None:
        if self.previous_entry.state in states.STABLE_STATES:
            raise HyperspaceException(
                f"Cancel() is not supported in a stable state "
                f"({self.previous_entry.state})."
            )

    def log_entry(self) -> LogEntry:
        stable: Optional[IndexLogEntry] = self.log_manager.get_latest_stable_log()
        return stable if stable is not None else self.previous_entry

    def event(self, message: str):
        return CancelActionEvent(
            index=self.previous_entry.name, state=self.final_state, message=message
        )
