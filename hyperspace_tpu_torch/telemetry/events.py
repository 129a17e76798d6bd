"""Structured telemetry events emitted by actions and the rewrite layer.

Parity: com/microsoft/hyperspace/telemetry/HyperspaceEvent.scala:28-156 —
one event class per action, emitted at start/success/failure, plus an
index-usage event carrying before/after plan strings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class AppInfo:
    """(HyperspaceEvent.scala:28)."""

    sparkUser: str = ""
    appId: str = ""
    appName: str = "hyperspace_tpu_torch"


@dataclass
class HyperspaceEvent:
    appInfo: AppInfo = field(default_factory=AppInfo)
    message: str = ""


@dataclass
class HyperspaceIndexCRUDEvent(HyperspaceEvent):
    """(HyperspaceEvent.scala:33-38). ``index`` is the entry's name (entries
    themselves are large; events carry the name + state)."""

    index: Optional[str] = None
    state: str = ""


@dataclass
class CreateActionEvent(HyperspaceIndexCRUDEvent):
    original_plan: str = ""


@dataclass
class HyperspaceIndexUsageEvent(HyperspaceEvent):
    """Emitted when the rewrite layer applies indexes to a query
    (HyperspaceEvent.scala:150-156)."""

    indexes: List[str] = field(default_factory=list)
    plan_before: str = ""
    plan_after: str = ""


@dataclass
class DeleteActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class RestoreActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class VacuumActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class RefreshActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class RefreshIncrementalActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class RefreshQuickActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class OptimizeActionEvent(HyperspaceIndexCRUDEvent):
    pass


@dataclass
class CancelActionEvent(HyperspaceIndexCRUDEvent):
    pass
