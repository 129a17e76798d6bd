from .events import (  # noqa: F401
    AppInfo,
    HyperspaceEvent,
    HyperspaceIndexCRUDEvent,
    CreateActionEvent,
    DeleteActionEvent,
    RestoreActionEvent,
    VacuumActionEvent,
    RefreshActionEvent,
    RefreshIncrementalActionEvent,
    RefreshQuickActionEvent,
    OptimizeActionEvent,
    CancelActionEvent,
    HyperspaceIndexUsageEvent,
)
from .logging import EventLogger, NoOpEventLogger, EventLogging, get_event_logger  # noqa: F401
from .metrics import metrics  # noqa: F401
