"""Event-logger loading and dispatch.

Parity: com/microsoft/hyperspace/telemetry/HyperspaceEventLogging.scala:30-68
— the logger class is loaded reflectively from config
(``hyperspace.eventLoggerClass``), defaulting to a no-op.
"""

from __future__ import annotations

import importlib
from typing import Optional

from ..config import HyperspaceConf
from ..exceptions import HyperspaceException
from ..utils.cache_with_transform import CacheWithTransform
from .events import HyperspaceEvent


class EventLogger:
    def log_event(self, event: HyperspaceEvent) -> None:
        raise NotImplementedError


class NoOpEventLogger(EventLogger):
    """(HyperspaceEventLogging.scala:66-68)."""

    def log_event(self, event: HyperspaceEvent) -> None:
        pass


def get_event_logger(conf: HyperspaceConf) -> EventLogger:
    """Load the configured logger class (``module:ClassName`` or dotted
    path), defaulting to NoOp (HyperspaceEventLogging.scala:42-64)."""
    cls_name = conf.event_logger_class()
    if not cls_name:
        return NoOpEventLogger()
    if ":" in cls_name:
        mod_name, _, attr = cls_name.partition(":")
    elif "." in cls_name:
        mod_name, _, attr = cls_name.rpartition(".")
    else:
        raise HyperspaceException(
            f"Invalid event logger class {cls_name!r}: expected "
            "'module:ClassName' or a dotted path."
        )
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr)()


class EventLogging:
    """Mixin giving actions a ``log_event`` (HyperspaceEventLogging.scala:30-40).
    The logger reloads whenever the configured class name changes, via
    CacheWithTransform — the same conf-keyed invalidation the reference uses."""

    _logger_cache: Optional[CacheWithTransform] = None
    _current_conf: Optional[HyperspaceConf] = None

    def log_event(self, conf: HyperspaceConf, event: HyperspaceEvent) -> None:
        # The cache's key_fn reads the *latest* conf through self, so both a
        # changed conf object and a changed class value invalidate correctly.
        self._current_conf = conf
        if self._logger_cache is None:
            self._logger_cache = CacheWithTransform(
                lambda: self._current_conf.event_logger_class(),
                lambda _key: get_event_logger(self._current_conf),
            )
        self._logger_cache.load().log_event(event)
