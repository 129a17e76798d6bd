"""Display modes for the explain API: plain text, HTML, console.

Parity: com/microsoft/hyperspace/index/plananalysis/DisplayMode.scala:24-88
— each mode supplies a highlight tag pair (overridable via the
``hyperspace.explain.displayMode.highlight.*`` conf keys), a begin/end tag
wrapping the whole output, and its newline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .. import constants as C
from ..exceptions import HyperspaceException


@dataclass(frozen=True)
class Tag:
    open: str
    close: str


def _highlight_tag_or_else(display_conf: Dict[str, str], default: Tag) -> Tag:
    begin = display_conf.get(C.HIGHLIGHT_BEGIN_TAG, "")
    end = display_conf.get(C.HIGHLIGHT_END_TAG, "")
    if begin and end:
        return Tag(begin, end)
    return default


class DisplayMode:
    highlight_tag: Tag = Tag("", "")
    begin_end_tag: Tag = Tag("", "")
    new_line: str = "\n"


class PlainTextMode(DisplayMode):
    """(DisplayMode.scala:71-77)."""

    def __init__(self, display_conf: Dict[str, str] | None = None):
        self.highlight_tag = _highlight_tag_or_else(
            display_conf or {}, Tag("<----", "---->")
        )


class HTMLMode(DisplayMode):
    """(DisplayMode.scala:59-68)."""

    begin_end_tag = Tag("<pre>", "</pre>")
    new_line = "<br>"

    def __init__(self, display_conf: Dict[str, str] | None = None):
        self.highlight_tag = _highlight_tag_or_else(
            display_conf or {},
            Tag('<b style="background:LightGreen">', "</b>"),
        )


class ConsoleMode(DisplayMode):
    """(DisplayMode.scala:80-87): ANSI green background, as
    scala.Console.GREEN_B/RESET."""

    def __init__(self, display_conf: Dict[str, str] | None = None):
        self.highlight_tag = _highlight_tag_or_else(
            display_conf or {}, Tag("\x1b[42m", "\x1b[0m")
        )


def display_mode_from_conf(conf) -> DisplayMode:
    """Resolve the session's display mode (IndexConstants.scala:65-72)."""
    name = str(conf.get(C.DISPLAY_MODE, C.DISPLAY_MODE_DEFAULT)).lower()
    display_conf = {
        k: str(v)
        for k, v in conf.as_dict().items()
        if k in (C.HIGHLIGHT_BEGIN_TAG, C.HIGHLIGHT_END_TAG)
    }
    if name == C.DISPLAY_MODE_PLAIN_TEXT:
        return PlainTextMode(display_conf)
    if name == C.DISPLAY_MODE_HTML:
        return HTMLMode(display_conf)
    if name == C.DISPLAY_MODE_CONSOLE:
        return ConsoleMode(display_conf)
    raise HyperspaceException(f"Unsupported display mode: {name!r}.")
