"""BufferStream: string building with display-mode-aware highlighting.

Parity: com/microsoft/hyperspace/index/plananalysis/BufferStream.scala:23-82
— highlight tags are inserted after leading and before trailing whitespace
so indentation survives, and the final output is wrapped in the mode's
begin/end tag.
"""

from __future__ import annotations

import re

from .display_mode import DisplayMode

_LEADING_WS = re.compile(r"^(\s*)")
_TRAILING_WS = re.compile(r"(\s*)$")


class BufferStream:
    def __init__(self, display_mode: DisplayMode):
        self.display_mode = display_mode
        self._parts: list[str] = []

    def write(self, s: str = "") -> "BufferStream":
        self._parts.append(s)
        return self

    def write_line(self, s: str = "") -> "BufferStream":
        self._parts.append(s)
        self._parts.append(self.display_mode.new_line)
        return self

    def highlight(self, s: str) -> "BufferStream":
        """Wrap ``s`` in the mode's highlight tags, preserving leading and
        trailing whitespace outside the tags (BufferStream.scala:55-66)."""
        tag = self.display_mode.highlight_tag
        lead = _LEADING_WS.match(s).group(1)
        trail = _TRAILING_WS.search(s[len(lead):]).group(1)
        body = s[len(lead): len(s) - len(trail)] if trail else s[len(lead):]
        self._parts.append(f"{lead}{tag.open}{body}{tag.close}{trail}")
        return self

    def highlight_line(self, s: str = "") -> "BufferStream":
        self.highlight(s)
        self._parts.append(self.display_mode.new_line)
        return self

    def with_tag(self) -> str:
        tag = self.display_mode.begin_end_tag
        return f"{tag.open}{self}{tag.close}"

    def __str__(self) -> str:
        return "".join(self._parts)
