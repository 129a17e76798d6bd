"""Per-query span tracing: one tree of timed spans per query.

Counterpart of ``hyperspace_tpu.telemetry.trace``. The metrics registry
answers "how much, in total"; a trace answers where THIS query's wall
time went: admission, queue, plan and pipeline cache, lowering, the
device dispatch and its copy home, the host legs. A trace is a tree of
``Span``s, each with monotonic wall times and labels (residency tier,
pipeline fingerprint, H2D/D2H bytes), opened at stage boundaries that
already exist as counter sites.

The active span is a ``contextvars`` variable: a thread, or a context
copied from it (the union's sides, the worker pool), records into the
span it entered; unrelated threads see no active span and record
nothing, so two concurrent queries' traces never interleave. With no
active trace ``span()`` and ``annotate()`` cost one context-variable
read. Tracing is on by default (``hyperspace.telemetry.tracing=off``
stops the entry points from opening traces; the span sites then do
nothing).

Clock: ``time.monotonic()`` throughout, the serve tier's ticket clock.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import contextvars

_ACTIVE: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "hyperspace_tpu_torch_trace_span", default=None
)

_IDS = itertools.count(1)
_IDS_LOCK = threading.Lock()


class Span:
    """One timed stage. Children are appended by nested ``span()`` calls
    on this thread/context; labels carry the stage's attribution facts
    (tier, fingerprint, byte gauges). Mutation is single-writer by the
    contextvar discipline except ``children.append`` (atomic under the
    GIL — union sides append to one parent concurrently by design)."""

    __slots__ = ("name", "t0", "t1", "labels", "children", "status", "error")

    def __init__(
        self,
        name: str,
        t0: Optional[float] = None,
        labels: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.t0 = time.monotonic() if t0 is None else float(t0)
        self.t1: Optional[float] = None
        self.labels: Dict[str, Any] = dict(labels) if labels else {}
        self.children: List["Span"] = []
        self.status = "ok"
        self.error: Optional[str] = None

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def close(self, error: Optional[BaseException] = None) -> None:
        if error is not None:
            self.status = "error"
            self.error = repr(error)
        if self.t1 is None:
            self.t1 = time.monotonic()

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in list(self.children):
            yield from c.walk()

    def to_dict(self) -> Dict[str, Any]:
        d = self.duration_s
        out: Dict[str, Any] = {
            "name": self.name,
            "duration_s": None if d is None else round(d, 6),
            "status": self.status,
        }
        if self.error is not None:
            out["error"] = self.error
        if self.labels:
            out["labels"] = dict(self.labels)
        if self.children:
            out["spans"] = [c.to_dict() for c in list(self.children)]
        return out

    def render(self, indent: int = 0) -> List[str]:
        d = self.duration_s
        dur = "..." if d is None else f"{d * 1e3:.3f} ms"
        mark = "" if self.status == "ok" else f"  [{self.status}: {self.error}]"
        labels = (
            " " + " ".join(f"{k}={v}" for k, v in sorted(self.labels.items()))
            if self.labels
            else ""
        )
        lines = [f"{'  ' * indent}{self.name}  {dur}{labels}{mark}"]
        for c in list(self.children):
            lines.extend(c.render(indent + 1))
        return lines


class QueryTrace:
    """One query's span tree plus its attribution metadata.

    ``meta`` is the one-source-of-truth record explain(verbose) renders
    from: ``metrics`` (the query's scoped registry snapshot), ``serve``
    (tenant + pinned log version, serve tier only), ``pipeline`` (the
    CompiledPipeline describe() dict). The flight recorder rings
    completed traces; snapshots taken around failures carry in-flight
    traces too (telemetry.recorder)."""

    def __init__(self, name: str, **labels: Any):
        with _IDS_LOCK:
            self.trace_id = next(_IDS)
        self.root = Span(name, labels=labels)
        self.meta: Dict[str, Any] = {}
        self.complete = False

    def activate(self) -> "_Activation":
        """Bind this trace's root as the active span on the current
        thread/context — library ``span()`` sites attach under it. Used
        by the serve worker to adopt a ticket's trace on its own thread
        (submit and dispatch run on different threads by design)."""
        return _Activation(self)

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        **labels: Any,
    ) -> Span:
        """Attach an already-elapsed stage from explicit monotonic
        timestamps (queue wait: submitted_at -> started_at)."""
        s = Span(name, t0=t0, labels=labels)
        s.t1 = float(t1)
        self.root.children.append(s)
        return s

    def adopt(self, shared: Span) -> None:
        """Attach a span subtree RECORDED UNDER ANOTHER TRACE (a
        coalesced batch's one dispatch serves many tickets; each rider's
        trace adopts the shared dispatch subtree — a per-rider split of
        one stacked launch would be fiction, exactly the batched-metrics
        rule)."""
        self.root.children.append(shared)

    def finish(self, error: Optional[BaseException] = None) -> None:
        self.root.close(error)
        self.complete = True

    # -- queries -------------------------------------------------------------
    def spans(self) -> List[str]:
        return [s.name for s in self.root.walk()]

    def find(self, name: str) -> Optional[Span]:
        for s in self.root.walk():
            if s.name == name:
                return s
        return None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "complete": self.complete,
            "root": self.root.to_dict(),
        }
        meta = {k: v for k, v in self.meta.items() if k != "metrics"}
        if meta:
            out["meta"] = meta
        return out

    def render(self) -> str:
        return "\n".join(self.root.render())


# ---------------------------------------------------------------------------
# module-level recording API (no-ops without an active trace)
# ---------------------------------------------------------------------------
class _Activation:
    """Class-based context manager for QueryTrace.activate() — span
    sites sit on the serve hot path, so the machinery avoids the
    generator-contextmanager overhead."""

    __slots__ = ("_trace", "_token")

    def __init__(self, trace: QueryTrace):
        self._trace = trace
        self._token = None

    def __enter__(self) -> QueryTrace:
        self._token = _ACTIVE.set(self._trace.root)
        return self._trace

    def __exit__(self, et, ev, tb) -> bool:
        _ACTIVE.reset(self._token)
        return False


class _SpanCtx:
    """Class-based context manager behind ``span()`` (hot path; see
    _Activation). Enters to the Span, or None with no active trace. An
    exception propagating out marks the span failed before re-raising."""

    __slots__ = ("_name", "_labels", "_span", "_token")

    def __init__(self, name: str, labels: Dict[str, Any]):
        self._name = name
        self._labels = labels
        self._span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Optional[Span]:
        parent = _ACTIVE.get()
        if parent is None:
            return None
        s = Span(self._name, labels=self._labels)
        parent.children.append(s)
        self._token = _ACTIVE.set(s)
        self._span = s
        return s

    def __exit__(self, et, ev, tb) -> bool:
        s = self._span
        if s is None:
            return False
        if et is not None:
            s.status = "error"
            s.error = repr(ev)
        s.t1 = time.monotonic()
        _ACTIVE.reset(self._token)
        return False


def span(name: str, **labels: Any) -> _SpanCtx:
    """Open a child span under the active one; the ``with`` target is
    the Span (None when no trace is active — callers may label through
    the yielded object only after a None check, or use annotate())."""
    return _SpanCtx(name, labels)


def annotate(**labels: Any) -> None:
    """Merge labels into the active span (no-op without one) — how deep
    layers (residency caches) attach facts to whatever stage is open."""
    s = _ACTIVE.get()
    if s is not None:
        s.labels.update(labels)


def add_bytes(key: str, n: int) -> None:
    """Accumulate a byte gauge on the active span (no-op without one):
    the H2D/D2H sites call this next to their counters, so a span says
    how many bytes ITS stage moved."""
    s = _ACTIVE.get()
    if s is not None:
        s.labels[key] = int(s.labels.get(key, 0)) + int(n)


@contextmanager
def start_trace(name: str, **labels: Any):
    """Create a QueryTrace and activate it for the block; the caller
    finishes/records it (query entry points gate on
    conf.telemetry_tracing_enabled() BEFORE calling this)."""
    t = QueryTrace(name, **labels)
    with t.activate():
        yield t
