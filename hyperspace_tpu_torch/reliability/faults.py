"""Deterministic fault injection on the FileSystem seam.

A crash sweep needs storage that fails ON SCHEDULE, not at random:
every sweep must be reproducible from its parameters alone. A
``FaultSchedule`` is an explicit list of rules evaluated against each
op the wrapped filesystem performs, in call order:

* ``fail`` — raise TransientStorageError (or a supplied error) for the
  first N matching calls, then pass (the classic fail-once / fail-N
  flake the retry layer must absorb);
* ``torn`` — apply HALF the payload with a plain write, then raise: a
  partial PUT / torn page the protocol must never mistake for a commit;
* ``latency`` — sleep before the op (deadline/timeout pressure);
* ``crash`` — raise InjectedCrash (a BaseException, so no ``except
  Exception`` recovery path can swallow it — exactly like process
  death) and flip the filesystem into **dead mode**: every subsequent
  op also raises InjectedCrash. A dead process performs no more IO —
  not even its ``finally`` blocks' lease release or its heartbeat
  thread's next beat, which is precisely the abandonment the lease
  machinery must detect.

``RecordingFileSystem`` wraps a backend and journals every (op, path)
in call order — a clean run under it enumerates the fault points a
crash sweep then kills one at a time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..exceptions import TransientStorageError
from ..storage.filesystem import FileSystem

MUTATING_OPS = ("create_if_absent", "write", "delete")


class InjectedCrash(BaseException):
    """Simulated process death at a storage call. A BaseException on
    purpose: production code's ``except Exception`` recovery paths must
    not observe it, the same way they would not observe SIGKILL."""


@dataclass
class FaultRule:
    """One scheduled fault. ``op`` matches the seam method name or
    ``"*"``; ``path_contains`` substring-matches the path (empty matches
    all); ``after`` skips that many matching calls first (0 = fire on
    the first match); ``times`` bounds how many calls fire (crash rules
    ignore it — dead is dead). ``every=N`` instead fires on every N-th
    matching call (1st, N+1-th, ...): under the retry layer, ``every=2``
    makes every logical op flake exactly once and succeed on its
    immediate retry — the whole-action storage-weather scenario."""

    kind: str  # "fail" | "torn" | "latency" | "crash"
    op: str = "*"
    path_contains: str = ""
    after: int = 0
    times: int = 1
    every: int = 0
    delay_s: float = 0.0
    error: Optional[Exception] = None

    # internal counters
    _seen: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def matches(self, op: str, path: str) -> bool:
        if self.op != "*" and op != self.op:
            return False
        if self.path_contains and self.path_contains not in str(path):
            return False
        self._seen += 1
        if self._seen <= self.after:
            return False
        if self.every > 0:
            if (self._seen - self.after) % self.every != 1 % self.every:
                return False
            self._fired += 1
            return True
        if self.kind != "crash" and self._fired >= self.times:
            return False
        self._fired += 1
        return True


class FaultInjectingFileSystem(FileSystem):
    """Wraps a backend; applies a FaultRule schedule to every op."""

    def __init__(self, inner: FileSystem, rules: Optional[List[FaultRule]] = None):
        self._inner = inner
        self.rules = list(rules or [])
        self.dead = False
        self.ops: List[Tuple[str, str]] = []  # call journal (op, path)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def supports_generation_preconditions(self) -> bool:
        # explicit: the base class attribute would shadow __getattr__
        return self._inner.supports_generation_preconditions

    def _gate(self, op: str, path: str, data: Optional[bytes] = None):
        """Returns the payload to use (torn rules halve it) and raises
        per the schedule."""
        if self.dead:
            raise InjectedCrash(f"(dead) {op} {path}")
        self.ops.append((op, str(path)))
        for rule in self.rules:
            if not rule.matches(op, path):
                continue
            if rule.kind == "latency":
                time.sleep(rule.delay_s)
            elif rule.kind == "fail":
                raise rule.error or TransientStorageError(
                    f"injected transient failure: {op} {path}"
                )
            elif rule.kind == "torn":
                if data is not None:
                    # the torn half lands as a plain (non-claiming) write:
                    # a partial PUT never passes the claim precondition,
                    # but CAN clobber an overwrite target — which is why
                    # overwrite targets must be rebuildable (latestStable)
                    self._inner.write(path, data[: max(1, len(data) // 2)])
                self.dead = True
                raise InjectedCrash(f"torn write: {op} {path}")
            elif rule.kind == "crash":
                self.dead = True
                raise InjectedCrash(f"injected crash: {op} {path}")
        return data

    # -- seam ----------------------------------------------------------------
    def create_if_absent(self, path: str, data: bytes) -> bool:
        self._gate("create_if_absent", path, data)
        return self._inner.create_if_absent(path, data)

    def write(self, path: str, data: bytes, *, if_generation_match=None) -> None:
        self._gate("write", path, data)
        self._inner.write(path, data, if_generation_match=if_generation_match)

    def read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        self._gate("read", path)
        return self._inner.read(path, offset, length)

    def exists(self, path: str) -> bool:
        self._gate("exists", path)
        return self._inner.exists(path)

    def size(self, path: str) -> int:
        self._gate("size", path)
        return self._inner.size(path)

    def list(self, prefix: str) -> List[str]:
        self._gate("list", prefix)
        return self._inner.list(prefix)

    def delete(self, path: str) -> None:
        self._gate("delete", path)
        self._inner.delete(path)


class RecordingFileSystem(FaultInjectingFileSystem):
    """A fault filesystem with no rules: pure call journal. A clean run
    under it enumerates every (op, path) in order; the crash sweep then
    replays the same scenario once per mutating entry with a crash rule
    aimed at that call index."""

    def __init__(self, inner: FileSystem):
        super().__init__(inner, rules=[])


def crash_at(op: str, index_among_matching: int, path_contains: str = "") -> FaultRule:
    """Rule that kills the process at the ``index_among_matching``-th
    call of ``op`` (0-based among matching calls)."""
    return FaultRule(
        kind="crash", op=op, path_contains=path_contains, after=index_among_matching
    )
