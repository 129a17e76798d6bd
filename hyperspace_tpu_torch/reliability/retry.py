"""Storage retry: error classification, bounded backoff with deterministic
jitter, and a RetryingFileSystem decorator over the FileSystem seam.

Counterpart of ``hyperspace_tpu.reliability.retry``; the serve client
(``serve/client.py``) backs off with the same ``RetryPolicy``.

The operation log's whole crash-consistency story assumed every storage
RPC either succeeds or fails *once*: a single flaky object-store call
failed an entire index build. This module makes the seam survive flaky
storage without changing its semantics:

* **classification** — ``classify_error`` sorts exceptions into
  ``transient`` (retry) and ``permanent`` (propagate now). Protocol
  *results* (FileNotFoundError from read, False from create_if_absent)
  are never errors and never retried; precondition failures are
  permanent by construction (retrying a lost race cannot win it).
* **RetryPolicy** — bounded exponential backoff with *deterministic*
  jitter: the jitter factor is a stable hash of (op, path, attempt), so
  a replayed fault schedule produces byte-identical timing decisions
  (a crash sweep depends on this) while distinct paths still spread
  their retries.
* **RetryingFileSystem** — wraps any backend; each op runs under the
  policy with per-op retry metrics (``storage.retry.<op>``). The one
  subtlety is ``create_if_absent``: a transient failure may have landed
  AFTER the store applied the claim, so a retry that observes "already
  exists" runs self-win detection (read-back byte compare) before
  reporting the claim lost — the same recovery the GCS client performs,
  hoisted to the seam so every backend gets it. This leans on the seam's
  documented writer-unique-payload contract.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional, TypeVar

from ..exceptions import (
    HyperspaceException,
    PermanentStorageError,
    TransientStorageError,
)
from ..telemetry.metrics import metrics
from ..storage.filesystem import FileSystem

T = TypeVar("T")

TRANSIENT = "transient"
PERMANENT = "permanent"

# OS-level results that are protocol answers, not storage flakiness
_PERMANENT_OS = (
    FileNotFoundError,
    FileExistsError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
)


def classify_error(exc: BaseException) -> str:
    """``transient`` (worth retrying) or ``permanent`` (propagate now)."""
    if isinstance(exc, TransientStorageError):
        return TRANSIENT
    if isinstance(exc, PermanentStorageError):
        return PERMANENT
    if isinstance(exc, HyperspaceException):
        return PERMANENT  # framework errors are never storage flakiness
    if isinstance(exc, _PERMANENT_OS):
        return PERMANENT
    if isinstance(exc, (TimeoutError, ConnectionError, InterruptedError)):
        return TRANSIENT
    if isinstance(exc, OSError):
        # EIO / ESTALE / unreachable-store wrappers (gcs.py raises OSError
        # for exhausted HTTP retries and socket failures)
        return TRANSIENT
    return PERMANENT


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff. ``max_attempts`` counts the first try:
    ``max_attempts=1`` disables retrying entirely."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25  # +/- fraction of the computed delay

    def delay_for(self, attempt: int, seed_key: str = "") -> float:
        """Delay before retry number ``attempt`` (1-based). Jitter is a
        deterministic function of (seed_key, attempt): replaying a fault
        schedule replays the exact timing, while distinct ops/paths still
        de-synchronize their backoff."""
        base = min(self.base_delay_s * (2 ** (attempt - 1)), self.max_delay_s)
        if not self.jitter:
            return base
        h = zlib.crc32(f"{seed_key}#{attempt}".encode("utf-8"))
        # crc32 -> [0,1) -> [-jitter, +jitter]
        frac = (h / 0xFFFFFFFF) * 2.0 - 1.0
        return max(0.0, base * (1.0 + self.jitter * frac))


DEFAULT_RETRY_POLICY = RetryPolicy()


def call_with_retries(
    fn: Callable[[], T],
    *,
    op: str,
    key: str = "",
    policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``fn`` under ``policy``: transient failures retry with backoff
    and metrics; permanent ones (and BaseExceptions like an injected
    crash) propagate immediately. The last transient failure, once
    attempts are exhausted, propagates with ``storage.retry.exhausted``
    incremented so dashboards separate "slow but fine" from "down"."""
    policy = policy or DEFAULT_RETRY_POLICY
    attempts = max(1, policy.max_attempts)
    last: Optional[Exception] = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classified right below
            if classify_error(e) != TRANSIENT or attempt == attempts:
                if classify_error(e) == TRANSIENT:
                    metrics.incr("storage.retry.exhausted")
                raise
            last = e
            metrics.incr("storage.retry.attempts")
            metrics.incr(f"storage.retry.{op}")
            sleep(policy.delay_for(attempt, seed_key=f"{op}:{key}"))
    raise last  # unreachable; keeps type checkers honest


class RetryingFileSystem(FileSystem):
    """FileSystem decorator: every op runs under a RetryPolicy.

    Unknown attributes delegate to the wrapped backend, so capability
    probes (``generation``, ``supports_generation_preconditions``) and
    test hooks keep working through the wrapper."""

    def __init__(self, inner: FileSystem, policy: Optional[RetryPolicy] = None):
        self._inner = inner
        self._policy = policy or DEFAULT_RETRY_POLICY

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def supports_generation_preconditions(self) -> bool:
        # explicit, not via __getattr__: the base class defines this as a
        # class attribute, which would shadow the delegation and silently
        # disable precondition fencing on generation backends
        return self._inner.supports_generation_preconditions

    def _run(self, op: str, path: str, fn: Callable[[], T]) -> T:
        return call_with_retries(fn, op=op, key=str(path), policy=self._policy)

    # -- seam ----------------------------------------------------------------
    def create_if_absent(self, path: str, data: bytes) -> bool:
        data = bytes(data)
        policy = self._policy
        attempts = max(1, policy.max_attempts)
        retried = False
        for attempt in range(1, attempts + 1):
            try:
                won = self._inner.create_if_absent(path, data)
            except Exception as e:  # noqa: BLE001 - classified right below
                if classify_error(e) != TRANSIENT or attempt == attempts:
                    if classify_error(e) == TRANSIENT:
                        metrics.incr("storage.retry.exhausted")
                    raise
                retried = True
                metrics.incr("storage.retry.attempts")
                metrics.incr("storage.retry.create_if_absent")
                time.sleep(
                    policy.delay_for(attempt, seed_key=f"create_if_absent:{path}")
                )
                continue
            if not won and retried:
                # self-win detection: the failed attempt may have landed
                # before its error surfaced, making OUR claim the existing
                # object. Payloads are writer-unique by seam contract, so
                # byte equality decides ownership.
                try:
                    if self._inner.read(path) == data:
                        metrics.incr("storage.retry.claim_self_win")
                        return True
                except FileNotFoundError:
                    return False
            return won
        raise AssertionError("unreachable")

    def write(self, path: str, data: bytes, *, if_generation_match=None) -> None:
        # a preconditioned retry can observe its OWN first application as
        # a generation mismatch; PreconditionFailedError is permanent so
        # the loop never retries a lost race — callers that pass a
        # precondition handle the mismatch (lease heartbeat stops).
        self._run(
            "write",
            path,
            lambda: self._inner.write(
                path, data, if_generation_match=if_generation_match
            ),
        )

    def read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        return self._run("read", path, lambda: self._inner.read(path, offset, length))

    def exists(self, path: str) -> bool:
        return self._run("exists", path, lambda: self._inner.exists(path))

    def size(self, path: str) -> int:
        return self._run("size", path, lambda: self._inner.size(path))

    def list(self, prefix: str) -> List[str]:
        return self._run("list", prefix, lambda: self._inner.list(prefix))

    def delete(self, path: str) -> None:
        self._run("delete", path, lambda: self._inner.delete(path))


def wrap_with_retries(
    fs: FileSystem, policy: Optional[RetryPolicy] = None
) -> FileSystem:
    """Idempotent wrap: an already-retrying fs — the decorator itself,
    or a backend with its own internal retry loop (GcsFileSystem's
    per-RPC retries) — is returned as-is. Double wrapping would square
    the attempt budget and compound the backoff during an outage."""
    if isinstance(fs, RetryingFileSystem):
        return fs
    if getattr(fs, "has_internal_retries", False):
        return fs
    return RetryingFileSystem(fs, policy)
