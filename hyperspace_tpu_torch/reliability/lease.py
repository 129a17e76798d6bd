"""Writer leases with epoch fencing over the FileSystem seam.

Counterpart of ``hyperspace_tpu.reliability.lease``, with the same epoch
files: either package reads, expires, recovers and fences a lease the
other wrote. Every clock reading goes through ``_now_ms``.

The operation log's OCC makes *commits* linearizable but says nothing
about writer *liveness*: a writer that crashed between ``begin()`` and
``end()`` wedged the index until a human called ``cancel()``, and a
writer that merely stalled could wake up later and race a recovery that
had already rolled it back. Leases close both holes:

    <index>/_hyperspace_lease/epoch-<N>      JSON lease record

* **acquisition** — the claim is ``create_if_absent`` on the NEXT epoch
  file (``max existing + 1``): the same linearizable primitive as the
  log, so exactly one concurrent acquirer wins. An acquirer may only
  claim when the current epoch is released, aborted, or expired — a live
  lease held by another owner raises ConcurrentModificationException
  (``force=True``, used by cancel/recovery, fences a live holder
  instead).
* **heartbeat** — a daemon thread re-writes the holder's epoch file
  extending ``expires_at``; a writer that stalls longer than its lease
  duration simply stops being live. On generation-preconditioned
  backends the heartbeat write carries ``if_generation_match`` — if
  recovery tombstoned the record, the zombie's heartbeat gets a
  classified PreconditionFailedError instead of silently resurrecting
  the lease.
* **fencing** — epochs only grow. Before committing, a writer checks
  that no higher epoch exists (``check_fenced``); a zombie that slept
  through its expiry finds epoch N+1 on disk and its ``end()`` refuses
  with LeaseFencedError. Old epoch files are tombstones, kept so epoch
  numbers never regress; doctor() garbage-collects all but the latest.

Release states: ``released`` (clean commit), ``aborted`` (the action
failed in-process — an operator saw the exception; the transient log
entry stays for *manual* cancel, matching the reference's semantics).
Only an *expired, unreleased* lease is evidence of a dead writer, and
only that evidence triggers automatic rollback (recovery.py).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Optional

from ..exceptions import (
    ConcurrentModificationException,
    LeaseFencedError,
    PreconditionFailedError,
)
from ..telemetry.metrics import metrics
from ..utils import json_utils

LEASE_DIR = "_hyperspace_lease"
EPOCH_PREFIX = "epoch-"

DEFAULT_LEASE_DURATION_S = 60.0

STATE_LIVE = "live"
STATE_RELEASED = "released"
STATE_ABORTED = "aborted"
STATE_FENCED = "fenced"

_TERMINAL_STATES = frozenset({STATE_RELEASED, STATE_ABORTED, STATE_FENCED})


def _now_ms() -> int:
    return int(time.time() * 1000)


@dataclass
class LeaseRecord:
    """One epoch file's contents."""

    epoch: int
    owner: str
    state: str
    acquired_at_ms: int
    expires_at_ms: int
    duration_ms: int
    action: str = ""

    def to_json(self) -> str:
        return json_utils.to_json(
            {
                "epoch": self.epoch,
                "owner": self.owner,
                "state": self.state,
                "acquiredAtMs": self.acquired_at_ms,
                "expiresAtMs": self.expires_at_ms,
                "durationMs": self.duration_ms,
                "action": self.action,
            }
        )

    @classmethod
    def from_json(cls, raw: str) -> "LeaseRecord":
        d = json_utils.from_json(raw)
        return cls(
            epoch=int(d["epoch"]),
            owner=str(d["owner"]),
            state=str(d.get("state", STATE_LIVE)),
            acquired_at_ms=int(d.get("acquiredAtMs", 0)),
            expires_at_ms=int(d.get("expiresAtMs", 0)),
            duration_ms=int(d.get("durationMs", 0)),
            action=str(d.get("action", "")),
        )

    @property
    def is_terminal(self) -> bool:
        return self.state in _TERMINAL_STATES

    def is_live(self, now_ms: Optional[int] = None) -> bool:
        if self.is_terminal:
            return False
        return (now_ms if now_ms is not None else _now_ms()) < self.expires_at_ms

    def is_abandoned(self, now_ms: Optional[int] = None) -> bool:
        """Expired without ever being released/aborted: the writer died
        (or stalled past its lease). THE trigger for auto-recovery."""
        if self.is_terminal:
            return False
        return (now_ms if now_ms is not None else _now_ms()) >= self.expires_at_ms


class LeaseManager:
    """Lease protocol over one index directory. Stateless between calls
    except for the fs handle; every decision re-reads the epoch chain."""

    def __init__(self, index_path, fs):
        self._lease_dir = str(index_path) + os.sep + LEASE_DIR
        self._fs = fs

    @property
    def lease_dir(self) -> str:
        return self._lease_dir

    def _path_of(self, epoch: int) -> str:
        return self._lease_dir + os.sep + f"{EPOCH_PREFIX}{epoch}"

    def epochs(self) -> list:
        out = []
        for name in self._fs.list(self._lease_dir):
            if name.startswith(EPOCH_PREFIX) and name[len(EPOCH_PREFIX):].isdigit():
                out.append(int(name[len(EPOCH_PREFIX):]))
        return sorted(out)

    def read(self, epoch: int) -> Optional[LeaseRecord]:
        try:
            raw = self._fs.read(self._path_of(epoch))
        except (FileNotFoundError, IsADirectoryError):
            return None
        try:
            return LeaseRecord.from_json(raw.decode("utf-8"))
        except (ValueError, KeyError, TypeError):
            # a torn lease write is NOT fatal to the protocol: an
            # unreadable record cannot prove liveness, so it counts as
            # abandoned at its epoch (doctor reports it; recovery may
            # fence past it)
            metrics.incr("lease.corrupt_record")
            return LeaseRecord(
                epoch=epoch, owner="?", state=STATE_LIVE,
                acquired_at_ms=0, expires_at_ms=0, duration_ms=0,
            )

    def current(self) -> Optional[LeaseRecord]:
        """The highest-epoch lease record, or None if no lease was ever
        taken (legacy index: pre-lease writers, hand-written entries)."""
        epochs = self.epochs()
        return self.read(epochs[-1]) if epochs else None

    # -- acquisition ---------------------------------------------------------
    def acquire(
        self,
        *,
        owner: Optional[str] = None,
        duration_s: float = DEFAULT_LEASE_DURATION_S,
        action: str = "",
        force: bool = False,
    ) -> "HeldLease":
        """Claim the next epoch. Raises ConcurrentModificationException if
        the current epoch is live and held by someone else (unless
        ``force`` — cancel/recovery's break-glass, which fences the live
        holder by tombstoning its record and claiming over it)."""
        owner = owner or f"{os.getpid()}-{uuid.uuid4().hex[:12]}"
        cur = self.current()
        if cur is not None and cur.is_live():
            if not force:
                raise ConcurrentModificationException(
                    f"Could not acquire writer lease: epoch {cur.epoch} is "
                    f"held by {cur.owner} until "
                    f"{cur.expires_at_ms} (another writer is in flight)."
                )
            self._tombstone(cur, STATE_FENCED)
            metrics.incr("lease.forced_fence")
        next_epoch = (cur.epoch if cur is not None else 0) + 1
        now = _now_ms()
        record = LeaseRecord(
            epoch=next_epoch,
            owner=owner,
            state=STATE_LIVE,
            acquired_at_ms=now,
            expires_at_ms=now + int(duration_s * 1000),
            duration_ms=int(duration_s * 1000),
            action=action,
        )
        if not self._fs.create_if_absent(
            self._path_of(next_epoch), record.to_json().encode("utf-8")
        ):
            # another acquirer claimed this epoch between our read and our
            # claim — the race loss the log's begin() maps to CME
            raise ConcurrentModificationException(
                f"Could not acquire writer lease: epoch {next_epoch} was "
                "claimed concurrently."
            )
        metrics.incr("lease.acquired")
        return HeldLease(self, record, duration_s)

    def _tombstone(self, record: LeaseRecord, state: str) -> None:
        """Overwrite ``record``'s epoch file with a terminal state. On
        generation backends the write is preconditioned so a concurrent
        heartbeat and a tombstone cannot both win silently."""
        record.state = state
        data = record.to_json().encode("utf-8")
        path = self._path_of(record.epoch)
        if getattr(self._fs, "supports_generation_preconditions", False):
            gen = self._fs.generation(path)
            try:
                self._fs.write(path, data, if_generation_match=gen)
            except PreconditionFailedError:
                # the holder heartbeated between our read and our write;
                # retry once against the new generation — epochs only move
                # to terminal states through this method, so losing twice
                # means another fencer got there first (same outcome)
                try:
                    self._fs.write(
                        path, data, if_generation_match=self._fs.generation(path)
                    )
                except PreconditionFailedError:
                    pass
        else:
            self._fs.write(path, data)

    # -- fencing -------------------------------------------------------------
    def check_fenced(self, epoch: int) -> None:
        """Raise LeaseFencedError if any epoch newer than ``epoch`` exists
        or the record at ``epoch`` was tombstoned by someone else."""
        epochs = self.epochs()
        if epochs and epochs[-1] > epoch:
            metrics.incr("lease.fenced_writer_refused")
            raise LeaseFencedError(
                f"Writer lease epoch {epoch} was fenced by epoch "
                f"{epochs[-1]}; refusing to commit (the index was "
                "recovered or claimed by a newer writer)."
            )
        rec = self.read(epoch)
        if rec is not None and rec.state == STATE_FENCED:
            metrics.incr("lease.fenced_writer_refused")
            raise LeaseFencedError(
                f"Writer lease epoch {epoch} was tombstoned as fenced; "
                "refusing to commit."
            )


class HeldLease:
    """A granted lease: heartbeats in the background until released.

    ``release()``/``abort()`` are idempotent and best-effort on storage
    errors (a crash during release just leaves the lease to expire)."""

    def __init__(self, manager: LeaseManager, record: LeaseRecord, duration_s: float):
        self._manager = manager
        self.record = record
        self._duration_s = duration_s
        self._generation = None
        fs = manager._fs
        if getattr(fs, "supports_generation_preconditions", False):
            self._generation = fs.generation(manager._path_of(record.epoch))
        self._stop = threading.Event()
        self._fenced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        interval = max(duration_s / 3.0, 0.01)
        self._thread = threading.Thread(
            target=self._heartbeat_loop,
            args=(interval,),
            daemon=True,
            name=f"hyperspace-lease-{record.epoch}",
        )
        self._thread.start()

    @property
    def epoch(self) -> int:
        return self.record.epoch

    @property
    def fenced(self) -> bool:
        return self._fenced.is_set()

    def _heartbeat_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self._extend()
            except PreconditionFailedError:
                # someone tombstoned our record: we are fenced. Stop
                # heartbeating — resurrecting the lease would un-fence us.
                metrics.incr("lease.heartbeat_fenced")
                self._fenced.set()
                return
            except Exception:  # noqa: BLE001
                # counted, not raised: a heartbeat may miss a beat on
                # storage flake and catch the next one
                metrics.incr("lease.heartbeat_error")
            except BaseException:  # noqa: BLE001
                # a BaseException out of storage (simulated process death
                # in a crash sweep, interpreter teardown) ends the
                # heartbeat: the lease is left to expire — which is
                # exactly what a dead writer's lease must do
                metrics.incr("lease.heartbeat_dead")
                return

    def _extend(self) -> None:
        rec = self.record
        rec.expires_at_ms = _now_ms() + rec.duration_ms
        data = rec.to_json().encode("utf-8")
        path = self._manager._path_of(rec.epoch)
        if self._generation is not None:
            self._manager._fs.write(path, data, if_generation_match=self._generation)
            self._generation = self._manager._fs.generation(path)
        else:
            cur = self._manager.read(rec.epoch)
            if cur is not None and (cur.owner != rec.owner or cur.is_terminal):
                raise PreconditionFailedError(
                    f"lease epoch {rec.epoch} no longer ours"
                )
            self._manager._fs.write(path, data)
        metrics.incr("lease.heartbeat")

    def check_fenced(self) -> None:
        if self._fenced.is_set():
            metrics.incr("lease.fenced_writer_refused")
            raise LeaseFencedError(
                f"Writer lease epoch {self.record.epoch} was tombstoned "
                "while held; refusing to commit."
            )
        self._manager.check_fenced(self.record.epoch)

    def _finish(self, state: str) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self.record.is_terminal:
            return
        try:
            self._manager._tombstone(self.record, state)
        except Exception:  # noqa: BLE001
            # counted, not raised: an unreleased lease simply expires
            # (that is the whole point of leases)
            metrics.incr("lease.release_error")

    def release(self) -> None:
        self._finish(STATE_RELEASED)

    def abort(self) -> None:
        self._finish(STATE_ABORTED)
