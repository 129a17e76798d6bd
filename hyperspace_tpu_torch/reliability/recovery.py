"""Automatic crash recovery: roll an abandoned writer's transient state
back to the last stable entry — no human ``cancel()`` required.

The trigger is deliberately narrow. A transient head entry alone is NOT
evidence of a crash: an in-flight writer looks exactly like that, and an
in-process failure (exception out of ``op()``) marks its lease *aborted*
so an operator — who just saw the exception — keeps the reference's
manual-cancel contract. Only a lease that EXPIRED while still live
proves its writer died or stalled past its lease; that, and only that,
auto-rolls back:

    latest entry transient  +  lease abandoned  →  CancelAction.run()

The rollback reuses CancelAction wholesale: it writes CANCELLING then
the last stable state through the normal begin/end protocol, acquiring
the NEXT lease epoch with ``force=True`` — which tombstones the zombie's
record, so a stalled writer that wakes up later finds itself fenced at
``end()`` (lease.py). Two recoverers racing resolve through the same OCC
claim as everything else: the loser's ConcurrentModificationException is
swallowed as "someone else recovered it".

Recovery also sweeps the cheap crash litter it can prove orphaned:
``.{name}.tmp.{pid}.{rand}`` files that ``atomic_create``'s temp-then-link
leaves in the log directory when a writer dies between the temp write and
the link (doctor() reports the same files; the sweep is shared).

Entry points:
* ``maybe_auto_recover`` — one index, called from ``Action.run()`` before
  ``validate()`` (every modifying verb self-heals before refusing);
* ``recover_abandoned_indexes`` — a sweep over the whole system path,
  called on session attach (first catalog enumeration) and periodically
  by the query server's submit path (serve/server.py).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import List, Optional

from ..exceptions import ConcurrentModificationException, HyperspaceException
from ..telemetry.metrics import metrics
from .lease import LeaseManager

logger = logging.getLogger(__name__)


def sweep_orphan_tmp_files(log_dir, fs=None, min_age_s: float = 5.0) -> List[str]:
    """Delete ``.*.tmp.*`` leftovers in one log directory (a crashed
    atomic_create between temp-write and link). Returns swept names.

    Two guards against racing a LIVE writer's in-flight temp (whose
    lifetime is microseconds, but recovery runs exactly when a waiting
    writer may begin): files younger than ``min_age_s`` are skipped
    (unknowable age — no local stat — counts as young), and the POSIX
    claim path treats a vanished temp as a transient retry, not a
    failure (storage/filesystem.py), so even a mis-swept temp costs one
    retry, never a failed action."""
    import os

    from ..storage.filesystem import DEFAULT_FS

    fs = fs or DEFAULT_FS
    log_dir = str(log_dir)
    swept: List[str] = []
    try:
        names = fs.list(log_dir)
    except OSError:
        return swept
    now = time.time()
    for name in names:
        if name.startswith(".") and ".tmp." in name:
            try:
                age = now - os.stat(os.path.join(log_dir, name)).st_mtime
            except OSError:
                continue  # gone already, or no local stat surface
            if age < min_age_s:
                continue
            try:
                fs.delete(log_dir + "/" + name)
                swept.append(name)
            except OSError:
                continue
    if swept:
        metrics.incr("recovery.orphan_tmp_swept", len(swept))
    return swept


def maybe_auto_recover(
    log_manager,
    data_manager=None,
    conf=None,
) -> bool:
    """Roll back ``log_manager``'s index iff its head entry is transient
    AND its current lease is abandoned (expired, never released). Returns
    True when a rollback happened (by us or a concurrent recoverer).
    No-ops on stable heads, live leases, aborted leases (manual-cancel
    territory), and legacy indexes with no lease at all."""
    from ..actions import states

    if conf is not None and hasattr(conf, "auto_recovery_enabled"):
        if not conf.auto_recovery_enabled():
            return False
    index_path = getattr(log_manager, "index_path", None)
    fs = getattr(log_manager, "_fs", None)
    if index_path is None or fs is None:
        return False
    latest = log_manager.get_latest_log()
    if latest is None or latest.state in states.STABLE_STATES:
        return False
    lease = LeaseManager(index_path, fs).current()
    if lease is None or not lease.is_abandoned():
        return False

    from ..actions.metadata_actions import CancelAction

    try:
        CancelAction(log_manager, conf, data_manager=data_manager).run()
    except ConcurrentModificationException:
        # a concurrent recoverer (or a racing writer's cancel) got there
        # first; the index is being healed either way
        metrics.incr("recovery.rollback_race_lost")
    except HyperspaceException as e:
        if "stable state" in str(e):
            # someone recovered between our read and our cancel
            metrics.incr("recovery.rollback_race_lost")
        else:
            raise
    else:
        metrics.incr("recovery.auto_rollback")
        logger.warning(
            "auto-recovered index at %s: abandoned writer (lease epoch %s, "
            "owner %s) rolled back to last stable state",
            index_path,
            lease.epoch,
            lease.owner,
        )
    sweep_orphan_tmp_files(getattr(log_manager, "log_dir", Path(index_path)), fs)
    return True


def recover_abandoned_indexes(system_path, conf=None) -> int:
    """Sweep every index directory under ``system_path`` and auto-recover
    each abandoned one. Returns the number of indexes recovered."""
    from ..index.data_manager import IndexDataManagerImpl
    from ..index.log_manager import IndexLogManagerImpl

    root = Path(system_path)
    metrics.incr("recovery.sweep")
    if not root.is_dir():
        return 0
    recovered = 0
    for d in sorted(root.iterdir()):
        if not d.is_dir():
            continue
        try:
            mgr = IndexLogManagerImpl(d)
            if mgr.get_latest_id() is None:
                continue
            if maybe_auto_recover(
                mgr, data_manager=IndexDataManagerImpl(d), conf=conf
            ):
                recovered += 1
        except Exception:  # noqa: BLE001
            # per-index isolation: one damaged index directory must not
            # take down session attach / enumeration for every other
            # index — counted and logged, then the sweep continues
            metrics.incr("recovery.sweep_error")
            logger.warning(
                "recovery sweep failed for index at %s", d, exc_info=True
            )
            continue
    return recovered
