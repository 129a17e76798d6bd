"""Build-side device-memory slab accounting, shared with the residency
budget.

Counterpart of ``hyperspace_tpu.residency.slabs``. The device-resident
streaming build pins device memory outside the residency caches: up to
``runChunks`` staged sorted chunks awaiting their on-card run merge, and
the merge's working set. Those bytes come out of the same HBM the
residency budget (``hyperspace.torch.hbm.budgetMB``) governs, so:

* a build reserves its worst-case footprint here before staging its
  first chunk (``try_reserve``) and releases it at finalize or abort;
  a reservation is all or nothing;
* a reservation is capped at half the budget: the build may borrow
  headroom but never starve the serving caches. A build that needs more
  takes the per-chunk device path (counted
  ``build.device.staging_declined.budget``); it never moves to the CPU;
* the residency cache subtracts ``held_bytes()`` from its budget.

Pure byte bookkeeping: it holds no tensors.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..telemetry.metrics import metrics

# the build may reserve at most budget // this; the rest stays the
# serving caches' floor
_BUILD_FRACTION = 2

_lock = threading.Lock()
_held: Dict[str, int] = {}


def try_reserve(tag: str, nbytes: int, budget_bytes: int) -> bool:
    """Reserve ``nbytes`` of build headroom under ``tag`` (one tag per
    writer; re-reserving a live tag replaces its charge). False when the
    builds' total would pass half of ``budget_bytes``: the caller declines
    staging."""
    nbytes = max(0, int(nbytes))
    cap = int(budget_bytes) // _BUILD_FRACTION
    with _lock:
        others = sum(v for k, v in _held.items() if k != tag)
        if others + nbytes > cap:
            metrics.incr("build.device.slab_reserve_refused")
            return False
        _held[tag] = nbytes
        total = others + nbytes
    metrics.gauge("build.device.slab_reserved_bytes", total)
    return True


def release(tag: str) -> None:
    """Drop ``tag``'s reservation. Idempotent: abort and finalize may both
    call it."""
    with _lock:
        _held.pop(tag, None)
        total = sum(_held.values())
    metrics.gauge("build.device.slab_reserved_bytes", total)


def held_bytes() -> int:
    """Bytes builds hold now — what the residency cache subtracts from its
    budget."""
    with _lock:
        return sum(_held.values())
