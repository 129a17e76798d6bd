"""The scan gate's counters and the bucket heat.

Counterpart of the observability half of ``hyperspace_tpu.exec.scan_gate``
(its ``note_resident_bypass``, ``snapshot``, ``reset``, ``note_bucket_heat``
and ``bucket_heat``). The reference's gate routes each file's predicate
mask to the host or the device by measurement: a link probe and a timed
round per size class, for the TPU's link and compile costs. This package
routes no work to the host on its own, so the routing half (``decide``,
the ``record_*`` calls, the link probe and its disk memo) is not here: the
mask always runs on the card. ``snapshot`` is therefore empty.

What stays:

* ``note_resident_bypass(kind)`` counts ``scan.gate.resident_bypass_<kind>``
  wherever residency serves a query: ``plain``, ``compressed`` and
  ``streaming`` from the resident scan's tiers, ``hybrid`` from the
  base-plus-delta path, ``join`` from the resident join arms;
* the bucket heat: every run-file segment read counts the buckets a
  query touched under its index root, and the compactor
  (``index/compactor.py``) compacts the hottest buckets first.
"""

from __future__ import annotations

import threading

from ..telemetry.metrics import metrics


class ScanGate:
    """The gate's counters; no probe state (see the module docstring)."""

    def note_resident_bypass(self, kind: str) -> None:
        """Count a query residency served without the gate: ``kind`` is
        ``plain``, ``compressed``, ``streaming``, ``hybrid`` or ``join``."""
        metrics.incr(f"scan.gate.resident_bypass_{kind}")

    def snapshot(self) -> dict:
        """Probe evidence per size class: empty, no probe ladder runs."""
        return {}

    def reset(self) -> None:
        with _heat_lock:
            _bucket_heat.clear()


# Bucket heat, keyed by the index root a file set lives under: a plain
# bounded dict (the compactor needs the per-bucket order, not a metric).
_heat_lock = threading.Lock()
_bucket_heat: dict = {}  # index root -> {bucket: touch count}
_HEAT_ROOT_CAP = 64  # roots tracked; the oldest inserted goes past this


def note_bucket_heat(root, buckets) -> None:
    """Count a query's touch of ``buckets`` under ``root`` (an index
    directory; None is ignored)."""
    if root is None:
        return
    root = str(root)
    with _heat_lock:
        per = _bucket_heat.get(root)
        if per is None:
            if len(_bucket_heat) >= _HEAT_ROOT_CAP:
                _bucket_heat.pop(next(iter(_bucket_heat)))
            per = _bucket_heat[root] = {}
        for b in buckets:
            b = int(b)
            per[b] = per.get(b, 0) + 1


def bucket_heat(root) -> dict:
    """A copy of the touch counts under ``root`` (empty when never seen)."""
    with _heat_lock:
        return dict(_bucket_heat.get(str(root), ()))


scan_gate = ScanGate()
