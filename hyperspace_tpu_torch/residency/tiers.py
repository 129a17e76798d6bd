"""The one tier-planning procedure of the residency ladder.

Counterpart of ``hyperspace_tpu.residency.tiers``. A candidate table is
sized here, not by comparing raw bytes with the budget inline. The ladder,
cheapest at query time first:

  resident    raw int32 planes fit the budget;
  compressed  bit-packed planes (``ops/bitpack.py``) fit where raw did
              not; the budget is charged the packed bytes;
  streaming   even the packed planes exceed the budget: pinned host
              planes staged through a pair of device slabs, so the charge
              is two windows whatever the table's size;
  host        streaming off, or the slab pair itself does not fit.

Compression ``force`` skips the resident rung for packable columns.

Budget claimants are the non-residency holders of budget-charged bytes
(the reference's result caches): each exposes ``held_bytes() -> int`` and
``shed(nbytes) -> int``, and the eviction ladder sheds them first. The
serve tier's result cache registers here (``compile/result_cache.py``);
the reference's router-level twin comes with multi-device.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..config import ResidencyConf
from ..ops.bitpack import PackSpec
from ..telemetry.metrics import metrics

_CLAIMANTS_LOCK = threading.Lock()
_CLAIMANTS: Dict[str, object] = {}


def register_claimant(name: str, claimant: object) -> None:
    with _CLAIMANTS_LOCK:
        _CLAIMANTS[name] = claimant


def claimant_bytes() -> int:
    """Total budget-charged bytes held by registered claimants."""
    with _CLAIMANTS_LOCK:
        holders = list(_CLAIMANTS.values())
    total = 0
    for c in holders:
        try:
            total += int(c.held_bytes())
        except Exception:  # noqa: BLE001 - one claimant must not wedge budget math
            metrics.incr("residency.claimant.error")
    return total


def shed_claimants(nbytes: int) -> int:
    """Free at least ``nbytes`` of claimant-held budget. Returns the bytes
    actually freed (may fall short: the caches then go on down their own
    ladder, deltas then tables)."""
    if nbytes <= 0:
        return 0
    with _CLAIMANTS_LOCK:
        holders = list(_CLAIMANTS.values())
    freed = 0
    for c in holders:
        if freed >= nbytes:
            break
        try:
            freed += int(c.shed(nbytes - freed))
        except Exception:  # noqa: BLE001 - one claimant must not wedge eviction
            metrics.incr("residency.claimant.error")
    return freed


@dataclass
class TierPlan:
    """Outcome of plan_tier. ``specs`` maps column name -> PackSpec for
    every column the chosen tier packs (empty for tier "resident");
    ``window_rows`` is set for tier "streaming" (before padding)."""

    tier: str  # "resident" | "compressed" | "streaming" | "host"
    reason: str = ""
    specs: Dict[str, PackSpec] = field(default_factory=dict)
    window_rows: int = 0
    raw_bytes: int = 0
    packed_bytes: int = 0


def plan_tier(
    raw_plane_bytes: int,
    budget_bytes: int,
    pack_specs: Optional[Dict[str, PackSpec]] = None,
    unpacked_plane_bytes: int = 0,
    side_bytes: int = 0,
    streaming_ok: bool = True,
    shard_count: int = 1,
    conf: ResidencyConf = ResidencyConf(),
) -> TierPlan:
    """Pick the cheapest tier that fits ``budget_bytes``.

    ``raw_plane_bytes``      device bytes of every plane stored raw;
    ``pack_specs``           per-column PackSpec of the packable columns;
    ``unpacked_plane_bytes`` device bytes of the planes that stay raw
                             under compression;
    ``side_bytes``           budget-charged non-plane bytes (host vocab
                             heaps) that ride along at every tier;
    ``streaming_ok``         caller-side eligibility (delta regions pass
                             False: streaming is a base-table tier);
    ``shard_count``          device shards each spec materializes on;
    ``conf``                 the session's ``compression``, ``streaming``
                             and ``window_rows``.
    """
    mode = conf.compression
    specs = dict(pack_specs or {})
    packed_bytes = (
        sum(s.packed_nbytes for s in specs.values()) * max(shard_count, 1)
        + unpacked_plane_bytes
    )
    force = mode == "force" and bool(specs)
    if raw_plane_bytes + side_bytes <= budget_bytes and not force:
        return TierPlan("resident", "raw fits", {}, 0, raw_plane_bytes, packed_bytes)
    if mode != "off" and specs and packed_bytes + side_bytes <= budget_bytes:
        return TierPlan(
            "compressed",
            "compression forced" if force else "packed fits",
            specs,
            0,
            raw_plane_bytes,
            packed_bytes,
        )
    if streaming_ok and conf.streaming != "off":
        return TierPlan(
            "streaming",
            "oversubscribed",
            specs if mode != "off" else {},
            conf.window_rows,
            raw_plane_bytes,
            packed_bytes,
        )
    return TierPlan(
        "host",
        "streaming disabled" if streaming_ok else "tier ineligible",
        {},
        0,
        raw_plane_bytes,
        packed_bytes,
    )
