"""Oversubscribed residency: the tier ladder that keeps tables larger than
the device budget on the device path, and the device-memory accounting
the residency caches share with the build.

Counterpart of ``hyperspace_tpu.residency``. The ladder

    resident -> compressed -> streaming -> host

has two levers: bit-packed planes (``ops/bitpack.py``), which multiply the
budget's capacity by the pack ratio, and the streaming tier
(``streaming.py``), whose planes stay in pinned host memory and pass
through a pair of device slabs window by window, so the budget is charged
two windows whatever the table's size. ``tiers.plan_tier`` is the one
procedure that picks a tier; ``slabs`` accounts the streaming build's
staged runs against the same budget.

The reference's ``residency/knobs.py`` reads the ``hyperspace.residency.*``
keys into process defaults that ``HYPERSPACE_TPU_RESIDENCY_*`` environment
variables override. This package reads conf per session and no
environment variable, so it has no such module: the keys are fields of
``config.ResidencyConf`` (``compression``, ``streaming``,
``window_rows``), passed to every residency call. The reference's
``forDelta`` key serves join residency and comes with it.
"""

from .tiers import TierPlan, plan_tier  # noqa: F401
