"""hslint rule registry: one instance per rule, ordered by code.

Adding a rule = add a module here and append an instance to REGISTRY;
``python -m hyperspace_tpu_torch.tools.lint --list-rules`` reads this
list. Every rule here is a per-file pass over one module's AST. HS001
and HS007 carry the torch/CUDA device model (their modules' docstrings
give it); the others are the reference analyzer's rules as written.
"""

from __future__ import annotations

from typing import List

from ..core import Rule
from .hs001_host_sync import HostSyncRule
from .hs002_lock_blocking import LockBlockingRule
from .hs003_path_keys import PathKeyRule
from .hs004_swallowed_exceptions import SwallowedExceptionRule
from .hs005_nondeterministic_hashing import NondeterministicHashRule
from .hs006_unbounded_cache import UnboundedCacheRule
from .hs007_unfenced_device_timing import UnfencedDeviceTimingRule
from .hs008_raw_metadata_write import RawMetadataWriteRule
from .hs014_metric_names import MetricNameRule

REGISTRY: List[Rule] = [
    HostSyncRule(),
    LockBlockingRule(),
    PathKeyRule(),
    SwallowedExceptionRule(),
    NondeterministicHashRule(),
    UnboundedCacheRule(),
    UnfencedDeviceTimingRule(),
    RawMetadataWriteRule(),
    MetricNameRule(),
]

__all__ = [
    "REGISTRY",
    "HostSyncRule",
    "LockBlockingRule",
    "PathKeyRule",
    "SwallowedExceptionRule",
    "NondeterministicHashRule",
    "UnboundedCacheRule",
    "UnfencedDeviceTimingRule",
    "RawMetadataWriteRule",
    "MetricNameRule",
]
