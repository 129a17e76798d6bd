"""hslint rule registry: one instance per rule, ordered by code.

Adding a rule = add a module here and append an instance to REGISTRY;
``python -m hyperspace_tpu_torch.tools.lint --list-rules`` reads this
list. HS001-HS008 and HS014 are per-file passes; HS009-HS013 are project
rules (subclasses of ``ProjectRule``) running on the whole-program model
of ``analysis/project.py``. HS001 and HS007 carry the torch/CUDA device
model (their modules' docstrings give it), and the project model's
device-dispatch endpoint, which HS011 follows, reads HS007's lists; the
others are the reference analyzer's rules as written.
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
from .hs009_lock_order import LockOrderRule
from .hs010_guarded_fields import GuardedFieldRule
from .hs011_interproc_blocking import InterprocBlockingRule
from .hs012_residency_fence import ResidencyFenceRule
from .hs013_config_keys import ConfigKeyRule
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
    LockOrderRule(),
    GuardedFieldRule(),
    InterprocBlockingRule(),
    ResidencyFenceRule(),
    ConfigKeyRule(),
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
    "LockOrderRule",
    "GuardedFieldRule",
    "InterprocBlockingRule",
    "ResidencyFenceRule",
    "ConfigKeyRule",
    "MetricNameRule",
]
