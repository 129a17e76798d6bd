"""reliability/: crash-consistent lifecycle machinery.

Counterpart of ``hyperspace_tpu.reliability`` (its chaos proxy for the
query router waits for the multi-device slice). Layered over the
FileSystem seam and the Action protocol:

* ``retry``    — classified storage errors, bounded-backoff RetryPolicy
                 with deterministic jitter, RetryingFileSystem decorator;
* ``lease``    — heartbeated writer leases with epoch fencing next to
                 the operation log (the same on-disk records);
* ``recovery`` — automatic rollback of abandoned writers (transient log
                 head + expired lease) and crash-litter sweeping;
* ``doctor``   — fsck over index directories (log-chain integrity, data
                 presence, orphan reporting/vacuum), also a command line:
                 ``python -m hyperspace_tpu_torch.reliability.doctor PATH``;
* ``faults``   — deterministic fault injection on the storage seam.
"""

from .doctor import DoctorReport, Issue, doctor
from .faults import (
    FaultInjectingFileSystem,
    FaultRule,
    InjectedCrash,
    RecordingFileSystem,
    crash_at,
)
from .lease import DEFAULT_LEASE_DURATION_S, HeldLease, LeaseManager, LeaseRecord
from .recovery import (
    maybe_auto_recover,
    recover_abandoned_indexes,
    sweep_orphan_tmp_files,
)
from .retry import (
    DEFAULT_RETRY_POLICY,
    RetryingFileSystem,
    RetryPolicy,
    call_with_retries,
    classify_error,
    wrap_with_retries,
)

__all__ = [
    "DEFAULT_LEASE_DURATION_S",
    "DEFAULT_RETRY_POLICY",
    "DoctorReport",
    "FaultInjectingFileSystem",
    "FaultRule",
    "HeldLease",
    "InjectedCrash",
    "Issue",
    "LeaseManager",
    "LeaseRecord",
    "RecordingFileSystem",
    "RetryPolicy",
    "RetryingFileSystem",
    "call_with_retries",
    "classify_error",
    "crash_at",
    "doctor",
    "maybe_auto_recover",
    "recover_abandoned_indexes",
    "sweep_orphan_tmp_files",
    "wrap_with_retries",
]
