"""Exception types for the TPU-native Hyperspace framework.

Parity: com/microsoft/hyperspace/HyperspaceException.scala:18 and
com/microsoft/hyperspace/actions/NoChangesException.scala:28 in the reference.
"""


class HyperspaceException(Exception):
    """Generic framework error (reference: HyperspaceException.scala:18)."""


class NoChangesException(HyperspaceException):
    """Marker raised by maintenance actions when there is nothing to do; the
    action protocol treats it as a successful no-op
    (reference: actions/NoChangesException.scala:28, Action.scala:97-99)."""


class ConcurrentModificationException(HyperspaceException):
    """Raised when an action loses the optimistic-concurrency race on the
    operation log (reference: Action.scala:78-80, "Could not acquire proper
    state" on a failed write_log of the transient entry)."""


class LeaseFencedError(ConcurrentModificationException):
    """Raised when a writer discovers it has been fenced: its lease epoch
    was superseded (the writer stalled past its lease and a newer writer
    — or crash recovery — claimed the next epoch). The fenced writer's
    ``end()`` must refuse to commit (reliability/lease.py)."""


class DeviceUnavailableError(HyperspaceException):
    """The device probe proved the card unreachable (its first touch hung
    or raised; ``utils/deviceprobe.py``). Where the reference routes such a
    query to its host engine, this package raises: every engine path runs
    on the card. ``reason`` carries the probe's verdict."""

    def __init__(self, reason: str):
        super().__init__(f"device unavailable: {reason}")
        self.reason = reason


class KernelBuildError(HyperspaceException):
    """A hand-written kernel failed to build or load (``nvcc`` missing or
    failing, the library refusing to load, a parameter block that does not
    match its packer). The device-loss degrade never catches it: a kernel
    that cannot build is a fault of the program, not of the card."""


class KernelLaunchError(HyperspaceException, RuntimeError):
    """A kernel's launch returned a CUDA error. A ``RuntimeError``, as
    torch's own CUDA errors are: a resident arm that sees one drops its
    table and answers through the per-file route (exec/scan.py)."""


# -- storage error taxonomy (reliability/retry.py classifies against these) ---
class StorageError(HyperspaceException):
    """Base for classified storage failures on the FileSystem seam."""


class TransientStorageError(StorageError):
    """A failure worth retrying: flaky RPC, timeout, connection reset,
    throttling. The RetryingFileSystem retries these with bounded
    exponential backoff; everything else propagates immediately."""


class PermanentStorageError(StorageError):
    """A failure retrying cannot fix: bad request, auth, or a protocol
    *result* misdelivered as an error. Never retried."""


class PreconditionFailedError(PermanentStorageError):
    """A generation-preconditioned write lost: the object changed under
    the writer (GCS 412 outside the create_if_absent claim path). This is
    how a fenced/stale writer's overwrite is refused instead of silently
    clobbering newer state (storage/filesystem.py write preconditions)."""
