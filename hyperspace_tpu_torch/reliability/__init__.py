"""Reliability: so far only the retry policy the serve client backs off
with (``retry.RetryPolicy``). Error classification, leases, recovery, the
retrying file system, the doctor and fault injection come with the
reliability slice."""

from .retry import RetryPolicy  # noqa: F401
