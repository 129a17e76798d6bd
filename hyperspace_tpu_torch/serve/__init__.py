"""Concurrent multi-tenant query serving: per-tenant admission quotas,
weighted-fair scheduling, micro-batched resident scans, plan caching and
snapshot-pinned reads.

Counterpart of ``hyperspace_tpu.serve`` (single device). Entry points:
``session.serve()`` / ``session.submit(df, tenant=...)``, or a
``QueryServer`` built directly; ``serve.client.submit_with_retry`` adds
jittered-backoff retry on admission rejection.
"""

from .client import submit_with_retry
from .plan_cache import PlanCache, plan_signature
from .server import (
    AdmissionRejected,
    DeadlineExceeded,
    QueryCancelled,
    QueryServer,
    QueryTicket,
    ServeConfig,
    ServerClosed,
)
from .tenancy import DEFAULT_TENANT, CircuitBreaker, TenantPolicy, TenantState

__all__ = [
    "AdmissionRejected",
    "CircuitBreaker",
    "DEFAULT_TENANT",
    "DeadlineExceeded",
    "PlanCache",
    "QueryCancelled",
    "QueryServer",
    "QueryTicket",
    "ServeConfig",
    "ServerClosed",
    "TenantPolicy",
    "TenantState",
    "plan_signature",
    "submit_with_retry",
]
