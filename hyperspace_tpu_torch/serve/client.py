"""Client-side submit helper: jittered-backoff retry on admission
rejection.

Counterpart of ``hyperspace_tpu.serve.client``. ``AdmissionRejected`` is
backpressure, not failure: the server says how long the tenant's backlog
plausibly needs to drain (``retry_after_s``). A fleet of clients that all
sleep exactly that long re-arrives as one herd, so the delay here is the
larger of the server's estimate and a deterministically jittered
exponential backoff (``reliability/retry.py:RetryPolicy``), seeded with
the submitted DataFrame's identity so same-tenant clients spread out.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..reliability.retry import RetryPolicy
from ..telemetry.metrics import metrics
from .server import AdmissionRejected, QueryTicket
from .tenancy import DEFAULT_TENANT

# client backoff is measured in queue-drain time, not storage-RPC time:
# a slower base and more headroom than the storage default
DEFAULT_CLIENT_POLICY = RetryPolicy(
    max_attempts=5, base_delay_s=0.05, max_delay_s=5.0
)


def submit_with_retry(
    server,
    df,
    *,
    tenant: str = DEFAULT_TENANT,
    deadline_s: Optional[float] = None,
    policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> QueryTicket:
    """``server.submit`` with jittered-backoff retry on AdmissionRejected.

    Each rejection sleeps ``max(server retry_after, policy backoff)``
    and retries, up to ``policy.max_attempts`` total submit attempts;
    the final rejection propagates (``serve.client.exhausted``). Every
    other outcome — including ServerClosed and planning failures riding
    the ticket — is the caller's, first try."""
    policy = policy or DEFAULT_CLIENT_POLICY
    attempts = max(1, policy.max_attempts)
    for attempt in range(1, attempts + 1):
        try:
            return server.submit(df, deadline_s=deadline_s, tenant=tenant)
        except AdmissionRejected as e:
            if attempt == attempts:
                metrics.incr("serve.client.exhausted")
                raise
            metrics.incr("serve.client.retry")
            delay = policy.delay_for(
                attempt, seed_key=f"serve:{tenant}:{id(df)}"
            )
            sleep(max(e.retry_after_s, delay))
    raise AssertionError("unreachable")
