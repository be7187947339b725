"""Bounded jittered retries for API writes.

Reference: ``client-go/util/retry`` (``RetryOnConflict`` /
``OnError`` with a jittered backoff). The connected scheduler's bind and
status writes previously failed straight through to a requeue on the
first transient error — one 503 blip cost the pod a full backoff cycle.
A couple of cheap in-request retries absorb the blip; semantic outcomes
(404 gone, 409 conflict) still surface immediately, because retrying
those changes meaning, not odds.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.client.clientset import ApiError

# HTTP codes worth retrying: throttle + server-side unavailability. 404 and
# 409 are semantic outcomes the callers handle, never retried here.
RETRIABLE_CODES = frozenset((429, 500, 502, 503, 504))


def retriable_api_failure(e: BaseException) -> bool:
    if isinstance(e, ApiError):
        return e.code in RETRIABLE_CODES
    # transport-level: reset/refused/timeout (HTTPClient re-raises these
    # after its own single stale-connection retry)
    import http.client
    return isinstance(e, (ConnectionError, TimeoutError, OSError,
                          http.client.HTTPException))


def with_retries(fn: Callable, attempts: int = 3, base_s: float = 0.05,
                 rng: Optional[random.Random] = None,
                 retriable: Callable[[BaseException], bool] = retriable_api_failure,
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Optional[Callable[[BaseException], None]] = None):
    """Call ``fn`` with up to ``attempts`` tries; transient failures sleep
    an exponentially-growing, full-jitter backoff between tries. The final
    failure propagates unchanged so callers' error handling keeps its
    exact semantics. Jitter is full-range (0..backoff]: synchronized
    retries from a binding storm must not re-converge on the apiserver."""
    rng = rng or random
    last: Optional[BaseException] = None
    for i in range(max(1, attempts)):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — filtered right below
            if i >= max(1, attempts) - 1 or not retriable(e):
                raise
            last = e
            if on_retry is not None:
                on_retry(e)
            sleep(rng.uniform(0.0, base_s * (2 ** i)) or base_s / 2)
    raise last  # pragma: no cover — loop always returns or raises
