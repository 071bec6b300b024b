"""Retry policy: exponential backoff with full jitter (the port's copy of
``poseidon_tpu/runtime/retry.py``, as the serving client uses it).

Sleep before attempt k+1 is ``U(0, min(cap, base * 2**k))`` — full jitter,
so a mass reconnect after a server restart does not synchronize every
client's retries into the same slots.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

__all__ = ["retry_with_backoff"]

T = TypeVar("T")


def retry_with_backoff(
    fn: Callable[[], T],
    *,
    deadline: float,
    base: float = 0.05,
    cap: float = 2.0,
    rng: Optional[random.Random] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    should_stop: Optional[Callable[[], bool]] = None,
) -> T:
    """Call ``fn()`` until it returns, the ``deadline`` (seconds from now)
    passes, or ``should_stop()`` goes true. Exceptions outside
    ``retry_on`` propagate immediately; on deadline exhaustion (or a stop)
    the LAST retryable exception is re-raised."""
    rng = rng or random.Random()
    t_end = time.monotonic() + deadline
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on:
            now = time.monotonic()
            if now >= t_end or (should_stop is not None and should_stop()):
                raise
            delay = rng.uniform(0.0, min(cap, base * (2.0 ** attempt)))
            time.sleep(min(delay, max(0.0, t_end - now)))
            attempt += 1
