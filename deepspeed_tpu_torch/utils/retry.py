"""Retry-with-exponential-backoff-and-jitter for transient IO failures.

Checkpoint shards on pod-scale jobs live on network filesystems
(GCS-fuse, NFS) where a single read/write can fail transiently under
load; the reference DeepSpeed simply crashes the save. ``retry_call``
wraps one IO operation: it retries only the exception types the caller
names (default ``OSError`` — corruption errors must NOT be retried, a
truncated pickle does not heal), sleeping ``backoff_seconds * 2**attempt``
(capped at ``max_backoff_seconds``) plus a random jitter fraction between
attempts so a pod of workers does not retry in lockstep against the same
storage server.

Determinism for tests: pass ``rng`` (a ``random.Random``) and ``sleep``
to pin the jitter and observe the waits.
"""
import random
import time
from typing import NamedTuple


class RetryPolicy(NamedTuple):
    """How many times and how long to wait. ``retries`` counts the extra
    attempts AFTER the first one: retries=0 means try exactly once."""
    retries: int = 3
    backoff_seconds: float = 0.05
    max_backoff_seconds: float = 2.0
    jitter: float = 0.25


# try-once policy for callers that want the plumbing without the waiting
NO_RETRY = RetryPolicy(retries=0, backoff_seconds=0.0, jitter=0.0)


def backoff_delays(policy, rng=None):
    """The sleep schedule a failing call would see, as a list (one entry
    per retry). Exposed so tests can assert the schedule itself."""
    rng = rng or random
    out = []
    for attempt in range(policy.retries):
        base = min(policy.backoff_seconds * (2.0 ** attempt),
                   policy.max_backoff_seconds)
        out.append(base * (1.0 + policy.jitter * rng.random()))
    return out


def retry_call(fn, *args, policy=None, retry_on=(OSError,), on_retry=None,
               sleep=time.sleep, rng=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` exceptions
    per ``policy``. The last failure is re-raised once attempts are
    exhausted. ``on_retry(attempt, exc, delay)`` observes each retry."""
    policy = policy or RetryPolicy()
    rng = rng or random
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            if attempt >= policy.retries:
                raise
            base = min(policy.backoff_seconds * (2.0 ** attempt),
                       policy.max_backoff_seconds)
            delay = base * (1.0 + policy.jitter * rng.random())
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            if delay > 0:
                sleep(delay)
            attempt += 1


def retryable(policy=None, retry_on=(OSError,)):
    """Decorator form of ``retry_call``."""
    def wrap(fn):
        def inner(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, retry_on=retry_on,
                              **kwargs)
        inner.__name__ = getattr(fn, "__name__", "retryable")
        inner.__doc__ = fn.__doc__
        return inner
    return wrap
