"""Retry policies: exponential backoff over transient failures.

On a TPU pod the dispatch path crosses a network (PJRT over a tunnel,
preemptible workers, a borrowed slice), so "the device call failed"
very often means "the device call would succeed if asked again in a
moment" — TensorFlow's large-scale design treats exactly this class of
failure as retryable rather than fatal. This module gives the
framework one shared vocabulary for it:

- :class:`TransientDeviceError` — the canonical retryable error; the
  fault injector raises it, and backends may translate their own
  transient failures into it.
- :func:`is_transient` — message-pattern classification of runtime
  errors that are worth re-dispatching (UNAVAILABLE / DEADLINE_EXCEEDED
  / connection-reset style failures from jax's XlaRuntimeError, which
  subclasses RuntimeError).
- :class:`RetryPolicy` + :func:`with_retries` — bounded attempts with
  exponential backoff; the sleep function is injectable so tier-1 tests
  assert the exact backoff schedule without ever sleeping.

Env knobs (read by :func:`default_policy`, used by ``Executor.run`` and
``io.DeviceLoader``):

    PADDLE_TPU_MAX_RETRIES     total attempts, default 3; 1 disables
    PADDLE_TPU_RETRY_BACKOFF   initial backoff seconds, default 0.05
"""
import os
import time

__all__ = ["TransientDeviceError", "is_transient", "RetryPolicy",
           "with_retries", "default_policy"]


class TransientDeviceError(RuntimeError):
    """A device/runtime failure worth re-dispatching: connection reset
    on a tunneled PJRT backend, a preempted worker, an injected
    ``device_error`` fault."""


# substrings of error text that mark a runtime failure as transient —
# the gRPC canonical codes XLA surfaces plus the raw socket spellings a
# tunneled backend produces. Deliberately NOT including
# RESOURCE_EXHAUSTED: OOM is deterministic, retrying it just burns time.
_TRANSIENT_PATTERNS = (
    "unavailable", "deadline_exceeded", "deadline exceeded", "aborted",
    "cancelled", "connection reset", "connection closed",
    "socket closed", "broken pipe", "preempted", "unable to connect",
)


def is_transient(exc):
    """True iff ``exc`` looks like a failure that a fresh attempt could
    survive. TransientDeviceError always qualifies; other RuntimeErrors
    and OSErrors qualify by message pattern (jax's XlaRuntimeError is a
    RuntimeError subclass, so tunneled-backend failures land here)."""
    if isinstance(exc, TransientDeviceError):
        return True
    if not isinstance(exc, (RuntimeError, OSError)):
        return False
    msg = str(exc).lower()
    return any(p in msg for p in _TRANSIENT_PATTERNS)


class RetryPolicy:
    """Bounded attempts with exponential backoff.

    ``max_attempts`` counts TOTAL attempts (1 = no retries).
    ``retryable`` is a predicate ``exc -> bool`` (default
    :func:`is_transient`) or a tuple of exception types. ``sleep`` is
    injectable so tests can record the schedule instead of waiting."""

    def __init__(self, max_attempts=3, initial_backoff=0.05,
                 max_backoff=2.0, multiplier=2.0, retryable=None,
                 sleep=None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.initial_backoff = float(initial_backoff)
        self.max_backoff = float(max_backoff)
        self.multiplier = float(multiplier)
        if retryable is None:
            retryable = is_transient
        if isinstance(retryable, (tuple, type)):
            types = retryable
            retryable = lambda exc: isinstance(exc, types)  # noqa: E731
        self._retryable = retryable
        self.sleep = sleep or time.sleep

    def is_retryable(self, exc):
        return bool(self._retryable(exc))

    def backoff(self, failure_index):
        """Delay after the ``failure_index``-th failure (1-based):
        initial * multiplier^(n-1), capped at max_backoff."""
        return min(self.max_backoff,
                   self.initial_backoff
                   * self.multiplier ** (failure_index - 1))


def default_policy(**overrides):
    """The env-tunable policy Executor.run / DeviceLoader use. Explicit
    kwargs win over env, env wins over the constructor defaults."""
    kw = {}
    if "PADDLE_TPU_MAX_RETRIES" in os.environ:
        kw["max_attempts"] = int(os.environ["PADDLE_TPU_MAX_RETRIES"])
    if "PADDLE_TPU_RETRY_BACKOFF" in os.environ:
        kw["initial_backoff"] = float(
            os.environ["PADDLE_TPU_RETRY_BACKOFF"])
    kw.update(overrides)
    return RetryPolicy(**kw)


def with_retries(fn, policy=None, on_retry=None, args=(), kwargs=None,
                 deadline=None, clock=None):
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

    Non-retryable exceptions and the final failure propagate unchanged
    (full traceback — nothing is wrapped). ``on_retry(exc, failure_index,
    delay)`` observes every retried failure; callers use it for logging
    and tests use it to assert the schedule.

    ``deadline`` (monotonic seconds, compared against ``clock``, default
    ``time.monotonic``) caps the whole retry loop: when backing off
    would reach or cross it, the current failure propagates instead —
    a retry that cannot finish inside the caller's budget only delays
    the error past the point anyone is still waiting for it. The
    serving engine threads each micro-batch's tightest request
    deadline through here so dispatch retries never outlive the
    caller's timeout (docs/SERVING.md, "Operating under failure")."""
    policy = policy or RetryPolicy()
    kwargs = kwargs or {}
    clock = clock or time.monotonic
    failures = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as exc:          # noqa: BLE001 — reraises
            failures += 1
            if (failures >= policy.max_attempts
                    or not policy.is_retryable(exc)):
                raise
            delay = policy.backoff(failures)
            if deadline is not None and clock() + delay >= deadline:
                raise
            if on_retry is not None:
                on_retry(exc, failures, delay)
            policy.sleep(delay)
