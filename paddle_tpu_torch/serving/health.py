"""Serving health machinery: liveness states, circuit breaker, typed
failure errors.

Large-scale serving treats failure as the steady state (the TF design
axis — Abadi et al., 2016): a server is not "up or down" but somewhere
on STARTING → READY → DEGRADED → DRAINING → STOPPED, and every failure
mode must map to a *defined* behavior a client can program against.
This module is the pure-policy half of that story (no threads, no
executor — deterministic under an injectable clock, like batching.py):

- :class:`HealthState` / :class:`HealthMonitor` — the engine's
  liveness state machine plus the worker heartbeat the watchdog reads.
  The worker beats once per loop iteration; a stalled heartbeat or a
  dead thread is the watchdog's signal to fail pending requests with
  :class:`WorkerDiedError` instead of letting callers sit on their
  grace bound.
- :class:`CircuitBreaker` — the classic closed → open → half-open
  cycle over *consecutive* batch failures. While open, work is shed
  immediately with :class:`ServiceUnavailableError` (fail fast beats
  queueing into a known-bad device); after ``cooldown_s`` one probe
  batch is let through, and its outcome closes or re-opens the
  breaker. The engine keeps one breaker for itself and one per bucket
  signature, so a single poisoned shape cannot black-hole the whole
  server.

Thread-safety: every method takes the instance lock; the engine calls
in from the submit path, the worker, and the watchdog concurrently.
"""
import threading
import time

from .batching import ServingError

__all__ = ["HealthState", "HealthMonitor", "CircuitBreaker",
           "WorkerDiedError", "ServiceUnavailableError",
           "SERVING_STATE_RANK", "serving_rank"]


class WorkerDiedError(ServingError):
    """The serving worker thread is dead or stalled; this request will
    never be served by it. Distinct from RequestTimeoutError (the
    request was viable, the clock ran out) — a dead worker means the
    whole engine needs a restart, not the request a retry."""


class ServiceUnavailableError(ServingError):
    """Shed by an open circuit breaker: the engine (or this request's
    bucket) is in a known-failing state and refuses work instead of
    burning compute on it. Back off at least the breaker cooldown
    before retrying."""


class HealthState:
    """The serving lifecycle, ordered. String constants (not enum) so
    ``stats()`` snapshots stay plain-JSON."""

    STARTING = "STARTING"    # constructed, worker not yet taking work
    READY = "READY"          # worker up, admission open
    DEGRADED = "DEGRADED"    # serving impaired: breaker open or worker dead
    DRAINING = "DRAINING"    # admission closed, finishing queued work
    STOPPED = "STOPPED"      # worker joined, engine finished

    ALL = (STARTING, READY, DEGRADED, DRAINING, STOPPED)


# serving states ranked best-first for traffic placement; states absent
# from the map are NOT candidates. One vocabulary shared by the cluster
# router's health-aware balancing and the membership view, so "which
# tier is this replica in" has exactly one answer — local engine,
# pipe-backed process, or socket-backed remote host alike.
SERVING_STATE_RANK = {HealthState.READY: 0, HealthState.DEGRADED: 1}


def serving_rank(state):
    """Best-first placement rank for a health state, or None when the
    state must not take traffic (STARTING/DRAINING/STOPPED)."""
    return SERVING_STATE_RANK.get(state)


class HealthMonitor:
    """State holder + worker heartbeat for one engine.

    ``beat()`` is called by the worker once per loop iteration (cheap:
    one lock + one float store). ``heartbeat_age()`` is what the
    watchdog compares against the hang timeout — None before the first
    beat, so a never-started worker reads as "no heartbeat" rather
    than "infinitely stale"."""

    def __init__(self, clock=None):
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = HealthState.STARTING
        self._last_beat = None

    @property
    def state(self):
        with self._lock:
            return self._state

    def to(self, state):
        if state not in HealthState.ALL:
            raise ValueError(f"unknown health state {state!r}; one of "
                             f"{HealthState.ALL}")
        with self._lock:
            prev, self._state = self._state, state
            return prev

    def beat(self):
        with self._lock:
            self._last_beat = self.clock()

    def heartbeat_age(self):
        with self._lock:
            if self._last_beat is None:
                return None
            return self.clock() - self._last_beat


class CircuitBreaker:
    """Consecutive-failure breaker: closed → open → half-open → closed.

    ``failure_threshold`` consecutive failures open the breaker (one
    success resets the count — a flapping device never accumulates to
    open). While open, :meth:`admits` is False until ``cooldown_s`` has
    elapsed; the first :meth:`allow` after the cooldown transitions to
    half-open and lets exactly that caller's batch through as the
    probe. :meth:`record_success` closes, :meth:`record_failure`
    re-opens with a fresh cooldown.

    Two read points by design: ``admits()`` is the *read-only* check
    the submit path uses to shed early (it never changes state — state
    transitions belong to the worker, the single dispatcher), while
    ``allow()`` is the dispatch-side check that performs the
    open → half-open transition."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold=5, cooldown_s=1.0, clock=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = None
        self._opens_total = 0

    @property
    def state(self):
        with self._lock:
            return self._state

    @property
    def opens_total(self):
        with self._lock:
            return self._opens_total

    def _cooled_down(self, now):
        return (self._opened_at is not None
                and now - self._opened_at >= self.cooldown_s)

    def admits(self, now=None):
        """Read-only: would a new request be accepted right now? False
        only while open with the cooldown still running."""
        with self._lock:
            if self._state != self.OPEN:
                return True
            return self._cooled_down(self.clock() if now is None else now)

    def allow(self):
        """Dispatch-side gate. Closed/half-open pass; open passes only
        once the cooldown elapsed, transitioning to half-open — the
        caller's batch is the probe and MUST report its outcome via
        record_success/record_failure."""
        with self._lock:
            if self._state != self.OPEN:
                return True
            if self._cooled_down(self.clock()):
                self._state = self.HALF_OPEN
                return True
            return False

    def record_success(self):
        with self._lock:
            self._consecutive_failures = 0
            self._opened_at = None
            self._state = self.CLOSED

    def record_failure(self):
        """Count one terminal batch failure (post-retry). Returns True
        iff this failure OPENED the breaker (edge, not level — the
        caller counts opens and flips health on the edge)."""
        with self._lock:
            self._consecutive_failures += 1
            if self._state == self.HALF_OPEN or (
                    self._state == self.CLOSED
                    and self._consecutive_failures
                    >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self.clock()
                self._opens_total += 1
                return True
            return False

    def snapshot(self):
        """Plain-dict state for ``stats()``."""
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "opens_total": self._opens_total,
                    "cooldown_s": self.cooldown_s,
                    "failure_threshold": self.failure_threshold}
