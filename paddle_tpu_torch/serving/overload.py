"""Overload control: adaptive admission, brownout ladder, retry budget.

Port of ``paddle_tpu/serving/overload.py``: pure host code, copied
as it is (the port imports nothing of the JAX package).

Every overload path used to be binary — a fixed ``max_cluster_queue``
and a flat ``QueueFullError`` treated a batch scrape and a user-facing
decode stream identically, and nothing stopped failover/redrive
traffic from amplifying the very overload that triggered it. This
module makes degradation deliberate (the production-dataflow move of
arXiv:1605.08695): three small, clock-injectable controllers that the
router and the decode engine wire in, each unit-testable on a fake
clock with no threads and no device (tests/test_torch_overload.py).

- :class:`AdmissionController` — AIMD on observed request sojourn vs.
  a delay target. The admitted-outstanding limit grows additively
  while sojourn is under target and cuts multiplicatively when it is
  over, so the admitted rate tracks actual capacity instead of a
  hand-tuned constant. Priority tiers see DIFFERENT effective limits
  (batch a fraction of the limit, standard a larger one, interactive
  the hard ceiling itself), which is what makes shed ordering strict:
  as load rises past capacity, batch hits its ceiling first, then
  standard, and interactive sheds only where the old fixed bound
  would have shed it. The configured hard ceiling always binds.

- :class:`BrownoutController` — a pressure signal in [0, 1] (max of
  normalized queue delay, breaker state, page-pool occupancy) drives
  an explicit degradation ladder with hysteresis: level 1 caps
  batch-tier ``max_new``, level 2 disables speculative decoding,
  level 3 shrinks chunked-prefill admission. Each engage/revert is
  counted, and every step fully reverts on recovery — brownout trades
  work for admission, never numerics.

- :class:`RetryBudget` — a token bucket bounding cluster-wide retry /
  redrive / hedge amplification. Each retry takes a token; each
  success refills a configured fraction of one; an empty bucket makes
  retries fail fast with :class:`RetryBudgetExhaustedError` instead
  of storming a pool that is already down. Hedged requests draw from
  the same bucket, so tail-cutting duplicates can never become the
  storm themselves.

See docs/RELIABILITY.md "Operating at the overload knee".
"""
import threading
import time

from .health import ServiceUnavailableError
from .sched import PRIORITIES

__all__ = ["AdmissionController", "BrownoutController", "RetryBudget",
           "RetryBudgetExhaustedError", "BROWNOUT_STEPS",
           "shed_counter"]


class RetryBudgetExhaustedError(ServiceUnavailableError):
    """The cluster-wide retry budget is spent: this retry/redrive/
    hedge would amplify an overload, so it fails fast instead. Typed
    as unavailability (back off, don't resubmit immediately) — the
    ORIGINAL attempt's error is chained as ``__cause__``."""


# Per-tier admission fractions: the effective outstanding limit each
# priority admits against, as a fraction of the AIMD limit. Batch
# saturates first (sheds first), then standard; INTERACTIVE bypasses
# the adaptive limit entirely and admits up to the hard ceiling — the
# AIMD loop protects latency by throttling the lower tiers, and
# interactive traffic sheds only where the old fixed bound would have
# shed it. That is the strict ordering the overload drill asserts on.
_TIER_FRACTION = {0: 1.0, 1: 0.85, 2: 0.6}


class AdmissionController:
    """AIMD admission over observed request sojourn.

    ``admit(rank, outstanding)`` answers "may a request of this
    priority enter with this many already outstanding?" against
    ``limit * fraction(rank)``. ``observe(sojourn_s)`` feeds completed
    requests' wall time (submit → settle) into an EWMA; once per
    ``interval_s`` the limit adapts: additive increase (+``add_step``)
    while the EWMA is under ``target_delay_s``, multiplicative
    decrease (×``decrease``) when it is over. The limit lives in
    [``min_limit``, ``hard_ceiling``]; the ceiling is the old fixed
    bound and always binds.

    Thread-safe; ``clock`` is injectable for fake-clock units."""

    def __init__(self, hard_ceiling, target_delay_s=0.5,
                 min_limit=4, start_limit=None, add_step=1.0,
                 decrease=0.7, interval_s=0.25, ewma_alpha=0.3,
                 clock=None):
        if hard_ceiling is None or int(hard_ceiling) < 1:
            raise ValueError("hard_ceiling must be a positive int "
                             "(the fixed bound stays as the ceiling)")
        self.hard_ceiling = int(hard_ceiling)
        self.target_delay_s = float(target_delay_s)
        self.min_limit = max(1, int(min_limit))
        self.add_step = float(add_step)
        self.decrease = float(decrease)
        if not (0.0 < self.decrease < 1.0):
            raise ValueError("decrease must be in (0, 1)")
        self.interval_s = float(interval_s)
        self.ewma_alpha = float(ewma_alpha)
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._limit = float(min(self.hard_ceiling,
                                self.hard_ceiling
                                if start_limit is None
                                else max(self.min_limit,
                                         int(start_limit))))
        self._ewma = None               # observed sojourn EWMA, s
        self._last_adapt = self.clock()
        self._admitted_total = 0
        self._refused_total = 0

    def observe(self, sojourn_s):
        """Feed one completed request's sojourn (seconds, submit →
        settle) and adapt the limit if an interval elapsed."""
        s = float(sojourn_s)
        if not (s == s) or s < 0:       # NaN / negative: drop
            return
        now = self.clock()
        with self._lock:
            self._ewma = (s if self._ewma is None
                          else self.ewma_alpha * s
                          + (1.0 - self.ewma_alpha) * self._ewma)
            if now - self._last_adapt < self.interval_s:
                return
            self._last_adapt = now
            if self._ewma > self.target_delay_s:
                self._limit = max(float(self.min_limit),
                                  self._limit * self.decrease)
            else:
                self._limit = min(float(self.hard_ceiling),
                                  self._limit + self.add_step)

    def limit(self):
        with self._lock:
            return self._limit

    def admit(self, rank, outstanding):
        """True if a request of priority ``rank`` may enter with
        ``outstanding`` requests already in flight pool-wide.
        Interactive (rank 0) admits against the hard ceiling itself;
        lower tiers admit against their fraction of the AIMD limit."""
        rank = int(rank)
        frac = _TIER_FRACTION.get(rank, _TIER_FRACTION[2])
        with self._lock:
            if rank <= PRIORITIES["interactive"]:
                eff = float(self.hard_ceiling)
            else:
                eff = min(self._limit * frac, float(self.hard_ceiling))
            ok = outstanding < max(1.0, eff)
            if ok:
                self._admitted_total += 1
            else:
                self._refused_total += 1
            return ok

    def snapshot(self):
        with self._lock:
            return {"limit": self._limit,
                    "hard_ceiling": self.hard_ceiling,
                    "target_delay_s": self.target_delay_s,
                    "sojourn_ewma_s": self._ewma,
                    "admitted_total": self._admitted_total,
                    "refused_total": self._refused_total,
                    "tier_fractions": dict(_TIER_FRACTION)}


# The brownout ladder, mildest first. Step N engages when pressure
# holds above engage_at; everything reverts (in reverse order) as
# pressure falls below revert_at. Names key the brownout_* counters.
BROWNOUT_STEPS = ("cap_batch_max_new", "spec_off", "chunk_shrink")


class BrownoutController:
    """Pressure-driven degradation ladder with hysteresis.

    ``update(pressure)`` takes the current pressure signal in [0, 1]
    (the engine computes it as the max of normalized queue delay,
    breaker-open, and page-pool occupancy) and moves the level at most
    ONE step per call: up when pressure >= ``engage_at`` and the level
    has dwelled ``dwell_s``, down when pressure <= ``revert_at`` (the
    gap between the two thresholds is the hysteresis band that stops
    flapping). Levels mean: 0 = off, 1 = cap batch-tier ``max_new``,
    2 = +speculative decoding off, 3 = +chunked-prefill admission
    shrunk to one slice per iteration. ``active(step)`` answers
    whether a named step currently applies.

    The controller only decides the level; the ENGINE applies and
    reverts the effects and counts them (``brownout_engage_total`` /
    ``brownout_revert_total`` / per-step counters). Clock-injectable,
    thread-safe."""

    max_level = len(BROWNOUT_STEPS)

    def __init__(self, engage_at=0.85, revert_at=0.5, dwell_s=0.1,
                 clock=None):
        if not (0.0 <= revert_at < engage_at <= 1.0):
            raise ValueError("need 0 <= revert_at < engage_at <= 1 "
                             "(the hysteresis band)")
        self.engage_at = float(engage_at)
        self.revert_at = float(revert_at)
        self.dwell_s = float(dwell_s)
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._level = 0
        self._since = self.clock()
        self._pressure = 0.0

    def update(self, pressure):
        """Feed the current pressure; returns (old_level, new_level).
        Moves at most one rung per call."""
        p = min(1.0, max(0.0, float(pressure)))
        now = self.clock()
        with self._lock:
            self._pressure = p
            old = self._level
            dwelled = (now - self._since) >= self.dwell_s
            if p >= self.engage_at and dwelled \
                    and self._level < self.max_level:
                self._level += 1
                self._since = now
            elif p <= self.revert_at and dwelled and self._level > 0:
                self._level -= 1
                self._since = now
            return old, self._level

    def level(self):
        with self._lock:
            return self._level

    def pressure(self):
        with self._lock:
            return self._pressure

    def active(self, step):
        """Whether the named ladder step currently applies."""
        try:
            rung = BROWNOUT_STEPS.index(step) + 1
        except ValueError:
            raise ValueError(f"unknown brownout step {step!r}; one "
                             f"of {BROWNOUT_STEPS}") from None
        with self._lock:
            return self._level >= rung

    def snapshot(self):
        with self._lock:
            return {"level": self._level,
                    "pressure": self._pressure,
                    "engage_at": self.engage_at,
                    "revert_at": self.revert_at,
                    "steps": list(BROWNOUT_STEPS)}


class RetryBudget:
    """Cluster-wide retry token bucket.

    Starts full at ``capacity`` tokens. Every retry/redrive/hedge
    calls :meth:`acquire` — True consumes one token, False means the
    budget is spent and the caller must fail fast (the router raises
    :class:`RetryBudgetExhaustedError`). Every SUCCESS (first try or
    retried) calls :meth:`note_success`, refilling ``refill_ratio``
    of a token — so sustained retry traffic is bounded at roughly
    ``refill_ratio`` of goodput, the classic retry-budget contract:
    a healthy pool earns its retries back, a down pool cannot storm
    itself. Thread-safe."""

    def __init__(self, capacity=16, refill_ratio=0.1):
        self.capacity = float(capacity)
        if self.capacity <= 0:
            raise ValueError("capacity must be positive")
        self.refill_ratio = float(refill_ratio)
        if not (0.0 <= self.refill_ratio <= 1.0):
            raise ValueError("refill_ratio must be in [0, 1]")
        self._lock = threading.Lock()
        self._tokens = self.capacity
        self._acquired_total = 0
        self._exhausted_total = 0

    def acquire(self):
        """Take one retry token; False = budget spent, fail fast."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self._acquired_total += 1
                return True
            self._exhausted_total += 1
            return False

    def note_success(self):
        """A request succeeded: earn back a fraction of a token."""
        with self._lock:
            self._tokens = min(self.capacity,
                               self._tokens + self.refill_ratio)

    def tokens(self):
        with self._lock:
            return self._tokens

    def snapshot(self):
        with self._lock:
            return {"tokens": self._tokens,
                    "capacity": self.capacity,
                    "refill_ratio": self.refill_ratio,
                    "acquired_total": self._acquired_total,
                    "exhausted_total": self._exhausted_total}


def shed_counter(rank):
    """The per-class shed counter name for a priority rank — one
    vocabulary across engine, pool, and metrics merge."""
    for name, r in PRIORITIES.items():
        if r == int(rank):
            return f"shed_{name}_total"
    return "shed_standard_total"
