"""SLO-aware admission scheduling for the decode engine.

Port of ``paddle_tpu/serving/sched.py``: pure host code, copied
as it is (the port imports nothing of the JAX package).

FIFO admission is the wrong policy under mixed prompt lengths: a long
prompt at the head of the queue prefills for many engine iterations
(even chunked), while short interactive requests behind it blow their
time-to-first-token budgets waiting — and every admitted prefill slice
steals a step from the running streams' time-per-output-token. This
module makes the trade explicit: each request carries an
:class:`SLOClass` (TTFT + TPOT targets), queued prefills are ordered
earliest-deadline-first over their TTFT deadlines, and a TPOT budget
guard skips prefill admission on iterations where a running stream is
about to blow its per-token budget (decode runs first, prefill waits
one block) — unless a queued request's own TTFT deadline is at
imminent risk, in which case admission wins (a violated TPOT step
costs one token's latency; a violated TTFT costs the user-visible
first paint).

The scheduler is deliberately engine-agnostic and clock-injectable:
``order`` and ``admit_now`` see plain objects with a few attributes
(``enqueued_at``, ``slo`` on queued requests; ``req``,
``first_token_at``, ``emitted`` on running slots), so the policy unit
tests drive it on fake clocks with synthetic requests — no engine, no
threads, no device (tests/test_torch_slo_sched.py).

Deadline semantics reuse the serving engine's vocabulary: an SLO
target is NOT a hard deadline (the request still completes; the
breaker/deadline machinery is untouched) — it is the threshold the
attainment counters (``slo_ttft_met/violated``,
``slo_tpot_met/violated``) are scored against.
"""
import time

__all__ = ["PRIORITIES", "SLOClass", "FIFOScheduler", "SLOScheduler",
           "get_scheduler", "priority_rank"]

# Priority tiers, best (shed last, served first among deadline ties)
# to worst. The rank is the sort key everywhere — shedding, queue
# eviction, scheduler tie-breaks — so the ordering contract is a
# single table, not N comparisons.
PRIORITIES = {"interactive": 0, "standard": 1, "batch": 2}


def priority_rank(obj):
    """The priority rank of a request / SLOClass / priority name:
    0 = interactive (shed last), 1 = standard, 2 = batch (shed
    first). Anything without an explicit priority is ``standard`` —
    pre-priority traffic keeps its old position in every ordering."""
    if isinstance(obj, str):
        try:
            return PRIORITIES[obj]
        except KeyError:
            raise ValueError(
                f"unknown priority {obj!r}; one of "
                f"{sorted(PRIORITIES)}") from None
    pri = getattr(obj, "priority", None)
    if pri is None:
        slo = getattr(obj, "slo", None)
        pri = getattr(slo, "priority", None)
    return PRIORITIES.get(pri, PRIORITIES["standard"])


class SLOClass:
    """One request class's service-level objectives.

    ``ttft_target_s``: seconds from submit to first token;
    ``tpot_target_s``: seconds per generated token after the first.
    Either may be None (that half is not scored). ``name`` keys the
    per-class latency windows in ServingMetrics (``<name>.ttft_s`` /
    ``<name>.tpot_s``). ``priority`` is the overload tier
    (``interactive`` > ``standard`` > ``batch``): under pressure,
    batch sheds first and interactive last. It crosses the wire with
    the rest of the SLO — transports serialize an SLOClass as a plain
    dict and rebuild with ``SLOClass(**d)``, so every field here must
    round-trip through ``to_dict()``."""

    __slots__ = ("name", "ttft_target_s", "tpot_target_s", "priority")

    def __init__(self, ttft_target_s=None, tpot_target_s=None,
                 name="default", priority="standard"):
        if ttft_target_s is not None and float(ttft_target_s) <= 0:
            raise ValueError("ttft_target_s must be positive or None")
        if tpot_target_s is not None and float(tpot_target_s) <= 0:
            raise ValueError("tpot_target_s must be positive or None")
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r}; one of "
                f"{sorted(PRIORITIES)}")
        self.name = str(name)
        self.ttft_target_s = (None if ttft_target_s is None
                              else float(ttft_target_s))
        self.tpot_target_s = (None if tpot_target_s is None
                              else float(tpot_target_s))
        self.priority = priority

    def to_dict(self):
        """The wire form: a plain dict that ``SLOClass(**d)`` rebuilds
        bit-identically on the far side of a pipe or socket."""
        return {"ttft_target_s": self.ttft_target_s,
                "tpot_target_s": self.tpot_target_s,
                "name": self.name, "priority": self.priority}

    def __repr__(self):
        return (f"SLOClass({self.name!r}, "
                f"ttft={self.ttft_target_s}, tpot={self.tpot_target_s}, "
                f"priority={self.priority!r})")


def _ttft_deadline(req):
    """The absolute monotonic time by which this queued request wants
    its first token. Requests without an SLO (or without a TTFT half)
    sort LAST among equals — explicit targets always outrank
    best-effort traffic — and FIFO among themselves."""
    slo = getattr(req, "slo", None)
    if slo is not None and slo.ttft_target_s is not None:
        return req.enqueued_at + slo.ttft_target_s
    return float("inf")


class FIFOScheduler:
    """Arrival-order admission, always willing to prefill — exactly
    the pre-SLO engine behavior, kept as a first-class policy so
    servebench can A/B it against the SLO scheduler on one code
    path."""

    name = "fifo"

    def order(self, queue, now):
        return list(queue)

    def admit_now(self, queue, running, now):
        return True


class SLOScheduler:
    """EDF-over-TTFT admission ordering plus a TPOT budget guard.

    ``order``: queued requests sorted by TTFT deadline (earliest
    first), arrival order among ties — classic earliest-deadline-first,
    which is optimal for meeting deadlines on a single resource when
    the load is feasible.

    ``admit_now``: False (run the decode batch first, admit next
    iteration) when some running stream's TPOT budget is already spent
    — i.e. admitting a prefill slice now would push its next token past
    ``tpot_target_s * tokens`` of elapsed generation time — UNLESS the
    most urgent queued request's TTFT slack has dropped below
    ``urgency_s`` (then TTFT outranks TPOT, see module docstring).

    ``urgency_s`` defaults to one decode block's worth of leeway; pass
    the engine's measured block time for tighter control. ``clock`` is
    injectable for the fake-clock policy units."""

    name = "slo"

    def __init__(self, urgency_s=0.05, clock=None):
        self.urgency_s = float(urgency_s)
        self.clock = clock or time.monotonic

    def order(self, queue, now):
        # EDF first; priority breaks deadline ties (which includes
        # ALL best-effort traffic — no TTFT target sorts at +inf, so
        # among it interactive runs before standard before batch);
        # arrival order last.
        return sorted(queue, key=lambda r: (_ttft_deadline(r),
                                            priority_rank(r),
                                            r.enqueued_at))

    def _tpot_exhausted(self, slot, now):
        req = getattr(slot, "req", slot)
        slo = getattr(req, "slo", None)
        if slo is None or slo.tpot_target_s is None:
            return False
        first = getattr(slot, "first_token_at", None)
        if first is None:
            return False
        # budget through the NEXT token: n generated so far, token
        # n+1 due within n * tpot_target of the first token
        n = max(1, len(getattr(slot, "emitted", ()) or ()))
        return (now - first) >= slo.tpot_target_s * n

    def admit_now(self, queue, running, now):
        if not queue:
            return False
        urgent = min((_ttft_deadline(r) for r in queue),
                     default=float("inf"))
        if urgent - now <= self.urgency_s:
            return True
        return not any(self._tpot_exhausted(s, now) for s in running
                       if s is not None)


def get_scheduler(spec):
    """Resolve a scheduler from a config knob: None/'fifo' →
    FIFOScheduler, 'slo' → SLOScheduler, or an instance (anything with
    ``order`` + ``admit_now``) passed through."""
    if spec is None or spec == "fifo":
        return FIFOScheduler()
    if spec == "slo":
        return SLOScheduler()
    if hasattr(spec, "order") and hasattr(spec, "admit_now"):
        return spec
    raise ValueError(
        f"unknown scheduler {spec!r}; use 'fifo', 'slo', or an object "
        "with order()/admit_now()")
