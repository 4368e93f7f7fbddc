"""Router — the client-facing front of a replica pool.

One logical server over N replicas: ``submit()`` picks a replica via
a pluggable balancing policy, sheds at the cluster bound, and reroutes
a request whose chosen replica refuses it (full queue, open breaker,
dead worker); ``infer()`` adds transparent FAILOVER — a request that
died with its replica is resubmitted to a different one while its
deadline allows, so a replica crash costs latency, not answers. This
is the thin-routing-layer move of the reference Paddle's distribute
transpiler and the TF-Serving replica tier (arXiv:1605.08695), at
engine granularity.

Balancing policies (``POLICIES``):

- ``round_robin`` — rotate through eligible replicas; fair under
  uniform requests, blind to load and health beyond eligibility.
- ``least_outstanding`` — pick the replica with the fewest
  admitted-but-unfinished requests (``engine.outstanding()``, O(1)
  reads); the right default under variable request cost.
- ``health_aware`` (default) — least-outstanding over the healthiest
  tier: replicas whose circuit breaker currently admits and whose
  HealthMonitor reads READY sort before DEGRADED ones (breaker open /
  worker just died); non-serving states (STARTING, DRAINING, STOPPED)
  are excluded outright. The policy READS the existing per-engine
  health machinery — no second health system.

Every policy returns an ORDERED candidate list; the router tries each
in turn, so a single refusing replica never fails a request the next
replica would have taken.

On top of any policy, :meth:`Router.set_weights` splits traffic
across model VERSIONS (``replica.version`` labels) — the canary
traffic-shifting primitive ``cluster/deploy.py`` ramps deployments
with (``cluster/deploy.py``).
"""
import random
import threading
import time

from ..resilience import faultinject as _faultinject
from ..serving.batching import QueueFullError, ServerClosedError
from ..serving.health import (ServiceUnavailableError,
                              WorkerDiedError, serving_rank)
from ..serving.kv_pages import PagesExhaustedError
from ..serving.overload import (AdmissionController, RetryBudget,
                                RetryBudgetExhaustedError,
                                shed_counter)
from ..serving.sched import PRIORITIES, priority_rank
from . import net as _net

__all__ = ["BalancePolicy", "RoundRobinPolicy",
           "LeastOutstandingPolicy", "HealthAwarePolicy", "POLICIES",
           "ClusterOverloadError", "NoReadyReplicaError", "Router",
           "get_policy"]

# priority rank -> tier name (the inverse of sched.PRIORITIES)
_PRI_NAME = {rank: name for name, rank in PRIORITIES.items()}


class ClusterOverloadError(QueueFullError):
    """Cluster-level shed: every replica refused (or the pool-wide
    outstanding bound is hit). The typed signal that the POOL is the
    bottleneck — scale out — where a plain QueueFullError means one
    replica's queue filled. ``per_class`` (when the router built the
    error) maps each priority tier to its outstanding count at shed
    time, so the operator sees WHICH traffic holds the capacity, not
    just that the bound was hit."""

    def __init__(self, msg, per_class=None):
        super().__init__(msg)
        self.per_class = dict(per_class) if per_class else None


class NoReadyReplicaError(ServiceUnavailableError):
    """No replica is currently eligible to take traffic (all
    restarting, dead, or stopped). Distinct from overload: capacity is
    absent, not exhausted."""


# a router can front remote pools (a fleet coordinator routing across
# serve_remotes views); its typed sheds must survive the wire
_net.register_wire_error(ClusterOverloadError)
_net.register_wire_error(NoReadyReplicaError)


class BalancePolicy:
    """Order eligible replicas for one pick. Stateless unless noted."""

    name = "?"

    def order(self, replicas):
        raise NotImplementedError


class RoundRobinPolicy(BalancePolicy):
    name = "round_robin"

    def __init__(self):
        self._lock = threading.Lock()
        self._i = 0

    def order(self, replicas):
        if not replicas:
            return []
        with self._lock:
            i = self._i % len(replicas)
            self._i += 1
        return replicas[i:] + replicas[:i]


class LeastOutstandingPolicy(BalancePolicy):
    name = "least_outstanding"

    def order(self, replicas):
        return sorted(replicas, key=lambda r: r.outstanding())


class HealthAwarePolicy(BalancePolicy):
    name = "health_aware"

    # serving states, best first (health.SERVING_STATE_RANK — one
    # vocabulary with the membership view); anything unranked is not a
    # candidate

    def order(self, replicas):
        ranked = []
        for r in replicas:
            rank = serving_rank(r.health_state())
            if rank is None:
                continue
            ranked.append((0 if r.admits() else 2, rank,
                           r.outstanding(), r))
        ranked.sort(key=lambda t: t[:3])
        return [t[3] for t in ranked]


POLICIES = {p.name: p for p in (RoundRobinPolicy,
                                LeastOutstandingPolicy,
                                HealthAwarePolicy)}


def get_policy(policy):
    """A policy instance from a name, class, or instance."""
    if isinstance(policy, str):
        if policy not in POLICIES:
            raise ValueError(f"unknown balancing policy {policy!r}; "
                             f"one of {sorted(POLICIES)}")
        return POLICIES[policy]()
    if isinstance(policy, type):
        return policy()
    return policy


# submit-side refusals worth trying the NEXT replica for; anything
# else (BucketError, bad feed ValueError, never-fits
# PagesExhaustedError) would fail identically everywhere and
# propagates untouched
_REROUTABLE = (QueueFullError, ServiceUnavailableError,
               ServerClosedError, WorkerDiedError)


class Router:
    """Route requests across ``pool``'s replicas.

    ``max_cluster_queue`` bounds the POOL-WIDE outstanding count
    (queued + in dispatch, summed over replicas); beyond it, submits
    shed with :class:`ClusterOverloadError` before touching any
    replica — the cluster-level admission control on top of each
    engine's own ``max_queue``. ``None`` disables the pool bound (the
    per-replica bounds still hold).

    Overload controls (serving/overload.py, all off by default so the
    pre-overload-control behavior is the zero-config baseline):

    - ``admission="adaptive"`` (or an AdmissionController) replaces
      the static bound with AIMD admission over observed sojourn —
      ``max_cluster_queue`` stays as the hard ceiling and is required;
      priority tiers see tiered effective limits, so batch sheds
      first and interactive last.
    - ``retry_budget`` (True / capacity / a RetryBudget) bounds
      failover + redrive + hedge amplification cluster-wide; a retry
      past the budget raises :class:`RetryBudgetExhaustedError`
      instead of storming.
    - ``hedge_delay_s`` hedges INTERACTIVE-tier ``infer`` traffic: a
      primary attempt slower than the delay gets a budget-funded
      duplicate on another replica; first settled answer wins.
    - ``default_timeout_s`` is resolved ONCE at ``infer``/``generate``
      entry when the caller gives no timeout, so every failover /
      redrive hop inherits the ORIGINAL deadline — a hop never
      restarts the clock against the engine's per-hop default.
    """

    def __init__(self, pool, policy="health_aware",
                 max_cluster_queue=None, weight_seed=None,
                 admission=None, retry_budget=None,
                 hedge_delay_s=None, default_timeout_s=30.0):
        self.pool = pool
        self.policy = get_policy(policy)
        self.max_cluster_queue = (None if max_cluster_queue is None
                                  else int(max_cluster_queue))
        self._weights = None            # version -> normalized weight
        self._weights_lock = threading.Lock()
        self._weight_rng = random.Random(weight_seed)
        if admission == "adaptive":
            if self.max_cluster_queue is None:
                raise ValueError(
                    "admission='adaptive' needs max_cluster_queue — "
                    "the fixed bound stays as the hard ceiling")
            admission = AdmissionController(
                hard_ceiling=self.max_cluster_queue)
        self.admission = admission      # AdmissionController or None
        if retry_budget is True:
            retry_budget = RetryBudget()
        elif isinstance(retry_budget, (int, float)):
            retry_budget = RetryBudget(capacity=retry_budget)
        self.retry_budget = retry_budget
        self.hedge_delay_s = (None if hedge_delay_s is None
                              else float(hedge_delay_s))
        self.default_timeout_s = (
            None if default_timeout_s is None
            else float(default_timeout_s))
        self._class_lock = threading.Lock()
        self._outstanding_by_class = {n: 0 for n in PRIORITIES}

    # -- weighted version-aware balancing --------------------------------
    def set_weights(self, weights, seed=None):
        """Split traffic across model VERSIONS (``replica.version``
        labels, stamped by cluster/deploy.py):
        ``set_weights({"v1": 0.99, "v2": 0.01})`` sends ~1% of picks
        to v2's replicas. Semantics the canary machinery leans on:

        - weight ``0.0`` (or a version absent from the dict) NEVER
          routes — a canary at weight 0 is deployed-but-dark, safe to
          numerics-check before any traffic touches it;
        - a single weight ``1.0`` ALWAYS routes to that version;
        - the per-request version draw is weighted-random from a
          router-owned RNG (``seed=``/``weight_seed=`` pin it for
          deterministic tests);
        - the non-chosen weight>0 versions stay in the candidate list
          AFTER the chosen version's replicas, so the reroute ladder
          and ``infer()`` failover still see the whole eligible pool —
          a refusing canary costs a reroute, never a lost request.

        ``set_weights(None)`` clears version routing (every replica is
        a candidate again, whatever its label). Weights need not sum
        to 1 — they are normalized at draw time."""
        if weights is None:
            with self._weights_lock:
                self._weights = None
                if seed is not None:
                    self._weight_rng = random.Random(seed)
            return
        cleaned = {}
        for version, w in weights.items():
            w = float(w)
            if w < 0 or not (w == w):       # negative or NaN
                raise ValueError(
                    f"weight for version {version!r} must be a "
                    f"finite value >= 0, got {w}")
            if w > 0:
                cleaned[version] = w
        if not cleaned:
            raise ValueError(
                "set_weights needs at least one version with "
                "weight > 0 (use set_weights(None) to clear "
                "version routing)")
        with self._weights_lock:
            self._weights = cleaned
            if seed is not None:
                self._weight_rng = random.Random(seed)

    def weights(self):
        """The live version-weight map (a copy), or None."""
        with self._weights_lock:
            return dict(self._weights) if self._weights else None

    # -- request path ----------------------------------------------------
    def _candidates(self, role=None):
        eligible = [r for r in self.pool.replicas()
                    if not r.restarting and r.alive()
                    and (role is None
                         or getattr(r, "role", None) == role)]
        with self._weights_lock:
            weights = self._weights
            rng = self._weight_rng
        if not weights:
            return self.policy.order(eligible)
        by_version = {}
        for r in eligible:
            by_version.setdefault(getattr(r, "version", None),
                                  []).append(r)
        # only versions that are both weighted AND currently have an
        # eligible replica can win the draw; zero-weight versions are
        # not candidates at all
        avail = [(v, w) for v, w in weights.items()
                 if by_version.get(v)]
        if not avail:
            return []
        total = sum(w for _, w in avail)
        with self._weights_lock:
            x = rng.random() * total
        chosen = avail[-1][0]
        for v, w in avail:
            x -= w
            if x < 0:
                chosen = v
                break
        ordered = self.policy.order(by_version[chosen])
        spill = [r for v, _ in avail if v != chosen
                 for r in by_version[v]]
        return ordered + self.policy.order(spill)

    def _resolve_rank(self, slo, priority):
        """The priority rank for a request: explicit ``priority=``
        outranks the SLO's tier; no signal at all = standard."""
        if priority is not None:
            return priority_rank(priority)
        if slo is not None:
            return priority_rank(slo)
        return PRIORITIES["standard"]

    def _shed(self, rank):
        self.pool.incr("cluster_shed_total")
        self.pool.incr(shed_counter(rank))

    def _per_class_outstanding(self):
        with self._class_lock:
            return dict(self._outstanding_by_class)

    def _track(self, handle, rank):
        """Per-class admission accounting on a successful submit: the
        class's outstanding count rises now and falls when the handle
        settles, and the settle latency (sojourn) feeds the adaptive
        admission controller's AIMD loop."""
        name = _PRI_NAME.get(rank, "standard")
        with self._class_lock:
            self._outstanding_by_class[name] += 1
        t0 = time.monotonic()

        def _done(_handle):
            with self._class_lock:
                self._outstanding_by_class[name] -= 1
            if self.admission is not None:
                self.admission.observe(time.monotonic() - t0)

        if hasattr(handle, "add_done_callback"):
            handle.add_done_callback(_done)
        else:           # untrackable foreign handle: release now
            with self._class_lock:
                self._outstanding_by_class[name] -= 1
        return handle

    def submit(self, item, timeout=None, role=None, slo=None,
               priority=None, **kw):
        """Pick a replica and submit; returns that replica's handle.
        ``role=`` restricts the pick to replicas carrying that
        disaggregation tag (``"prefill"`` / ``"decode"``).

        ``slo`` (an SLOClass, forwarded to the replica) and
        ``priority`` (a tier name, router-side only) set the request's
        overload tier; under adaptive admission the tiers see
        different effective limits, so batch sheds strictly before
        standard before interactive.

        Raises ClusterOverloadError (pool bound / adaptive admission
        refusal / every replica shed with a full queue),
        NoReadyReplicaError (no eligible replica), or the first
        non-reroutable submit error (BucketError etc.)."""
        rank = self._resolve_rank(slo, priority)
        outstanding = self.pool.total_outstanding()
        if self.max_cluster_queue is not None \
                and outstanding >= self.max_cluster_queue:
            self._shed(rank)
            raise ClusterOverloadError(
                f"cluster outstanding bound "
                f"({self.max_cluster_queue}) reached — every replica "
                "is saturated; back off or scale_up()",
                per_class=self._per_class_outstanding())
        if self.admission is not None \
                and not self.admission.admit(rank, outstanding):
            self._shed(rank)
            raise ClusterOverloadError(
                f"adaptive admission refused a "
                f"{_PRI_NAME.get(rank, 'standard')}-tier request at "
                f"{outstanding} outstanding (current limit "
                f"{self.admission.limit():.1f}) — the pool is past "
                "its knee; back off",
                per_class=self._per_class_outstanding())
        if slo is not None:
            kw = dict(kw, slo=slo)
        candidates = self._candidates(role=role)
        if _faultinject.fires("serving_replica_crash") and candidates:
            # chaos: the replica the policy just chose dies under the
            # request — the drill the pool's revival monitor + infer()
            # failover must absorb with zero losses
            candidates[0].crash()
        last = None
        rerouted = False
        for replica in candidates:
            try:
                return self._track(
                    replica.submit(item, timeout=timeout, **kw), rank)
            except PagesExhaustedError:
                raise            # never-fits: identical on every replica
            except _REROUTABLE as exc:
                last = exc
                rerouted = True
                self.pool.incr("reroutes_total")
        if rerouted:
            self._shed(rank)
            if isinstance(last, QueueFullError):
                raise ClusterOverloadError(
                    "every replica shed this request (all queues "
                    "full or breakers open)",
                    per_class=self._per_class_outstanding()) from last
            raise NoReadyReplicaError(
                "every replica refused this request") from last
        self._shed(rank)
        raise NoReadyReplicaError(
            "no eligible replica (all restarting, dead, or stopped)")

    def _spend_retry(self, cause):
        """Take a retry token before any failover / redrive / storm
        resubmission. No budget configured = unbounded (the pre-budget
        behavior). An empty bucket fails FAST with the typed error —
        retrying into an overload amplifies it."""
        if self.retry_budget is None:
            return
        if self.retry_budget.acquire():
            return
        self.pool.incr("retry_budget_exhausted_total")
        raise RetryBudgetExhaustedError(
            "cluster retry budget exhausted — failing fast instead "
            "of amplifying the overload; back off and resubmit"
        ) from cause

    def _note_success(self):
        if self.retry_budget is not None:
            self.retry_budget.note_success()

    def _await_hedged(self, handle, deadline, item, kw):
        """Interactive-tier hedging: give the primary attempt
        ``hedge_delay_s``; past that, a budget-funded duplicate goes
        to another replica and the first settled answer wins (the
        loser is abandoned — its cost is exactly what the retry
        budget meters). Falls back to a plain wait when the budget or
        the pool refuses the duplicate."""
        def _rem():
            return (None if deadline is None
                    else deadline - time.monotonic())

        def _wait_bound():
            r = _rem()
            return None if r is None else max(0.0, r) + 10.0

        first_wait = self.hedge_delay_s
        r = _rem()
        if r is not None:
            first_wait = min(first_wait, max(0.0, r) + 10.0)
        if handle.wait(first_wait):
            return handle.result(0)
        if not self.retry_budget.acquire():
            return handle.result(_wait_bound())
        try:
            other = self.submit(item, timeout=_rem(), **kw)
        except (PagesExhaustedError, *_REROUTABLE):
            self.retry_budget.note_success()   # unused token back
            return handle.result(_wait_bound())
        self.pool.incr("hedges_total")
        while True:
            if handle.wait(0.005):
                winner, loser = handle, other   # primary wins ties
                break
            if other.wait(0.005):
                winner, loser = other, handle
                break
            r = _rem()
            if r is not None and r <= -10.0:    # grace exhausted
                return handle.result(0)
        if winner is other:
            self.pool.incr("hedge_wins_total")
        try:
            return winner.result(0)
        except (WorkerDiedError, ServerClosedError):
            # the winner's replica died mid-answer; the other attempt
            # may still be good — drain it before giving up
            return loser.result(_wait_bound())

    def infer(self, item, timeout=None, failover=True, **kw):
        """Synchronous submit + wait, with cross-replica failover: if
        the serving replica dies (WorkerDiedError) or closes under the
        request (ServerClosedError), the request is resubmitted to a
        DIFFERENT replica — bounded by the remaining deadline, by one
        attempt per replica plus one (so a pool where everything is
        dying still terminates with the typed error), and by the
        retry budget when one is configured (exhaustion raises
        RetryBudgetExhaustedError instead of storming). Timeouts and
        request-content errors never fail over: a deadline that
        expired on one replica has expired everywhere, and a bad feed
        is bad everywhere.

        With no timeout the router's ``default_timeout_s`` applies —
        resolved ONCE here, so failover hops inherit the original
        deadline rather than restarting the clock per hop.

        Interactive-tier requests hedge when ``hedge_delay_s`` and a
        retry budget are configured (see _await_hedged). The
        ``serving_retry_storm`` fault point drops a completed
        attempt's answer in flight, forcing a retry — the drill that
        proves the budget bounds amplification."""
        if timeout is None:
            timeout = self.default_timeout_s
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        rank = self._resolve_rank(kw.get("slo"), kw.get("priority"))
        hedged = (self.hedge_delay_s is not None
                  and self.retry_budget is not None
                  and rank == PRIORITIES["interactive"])
        attempts = max(2, len(self.pool.replicas()) + 1)
        last = None
        for _ in range(attempts):
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                break
            handle = self.submit(item, timeout=remaining, **kw)
            if _faultinject.fires("serving_retry_storm"):
                # chaos: the attempt's answer is lost in flight (the
                # replica still burns capacity serving it — exactly
                # how a real retry storm feeds itself); the retry
                # below must pass the budget gate
                last = WorkerDiedError(
                    "injected retry storm: response dropped in "
                    "flight")
                self._spend_retry(last)
                self.pool.incr("failovers_total")
                continue
            try:
                if hedged:
                    result = self._await_hedged(handle, deadline,
                                                item, kw)
                else:
                    # grace past the serving deadline, like
                    # engine.infer: the structured error is the real
                    # signal
                    result = handle.result(
                        None if remaining is None
                        else remaining + 10.0)
                self._note_success()
                return result
            except (WorkerDiedError, ServerClosedError) as exc:
                last = exc
                if not failover:
                    raise
                self._spend_retry(exc)
                self.pool.incr("failovers_total")
        if last is not None:
            raise last
        raise NoReadyReplicaError(
            "request deadline expired before any replica answered")

    # -- disaggregated prefill/decode ------------------------------------
    def generate(self, prompt, max_new=None, timeout=None, slo=None,
                 **kw):
        """Generate over a DISAGGREGATED pool: prefill on a
        ``role="prefill"`` replica (``prefill_only=True`` — it resolves
        with a KV handoff blob, never holding a decode slot), then hand
        the blob to a ``role="decode"`` replica via the ``handoff``
        verb and return its full token sequence. With no role split in
        the pool this degrades to the ordinary failover ``infer``.

        Fault containment is the same zero-loss contract as infer():
        every refusal or death is typed, and each phase redrives on a
        surviving replica of its role while the deadline allows. The
        ``serving_handoff_drop`` chaos point fires in the gap between
        prefill completing and the blob reaching a decode replica — the
        prefill replica dies WITH the KV state, so the only correct
        recovery is a fresh prefill on a survivor (counted in
        ``handoff_redrives_total``).

        Deadline/SLO inheritance: the timeout (caller's, or the
        router's ``default_timeout_s``) is resolved to ONE absolute
        deadline here, before any hop, and every re-prefill and
        failover hop runs against the remainder — a redrive can
        expire, it can never restart the clock. The SLO (class AND
        priority) rides ``sub_kw`` onto every hop, and redrive hops
        carry ``queued_for_s`` (time already burned since entry) so
        the serving engine backdates ``enqueued_at`` — TTFT and EDF
        order are measured from the ORIGINAL arrival on whichever
        replica finally serves the request. Redrives and failovers
        consume the retry budget when one is configured."""
        sub_kw = dict(kw)
        if max_new is not None:
            sub_kw["max_new"] = max_new
        if slo is not None:
            sub_kw["slo"] = slo
        if timeout is None:
            timeout = self.default_timeout_s
        if not self._candidates(role="prefill") \
                or not self._candidates(role="decode"):
            return self.infer(prompt, timeout=timeout, **sub_kw)
        t_entry = time.monotonic()
        deadline = (None if timeout is None
                    else t_entry + float(timeout))

        def _remaining():
            return (None if deadline is None
                    else deadline - time.monotonic())

        # phase 1: prefill → KV handoff blob
        attempts = max(2, len(self.pool.replicas()) + 1)
        state = None
        last = None
        first_hop = True
        for _ in range(attempts):
            rem = _remaining()
            if rem is not None and rem <= 0:
                break
            cands = self._candidates(role="prefill")
            if not cands:
                last = NoReadyReplicaError(
                    "no prefill-role replica is eligible")
                time.sleep(0.05)  # the pool monitor revives crashed ones
                continue
            rep = cands[0]
            hop_kw = dict(sub_kw)
            if not first_hop:
                # a redrive: the new replica must measure TTFT from
                # the original arrival, not from this hop
                hop_kw["queued_for_s"] = time.monotonic() - t_entry
            first_hop = False
            try:
                handle = rep.submit(prompt, timeout=rem,
                                    prefill_only=True, **hop_kw)
                state = handle.result(
                    None if rem is None else rem + 10.0)
            except PagesExhaustedError:
                raise        # never-fits: identical on every replica
            except _REROUTABLE as exc:
                last = exc
                self._spend_retry(exc)
                self.pool.incr("handoff_redrives_total")
                continue
            if _faultinject.fires("serving_handoff_drop"):
                # chaos: the prefill replica dies WITH the finished
                # blob, before any decode replica saw it — the KV
                # state is gone, so recovery is a fresh prefill on a
                # survivor, never a dangling half-handoff
                rep.crash()
                state = None
                last = WorkerDiedError(
                    f"prefill replica {rep.name} died mid-handoff")
                self._spend_retry(last)
                self.pool.incr("handoff_redrives_total")
                continue
            break
        if state is None:
            if last is not None:
                raise last
            raise NoReadyReplicaError(
                "request deadline expired before prefill completed")

        # phase 2: blob → decode-role replica
        hand_kw = {} if slo is None else {"slo": slo}
        last = None
        for _ in range(attempts):
            rem = _remaining()
            if rem is not None and rem <= 0:
                break
            cands = self._candidates(role="decode")
            if not cands:
                last = NoReadyReplicaError(
                    "no decode-role replica is eligible")
                time.sleep(0.05)
                continue
            rep = cands[0]
            try:
                handle = rep.handoff(state, timeout=rem, **hand_kw)
                self.pool.incr("handoffs_total")
                result = handle.result(
                    None if rem is None else rem + 10.0)
                self._note_success()
                return result
            except _REROUTABLE as exc:
                # the router still holds the blob, so a decode death
                # replays it on the next decode replica — the handoff
                # is idempotent (import allocates fresh pages)
                last = exc
                self._spend_retry(exc)
                self.pool.incr("failovers_total")
        if last is not None:
            raise last
        raise NoReadyReplicaError(
            "request deadline expired before any decode replica "
            "answered")

    # -- introspection / lifecycle ---------------------------------------
    def stats(self):
        snap = self.pool.stats()
        snap["policy"] = self.policy.name
        snap["max_cluster_queue"] = self.max_cluster_queue
        snap["weights"] = self.weights()
        # the operator's view of the knee: the admission controller's
        # live limit + pressure (sojourn EWMA over its target), the
        # retry-budget level, and the per-class outstanding/shed
        # split — visible, not inferred
        adm = (None if self.admission is None
               else self.admission.snapshot())
        pressure = None
        if adm is not None and adm["sojourn_ewma_s"] is not None:
            pressure = min(1.0, adm["sojourn_ewma_s"]
                           / adm["target_delay_s"])
        snap["overload"] = {
            "admission": adm,
            "pressure": pressure,
            "retry_budget": (None if self.retry_budget is None
                             else self.retry_budget.snapshot()),
            "hedge_delay_s": self.hedge_delay_s,
            "default_timeout_s": self.default_timeout_s,
            "outstanding_by_class": self._per_class_outstanding(),
            "shed_by_class": {
                name: snap.get(f"shed_{name}_total", 0)
                for name in PRIORITIES},
        }
        return snap

    def close(self, drain=False, drain_timeout=None):
        self.pool.close(drain=drain, drain_timeout=drain_timeout)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
