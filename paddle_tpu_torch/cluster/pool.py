"""ReplicaPool — owns N serving replicas and their lifecycle.

The pool is the control plane the Router (data plane) reads:

- **construction** — ``factory`` is a zero-arg callable returning a
  started engine (ServingEngine or DecodeEngine) or a ready
  :class:`~paddle_tpu_torch.cluster.replica.Replica`; the pool builds
  ``replicas`` of them (warming each when ``warmup=True``) and names
  them ``replica-0..N-1``.
- **revival** — a monitor thread watches for dead replicas (worker
  thread died, process exited) and revives them in place
  (``replica.start()``: same compile cache for in-process replicas, a
  respawn for process replicas), counted in ``revives_total``. The
  engine-level watchdog already failed that replica's pending
  requests with WorkerDiedError; the router's failover resubmits
  them elsewhere meanwhile.
- **scaling** — ``scale_up()`` adds warmed replicas; ``scale_down()``
  drains and removes them (finish what they admitted, take nothing
  new) — traffic-spike response once artifact warmup is fast.
- **rolling restart** — ``rolling_restart()`` is the zero-downtime
  deploy: one replica at a time is flagged ``restarting`` (the router
  stops picking it), drained via the engine's own
  ``close(drain=True)``, rebuilt fresh from the factory, re-warmed,
  and put back. At most one replica is ever out of rotation, so the
  pool never reports fewer than N-1 READY replicas and — with the
  router steering — zero requests are lost (proven under load by
  ``chip_smoke.py``'s ``cluster_serve`` phase and the chaos
  suite).
- **stats** — per-replica snapshots plus a pool-wide merge:
  ``ServingMetrics.merge`` combines every in-process replica's
  registry into cluster p50/p95/p99 and counters under ``"cluster"``.
"""
import threading
import time

from ..serving.health import HealthState
from ..serving.metrics import ServingMetrics
from .replica import InProcessReplica, Replica

__all__ = ["ReplicaPool"]

_POOL_COUNTERS = ("revives_total", "restarts_total",
                  "cluster_shed_total", "reroutes_total",
                  "failovers_total", "handoffs_total",
                  "handoff_redrives_total",
                  # overload robustness: cluster sheds broken
                  # out by priority tier (the shed-ordering proof),
                  # retry-budget exhaustions (a retry that failed fast
                  # instead of storming), and hedging (duplicates sent
                  # / duplicates that won)
                  "shed_interactive_total", "shed_standard_total",
                  "shed_batch_total", "retry_budget_exhausted_total",
                  "hedges_total", "hedge_wins_total")


class ReplicaPool:
    """N replicas from one factory + lifecycle orchestration.

    ``revive_interval_s`` is how often the monitor checks liveness
    (0 disables the monitor — tests drive ``revive_dead()`` by hand).
    """

    def __init__(self, factory, replicas=2, warmup=False,
                 revive_interval_s=0.25, name_prefix="replica"):
        if replicas < 1:
            raise ValueError("a pool needs at least one replica")
        self._factory = factory
        self._warmup = bool(warmup)
        self._prefix = name_prefix
        self._lock = threading.Lock()
        self._counters = {name: 0 for name in _POOL_COUNTERS}
        self._made = 0
        self._replicas = [self._make_replica() for _ in range(replicas)]
        self._closed = False
        self._closers = []       # companion shutdowns (membership, …)
        self._monitor = None
        self._monitor_stop = threading.Event()
        self.revive_interval_s = float(revive_interval_s)
        if self.revive_interval_s > 0:
            self._monitor = threading.Thread(
                target=self._monitor_loop,
                name="paddle-tpu-pool-monitor", daemon=True)
            self._monitor.start()

    def _make_replica(self):
        with self._lock:
            name = f"{self._prefix}-{self._made}"
            self._made += 1
        built = self._factory()
        if isinstance(built, Replica):
            built.name = name
            replica = built
            if self._warmup:
                replica.warmup()
        else:
            replica = InProcessReplica(self._factory, name=name,
                                       warmup=self._warmup,
                                       engine=built)
        return replica

    # -- views -----------------------------------------------------------
    def replicas(self):
        with self._lock:
            return list(self._replicas)

    def __len__(self):
        with self._lock:
            return len(self._replicas)

    def ready_count(self):
        return sum(r.alive() and not r.restarting
                   and r.health_state() == HealthState.READY
                   for r in self.replicas())

    def total_outstanding(self):
        return sum(r.outstanding() for r in self.replicas())

    def incr(self, name, n=1):
        with self._lock:
            self._counters[name] += n

    # -- lifecycle -------------------------------------------------------
    def warmup(self):
        """Warm every replica; returns the per-replica reports."""
        return {r.name: r.warmup() for r in self.replicas()}

    def scale_up(self, n=1):
        """Add ``n`` fresh (warmed, if the pool warms) replicas."""
        added = [self._make_replica() for _ in range(int(n))]
        with self._lock:
            self._replicas.extend(added)
        return added

    def scale_down(self, n=1, drain=True, drain_timeout=None):
        """Remove the ``n`` newest replicas; each finishes what it
        admitted (``drain=True``) before closing."""
        with self._lock:
            n = min(int(n), len(self._replicas) - 1)
            if n <= 0:
                return []
            removed = self._replicas[len(self._replicas) - n:]
            del self._replicas[len(self._replicas) - n:]
        for r in removed:
            r.close(drain=drain, drain_timeout=drain_timeout)
        return removed

    def revive_dead(self):
        """One revival sweep; returns the replicas revived. Called by
        the monitor thread (and directly by deterministic tests)."""
        revived = []
        if self._closed:
            return revived
        for r in self.replicas():
            if r.restarting or r.alive():
                continue
            if r.health_state() == HealthState.STOPPED:
                continue     # deliberately closed, not a death
            r.start()
            self.incr("revives_total")
            revived.append(r)
        return revived

    def _monitor_loop(self):
        while not self._monitor_stop.wait(self.revive_interval_s):
            if self._closed:
                return
            try:
                self.revive_dead()
            except Exception:                 # noqa: BLE001
                # a failed revival must not kill the monitor; the next
                # sweep retries (the replica stays ineligible while
                # dead, so traffic keeps flowing around it)
                pass

    def rolling_restart(self, drain_timeout=None, warmup=None):
        """Zero-downtime deploy: restart every replica, one at a time.

        Per replica: flag ``restarting`` (the router stops picking
        it) → ``close(drain=True)`` (every admitted request finishes,
        bounded by ``drain_timeout``) → rebuild fresh from the factory
        → warm up → back in rotation. Returns a report including
        ``min_ready_observed`` — with one-at-a-time rotation it is
        N-1 unless something ELSE failed mid-restart."""
        return self.restart_replicas(None, drain_timeout=drain_timeout,
                                     warmup=warmup)

    def restart_replicas(self, replicas=None, factory=None,
                         version=None, drain_timeout=None, warmup=None):
        """The generalized rolling restart: restart a SUBSET of
        replicas, optionally swapping them onto a different
        ``factory`` and stamping a ``version`` label — the primitive
        ``cluster/deploy.py`` uses both to convert k replicas to a
        canary version and to roll them back to the incumbent. Same
        zero-loss choreography as :meth:`rolling_restart` (flag →
        drain → rebuild → re-warm, one at a time), same report shape.
        ``replicas=None`` restarts every replica; a whole-pool restart
        onto a new ``factory`` also makes it the pool's factory for
        future ``scale_up()`` builds (the version won), while a SUBSET
        conversion leaves the pool's factory alone — ``scale_up()``
        during a canary must add incumbent capacity, never more
        unproven canaries."""
        warmup = self._warmup if warmup is None else bool(warmup)
        whole_pool = replicas is None
        targets = self.replicas() if whole_pool else list(replicas)
        if factory is not None and whole_pool:
            with self._lock:
                self._factory = factory
        t0 = time.monotonic()
        restarted = []
        rewarm = {}
        min_ready = None
        for r in targets:
            if self._closed:
                break
            r.restarting = True
            try:
                r.close(drain=True, drain_timeout=drain_timeout)
                # the moment of minimum capacity: old engine gone, new
                # one not yet built
                ready_now = self.ready_count()
                min_ready = (ready_now if min_ready is None
                             else min(min_ready, ready_now))
                if factory is None:
                    r.rebuild(warmup=warmup)
                else:
                    r.rebuild(warmup=warmup, factory=factory)
                if version is not None:
                    r.version = version
            finally:
                r.restarting = False
            self.incr("restarts_total")
            restarted.append(r.name)
            rewarm[r.name] = r.last_rebuild_report
        return {"restarted": restarted,
                "min_ready_observed": min_ready,
                "ready_after": self.ready_count(),
                # per-replica rewarm reports: with an artifact store
                # behind the factory these show compiles: 0 — restart
                # cost is loading, not step builds
                "rewarm": rewarm,
                "wall_s": round(time.monotonic() - t0, 3)}

    def register_closer(self, fn):
        """Register a zero-arg callable run at ``close()`` — the hook
        companion subsystems (the remote-fabric membership refresher)
        use to share the pool's lifecycle."""
        self._closers.append(fn)
        return self

    def close(self, drain=False, drain_timeout=None):
        self._closed = True
        for fn in self._closers:
            try:
                fn()
            except Exception:                 # noqa: BLE001
                pass         # a companion's failure must not block the
        self._monitor_stop.set()              # pool's own shutdown
        if self._monitor is not None:
            self._monitor.join(5.0)
            self._monitor = None
        for r in self.replicas():
            r.close(drain=drain, drain_timeout=drain_timeout)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- stats -----------------------------------------------------------
    def stats(self):
        """Pool snapshot: lifecycle counters, per-replica summaries,
        and the merged cluster-wide metrics (pool p50/p95/p99 over
        every in-process replica's registry; process replicas report
        per-replica only — their registries live across the pipe)."""
        replicas = self.replicas()
        per = []
        metric_objs = []
        by_version = {}
        for r in replicas:
            per.append({"name": r.name,
                        "alive": r.alive(),
                        "health_state": r.health_state(),
                        "outstanding": r.outstanding(),
                        "admits": r.admits(),
                        "restarting": r.restarting,
                        "version": r.version})
            m = r.metrics_obj()
            if m is not None:
                metric_objs.append(m)
                if r.version is not None:
                    by_version.setdefault(r.version, []).append(m)
        with self._lock:
            snap = dict(self._counters)
        snap["n_replicas"] = len(replicas)
        snap["ready_replicas"] = sum(
            p["alive"] and not p["restarting"]
            and p["health_state"] == HealthState.READY for p in per)
        snap["total_outstanding"] = sum(p["outstanding"] for p in per)
        snap["replicas"] = per
        snap["cluster"] = (ServingMetrics.merge(*metric_objs).stats()
                           if metric_objs else None)
        # per-version merged views (a pool serving a canary beside its
        # incumbent): each version's replicas merge into their own
        # registry so the canary's error-rate/p99 is directly
        # comparable to the incumbent's — the numbers the promotion
        # guardrails read (cluster/deploy.py)
        snap["versions"] = ({str(v): ServingMetrics.merge(*ms).stats()
                             for v, ms in by_version.items()}
                            if by_version else None)
        return snap
