"""Membership — the fabric's partition-tolerant discovery view.

A deliberately tiny design (static seeds + heartbeat refresh), because
the robustness property matters more than the gossip protocol: every
remote replica is periodically refreshed (one ``stats`` RPC that also
re-establishes a dead connection — the REJOIN path), and a replica
whose last successful contact is older than ``stale_after_s`` reads
DEGRADED, so the health-aware balancing policy ranks it behind every
fresh replica and the Router routes around it. A partition therefore
degrades a replica to *excluded*, and the first refresh after the
partition heals brings it back — never a hang, never an operator page
for a self-healing event.

``serve_remotes()`` is the one-call front door: seed addresses in, a
balanced Router over :class:`RemoteReplica` instances out, with the
membership refresher attached and closed together with the pool.
"""
import threading
import time

from ..serving.health import serving_rank
from .pool import ReplicaPool
from .remote import RemoteReplica
from .router import Router

__all__ = ["Membership", "serve_remotes"]


class Membership:
    """Heartbeat refresher + staleness view over a set of replicas.

    ``replicas`` is any list of Replica objects exposing
    ``refresh()`` (RemoteReplica does; a test fake needs one method).
    ``refresh_interval_s=0`` disables the thread — tests drive
    :meth:`refresh_once` by hand."""

    def __init__(self, replicas, refresh_interval_s=0.5,
                 stale_after_s=None):
        self._replicas = list(replicas)
        self.refresh_interval_s = float(refresh_interval_s)
        self.stale_after_s = (3 * self.refresh_interval_s
                              if stale_after_s is None
                              else float(stale_after_s))
        for r in self._replicas:
            # the replica's own health read honors the same staleness
            # bound the view reports, so router tiers and membership
            # agree about who is excluded
            if getattr(r, "stale_after_s", None) is None \
                    and hasattr(r, "stale_after_s"):
                r.stale_after_s = self.stale_after_s
        self._lock = threading.Lock()
        self._alive_view = {r.name: None for r in self._replicas}
        self.refreshes_total = 0
        self.evictions_total = 0
        self.rejoins_total = 0
        self._stop = threading.Event()
        self._thread = None
        if self.refresh_interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, name="paddle-tpu-membership",
                daemon=True)
            self._thread.start()

    def replicas(self):
        return list(self._replicas)

    def refresh_once(self):
        """One sweep: refresh every member, count evictions (answering
        → not) and rejoins (not → answering). Returns the number of
        members that answered."""
        answered = 0
        for r in self._replicas:
            try:
                ok = bool(r.refresh())
            except Exception:           # noqa: BLE001 — a failing
                ok = False              # member must not stop the sweep
            with self._lock:
                was = self._alive_view.get(r.name)
                self._alive_view[r.name] = ok
                if was is True and not ok:
                    self.evictions_total += 1
                if was is False and ok:
                    self.rejoins_total += 1
                self.refreshes_total += 1
            answered += ok
        return answered

    def _loop(self):
        while not self._stop.wait(self.refresh_interval_s):
            self.refresh_once()

    def view(self):
        """Per-member snapshot the operator (and servebench) reads."""
        out = []
        with self._lock:
            alive_view = dict(self._alive_view)
        for r in self._replicas:
            state = r.health_state()
            out.append({
                "name": r.name,
                "addr": getattr(r, "addr", None),
                "answering": alive_view.get(r.name),
                "alive": r.alive(),
                "health_state": state,
                "serving_rank": serving_rank(state),
                "outstanding": r.outstanding(),
                "last_seen_age_s": getattr(r, "_last_seen", None)
                and round(time.monotonic() - r._last_seen, 3),
                # which model version the member is actually serving:
                # the engine stamps model_version (from the export's
                # __meta__.json) into its stats, which remote replicas
                # cache from the welcome/stats frames — no extra RPC
                "model_version": (getattr(r, "_last_stats", None)
                                  or {}).get("model_version"),
            })
        return out

    def stats(self):
        with self._lock:
            return {"members": len(self._replicas),
                    "refreshes_total": self.refreshes_total,
                    "evictions_total": self.evictions_total,
                    "rejoins_total": self.rejoins_total,
                    "stale_after_s": self.stale_after_s}

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        return self


def serve_remotes(addresses, token=None, policy="health_aware",
                  max_cluster_queue=None, refresh_interval_s=0.25,
                  stale_after_s=None, lazy=False, **replica_kw):
    """A balanced, self-healing Router over remote replicas.

    ``addresses`` are ``"host:port"`` strings (or ``(host, port)``
    pairs, or ready RemoteReplica instances). The membership refresher
    owns reconnection (the pool's own revive monitor is disabled), so
    a partitioned replica is excluded by health tiering and rejoins
    within one refresh of the partition healing. Closing the router
    closes the membership thread and every client connection; the
    remote SERVERS keep running — they belong to their hosts."""
    replicas = [addr if isinstance(addr, RemoteReplica)
                else RemoteReplica(addr, token=token, lazy=lazy,
                                   **replica_kw)
                for addr in addresses]
    if not replicas:
        raise ValueError("serve_remotes needs at least one address")
    it = iter(replicas)
    pool = ReplicaPool(lambda: next(it), replicas=len(replicas),
                       revive_interval_s=0, name_prefix="remote")
    membership = Membership(pool.replicas(),
                            refresh_interval_s=refresh_interval_s,
                            stale_after_s=stale_after_s)
    pool.register_closer(membership.close)
    router = Router(pool, policy=policy,
                    max_cluster_queue=max_cluster_queue)
    router.membership = membership
    return router
