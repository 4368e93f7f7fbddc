"""Elastic fault-tolerant data-parallel training over the serving
fabric (port of ``paddle_tpu/cluster/train_fabric.py``).

*Serving* has a cross-host socket fabric (CRC frames, typed
transport errors, breakers, membership). This module lifts *training*
onto the same wire: a :class:`TrainCoordinator` (one process, the
parameter-server role of Paddle's distribute transpiler — PAPER.md §1)
drives N :class:`~paddle_tpu_torch.cluster.train_worker.TrainWorkerServer`
hosts through a step-synchronized loop, and every failure mode is a
*typed, recoverable* event instead of a lost run:

- **heartbeat-missed / straggler-deadline** → the worker is evicted
  and the step is retried at reduced world size (elastic down);
- **rejoin / replacement** → a host cold-provisions its
  ``__artifacts__`` over the wire from any live peer
  (``provision_from_remote``), catches up from the
  last committed state, and is folded back into the shard assignment
  (elastic up);
- **coordinator crash** → workers park at the barrier under a
  deadline; a new coordinator resumes from the last committed
  checkpoint serial and the run continues.

Determinism is the load-bearing design decision: the global batch of
every step is cut into a FIXED number of logical shards
(``n_shards``), workers return per-shard gradient *sums*, and the
coordinator reduces them in shard-index order before applying the
update. The math of step S is therefore a pure function of
(committed state at S-1, S, the data) — independent of world size,
shard→worker assignment, evictions, or which host died — so crash
resume is bit-deterministic: same params sha at step S as an
uninterrupted run (``chip_smoke.py``'s ``train_fabric`` phase holds
exactly this on the card).

Commit discipline: every ``commit_interval`` steps the coordinator
writes the state through the crash-safe store
(``resilience/checkpoint.py`` — temp → fsync → rename, per-array
sha256 manifest, leader-only pruning under ``PADDLE_TPU_CKPT_KEEP``)
and broadcasts ``(step, state, sha)`` to every live worker, which
re-hashes and VERIFIES the sha (leader-writes / followers-verify). A
kill -9 of any worker — or the coordinator — mid-step never loses a
committed step; at worst the uncommitted tail is recomputed, to the
same bits.

Wire verbs (cluster/net.py frames, after the hello/welcome
handshake)::

    {"type": "train_configure", "id": n, "task": {...spec...}}
        -> {"type": "train_configured", "id": n, "name": ...,
            "total_compiles": c}
    {"type": "train_step", "id": n, "step": s, "state": {...},
     "shards": [ids], "n_shards": k}
        -> {"type": "train_grads", "id": n, "step": s,
            "shards": {id: {"loss_sum": f, "n_rows": r,
                            "grads": {name: array}}}}
    {"type": "train_commit", "id": n, "step": s, "serial": s,
     "state": {...}, "sha": hex}
        -> {"type": "train_committed", "id": n, "ok": bool,
            "sha": worker_sha}
    {"type": "stats"/"ping"/"fetch_manifest"/"fetch_artifact"/"bye"}
        — identical to the serving fabric (provisioning included).

Fault points (``resilience/faultinject.py``): the worker-side step
handler checks ``trainer_crash_at_step`` (hard death) and
``trainer_straggle`` (stall past the straggler deadline) and marks
``train_step`` progress events; the coordinator's RPC path checks
``train_net_partition`` and its step loop ``coordinator_crash`` —
all four ride the fault layer's event-barrier discipline so chaos drills are
deterministic on any host.
"""
import os
import threading
import time

import numpy as np

from ..resilience import checkpoint as _ckpt
from ..resilience import faultinject as _faultinject
from ..serving.health import (HealthState, ServiceUnavailableError)
from ..serving.metrics import ServingMetrics
from . import net
from .membership import Membership

__all__ = ["TrainTaskError", "NoTrainWorkersError", "CommitMismatch",
           "LinRegTask", "ProgramGradTask", "task_from_spec",
           "WorkerClient", "TrainCoordinator"]

_STRAGGLE_ENV = "PADDLE_TPU_FAULT_STRAGGLE_S"


class TrainTaskError(ValueError):
    """A task spec is malformed or names an unknown task kind."""


class NoTrainWorkersError(ServiceUnavailableError):
    """Every worker is evicted/unreachable and the admit deadline
    expired — the step cannot run at ANY world size. IS-A
    ServiceUnavailableError so fleet tooling treats it like an
    unservable cluster, not a crash."""


class CommitMismatch(_ckpt.CheckpointError):
    """A follower's re-hash of the committed state disagreed with the
    leader's manifest sha — bitwise divergence, the one thing the
    fabric must never paper over."""


# TrainTaskError is raised worker-side (task-spec validation) and
# forwarded as a wire pair; without registration it would re-raise on
# the coordinator as a bare ServingError and the typed-refusal tests
# would pass only in-process
net.register_wire_error(TrainTaskError)
net.register_wire_error(NoTrainWorkersError)


# ---------------------------------------------------------------------------
# tasks — the unit of work the fleet agrees on
# ---------------------------------------------------------------------------
#
# A task is the deterministic triple the coordinator and every worker
# rebuild from one wire-safe spec dict (plain containers only — it
# travels inside a restricted-unpickle frame):
#
#   init_state()                          -> {name: np.ndarray}
#   grad_sums(state, step, shard, n)      -> (loss_sum, {name: gsum}, rows)
#   apply(state, gsums, n_rows, step)     -> new state      (coordinator)
#
# grad_sums returns per-shard SUMS (not means): the coordinator adds
# shards in shard-index order and divides once, so the reduction is
# bit-identical however shards are assigned to workers.


class LinRegTask:
    """Analytic linear regression on deterministic synthetic data —
    pure numpy, zero compiles, sub-millisecond steps. The unit-test
    and faultsmoke task: every fabric behavior (barrier, eviction,
    commit, resume) is exercised without a device in the loop."""

    kind = "linreg"

    def __init__(self, dim=8, rows_per_shard=4, lr=0.1, seed=0):
        self.dim = int(dim)
        self.rows_per_shard = int(rows_per_shard)
        self.lr = float(lr)
        self.seed = int(seed)
        rng = np.random.RandomState(self.seed)
        self._w_true = rng.standard_normal(self.dim).astype(np.float32)

    def spec(self):
        return {"kind": self.kind, "dim": self.dim,
                "rows_per_shard": self.rows_per_shard,
                "lr": self.lr, "seed": self.seed}

    @classmethod
    def from_spec(cls, spec):
        return cls(dim=spec.get("dim", 8),
                   rows_per_shard=spec.get("rows_per_shard", 4),
                   lr=spec.get("lr", 0.1), seed=spec.get("seed", 0))

    def init_state(self):
        return {"w": np.zeros(self.dim, np.float32)}

    def _shard_data(self, step, shard):
        rng = np.random.RandomState(
            self.seed + 100003 * (step + 1) + shard)
        x = rng.standard_normal(
            (self.rows_per_shard, self.dim)).astype(np.float32)
        y = (x @ self._w_true).astype(np.float32)
        return x, y

    def grad_sums(self, state, step, shard, n_shards):
        x, y = self._shard_data(step, shard)
        err = (x @ state["w"] - y).astype(np.float32)
        loss_sum = float(np.sum(err.astype(np.float64) ** 2))
        g = (2.0 * x.T @ err).astype(np.float32)
        return loss_sum, {"w": g}, self.rows_per_shard

    def apply(self, state, gsums, n_rows, step):
        w = state["w"] - np.float32(self.lr) * (
            gsums["w"] / np.float32(n_rows))
        return {"w": w.astype(np.float32)}

    def total_compiles(self):
        return 0


class ProgramGradTask:
    """A real fluid train program split pserver-style: the worker runs
    forward + ``append_backward`` and fetches per-shard gradient sums
    through the Executor on ``place`` (the worker's: the card unless
    the host was asked for), as numpy; the coordinator applies the SGD
    update in deterministic host numpy, so every world size gives the
    same bits. The artifact store is attached as in the reference, but
    the port's store holds no train step (ROADMAP.md §3 F6): a
    provisioned host builds the gradient step once.

    The program — data → fc(tanh) → fc → square_error_cost → mean —
    is rebuilt from the spec on every host; the canonical
    program hash makes the artifact keys match across processes, which
    is what cold wire-provisioning relies on."""

    kind = "program"

    def __init__(self, dim=8, hidden=8, rows_per_shard=4, lr=0.05,
                 seed=0, artifact_dir=None, place=None):
        self.dim = int(dim)
        self.hidden = int(hidden)
        self.rows_per_shard = int(rows_per_shard)
        self.lr = float(lr)
        self.seed = int(seed)
        self.artifact_dir = artifact_dir
        self.place = place      # host-local like artifact_dir
        self._built = None      # lazy: the coordinator never builds

    def spec(self):
        # artifact_dir is deliberately host-local (CLI/ctor), never
        # part of the wire spec — the math is shared, the cache is not
        return {"kind": self.kind, "dim": self.dim,
                "hidden": self.hidden,
                "rows_per_shard": self.rows_per_shard,
                "lr": self.lr, "seed": self.seed}

    @classmethod
    def from_spec(cls, spec, artifact_dir=None, place=None):
        return cls(dim=spec.get("dim", 8), hidden=spec.get("hidden", 8),
                   rows_per_shard=spec.get("rows_per_shard", 4),
                   lr=spec.get("lr", 0.05), seed=spec.get("seed", 0),
                   artifact_dir=artifact_dir, place=place)

    def _build(self):
        if self._built is not None:
            return self._built
        from ..core import framework
        from ..core.backward import append_backward
        from ..core.executor import Scope
        from .. import layers
        main, startup = framework.Program(), framework.Program()
        with framework.program_guard(main, startup), \
                framework.unique_name.guard():
            x = layers.data(name="x", shape=[self.dim],
                            dtype="float32")
            y = layers.data(name="y", shape=[1], dtype="float32")
            h = layers.fc(input=x, size=self.hidden, act="tanh")
            pred = layers.fc(input=h, size=1)
            loss = layers.mean(layers.square_error_cost(
                input=pred, label=y))
            params_grads = append_backward(loss)
        self._built = {
            "main": main, "loss": loss,
            "params_grads": [(p.name, g) for p, g in params_grads],
            "scope": Scope(),
        }
        return self._built

    def _exe(self):
        """The worker's Executor, made at its first gradient step: the
        coordinator reads the program's shapes and runs nothing, so it
        needs no device."""
        b = self._build()
        if "exe" not in b:
            from ..core.executor import Executor
            b["exe"] = Executor(self.place,
                                compile_store=self.artifact_dir)
        return b["exe"]

    def param_shapes(self):
        b = self._build()
        gb = b["main"].global_block()
        return {name: tuple(int(d) for d in gb.var(name).shape)
                for name, _g in b["params_grads"]}

    def init_state(self):
        shapes = self.param_shapes()
        rng = np.random.RandomState(self.seed)
        return {name: (rng.standard_normal(shapes[name]) * 0.1
                       ).astype(np.float32)
                for name in sorted(shapes)}

    def _shard_data(self, step, shard):
        rng = np.random.RandomState(
            self.seed + 100003 * (step + 1) + shard)
        x = rng.standard_normal(
            (self.rows_per_shard, self.dim)).astype(np.float32)
        y = np.tanh(x.sum(axis=1, keepdims=True)).astype(np.float32)
        return x, y

    def grad_sums(self, state, step, shard, n_shards):
        b = self._build()
        for name, value in state.items():
            b["scope"].set(name, np.asarray(value))
        x, y = self._shard_data(step, shard)
        fetch = [b["loss"]] + [g for _n, g in b["params_grads"]]
        outs = self._exe().run(b["main"], feed={"x": x, "y": y},
                            fetch_list=fetch, scope=b["scope"])
        rows = self.rows_per_shard
        # the mean fetches as shape [1]: one element, read as a scalar
        loss_sum = float(np.asarray(outs[0]).reshape(-1)[0]) * rows
        gsums = {name: np.asarray(g, np.float32) * np.float32(rows)
                 for (name, _gv), g in zip(b["params_grads"],
                                           outs[1:])}
        return loss_sum, gsums, rows

    def apply(self, state, gsums, n_rows, step):
        inv = np.float32(1.0 / n_rows)
        lr = np.float32(self.lr)
        return {name: (np.asarray(state[name], np.float32)
                       - lr * gsums[name] * inv).astype(np.float32)
                for name in sorted(state)}

    def total_compiles(self):
        if self._built is None or "exe" not in self._built:
            return 0
        return self._built["exe"].total_compiles()


_TASK_KINDS = {"linreg": LinRegTask, "program": ProgramGradTask}


def task_from_spec(spec, artifact_dir=None, place=None):
    """Rebuild a task from its wire spec (the worker side of
    ``train_configure``); ``place`` is where a program task computes.
    Raises :class:`TrainTaskError` on anything malformed — a typed
    refusal, never an import or KeyError."""
    if not isinstance(spec, dict) or "kind" not in spec:
        raise TrainTaskError(f"malformed task spec: {spec!r}")
    cls = _TASK_KINDS.get(spec["kind"])
    if cls is None:
        raise TrainTaskError(
            f"unknown task kind {spec['kind']!r}; "
            f"known: {sorted(_TASK_KINDS)}")
    if cls is ProgramGradTask:
        return cls.from_spec(spec, artifact_dir=artifact_dir,
                             place=place)
    return cls.from_spec(spec)


# ---------------------------------------------------------------------------
# WorkerClient — the coordinator's handle to one worker host
# ---------------------------------------------------------------------------


class WorkerClient:
    """Synchronous deadline-bounded RPC to one TrainWorkerServer.

    Training is step-synchronized, so the client is deliberately
    simpler than RemoteReplica: one socket, one RPC in flight,
    serialized by a connection lock (the membership refresher and the
    step dispatcher share it). ANY failed RPC — timeout, partition,
    typed transport error — closes the connection, so a straggler's
    late reply can never desynchronize the frame stream; the next RPC
    reconnects fresh. Exposes the membership-view surface
    (``refresh``/``alive``/``health_state``/``outstanding``) so
    :class:`~paddle_tpu_torch.cluster.membership.Membership` drives
    heartbeats and staleness unchanged."""

    def __init__(self, addr, name=None, token=None,
                 connect_timeout_s=5.0, rpc_timeout_s=10.0,
                 stale_after_s=None, connect=None):
        self.addr = addr
        self.name = name or (addr if isinstance(addr, str)
                             else f"{addr[0]}:{addr[1]}")
        self._token = token
        self.connect_timeout_s = float(connect_timeout_s)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.stale_after_s = stale_after_s
        self._connect = connect or net.open_conn
        self._io_lock = threading.Lock()
        self._sock = None
        self._next_id = 0
        self._closed = False
        self._last_seen = None
        self._last_stats = {}
        # coordinator bookkeeping (mutated only under the coordinator's
        # own lock — see TrainCoordinator)
        self.admitted = False
        self.evicted_at = None
        self.last_step = None
        self.evictions = 0
        self.rejoins = 0
        self.metrics = ServingMetrics(extra_counters=(
            "train_steps_total", "train_rpc_failures_total",
            "train_evictions_total", "train_rejoins_total",
            "train_commits_total"))

    # -- transport ------------------------------------------------------
    def _drop_locked(self):
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def rpc(self, frame, timeout=None):
        """One request → one reply, bounded by ``timeout`` seconds.
        Typed wire errors re-raise as their original class; transport
        failures surface as RemoteUnavailableError /
        RequestTimeoutError and tear the connection down."""
        deadline = time.monotonic() + (self.rpc_timeout_s
                                       if timeout is None
                                       else float(timeout))
        with self._io_lock:
            if self._closed:
                raise net.RemoteUnavailableError(
                    f"worker client {self.name} is closed")
            if _faultinject.fires("train_net_partition"):
                self._drop_locked()
                raise net.RemoteUnavailableError(
                    f"injected train-net partition to {self.name}")
            if self._sock is None:
                # racecheck: ok(blocking-under-lock) — deadline-bounded
                # connect under the connection's serialization lock;
                # only the step dispatcher and the heartbeat share it
                sock, _welcome = self._connect(
                    self.addr, token=self._token, deadline=deadline,
                    connect_timeout=self.connect_timeout_s)
                self._sock = sock
                self._last_seen = time.monotonic()
            self._next_id += 1
            frame = dict(frame, id=self._next_id)
            try:
                # racecheck: ok(blocking-under-lock) — deadline-bounded
                # frame RPC under the write-serialization lock: one
                # request in flight per connection is the protocol, so
                # send+recv must be atomic w.r.t. concurrent callers
                net.send_frame(self._sock, frame, deadline=deadline)
                reply = net.recv_frame(self._sock, deadline=deadline)
            except Exception:
                self._drop_locked()
                raise
            if reply is None:
                self._drop_locked()
                raise net.RemoteUnavailableError(
                    f"worker {self.name} closed the connection "
                    "mid-RPC")
            self._last_seen = time.monotonic()
            if reply.get("type") == "stats":
                self._last_stats = reply.get("value") or {}
        if reply.get("type") in ("error", "protocol_error"):
            net.raise_wire_error(reply["error"])
        return reply

    # -- train verbs ----------------------------------------------------
    def configure(self, spec, timeout=None):
        reply = self.rpc({"type": "train_configure", "task": spec},
                         timeout=timeout)
        return reply

    def train_step(self, step, state, shards, n_shards, timeout=None):
        return self.rpc({"type": "train_step", "step": int(step),
                         "state": state, "shards": list(shards),
                         "n_shards": int(n_shards)}, timeout=timeout)

    def commit(self, step, state, sha, timeout=None):
        return self.rpc({"type": "train_commit", "step": int(step),
                         "serial": int(step), "state": state,
                         "sha": sha}, timeout=timeout)

    # -- membership-view surface ---------------------------------------
    def refresh(self, timeout=2.0):
        """One heartbeat: stats RPC (reconnecting if needed). Returns
        True when the worker answered."""
        if self._closed:
            return False
        try:
            self.rpc({"type": "stats"}, timeout=timeout)
            return True
        except (net.ServingError, OSError):
            return False

    def alive(self):
        return self._sock is not None and not self._closed

    def health_state(self):
        if self._closed:
            return HealthState.STOPPED
        if not self.alive() or self._stale():
            return HealthState.DEGRADED
        return HealthState.READY

    def _stale(self):
        if self.stale_after_s is None or self._last_seen is None:
            return False
        return time.monotonic() - self._last_seen \
            > float(self.stale_after_s)

    def outstanding(self):
        return 0        # step-synchronized: nothing queues client-side

    def last_seen_age_s(self):
        return (None if self._last_seen is None
                else round(time.monotonic() - self._last_seen, 3))

    def stats(self):
        return dict(self._last_stats)

    def close(self):
        with self._io_lock:
            self._closed = True
            self._drop_locked()
        return self

    def drop_connection(self):
        """Sever the link (eviction hygiene: a stale reply must never
        be read as a fresh one — the next RPC reconnects)."""
        with self._io_lock:
            self._drop_locked()


# ---------------------------------------------------------------------------
# TrainCoordinator
# ---------------------------------------------------------------------------


class TrainCoordinator:
    """Owns the state, the membership view, the step barrier, and the
    commit discipline for a fleet of train workers.

    Construction RESUMES: if ``checkpoint_dir`` holds a committed
    serial, the newest checksum-valid one is loaded (quarantine and
    fall back on damage, exactly the resilience-store read protocol)
    and training continues from the step after it — the coordinator
    crash-recovery path is the constructor, there is no separate
    recover() to get wrong.

    ``elastic=False`` disables eviction/retry (a worker failure
    raises) — the teeth-check mode that proves the chaos drill
    detects lost steps.
    """

    def __init__(self, task, workers, checkpoint_dir,
                 commit_interval=5, n_shards=None,
                 step_deadline_s=30.0, admit_deadline_s=10.0,
                 readmit_interval_s=0.2, token=None,
                 refresh_interval_s=0.0, stale_after_s=None,
                 keep_checkpoints=None, elastic=True):
        self.task = task
        self.checkpoint_dir = checkpoint_dir
        self.commit_interval = max(1, int(commit_interval))
        self.step_deadline_s = float(step_deadline_s)
        self.admit_deadline_s = float(admit_deadline_s)
        self.readmit_interval_s = float(readmit_interval_s)
        self.keep_checkpoints = keep_checkpoints
        self.elastic = bool(elastic)
        self._token = token
        self._lock = threading.Lock()
        self._clients = []
        self._events = []           # (kind, worker, step, reason)
        self._losses = []           # per-step global mean loss
        self._commits = []          # (step, sha)
        self.retries_total = 0
        self.evictions_total = 0
        self.rejoins_total = 0
        self.last_recover_s = None          # eviction → rejoin wall
        self._readmit_at = {}               # name -> next attempt time
        for w in workers:
            self.admit(w, _initial=True)
        self.n_shards = int(n_shards) if n_shards \
            else max(1, len(self._clients))
        # resume from the newest committed serial, or start fresh
        self.state = None
        self.step = 0
        self._committed_state = None    # catch-up payload for rejoins
        try:
            state, manifest, serial, _path = _ckpt.load_latest_valid(
                checkpoint_dir)
            self.state = state
            self.step = int(serial)
            self._committed_state = state
            meta = manifest.get("meta", {})
            with self._lock:
                self._commits.append(
                    (self.step, meta.get("params_sha")
                     or _ckpt.state_sha(state)))
        except FileNotFoundError:
            self.state = task.init_state()
        if stale_after_s is None:
            # refresh_interval_s=0 is the hand-driven test mode;
            # Membership's 3×interval default would degenerate to 0s
            # staleness and mark every worker DEGRADED on sight
            stale_after_s = max(3.0 * refresh_interval_s, 30.0)
        self.membership = Membership(
            list(self._clients), refresh_interval_s=refresh_interval_s,
            stale_after_s=stale_after_s)

    # -- membership / elasticity ---------------------------------------
    def admit(self, worker, _initial=False):
        """Add a worker (an address or a ready WorkerClient). The
        handshake + task configure + catch-up from the last committed
        state happen on the next admit sweep — a dead seed address
        never blocks construction."""
        client = worker if isinstance(worker, WorkerClient) \
            else WorkerClient(worker, token=self._token)
        with self._lock:
            self._clients.append(client)
            self._readmit_at[client.name] = 0.0
        membership = getattr(self, "membership", None)
        if not _initial and membership is not None:
            # fold the newcomer into the heartbeat view
            with membership._lock:
                membership._replicas.append(client)
                membership._alive_view.setdefault(client.name, None)
        return client

    def _record_event(self, kind, client, step, reason):
        with self._lock:
            self._events.append({
                "kind": kind, "worker": client.name, "step": step,
                "reason": reason, "t": time.monotonic()})

    def _evict(self, client, step, reason):
        with self._lock:
            if not client.admitted:
                return
            client.admitted = False
            client.evicted_at = time.monotonic()
            client.evictions += 1
            self.evictions_total += 1
            self._readmit_at[client.name] = (
                time.monotonic() + self.readmit_interval_s)
        client.metrics.incr("train_evictions_total")
        client.drop_connection()
        self._record_event("evicted", client, step, reason)

    def _try_admit(self, client):
        """One admit attempt: configure + catch up from the last
        committed state. Returns True when the worker is in."""
        try:
            client.configure(self.task.spec(),
                             timeout=self.step_deadline_s)
            step, sha = self.last_commit()
            if sha is not None and self._committed_state is not None:
                # catch up from the COMMITTED snapshot — the live
                # self.state may be steps past the barrier and would
                # never re-hash to the committed sha
                reply = client.commit(step, self._committed_state,
                                      sha,
                                      timeout=self.step_deadline_s)
                if not reply.get("ok"):
                    # bitwise divergence at the door: refuse, record,
                    # and keep the coordinator alive — the readmit
                    # sweep will retry after the worker re-syncs
                    self._record_event(
                        "admit_refused", client, self.step,
                        f"CommitMismatch: worker sha "
                        f"{reply.get('sha')} != leader sha {sha}")
                    return False
        except (net.ServingError, OSError):
            return False
        now = time.monotonic()
        with self._lock:
            was_evicted = client.evicted_at is not None
            client.admitted = True
            if was_evicted:
                client.rejoins += 1
                self.rejoins_total += 1
                self.last_recover_s = now - client.evicted_at
                client.evicted_at = None
        client.metrics.incr("train_rejoins_total")
        if was_evicted:
            self._record_event("rejoined", client, self.step,
                              f"recover_s={self.last_recover_s:.3f}")
        return True

    def _admit_sweep(self, block=False):
        """Try to (re)admit every non-admitted worker; with ``block``,
        keep trying until at least one worker is in or the admit
        deadline expires."""
        end = time.monotonic() + self.admit_deadline_s
        while True:
            now = time.monotonic()
            for client in list(self._clients):
                if client.admitted:
                    continue
                if now < self._readmit_at.get(client.name, 0.0):
                    continue
                with self._lock:
                    self._readmit_at[client.name] = (
                        now + self.readmit_interval_s)
                self._try_admit(client)
            live = [c for c in self._clients if c.admitted]
            if live or not block or time.monotonic() >= end:
                return live
            time.sleep(min(0.05, self.readmit_interval_s))

    def live_workers(self):
        return [c for c in self._clients if c.admitted]

    # -- the step loop --------------------------------------------------
    def _assignment(self, live):
        """Round-robin logical shards over the live workers, in
        deterministic (name-sorted) order. The ASSIGNMENT may change
        every step; the reduction order never does."""
        live = sorted(live, key=lambda c: c.name)
        out = {c: [] for c in live}
        for shard in range(self.n_shards):
            out[live[shard % len(live)]].append(shard)
        return out

    def _dispatch(self, assignment, step):
        """The barrier: every live worker computes its shards in
        parallel, bounded by the straggler deadline. Returns
        (per-shard results, failures)."""
        results = {}
        failures = {}
        res_lock = threading.Lock()

        def one(client, shards):
            t0 = time.monotonic()
            try:
                reply = client.train_step(
                    step, self.state, shards, self.n_shards,
                    timeout=self.step_deadline_s)
                got = reply.get("shards") or {}
                missing = [s for s in shards if s not in got
                           and str(s) not in got]
                if missing:
                    raise net.ServingError(
                        f"worker {client.name} answered step {step} "
                        f"without shards {missing}")
                with res_lock:
                    for s in shards:
                        results[s] = got.get(s, got.get(str(s)))
                client.metrics.incr("train_steps_total")
                client.metrics.observe_window(
                    "step_time_s", time.monotonic() - t0)
                with self._lock:
                    client.last_step = step
            except Exception as exc:    # noqa: BLE001 — typed below
                client.metrics.incr("train_rpc_failures_total")
                with res_lock:
                    failures[client] = exc

        threads = [threading.Thread(
            target=one, args=(c, s), daemon=True,
            name=f"train-dispatch-{c.name}")
            for c, s in assignment.items()]
        for t in threads:
            t.start()
        end = time.monotonic() + self.step_deadline_s + 1.0
        for t in threads:
            t.join(max(0.0, end - time.monotonic()))
        # a thread still alive past the deadline is a straggler whose
        # RPC will fail typed on its own recv deadline; its client is
        # treated as failed NOW
        for client in assignment:
            with res_lock:
                done = (client in failures
                        or all(s in results
                               for s in assignment[client]))
            if not done:
                failures.setdefault(client, net.RequestTimeoutError(
                    f"worker {client.name} missed the straggler "
                    f"deadline ({self.step_deadline_s}s) at step "
                    f"{step}"))
                client.drop_connection()
        return results, failures

    def step_once(self):
        """One committed-or-retried global step. Elastic: worker
        failures evict + retry at reduced world size; zero live
        workers parks up to the admit deadline then raises typed."""
        if _faultinject.fires("coordinator_crash"):
            raise _faultinject.SimulatedCrash(
                f"injected coordinator crash before step "
                f"{self.step + 1}")
        step = self.step + 1
        attempts = 0
        while True:
            live = self._admit_sweep(block=attempts > 0)
            if not live:
                raise NoTrainWorkersError(
                    f"no admitted train workers for step {step} "
                    f"within the {self.admit_deadline_s}s admit "
                    "deadline")
            assignment = self._assignment(live)
            results, failures = self._dispatch(assignment, step)
            if not failures:
                break
            for client, exc in failures.items():
                if not self.elastic:
                    raise exc
                self._evict(client, step,
                            f"{type(exc).__name__}: {exc}")
            with self._lock:
                self.retries_total += 1
            attempts += 1
        # deterministic reduction: shard-index order, sums first
        total_rows = 0
        total_loss = 0.0
        gsums = None
        for shard in range(self.n_shards):
            r = results[shard]
            total_rows += int(r["n_rows"])
            total_loss += float(r["loss_sum"])
            grads = r["grads"]
            if gsums is None:
                gsums = {k: np.asarray(v, np.float32).copy()
                         for k, v in grads.items()}
            else:
                for k in gsums:
                    gsums[k] += np.asarray(grads[k], np.float32)
        self.state = self.task.apply(self.state, gsums, total_rows,
                                     step)
        self.step = step
        with self._lock:
            self._losses.append(total_loss / max(1, total_rows))
        _faultinject.event("coordinator_step")
        if step % self.commit_interval == 0:
            self.commit()
        return self.step

    def run(self, num_steps):
        """Drive ``num_steps`` committed-or-retried steps."""
        for _ in range(int(num_steps)):
            self.step_once()
        return self.step

    # -- commit discipline ---------------------------------------------
    def commit(self):
        """The checkpoint barrier: leader writes the committed state
        through the crash-safe store (sha in the manifest meta,
        leader-only pruning), then every live worker re-hashes the
        broadcast state and verifies — a mismatch is bitwise
        divergence and evicts the worker typed."""
        sha = _ckpt.state_sha(self.state)
        _ckpt.save_state(
            self.checkpoint_dir, self.state, serial=self.step,
            meta={"step": self.step, "params_sha": sha,
                  "world_size": len(self.live_workers()),
                  "n_shards": self.n_shards},
            max_num_checkpoints=self.keep_checkpoints, leader=True)
        self._committed_state = self.state      # apply() never mutates
        with self._lock:
            self._commits.append((self.step, sha))
        for client in self.live_workers():
            try:
                reply = client.commit(self.step, self.state, sha,
                                      timeout=self.step_deadline_s)
            except (net.ServingError, OSError) as exc:
                self._evict(client, self.step,
                            f"commit barrier: {type(exc).__name__}: "
                            f"{exc}")
                continue
            client.metrics.incr("train_commits_total")
            if not reply.get("ok"):
                self._evict(client, self.step, CommitMismatch(
                    f"worker sha {reply.get('sha')} != leader sha "
                    f"{sha} at step {self.step}").args[0])
        _faultinject.event("train_commit")
        return sha

    def last_commit(self):
        with self._lock:
            return self._commits[-1] if self._commits else (0, None)

    def losses(self):
        with self._lock:
            return list(self._losses)

    def commits(self):
        with self._lock:
            return list(self._commits)

    def events(self):
        with self._lock:
            return list(self._events)

    # -- ops plane ------------------------------------------------------
    def stats(self):
        """The operator view: fleet position, per-worker rows
        (last_step, step-time percentiles, heartbeat age,
        evictions/rejoins), and one merged metrics registry with every
        worker's counters under its own ``<name>/`` namespace
        (ServingMetrics.merge label discipline — rows never
        collide)."""
        step, sha = self.last_commit()
        rows = []
        per_worker = []
        for c in list(self._clients):
            win = c.metrics.stats().get("step_time_s") or {}
            rows.append({
                "name": c.name,
                "addr": c.addr,
                "admitted": c.admitted,
                "alive": c.alive(),
                "health_state": c.health_state(),
                "last_step": c.last_step,
                "step_time_p50_ms": win.get("p50_ms"),
                "step_time_p99_ms": win.get("p99_ms"),
                "heartbeat_age_s": c.last_seen_age_s(),
                "evictions": c.evictions,
                "rejoins": c.rejoins,
                "remote": c.stats(),
            })
            per_worker.append(
                ServingMetrics.merge(c.metrics, label=c.name))
        merged = ServingMetrics.merge(*per_worker) if per_worker \
            else ServingMetrics()
        with self._lock:
            snap = {
                "step": self.step,
                "committed_step": step,
                "committed_sha": sha,
                "commits_total": len(self._commits),
                "world_size": sum(1 for c in self._clients
                                  if c.admitted),
                "n_shards": self.n_shards,
                "evictions_total": self.evictions_total,
                "rejoins_total": self.rejoins_total,
                "retries_total": self.retries_total,
                "last_recover_s": self.last_recover_s,
                "events": list(self._events[-32:]),
            }
        snap["workers"] = rows
        snap["membership"] = self.membership.stats()
        snap["metrics"] = merged.stats()
        return snap

    def close(self, goodbye=True):
        """Shut the coordinator down; the worker SERVERS keep running
        (they belong to their hosts, and they will park for the next
        coordinator)."""
        self.membership.close()
        for c in list(self._clients):
            c.close()
        return self
