"""Replica wrappers — the unit the router balances over (port of
``paddle_tpu/cluster/replica.py``).

A replica is one serving engine plus the lifecycle state the pool
needs around it (restarting flag, revival, rebuild). Two backings
share one interface, so the same Router drives either:

- :class:`InProcessReplica` — the tested default: the engine lives in
  this process (its own worker thread, its own Executor compile
  cache; parameters share one read-only scope, held once). Death is a dead
  worker thread; revival is ``engine.start()``; a rolling-restart
  rebuild constructs a FRESH engine from the factory (a closed
  engine's admission queue never reopens — by design, close is a
  deploy boundary).
- :class:`ProcessReplica` — the same engine behind a separate OS
  process (``cluster/proc_worker.py`` serves a ``save_inference_model``
  directory over CRC-framed, restricted-unpickle ``cluster/net.py``
  frames on stdin/stdout).
  Death is process exit (chaos ``crash()`` is a real SIGKILL);
  revival/rebuild respawn the process, which re-warms from the
  artifact's serving manifest — the process-level half of the
  scale-out story, and the template for host-level replicas. The child
  runs on the card unless its spawner's place is the host (``--cpu``,
  :func:`worker_argv`).

Interface contract (everything the Router/Pool touch):
``submit(item, timeout=, **kw)`` returning a settled-once handle with
``wait``/``result``; ``outstanding()``; ``health_state()``;
``admits()`` (breaker read); ``alive()``; ``start()`` (revive in
place); ``rebuild()`` (fresh engine); ``close(drain=)``; ``warmup()``;
``stats()``; ``metrics_obj()`` (a ServingMetrics for pool merging, or
None); ``crash()`` (chaos).
"""
import os
import subprocess
import sys
import threading
import time

from ..serving.batching import (PendingResult, ServerClosedError,
                                ServingError)
from ..serving.health import HealthState, WorkerDiedError
# the pipe protocol speaks the SAME hardened frame format as the
# socket fabric (magic + version + CRC32, restricted unpickling): a
# stray write to the protocol fd is a typed FrameError on either
# transport, never pickle garbage
from .net import FrameError, WIRE_ERRORS, read_frame, write_frame

__all__ = ["Replica", "InProcessReplica", "ProcessReplica",
           "read_frame", "write_frame", "worker_argv", "worker_env"]


def _is_host(place):
    """Whether ``place`` (None: this process's default place) is the
    host — read without resolving a CUDA device."""
    if place is None:
        from ..core.executor import default_place
        place = default_place()
    from ..core.executor import CPUPlace
    if isinstance(place, str):
        return place == "cpu"
    return isinstance(place, CPUPlace) or \
        getattr(place, "type", None) == "cpu"


def worker_argv(module, place=None):
    """The command line of a fresh worker interpreter running
    ``paddle_tpu_torch.cluster.<module>`` (``proc_worker``,
    ``net_worker``, ``train_worker``): it runs on the card unless
    ``place`` (default: the caller's default place) is the host, which
    the child takes as ``--cpu``. Children are always a fresh
    interpreter, never a fork, so no CUDA state crosses."""
    argv = [sys.executable, "-m", f"paddle_tpu_torch.cluster.{module}"]
    if _is_host(place):
        argv.append("--cpu")
    return argv


def worker_env():
    """The environment of a worker child: the caller's, with this
    checkout first on ``PYTHONPATH``. Returns ``(env, repo_root)``."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep \
        + env.get("PYTHONPATH", "")
    return env, repo_root


def require_device(cpu):
    """A worker entry point's device check: the host when ``cpu``
    (``--cpu``; the process's default place becomes the host), else the
    card — a worker that finds no CUDA exits non-zero naming the
    reason instead of falling back to the host."""
    from ..core import executor
    if cpu:
        # racecheck: ok(global-mutation) — worker-process entry point,
        # called once before any engine or serving thread exists
        executor.force_cpu()
        return executor.CPUPlace()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write(
            "this worker runs on the card and torch finds no CUDA "
            "device; pass --cpu to run it on the host\n")
        sys.exit(2)
    return executor.CUDAPlace(0)


class Replica:
    """Base: naming + the restarting flag the router honors."""

    def __init__(self, name):
        self.name = name
        self.restarting = False     # rolling restart steers traffic away
        self.last_rebuild_report = None   # warmup report of last rebuild
        self.version = None         # deployment label (cluster/deploy.py)
        # disaggregated serving role: None (any work), "prefill"
        # (prefill_only submits that resolve with KV handoff blobs), or
        # "decode" (accepts handoff() imports). The Router's
        # role-filtered candidate lists read this tag.
        self.role = None

    # every method below is backing-specific
    def submit(self, item, timeout=None, **kw):
        raise NotImplementedError

    def handoff(self, state, timeout=None, **kw):
        """Adopt a KV handoff blob (decode engines only) — the decode
        half of prefill/decode disaggregation. Returns a settled-once
        handle like submit()."""
        raise NotImplementedError(
            f"{type(self).__name__} does not accept KV handoffs")

    def outstanding(self):
        raise NotImplementedError

    def health_state(self):
        raise NotImplementedError

    def admits(self):
        raise NotImplementedError

    def alive(self):
        raise NotImplementedError

    def start(self):
        raise NotImplementedError

    def rebuild(self, warmup=True, factory=None):
        raise NotImplementedError

    def close(self, drain=False, drain_timeout=None):
        raise NotImplementedError

    def warmup(self):
        raise NotImplementedError

    def stats(self):
        raise NotImplementedError

    def metrics_obj(self):
        return None

    def crash(self):
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__}({self.name!r}, "
                f"state={self.health_state()}, "
                f"outstanding={self.outstanding()})")


class InProcessReplica(Replica):
    """One engine (ServingEngine or DecodeEngine) in this process.

    ``factory`` is a zero-arg callable returning a STARTED engine; the
    replica calls it at construction and again on ``rebuild()`` —
    engines built from one factory must share nothing mutable (a
    read-only parameter scope is fine; that is what
    ``Inferencer.serve(replicas=N)`` does)."""

    def __init__(self, factory, name="replica", warmup=False,
                 engine=None, role=None):
        super().__init__(name)
        self._factory = factory
        self._engine = engine if engine is not None else factory()
        self.role = role
        if warmup:
            self._engine.warmup()

    @property
    def engine(self):
        return self._engine

    def submit(self, item, timeout=None, **kw):
        return self._engine.submit(item, timeout=timeout, **kw)

    def handoff(self, state, timeout=None, **kw):
        return self._engine.import_handoff(state, timeout=timeout, **kw)

    def outstanding(self):
        return self._engine.outstanding()

    def health_state(self):
        return self._engine.health.state

    def admits(self):
        return self._engine.breaker.admits()

    def alive(self):
        return self._engine.worker_alive()

    def start(self):
        """Revive after a worker death — same engine, same compile
        cache, so revival is milliseconds, not a re-warm."""
        self._engine.start()
        return self

    def rebuild(self, warmup=True, factory=None):
        """Fresh engine from the factory (the rolling-restart /
        deploy-rollover path; the caller has already drained and
        closed the old one). Passing ``factory=`` swaps the replica
        onto a NEW factory first — that is how a canary deploy (and
        its rollback) converts a drained replica to another model
        version in place, keeping the pool's membership stable. The
        warmup report is stashed on ``last_rebuild_report`` — with a
        compiled-artifact store behind the factory's engines it shows
        ``compiles: 0``, the proof that restart cost is load-bound,
        not compile-bound."""
        if factory is not None:
            self._factory = factory
        self._engine = self._factory()
        self.last_rebuild_report = (self._engine.warmup() if warmup
                                    else None)
        return self

    def close(self, drain=False, drain_timeout=None):
        self._engine.close(drain=drain, drain_timeout=drain_timeout)
        return self

    def warmup(self):
        return self._engine.warmup()

    def stats(self):
        return self._engine.stats()

    def metrics_obj(self):
        return self._engine.metrics

    def crash(self):
        self._engine._simulate_worker_crash()


# ---------------------------------------------------------------------------
# process-backed replica
# ---------------------------------------------------------------------------

# typed serving errors the worker process forwards by class name (the
# shared wire vocabulary of cluster/net.py); the parent re-raises the
# same type so router/client retry classification is identical for
# every replica backing
_ERROR_TYPES = WIRE_ERRORS


class ProcessReplica(Replica):
    """A serving replica in its own OS process.

    The worker (``python -m paddle_tpu_torch.cluster.proc_worker``) loads a
    ``save_inference_model`` directory, warms the buckets from its
    serving manifest, and serves pickle frames; this wrapper gives it
    the in-process replica interface so the Router cannot tell them
    apart. ``crash()`` is a real ``SIGKILL``; the pool's revival
    monitor then respawns the process.

    ``engine_kw`` forwards ServingConfig knobs (max_wait_ms,
    max_queue, default_timeout_s) to the worker's engine.

    ``place`` is forwarded to the child: the card unless it (default:
    this process's default place) is the host, then ``--cpu``.

    ``decode=True`` serves a :func:`~paddle_tpu_torch.models.llama.
    save_decode_model` directory with a DecodeEngine instead
    (engine_kw then forwards DecodeConfig knobs: max_batch, page_size,
    chunk_size, scheduler, ...); such a worker also answers the
    ``handoff`` verb, and ``role`` tags the replica for the router's
    disaggregated placement."""

    READY_TIMEOUT_S = 120.0    # process start + torch import + warmup

    def __init__(self, model_dir, name="proc-replica", warmup=True,
                 stderr=None, decode=False, role=None, place=None,
                 **engine_kw):
        super().__init__(name)
        self.model_dir = os.path.abspath(model_dir)
        self._host = _is_host(place)
        self.decode = bool(decode)
        self.role = role
        self.engine_kw = dict(engine_kw)
        self._do_warmup = bool(warmup)
        self._stderr = stderr
        self._lock = threading.Lock()       # write side + pending map
        self._pending = {}                  # id -> PendingResult
        self._stats_waiters = {}            # id -> [event, payload]
        self._next_id = 0
        self._proc = None
        self._reader = None
        self._ready = threading.Event()
        self._last_stats = {}
        self._warmup_report = None
        self._closed = False
        self._spawn()

    # -- process lifecycle ----------------------------------------------
    def _spawn(self):
        env, repo_root = worker_env()
        cmd = worker_argv("proc_worker",
                          "cpu" if self._host else "cuda")
        cmd += ["--dir", self.model_dir]
        if self.decode:
            cmd.append("--decode")
        if not self._do_warmup:
            cmd.append("--no-warmup")
        for k, v in self.engine_kw.items():
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        self._ready.clear()
        self._closed = False
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._stderr if self._stderr is not None
            else subprocess.DEVNULL,
            env=env, cwd=repo_root)
        self._reader = threading.Thread(
            target=self._reader_loop, name=f"{self.name}-reader",
            daemon=True)
        self._reader.start()

    def wait_ready(self, timeout=None):
        """Block until the worker reported ready (engine loaded +
        warmed). Raises WorkerDiedError if it exited first."""
        if not self._ready.wait(self.READY_TIMEOUT_S
                                if timeout is None else timeout):
            raise WorkerDiedError(
                f"replica process {self.name} never became ready")
        if not self.alive() and not self._ready.is_set():
            raise WorkerDiedError(
                f"replica process {self.name} died during startup")
        return self

    def _reader_loop(self):
        proc = self._proc
        stream = proc.stdout
        # the try/finally is load-bearing: the reader thread is the
        # ONLY settler of pending requests, so it must fail them all
        # however it exits — clean EOF, protocol damage on the pipe, or
        # an unexpected bug in the dispatch below. Before this audit a
        # reader death during close(drain=True) (or any raising frame)
        # stranded pending requests past their deadlines.
        note = ""
        try:
            while True:
                msg = read_frame(stream)
                if msg is None:
                    break
                kind = msg.get("type")
                if kind == "ready":
                    self._last_stats = msg.get("stats") or {}
                    self._warmup_report = msg.get("warmup")
                    self._ready.set()
                elif kind == "result":
                    req = self._pop_pending(msg["id"])
                    if req is not None:
                        req.set_result(msg["value"])
                elif kind == "error":
                    req = self._pop_pending(msg["id"])
                    if req is not None:
                        name, text = msg["error"]
                        req.set_error(_ERROR_TYPES.get(
                            name, ServingError)(text))
                elif kind == "stats":
                    with self._lock:
                        waiter = self._stats_waiters.pop(
                            msg["id"], None)
                    self._last_stats = msg.get("value") or {}
                    if waiter is not None:
                        waiter[1] = self._last_stats
                        waiter[0].set()
        except FrameError as exc:
            note = f" (pipe protocol damage: {exc})"
        except (OSError, ValueError) as exc:
            note = f" (pipe read failed: {exc})"
        finally:
            # the process (or its protocol stream) is gone — nothing
            # it held will ever answer
            self._fail_all_pending(WorkerDiedError(
                f"replica process {self.name} exited "
                f"(rc={proc.poll()}){note}"))

    def _pop_pending(self, req_id):
        with self._lock:
            return self._pending.pop(req_id, None)

    def _fail_all_pending(self, exc):
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
            waiters = list(self._stats_waiters.values())
            self._stats_waiters.clear()
        for req in pending:
            req.set_error(exc)
        for waiter in waiters:
            waiter[0].set()

    # -- replica interface ----------------------------------------------
    def _send_pending(self, frame, timeout):
        """Register a pending handle and ship one request frame; the
        reader thread settles it (or fails it typed on worker death)."""
        if self._closed:
            raise ServerClosedError(f"replica {self.name} is closed")
        if not self.alive():
            raise WorkerDiedError(
                f"replica process {self.name} is dead")
        now = time.monotonic()
        req = PendingResult(
            feed=None, n_rows=1, signature=(),
            deadline=None if timeout is None else now + float(timeout),
            enqueued_at=now)
        with self._lock:
            self._next_id += 1
            req_id = self._next_id
            self._pending[req_id] = req
            frame["id"] = req_id
            try:
                # racecheck: ok(blocking-under-lock) — frames are far
                # smaller than the pipe buffer, so the write cannot
                # stall on an unread pipe; the lock orders the
                # pending-map insert with the write
                write_frame(self._proc.stdin, frame)
            except (OSError, ValueError) as exc:
                self._pending.pop(req_id, None)
                raise WorkerDiedError(
                    f"replica process {self.name} pipe broken: "
                    f"{exc}") from exc
        return req

    def submit(self, item, timeout=None, **kw):
        frame = {"type": "submit", "feed": item, "timeout": timeout}
        if kw:
            # wire-safe kwargs only (prefill_only, max_new, an SLO
            # passed as a plain dict); the decode worker rebuilds the
            # SLOClass on its side
            frame["kw"] = kw
        return self._send_pending(frame, timeout)

    def handoff(self, state, timeout=None, **kw):
        frame = {"type": "handoff", "state": state, "timeout": timeout}
        if kw:
            frame["kw"] = kw
        return self._send_pending(frame, timeout)

    def outstanding(self):
        with self._lock:
            return len(self._pending)

    def health_state(self):
        if self._closed:
            return HealthState.STOPPED
        if not self.alive():
            return HealthState.DEGRADED
        if not self._ready.is_set():
            return HealthState.STARTING
        return self._last_stats.get("health_state", HealthState.READY)

    def admits(self):
        breaker = self._last_stats.get("breaker") or {}
        return breaker.get("state", "closed") != "open"

    def alive(self):
        proc = self._proc
        return proc is not None and proc.poll() is None

    def start(self):
        """Revive a dead process (full respawn — the process's compile
        cache died with it; the serving manifest makes the re-warm
        deterministic)."""
        if self.alive():
            return self
        self._fail_all_pending(WorkerDiedError(
            f"replica process {self.name} died"))
        self._spawn()
        return self

    def rebuild(self, warmup=True, factory=None):
        """Respawn the worker process. For process replicas the
        "factory" is the saved-model directory itself, so a version
        deploy passes the new version's export dir here."""
        if factory is not None:
            if not isinstance(factory, (str, os.PathLike)):
                raise TypeError(
                    "ProcessReplica.rebuild(factory=) takes a "
                    "saved-model directory path, got "
                    f"{type(factory).__name__}")
            self.model_dir = os.path.abspath(os.fspath(factory))
        self._do_warmup = bool(warmup)
        self._spawn()
        return self

    def close(self, drain=False, drain_timeout=None):
        self._closed = True      # stop admitting here; the worker's
        proc = self._proc        # engine drains its own queue
        if proc is None or proc.poll() is not None:
            return self
        try:
            with self._lock:
                # racecheck: ok(blocking-under-lock) — one tiny close
                # frame, bounded by the pipe buffer; serialized against
                # concurrent submit writes on the same fd
                write_frame(proc.stdin,
                            {"type": "close", "drain": bool(drain),
                             "drain_timeout": drain_timeout})
        except (OSError, ValueError):
            pass
        budget = 10.0 if drain_timeout is None \
            else float(drain_timeout) + 5.0
        try:
            proc.wait(budget)
        except subprocess.TimeoutExpired:
            proc.kill()
        self._closed = True
        return self

    def warmup(self):
        """Warmup happens inside the worker at spawn; this just waits
        for (and returns) its report."""
        self.wait_ready()
        return self._warmup_report

    def stats(self, timeout=5.0):
        if not self.alive():
            snap = dict(self._last_stats)
            snap["health_state"] = self.health_state()
            return snap
        waiter = [threading.Event(), None]
        with self._lock:
            self._next_id += 1
            req_id = self._next_id
            self._stats_waiters[req_id] = waiter
            try:
                # racecheck: ok(blocking-under-lock) — tiny frame,
                # bounded by the pipe buffer; the lock orders the
                # waiter insert with the write
                write_frame(self._proc.stdin,
                            {"type": "stats", "id": req_id})
            except (OSError, ValueError):
                self._stats_waiters.pop(req_id, None)
                return dict(self._last_stats)
        waiter[0].wait(timeout)
        return dict(waiter[1] if waiter[1] is not None
                    else self._last_stats)

    def metrics_obj(self):
        return None     # metrics live in the worker; stats() fetches

    def crash(self):
        """A REAL SIGKILL — the strongest form of the replica-crash
        drill."""
        proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.kill()
