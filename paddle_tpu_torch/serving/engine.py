"""ServingEngine — the model-server core (port of
``paddle_tpu/serving/engine.py``).

Concurrent callers submit feeds; a single worker thread coalesces them
into micro-batches (batching.py), pads each batch to a pre-declared
shape bucket (buckets.py), runs the batch through the port's
:class:`~paddle_tpu_torch.core.executor.Executor` on the card, and
splits the fetch rows back to callers. Around that core:

- **warmup** — runs every bucket the spec can produce once and records
  the executor's step-build counts; ``assert_no_recompiles`` then
  turns "no new shapes during steady-state traffic" into a hard check
  (Executor.compile_counts counts step builds per feed signature).
- **admission control** — a bounded queue that sheds at capacity
  (QueueFullError) and per-request deadlines that convert queue decay
  into structured RequestTimeoutError instead of unbounded latency.
- **resilience** — the worker wraps each dispatch in
  resilience.retry.with_retries; the engine's executor itself runs
  with retries disabled so every transient-device retry is owned (and
  counted — ``retries_total``) at the serving layer.
- **hardening** (health.py, docs/SERVING.md "Operating under
  failure") — a HealthMonitor state machine (STARTING → READY →
  DEGRADED → DRAINING → STOPPED) fed by a worker heartbeat; a
  watchdog thread that detects a dead/stuck worker and fails pending
  requests with WorkerDiedError; engine- and per-bucket circuit
  breakers that shed with ServiceUnavailableError after repeated
  batch failures and half-open probe on a cooldown; ``close(
  drain=True)`` graceful drain; and per-batch deadline propagation so
  dispatch retries never outlive the tightest caller timeout.
- **metrics** — a ServingMetrics registry behind ``stats()``.

The engine serves ONE program; put one engine per model (they share
nothing mutable). Single worker by design: the device executes one
program at a time anyway, and one consumer keeps batch assembly
trivially racefree — parallelism belongs to the batch dimension.

Differences from the reference: the default place is the card
(``CUDAPlace(0)``; constructing without one raises where CUDA is
absent), the ``optimize`` rewrite (analysis/optimize.py) is not ported
yet so ``optimize`` defaults to False and True raises, and
``from_saved_model`` / ``compile_store`` arrive with the io slice.
"""
import os
import threading
import time

import numpy as np

from ..core.executor import CUDAPlace, Executor, global_scope
from ..resilience import faultinject as _faultinject
from ..resilience.retry import (RetryPolicy, TransientDeviceError,
                                default_policy, with_retries)
from .batching import (MicroBatcher, PendingResult, QueueFullError,
                       RequestTimeoutError, ServerClosedError)
from .buckets import BucketError, BucketSpec
from .health import (CircuitBreaker, HealthMonitor, HealthState,
                     ServiceUnavailableError, WorkerDiedError)
from .metrics import ServingMetrics

__all__ = ["ServingConfig", "ServingEngine"]


def _env_float(name, default):
    return float(os.environ.get(name, default))


class _ReplicaCrashed(BaseException):
    """Internal: tears the worker thread down ungracefully when the
    cluster chaos hook (``_simulate_worker_crash``) fires while the
    worker idles inside the batcher poll. BaseException so no recovery
    path can swallow the simulated SIGKILL."""


class ServingConfig:
    """Tuning knobs for one engine (docs/SERVING.md walks the
    tradeoffs).

    ``max_wait_ms`` — how long the oldest queued request may wait for
    batch peers; the latency you trade for fill ratio.
    ``max_queue`` — admission bound; arrivals beyond it shed.
    ``default_timeout_s`` — per-request deadline when the caller gives
    none (None = requests never expire).
    ``retry_policy`` — transient-device-error policy for the worker
    dispatch (None = resilience.default_policy(), env-tunable).

    Hardening knobs (each defaults from an env var so operators tune a
    deployment without code changes; docs/SERVING.md "Operating under
    failure"):

    ``breaker_threshold`` (PADDLE_TPU_BREAKER_THRESHOLD, 5) —
    consecutive terminal batch failures that open a circuit breaker.
    ``breaker_cooldown_s`` (PADDLE_TPU_BREAKER_COOLDOWN, 1.0) — open
    time before a half-open probe batch is let through.
    ``drain_timeout_s`` (PADDLE_TPU_DRAIN_TIMEOUT, 10.0) — default
    budget for ``close(drain=True)`` to finish queued work.
    ``watchdog_interval_s`` (PADDLE_TPU_WATCHDOG_INTERVAL, 0.1) — how
    often the watchdog checks worker liveness.
    ``hang_timeout_s`` (PADDLE_TPU_HANG_TIMEOUT, 30.0) — heartbeat
    staleness that declares a live-but-stuck worker dead; 0 disables
    hang detection (thread-death detection stays on).
    """

    def __init__(self, max_wait_ms=2.0, max_queue=64,
                 default_timeout_s=30.0, retry_policy=None,
                 breaker_threshold=None, breaker_cooldown_s=None,
                 drain_timeout_s=None, watchdog_interval_s=None,
                 hang_timeout_s=None):
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.default_timeout_s = default_timeout_s
        self.retry_policy = retry_policy
        self.breaker_threshold = int(
            _env_float("PADDLE_TPU_BREAKER_THRESHOLD", 5)
            if breaker_threshold is None else breaker_threshold)
        self.breaker_cooldown_s = (
            _env_float("PADDLE_TPU_BREAKER_COOLDOWN", 1.0)
            if breaker_cooldown_s is None else float(breaker_cooldown_s))
        self.drain_timeout_s = (
            _env_float("PADDLE_TPU_DRAIN_TIMEOUT", 10.0)
            if drain_timeout_s is None else float(drain_timeout_s))
        self.watchdog_interval_s = (
            _env_float("PADDLE_TPU_WATCHDOG_INTERVAL", 0.1)
            if watchdog_interval_s is None else float(watchdog_interval_s))
        self.hang_timeout_s = (
            _env_float("PADDLE_TPU_HANG_TIMEOUT", 30.0)
            if hang_timeout_s is None else float(hang_timeout_s))


class ServingEngine:
    """Serve ``program``'s ``fetch_list`` from batched feeds.

    ``program`` must be inference-form (clone(for_test=True) or a
    load_inference_model result); ``feed_names`` fixes the request
    contract — every request must feed exactly these, each array with
    a leading rows dim. ``scope`` holds the parameters (defaults to
    the ambient global scope at construction). ``buckets`` defaults to
    batch buckets ``(1, 2, 4, 8)`` with no sequence bucketing.
    """

    def __init__(self, program, feed_names, fetch_list, scope=None,
                 place=None, buckets=None, config=None, auto_start=True,
                 optimize=False, model_version=None):
        if optimize:
            raise NotImplementedError(
                "ServingEngine(optimize=True) applies analysis/optimize.py, "
                "which is a later slice of the torch port (ROADMAP.md "
                "item 'Optimize rewrite and verifier'); pass "
                "optimize=False")
        self.feed_names = list(feed_names)
        self.fetch_list = list(fetch_list)
        # deployment identity (None for engines built straight from a
        # Program) — surfaced in stats()
        self.model_version = model_version
        self.program = program
        self.scope = scope or global_scope()
        self.buckets = buckets or BucketSpec()
        self.config = config or ServingConfig()
        # all retries surface here (counted in metrics); the inner
        # executor must not also retry or attempts would multiply.
        # The default place is the card, never the host.
        self.exe = Executor(place if place is not None else CUDAPlace(0),
                            retry_policy=RetryPolicy(max_attempts=1))
        self.metrics = ServingMetrics()
        self.batcher = MicroBatcher(
            max_batch_size=self.buckets.max_batch,
            max_wait_s=self.config.max_wait_ms / 1e3,
            max_queue=self.config.max_queue)
        self.health = HealthMonitor()
        self.breaker = CircuitBreaker(
            failure_threshold=self.config.breaker_threshold,
            cooldown_s=self.config.breaker_cooldown_s)
        self._sig_breakers = {}   # bucket signature -> CircuitBreaker
        self._inflight = []       # batch currently in dispatch
        self._warmed = None       # compile snapshot after warmup()
        self._worker = None
        self._watchdog = None
        self._worker_death_seen = False
        self._stop = threading.Event()
        self._watchdog_stop = threading.Event()
        # chaos hook: lets the cluster layer kill THIS engine's worker
        # ungracefully (the global serving_worker_crash fault point
        # cannot target one replica of a pool)
        self._crash = threading.Event()
        if auto_start:
            self.start()

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Start (or restart, e.g. after the watchdog declared the
        previous worker dead) the worker + watchdog threads."""
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stop.clear()
        self._crash.clear()
        self._worker_death_seen = False
        self.health.beat()        # fresh heartbeat epoch for the watchdog
        self._worker = threading.Thread(
            target=self._worker_loop, name="paddle-tpu-torch-serving-worker",
            daemon=True)
        self._worker.start()
        if self._watchdog is None or not self._watchdog.is_alive():
            self._watchdog_stop.clear()
            self._watchdog = threading.Thread(
                target=self._watchdog_loop,
                name="paddle-tpu-torch-serving-watchdog", daemon=True)
            self._watchdog.start()
        self.health.to(HealthState.READY)
        return self

    def close(self, timeout=5.0, drain=False, drain_timeout=None):
        """Shut the engine down.

        ``drain=False`` (default, the pre-hardening behavior): stop
        admitting, fulfill everything still queued with
        ServerClosedError, join the worker.

        ``drain=True``: stop admitting, then let the worker FINISH all
        queued and in-flight requests before joining — no admitted
        request is refused. ``drain_timeout`` (default
        ``config.drain_timeout_s``) bounds the drain; whatever is
        still queued when it expires gets ServerClosedError, so a
        wedged device cannot turn shutdown into a hang. Per-request
        deadlines stay live during the drain (an expired request is
        still swept as RequestTimeoutError, never served stale)."""
        worker = self._worker
        if drain and worker is not None and worker.is_alive() \
                and not self._stop.is_set():
            self.health.to(HealthState.DRAINING)
            self.batcher.close()     # stop admission; keep serving
            budget = (self.config.drain_timeout_s
                      if drain_timeout is None else float(drain_timeout))
            # the worker exits by itself once closed AND empty
            worker.join(max(budget, 0.0))
        self.batcher.close()
        self._stop.set()
        for req in self.batcher.drain():
            req.set_error(ServerClosedError("engine closed"))
        if self._worker is not None:
            self._worker.join(timeout)
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout)
            self._watchdog = None
        self.health.to(HealthState.STOPPED)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- warmup ----------------------------------------------------------
    def warmup(self):
        """Run every declared bucket once: one dummy run per
        (batch bucket × length-bucket signature). Returns
        ``{"signatures": n, "compiles": total_step_builds}`` and
        snapshots the counts that :meth:`assert_no_recompiles` later
        compares against (on the card this also builds the kernels and
        warms the allocator)."""
        sigs = self.buckets.all_signatures(names=set(self.feed_names))
        for batch_rows, sig in sigs:
            feed = self._dummy_feed(batch_rows, dict(sig))
            # scope passed explicitly (NOT via the process-global
            # scope_guard): engine runs happen on worker threads
            # concurrent with other engines' loads/rebuilds, and the
            # global guard is not thread-safe
            self.exe.run(self.program, feed=feed,
                         fetch_list=self.fetch_list, mode="test",
                         scope=self.scope)
        self._warmed = self.exe.compile_counts()
        compiles = self.exe.total_compiles()
        self.metrics.incr("warmup_compiles", compiles)
        return {"signatures": len(sigs), "compiles": compiles}

    def assert_no_recompiles(self):
        """Raise AssertionError if any new step build happened after
        warmup() — the steady-state contract. No-op before warmup."""
        if self._warmed is None:
            return
        now = self.exe.compile_counts()
        if now != self._warmed:
            raise AssertionError(
                f"serving executables changed after warmup: "
                f"{self._warmed} -> {now} — a request shape escaped "
                "the declared buckets")

    def _dummy_feed(self, batch_rows, seq_by_name):
        """Zero-valued feed shaped for one bucket signature, derived
        from the program's data-var declarations."""
        gb = self.program.global_block()
        feed = {}
        for name in self.feed_names:
            var = gb.var(name)
            shape = list(var.shape)
            shape[0] = batch_rows
            if name in seq_by_name and len(shape) > 1:
                shape[1] = seq_by_name[name]
            shape = [1 if (d is None or d < 0) else int(d)
                     for d in shape]
            shape[0] = batch_rows
            feed[name] = np.zeros(shape, dtype=str(var.dtype))
        return feed

    # -- request path ----------------------------------------------------
    def submit(self, feed, timeout=None):
        """Enqueue one request; returns a PendingResult immediately.

        ``feed`` maps every declared feed name to an array whose
        leading dim is this request's row count (1 for a single
        sample). Raises BucketError (shape outside every declared
        bucket), QueueFullError (shed), ServiceUnavailableError (the
        engine-level or this bucket's circuit breaker is open),
        ServerClosedError — all before any queueing, so a rejected
        request costs nothing."""
        missing = [n for n in self.feed_names if n not in feed]
        extra = [n for n in feed if n not in self.feed_names]
        if missing or extra:
            raise ValueError(
                f"request feed must supply exactly {self.feed_names}; "
                f"missing {missing}, unexpected {extra}")
        arrs = {n: np.asarray(feed[n]) for n in self.feed_names}
        rows = {n: a.shape[0] if a.ndim else 0 for n, a in arrs.items()}
        n_rows = rows[self.feed_names[0]]
        if n_rows < 1 or len(set(rows.values())) != 1:
            raise ValueError(
                f"request arrays must agree on a leading rows dim >= 1, "
                f"got {rows}")
        try:
            signature = self.buckets.signature(arrs)
            self.buckets.batch_bucket(n_rows)    # fits some bucket?
        except BucketError:
            self.metrics.incr("shed_total")
            raise
        # breaker fast-shed: read-only (state transitions belong to the
        # worker) — a cooled-down open breaker admits, and those
        # requests become the half-open probe batch
        sig_breaker = self._sig_breakers.get(signature)
        if not self.breaker.admits() or (
                sig_breaker is not None and not sig_breaker.admits()):
            self.metrics.incr("breaker_shed_total")
            raise ServiceUnavailableError(
                "circuit breaker open — the engine (or this request's "
                "bucket) is failing; back off at least "
                f"{self.config.breaker_cooldown_s}s and retry")
        if timeout is None:
            timeout = self.config.default_timeout_s
        now = time.monotonic()
        req = PendingResult(
            feed=arrs, n_rows=n_rows, signature=signature,
            deadline=None if timeout is None else now + float(timeout),
            enqueued_at=now)
        try:
            self.batcher.put(req)
        except QueueFullError:
            self.metrics.incr("shed_total")
            raise
        # admitted only: shed/oversize rejections count in shed_total
        self.metrics.incr("requests_total")
        self.metrics.set_queue_depth(self.batcher.depth())
        return req

    def infer(self, feed, timeout=None):
        """Synchronous convenience: submit + wait. Returns the fetch
        list for THIS request's rows (numpy arrays).

        The wait is liveness-aware: it polls the worker thread while
        waiting and raises WorkerDiedError promptly if the worker is
        gone, instead of sitting out the full grace bound (the
        watchdog fails queued requests too, but this direct check
        holds even with a long watchdog interval)."""
        req = self.submit(feed, timeout=timeout)
        # caller-side wait is the serving deadline plus grace — the
        # structured RequestTimeoutError from the worker is the real
        # signal; the grace bound only guards a silently-lost request
        end = None if req.deadline is None else req.deadline + 10.0
        while True:
            if req.wait(0.05):
                return req.result(0)
            worker = self._worker
            if worker is None or not worker.is_alive():
                # the worker may have settled it on its way out (drain
                # tail, close()) — give settlement a beat to land
                if req.wait(0.2):
                    return req.result(0)
                raise WorkerDiedError(
                    "serving worker died while this request waited "
                    "(restart the engine with start())")
            if end is not None and time.monotonic() >= end:
                return req.result(0)   # structured wait-bound timeout

    def outstanding(self):
        """Admitted-but-unfinished requests right now: queued plus the
        batch in dispatch. The cluster router's least-outstanding /
        health-aware balancing reads this per pick — it must stay a
        couple of O(1) reads, never a stats() snapshot."""
        return self.batcher.depth() + len(self._inflight)

    def worker_alive(self):
        """True iff the worker thread exists and is running (the
        liveness read infer() and the cluster revival monitor share)."""
        w = self._worker
        return w is not None and w.is_alive()

    def _simulate_worker_crash(self):
        """Kill THIS engine's worker ungracefully on its next loop
        iteration (no cleanup — models SIGKILL, like the global
        serving_worker_crash point, but per-engine so cluster chaos
        can take down one replica of a pool). start() revives."""
        self._crash.set()

    def stats(self):
        """Metrics snapshot + compile-cache evidence + health/breaker
        state."""
        snap = self.metrics.stats()
        snap["compiles_now"] = self.exe.total_compiles()
        snap["queue_depth"] = self.batcher.depth()
        snap["health_state"] = self.health.state
        snap["model_version"] = self.model_version
        snap["breaker"] = self.breaker.snapshot()
        open_sigs = {str(sig): br.snapshot()
                     for sig, br in self._sig_breakers.items()
                     if br.state != CircuitBreaker.CLOSED}
        snap["bucket_breakers_not_closed"] = open_sigs
        return snap

    # -- watchdog --------------------------------------------------------
    def _watchdog_loop(self):
        """Liveness sentinel: periodically checks that the worker
        thread exists and its heartbeat moves; on death (or a stalled
        heartbeat past hang_timeout_s) fails everything pending with
        WorkerDiedError so no caller ever waits out a grace bound on a
        server that cannot answer."""
        while not self._watchdog_stop.wait(self.config.watchdog_interval_s):
            if self._stop.is_set() or self.batcher.closed:
                continue          # shutdown/drain: worker exit is expected
            worker = self._worker
            if worker is None:
                continue
            if not worker.is_alive():
                self._on_worker_dead("serving worker thread died")
                continue
            age = self.health.heartbeat_age()
            hang = self.config.hang_timeout_s
            if hang and age is not None and age > hang:
                self._on_worker_dead(
                    f"serving worker heartbeat stalled {age:.1f}s "
                    f"(hang timeout {hang:g}s) — worker is stuck")

    def _on_worker_dead(self, reason):
        """Fail pending (queued + in-flight) requests with a typed
        error; flip health to DEGRADED once per death event."""
        if not self._worker_death_seen:
            self._worker_death_seen = True
            self.metrics.incr("worker_died_total")
            self.health.to(HealthState.DEGRADED)
        inflight, self._inflight = self._inflight, []
        pending = list(inflight) + self.batcher.drain()
        for req in pending:
            req.set_error(WorkerDiedError(reason))

    # -- worker ----------------------------------------------------------
    def _beat_or_crash(self):
        """The worker heartbeat, doubling as the per-engine crash
        point: called once per queue-poll iteration, so a simulated
        crash kills even an IDLE worker promptly (the plain loop-top
        check only runs between batches)."""
        if self._crash.is_set():
            raise _ReplicaCrashed()
        self.health.beat()

    def _worker_loop(self):
        try:
            self._worker_loop_impl()
        except _ReplicaCrashed:
            return   # models SIGKILL: no cleanup — the watchdog's job

    def _worker_loop_impl(self):
        policy = self.config.retry_policy or default_policy()
        while not (self._stop.is_set() and self.batcher.depth() == 0):
            if self._crash.is_set() \
                    or _faultinject.fires("serving_worker_crash"):
                return   # models SIGKILL: no cleanup — the watchdog's job
            self.health.beat()
            batch, expired = self.batcher.next_batch(
                on_poll=self._beat_or_crash)
            for req in expired:
                self.metrics.incr("timeouts_total")
                req.set_error(RequestTimeoutError(
                    "request deadline expired before it was served "
                    f"(waited >= {self.config.max_wait_ms} ms window; "
                    "queue saturated or timeout too tight)"))
            if not batch:
                if self.batcher.closed and self.batcher.depth() == 0:
                    break
                continue
            self.metrics.set_queue_depth(self.batcher.depth())
            self._serve_batch(batch, policy)
        # engine closing: anything left gets a structured refusal
        for req in self.batcher.drain():
            req.set_error(ServerClosedError("engine closed"))

    def _sig_breaker(self, signature):
        br = self._sig_breakers.get(signature)
        if br is None:
            br = CircuitBreaker(
                failure_threshold=self.config.breaker_threshold,
                cooldown_s=self.config.breaker_cooldown_s)
            self._sig_breakers[signature] = br
        return br

    def _serve_batch(self, batch, policy):
        sig_breaker = self._sig_breaker(batch[0].signature)
        # dispatch-side breaker gate: an open breaker sheds the batch
        # without compute; a cooled-down one lets it through half-open
        # as the probe whose outcome closes or re-opens the breaker
        if not (self.breaker.allow() and sig_breaker.allow()):
            self.metrics.incr("breaker_shed_total", len(batch))
            for req in batch:
                req.set_error(ServiceUnavailableError(
                    "circuit breaker open — batch shed without dispatch; "
                    f"back off {self.config.breaker_cooldown_s}s"))
            return
        if CircuitBreaker.HALF_OPEN in (self.breaker.state,
                                        sig_breaker.state):
            self.metrics.incr("breaker_probe_total")
        # deadline propagation: the tightest member deadline caps the
        # retry loop, so re-dispatching never outlives any caller
        deadlines = [r.deadline for r in batch if r.deadline is not None]
        batch_deadline = min(deadlines) if deadlines else None
        t0 = time.monotonic()
        self._inflight = batch
        try:
            feeds = [r.feed for r in batch]
            batch_feed, n_rows, bucket_rows = \
                self.buckets.pad_batch(feeds)

            def _dispatch():
                if _faultinject.fires("serving_slow_batch"):
                    # models a wedged/slow device dispatch (tunable so
                    # drain-under-fire tests stay fast)
                    time.sleep(_env_float("PADDLE_TPU_FAULT_SLOW_S",
                                          0.25))
                if _faultinject.fires("serving_device_error"):
                    raise TransientDeviceError(
                        "injected serving-layer transient device error "
                        "(UNAVAILABLE)")
                return self.exe.run(
                    self.program, feed=batch_feed,
                    fetch_list=self.fetch_list, mode="test",
                    scope=self.scope)

            fetches = with_retries(
                _dispatch, policy=policy, deadline=batch_deadline,
                on_retry=lambda exc, n, delay:
                    self.metrics.incr("retries_total"))
            per_req = BucketSpec.unpad_rows(
                fetches, [r.n_rows for r in batch])
        except BaseException as exc:     # noqa: BLE001 — forwarded
            # a failed batch fails its requests, never the worker;
            # breakers count the terminal (post-retry) failure FIRST so
            # a caller seeing the error and immediately resubmitting
            # meets an already-open breaker
            self._inflight = []
            opened = self.breaker.record_failure()
            opened_sig = sig_breaker.record_failure()
            if opened:
                self.metrics.incr("breaker_open_total")
            if opened_sig:
                self.metrics.incr("breaker_open_total")
            if opened or opened_sig:
                self.health.to(HealthState.DEGRADED)
            self.metrics.incr("errors_total", len(batch))
            for req in batch:
                req.set_error(exc)
            return
        self._inflight = []
        self.breaker.record_success()
        sig_breaker.record_success()
        if self.health.state == HealthState.DEGRADED:
            self.health.to(HealthState.READY)   # breaker recovered
        done = time.monotonic()
        self.metrics.observe_batch(n_rows, bucket_rows, done - t0)
        draining = self.batcher.closed and not self._stop.is_set()
        for req, res in zip(batch, per_req):
            self.metrics.incr("responses_total")
            if draining:
                self.metrics.incr("drained_total")
            self.metrics.observe_latency(done - req.enqueued_at)
            req.set_result(res)
