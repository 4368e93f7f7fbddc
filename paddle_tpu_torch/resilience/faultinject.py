"""Deterministic fault-injection harness.

Every recovery path in the resilience subsystem — crash-safe
checkpoints, retrying execution, the NaN sentinel — is only as good as
its tests, and none of the underlying faults (SIGKILL mid-write, a
flaky network reader, a numerically divergent step, a dropped PJRT
tunnel) occur naturally in CI. This module makes them occur ON DEMAND
and DETERMINISTICALLY: a fault is armed with a fire index and a fire
count, instrumented framework code calls :func:`fires` at its
injection point, and exactly the configured calls fire. TensorFlow's
large-scale paper treats recovery as a first-class subsystem precisely
because preemption is the common case on pods; this harness is what
lets tier-1 exercise those paths on a laptop CPU in milliseconds.

Injection points wired into the framework:

    point            site                             effect when armed
    ---------------  -------------------------------  -------------------
    crash_at_step    Trainer.train step loop          SimulatedCrash (no
                                                      exit checkpoint —
                                                      models SIGKILL)
    torn_write       resilience.checkpoint.save_state partial temp dir +
                                                      SimulatedCrash
    nan_step         Trainer.train step loop          fetched loss := NaN
    reader_io_error  reader.retry_reader /            IOError from the
                     io.DeviceLoader                  wrapped reader
    device_error     Executor.run dispatch            TransientDeviceError
                                                      (exercises retries)
    serving_device_error  ServingEngine batch         TransientDeviceError
                     dispatch                         at the serving layer
                                                      (breaker + serving
                                                      retries)
    serving_slow_batch    ServingEngine batch         dispatch stalls for
                     dispatch                         PADDLE_TPU_FAULT_
                                                      SLOW_S seconds
                                                      (drain-under-fire,
                                                      deadline paths)
    serving_worker_crash  ServingEngine worker loop   worker thread dies
                                                      without cleanup
                                                      (watchdog path)
    serving_replica_crash cluster Router submit path  the replica the
                                                      router just picked
                                                      is killed (thread
                                                      worker or SIGKILL
                                                      for process
                                                      replicas); the
                                                      pool must reroute
                                                      + revive
    net_conn_refused cluster/net.open_conn            connection refused
                                                      before the dial
                                                      (typed Remote-
                                                      UnavailableError)
    net_frame_drop   cluster/net.send_frame           the frame is
                                                      silently eaten by
                                                      the network — the
                                                      caller's deadline
                                                      is the safety net
    net_frame_delay  cluster/net.send_frame           send stalls
                                                      PADDLE_TPU_FAULT_
                                                      NET_DELAY_S
                                                      seconds (deadline
                                                      paths)
    net_partial_write cluster/net.send_frame          half a frame then
                                                      a torn connection
                                                      — the peer sees a
                                                      typed truncated
                                                      FrameError
    net_partition    cluster/net send AND recv        both directions
                                                      fail as if the
                                                      route vanished;
                                                      breakers open,
                                                      membership
                                                      excludes, rejoin
                                                      after it heals
    serving_canary_regression  cluster/deploy golden  the canary's
                     -set evaluation                  golden-set outputs
                                                      are perturbed past
                                                      any sane tolerance
                                                      (models a bad
                                                      weight push /
                                                      miscompiled
                                                      kernel); the
                                                      numerics gate
                                                      must auto-reject
                                                      and roll back
    trainer_crash_at_step  train_worker step handler  the worker dies
                                                      mid-step (os._exit
                                                      for subprocess
                                                      workers, abrupt
                                                      listener+conn
                                                      close in-process)
                                                      — the coordinator
                                                      must evict, retry
                                                      the step at
                                                      reduced world
                                                      size, and rejoin
                                                      a replacement
    trainer_straggle train_worker step handler        the step stalls
                                                      PADDLE_TPU_FAULT_
                                                      STRAGGLE_S seconds
                                                      — the coordinator's
                                                      straggler deadline
                                                      must evict + retry
    train_net_partition  cluster/train_fabric         the coordinator→
                     WorkerClient RPC path            worker route
                                                      vanishes (typed
                                                      RemoteUnavailable-
                                                      Error); evict,
                                                      retry, rejoin
                                                      after it heals
    coordinator_crash  TrainCoordinator step loop     SimulatedCrash
                                                      with NO exit
                                                      checkpoint (models
                                                      kill -9 of the
                                                      coordinator);
                                                      workers park at
                                                      the barrier, a new
                                                      coordinator
                                                      resumes from the
                                                      last committed
                                                      serial
    serving_handoff_drop  Router disaggregated        the prefill
                      generate, between prefill       replica dies with
                      completing and the handoff      the finished KV
                      reaching the decode replica     blob (WorkerDied-
                                                      Error); the router
                                                      must re-prefill on
                                                      a surviving
                                                      prefill replica —
                                                      zero lost
    serving_retry_storm  Router.infer, after an       the attempt's
                      attempt was submitted           answer is dropped
                                                      in flight (the
                                                      replica still
                                                      burns capacity on
                                                      it); the forced
                                                      retry must pass
                                                      the retry-budget
                                                      gate — beyond
                                                      budget it fails
                                                      fast typed
                                                      (RetryBudget-
                                                      ExhaustedError),
                                                      never storms
                                                      requests, typed
                                                      errors only

Arming — from test code::

    from paddle_tpu_torch.resilience import faultinject
    faultinject.arm("crash_at_step", at=5)            # 6th check fires
    faultinject.arm("reader_io_error", at=3, times=2) # fires twice
    ...
    faultinject.disarm()                              # clean slate

or, for subprocess tests and the selfcheck smoke sweep, via env::

    PADDLE_TPU_FAULTS="crash_at_step@5,reader_io_error@3x2"

(``kind@at`` with an optional ``xTIMES`` suffix; ``times`` defaults
to 1.) Counters live in the spec, so re-arming resets them and runs
are reproducible: the fault fires on the ``at``-th zero-based check of
its point, ``times`` consecutive checks in a row, then never again.

Event barriers — arming against progress instead of wall-clock::

    faultinject.arm("serving_worker_crash", at=2,
                    after=("decode_submit", 6))

Instrumented code marks progress with :func:`event` (e.g. the decode
engine fires ``decode_submit`` for every admitted request). A spec
armed with ``after=(name, n)`` holds its fire-index clock — checks
return False WITHOUT consuming the ``at`` counter — until ``n`` new
``name`` events (counted from the arm() call) have occurred. This is
how chaos tests pin a fault to a deterministic point in the request
stream: "crash the worker 2 loop iterations after the 6th admission"
is reproducible on any host, where "arm 50ms after submitting" flakes
on fast or loaded machines.
"""
import os

__all__ = ["SimulatedCrash", "arm", "disarm", "armed", "fires",
           "event", "event_count", "FaultSpec", "KNOWN_POINTS"]

KNOWN_POINTS = ("crash_at_step", "torn_write", "nan_step",
                "reader_io_error", "device_error",
                "serving_device_error", "serving_slow_batch",
                "serving_worker_crash", "serving_replica_crash",
                "net_conn_refused", "net_frame_drop",
                "net_frame_delay", "net_partial_write",
                "net_partition", "serving_canary_regression",
                "trainer_crash_at_step", "trainer_straggle",
                "train_net_partition", "coordinator_crash",
                "serving_handoff_drop", "serving_retry_storm")


class SimulatedCrash(BaseException):
    """An injected hard failure. Deliberately a BaseException (like
    KeyboardInterrupt): recovery code that catches ``Exception`` must
    NOT be able to swallow a simulated SIGKILL, or the test would pass
    for the wrong reason."""


class FaultSpec:
    """One armed fault: fire on the ``at``-th zero-based check, for
    ``times`` consecutive checks. ``after=(event, n)`` gates the whole
    clock on ``n`` new :func:`event` marks since arming — checks before
    the barrier opens return False without consuming ``at``."""

    def __init__(self, kind, at=0, times=1, after=None):
        if kind not in KNOWN_POINTS:
            raise ValueError(
                f"unknown fault point {kind!r}; known: {KNOWN_POINTS}")
        self.kind = kind
        self.at = int(at)
        self.times = int(times)
        self.calls = 0      # checks observed at this point
        self.fired = 0      # times this spec has fired
        self.after = None
        self._after_base = 0
        if after is not None:
            name, n = after
            self.after = (str(name), int(n))
            self._after_base = _events.get(str(name), 0)

    def barrier_open(self):
        if self.after is None:
            return True
        name, n = self.after
        return _events.get(name, 0) - self._after_base >= n

    def should_fire(self):
        if not self.barrier_open():
            return False
        i = self.calls
        self.calls += 1
        if i >= self.at and self.fired < self.times:
            self.fired += 1
            return True
        return False

    def __repr__(self):
        return (f"FaultSpec({self.kind}@{self.at}x{self.times}, "
                f"calls={self.calls}, fired={self.fired}"
                + (f", after={self.after[0]}+{self.after[1]}"
                   if self.after else "") + ")")


_armed = {}
_env_consumed = False
_events = {}        # progress-event name -> monotonic count


def _load_env():
    """Parse PADDLE_TPU_FAULTS once per process (explicit arm() calls
    always win over env specs for the same point)."""
    global _env_consumed
    if _env_consumed:
        return
    _env_consumed = True
    raw = os.environ.get("PADDLE_TPU_FAULTS", "").strip()
    if not raw:
        return
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        kind, _, rest = item.partition("@")
        at, times = 0, 1
        if rest:
            at_s, _, times_s = rest.partition("x")
            at = int(at_s)
            if times_s:
                times = int(times_s)
        _armed.setdefault(kind, FaultSpec(kind, at=at, times=times))


def event(name):
    """Mark one unit of progress (e.g. a request admission). Costs one
    dict update; cheap enough for production paths. Counters are
    process-monotonic — barriers measure deltas from their arm()
    snapshot, so marking is always safe."""
    _events[name] = _events.get(name, 0) + 1


def event_count(name):
    """Total :func:`event` marks for ``name`` this process."""
    return _events.get(name, 0)


def arm(kind, at=0, times=1, after=None):
    """Arm ``kind`` to fire on its ``at``-th zero-based check, ``times``
    consecutive checks in a row. Re-arming resets the counters.
    ``after=(event, n)`` holds the clock until ``n`` new ``event``
    marks arrive (counted from this call) — the deterministic
    alternative to sleeping before/after arming."""
    _load_env()
    spec = FaultSpec(kind, at=at, times=times, after=after)
    _armed[kind] = spec
    return spec


def disarm(kind=None):
    """Disarm one point, or every point (and forget env arming) when
    called with no argument — tests call this in teardown."""
    global _env_consumed
    if kind is None:
        _armed.clear()
        _env_consumed = True    # a full disarm also silences env faults
    else:
        _armed.pop(kind, None)


def armed(kind):
    """The live FaultSpec for ``kind``, or None."""
    _load_env()
    return _armed.get(kind)


def fires(kind):
    """The injection-point check: True iff ``kind`` is armed and this
    call is one of its configured firings. Unarmed points cost one dict
    lookup — cheap enough to leave compiled into production paths."""
    _load_env()
    spec = _armed.get(kind)
    return spec.should_fire() if spec is not None else False
