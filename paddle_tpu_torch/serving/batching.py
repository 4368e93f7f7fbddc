"""Micro-batching queue with admission control.

The throughput story of a TPU server is request coalescing: one
device dispatch amortizes over a device-sized batch (the TF-Serving
batching lesson — Abadi et al., 2016). This module is the host-side
half of that: a bounded, condition-variable-guarded queue that groups
compatible requests into micro-batches under a deadline.

Policy (``MicroBatcher.next_batch``):

- A batch flushes when it holds ``max_batch_size`` rows, OR when
  ``max_wait_s`` has elapsed since its *oldest* member arrived —
  bounded latency even at trickle traffic.
- Only requests with the same shape ``signature`` coalesce (see
  buckets.py): the head-of-queue request picks the signature, and the
  scan takes same-signature followers up to capacity. Different-
  signature requests wait for the next pop (mild head-of-line
  blocking, zero cross-request numeric coupling).
- Admission control is at ``put``: a full queue sheds the request
  *immediately* with :class:`QueueFullError` instead of queueing into
  unbounded latency. Expired requests are swept at pop time and
  fulfilled with :class:`RequestTimeoutError` rather than occupying
  batch slots.

No executor, no numpy — pure queueing, deterministic under an
injectable clock, so tier-1 tests pin the flush/shed/timeout logic
without sleeping.
"""
import threading

__all__ = ["QueueFullError", "RequestTimeoutError", "ServerClosedError",
           "ServingError", "PendingResult", "MicroBatcher"]


class ServingError(RuntimeError):
    """Base class of structured serving-layer failures."""


class QueueFullError(ServingError):
    """Load shed: the admission queue is at capacity. The client should
    back off and retry — queueing deeper would only convert overload
    into unbounded tail latency."""


class RequestTimeoutError(ServingError, TimeoutError):
    """The request's deadline expired before (or while) it could be
    served."""


class ServerClosedError(ServingError):
    """The engine is shut down; no new work is accepted."""


class PendingResult:
    """The caller's handle for an in-flight request: an event the
    worker fulfills with either a result or a structured error.

    Fulfillment is first-writer-wins: the worker and the watchdog may
    race to settle the same request (batch completes just as the
    watchdog declares the worker dead), and the caller must see ONE
    consistent outcome, never a result overwritten by a late error."""

    __slots__ = ("feed", "n_rows", "signature", "deadline", "enqueued_at",
                 "_event", "_result", "_error", "_settle_lock",
                 "_callbacks")

    def __init__(self, feed, n_rows, signature, deadline, enqueued_at):
        self.feed = feed
        self.n_rows = n_rows
        self.signature = signature
        self.deadline = deadline            # monotonic seconds or None
        self.enqueued_at = enqueued_at
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._settle_lock = threading.Lock()
        self._callbacks = []

    def done(self):
        return self._event.is_set()

    def remaining(self, now):
        """Seconds of deadline left at ``now`` (None = no deadline)."""
        if self.deadline is None:
            return None
        return self.deadline - now

    def add_done_callback(self, fn):
        """Call ``fn(self)`` exactly once when this handle settles
        (result OR error); immediately if it already has. The router
        uses this to observe sojourn and release per-class admission
        accounting without polling. Callback exceptions are swallowed
        — settlement must never fail because an observer did."""
        with self._settle_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn):
        try:
            fn(self)
        except Exception:       # noqa: BLE001 — observer must not break settle
            pass

    def set_result(self, value):
        with self._settle_lock:
            if self._event.is_set():
                return False
            self._result = value
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:           # outside the lock: observers may block
            self._run_callback(fn)
        return True

    def set_error(self, exc):
        with self._settle_lock:
            if self._event.is_set():
                return False
            self._error = exc
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)
        return True

    def wait(self, timeout=None):
        """Block up to ``timeout`` for settlement; True iff settled.
        Unlike :meth:`result` this never raises — the liveness-aware
        wait loop in ``ServingEngine.infer`` polls it between worker
        health checks."""
        return self._event.wait(timeout)

    def result(self, timeout=None):
        """Block for the outcome; raises the structured error on
        failure. ``timeout`` here is a wait bound on the *caller's*
        side (the serving deadline lives in the engine)."""
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                "result not ready within the wait bound")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Bounded request queue + deadline-driven micro-batch assembly.

    ``max_batch_size`` counts ROWS (a request may carry several rows).
    ``max_wait_s`` bounds how long the oldest queued request may wait
    for peers before its batch flushes partially filled. ``max_queue``
    bounds queued requests; beyond it, ``put`` sheds. ``clock`` is
    injectable (monotonic seconds) for deterministic tests.
    """

    def __init__(self, max_batch_size, max_wait_s=0.002, max_queue=64,
                 clock=None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        import time
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        self.clock = clock or time.monotonic
        self._q = []
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False

    # -- producer side ---------------------------------------------------
    def put(self, request):
        """Admit ``request`` or shed it. Raises QueueFullError (queue at
        capacity) or ServerClosedError (after close)."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("serving engine is closed")
            if len(self._q) >= self.max_queue:
                raise QueueFullError(
                    f"admission queue full ({self.max_queue} requests) "
                    "— load shed, retry with backoff")
            self._q.append(request)
            self._nonempty.notify()

    def depth(self):
        with self._lock:
            return len(self._q)

    def close(self):
        """Stop admitting; wake any blocked consumer."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()

    @property
    def closed(self):
        return self._closed

    def drain(self):
        """Remove and return everything still queued (engine shutdown
        fulfills these with ServerClosedError)."""
        with self._lock:
            q, self._q = self._q, []
            return q

    # -- consumer side ---------------------------------------------------
    def next_batch(self, poll_s=0.05, on_poll=None):
        """Block until a batch is ready; returns ``(batch, expired)``.

        ``batch`` is a same-signature request list whose rows fit
        ``max_batch_size`` (empty only when closed and drained).
        ``expired`` are deadline-blown requests swept from the queue —
        the caller fulfills them with RequestTimeoutError and serves
        the rest. ``poll_s`` caps each internal wait so a closed flag
        is always noticed promptly. ``on_poll`` (if given) is invoked
        once per internal wait iteration — the serving worker passes
        its heartbeat here so liveness keeps ticking while the
        consumer idles inside this call (a heartbeat only at the
        call boundary would read as a hang on an idle queue)."""
        with self._lock:
            while True:
                if on_poll is not None:
                    on_poll()
                now = self.clock()
                expired = [r for r in self._q
                           if r.deadline is not None and now >= r.deadline]
                if expired:
                    # sweep first and report: blown deadlines must be
                    # fulfilled before any compute is spent on peers
                    self._q = [r for r in self._q if r not in expired]
                    return [], expired
                if self._q:
                    head_age_flush = (
                        self._q[0].enqueued_at + self.max_wait_s <= now)
                    rows = 0
                    batch = []
                    sig = self._q[0].signature
                    for r in self._q:
                        if r.signature != sig:
                            continue
                        if rows + r.n_rows > self.max_batch_size \
                                and batch:
                            break
                        batch.append(r)
                        rows += r.n_rows
                        if rows >= self.max_batch_size:
                            break
                    if rows >= self.max_batch_size or head_age_flush \
                            or self._closed:
                        self._q = [r for r in self._q if r not in batch]
                        return batch, expired
                    # not full yet: wait out the remainder of the
                    # head's deadline window (or a queue change)
                    remaining = (self._q[0].enqueued_at
                                 + self.max_wait_s - now)
                    self._nonempty.wait(min(max(remaining, 1e-4),
                                            poll_s))
                    continue
                if self._closed:
                    return [], []
                self._nonempty.wait(poll_s)
