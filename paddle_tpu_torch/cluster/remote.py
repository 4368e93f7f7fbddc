"""RemoteReplica — a socket-backed replica with the robustness layer.

The third backing of the :class:`~paddle_tpu_torch.cluster.replica.Replica`
interface (after in-process engines and pipe-driven OS processes): the
engine lives on another host behind a :class:`ReplicaServer`, and this
wrapper makes the network's failure modes *defined behaviors* the
Router's reroute/failover ladder already knows how to absorb:

- **deadline-aware RPC** — every submit propagates the tightest of the
  caller's deadline and the replica's default request timeout into the
  frame (the server enforces it engine-side) AND arms a local sweeper,
  so a request on a partitioned connection resolves as a typed
  RequestTimeoutError at its deadline, never a hang;
- **per-connection circuit breaker** — the serving breaker's semantics over transport
  failures: consecutive connect/send/reader failures open it, open
  sheds submits instantly with ServiceUnavailableError (the router
  reroutes), a cooled-down breaker lets one submit through half-open
  as the probe whose outcome closes or re-opens it;
- **reconnect with jittered exponential backoff** — ``start()`` (the
  pool revival monitor's verb, and the membership refresher's) retries
  the connect through ``resilience.retry.with_retries`` with a
  0.5–1.5× jitter on each delay so a rack of replicas does not
  reconnect in lockstep after a partition heals;
- **typed error re-raise** — server-side serving errors arrive as
  ``(type_name, message)`` and re-raise as the same class, so
  QueueFullError still reroutes, BucketError still doesn't, and
  WorkerDiedError still triggers infer() failover — the Router cannot
  tell a remote replica from a local one.
"""
import random
import threading
import time

from ..resilience.retry import RetryPolicy, with_retries
from ..serving.batching import (PendingResult, RequestTimeoutError,
                                ServerClosedError)
from ..serving.health import (CircuitBreaker, HealthState,
                              ServiceUnavailableError,
                              WorkerDiedError)
from . import net
from .replica import Replica

__all__ = ["RemoteReplica"]


class RemoteReplica(Replica):
    """One remote serving engine at ``addr`` (``"host:port"`` or a
    ``(host, port)`` pair) behind the standard Replica interface.

    ``connect=`` is injectable (tests drive scriptable fake sockets
    through it); the default is :func:`net.open_conn`. ``lazy=True``
    skips the construction-time connect — the pool monitor or the
    membership refresher will establish it (a seed list may name hosts
    that are still provisioning)."""

    def __init__(self, addr, name=None, token=None,
                 request_timeout_s=30.0, connect_timeout_s=5.0,
                 breaker_threshold=3, breaker_cooldown_s=1.0,
                 reconnect_attempts=3, reconnect_backoff_s=0.05,
                 stale_after_s=None, deadline_grace_s=0.5,
                 connect=None, sleep=None, rng=None, lazy=False,
                 role=None):
        super().__init__(name or (addr if isinstance(addr, str)
                                  else f"{addr[0]}:{addr[1]}"))
        self.addr = addr
        self.role = role
        self._token = token
        self.request_timeout_s = request_timeout_s
        self.connect_timeout_s = float(connect_timeout_s)
        self.reconnect_attempts = int(reconnect_attempts)
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        self.stale_after_s = stale_after_s
        self.deadline_grace_s = float(deadline_grace_s)
        self._connect = connect or net.open_conn
        self._base_sleep = sleep or time.sleep
        self._rng = rng or random.Random()
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown_s = float(breaker_cooldown_s)
        self._lock = threading.Lock()       # write side + pending map
        self._pending = {}                  # id -> PendingResult
        self._waiters = {}                  # id -> [event, payload]
        self._next_id = 0
        self._sock = None
        self._reader = None
        self._closed = False
        self._last_stats = {}
        self._last_seen = None              # monotonic, last reply
        self._warmup_report = None
        self.remote_name = None
        self.reconnects_total = 0
        self.reconnect_failures_total = 0
        # breaker opens survive connection turnover: each established
        # connection gets a FRESH breaker (per-connection semantics),
        # so the opens seen across the replica's lifetime accumulate
        # here — the chaos gate's "breaker opened and re-closed" read
        self._breaker_opens_accum = 0
        # per-connection breaker: replaced on every established
        # connection, so "consecutive failures" counts against the
        # CURRENT link, per the serving breaker's contract
        self.breaker = self._fresh_breaker()
        self._sweeper = None
        if not lazy:
            self._establish()

    def _fresh_breaker(self):
        return CircuitBreaker(
            failure_threshold=self._breaker_threshold,
            cooldown_s=self._breaker_cooldown_s)

    # -- connection lifecycle --------------------------------------------
    def _jittered_sleep(self, delay):
        """0.5–1.5x jitter so a fleet never reconnects in lockstep."""
        self._base_sleep(delay * (0.5 + self._rng.random()))

    def _establish(self, deadline=None):
        """One connect + handshake; raises typed on failure."""
        sock, welcome = self._connect(
            self.addr, token=self._token, deadline=deadline,
            connect_timeout=self.connect_timeout_s)
        with self._lock:
            old = self._sock
            self._sock = sock
            self.remote_name = welcome.get("name")
            self._warmup_report = welcome.get("warmup")
            self._last_stats = welcome.get("stats") or {}
            self._last_seen = time.monotonic()
            self._breaker_opens_accum += self.breaker.opens_total
            self.breaker = self._fresh_breaker()
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        self._reader = threading.Thread(
            target=self._reader_loop, args=(sock,),
            name=f"{self.name}-reader", daemon=True)
        self._reader.start()
        if self._sweeper is None or not self._sweeper.is_alive():
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name=f"{self.name}-sweeper",
                daemon=True)
            self._sweeper.start()
        return self

    def _mark_dead(self, exc):
        """The connection is gone: fail everything pending with a
        typed error and count a breaker failure."""
        with self._lock:
            sock, self._sock = self._sock, None
            pending = list(self._pending.values())
            self._pending.clear()
            waiters = list(self._waiters.values())
            self._waiters.clear()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for req in pending:
            req.set_error(exc)
        for waiter in waiters:
            waiter[0].set()
        self.breaker.record_failure()

    def _reader_loop(self, sock):
        """Demux reply frames to pending requests. The try/finally is
        the lesson of the ProcessReplica audit: the reader MUST fail
        everything pending however it exits — EOF, protocol damage, a
        partition, or an unexpected bug — or callers strand past their
        deadlines."""
        exc = WorkerDiedError(
            f"remote replica {self.name} connection closed")
        try:
            while True:
                msg = net.recv_frame(sock)
                if msg is None:
                    break
                with self._lock:
                    self._last_seen = time.monotonic()
                kind = msg.get("type")
                if kind == "result":
                    req = self._pop_pending(msg["id"])
                    if req is not None:
                        req.set_result(msg["value"])
                    self.breaker.record_success()
                elif kind == "error":
                    req = self._pop_pending(msg["id"])
                    if req is not None:
                        name, text = msg["error"]
                        req.set_error(net.WIRE_ERRORS.get(
                            name, net.ServingError)(text))
                    else:
                        # an error answering a non-submit RPC
                        # (fetch_artifact on a bad path, …) settles
                        # that verb's waiter instead
                        with self._lock:
                            waiter = self._waiters.pop(
                                msg.get("id"), None)
                        if waiter is not None:
                            waiter[1] = msg
                            waiter[0].set()
                    # a typed SERVING error is a live, answering
                    # remote — the transport breaker stays closed
                    self.breaker.record_success()
                elif kind in ("stats", "pong", "manifest", "artifact"):
                    with self._lock:
                        waiter = self._waiters.pop(msg.get("id"), None)
                        if kind == "stats":
                            self._last_stats = msg.get("value") or {}
                    if waiter is not None:
                        waiter[1] = msg
                        waiter[0].set()
                elif kind == "protocol_error":
                    exc = net.WIRE_ERRORS.get(
                        msg["error"][0], net.FrameError)(
                            msg["error"][1])
                    break
        except net.FrameError as e:
            exc = e
        except (net.RemoteUnavailableError, OSError) as e:
            exc = net.RemoteUnavailableError(
                f"remote replica {self.name} unreachable: {e}")
        except RequestTimeoutError as e:
            exc = e
        finally:
            # only tear down if WE still own this socket (a newer
            # connection may already have replaced it)
            if self._sock is sock:
                self._mark_dead(exc if isinstance(exc, Exception)
                                else WorkerDiedError(str(exc)))

    def _sweep_loop(self):
        """Deadline sentinel: a request whose deadline (+grace) passed
        with no reply — partitioned link, dropped frame, stuck server
        — is failed typed HERE, so 'never a hang' holds even when TCP
        has not noticed the partition."""
        while not self._closed:
            time.sleep(min(0.05, self.deadline_grace_s))
            now = time.monotonic()
            overdue = []
            with self._lock:
                for req_id, req in list(self._pending.items()):
                    if req.deadline is not None and \
                            now >= req.deadline + self.deadline_grace_s:
                        overdue.append(self._pending.pop(req_id))
            for req in overdue:
                req.set_error(RequestTimeoutError(
                    f"request deadline expired with no reply from "
                    f"{self.name} (connection unresponsive — "
                    "partition or dropped frame)"))

    def _pop_pending(self, req_id):
        with self._lock:
            return self._pending.pop(req_id, None)

    # -- small RPC helper (stats/ping/fetch) -----------------------------
    def _rpc(self, frame, timeout=5.0):
        """Fire one non-submit verb and wait for its reply frame; None
        on any transport failure (callers degrade to cached state)."""
        waiter = [threading.Event(), None]
        deadline = time.monotonic() + float(timeout)
        with self._lock:
            if self._sock is None or self._closed:
                return None
            self._next_id += 1
            frame = dict(frame, id=self._next_id)
            self._waiters[frame["id"]] = waiter
            try:
                # racecheck: ok(blocking-under-lock) — the send is
                # deadline-bounded and the lock is what orders the
                # waiter-map insert with the socket write; moving the
                # send out would let the reply race its own waiter
                net.send_frame(self._sock, frame, deadline=deadline)
            except (net.ServingError, OSError):
                self._waiters.pop(frame["id"], None)
                return None
        waiter[0].wait(timeout)
        with self._lock:
            self._waiters.pop(frame["id"], None)
        return waiter[1]

    # -- replica interface -----------------------------------------------
    def submit(self, item, timeout=None, **kw):
        return self._submit_frame(
            {"type": "submit", "feed": item}, timeout, kw)

    def handoff(self, state, timeout=None, **kw):
        """Ship a KV handoff blob to a decode-role server (the
        ``handoff`` wire verb); same breaker/deadline/pending
        machinery as submit."""
        return self._submit_frame(
            {"type": "handoff", "state": state}, timeout, kw)

    def _submit_frame(self, frame, timeout, kw):
        if kw:
            # wire-safe kwargs only (prefill_only, max_new, an SLO as
            # a plain dict — the restricted unpickler refuses custom
            # classes; the server rebuilds the SLOClass)
            frame = dict(frame, kw=kw)
        if self._closed:
            raise ServerClosedError(f"replica {self.name} is closed")
        # breaker gate: open sheds instantly (the router reroutes); a
        # cooled-down open transitions half-open and THIS submit is
        # the probe
        if not self.breaker.allow():
            raise ServiceUnavailableError(
                f"circuit breaker open for {self.name} — the "
                f"connection is failing; back off "
                f"{self._breaker_cooldown_s}s")
        # tightest of the caller deadline and the replica default
        wire_timeout = self.request_timeout_s if timeout is None \
            else (timeout if self.request_timeout_s is None
                  else min(float(timeout), self.request_timeout_s))
        now = time.monotonic()
        deadline = None if wire_timeout is None \
            else now + float(wire_timeout)
        if self._sock is None:
            # one FAST reconnect attempt inline (the submit path must
            # not sit in a backoff loop — that is start()'s job); a
            # failure is typed and reroutable
            try:
                self._establish(deadline=deadline)
            except (net.ServingError, OSError) as exc:
                self.breaker.record_failure()
                self.reconnect_failures_total += 1
                raise net.RemoteUnavailableError(
                    f"replica {self.name} unreachable: {exc}") \
                    from exc
        req = PendingResult(
            feed=None, n_rows=1, signature=(), deadline=deadline,
            enqueued_at=now)
        with self._lock:
            if self._sock is None:
                raise net.RemoteUnavailableError(
                    f"replica {self.name} lost its connection")
            self._next_id += 1
            req_id = self._next_id
            self._pending[req_id] = req
            try:
                # racecheck: ok(blocking-under-lock) — deadline-bounded
                # send; the lock orders the pending-map insert with the
                # write so the reader can never see a reply for an id
                # it cannot find
                net.send_frame(
                    self._sock,
                    dict(frame, id=req_id, timeout=wire_timeout),
                    deadline=deadline)
            except (net.RemoteUnavailableError, OSError) as exc:
                self._pending.pop(req_id, None)
                sock, self._sock = self._sock, None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                self.breaker.record_failure()
                raise net.RemoteUnavailableError(
                    f"replica {self.name} send failed: {exc}") \
                    from exc
            except RequestTimeoutError:
                self._pending.pop(req_id, None)
                raise
        return req

    def outstanding(self):
        with self._lock:
            return len(self._pending)

    def _stale(self):
        if self.stale_after_s is None or self._last_seen is None:
            return False
        return time.monotonic() - self._last_seen \
            > float(self.stale_after_s)

    def health_state(self):
        if self._closed:
            return HealthState.STOPPED
        if not self.alive():
            return HealthState.DEGRADED
        if self.breaker.state == CircuitBreaker.OPEN or self._stale():
            return HealthState.DEGRADED
        return self._last_stats.get("health_state", HealthState.READY)

    def admits(self):
        if not self.breaker.admits():
            return False
        remote = self._last_stats.get("breaker") or {}
        return remote.get("state", "closed") != "open"

    def alive(self):
        return self._sock is not None and not self._closed

    def start(self):
        """Revive a dead connection: jittered exponential backoff via
        resilience.retry, bounded attempts. Swallows the terminal
        failure (the replica simply stays dead/excluded and the next
        revival sweep or membership refresh tries again) — a
        partitioned peer must cost retries, never a crash or a hang."""
        if self._closed or self.alive():
            return self
        policy = RetryPolicy(
            max_attempts=max(1, self.reconnect_attempts),
            initial_backoff=self.reconnect_backoff_s,
            retryable=(net.RemoteUnavailableError, ConnectionError,
                       OSError, RequestTimeoutError),
            sleep=self._jittered_sleep)
        try:
            with_retries(self._establish, policy=policy)
            self.reconnects_total += 1
        except (net.HandshakeError, net.FrameError):
            raise           # a peer that REFUSES us won't heal by retry
        except (net.ServingError, OSError):
            self.reconnect_failures_total += 1
            # a whole reconnect cycle failing is one consecutive
            # failure against this link — enough of them open the
            # breaker even while the router is ignoring the corpse
            self.breaker.record_failure()
        return self

    def rebuild(self, warmup=True):
        """The rolling-restart verb: drop the link and reconnect fresh
        (the server engine itself is rebuilt server-side by ITS
        operator; client-side a rebuild is a clean re-handshake)."""
        self._mark_dead(ServerClosedError(
            f"replica {self.name} rebuilding its connection"))
        self._establish()
        self.last_rebuild_report = self._warmup_report
        return self

    def close(self, drain=False, drain_timeout=None):
        """Close the CLIENT side (the server keeps serving its other
        clients). ``drain=True`` waits for this client's outstanding
        requests to settle first, bounded by ``drain_timeout``."""
        if drain:
            budget = 10.0 if drain_timeout is None \
                else float(drain_timeout)
            end = time.monotonic() + budget
            while self.outstanding() and time.monotonic() < end:
                time.sleep(0.01)
        self._closed = True
        self._mark_dead(ServerClosedError(
            f"replica {self.name} closed"))
        return self

    def warmup(self):
        """The server warmed at ITS construction; this returns the
        report it handed over in the welcome frame."""
        return self._warmup_report

    def breaker_opens_total(self):
        """Breaker opens across every connection this replica has
        owned (per-connection breakers are replaced on reconnect)."""
        return self._breaker_opens_accum + self.breaker.opens_total

    def stats(self, timeout=5.0):
        reply = self._rpc({"type": "stats"}, timeout=timeout)
        snap = dict(self._last_stats)
        if reply is None:
            snap["health_state"] = self.health_state()
        snap["breaker_client"] = self.breaker.snapshot()
        snap["breaker_opens_lifetime"] = self.breaker_opens_total()
        snap["reconnects_total"] = self.reconnects_total
        snap["last_seen_age_s"] = (
            None if self._last_seen is None
            else round(time.monotonic() - self._last_seen, 3))
        return snap

    def refresh(self, timeout=2.0):
        """One membership heartbeat: reconnect if dead (the rejoin
        path), then refresh cached stats. Returns True when the remote
        answered."""
        if self._closed:
            return False
        if not self.alive():
            self.start()
            if not self.alive():
                return False
        return self._rpc({"type": "stats"},
                         timeout=timeout) is not None

    def fetch_artifact(self, relpath, timeout=30.0):
        """One model-dir file over the wire (verified against the
        server's sha256). Raises on transport failure or damage."""
        reply = self._rpc({"type": "fetch_artifact", "path": relpath},
                          timeout=timeout)
        if reply is None:
            raise net.RemoteUnavailableError(
                f"fetch_artifact({relpath!r}) from {self.name} got "
                "no reply")
        if reply.get("type") == "error":
            net.raise_wire_error(reply["error"])
        blob = reply["blob"]
        if net.hash_blob(blob) != reply.get("sha256"):
            raise net.FrameError(
                "crc-mismatch",
                f"{relpath} blob sha256 mismatch in transit")
        return blob

    def metrics_obj(self):
        return None     # metrics live server-side; stats() fetches

    def crash(self):
        """Chaos: sever the link abruptly (the network analogue of
        SIGKILL — the server never hears a goodbye)."""
        self._mark_dead(WorkerDiedError(
            f"replica {self.name} link severed (chaos)"))
