"""Cross-host serving fabric, the torch port on the CPU: the cases of
tests/test_net_cluster.py run on the port (cluster/net*.py,
cluster/remote.py, cluster/membership.py), and the port is held against
the JAX package where the two meet: frames encoded by either package
decode bit-equal in the other, a hello that crosses the packages is
refused by fingerprint (ROADMAP.md §3 F18), and a port replica server
(``python -m paddle_tpu_torch.cluster.net_worker --cpu``) answers within
f32 2e-4 / 2e-5 of a reference engine on the reference's saved model.

What is pinned here:

* **the frame codec is typed about every failure** — corrupt,
  truncated, alien, version-skewed, and oversize frames each raise
  FrameError with a distinct reason (never pickle garbage), clean EOF
  at a frame boundary reads as ``None``, and unpickling is restricted
  to containers/scalars/numpy on both transports (an ``os.system``
  payload is a typed refusal, not an import);
* **the handshake refuses bad peers up front** — wrong auth token and
  schema-fingerprint mismatch both answer with a typed reject, and the
  server keeps serving its good clients afterwards;
* **RemoteReplica is robust by construction** — deadlines resolve on a
  silent link (sweeper), transport failures are typed AND reroutable,
  the per-connection breaker opens/half-opens/recloses, reconnects
  back off exponentially with jitter, and the reader loop fails
  everything pending however it dies;
* **loopback end-to-end** — a ReplicaServer serving a saved-model dir
  answers bit-exact with a lone engine, builds no step after its
  warmup (the port's engine builds one a bucket at warmup: F6), and
  provisions a fresh host over nothing but the socket
  (``fetch_manifest``/``fetch_artifact``, sha256-verified);
* **partition tolerance** — a partitioned remote degrades to excluded
  (typed errors only, zero lost requests) and rejoins within one
  membership refresh of the partition healing.

All CPU (``_host`` makes the host the default place). The
sustained-load chaos drill is slow-marked, as in the reference.
"""
import io
import os
import pickle
import socket
import struct
import threading
import time
import zlib

import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.cluster import net as jnet

import paddle_tpu_torch as fluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.cluster import (FrameError, HandshakeError, Membership,
                                RemoteReplica, RemoteUnavailableError,
                                ReplicaServer, Router,
                                provision_from_remote, serve_remotes)
from paddle_tpu_torch.cluster import net
from paddle_tpu_torch.cluster.replica import ProcessReplica
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.serving import (BucketSpec, QueueFullError,
                                RequestTimeoutError, ServerClosedError,
                                ServingEngine, ServingError,
                                ServiceUnavailableError,
                                WorkerDiedError)
from paddle_tpu_torch.serving.health import (CircuitBreaker, HealthState,
                                       serving_rank)

torch.set_num_threads(1)

pytestmark = pytest.mark.cluster


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    """The process's default place is the host, so engines, servers and
    the worker processes they spawn (``--cpu``) run on the CPU."""
    from paddle_tpu_torch.core import executor
    monkeypatch.setattr(executor, "_FORCED_CPU", True)


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.disarm()
    yield
    faultinject.disarm()


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------

def _raw_frame(payload):
    """Hand-built frame around an arbitrary payload (bypasses
    encode_frame so tests can smuggle evil pickles)."""
    return (net.MAGIC + bytes((net.PROTO_VERSION,))
            + struct.pack(">II", len(payload), zlib.crc32(payload))
            + payload)


def test_new_fault_points_registered():
    for point in ("net_conn_refused", "net_frame_drop",
                  "net_frame_delay", "net_partial_write",
                  "net_partition"):
        assert point in faultinject.KNOWN_POINTS


def test_frame_roundtrip_and_clean_eof():
    buf = io.BytesIO()
    first = {"type": "submit", "id": 7,
             "feed": {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "n": np.int64(3)},
             "timeout": 1.5}
    net.write_frame(buf, first)
    net.write_frame(buf, {"type": "stats", "id": 8})
    buf.seek(0)
    got = net.read_frame(buf)
    np.testing.assert_array_equal(got["feed"]["x"], first["feed"]["x"])
    assert got["feed"]["n"] == 3 and got["timeout"] == 1.5
    assert net.read_frame(buf) == {"type": "stats", "id": 8}
    # EOF exactly at a frame boundary is a polite close, not damage
    assert net.read_frame(buf) is None


def test_frame_corrupt_crc_is_typed():
    raw = bytearray(net.encode_frame({"a": 1}))
    raw[-1] ^= 0xFF
    with pytest.raises(FrameError) as exc:
        net.read_frame(io.BytesIO(bytes(raw)))
    assert exc.value.reason == "crc-mismatch"


def test_frame_alien_magic_is_typed():
    with pytest.raises(FrameError) as exc:
        net.read_frame(io.BytesIO(b"GET / HTTP/1.1\r\n\r\n"))
    assert exc.value.reason == "alien-magic"


def test_frame_version_skew_is_typed():
    raw = bytearray(net.encode_frame({"a": 1}))
    raw[len(net.MAGIC)] = net.PROTO_VERSION + 1
    with pytest.raises(FrameError) as exc:
        net.read_frame(io.BytesIO(bytes(raw)))
    assert exc.value.reason == "version-skew"


def test_frame_truncation_is_typed_header_and_payload():
    raw = net.encode_frame({"a": 1})
    with pytest.raises(FrameError) as exc:
        net.read_frame(io.BytesIO(raw[:-3]))        # payload cut
    assert exc.value.reason == "truncated"
    with pytest.raises(FrameError) as exc:
        net.read_frame(io.BytesIO(raw[:5]))         # header cut
    assert exc.value.reason == "truncated"


def test_frame_oversize_length_guard():
    header = (net.MAGIC + bytes((net.PROTO_VERSION,))
              + struct.pack(">II", net.MAX_FRAME_BYTES + 1, 0))
    with pytest.raises(FrameError) as exc:
        net.read_frame(io.BytesIO(header))
    assert exc.value.reason == "oversize"


def test_restricted_unpickle_rejects_code_globals():
    for evil in (os.system, eval, pickle.loads):
        frame = _raw_frame(pickle.dumps(evil))
        with pytest.raises(FrameError) as exc:
            net.read_frame(io.BytesIO(frame))
        assert exc.value.reason == "unpickle"
    # while the actual wire vocabulary stays fully allowed
    ok = net.decode_payload(pickle.dumps(
        {"s": {1, 2}, "t": (b"x", 2.5, None, True),
         "a": np.ones((2,), np.float32), "d": np.dtype("int64")}))
    assert ok["t"][3] is True


def test_wire_error_mapping():
    with pytest.raises(QueueFullError, match="full"):
        net.raise_wire_error(("QueueFullError", "full"))
    # an unknown (future) error name degrades to the ServingError base
    with pytest.raises(ServingError):
        net.raise_wire_error(("ErrorFromTheFuture", "boom"))
    assert net.wire_error(ValueError("x")) == ("ValueError", "x")


def test_check_hello_refusals():
    ok = net.client_hello(token="s3cret")
    assert net.check_hello(ok, token="s3cret") is None
    assert "token" in net.check_hello(
        net.client_hello(token="wrong"), token="s3cret")
    skew = net.client_hello(token="s3cret",
                            fingerprint={"proto": 0, "jax": "alien"})
    assert "fingerprint" in net.check_hello(skew, token="s3cret")
    assert "malformed" in net.check_hello({"type": "submit"})


def test_serving_rank_vocabulary():
    assert serving_rank(HealthState.READY) == 0
    assert serving_rank(HealthState.DEGRADED) == 1
    for state in (HealthState.STARTING, HealthState.DRAINING,
                  HealthState.STOPPED):
        assert serving_rank(state) is None


# ---------------------------------------------------------------------------
# scriptable fake sockets — RemoteReplica units without a server
# ---------------------------------------------------------------------------

class FakeSock:
    """A socket double the RemoteReplica transport can drive: sendall
    parses outgoing frames and (when scripted) pushes reply frames
    into the recv buffer; recv honors settimeout like a real socket."""

    def __init__(self, reply=None):
        self.reply = reply          # fn(msg) -> reply dict | None
        self.sent = []
        self._buf = b""
        self._cond = threading.Condition()
        self._timeout = None
        self.closed = False

    # -- test-side controls ---------------------------------------------
    def push(self, obj):
        with self._cond:
            self._buf += net.encode_frame(obj)
            self._cond.notify_all()

    def push_raw(self, data):
        with self._cond:
            self._buf += data
            self._cond.notify_all()

    # -- socket interface ------------------------------------------------
    def settimeout(self, t):
        self._timeout = t

    def sendall(self, data):
        if self.closed:
            raise BrokenPipeError("fake socket closed")
        stream = io.BytesIO(data)
        while True:
            try:
                msg = net.read_frame(stream)
            except FrameError:
                break
            if msg is None:
                break
            self.sent.append(msg)
            if self.reply is not None:
                out = self.reply(msg)
                if out is not None:
                    self.push(out)

    def send(self, data):
        self.sendall(bytes(data))
        return len(data)

    def recv(self, n):
        deadline = (None if self._timeout is None
                    else time.monotonic() + self._timeout)
        with self._cond:
            while not self._buf:
                if self.closed:
                    return b""
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise socket.timeout("fake timeout")
                self._cond.wait(0.01 if left is None
                                else min(left, 0.01))
            out, self._buf = self._buf[:n], self._buf[n:]
            return out

    def close(self):
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def shutdown(self, how):
        self.close()


_WELCOME = {"type": "welcome", "name": "fake-remote",
            "warmup": {"signatures": 2, "compiles": 0},
            "stats": {"health_state": HealthState.READY}}


def _fake_connect(sock_factory):
    """A net.open_conn stand-in handing out scripted sockets."""
    def connect(addr, token=None, deadline=None, connect_timeout=5.0):
        sock = sock_factory()
        if isinstance(sock, Exception):
            raise sock
        return sock, dict(_WELCOME)
    return connect


def _echo_reply(msg):
    if msg.get("type") == "submit":
        return {"type": "result", "id": msg["id"],
                "value": [np.asarray(msg["feed"])]}
    if msg.get("type") == "stats":
        return {"type": "stats", "id": msg["id"],
                "value": {"health_state": HealthState.READY}}
    return None


def test_remote_replica_roundtrip_on_fake_socket():
    rep = RemoteReplica("fake:1", name="r0",
                        connect=_fake_connect(
                            lambda: FakeSock(reply=_echo_reply)))
    try:
        out = rep.submit(np.arange(3), timeout=5.0).result(5.0)
        np.testing.assert_array_equal(out[0], np.arange(3))
        assert rep.alive()
        assert rep.health_state() == HealthState.READY
        assert rep.outstanding() == 0
        assert rep.warmup() == {"signatures": 2, "compiles": 0}
    finally:
        rep.close()
    assert rep.health_state() == HealthState.STOPPED
    with pytest.raises(ServerClosedError):
        rep.submit(np.arange(3))


def test_remote_deadline_resolves_on_silent_link():
    """The server never answers (partitioned link): the sweeper fails
    the request with a typed RequestTimeoutError at deadline+grace —
    never a hang."""
    silent = FakeSock(reply=None)
    rep = RemoteReplica("fake:1", deadline_grace_s=0.1,
                        connect=_fake_connect(lambda: silent))
    try:
        t0 = time.monotonic()
        handle = rep.submit(np.arange(2), timeout=0.2)
        with pytest.raises(RequestTimeoutError,
                           match="unresponsive|no reply"):
            handle.result(5.0)
        assert time.monotonic() - t0 < 2.0
        assert rep.outstanding() == 0       # nothing stranded
    finally:
        rep.close()


def test_remote_wire_timeout_is_tightest_of_caller_and_default():
    sock = FakeSock(reply=None)
    rep = RemoteReplica("fake:1", request_timeout_s=10.0,
                        connect=_fake_connect(lambda: sock))
    try:
        rep.submit(np.arange(2), timeout=3.0)
        rep.submit(np.arange(2), timeout=60.0)
        rep.submit(np.arange(2))
        wire = [m["timeout"] for m in sock.sent
                if m["type"] == "submit"]
        assert wire == [3.0, 10.0, 10.0]
    finally:
        rep.close()


def test_remote_typed_error_reraise():
    def reply(msg):
        if msg.get("type") == "submit":
            return {"type": "error", "id": msg["id"],
                    "error": ("QueueFullError", "remote queue full")}
        return None
    rep = RemoteReplica("fake:1",
                        connect=_fake_connect(lambda: FakeSock(reply)))
    try:
        with pytest.raises(QueueFullError, match="remote queue full"):
            rep.submit(np.arange(2), timeout=5.0).result(5.0)
        # a typed serving error is an ANSWER — the link breaker must
        # not count it as a transport failure
        assert rep.breaker.state == CircuitBreaker.CLOSED
    finally:
        rep.close()


def test_remote_breaker_opens_then_half_open_probe_recovers():
    state = {"refuse": True, "connects": 0}

    def connect(addr, token=None, deadline=None, connect_timeout=5.0):
        state["connects"] += 1
        if state["refuse"]:
            raise RemoteUnavailableError("injected refusal")
        return FakeSock(reply=_echo_reply), dict(_WELCOME)

    rep = RemoteReplica("fake:1", breaker_threshold=2,
                        breaker_cooldown_s=0.05, connect=connect,
                        lazy=True)
    try:
        for _ in range(2):
            with pytest.raises(RemoteUnavailableError):
                rep.submit(np.arange(2), timeout=1.0)
        assert rep.breaker.state == CircuitBreaker.OPEN
        assert rep.health_state() == HealthState.DEGRADED
        connects_when_open = state["connects"]
        # open sheds instantly, without touching the network
        with pytest.raises(ServiceUnavailableError):
            rep.submit(np.arange(2), timeout=1.0)
        assert state["connects"] == connects_when_open
        # cooldown elapses; the network heals; the next submit is the
        # half-open probe and its success closes the (fresh) breaker
        time.sleep(0.08)
        state["refuse"] = False
        out = rep.submit(np.arange(2), timeout=5.0).result(5.0)
        np.testing.assert_array_equal(out[0], np.arange(2))
        assert rep.breaker.state == CircuitBreaker.CLOSED
        assert rep.breaker_opens_total() >= 1
    finally:
        rep.close()


def test_remote_reconnect_backoff_is_jittered_exponential():
    sleeps = []
    attempts = {"n": 0}

    def connect(addr, token=None, deadline=None, connect_timeout=5.0):
        attempts["n"] += 1
        raise RemoteUnavailableError("still down")

    rep = RemoteReplica("fake:1", connect=connect, lazy=True,
                        reconnect_attempts=4,
                        reconnect_backoff_s=0.08,
                        sleep=sleeps.append)
    rep.start()             # swallows the terminal failure by design
    assert attempts["n"] == 4
    assert not rep.alive()
    assert rep.reconnect_failures_total == 1
    # 3 backoffs of 0.08 * 2^k, each jittered into [0.5x, 1.5x)
    assert len(sleeps) == 3
    for base, got in zip((0.08, 0.16, 0.32), sleeps):
        assert 0.5 * base <= got < 1.5 * base
    rep.close()


def test_remote_conn_refused_fault_point():
    faultinject.arm("net_conn_refused", at=0)
    with pytest.raises(RemoteUnavailableError, match="injected"):
        net.open_conn("127.0.0.1:1")


def test_remote_reader_death_fails_pending_typed():
    """The shared reader-loop contract: however the reader exits, every
    pending request is failed typed, promptly."""
    sock = FakeSock(reply=None)
    rep = RemoteReplica("fake:1", connect=_fake_connect(lambda: sock))
    try:
        handle = rep.submit(np.arange(2), timeout=30.0)
        sock.close()            # EOF under the reader
        with pytest.raises((WorkerDiedError, ServerClosedError)):
            handle.result(5.0)
        assert not rep.alive()
        assert rep.outstanding() == 0
    finally:
        rep.close()


def test_remote_reader_protocol_damage_fails_pending_typed():
    sock = FakeSock(reply=None)
    rep = RemoteReplica("fake:1", connect=_fake_connect(lambda: sock))
    try:
        handle = rep.submit(np.arange(2), timeout=30.0)
        sock.push_raw(b"this is not a frame at all!!")
        with pytest.raises(FrameError):
            handle.result(5.0)
        assert rep.outstanding() == 0
    finally:
        rep.close()


def test_process_replica_reader_death_cannot_strand_pending():
    """Regression (the _fail_all_pending audit): a reader thread that
    DIES — e.g. protocol damage mid-drain — must fail every pending
    request typed instead of stranding it past its deadline."""

    class ExplodingStream:
        def __init__(self):
            self.reads = 0

        def read(self, n):
            self.reads += 1
            if self.reads == 1:
                # half a header, then a blocking-forever stream would
                # strand; here: damage
                return b"garbage-that-is-not-magic"[:n]
            return b""

    replica = ProcessReplica.__new__(ProcessReplica)
    replica.name = "audit"
    replica._lock = threading.Lock()
    replica._pending = {}
    replica._stats_waiters = {}
    replica._last_stats = {}
    replica._ready = threading.Event()

    class FakeProc:
        stdout = ExplodingStream()

        def poll(self):
            return None

    replica._proc = FakeProc()
    from paddle_tpu_torch.serving.batching import PendingResult
    req = PendingResult(feed=None, n_rows=1, signature=(),
                        deadline=time.monotonic() + 30.0,
                        enqueued_at=time.monotonic())
    replica._pending[1] = req
    t = threading.Thread(target=replica._reader_loop, daemon=True)
    t.start()
    t.join(5.0)
    assert not t.is_alive()
    with pytest.raises(WorkerDiedError, match="protocol damage"):
        req.result(0.1)
    assert replica._pending == {}


# ---------------------------------------------------------------------------
# membership units
# ---------------------------------------------------------------------------

class FakeMember:
    def __init__(self, name, answering=True):
        self.name = name
        self.answering = answering
        self.stale_after_s = None
        self.refreshes = 0
        self._last_seen = None

    def refresh(self, timeout=2.0):
        self.refreshes += 1
        if self.answering:
            self._last_seen = time.monotonic()
        return self.answering

    def health_state(self):
        return (HealthState.READY if self.answering
                else HealthState.DEGRADED)

    def alive(self):
        return self.answering

    def outstanding(self):
        return 0


def test_membership_eviction_and_rejoin_counters():
    a, b = FakeMember("a"), FakeMember("b")
    m = Membership([a, b], refresh_interval_s=0, stale_after_s=0.5)
    assert m.refresh_once() == 2
    assert m.stats()["evictions_total"] == 0
    b.answering = False         # partition
    assert m.refresh_once() == 1
    assert m.stats()["evictions_total"] == 1
    view = {v["name"]: v for v in m.view()}
    assert view["b"]["answering"] is False
    assert view["b"]["serving_rank"] == 1       # DEGRADED tier
    assert view["a"]["serving_rank"] == 0
    b.answering = True          # heals: ONE refresh rejoins
    m.refresh_once()
    assert m.stats()["rejoins_total"] == 1
    assert {v["name"]: v["answering"] for v in m.view()} \
        == {"a": True, "b": True}
    m.close()


def test_membership_propagates_staleness_bound():
    a = FakeMember("a")
    m = Membership([a], refresh_interval_s=0, stale_after_s=0.7)
    assert a.stale_after_s == 0.7
    m.close()


def test_membership_refresh_thread_runs():
    a = FakeMember("a")
    m = Membership([a], refresh_interval_s=0.02)
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and a.refreshes < 2:
            time.sleep(0.01)
        assert a.refreshes >= 2
    finally:
        m.close()


# ---------------------------------------------------------------------------
# loopback end-to-end — a real ReplicaServer over a saved model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    """A tiny exported classifier with serving buckets AND a seeded
    embedded artifact store, plus a lone-engine reference output."""
    tmp = tmp_path_factory.mktemp("netmodel")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h, size=10, act="softmax")
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = str(tmp / "model")
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(
            model_dir, ["x"], [pred], exe, main_program=infer,
            serving_buckets=BucketSpec(batch_sizes=(1, 2)),
            artifact_store=True)
    eng = ServingEngine.from_saved_model(model_dir,
                                         place=fluid.CPUPlace())
    feed = {"x": np.arange(8, dtype=np.float32).reshape(1, 8)}
    try:
        ref = np.asarray(eng.infer(feed, timeout=30.0)[0])
    finally:
        eng.close()
    return {"dir": model_dir, "feed": feed, "ref": ref}


@pytest.fixture(scope="module")
def loopback_server(saved_model):
    server = ReplicaServer(saved_model["dir"], name="lo-0",
                           place=fluid.CPUPlace())
    yield server
    server.close()


def test_server_cold_starts_with_zero_compiles(loopback_server,
                                               saved_model):
    """A fresh ReplicaServer built from only a saved-model dir warms the
    exporter's bucket set and builds no step after its warmup. By the
    port's rule (ROADMAP.md §3 F6) ``from_saved_model`` takes the
    embedded artifact store only with ``compile_store=True``, which the
    server does not pass: its warmup builds one step a bucket (the
    reference's loads them from the store and counts zero compiles),
    and traffic afterwards builds none."""
    report = loopback_server.warmup_report
    assert report["signatures"] == 2
    assert report["compiles"] == 2
    assert loopback_server.total_compiles() == report["compiles"]
    rep = RemoteReplica(loopback_server.addr)
    try:
        for rows in (1, 2, 1):
            feed = {"x": np.repeat(saved_model["feed"]["x"], rows, 0)}
            rep.submit(feed, timeout=30.0).result(30.0)
    finally:
        rep.close()
    assert loopback_server.total_compiles() == report["compiles"]
    loopback_server.engine.assert_no_recompiles()


def test_loopback_bit_exact_vs_lone_engine(saved_model,
                                           loopback_server):
    rep = RemoteReplica(loopback_server.addr, name="cli")
    try:
        for _ in range(3):
            out = rep.submit(saved_model["feed"],
                             timeout=30.0).result(30.0)
            np.testing.assert_array_equal(np.asarray(out[0]),
                                          saved_model["ref"])
        assert rep.health_state() == HealthState.READY
        snap = rep.stats()
        assert snap["responses_total"] >= 3
        assert snap["breaker_client"]["state"] == "closed"
    finally:
        rep.close()


def test_handshake_wrong_token_refused_server_survives(
        saved_model, loopback_server):
    with pytest.raises(HandshakeError, match="token"):
        RemoteReplica(loopback_server.addr, token="wrong-secret")
    # the refusal cost the server nothing: a good client still serves
    rep = RemoteReplica(loopback_server.addr)
    try:
        out = rep.submit(saved_model["feed"],
                         timeout=30.0).result(30.0)
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      saved_model["ref"])
    finally:
        rep.close()
    assert loopback_server.stats()["handshake_refused_total"] >= 1


def test_sender_deadline_never_breaks_the_readers_recv():
    """A socket's timeout is shared by every thread that uses it. The
    RemoteReplica's callers send with a deadline while its reader waits
    in recv with none: had a send switched the socket out of blocking
    mode just as the reader entered its recv, that recv would fail with
    EAGAIN and tear a live connection down under load. The window is
    too narrow to hit on demand, so what is pinned is its cause: a send
    with a deadline and a recv without one leave the socket in the same
    timeout mode, never blocking; and 400 frames sent with deadlines
    while the reader receives their echoes all arrive."""
    a, b = socket.socketpair()
    n = 400
    got, errors = [], []

    def read():
        try:
            for _ in range(n):
                got.append(net.recv_frame(a)["i"])
        except Exception as e:          # noqa: BLE001 — asserted below
            errors.append(e)

    def echo():
        try:
            for _ in range(n):
                net.send_frame(b, net.recv_frame(
                    b, deadline=time.monotonic() + 30.0))
        except Exception as e:          # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=f, daemon=True)
               for f in (read, echo)]
    try:
        for t in threads:
            t.start()
        for i in range(n):
            net.send_frame(a, {"i": i},
                           deadline=time.monotonic() + 30.0)
        for t in threads:
            t.join(30.0)
        assert not errors and got == list(range(n))
        mode = a.gettimeout()
        net.send_frame(a, {"i": n}, deadline=time.monotonic() + 5.0)
        assert net.recv_frame(b) == {"i": n}
        assert a.gettimeout() == mode and mode is not None and mode > 0
    finally:
        a.close()
        b.close()


def test_handshake_fingerprint_mismatch_refused(loopback_server):
    sock = socket.create_connection(
        (loopback_server.host, loopback_server.port), timeout=5.0)
    try:
        net.send_frame(sock, {
            "type": "hello", "token": net.default_token(),
            "fingerprint": {"proto": 999, "jax": "not-this-jax"}})
        reply = net.recv_frame(
            sock, deadline=time.monotonic() + 5.0)
        assert reply["type"] == "reject"
        assert "fingerprint" in reply["reason"]
    finally:
        sock.close()


def test_alien_bytes_answered_typed_and_server_survives(
        saved_model, loopback_server):
    """A port scanner / stray writer on the fabric port gets a typed
    protocol_error and ONLY its connection dies."""
    sock = socket.create_connection(
        (loopback_server.host, loopback_server.port), timeout=5.0)
    try:
        sock.sendall(b"GET / HTTP/1.1\r\nHost: nope\r\n\r\n")
        reply = net.recv_frame(sock,
                               deadline=time.monotonic() + 5.0)
        assert reply["type"] == "protocol_error"
        assert reply["error"][0] == "FrameError"
    finally:
        sock.close()
    assert loopback_server.stats()["protocol_errors_total"] >= 1
    rep = RemoteReplica(loopback_server.addr)
    try:
        out = rep.submit(saved_model["feed"],
                         timeout=30.0).result(30.0)
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      saved_model["ref"])
    finally:
        rep.close()


def test_frame_drop_resolves_at_deadline_then_recovers(
        saved_model, loopback_server):
    rep = RemoteReplica(loopback_server.addr, deadline_grace_s=0.15)
    try:
        faultinject.arm("net_frame_drop", at=0)
        handle = rep.submit(saved_model["feed"], timeout=0.3)
        with pytest.raises(RequestTimeoutError):
            handle.result(5.0)
        faultinject.disarm()
        # the connection itself is fine — the next request serves
        out = rep.submit(saved_model["feed"],
                         timeout=30.0).result(30.0)
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      saved_model["ref"])
        assert rep.outstanding() == 0
    finally:
        rep.close()


def test_partial_write_is_typed_and_reconnect_recovers(
        saved_model, loopback_server):
    rep = RemoteReplica(loopback_server.addr)
    try:
        faultinject.arm("net_partial_write", at=0)
        with pytest.raises(RemoteUnavailableError):
            rep.submit(saved_model["feed"], timeout=5.0)
        faultinject.disarm()
        assert not rep.alive()
        rep.start()
        assert rep.alive()
        out = rep.submit(saved_model["feed"],
                         timeout=30.0).result(30.0)
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      saved_model["ref"])
    finally:
        rep.close()


def test_provision_from_remote_over_the_wire(saved_model,
                                             loopback_server,
                                             tmp_path):
    """No shared filesystem: a fresh host materializes the model dir
    (artifacts included, every file's sha256 the source's) over
    fetch_manifest/fetch_artifact, then cold-starts — building one step
    a bucket by the port's rule (F6), none after warmup — and answers
    bit-exact."""
    from paddle_tpu_torch.io.artifact_store import dir_manifest
    dest = str(tmp_path / "provisioned")
    report = provision_from_remote(loopback_server.addr, dest)
    assert report["files"] >= 3 and report["bytes"] > 0
    assert os.path.isdir(os.path.join(dest, "__artifacts__"))
    assert dir_manifest(dest) == dir_manifest(saved_model["dir"])
    fresh = ReplicaServer(dest, name="provisioned")
    try:
        assert fresh.total_compiles() == fresh.warmup_report["compiles"]
        rep = RemoteReplica(fresh.addr)
        try:
            out = rep.submit(saved_model["feed"],
                             timeout=30.0).result(30.0)
            np.testing.assert_array_equal(np.asarray(out[0]),
                                          saved_model["ref"])
        finally:
            rep.close()
    finally:
        fresh.close()


def test_fetch_artifact_path_confinement(loopback_server, tmp_path):
    rep = RemoteReplica(loopback_server.addr)
    try:
        with pytest.raises(ValueError, match="escapes|relative"):
            rep.fetch_artifact("../../etc/passwd")
        with pytest.raises(ValueError, match="escapes|relative"):
            rep.fetch_artifact("/etc/passwd")
    finally:
        rep.close()


def test_serve_remotes_partition_excluded_then_rejoined(
        saved_model, tmp_path):
    """The quick partition drill: mid-traffic partition on a 2-remote
    pool degrades to typed errors only; the partitioned replicas are
    excluded, then rejoin within one membership refresh of healing."""
    s1 = ReplicaServer(saved_model["dir"], name="p1")
    s2 = ReplicaServer(saved_model["dir"], name="p2")
    router = serve_remotes([s1.addr, s2.addr],
                           refresh_interval_s=0.05,
                           breaker_cooldown_s=0.1,
                           reconnect_backoff_s=0.01)
    feed = saved_model["feed"]
    try:
        assert isinstance(router, Router)
        for _ in range(4):
            out = router.infer(feed, timeout=30.0)
            np.testing.assert_array_equal(np.asarray(out[0]),
                                          saved_model["ref"])
        faultinject.arm("net_partition", at=0, times=12)
        outcomes = {"ok": 0, "typed": 0}
        for _ in range(12):
            try:
                router.infer(feed, timeout=1.0)
                outcomes["ok"] += 1
            except ServingError:
                outcomes["typed"] += 1      # typed, never lost
            time.sleep(0.01)
        faultinject.disarm()
        # heal: every replica rejoins via the membership refresher
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and \
                not all(r.alive() for r in router.pool.replicas()):
            time.sleep(0.02)
        assert all(r.alive() for r in router.pool.replicas())
        for _ in range(4):
            out = router.infer(feed, timeout=30.0)
            np.testing.assert_array_equal(np.asarray(out[0]),
                                          saved_model["ref"])
        assert router.membership.stats()["rejoins_total"] >= 1
    finally:
        router.close()
        s1.close()
        s2.close()


def test_inferencer_serve_remotes_returns_router(saved_model,
                                                 loopback_server):
    from paddle_tpu_torch.inferencer import Inferencer
    inferencer = Inferencer.from_inference_model(
        saved_model["dir"], place=fluid.CPUPlace())
    router = inferencer.serve(remotes=[loopback_server.addr])
    try:
        assert isinstance(router, Router)
        out = router.infer(saved_model["feed"], timeout=30.0)
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      saved_model["ref"])
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the sustained chaos drill — slow lane
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_partition_chaos_zero_loss_breaker_cycle_and_rejoin(
        saved_model):
    """The acceptance chaos gate: net_partition + net_frame_drop
    injected mid-load on a 2-remote pool — zero lost requests (every
    submit resolves to a result or a typed serving error), the breaker
    opens and re-closes, and the partitioned replica rejoins."""
    s1 = ReplicaServer(saved_model["dir"], name="c1")
    s2 = ReplicaServer(saved_model["dir"], name="c2")
    router = serve_remotes([s1.addr, s2.addr],
                           refresh_interval_s=0.05,
                           breaker_threshold=2,
                           breaker_cooldown_s=0.1,
                           reconnect_backoff_s=0.01,
                           reconnect_attempts=2)
    feed = saved_model["feed"]
    outcomes = {"ok": 0, "typed": 0, "lost": 0}
    lock = threading.Lock()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                router.infer(feed, timeout=5.0)
                key = "ok"
            except ServingError:
                key = "typed"
            except Exception:               # noqa: BLE001 — tallied
                key = "lost"
            with lock:
                outcomes[key] += 1
            time.sleep(0.002)

    try:
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        faultinject.arm("net_partition", at=0, times=60)
        faultinject.arm("net_frame_drop", at=0, times=4)
        time.sleep(1.0)
        faultinject.disarm()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(30.0)
        replicas = router.pool.replicas()
        # zero lost; traffic flowed on both sides of the partition
        assert outcomes["lost"] == 0, outcomes
        assert outcomes["ok"] > 0, outcomes
        # the breaker cycle happened: at least one open across the
        # drill, and every live link's breaker is closed again
        assert sum(r.breaker_opens_total() for r in replicas) >= 1
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and \
                not all(r.alive() for r in replicas):
            time.sleep(0.02)
        assert all(r.alive() for r in replicas)
        assert all(r.breaker.state == CircuitBreaker.CLOSED
                   for r in replicas)
        assert router.membership.stats()["rejoins_total"] >= 1
        # post-heal traffic is clean and bit-exact
        for _ in range(6):
            out = router.infer(feed, timeout=30.0)
            np.testing.assert_array_equal(np.asarray(out[0]),
                                          saved_model["ref"])
    finally:
        stop.set()
        router.close()
        s1.close()
        s2.close()


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

FRAMES = [
    {"type": "submit", "id": 3, "timeout": 1.5,
     "feed": {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
              "ids": np.array([[1, 2]], np.int64), "n": np.int64(7)}},
    {"type": "result", "id": 3,
     "value": [np.linspace(0, 1, 6).reshape(2, 3),
               np.array([True, False])]},
    {"type": "error", "id": 4, "error": ("QueueFullError", "full")},
    {"type": "handoff", "id": 5, "state": {
        "kind": "kv_handoff", "pages": [0, 3],
        "k": np.arange(8, dtype=np.uint16).view(np.dtype("V2")),
        "ttft_s": None}},
    {"type": "stats", "id": 6,
     "value": {"health_state": "READY", "breaker": {"state": "closed"},
               "p99_ms": 1.25, "tags": ("a", "b"), "seen": {1, 2}}},
]


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape and a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: f["type"])
def test_frames_cross_the_packages_bit_equal(frame):
    """The port keeps the reference's magic, version byte and layout: a
    frame either package encodes is the same bytes, and decodes
    bit-equal in the other (stream and socket readers alike)."""
    for enc, dec in ((jnet, net), (net, jnet)):
        raw = enc.encode_frame(frame)
        assert raw == dec.encode_frame(frame)
        assert raw[:net.HEADER_LEN - 8] == jnet.MAGIC + bytes(
            (jnet.PROTO_VERSION,))
        _same(frame, dec.read_frame(io.BytesIO(raw)))
        a, b = socket.socketpair()
        try:
            enc.send_frame(a, frame)
            _same(frame, dec.recv_frame(b, deadline=time.monotonic() + 5))
        finally:
            a.close()
            b.close()


def test_torch_tensor_in_a_frame_is_refused():
    """Only numpy crosses the wire: a torch tensor in a payload is a
    typed FrameError at the reader, in either package."""
    raw = pickle.dumps({"type": "result", "value": [torch.ones(2)]})
    for mod in (net, jnet):
        with pytest.raises(mod.FrameError) as exc:
            mod.read_frame(io.BytesIO(_raw_frame(raw)))
        assert exc.value.reason == "unpickle"


def test_fingerprint_names_torch_and_cross_package_hello_refused(
        loopback_server):
    """F18: the port's fingerprint names torch and its CUDA build, the
    reference's jax; a hello from either package is refused by the
    other's server with a typed reject naming the fingerprint."""
    fp = net.schema_fingerprint()
    assert fp == {"proto": net.PROTO_VERSION,
                  "torch": str(torch.__version__),
                  "cuda": str(torch.version.cuda or "none")}
    assert all(type(v) in (int, str) for v in fp.values())
    assert set(jnet.schema_fingerprint()) == {"proto", "jax"}
    assert "fingerprint mismatch" in net.check_hello(jnet.client_hello())
    assert "fingerprint mismatch" in jnet.check_hello(net.client_hello())
    # over the socket: the reference's client against the port's server
    with pytest.raises(jnet.HandshakeError, match="fingerprint"):
        jnet.open_conn(loopback_server.addr,
                       deadline=time.monotonic() + 10.0)
    # the refusal left the server serving its own package's clients
    rep = RemoteReplica(loopback_server.addr)
    try:
        assert rep.refresh(timeout=10.0)
    finally:
        rep.close()


@pytest.fixture(scope="module")
def reference_saved_model(tmp_path_factory):
    """The reference's saved classifier (no artifact store) and the
    reference engine's answers for each request alone."""
    d = str(tmp_path_factory.mktemp("jaxmodel") / "model")
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[8], dtype="float32")
        h = jfluid.layers.fc(x, size=16, act="relu")
        pred = jfluid.layers.fc(h, size=10, act="softmax")
    infer = main.clone(for_test=True)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(
            d, ["x"], [pred], exe, main_program=infer,
            serving_buckets=jfluid.serving.BucketSpec(batch_sizes=(1, 2)))
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.randn(n, 8).astype(np.float32)} for n in (1, 2, 1)]
    eng = jfluid.serving.ServingEngine.from_saved_model(
        d, place=jfluid.CPUPlace())
    try:
        eng.warmup()
        refs = [np.asarray(eng.infer(f, timeout=60.0)[0]) for f in feeds]
    finally:
        eng.close()
    return {"dir": d, "feeds": feeds, "refs": refs}


def _spawn_net_worker(model_dir, deadline_s=120.0):
    """``python -m paddle_tpu_torch.cluster.net_worker --cpu --port 0``;
    returns (process, addr) once its ready line names the port."""
    from paddle_tpu_torch.cluster.replica import worker_argv, worker_env
    env, root = worker_env()
    proc = subprocess.Popen(
        worker_argv("net_worker", fluid.CPUPlace())
        + ["--dir", model_dir, "--host", "127.0.0.1", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=root)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "ready on" in line:
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(deadline_s)
    ready = [ln for ln in lines if "ready on" in ln]
    if not ready:
        proc.kill()
        proc.wait(10)
        raise AssertionError(f"net_worker never became ready: {lines}")
    return proc, ready[0].split("ready on ")[1].split()[0]


def test_remote_answers_match_the_reference_engine(reference_saved_model):
    """A port replica server process (``--cpu``) over the reference's
    saved model answers each request, sent alone, within f32 2e-4 /
    2e-5 of the reference's engine; through a Router (``serve(remotes=
    ...)`` of the port's Inferencer) as well."""
    m = reference_saved_model
    proc, addr = _spawn_net_worker(m["dir"])
    try:
        rep = RemoteReplica(addr)
        try:
            for feed, ref in zip(m["feeds"], m["refs"]):
                out = rep.submit(feed, timeout=60.0).result(60.0)
                assert isinstance(out[0], np.ndarray)
                np.testing.assert_allclose(out[0], ref, rtol=2e-4,
                                           atol=2e-5)
        finally:
            rep.close()
        inf = fluid.Inferencer.from_inference_model(
            m["dir"], place=fluid.CPUPlace())
        router = inf.serve(remotes=[addr])
        try:
            assert isinstance(router, Router)
            out = router.infer(m["feeds"][1], timeout=60.0)
            np.testing.assert_allclose(out[0], m["refs"][1], rtol=2e-4,
                                       atol=2e-5)
        finally:
            router.close()
    finally:
        proc.kill()
        proc.wait(30)
