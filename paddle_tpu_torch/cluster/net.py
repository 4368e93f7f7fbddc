"""Network transport for the serving fabric — the robust frame layer
(port of ``paddle_tpu/cluster/net.py``).

Everything that crosses a machine boundary in paddle_tpu_torch goes through
this module: the versioned frame codec (shared by the stdio pipe
protocol of ``proc_worker`` and the TCP sockets of ``net_worker`` /
``RemoteReplica``), the connection handshake, and the deadline-aware
socket send/recv primitives. The design stance is the TF-paper one
(arXiv:1605.08695): the network is a *fault domain*, so every failure
mode must map to a typed error a client can program against — never
pickle garbage, never an indefinite hang.

Frame format (``PTN`` + version byte, then two big-endian u32s)::

    +------+----+----------+----------+----------------+
    | PTN  | v1 | len(u32) | crc32    | pickle payload |
    +------+----+----------+----------+----------------+

- an **alien** frame (wrong magic — a stray print, an HTTP probe, a
  port scanner) raises :class:`FrameError` at the first 4 bytes;
- a **version-skew** frame (magic right, version byte wrong) is typed
  too, so a rolling fleet upgrade fails loudly instead of misparsing;
- a **truncated** frame (EOF mid-header or mid-payload — the peer died
  or a partial write landed) is distinguished from a clean EOF at a
  frame boundary (``None``: the peer closed politely);
- a **corrupt** frame (CRC32 mismatch) never reaches the unpickler.

Unpickling is restricted on BOTH transports: only plain containers,
scalars, and numpy array reconstructors are allowed — a frame whose
payload references any other global (``os.system``, ``builtins.eval``,
a framework class) raises :class:`FrameError` instead of importing it.
Feeds, fetches, stats dicts, and error tuples all fit comfortably
inside that vocabulary; arbitrary code does not.

The handshake (one frame each way, before any RPC) carries a shared
auth token (``PADDLE_TPU_NET_TOKEN``) compared constant-time, plus a
schema fingerprint (frame protocol version + the torch version and its
CUDA build) so two hosts that would disagree about numerics or wire
semantics refuse each other with a typed :class:`HandshakeError` up
front. The magic, the version byte and the frame layout are the JAX
package's, so a frame either package encodes decodes bit-equal in the
other; a hello that crosses the packages is refused by fingerprint
(the reference's names jax, this one torch).

Only numpy crosses the wire: replicas turn torch outputs into numpy
arrays before framing (the restricted unpickler admits no tensor), and
bfloat16 travels as its ``<V2`` bits.

Fault points (``resilience/faultinject.py``) are compiled into the
socket paths on both sides: ``net_conn_refused`` (connect),
``net_frame_drop`` / ``net_frame_delay`` / ``net_partial_write``
(send), and ``net_partition`` (send AND recv fail as if the route
vanished) — the chaos drills in ``tests/test_net_cluster.py`` and
``servebench --remote --chaos`` arm them mid-load.
"""
import hashlib
import hmac
import io
import os
import pickle
import socket
import struct
import time
import zlib

from ..resilience import faultinject as _faultinject
from ..serving.batching import (QueueFullError, RequestTimeoutError,
                                ServerClosedError, ServingError)
from ..serving.buckets import BucketError
from ..serving.health import ServiceUnavailableError, WorkerDiedError
from ..serving.kv_pages import PagesExhaustedError
from ..serving.overload import RetryBudgetExhaustedError

__all__ = ["FrameError", "HandshakeError", "RemoteUnavailableError",
           "PROTO_VERSION", "MAGIC", "HEADER_LEN", "MAX_FRAME_BYTES",
           "encode_frame", "decode_payload", "write_frame",
           "read_frame", "send_frame", "recv_frame",
           "schema_fingerprint", "default_token", "client_hello",
           "check_hello", "open_conn", "WIRE_ERRORS", "wire_error",
           "raise_wire_error"]

MAGIC = b"PTN"               # paddle_tpu net frame (both packages)
PROTO_VERSION = 1
_HEADER = struct.Struct(">II")          # payload length, crc32
HEADER_LEN = len(MAGIC) + 1 + _HEADER.size
# length sanity bound: an alien frame that happens to start with the
# magic must not make us allocate gigabytes on a garbage length field
MAX_FRAME_BYTES = 256 * 2 ** 20

_FAULT_DELAY_ENV = "PADDLE_TPU_FAULT_NET_DELAY_S"


class FrameError(ServingError):
    """Protocol-level damage on a frame stream: alien magic, version
    skew, truncation mid-frame, CRC mismatch, an oversize length, or a
    payload outside the restricted-unpickle vocabulary. The connection
    that produced it is unusable — close it; the *stream position* is
    unknowable after garbage."""

    def __init__(self, reason, detail=""):
        self.reason = reason
        super().__init__(f"[{reason}] {detail}" if detail else reason)


class HandshakeError(ServingError):
    """The peer refused the connection at handshake time: bad auth
    token, schema/torch fingerprint mismatch, or a malformed hello.
    Deliberately NOT retriable-looking — reconnecting with the same
    credentials will refuse identically."""


class RemoteUnavailableError(ServiceUnavailableError):
    """The remote endpoint cannot be reached right now: connection
    refused/reset, a partition, a send into a dead socket. IS-A
    ServiceUnavailableError, so the Router's reroute ladder treats it
    exactly like an open breaker — try the next replica."""


# typed serving errors forwarded over the wire by class name; both the
# pipe worker and the socket server send ``(type_name, message)`` and
# the client re-raises the same type so retry/reroute classification is
# identical however the replica is backed
WIRE_ERRORS = {cls.__name__: cls for cls in (
    QueueFullError, RequestTimeoutError, ServerClosedError,
    ServingError, BucketError, ServiceUnavailableError,
    WorkerDiedError, PagesExhaustedError, FrameError, HandshakeError,
    RemoteUnavailableError, RetryBudgetExhaustedError, ValueError,
    TimeoutError)}


def register_wire_error(cls):
    """Register a typed error defined ABOVE net in the import graph
    (router, train_fabric) for by-name re-raise on the client side.
    Modules call this right after the class definition, so any
    process that can raise the class can also map it — protocheck's
    wire-error rule audits that every raised ServingError-family
    class is registered one way or the other."""
    WIRE_ERRORS[cls.__name__] = cls
    return cls


def wire_error(exc):
    """The ``(type_name, message)`` pair a server forwards."""
    return (type(exc).__name__, str(exc))


def raise_wire_error(pair):
    """Re-raise a forwarded error as its original type (ServingError
    when the name is unknown — a newer server never crashes an older
    client with an unmappable name)."""
    name, text = pair
    raise WIRE_ERRORS.get(name, ServingError)(text)


# ---------------------------------------------------------------------------
# restricted unpickling
# ---------------------------------------------------------------------------

_SAFE_BUILTINS = frozenset((
    "bool", "bytearray", "bytes", "complex", "dict", "float",
    "frozenset", "int", "list", "range", "set", "slice", "str",
    "tuple"))

# exactly the globals numpy's array/scalar pickles reference, across
# the numpy 1.x (numpy.core) and 2.x (numpy._core) module layouts
_SAFE_NUMPY = {
    "numpy": frozenset(("dtype", "ndarray")),
    "numpy.core.multiarray": frozenset(("_reconstruct", "scalar")),
    "numpy._core.multiarray": frozenset(("_reconstruct", "scalar")),
    "numpy.core.numeric": frozenset(("_frombuffer",)),
    "numpy._core.numeric": frozenset(("_frombuffer",)),
}


class _RestrictedUnpickler(pickle.Unpickler):
    """Allow containers, scalars, and numpy arrays — nothing else. A
    frame is DATA; a payload that wants to import anything beyond this
    vocabulary is an attack or a bug, and both deserve FrameError."""

    def find_class(self, module, name):
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        allowed = _SAFE_NUMPY.get(module)
        if allowed is not None and name in allowed:
            return super().find_class(module, name)
        raise FrameError(
            "unpickle",
            f"payload references disallowed global {module}.{name}")


def decode_payload(payload):
    """Restricted-unpickle one frame payload; any failure (including a
    disallowed global) is FrameError."""
    try:
        return _RestrictedUnpickler(io.BytesIO(payload)).load()
    except FrameError:
        raise
    except Exception as exc:            # noqa: BLE001 — typed rewrap
        raise FrameError("unpickle",
                         f"payload would not deserialize: {exc}") \
            from exc


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def encode_frame(obj):
    """One complete frame (header + payload) as bytes."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return (MAGIC + bytes((PROTO_VERSION,))
            + _HEADER.pack(len(payload), zlib.crc32(payload))
            + payload)


def _check_header(header):
    """Validate a 12-byte header; returns the payload length."""
    if header[:len(MAGIC)] != MAGIC:
        raise FrameError(
            "alien-magic",
            f"stream carries non-protocol bytes {header[:4]!r} — a "
            "stray write reached the frame channel")
    version = header[len(MAGIC)]
    if version != PROTO_VERSION:
        raise FrameError(
            "version-skew",
            f"peer speaks frame protocol v{version}, this process "
            f"speaks v{PROTO_VERSION}")
    length, crc = _HEADER.unpack_from(header, len(MAGIC) + 1)
    if length > MAX_FRAME_BYTES:
        raise FrameError(
            "oversize", f"declared payload of {length} bytes exceeds "
            f"the {MAX_FRAME_BYTES}-byte frame bound")
    return length, crc


def _finish_frame(payload, length, crc):
    if len(payload) < length:
        raise FrameError(
            "truncated",
            f"payload ended at {len(payload)}/{length} bytes — peer "
            "died or a partial write landed")
    if zlib.crc32(payload) != crc:
        raise FrameError(
            "crc-mismatch",
            "payload checksum mismatch — corruption in transit")
    return decode_payload(payload)


# -- file-like streams (the stdio pipe transport) ----------------------


def _read_exact(stream, n):
    """Read exactly ``n`` bytes; short data returns what arrived."""
    chunks = []
    got = 0
    while got < n:
        chunk = stream.read(n - got)
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def write_frame(stream, obj):
    """One frame onto a file-like stream (the proc_worker pipe)."""
    stream.write(encode_frame(obj))
    stream.flush()


def read_frame(stream):
    """One frame from a file-like stream. ``None`` on clean EOF at a
    frame boundary; FrameError on anything else."""
    header = _read_exact(stream, HEADER_LEN)
    if not header:
        return None
    if len(header) < HEADER_LEN:
        raise FrameError(
            "truncated",
            f"header ended at {len(header)}/{HEADER_LEN} bytes")
    length, crc = _check_header(header)
    return _finish_frame(_read_exact(stream, length), length, crc)


# -- sockets (the cross-host transport) --------------------------------


def _remaining(deadline, clock=time.monotonic):
    """Seconds left before ``deadline`` (monotonic), or None."""
    if deadline is None:
        return None
    left = deadline - clock()
    if left <= 0:
        raise RequestTimeoutError(
            "deadline expired before the network operation started")
    return left


def send_frame(sock, obj, deadline=None):
    """One frame onto a socket, bounded by ``deadline`` (monotonic
    seconds). Transport failures surface as RemoteUnavailableError;
    an expired deadline as RequestTimeoutError. Fault points:
    net_partition / net_frame_delay / net_frame_drop /
    net_partial_write."""
    if _faultinject.fires("net_partition"):
        raise RemoteUnavailableError(
            "injected network partition (send side)")
    if _faultinject.fires("net_frame_delay"):
        time.sleep(float(os.environ.get(_FAULT_DELAY_ENV, 0.05)))
    data = encode_frame(obj)
    if _faultinject.fires("net_frame_drop"):
        return                      # the network ate it; caller's
    try:                            # deadline is the safety net
        sock.settimeout(_remaining(deadline))
        if _faultinject.fires("net_partial_write"):
            sock.sendall(data[:max(1, len(data) // 2)])
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise ConnectionResetError(
                "injected partial write — connection torn mid-frame")
        sock.sendall(data)
    except socket.timeout as exc:
        raise RequestTimeoutError(
            "deadline expired while sending a frame") from exc
    except OSError as exc:
        raise RemoteUnavailableError(
            f"send failed: {exc}") from exc


def _recv_exact(sock, n, deadline):
    chunks = []
    got = 0
    while got < n:
        sock.settimeout(_remaining(deadline))
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except socket.timeout as exc:
            raise RequestTimeoutError(
                "deadline expired while receiving a frame") from exc
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock, deadline=None):
    """One frame from a socket, bounded by ``deadline``. ``None`` on
    clean EOF at a frame boundary; FrameError / RequestTimeoutError /
    RemoteUnavailableError otherwise."""
    if _faultinject.fires("net_partition"):
        raise RemoteUnavailableError(
            "injected network partition (recv side)")
    try:
        header = _recv_exact(sock, HEADER_LEN, deadline)
    except RequestTimeoutError:
        raise
    except OSError as exc:
        raise RemoteUnavailableError(f"recv failed: {exc}") from exc
    if not header:
        return None
    if len(header) < HEADER_LEN:
        raise FrameError(
            "truncated",
            f"header ended at {len(header)}/{HEADER_LEN} bytes")
    length, crc = _check_header(header)
    try:
        payload = _recv_exact(sock, length, deadline)
    except OSError as exc:
        raise RemoteUnavailableError(f"recv failed: {exc}") from exc
    return _finish_frame(payload, length, crc)


# ---------------------------------------------------------------------------
# handshake
# ---------------------------------------------------------------------------


def default_token():
    """The shared fabric auth token (``PADDLE_TPU_NET_TOKEN``, default
    empty — fine on a loopback dev box, set a real secret on a
    fleet)."""
    return os.environ.get("PADDLE_TPU_NET_TOKEN", "")


def schema_fingerprint():
    """What both ends must agree on before exchanging work: the frame
    protocol version, the torch version and the CUDA build it was
    compiled for (a replica whose torch differs would disagree about
    kernels and numerics — refuse at handshake, not at the first weird
    answer)."""
    import torch
    # plain str: torch.__version__ is a TorchVersion, a class the
    # restricted unpickler refuses
    return {"proto": PROTO_VERSION, "torch": str(torch.__version__),
            "cuda": str(torch.version.cuda or "none")}


def client_hello(token=None, fingerprint=None):
    return {"type": "hello",
            "token": default_token() if token is None else str(token),
            "fingerprint": fingerprint or schema_fingerprint()}


def check_hello(msg, token=None, fingerprint=None):
    """Server-side hello validation; returns None when acceptable,
    else the refusal reason string."""
    if not isinstance(msg, dict) or msg.get("type") != "hello":
        return "malformed hello"
    want = default_token() if token is None else str(token)
    got = msg.get("token")
    if not isinstance(got, str) or not hmac.compare_digest(got, want):
        return "bad auth token"
    want_fp = fingerprint or schema_fingerprint()
    if msg.get("fingerprint") != want_fp:
        return (f"fingerprint mismatch: client "
                f"{msg.get('fingerprint')} vs server {want_fp}")
    return None


def open_conn(addr, token=None, deadline=None, connect_timeout=5.0):
    """Connect + handshake; returns ``(socket, welcome_frame)``.

    ``addr`` is ``(host, port)`` or ``"host:port"``. Raises
    RemoteUnavailableError (unreachable / refused — including the
    ``net_conn_refused`` fault point), HandshakeError (peer refused
    us), FrameError (peer is not speaking the protocol), or
    RequestTimeoutError (deadline)."""
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        addr = (host or "127.0.0.1", int(port))
    if _faultinject.fires("net_conn_refused"):
        raise RemoteUnavailableError(
            f"injected connection refusal to {addr[0]}:{addr[1]}")
    left = _remaining(deadline)
    timeout = connect_timeout if left is None \
        else min(connect_timeout, left)
    try:
        sock = socket.create_connection(addr, timeout=timeout)
    except socket.timeout as exc:
        raise RequestTimeoutError(
            f"connect to {addr[0]}:{addr[1]} timed out") from exc
    except OSError as exc:
        raise RemoteUnavailableError(
            f"cannot connect to {addr[0]}:{addr[1]}: {exc}") from exc
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello_deadline = (time.monotonic() + connect_timeout
                          if deadline is None else deadline)
        send_frame(sock, client_hello(token=token),
                   deadline=hello_deadline)
        welcome = recv_frame(sock, deadline=hello_deadline)
    except BaseException:
        sock.close()
        raise
    if welcome is None:
        sock.close()
        raise RemoteUnavailableError(
            f"{addr[0]}:{addr[1]} closed the connection during "
            "handshake")
    if welcome.get("type") == "reject":
        sock.close()
        raise HandshakeError(
            f"{addr[0]}:{addr[1]} refused the handshake: "
            f"{welcome.get('reason')}")
    if welcome.get("type") != "welcome":
        sock.close()
        raise FrameError(
            "alien-magic",
            f"peer answered the hello with {welcome.get('type')!r}")
    return sock, welcome


def hash_blob(blob):
    """sha256 hex of a wire blob (provisioning integrity checks)."""
    return hashlib.sha256(blob).hexdigest()
