"""ReplicaServer — one serving replica behind a TCP socket (port of
``paddle_tpu/cluster/net_worker.py``).

The cross-host half of the replica story: where ``proc_worker`` serves
a ``save_inference_model`` directory to its parent over a stdio pipe,
:class:`ReplicaServer` serves the same engine to ANY number of
concurrent client connections over sockets (``cluster/net.py`` frames:
magic + version + CRC32, restricted unpickling, handshake auth). A
fresh host needs nothing but this module and a saved-model dir — and
with the ``fetch_manifest`` / ``fetch_artifact`` verbs it does not even
need the dir: a peer can provision itself over the wire
(:func:`provision_from_remote`), ``__artifacts__`` blobs included, so
the new replica needs no shared filesystem. (The port's engine takes
the embedded store only when asked, ROADMAP.md §3 F6: a server built
here warms by building its buckets' steps, and counts no step build
after warmup.)

Wire verbs (after the hello/welcome handshake)::

    {"type": "submit", "id": n, "feed": {...}, "timeout": s | None}
        -> {"type": "result", "id": n, "value": [arrays]}
         | {"type": "error", "id": n, "error": (type_name, message)}
    {"type": "stats", "id": n}   -> {"type": "stats", "id": n, "value": {...}}
    {"type": "ping", "id": n}    -> {"type": "pong", "id": n}
    {"type": "fetch_manifest", "id": n}
        -> {"type": "manifest", "id": n,
            "value": {relpath: {"sha256": ..., "bytes": n}}}
    {"type": "fetch_artifact", "id": n, "path": relpath}
        -> {"type": "artifact", "id": n, "path": relpath,
            "blob": bytes, "sha256": ...}
    {"type": "bye"}              -> connection closed (server stays up)

A protocol error on one connection (alien bytes, CRC damage, a
disallowed pickle global) answers with a typed ``protocol_error`` frame
when the socket still works, then closes THAT connection — the server
and its other clients keep serving. Closing a client connection never
drains the engine; :meth:`ReplicaServer.close` is the deploy boundary.

Run in-process (tests, loopback benches) or as a host entrypoint::

    python -m paddle_tpu_torch.cluster.net_worker --dir <saved_model_dir> \
        --port 7711 [--cpu]

It serves from the card; ``--cpu`` serves from the host. Without
``--cpu`` and with no CUDA device it exits with status 2, naming the
reason. ``--port 0`` picks a free port and the ready line names it.
"""
import argparse
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..io.artifact_store import dir_manifest
from . import net

__all__ = ["ReplicaServer", "provision_from_remote"]

_HANDSHAKE_TIMEOUT_S = 10.0


class ReplicaServer:
    """Serve a ``save_inference_model`` directory over TCP.

    ``port=0`` picks a free port (read it back from ``.port``).
    ``token=None`` uses the shared-env default. ``engine_kw`` forwards
    ServingConfig knobs exactly like ProcessReplica does. The engine
    is built (and warmed, unless ``warmup=False``) at construction, so
    ``.warmup_report`` answers the zero-compile question before the
    first client connects.

    ``engine=`` serves a pre-built engine instead (a DecodeEngine for
    disaggregated decode serving: submit feeds are prompt arrays, the
    extra ``handoff`` wire verb adopts KV handoff blobs); model_dir
    may then be None — the artifact verbs refuse politely.

    ``place`` is the built engine's (default: this process's default
    place, the card unless the process was forced to the host)."""

    def __init__(self, model_dir, host="127.0.0.1", port=0,
                 token=None, name=None, warmup=True, max_workers=8,
                 backlog=16, engine=None, place=None, **engine_kw):
        from ..serving import ServingConfig, ServingEngine
        self.model_dir = (None if model_dir is None
                          else os.path.abspath(model_dir))
        self._token = token
        if engine is not None:
            if engine_kw:
                raise TypeError(
                    "pass engine_kw only when the server builds the "
                    f"engine itself, got both engine= and {engine_kw}")
            self.engine = engine
        else:
            self.engine = ServingEngine.from_saved_model(
                self.model_dir, place=place,
                config=ServingConfig(**engine_kw) if engine_kw
                else None)
        self.warmup_report = self.engine.warmup() if warmup else None
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="replica-net-serve")
        self._closed = threading.Event()
        self._conns = set()
        self._conns_lock = threading.Lock()
        self._counters = {"connections_total": 0,
                          "handshake_refused_total": 0,
                          "protocol_errors_total": 0,
                          "artifacts_served_total": 0}
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(backlog)
        self.host, self.port = self._listener.getsockname()[:2]
        self.name = name or f"net-replica@{self.host}:{self.port}"
        self._acceptor = threading.Thread(
            target=self._accept_loop, name=f"{self.name}-accept",
            daemon=True)
        self._acceptor.start()

    @property
    def addr(self):
        return f"{self.host}:{self.port}"

    def total_compiles(self):
        """Step builds this server's engine has performed (one a
        warmed bucket; a step loaded from an artifact store counts
        none)."""
        return self.engine.exe.total_compiles()

    def _incr(self, key, n=1):
        with self._conns_lock:
            self._counters[key] += n

    # -- accept / per-connection ----------------------------------------
    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                sock, peer = self._listener.accept()
            except OSError:
                return              # listener closed: shutting down
            self._incr("connections_total")
            with self._conns_lock:
                self._conns.add(sock)
            threading.Thread(
                target=self._serve_conn, args=(sock, peer),
                name=f"{self.name}-conn", daemon=True).start()

    def _drop_conn(self, sock):
        with self._conns_lock:
            self._conns.discard(sock)
        try:
            sock.close()
        except OSError:
            pass

    def _serve_conn(self, sock, peer):
        write_lock = threading.Lock()

        def send(obj):
            with write_lock:
                # racecheck: ok(blocking-under-lock) — the lock exists
                # ONLY to serialize frame writes on this socket (pool
                # threads answer concurrently); nothing else ever
                # waits on it
                net.send_frame(sock, obj)

        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            deadline = time.monotonic() + _HANDSHAKE_TIMEOUT_S
            hello = net.recv_frame(sock, deadline=deadline)
            if hello is None:
                return
            refusal = net.check_hello(hello, token=self._token)
            if refusal is not None:
                self._incr("handshake_refused_total")
                send({"type": "reject", "reason": refusal})
                return
            send({"type": "welcome", "name": self.name,
                  "fingerprint": net.schema_fingerprint(),
                  "warmup": self.warmup_report,
                  "stats": self.engine.stats()})
            while not self._closed.is_set():
                msg = net.recv_frame(sock)
                # protocheck: ok(verb-asymmetric) — 'bye' is the
                # socket-only polite hangup; the pipe transport's
                # equivalent is simply closing the child's stdin (EOF)
                if msg is None or msg.get("type") == "bye":
                    return
                self._dispatch(msg, send)
        except net.FrameError as exc:
            # this CONNECTION is damaged; tell the peer (typed, best
            # effort) and drop it — the server keeps serving others
            self._incr("protocol_errors_total")
            try:
                send({"type": "protocol_error",
                      "error": net.wire_error(exc)})
            except Exception:       # noqa: BLE001 — socket is gone
                pass
        except (OSError, net.RemoteUnavailableError,
                net.RequestTimeoutError):
            pass                    # peer vanished mid-frame
        finally:
            self._drop_conn(sock)

    def _dispatch(self, msg, send):
        kind = msg.get("type")
        req_id = msg.get("id")
        if kind == "submit":
            self._pool.submit(self._serve_one, req_id, msg.get("feed"),
                              msg.get("timeout"), send,
                              msg.get("kw") or {})
        elif kind == "handoff":
            self._pool.submit(self._serve_handoff, req_id,
                              msg.get("state"), msg.get("timeout"),
                              send, msg.get("kw") or {})
        elif kind == "stats":
            send({"type": "stats", "id": req_id,
                  "value": self.stats()})
        # protocheck: ok(verb-dead) — liveness probe for operators and
        # external monitors (nc/ncat a frame, get a pong); in-tree
        # clients use 'stats' for health because it refreshes the
        # membership view's metrics at the same time
        elif kind == "ping":
            send({"type": "pong", "id": req_id})
        # protocheck: ok(verb-asymmetric) — artifact provisioning is
        # socket-only by design: a pipe replica is a child process on
        # the same host and shares the parent's filesystem, so it
        # never fetches artifacts over its own wire
        elif kind == "fetch_manifest":
            if self.model_dir is None:
                send({"type": "error", "id": req_id,
                      "error": ("ServingError",
                                "this server has no model dir to "
                                "serve artifacts from")})
                return
            send({"type": "manifest", "id": req_id,
                  "value": dir_manifest(self.model_dir)})
        # protocheck: ok(verb-asymmetric) — socket-only, same reason
        # as fetch_manifest: pipe replicas share the host filesystem
        elif kind == "fetch_artifact":
            self._send_artifact(req_id, msg.get("path"), send)
        else:
            send({"type": "error", "id": req_id,
                  "error": ("ServingError",
                            f"unknown verb {kind!r}")})

    @staticmethod
    def _wire_slo(kw):
        """An SLO crosses the wire as a plain dict (the restricted
        unpickler refuses custom classes — by design); rebuild the
        SLOClass server-side."""
        slo = kw.get("slo")
        if isinstance(slo, dict):
            from ..serving import SLOClass
            kw["slo"] = SLOClass(**slo)
        return kw

    def _serve_one(self, req_id, feed, timeout, send, kw=None):
        try:
            if hasattr(self.engine, "infer"):       # ServingEngine
                value = self.engine.infer(feed, timeout=timeout)
            else:                                   # DecodeEngine
                import numpy as np
                handle = self.engine.submit(
                    np.asarray(feed), timeout=timeout,
                    **self._wire_slo(dict(kw or {})))
                value = handle.result(
                    None if timeout is None else float(timeout) + 10.0)
            send({"type": "result", "id": req_id, "value": value})
        except Exception as exc:        # noqa: BLE001 — forwarded
            try:
                send({"type": "error", "id": req_id,
                      "error": net.wire_error(exc)})
            except Exception:           # noqa: BLE001 — conn gone; the
                pass                    # client's deadline covers it

    def _serve_handoff(self, req_id, state, timeout, send, kw=None):
        try:
            handle = self.engine.import_handoff(
                state, timeout=timeout,
                **self._wire_slo(dict(kw or {})))
            value = handle.result(
                None if timeout is None else float(timeout) + 10.0)
            send({"type": "result", "id": req_id, "value": value})
        except Exception as exc:        # noqa: BLE001 — forwarded
            try:
                send({"type": "error", "id": req_id,
                      "error": net.wire_error(exc)})
            except Exception:           # noqa: BLE001 — conn gone
                pass

    def _send_artifact(self, req_id, relpath, send):
        """One file of the model dir, path-confined and checksummed —
        the remote-provisioning primitive."""
        try:
            if not isinstance(relpath, str) or os.path.isabs(relpath):
                raise ValueError(f"artifact path must be relative, "
                                 f"got {relpath!r}")
            full = os.path.realpath(
                os.path.join(self.model_dir, relpath))
            if not (full + os.sep).startswith(
                    os.path.realpath(self.model_dir) + os.sep) \
                    and full != os.path.realpath(self.model_dir):
                raise ValueError(
                    f"artifact path {relpath!r} escapes the model dir")
            with open(full, "rb") as f:
                blob = f.read()
        except (OSError, ValueError) as exc:
            send({"type": "error", "id": req_id,
                  "error": net.wire_error(
                      exc if isinstance(exc, ValueError)
                      else ValueError(str(exc)))})
            return
        self._incr("artifacts_served_total")
        send({"type": "artifact", "id": req_id, "path": relpath,
              "blob": blob, "sha256": net.hash_blob(blob)})

    # -- introspection / lifecycle ---------------------------------------
    def stats(self):
        snap = self.engine.stats()
        with self._conns_lock:
            snap.update(self._counters)
            snap["open_connections"] = len(self._conns)
        snap["addr"] = self.addr
        snap["total_compiles"] = self.total_compiles()
        return snap

    def close(self, drain=False, drain_timeout=None):
        """Stop accepting, drop every connection, shut the engine down
        (``drain=True`` lets admitted work finish first)."""
        self._closed.set()
        # shutdown BEFORE close: merely closing the fd leaves a thread
        # blocked in accept() stuck (Linux); shutdown wakes it with a
        # typed OSError immediately, so close() returns fast instead
        # of eating the full acceptor join timeout
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self.engine.close(drain=drain, drain_timeout=drain_timeout)
        self._pool.shutdown(wait=True)
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            self._drop_conn(sock)
        self._acceptor.join(5.0)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# remote provisioning
# ---------------------------------------------------------------------------


def provision_from_remote(addr, dest_dir, token=None, timeout=120.0):
    """Materialize a saved-model directory from a running
    :class:`ReplicaServer` — no shared filesystem: fetch the file
    manifest, then every file (``__artifacts__`` blobs and the warmup
    manifest included) over ``fetch_artifact``, each verified against
    its sha256 before it touches disk. Returns a report dict; a fresh
    ``ReplicaServer(dest_dir)`` afterwards warms the exporter's bucket
    set with zero step builds."""
    t0 = time.monotonic()
    deadline = None if timeout is None else t0 + float(timeout)
    sock, _welcome = net.open_conn(addr, token=token,
                                   deadline=deadline)
    total = 0
    try:
        net.send_frame(sock, {"type": "fetch_manifest", "id": 0},
                       deadline=deadline)
        reply = net.recv_frame(sock, deadline=deadline)
        if reply is None or reply.get("type") != "manifest":
            if reply is not None and reply.get("type") == "error":
                net.raise_wire_error(reply["error"])
            raise net.FrameError(
                "alien-magic", f"expected a manifest frame, got "
                f"{None if reply is None else reply.get('type')!r}")
        manifest = reply["value"]
        os.makedirs(dest_dir, exist_ok=True)
        for i, (relpath, spec) in enumerate(sorted(manifest.items())):
            net.send_frame(sock, {"type": "fetch_artifact",
                                  "id": i + 1, "path": relpath},
                           deadline=deadline)
            got = net.recv_frame(sock, deadline=deadline)
            if got is None:
                raise net.RemoteUnavailableError(
                    f"{addr} closed the connection mid-provision")
            if got.get("type") == "error":
                net.raise_wire_error(got["error"])
            blob = got["blob"]
            if net.hash_blob(blob) != spec["sha256"]:
                raise net.FrameError(
                    "crc-mismatch",
                    f"{relpath} arrived with sha256 != manifest — "
                    "refusing to provision from damaged bytes")
            full = os.path.join(dest_dir, relpath)
            os.makedirs(os.path.dirname(full) or dest_dir,
                        exist_ok=True)
            with open(full, "wb") as f:
                f.write(blob)
            total += len(blob)
        try:
            net.send_frame(sock, {"type": "bye"})
        except Exception:           # noqa: BLE001 — best-effort bye
            pass
    finally:
        sock.close()
    return {"files": len(manifest), "bytes": total,
            "wall_s": round(time.monotonic() - t0, 3)}


# ---------------------------------------------------------------------------
# host entrypoint
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve a save_inference_model dir over TCP")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7711)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--max-workers", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--default-timeout-s", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true",
                    help="serve from the host instead of the card")
    args = ap.parse_args(argv)
    from .replica import require_device
    place = require_device(args.cpu)
    server = ReplicaServer(
        args.dir, host=args.host, port=args.port, place=place,
        warmup=not args.no_warmup, max_workers=args.max_workers,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        default_timeout_s=args.default_timeout_s)
    print(f"replica server ready on {server.addr} "
          f"(compiles={server.total_compiles()})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close(drain=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
