"""TrainWorkerServer — one training host behind a TCP socket (port of
``paddle_tpu/cluster/train_worker.py``).

The training-side sibling of ``net_worker.ReplicaServer``: where that
module serves *inference* over the CRC-framed transport, this one
serves gradient computation to a
:class:`~paddle_tpu_torch.cluster.train_fabric.TrainCoordinator`. A worker
is deliberately passive and (almost) stateless: the coordinator sends
the authoritative params with EVERY ``train_step``, so a worker that
died and came back — or a brand-new replacement host — needs nothing
but this entrypoint, the task spec (re-sent on ``train_configure``),
and, for compiled tasks, an ``__artifacts__`` store it can
cold-provision over the wire from any live peer
(``net_worker.provision_from_remote``). The only
state a worker retains is the last COMMITTED ``(step, sha)`` it
verified, which is exactly what a parked worker needs to answer a new
coordinator's catch-up commit after the old coordinator died.

Wire verbs (after the hello/welcome handshake; see
``train_fabric`` for the frame schemas)::

    train_configure   rebuild the task from its spec
    train_step        compute per-shard gradient SUMS for the given
                      (step, state, shards); the determinism contract
                      is the task's, the worker just evaluates it
    train_commit      re-hash the broadcast state and VERIFY the
                      leader's sha (followers-verify half of the
                      commit barrier); remember (step, sha)
    stats/ping        ops plane + heartbeat
    fetch_manifest /  serve this worker's artifact dir so a PEER can
    fetch_artifact    provision itself over the wire (same
                      path-confined, checksummed protocol as serving)
    bye               close this connection (server stays up)

Parking: a worker whose coordinator vanished simply keeps listening —
``stats()`` reports ``coordinator_age_s`` so operators can see the
fleet is parked, and the ``--park-deadline`` entrypoint flag turns
"parked too long" into a clean typed exit (status 3) instead of a
zombie host.

Fault points (armed via ``PADDLE_TPU_FAULTS`` or
``faultinject.arm``): the step handler marks a ``train_step``
progress event, then checks ``trainer_crash_at_step`` (hard death:
``os._exit`` when ``--hard-exit``/``hard_exit=True`` — a real
SIGKILL-shaped hole for subprocess drills — else an abrupt
listener+connection teardown for in-process tests) and
``trainer_straggle`` (stall ``PADDLE_TPU_FAULT_STRAGGLE_S`` seconds —
the coordinator's straggler deadline must evict us).

Run in-process (tests) or as a host entrypoint::

    python -m paddle_tpu_torch.cluster.train_worker --port 7731 \
        [--artifact-dir DIR] [--provision-from HOST:PORT] \
        [--park-deadline 60] [--hard-exit] [--cpu]

A program task computes on the card; ``--cpu`` computes on the host.
Without ``--cpu`` and with no CUDA device the entry point exits with
status 2, naming the reason.
"""
import argparse
import os
import socket
import threading
import time

import numpy as np

from ..resilience import faultinject as _faultinject
from ..resilience.checkpoint import state_sha
from . import net
from .train_fabric import task_from_spec

__all__ = ["TrainWorkerServer"]

_HANDSHAKE_TIMEOUT_S = 10.0
_STRAGGLE_ENV = "PADDLE_TPU_FAULT_STRAGGLE_S"


class TrainWorkerServer:
    """Serve gradient computation over TCP for one training host.

    ``port=0`` picks a free port (read it back from ``.port``).
    ``artifact_dir`` doubles as the compile cache for program tasks
    AND the directory served to provisioning peers. ``hard_exit=True``
    makes an injected ``trainer_crash_at_step`` call ``os._exit`` —
    subprocess drills want the SIGKILL shape; in-process tests get an
    abrupt socket teardown instead. ``place`` is where a program task
    computes (default: this process's default place)."""

    def __init__(self, host="127.0.0.1", port=0, token=None,
                 name=None, artifact_dir=None, hard_exit=False,
                 backlog=16, place=None):
        self._token = token
        self.place = place
        self.artifact_dir = (os.path.abspath(artifact_dir)
                             if artifact_dir else None)
        self.hard_exit = bool(hard_exit)
        self._task = None
        self._task_spec = None
        self._task_lock = threading.Lock()
        self._closed = threading.Event()
        self._conns = set()
        self._conns_lock = threading.Lock()
        self.last_step = None
        self.committed_step = None
        self.committed_sha = None
        self._last_contact = time.monotonic()
        self._counters = {"connections_total": 0,
                          "handshake_refused_total": 0,
                          "protocol_errors_total": 0,
                          "steps_total": 0,
                          "commits_total": 0,
                          "commit_mismatches_total": 0,
                          "artifacts_served_total": 0}
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(backlog)
        self.host, self.port = self._listener.getsockname()[:2]
        self.name = name or f"train-worker@{self.host}:{self.port}"
        self._acceptor = threading.Thread(
            target=self._accept_loop, name=f"{self.name}-accept",
            daemon=True)
        self._acceptor.start()

    @property
    def addr(self):
        return f"{self.host}:{self.port}"

    def total_compiles(self):
        """Step builds this worker's task has performed — 0 for pure
        tasks, one for a program task's gradient step (the port's
        store holds no train step: ROADMAP.md §3 F6)."""
        with self._task_lock:
            task = self._task
        return task.total_compiles() if task is not None else 0

    def coordinator_age_s(self):
        """Seconds since the last coordinator contact — the parking
        clock."""
        return round(time.monotonic() - self._last_contact, 3)

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
                # ONLY to serialize frame writes on this socket;
                # nothing else ever waits on it
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
                  "stats": self.stats()})
            while not self._closed.is_set():
                msg = net.recv_frame(sock)
                if msg is None or msg.get("type") == "bye":
                    return
                self._last_contact = time.monotonic()
                self._dispatch(msg, send)
        except net.FrameError as exc:
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

    # -- verbs -----------------------------------------------------------
    def _dispatch(self, msg, send):
        kind = msg.get("type")
        req_id = msg.get("id")
        try:
            if kind == "train_configure":
                self._handle_configure(req_id, msg, send)
            elif kind == "train_step":
                self._handle_step(req_id, msg, send)
            elif kind == "train_commit":
                self._handle_commit(req_id, msg, send)
            elif kind == "stats":
                send({"type": "stats", "id": req_id,
                      "value": self.stats()})
            # protocheck: ok(verb-dead) — operator liveness probe,
            # mirrors ReplicaServer; the coordinator heartbeats with
            # 'stats' because it also wants the worker's step serial
            elif kind == "ping":
                send({"type": "pong", "id": req_id})
            elif kind == "fetch_manifest":
                self._handle_manifest(req_id, send)
            elif kind == "fetch_artifact":
                self._send_artifact(req_id, msg.get("path"), send)
            else:
                send({"type": "error", "id": req_id,
                      "error": ("ServingError",
                                f"unknown verb {kind!r}")})
        except _faultinject.SimulatedCrash:
            raise
        except Exception as exc:    # noqa: BLE001 — forwarded typed
            send({"type": "error", "id": req_id,
                  "error": net.wire_error(exc)})

    def _handle_configure(self, req_id, msg, send):
        spec = msg.get("task")
        with self._task_lock:
            if spec != self._task_spec:
                self._task = task_from_spec(
                    spec, artifact_dir=self.artifact_dir,
                    place=self.place)
                self._task_spec = spec
            task = self._task
        send({"type": "train_configured", "id": req_id,
              "name": self.name,
              "total_compiles": task.total_compiles()})

    def _die(self):
        """The injected-crash shape: with ``hard_exit`` the process is
        GONE (``os._exit`` — no atexit, no flush: models kill -9);
        in-process, the listener and every connection are torn down
        abruptly so the coordinator sees the same wire symptoms."""
        if self.hard_exit:
            os._exit(17)
        self._closed.set()
        self._close_listener()
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            self._drop_conn(sock)

    def _handle_step(self, req_id, msg, send):
        _faultinject.event("train_step")
        if _faultinject.fires("trainer_crash_at_step"):
            self._die()
            return
        if _faultinject.fires("trainer_straggle"):
            time.sleep(float(os.environ.get(_STRAGGLE_ENV, "1.0")))
        with self._task_lock:
            task = self._task
        if task is None:
            send({"type": "error", "id": req_id,
                  "error": ("ServingError",
                            "train_step before train_configure")})
            return
        step = int(msg["step"])
        n_shards = int(msg["n_shards"])
        state = {k: np.asarray(v) for k, v in msg["state"].items()}
        out = {}
        for shard in msg["shards"]:
            shard = int(shard)
            loss_sum, gsums, rows = task.grad_sums(
                state, step, shard, n_shards)
            out[shard] = {"loss_sum": float(loss_sum),
                          "n_rows": int(rows),
                          "grads": {k: np.asarray(v, np.float32)
                                    for k, v in gsums.items()}}
        self.last_step = step
        self._incr("steps_total")
        send({"type": "train_grads", "id": req_id, "step": step,
              "shards": out})

    def _handle_commit(self, req_id, msg, send):
        """Followers-verify: re-hash the broadcast state and compare
        with the leader's manifest sha. A mismatch is reported
        honestly (ok=False) — the coordinator evicts us; agreeing
        with a sha we did not compute would defeat the barrier."""
        state = {k: np.asarray(v) for k, v in msg["state"].items()}
        ours = state_sha(state)
        ok = bool(ours == msg.get("sha"))
        if ok:
            self.committed_step = int(msg["step"])
            self.committed_sha = ours
            self._incr("commits_total")
        else:
            self._incr("commit_mismatches_total")
        _faultinject.event("train_commit")
        send({"type": "train_committed", "id": req_id, "ok": ok,
              "sha": ours})

    def _handle_manifest(self, req_id, send):
        if self.artifact_dir is None \
                or not os.path.isdir(self.artifact_dir):
            send({"type": "manifest", "id": req_id, "value": {}})
            return
        from ..io.artifact_store import dir_manifest
        send({"type": "manifest", "id": req_id,
              "value": dir_manifest(self.artifact_dir)})

    def _send_artifact(self, req_id, relpath, send):
        """One file of the artifact dir, path-confined and
        checksummed — lets a replacement worker provision its compile
        cache from this live peer."""
        try:
            if self.artifact_dir is None:
                raise ValueError(
                    f"worker {self.name} has no artifact dir to serve")
            if not isinstance(relpath, str) or os.path.isabs(relpath):
                raise ValueError(f"artifact path must be relative, "
                                 f"got {relpath!r}")
            root = os.path.realpath(self.artifact_dir)
            full = os.path.realpath(os.path.join(root, relpath))
            if not (full + os.sep).startswith(root + os.sep) \
                    and full != root:
                raise ValueError(
                    f"artifact path {relpath!r} escapes the "
                    "artifact dir")
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
        with self._task_lock:
            spec = dict(self._task_spec) if self._task_spec else None
        with self._conns_lock:
            snap = dict(self._counters)
            snap["open_connections"] = len(self._conns)
        snap.update({
            "addr": self.addr,
            "name": self.name,
            "task": spec,
            "last_step": self.last_step,
            "committed_step": self.committed_step,
            "committed_sha": self.committed_sha,
            "coordinator_age_s": self.coordinator_age_s(),
            "total_compiles": self.total_compiles(),
        })
        return snap

    def _close_listener(self):
        # shutdown BEFORE close: merely closing the fd leaves a
        # thread blocked in accept() stuck (Linux); shutdown wakes it
        # with a typed OSError immediately
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    def close(self):
        self._closed.set()
        self._close_listener()
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
# host entrypoint
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve gradient computation for a train "
                    "coordinator over TCP")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7731)
    ap.add_argument("--artifact-dir", default=None,
                    help="compile cache for program tasks; also "
                         "served to provisioning peers")
    ap.add_argument("--provision-from", default=None, metavar="ADDR",
                    help="cold-provision --artifact-dir over the wire "
                         "from a live peer worker before serving")
    ap.add_argument("--park-deadline", type=float, default=None,
                    metavar="S",
                    help="exit status 3 when no coordinator has "
                         "spoken for S seconds (default: park "
                         "forever)")
    ap.add_argument("--hard-exit", action="store_true",
                    help="an injected trainer_crash_at_step calls "
                         "os._exit (SIGKILL shape) instead of a "
                         "socket teardown")
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the host instead of the card")
    args = ap.parse_args(argv)
    from .replica import require_device
    place = require_device(args.cpu)
    if args.provision_from:
        if not args.artifact_dir:
            ap.error("--provision-from requires --artifact-dir")
        from .net_worker import provision_from_remote
        report = provision_from_remote(args.provision_from,
                                       args.artifact_dir)
        print(f"provisioned {report['files']} files "
              f"({report['bytes']} bytes) from {args.provision_from} "
              f"in {report['wall_s']}s", flush=True)
    server = TrainWorkerServer(
        host=args.host, port=args.port,
        artifact_dir=args.artifact_dir, hard_exit=args.hard_exit,
        place=place)
    print(f"train worker ready on {server.addr} "
          f"(compiles={server.total_compiles()})", flush=True)
    try:
        while True:
            time.sleep(0.5)
            if args.park_deadline is not None \
                    and server.coordinator_age_s() > args.park_deadline:
                print(f"parked past the {args.park_deadline}s "
                      "deadline with no coordinator — exiting",
                      flush=True)
                return 3
    except KeyboardInterrupt:
        return 0
    finally:
        server.close()


if __name__ == "__main__":
    import sys
    sys.exit(main())
