"""Replica worker process — one ServingEngine behind a pipe protocol
(port of ``paddle_tpu/cluster/proc_worker.py``).

Spawned by :class:`~paddle_tpu_torch.cluster.replica.ProcessReplica`:

    python -m paddle_tpu_torch.cluster.proc_worker --dir <saved_model_dir>

It runs on the card; ``--cpu`` runs it on the host (the spawner passes
it when its own place is the host). Without ``--cpu`` and with no CUDA
device it exits with status 2, naming the reason.

Loads the ``save_inference_model`` artifact, builds a ServingEngine
over it (buckets from the artifact's serving manifest when present),
warms up, then serves ``cluster/net.py`` frames (magic + version +
CRC32, restricted unpickling — the same codec as the socket fabric)
read from stdin:

    {"type": "submit", "id": n, "feed": {...}, "timeout": s | None}
        -> {"type": "result", "id": n, "value": [arrays]}
         | {"type": "error", "id": n, "error": (type_name, message)}
    {"type": "stats", "id": n} -> {"type": "stats", "id": n, "value": {...}}
    {"type": "close", "drain": bool, "drain_timeout": s | None}
        -> drains (optionally) and exits 0

``--decode`` serves a :func:`~paddle_tpu_torch.models.llama.save_decode_model`
directory with a DecodeEngine instead: ``submit`` feeds are prompt
arrays (``kw`` carries max_new / prefill_only / an SLO dict), results
are generated-token arrays — or a KV handoff blob for ``prefill_only``
— and the extra ``handoff`` verb adopts such a blob on a decode-role
worker:

    {"type": "handoff", "id": n, "state": {...}, "timeout": s | None,
     "kw": {...}} -> result | error, as for submit

The real stdout fd is reserved for protocol frames; python-level
stdout is re-pointed at stderr first, so a stray print (warmup
chatter, user code) can never corrupt a frame. A SIGKILL'd worker just
disappears — the parent's reader thread sees EOF and fails every
pending request with WorkerDiedError, which is exactly the replica-
crash drill's contract.
"""
import argparse
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor


def _claim_stdout():
    """Duplicate the protocol fd, then point fd 1 (and sys.stdout) at
    stderr so nothing else can write frames."""
    proto_fd = os.dup(sys.stdout.fileno())
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    return os.fdopen(proto_fd, "wb")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve a saved model to a ProcessReplica over "
                    "stdin/stdout frames")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--default-timeout-s", type=float, default=30.0)
    # --decode serves a models.llama.save_decode_model directory with
    # a DecodeEngine (continuous batching + the handoff verb) instead
    # of a save_inference_model dir with a ServingEngine
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-buckets", default="16,32")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=None)
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--scheduler", default=None)
    args = ap.parse_args(argv)

    from paddle_tpu_torch.cluster.replica import require_device
    place = require_device(args.cpu)
    proto_out = _claim_stdout()
    proto_in = sys.stdin.buffer

    import numpy as np

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.cluster.net import (FrameError, read_frame,
                                              write_frame)
    from paddle_tpu_torch.serving import ServingError

    if args.decode:
        from paddle_tpu_torch.models.llama import load_decode_model
        cfg, scope = load_decode_model(args.dir)
        buckets = tuple(int(b) for b in
                        str(args.prompt_buckets).split(",") if b)
        engine = serving.DecodeEngine(
            cfg, scope=scope, place=place,
            config=serving.DecodeConfig(
                max_batch=args.max_batch, prompt_buckets=buckets,
                max_new_tokens=args.max_new_tokens,
                page_size=args.page_size, n_pages=args.n_pages,
                chunk_size=args.chunk_size, scheduler=args.scheduler,
                max_queue=args.max_queue,
                default_timeout_s=args.default_timeout_s))
    else:
        engine = serving.ServingEngine.from_saved_model(
            args.dir, place=place,
            config=serving.ServingConfig(
                max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
                default_timeout_s=args.default_timeout_s))
    warm = None if args.no_warmup else engine.warmup()

    write_lock = threading.Lock()

    def send(obj):
        with write_lock:
            # racecheck: ok(blocking-under-lock) — the lock exists only
            # to keep pool threads' reply frames from interleaving on
            # the protocol fd; frames fit the pipe buffer
            write_frame(proto_out, obj)

    send({"type": "ready", "warmup": warm, "stats": engine.stats()})

    def _wire_slo(kw):
        """An SLO crosses the pipe as a plain dict (the restricted
        unpickler refuses custom classes — by design); rebuild the
        SLOClass worker-side."""
        slo = kw.get("slo")
        if isinstance(slo, dict):
            kw["slo"] = serving.SLOClass(**slo)
        return kw

    def serve_one(req_id, feed, timeout, kw):
        try:
            if args.decode:
                handle = engine.submit(np.asarray(feed),
                                       timeout=timeout,
                                       **_wire_slo(kw))
                # grace past the serving deadline, like Router.infer:
                # the engine's typed error is the real signal
                value = handle.result(
                    None if timeout is None else float(timeout) + 10.0)
            else:
                value = engine.infer(feed, timeout=timeout)
            send({"type": "result", "id": req_id, "value": value})
        except (ServingError, ValueError) as exc:
            send({"type": "error", "id": req_id,
                  "error": (type(exc).__name__, str(exc))})
        except Exception as exc:             # noqa: BLE001 — forwarded
            send({"type": "error", "id": req_id,
                  "error": (type(exc).__name__, str(exc))})

    def serve_handoff(req_id, state, timeout, kw):
        try:
            handle = engine.import_handoff(state, timeout=timeout,
                                           **_wire_slo(kw))
            value = handle.result(
                None if timeout is None else float(timeout) + 10.0)
            send({"type": "result", "id": req_id, "value": value})
        except Exception as exc:             # noqa: BLE001 — forwarded
            send({"type": "error", "id": req_id,
                  "error": (type(exc).__name__, str(exc))})

    pool = ThreadPoolExecutor(max_workers=8,
                              thread_name_prefix="replica-serve")
    try:
        while True:
            try:
                msg = read_frame(proto_in)
            except FrameError:
                # protocol damage on OUR command stream: the stream
                # position is unknowable, so exit — the parent's
                # reader sees EOF and fails pending typed
                engine.close()
                return 1
            if msg is None:       # parent went away: treat as close
                engine.close()
                return 0
            kind = msg.get("type")
            if kind == "submit":
                pool.submit(serve_one, msg["id"], msg["feed"],
                            msg.get("timeout"), msg.get("kw") or {})
            elif kind == "handoff":
                pool.submit(serve_handoff, msg["id"], msg["state"],
                            msg.get("timeout"), msg.get("kw") or {})
            elif kind == "stats":
                send({"type": "stats", "id": msg["id"],
                      "value": engine.stats()})
            # protocheck: ok(verb-asymmetric) — 'close' is pipe-only
            # on purpose: a ProcessReplica OWNS its child and shuts it
            # down; a RemoteReplica is one client of a SHARED server
            # and must never be able to close it (the socket hangup is
            # 'bye', which drops only that connection)
            elif kind == "close":
                engine.close(drain=bool(msg.get("drain")),
                             drain_timeout=msg.get("drain_timeout"))
                # let in-flight serve_one threads flush their result
                # frames before the process exits — a drained request
                # whose reply died in the pipe would count as lost
                pool.shutdown(wait=True)
                return 0
    finally:
        pool.shutdown(wait=False)


if __name__ == "__main__":
    sys.exit(main())
