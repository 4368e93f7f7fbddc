"""Persistent compiled-artifact store — zero-build cold starts.

Port of ``paddle_tpu/io/artifact_store.py``: the same keys, write and
read discipline, quarantine, LRU and counters; the payload is the
port's own. An :class:`ArtifactStore` is a content-addressed on-disk
cache of steps, and an :class:`~paddle_tpu_torch.core.executor.Executor`
given ``compile_store=`` (or the ``PADDLE_TPU_ARTIFACT_DIR`` env var)
consults it before building a step and persists what it had to build —
so the NEXT process (a fresh serving replica, an engine from a saved
model) loads steps instead of building them.

The payload of an entry is the test-mode step for ONE argument
signature (a serving bucket), exported through ``torch.export`` with
io/aot.py's machinery: one graph of aten operators and K1
(``torch.ops.paddle_tpu_torch.flash_fwd``), with the state and the
feeds as inputs. Loading it replaces the step build: the executor calls
the graph module, and ``compile_counts`` does not grow. Train steps
(autograd inside the step) are not exported; they bypass the store,
counted in ``bypass_total``.

Key derivation — an entry key is the sha256 of everything that could
change the step:

- the **canonical program serialization**: blocks/ops/attrs with every
  interior variable alpha-renamed to a position index. Externally
  visible names (persistables, data vars, fetch targets) keep their
  real names — they are the step's argument and result names, so two
  programs must agree on them to share a step. Interior temporaries are
  process-local ``unique_name`` artifacts; renaming them makes the key
  stable across processes that built the same computation (and across
  the new Program object ``from_saved_model`` builds from JSON).
- the execution contract: mode, fetch set, ``repeats``, state donation.
- the **bucket shape signature**: the state and feed names and the
  shape/dtype of each.
- the **library fingerprint**: the torch and CUDA versions, the
  device's name and compute capability, the hash of the kernel sources
  (``cuda_build.library_path``), and the store schema version — a torch
  upgrade or a kernel edit changes the key, so old entries are simply
  never matched (and LRU GC ages them out) instead of loading a stale
  graph.

Entry layout (``<root>/art_<key>/``)::

    step.pt2            torch.export.save of the exported step
    MANIFEST.json       per-file sha256 + byte counts, the library
                        fingerprint, and the step's param/feed order

Write discipline is the resilience store's (resilience/checkpoint.py):
files are written into a dot-prefixed temp dir and fsynced, the
MANIFEST lands last, the temp dir is fsynced and atomically renamed into
place, and the root is fsynced — a kill at any point leaves either no
entry or a complete verified one. Two replicas persisting the same key
race benignly: rename onto an existing entry fails, the loser discards
its temp and counts ``put_races_total``.

Read discipline: trust nothing. Format and fingerprint are checked,
every file is re-hashed against the manifest, and ANY failure —
corrupt blob, truncated manifest, stale fingerprint, undeserializable
payload — quarantines the entry under ``<root>/quarantine/`` (evidence,
never silently deleted) and reports a miss, so a bad artifact degrades
to a normal step build, never an error.

Lifecycle: the store is size-capped (``PADDLE_TPU_ARTIFACT_CAP_MB``,
default 1024) with LRU eviction — a hit touches the entry's mtime, GC
after each put removes oldest-first past the cap. ``stats()`` exposes
hit/miss/stale/corrupt/put/race/evict counters; the serving engine
surfaces them under ``stats()["artifact_store"]``.
"""
import hashlib
import json
import os
import shutil
import time
import uuid
import warnings

import numpy as np

__all__ = ["ArtifactStore", "resolve_store", "artifact_key",
           "canonical_program_repr", "arg_signature",
           "library_fingerprint", "dir_manifest", "EMBEDDED_DIRNAME",
           "FORMAT"]

FORMAT = "paddle_tpu_torch-artifact-v1"
STORE_SCHEMA = 1
MANIFEST = "MANIFEST.json"
PROGRAM_FILE = "step.pt2"
# artifact store embedded in a save_inference_model directory — "a new
# replica host needs only the saved-model dir"
EMBEDDED_DIRNAME = "__artifacts__"
_ENTRY_PREFIX = "art_"
_TMP_PREFIX = ".tmp_art_"
_QUARANTINE = "quarantine"
TMP_GRACE_SECONDS = 300      # age before a foreign temp dir is GC-able

_DEFAULT_CAP_MB = 1024.0

_COUNTERS = ("hits_total", "misses_total", "stale_total",
             "corrupt_total", "puts_total", "put_races_total",
             "put_errors_total", "evictions_total", "bypass_total")

_KERNEL_HASH = None


def _kernel_sources_hash():
    """The hash ``cuda_build.library_path`` keys every kernel library by
    (all of them), read once."""
    global _KERNEL_HASH
    if _KERNEL_HASH is None:
        from ..ops import cuda_build
        _KERNEL_HASH = sorted(cuda_build.library_path(n).name
                              for n in cuda_build.SOURCES)
    return _KERNEL_HASH


def library_fingerprint(device="cpu"):
    """Everything outside the program that can invalidate an exported
    step: the torch and CUDA versions, the device (its name and compute
    capability on CUDA), the kernel sources' hash, and this store's
    schema version. Hashed into every key AND written to every
    manifest — the manifest copy guards entries that reached the store
    by hand (copied dirs, schema evolution)."""
    import torch
    device = str(device)
    fp = {"torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": device,
          "kernels": _kernel_sources_hash(),
          "store_schema": STORE_SCHEMA}
    dev = torch.device(device)
    if dev.type == "cuda":
        fp["device_name"] = torch.cuda.get_device_name(dev)
        fp["capability"] = list(torch.cuda.get_device_capability(dev))
    return fp


# ---------------------------------------------------------------------------
# key derivation
# ---------------------------------------------------------------------------


def _enc_attr(v):
    """Deterministic, content-only encoding of one op attribute.
    Sub-block references encode by block index (the block itself is
    walked in program order); ndarray payloads (assign_value folds) by
    dtype/shape/byte digest."""
    # a Block attr: duck-typed to avoid importing framework here
    if hasattr(v, "ops") and hasattr(v, "idx"):
        return ["block", int(v.idx)]
    if isinstance(v, np.ndarray):
        return ["nd", str(v.dtype), list(v.shape),
                hashlib.sha256(np.ascontiguousarray(v).tobytes())
                .hexdigest()]
    if isinstance(v, (list, tuple)):
        return ["seq", [_enc_attr(x) for x in v]]
    if isinstance(v, dict):
        return ["map", [[str(k), _enc_attr(v[k])] for k in sorted(v)]]
    if isinstance(v, bool):
        return ["b", v]
    if isinstance(v, int):
        return ["i", v]
    if isinstance(v, float):
        return ["f", repr(v)]
    if v is None:
        return ["none"]
    return [type(v).__name__, str(v)]


def canonical_program_repr(program, fetch_names=()):
    """Stable serialization of a Program's CONTENT: op sequence, wiring,
    attributes, and variable metadata, with interior variable names
    alpha-renamed to appearance order. Two processes that built the
    same computation — whatever their ``unique_name`` counters said —
    produce identical bytes; externally visible names (persistables,
    data vars, fetch targets) keep their identity because they are the
    lowered function's dict keys."""
    fetch_names = set(fetch_names)
    external = set(fetch_names)
    for b in program.blocks:
        for n, v in b.vars.items():
            if getattr(v, "persistable", False) or \
                    getattr(v, "is_data", False):
                external.add(n)
    rename = {}

    def canon(name):
        if name in external:
            return name
        got = rename.get(name)
        if got is None:
            got = f"%{len(rename)}"
            rename[name] = got
        return got

    blocks = []
    for b in program.blocks:
        ops = []
        for op in b.ops:
            ops.append({
                "type": op.type,
                "in": [[slot, [canon(n) for n in op.inputs[slot]]]
                       for slot in sorted(op.inputs)],
                "out": [[slot, [canon(n) for n in op.outputs[slot]]]
                        for slot in sorted(op.outputs)],
                "attrs": [[k, _enc_attr(op.attrs[k])]
                          for k in sorted(op.attrs)],
            })
        vars_ = []
        for name in sorted(b.vars):
            v = b.vars[name]
            vars_.append({
                "name": canon(name),
                "shape": [int(s) if s is not None else -1
                          for s in (v.shape or ())],
                "dtype": str(v.dtype),
                "lod_level": int(getattr(v, "lod_level", 0) or 0),
                "persistable": bool(getattr(v, "persistable", False)),
                "is_data": bool(getattr(v, "is_data", False)),
                "stop_gradient": bool(getattr(v, "stop_gradient",
                                              False)),
            })
        # canonical names sort differently than source names; re-sort so
        # the record order itself is name-independent
        vars_.sort(key=lambda d: d["name"])
        blocks.append({"idx": b.idx, "parent": b.parent_idx,
                       "ops": ops, "vars": vars_})
    doc = {"blocks": blocks,
           "fetch": sorted(fetch_names),
           "remat": program._remat_policy,
           "nan_guard": bool(getattr(program, "_nan_guard", False)),
           "amp": bool(getattr(program, "_amp", False))}
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def arg_signature(state, feed):
    """The state and feed names and each value's shape/dtype — the
    bucket shape signature. The structure string carries the names
    (external names), so signatures from different feed contracts never
    collide."""
    names = {"state": sorted(state), "feed": sorted(feed)}
    leaves = tuple(
        (tuple(int(d) for d in d_.shape), str(d_.dtype).replace("torch.",
                                                                ""))
        for d_ in [state[n] for n in names["state"]]
        + [feed[n] for n in names["feed"]])
    return json.dumps(names, sort_keys=True), leaves


def artifact_key(program_repr, mode, fetch_names, repeats, donate,
                 args_sig, fingerprint):
    """sha256 over every compile-relevant input. ``program_repr`` is
    the canonical serialization (callers cache it per program
    version); ``args_sig`` is :func:`arg_signature`'s result."""
    h = hashlib.sha256()
    h.update(program_repr.encode())
    h.update(json.dumps(
        {"mode": mode, "fetch": list(fetch_names),
         "repeats": int(repeats), "donate": bool(donate),
         "tree": args_sig[0], "leaves": [list(map(str, t))
                                         for t in args_sig[1]],
         "fingerprint": fingerprint},
        sort_keys=True).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path, payload):
    with open(path, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    return hashlib.sha256(payload).hexdigest()


class _LoadedArtifact:
    """A ready-to-dispatch step from the store: the graph module of the
    exported step, called as ``art(params, feeds)`` with both lists in
    the entry's name order (``param_names``, ``feed_names``). ``source``
    is ``"exported"`` for a verified disk load (zero step builds) or
    ``"fresh"`` for the step this process just exported."""

    __slots__ = ("call", "source", "key", "param_names", "feed_names")

    def __init__(self, call, source, key, param_names, feed_names):
        self.call = call
        self.source = source
        self.key = key
        self.param_names = list(param_names)
        self.feed_names = list(feed_names)

    def __call__(self, params, feeds):
        return self.call(params, feeds)


class ArtifactStore:
    """Content-addressed persistent store of exported steps.

    ``root`` is created lazily on first put; a missing root reads as
    all-miss. ``cap_bytes`` bounds total entry bytes (LRU eviction;
    None reads ``PADDLE_TPU_ARTIFACT_CAP_MB``, default 1024; 0
    disables GC)."""

    def __init__(self, root, cap_bytes=None):
        self.root = str(root)
        if cap_bytes is None:
            cap_mb = float(os.environ.get("PADDLE_TPU_ARTIFACT_CAP_MB",
                                          _DEFAULT_CAP_MB))
            cap_bytes = int(cap_mb * 2**20)
        self.cap_bytes = int(cap_bytes)
        import threading
        self._lock = threading.Lock()
        self._counters = {c: 0 for c in _COUNTERS}
        self._inflight = set()

    # -- accounting ------------------------------------------------------
    def _incr(self, name, n=1):
        with self._lock:
            self._counters[name] += n

    def stats(self):
        """Counter snapshot + size/entry totals (json-serializable)."""
        with self._lock:
            snap = dict(self._counters)
        snap["root"] = self.root
        snap["cap_bytes"] = self.cap_bytes
        try:
            entries = self.entries()
            snap["entries"] = len(entries)
            snap["total_bytes"] = sum(e["bytes"] for e in entries)
        except OSError:
            snap["entries"] = 0
            snap["total_bytes"] = 0
        return snap

    # -- layout ----------------------------------------------------------
    def _entry_dir(self, key):
        return os.path.join(self.root, _ENTRY_PREFIX + key)

    def entries(self):
        """[{key, path, bytes, mtime}] for every finalized entry."""
        try:
            names = os.listdir(self.root)
        except (FileNotFoundError, NotADirectoryError):
            return []
        out = []
        for name in names:
            if not name.startswith(_ENTRY_PREFIX):
                continue
            path = os.path.join(self.root, name)
            if not os.path.exists(os.path.join(path, MANIFEST)):
                continue
            total = 0
            try:
                for f in os.listdir(path):
                    total += os.path.getsize(os.path.join(path, f))
                mtime = os.path.getmtime(path)
            except OSError:
                continue        # racing an eviction/quarantine — skip
            out.append({"key": name[len(_ENTRY_PREFIX):], "path": path,
                        "bytes": total, "mtime": mtime})
        return out

    def total_bytes(self):
        return sum(e["bytes"] for e in self.entries())

    def _quarantine(self, key, reason):
        """Move a damaged entry aside — evidence for postmortems, and
        it stops re-verifying (and re-failing) on every lookup."""
        src = self._entry_dir(key)
        qdir = os.path.join(self.root, _QUARANTINE)
        dst = os.path.join(qdir, _ENTRY_PREFIX + key)
        try:
            os.makedirs(qdir, exist_ok=True)
            if os.path.exists(dst):
                dst = f"{dst}.{uuid.uuid4().hex[:8]}"
            os.rename(src, dst)
        except OSError:
            return      # racing another loader — one move is enough
        warnings.warn(
            f"artifact store: quarantined entry {key[:12]}… ({reason}) "
            f"-> {dst}; the program will compile normally",
            stacklevel=3)

    # -- read ------------------------------------------------------------
    def load(self, key):
        """Verified load of one entry. Returns a :class:`_LoadedArtifact`
        or None (miss). Every failure mode — absent entry, truncated or
        unparsable manifest, fingerprint mismatch, checksum mismatch,
        undeserializable payload — counts, quarantines when there is an
        entry to quarantine, and reports a miss: the caller compiles."""
        path = self._entry_dir(key)
        mpath = os.path.join(path, MANIFEST)
        if not os.path.exists(mpath):
            self._incr("misses_total")
            return None
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            self._incr("corrupt_total")
            self._incr("misses_total")
            self._quarantine(key, "unreadable manifest")
            return None
        if manifest.get("format") != FORMAT:
            self._incr("stale_total")
            self._incr("misses_total")
            self._quarantine(
                key, f"format {manifest.get('format')!r} != {FORMAT!r}")
            return None
        fp = manifest.get("fingerprint") or {}
        want = library_fingerprint(fp.get("device", "cpu"))
        if fp != want:
            # belt-and-braces: the fingerprint is hashed into the key,
            # so this only fires for hand-copied entries or schema
            # evolution — exactly the "a torch upgrade must invalidate
            # cleanly, never deserialize garbage" contract
            self._incr("stale_total")
            self._incr("misses_total")
            self._quarantine(key, f"library fingerprint {fp} != {want}")
            return None
        files = manifest.get("files") or {}
        payloads = {}
        for fname, spec in files.items():
            fpath = os.path.join(path, fname)
            try:
                with open(fpath, "rb") as f:
                    blob = f.read()
            except OSError:
                self._incr("corrupt_total")
                self._incr("misses_total")
                self._quarantine(key, f"{fname} missing")
                return None
            if hashlib.sha256(blob).hexdigest() != spec.get("sha256"):
                self._incr("corrupt_total")
                self._incr("misses_total")
                self._quarantine(
                    key, f"{fname} sha256 mismatch — torn or corrupted "
                    "write")
                return None
            payloads[fname] = blob
        art = self._decode(key, payloads, manifest.get("meta") or {})
        if art is None:
            self._incr("corrupt_total")
            self._incr("misses_total")
            self._quarantine(key, "payload would not deserialize")
            return None
        self._incr("hits_total")
        try:
            os.utime(path)          # LRU touch: a hit is recent use
        except OSError:
            pass
        return art

    def _decode(self, key, payloads, meta):
        """The exported step's graph module; None when it will not
        deserialize."""
        blob = payloads.get(PROGRAM_FILE)
        if blob is None:
            return None
        try:
            from ..ops import flash_attention  # noqa: F401  (K1's op)
            from .aot import load_exported
            return _LoadedArtifact(load_exported(blob), "exported", key,
                                   meta["param_names"],
                                   meta["feed_names"])
        except Exception:                   # noqa: BLE001
            return None

    # -- write -----------------------------------------------------------
    def save(self, key, blob, fingerprint, meta=None):
        """Persist one exported step (``blob``: ``torch.export.save``
        bytes) under ``key`` with the MANIFEST, via the atomic temp →
        fsync → rename protocol; ``meta`` must name the step's
        ``param_names`` and ``feed_names``. Returns True when an entry
        for ``key`` exists afterwards (including losing a benign race
        to a concurrent writer)."""
        final = self._entry_dir(key)
        if os.path.exists(os.path.join(final, MANIFEST)):
            return True                     # a peer already persisted it
        tmp = os.path.join(
            self.root,
            f"{_TMP_PREFIX}{key[:12]}.{os.getpid()}."
            f"{uuid.uuid4().hex[:8]}")
        try:
            os.makedirs(tmp, exist_ok=True)
        except OSError as e:
            self._incr("put_errors_total")
            warnings.warn(f"artifact store: cannot write to "
                          f"{self.root} ({e}); entry not persisted",
                          stacklevel=3)
            return False
        self._inflight.add(tmp)
        try:
            files = {PROGRAM_FILE: {
                "sha256": _write_file(os.path.join(tmp, PROGRAM_FILE),
                                      blob),
                "bytes": len(blob)}}
            manifest = {"format": FORMAT, "key": key,
                        "fingerprint": fingerprint, "files": files,
                        "meta": dict(meta or {}),
                        "created": time.time()}
            _write_file(os.path.join(tmp, MANIFEST),
                        json.dumps(manifest, indent=1).encode())
            _fsync_dir(tmp)
            try:
                os.rename(tmp, final)
            except OSError:
                # two replicas persisted the same key: first rename
                # wins, this one discards its temp — the entry exists
                # either way
                shutil.rmtree(tmp, ignore_errors=True)
                self._incr("put_races_total")
                return os.path.exists(os.path.join(final, MANIFEST))
            _fsync_dir(self.root)
        except Exception as e:              # noqa: BLE001 — best effort
            shutil.rmtree(tmp, ignore_errors=True)
            self._incr("put_errors_total")
            warnings.warn(
                f"artifact store: failed to persist entry "
                f"({type(e).__name__}: {e}); the step stays "
                "process-local", stacklevel=3)
            return False
        finally:
            self._inflight.discard(tmp)
        self._incr("puts_total")
        if self.cap_bytes:
            self.gc(protect=key)
        return True

    # -- lifecycle -------------------------------------------------------
    def gc(self, protect=None):
        """Evict oldest entries (by mtime — hits touch it, so this is
        LRU) until total bytes fit the cap; collect stale temp dirs
        past the grace window. Returns the evicted keys."""
        evicted = []
        if self.cap_bytes:
            entries = sorted(self.entries(), key=lambda e: e["mtime"])
            total = sum(e["bytes"] for e in entries)
            for e in entries:
                if total <= self.cap_bytes:
                    break
                if protect is not None and e["key"] == protect:
                    continue
                shutil.rmtree(e["path"], ignore_errors=True)
                total -= e["bytes"]
                evicted.append(e["key"])
            if evicted:
                self._incr("evictions_total", len(evicted))
        now = time.time()
        try:
            names = os.listdir(self.root)
        except (FileNotFoundError, NotADirectoryError):
            return evicted
        for name in names:
            if not name.startswith(_TMP_PREFIX):
                continue
            full = os.path.join(self.root, name)
            if full in self._inflight:
                continue
            try:
                age = now - os.path.getmtime(full)
            except OSError:
                continue
            if age >= TMP_GRACE_SECONDS:
                shutil.rmtree(full, ignore_errors=True)
        return evicted

    def clear(self):
        """Remove every entry (not the quarantine — that is evidence)."""
        for e in self.entries():
            shutil.rmtree(e["path"], ignore_errors=True)

    def __repr__(self):
        return (f"ArtifactStore({self.root!r}, "
                f"cap={self.cap_bytes / 2**20:.0f} MiB)")


def dir_manifest(root):
    """Integrity manifest of a directory tree for wire transfer:
    ``{relpath: {"sha256": hex, "bytes": n}}`` over every regular file
    under ``root``. Quarantined evidence and in-flight temp dirs are
    skipped — a provisioned host should start from the clean artifact
    set, not somebody's postmortem. This is the catalog the cluster
    fabric's ``fetch_manifest`` verb serves and
    ``provision_from_remote`` verifies against, blob by blob."""
    root = os.path.abspath(root)
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d != _QUARANTINE and not d.startswith(_TMP_PREFIX))
        for fname in sorted(filenames):
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, root)
            try:
                with open(full, "rb") as f:
                    blob = f.read()
            except OSError:
                continue        # racing an eviction — skip, like entries()
            out[rel] = {"sha256": hashlib.sha256(blob).hexdigest(),
                        "bytes": len(blob)}
    return out


def resolve_store(spec):
    """Normalize an Executor's ``compile_store`` argument: an
    :class:`ArtifactStore` passes through, a path string becomes a
    store, ``None`` defers to ``PADDLE_TPU_ARTIFACT_DIR`` (unset →
    no store), ``False`` disables even when the env var is set.
    ``True`` is refused here: it names a saved model's embedded store,
    which only ``ServingEngine.from_saved_model`` and ``Inferencer.serve``
    can find."""
    if spec is False:
        return None
    if spec is True:
        raise ValueError(
            "compile_store=True names a saved model's embedded artifact "
            "store: pass it to ServingEngine.from_saved_model or "
            "Inferencer.serve, or give a directory here")
    if spec is None:
        spec = os.environ.get("PADDLE_TPU_ARTIFACT_DIR") or None
        if spec is None:
            return None
    if isinstance(spec, ArtifactStore):
        return spec
    return ArtifactStore(str(spec))
