"""Crash-safe checkpoint store: atomic writes, checksums, quarantine.

Port of ``paddle_tpu/resilience/checkpoint.py``: the same protocol, the
same MANIFEST and the same file bytes, so a checkpoint directory written
by either package loads in the other. Values may be torch tensors or
numpy arrays; a tensor leaves through ``weights.tensor_to_array`` and a
bfloat16 one is written as the 2-byte void ``.npy`` that numpy writes
for an ml_dtypes bfloat16 array (``weights.write_npy``). Loading hands
back numpy arrays (bfloat16 as those void arrays, as ``np.load`` reads
them), or tensors on a ``device`` with bfloat16 read by the manifest's
``dtype``.

A SIGKILL (preemption) in the
middle of a checkpoint save must never cost more than the one save in
flight. The previous writer appended arrays file-by-file into the live
directory, so a kill mid-write left a directory that LOOKED like a
checkpoint but silently dropped or truncated arrays. This store makes
a checkpoint either fully present and verified, or not present at all.

Write protocol (``save_state``) — the classic temp → fsync → rename
dance, per array checksummed::

    1. arrays are serialized (.npy) into <dir>/.tmp_ckpt_<serial>.<pid>.<nonce>
       — the dot prefix keeps listers blind to in-flight saves
    2. each file is fsynced as written; its sha256 is computed from the
       exact bytes that hit the disk
    3. MANIFEST.json (schema below) is written LAST and fsynced — its
       presence marks the temp complete
    4. the temp dir is fsynced, atomically renamed to <dir>/ckpt_<serial>,
       and the parent dir is fsynced so the rename itself is durable

A reader therefore observes either no ``ckpt_<serial>`` or a complete
one; a kill at ANY point leaves at worst a stale ``.tmp_*`` dir that a
later :func:`prune` garbage-collects.

MANIFEST.json (``format: paddle_tpu-ckpt-v1``)::

    {
      "format": "paddle_tpu-ckpt-v1",
      "serial": 7,
      "arrays": {
        "fc_0.w_0": {"file": "fc_0.w_0.npy", "sha256": "<hex>",
                      "shape": [784, 10], "dtype": "float32",
                      "bytes": 31488},
        ...
      },
      "meta": {...}     # caller payload: trainer epoch/step, etc.
    }

Read protocol (``load_latest_valid``) — trust nothing: every array file
is re-hashed against the manifest before deserialization. A damaged
serial (missing manifest, truncated file, checksum mismatch) is moved
to ``<dir>/quarantine/`` — never deleted, it is evidence — and the scan
falls back to the next-newest serial.

Pruning (``prune``) keeps ``max_num_checkpoints`` finalized serials
without racing an in-flight save: the serial just written is passed as
``protect``, temps registered by THIS process's active saves are
skipped outright, and foreign temps are only collected after
``TMP_GRACE_SECONDS`` (another process may still be writing them).

Multi-writer discipline (a shared checkpoint dir on a fleet): pruning
is **leader-only** — ``save_state(..., leader=False)`` never deletes
anything, so N follower hosts checkpointing into one directory cannot
race each other's retention windows; exactly one process (the training
coordinator, or trainer_id 0) prunes. The retention window itself is a
knob: an explicit ``max_num_checkpoints`` wins, otherwise
``PADDLE_TPU_CKPT_KEEP`` (0/unset = keep everything).

:func:`state_sha` is the fleet's determinism probe: a canonical sha256
over a state dict (sorted names, dtype, shape, raw bytes) that leader
and followers compare at every commit barrier — bit-identical params
or a typed mismatch, never silent divergence.
"""
import hashlib
import io as _io
import json
import os
import shutil
import time
import uuid
import warnings

import numpy as np

from . import faultinject
from .. import weights

__all__ = ["CheckpointError", "ChecksumMismatch", "save_state",
           "load_state", "load_latest_valid", "list_serials", "verify",
           "quarantine", "prune", "retention_keep", "state_sha",
           "MANIFEST", "FORMAT"]

MANIFEST = "MANIFEST.json"
FORMAT = "paddle_tpu-ckpt-v1"
TMP_GRACE_SECONDS = 300     # age before a foreign temp dir is GC-able
_TMP_PREFIX = ".tmp_ckpt_"
_QUARANTINE = "quarantine"

# temp dirs being written by in-flight saves in THIS process; prune()
# must never collect them no matter how the grace clock reads
_inflight = set()


class CheckpointError(RuntimeError):
    """A checkpoint directory is structurally unusable (missing or
    unparsable manifest, wrong format version)."""


class ChecksumMismatch(CheckpointError):
    """An array file is missing, truncated, or fails its sha256 — the
    signature of a torn write or bit rot."""


def _escape(name):
    return name.replace("/", "%2F")


def _unescape(name):
    return name.replace("%2F", "/")


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _serial_of(entry):
    """ckpt_<n> -> n, else None (rejects ckpt_ without digits)."""
    if not entry.startswith("ckpt_"):
        return None
    tail = entry[len("ckpt_"):]
    return int(tail) if tail.isdigit() else None


def retention_keep(max_num_checkpoints=None):
    """Resolve the retention window: an explicit value wins, else the
    ``PADDLE_TPU_CKPT_KEEP`` env knob, else None (keep everything).
    0 or a negative value also means keep everything."""
    if max_num_checkpoints is not None:
        return max_num_checkpoints if int(max_num_checkpoints) > 0 \
            else None
    raw = os.environ.get("PADDLE_TPU_CKPT_KEEP", "").strip()
    if not raw:
        return None
    keep = int(raw)
    return keep if keep > 0 else None


def state_sha(state):
    """Canonical sha256 of a state dict (name → array): sorted names,
    dtype, shape, raw bytes. The commit-barrier determinism probe —
    leader and followers must agree on this hex or the fleet has
    diverged bitwise."""
    h = hashlib.sha256()
    for name in sorted(state):
        arr = np.ascontiguousarray(weights.to_host(state[name]))
        h.update(name.encode("utf-8"))
        h.update(weights.dtype_name(state[name]).encode("ascii"))
        h.update(repr(tuple(arr.shape)).encode("ascii"))
        h.update(arr.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def save_state(checkpoint_dir, state, serial, meta=None,
               max_num_checkpoints=None, leader=True):
    """Atomically persist ``state`` (name → array) as
    ``<checkpoint_dir>/ckpt_<serial>``. Returns the final path.

    ``leader=False`` marks this writer a follower in a shared
    checkpoint dir: the save is identical but pruning is SKIPPED
    regardless of the retention window — only the leader deletes, so
    concurrent writers can never collect each other's work. The window
    itself resolves through :func:`retention_keep` (explicit value →
    ``PADDLE_TPU_CKPT_KEEP`` env → keep everything).

    Honors the ``torn_write`` fault point: when armed, half the arrays
    (the last one truncated) hit the temp dir and SimulatedCrash is
    raised before any manifest or rename — exactly what SIGKILL
    mid-save leaves behind."""
    serial = int(serial)
    os.makedirs(checkpoint_dir, exist_ok=True)
    final = os.path.join(checkpoint_dir, f"ckpt_{serial}")
    tmp = os.path.join(
        checkpoint_dir,
        f"{_TMP_PREFIX}{serial}.{os.getpid()}.{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    _inflight.add(tmp)
    try:
        torn = faultinject.fires("torn_write")
        items = sorted(state.items())
        arrays = {}
        for i, (name, value) in enumerate(items):
            arr = weights.to_host(value)
            buf = _io.BytesIO()
            weights.write_npy(buf, arr, weights.dtype_name(value))
            payload = buf.getvalue()
            fname = _escape(name) + ".npy"
            fpath = os.path.join(tmp, fname)
            if torn and i == max(0, len(items) // 2):
                # simulated kill mid-write: a truncated file, no
                # manifest, no rename — the temp dir stays on disk as
                # the crash would leave it
                with open(fpath, "wb") as f:
                    f.write(payload[:max(1, len(payload) // 2)])
                raise faultinject.SimulatedCrash(
                    f"injected torn write at {fpath}")
            with open(fpath, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            arrays[name] = {"file": fname,
                            "sha256": hashlib.sha256(payload).hexdigest(),
                            "shape": list(arr.shape),
                            "dtype": weights.dtype_name(value),
                            "bytes": len(payload)}
        manifest = {"format": FORMAT, "serial": serial,
                    "arrays": arrays, "meta": dict(meta or {})}
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.isdir(final):
            # re-save of an existing serial (rollback then re-checkpoint
            # at the same step): replace it, old dir first — rename onto
            # a non-empty dir is not atomic-replace on POSIX
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(checkpoint_dir)
    finally:
        # on success the temp no longer exists; on a (simulated) crash
        # the partial dir is deliberately LEFT on disk — that is the
        # state recovery must cope with — but it stops being "in flight"
        _inflight.discard(tmp)
    keep = retention_keep(max_num_checkpoints)
    if leader and keep:
        prune(checkpoint_dir, keep, protect=final)
    return final


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def list_serials(checkpoint_dir):
    """Serials of finalized (manifest-bearing) checkpoints, ascending.
    A missing, empty, or partially-created directory (fresh run after a
    crash during the very first save) is simply "no checkpoints"."""
    try:
        entries = os.listdir(checkpoint_dir)
    except (FileNotFoundError, NotADirectoryError):
        return []
    out = []
    for entry in entries:
        serial = _serial_of(entry)
        if serial is None:
            continue
        if os.path.exists(os.path.join(checkpoint_dir, entry, MANIFEST)):
            out.append(serial)
    return sorted(out)


def _read_manifest(path):
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise CheckpointError(
            f"no {MANIFEST} in {path} — incomplete checkpoint (killed "
            "before finalize?)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(f"unreadable {MANIFEST} in {path}: {e}")
    if manifest.get("format") != FORMAT:
        raise CheckpointError(
            f"{path} has format {manifest.get('format')!r}, expected "
            f"{FORMAT!r}")
    return manifest


def verify(path):
    """Re-hash every array file against the manifest. Returns the
    manifest on success; raises CheckpointError / ChecksumMismatch."""
    manifest = _read_manifest(path)
    for name, spec in manifest["arrays"].items():
        fpath = os.path.join(path, spec["file"])
        if not os.path.exists(fpath):
            raise ChecksumMismatch(
                f"checkpoint {path}: array {name!r} file missing")
        with open(fpath, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != spec["sha256"]:
            raise ChecksumMismatch(
                f"checkpoint {path}: array {name!r} ({spec['file']}) "
                "sha256 mismatch — torn or corrupted write")
    return manifest


def load_state(path, device=None):
    """Verify-then-deserialize in one read per file. Returns
    ``(state, manifest)`` with state name → np.ndarray, or → tensor on
    ``device`` when one is given (bfloat16 by the manifest's dtype)."""
    manifest = _read_manifest(path)
    state = {}
    for name, spec in manifest["arrays"].items():
        fpath = os.path.join(path, spec["file"])
        try:
            with open(fpath, "rb") as f:
                payload = f.read()
        except OSError:
            raise ChecksumMismatch(
                f"checkpoint {path}: array {name!r} file missing")
        if hashlib.sha256(payload).hexdigest() != spec["sha256"]:
            raise ChecksumMismatch(
                f"checkpoint {path}: array {name!r} ({spec['file']}) "
                "sha256 mismatch — torn or corrupted write")
        arr = np.load(_io.BytesIO(payload), allow_pickle=False)
        state[name] = arr if device is None else \
            weights.array_to_tensor(arr, device, dtype=spec.get("dtype"))
    return state, manifest


def quarantine(checkpoint_dir, serial):
    """Move a damaged ``ckpt_<serial>`` into ``<dir>/quarantine/`` —
    corrupt state is evidence for postmortems, never silently deleted.
    Returns the quarantined path."""
    src = os.path.join(checkpoint_dir, f"ckpt_{serial}")
    qdir = os.path.join(checkpoint_dir, _QUARANTINE)
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, f"ckpt_{serial}")
    if os.path.exists(dst):
        dst = f"{dst}.{uuid.uuid4().hex[:8]}"
    os.rename(src, dst)
    return dst


def load_latest_valid(checkpoint_dir, serial=None,
                      quarantine_corrupt=True, device=None):
    """Load the newest checksum-valid checkpoint.

    Scans serials newest-first; a damaged one is quarantined (unless
    ``quarantine_corrupt=False``) with a warning and the scan falls
    back to the next older serial. Returns ``(state, manifest, serial,
    path)``. Raises FileNotFoundError when nothing valid exists —
    including the empty/missing-dir case. Pinning ``serial`` skips the
    fallback: damage there raises. ``device`` as in :func:`load_state`."""
    if serial is not None:
        path = os.path.join(checkpoint_dir, f"ckpt_{int(serial)}")
        state, manifest = load_state(path, device)
        return state, manifest, int(serial), path
    for s in reversed(list_serials(checkpoint_dir)):
        path = os.path.join(checkpoint_dir, f"ckpt_{s}")
        try:
            state, manifest = load_state(path, device)
        except CheckpointError as e:
            warnings.warn(
                f"skipping damaged checkpoint serial {s}: {e}",
                stacklevel=2)
            if quarantine_corrupt:
                try:
                    quarantine(checkpoint_dir, s)
                except OSError:
                    pass    # racing another recoverer — skip is enough
            continue
        return state, manifest, s, path
    raise FileNotFoundError(
        f"no valid checkpoints in {checkpoint_dir}")


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------


def prune(checkpoint_dir, keep, protect=None):
    """Keep the newest ``keep`` finalized checkpoints; GC stale temps.

    Never touches: ``protect`` (the serial a save just finalized — it
    must survive even if concurrent saves pushed it past the window),
    temps registered by this process's in-flight saves, or foreign
    temps younger than TMP_GRACE_SECONDS."""
    try:
        entries = os.listdir(checkpoint_dir)
    except (FileNotFoundError, NotADirectoryError):
        return
    serials = list_serials(checkpoint_dir)
    if keep and keep > 0:
        for s in serials[:-keep]:
            path = os.path.join(checkpoint_dir, f"ckpt_{s}")
            if protect and os.path.abspath(path) == os.path.abspath(protect):
                continue
            shutil.rmtree(path, ignore_errors=True)
    now = time.time()
    for entry in entries:
        if not entry.startswith(_TMP_PREFIX):
            continue
        full = os.path.join(checkpoint_dir, entry)
        if full in _inflight:
            continue
        try:
            age = now - os.path.getmtime(full)
        except OSError:
            continue        # vanished under us — fine
        if age >= TMP_GRACE_SECONDS:
            shutil.rmtree(full, ignore_errors=True)
