"""Executor, Scope, Place.

Port of ``paddle_tpu/core/executor.py``. ``Executor.run`` lowers a
Program into a step function once per (program uid, version, mode,
fetch set) and runs it eagerly on torch tensors on the place's device.

Places are real devices: ``CUDAPlace(i)`` is ``cuda:i`` and
``CPUPlace()`` the host. ``TPUPlace`` is an alias of ``CUDAPlace`` so
reference scripts keep running on the card — the reverse of the
reference, where CUDAPlace aliased the TPU. An Executor built without a
place runs on ``CUDAPlace(0)`` and raises where CUDA is absent: the CPU
is only used when the caller asks for it (a place, or ``force_cpu()``
for the whole process).

Fetches returned as numpy (``return_numpy=True``) come back in their
dtype, except bfloat16, which numpy cannot hold without ml_dtypes: those
come back as float32 (exact — every bfloat16 is a float32).

A program with a ``backward`` marker is one train step (lowering.py);
``run(..., repeats=k)`` takes k such steps on the same feed, as the
reference does in one dispatch. A train step donates its state, as the
reference's Executor does by default: each optimizer update ends in the
scope's own tensor, so the old and the new state are never both held
(a tensor placed in two scopes is updated in both). With the NaN guard on
(``debugger.enable_nan_guard``) a run reads the step's finite flags back
once, after writing the scope, and raises ``FloatingPointError`` naming
the first non-finite op outputs.

Before a program version first runs, ``run`` verifies it statically
(``validate=`` / ``PADDLE_TPU_VALIDATE``, default ``"1"``: the cheap
structural passes, an error finding becomes a ``VerifyWarning``;
``"strict"``: every pass, and an error raises ``VerifyError`` before
anything is lowered; ``"0"``: off), once per (program, version, fetch
set, mode). With ``PADDLE_TPU_OPTIMIZE`` on (``"1"``, or a list of
passes such as ``"fold,dce"``) it runs an optimized clone of the program
(analysis/optimize.py) in its place, folding constants on the
executor's own device.

In-graph readers (layers.py_reader / open_files / ...): any started
reader of the program supplies its variables unless they are fed
explicitly (explicit feed keys win); an exhausted one raises
:class:`EOFException`, which ends an epoch. Feeds that are already
tensors on the executor's device (``io.DeviceLoader``) are used as
they are, with no host round trip.

A persistent artifact store (``compile_store=`` / the
``PADDLE_TPU_ARTIFACT_DIR`` env var, io/artifact_store.py): before a
test-mode step of a new argument signature is built, the store is asked
for the exported step under the content key of (canonical program,
mode, fetches, signature, library fingerprint); a hit runs the loaded
graph and builds nothing (``compile_counts`` does not grow), a miss
builds the step as always and persists its export for the next process.
The exported step returns the persistables it writes with its fetches,
and they go to the scope as the eager step's do. ``store_stats()`` reads
the counters. Train steps, guarded steps, steps that draw random
numbers and steps fed sequences bypass the store.

Sequence feeds (variables with ``lod_level > 0``) are SequenceBatch
values (``to_sequence_batch``, ``DataFeeder``, ``create_lod_tensor``, or
any value with ``.data`` and ``.lengths``); a fetched sequence comes back
as a SequenceBatch, with numpy leaves under ``return_numpy=True``.

While a ``profiler`` session is open, each run records one
``dispatch step N`` slice (N its first step) in the session's host
timeline.
"""
import contextlib
import os
import time
import warnings

import numpy as np
import torch

from . import framework
from .lowering import GUARD, lower_program, written_names
from .sequence import SequenceBatch
from ..resilience import faultinject as _faultinject
from ..resilience.retry import (TransientDeviceError, default_policy,
                                with_retries)

__all__ = ["Scope", "global_scope", "scope_guard", "Executor",
           "CPUPlace", "TPUPlace", "CUDAPlace", "EOFException",
           "force_cpu", "default_place", "compiled_cost_stats",
           "global_value"]


class EOFException(Exception):
    """A started in-graph reader ran out of data (parity with
    fluid.core.EOFException — reference catches it to end an epoch)."""


class Scope:
    """Flat name → tensor store for persistable state (parameters,
    optimizer accumulators, batch-norm statistics). Reference
    paddle/fluid/framework/scope.h."""

    def __init__(self):
        self.vars = {}

    def find_var(self, name):
        return self.vars.get(name)

    def var(self, name):
        return self.vars.setdefault(name, None)

    def set(self, name, value):
        self.vars[name] = value

    def has(self, name):
        return name in self.vars

    def keys(self):
        return self.vars.keys()

    def drop_kids(self):  # fluid-compat no-op
        pass


_global_scope = Scope()


def global_scope():
    return _global_scope


def _switch_scope(scope):
    """Swap the global scope, returning the previous one (reference
    executor.py _switch_scope)."""
    global _global_scope
    old = _global_scope
    _global_scope = scope
    return old


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


class Place:
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    @property
    def device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    """One NVIDIA card. Resolving its device raises where CUDA is
    absent — no silent fallback to the host."""

    @property
    def device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: CUDA is not available on this machine; pass "
                "CPUPlace() to run on the host")
        n = torch.cuda.device_count()
        if not 0 <= self.device_id < n:
            raise RuntimeError(f"{self!r}: this machine has {n} CUDA "
                               "device(s)")
        return torch.device("cuda", self.device_id)


# reference scripts say TPUPlace(); in the port the accelerator is the card
TPUPlace = CUDAPlace

# set by force_cpu(): the process's entry points then default to the host
_FORCED_CPU = False


def force_cpu():
    """Make the host the default place of every entry point in this
    process (``Executor()``, ``ServingEngine``, ``Trainer``,
    ``Inferencer``, ``DeviceLoader``, the fold's device) — the
    counterpart of the reference's ``force_cpu``, which routes all of
    jax to its CPU backend. Call it before building the entry points;
    an explicit place still wins. Safe to call more than once."""
    global _FORCED_CPU
    _FORCED_CPU = True


def default_place():
    """The place an entry point runs on when the caller names none: the
    card, ``CUDAPlace(0)`` (resolving its device raises where CUDA is
    absent), or ``CPUPlace()`` after :func:`force_cpu`."""
    return CPUPlace() if _FORCED_CPU else CUDAPlace(0)


def _feed_signature(feed):
    """Each feed's shape and dtype; a sequence's padded shape (each
    padded length its own signature, as the reference's retrace) with
    the shapes of its lengths and counts."""
    def sig(v):
        if isinstance(v, SequenceBatch):
            return tuple(tuple(leaf.shape) for leaf in v.leaves()) \
                + (str(v.dtype),)
        return tuple(v.shape), str(v.dtype)
    return tuple(sorted((k,) + tuple(sig(v)) for k, v in feed.items()))


class Executor:
    """Op-by-op executor over torch tensors (vs. fluid's per-op
    interpreter, reference paddle/fluid/framework/executor.cc)."""

    def __init__(self, place=None, retry_policy=None, compile_store=None):
        self.place = place if place is not None else default_place()
        self.device = self.place.device      # raises without CUDA
        # persistent artifact store (io/artifact_store.py): an
        # ArtifactStore, a directory, None (PADDLE_TPU_ARTIFACT_DIR) or
        # False (off even with the env var)
        from ..io.artifact_store import resolve_store
        self._store = resolve_store(compile_store)
        self._store_fns = {}     # artifact key -> loaded step
        self._store_new = {}     # ("artifact", key) -> 1 per exported miss
        self._akey_cache = {}    # (uid, version, mode, fetch, sig) -> key
        self._prog_repr = {}     # (uid, version, fetch) -> canonical repr
        self._store_warned = False
        self._fp = None          # library fingerprint, resolved lazily
        # (uid, version, mode, fetch names) -> [step fn, feed signatures]
        self._cache = {}
        # (uid, version, fetch names, validate mode) already verified
        self._validated = set()
        # PADDLE_TPU_OPTIMIZE: (program uid, fetch names, passes) ->
        # (source version, optimized clone) — the rewritten twin that
        # runs in the caller's program's place
        self._opt_cache = {}
        self._step = 0
        # None → resilience.retry.default_policy() resolved per run, so
        # PADDLE_TPU_MAX_RETRIES / PADDLE_TPU_RETRY_BACKOFF changes in
        # a live process (or a test) take effect immediately
        self._retry_policy = retry_policy

    # ------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, mode=None, repeats=1, validate=None):
        """Run one step of ``program``. Feeds move to the place's
        device. A train program (one with a ``backward`` marker) manages
        grad mode itself; any other runs under ``torch.inference_mode()``
        in ``mode == "test"`` (thread-local, so it is entered here, on
        the calling thread — the serving engine's worker) and under
        ``torch.no_grad()`` otherwise.

        ``repeats`` (1 to 32) runs that many steps on the same feed,
        each on the state the one before wrote, with the rng advancing
        per step exactly as separate calls would; fetches are the last
        step's.

        ``validate`` gates the static verifier (analysis/), run once per
        new program version and fetch set, BEFORE lowering: None reads
        ``PADDLE_TPU_VALIDATE`` (default "1" — cheap structural checks,
        error findings surface as VerifyWarning); "strict" runs the
        full pass pipeline and raises VerifyError on any error-level
        diagnostic; "0"/False disables."""
        if not 1 <= repeats <= 32:
            raise ValueError(f"repeats must be in [1, 32], got {repeats}")
        program = program or framework.default_main_program()
        if repeats > 1 and getattr(program, "_nan_guard", False):
            raise ValueError("repeats > 1 does not compose with the "
                             "NaN guard — flags are per dispatch")
        scope = scope or global_scope()
        feed = dict(feed) if feed else {}
        # in-graph readers (layers.py_reader / open_files / ...): any
        # started reader supplies its variables unless explicitly fed;
        # an exhausted one raises EOFException
        for r in getattr(program, "_readers", []):
            if r.started() and not all(n in feed for n in r.var_names()):
                for k, v in r.next_feed().items():
                    feed.setdefault(k, v)   # explicit feed keys win
        # static verification BEFORE anything is prepared or lowered,
        # once per (program version, fetch set, validate mode)
        self._validate(program, fetch_list, feed, validate)
        # opt-in graph rewrites (PADDLE_TPU_OPTIMIZE): run an optimized
        # clone instead of the caller's program, cached per fetch set
        program = self._maybe_optimize(program, fetch_list)
        fetch_names, mode, state, feed_vals = \
            self._prepare(program, feed, fetch_list, scope, mode)

        # artifact store: a hit runs the loaded step (no step build);
        # a miss builds the step below and persists its export
        art = (self._artifact_for(program, mode, fetch_names, repeats,
                                  state, feed_vals)
               if self._store is not None else None)
        step_fn = None if art is not None and art.source == "exported" \
            else self._step_fn(program, mode, fetch_names, feed_vals)
        if art is not None and art.source == "pending":
            art = self._export_and_persist(art, program, step_fn, state,
                                           feed_vals, mode, fetch_names)

        self._step += 1
        first_step = self._step
        self._step += repeats - 1

        def _dispatch():
            # deterministic transient-fault point (resilience/
            # faultinject.py "device_error") — raises before the step
            # touches any state, so a retry re-runs it safely
            if _faultinject.fires("device_error"):
                raise TransientDeviceError(
                    "injected transient device error (UNAVAILABLE)")
            if art is not None:
                with torch.inference_mode():
                    fetches, written = art(
                        [state[n] for n in art.param_names],
                        [feed_vals[n] for n in art.feed_names])
                return dict(written), list(fetches)
            if step_fn.trains:
                grad_mode = contextlib.nullcontext()
            elif mode == "test":
                grad_mode = torch.inference_mode()
            else:
                grad_mode = torch.no_grad()
            cur, written, fetches = state, {}, None
            with grad_mode:
                for i in range(repeats):
                    new_state, fetches = step_fn(
                        cur, feed_vals, self.device,
                        program.random_seed or 0, first_step + i)
                    written.update(new_state)
                    cur = {**cur, **new_state}
            return written, fetches

        from .. import profiler
        prof = profiler.profiling_active()
        t0 = time.perf_counter() if prof else 0.0
        policy = self._retry_policy or default_policy()
        new_state, fetches = with_retries(
            _dispatch, policy=policy,
            on_retry=lambda exc, n, delay: warnings.warn(
                f"transient device error on dispatch (failure {n}): "
                f"{exc}; retrying in {delay:.3g}s", stacklevel=3))
        if prof:
            # dispatch slice for the chrome timeline (host time: the
            # launches are asynchronous on the card; device time is in
            # the session's torch.profiler trace)
            profiler.add_timeline_event(
                f"dispatch step {first_step}", t0, time.perf_counter(),
                args={"repeats": repeats,
                      "program": f"uid={program.uid}"})
        guard = new_state.pop(GUARD, None)
        for n, v in new_state.items():
            scope.set(n, v)
        # after the scope is written, so a tripped guard leaves the
        # step's state readable
        check_nan_guard(guard, step_fn.guard_labels if step_fn else [])
        if return_numpy:
            fetches = [to_numpy(f) for f in fetches]
        return fetches

    def _step_fn(self, program, mode, fetch_names, feed_vals):
        """The built step of (program version, mode, fetch set), built
        on first use; records the feed signature (one step build
        each)."""
        key = (program.uid, program.version, mode, tuple(fetch_names))
        entry = self._cache.get(key)
        if entry is None:
            # drop step functions of older versions of this program so a
            # mutate-and-run loop doesn't leak them
            stale = [k for k in self._cache
                     if k[0] == program.uid and k[1] != program.version]
            for k in stale:
                del self._cache[k]
            entry = self._cache[key] = [
                lower_program(program, fetch_names, mode), set()]
        step_fn, sigs = entry
        sigs.add(_feed_signature(feed_vals))
        return step_fn

    # ------------------------------------------------------------------
    def _fingerprint(self):
        if self._fp is None:
            from ..io.artifact_store import library_fingerprint
            self._fp = library_fingerprint(self.device)
        return self._fp

    def _store_bypass(self, why):
        """Count a dispatch the store could not serve; warn once."""
        self._store._incr("bypass_total")
        if not self._store_warned:
            self._store_warned = True
            warnings.warn(f"artifact store bypassed ({why}); building "
                          "the step as usual", stacklevel=4)

    def _artifact_for(self, program, mode, fetch_names, repeats, state,
                      feed_vals):
        """Store-backed step for this dispatch: an in-memory hit, a
        verified disk load (no step build), or a ``"pending"`` marker
        for a miss whose step is built and then exported. None for what
        the store does not hold (train steps, guarded steps, repeats)
        or on any failure — the ordinary step runs, so the store can
        degrade but never break a dispatch. A step that draws random
        numbers bypasses it too: the exported graph has no seed or step
        input, so it would repeat one draw; and a step fed sequences,
        whose exported graph would take plain tensors (io/aot.py
        decomposes them for its own export)."""
        from ..io import artifact_store as ast
        if mode != "test" or repeats != 1 or \
                getattr(program, "_nan_guard", False) or any(
                    op.type == "backward"
                    for op in program.global_block().ops) or \
                _draws_rng(program) or any(
                    isinstance(v, SequenceBatch) for v in feed_vals.values()):
            self._store._incr("bypass_total")
            return None
        try:
            sig = ast.arg_signature(state, feed_vals)
            ckey = (program.uid, program.version, mode,
                    tuple(fetch_names), sig)
            akey = self._akey_cache.get(ckey)
            if akey is None:
                pkey = (program.uid, program.version,
                        tuple(sorted(fetch_names)))
                prepr = self._prog_repr.get(pkey)
                if prepr is None:
                    prepr = ast.canonical_program_repr(program,
                                                       fetch_names)
                    self._prog_repr[pkey] = prepr
                akey = ast.artifact_key(prepr, mode, fetch_names, repeats,
                                        True, sig, self._fingerprint())
                self._akey_cache[ckey] = akey
            art = self._store_fns.get(akey)
            if art is None:
                art = self._store.load(akey)
            if art is None:
                return ast._LoadedArtifact(None, "pending", akey,
                                           sorted(state), sorted(feed_vals))
            self._store_fns[akey] = art
            if len(self._store_fns) > 512:   # mutate-and-run bound
                self._store_fns.pop(next(iter(self._store_fns)))
            return art
        except Exception as e:        # noqa: BLE001 — degrade, never block
            self._store_bypass(f"{type(e).__name__}: {e}")
            return None

    def _export_and_persist(self, art, program, step_fn, state, feed_vals,
                            mode, fetch_names):
        """The store-miss path: export the step just built for exactly
        this signature (io/aot.py's machinery), persist it for every
        later process, and run it in this one too, so a miss and a hit
        run the same graph. The build is counted in ``compile_counts``
        (the step's feed signature, plus an ("artifact", key) entry)."""
        from ..io.aot import export_step, save_exported
        try:
            ep = export_step(step_fn, art.param_names,
                             [state[n] for n in art.param_names],
                             art.feed_names,
                             [feed_vals[n] for n in art.feed_names],
                             self.device, with_state=True)
            self._store.save(
                art.key, save_exported(ep), self._fingerprint(),
                meta={"mode": mode, "fetch": list(fetch_names),
                      "param_names": art.param_names,
                      "feed_names": art.feed_names})
        except Exception as e:        # noqa: BLE001 — degrade, never block
            self._store_bypass(f"export failed: {type(e).__name__}: {e}")
            return None
        self._store_new[("artifact", art.key)] = 1
        from ..io.artifact_store import _LoadedArtifact
        fresh = _LoadedArtifact(ep.module(), "fresh", art.key,
                                art.param_names, art.feed_names)
        self._store_fns[art.key] = fresh
        return fresh

    def store_stats(self):
        """The artifact store's counter snapshot (plus how many loaded
        steps this executor holds), or None when no store is
        configured — surfaced by the serving engine under
        stats()["artifact_store"]."""
        if self._store is None:
            return None
        snap = self._store.stats()
        snap["loaded_executables"] = len(self._store_fns)
        return snap

    # ------------------------------------------------------------------
    def _maybe_optimize(self, program, fetch_list):
        """The PADDLE_TPU_OPTIMIZE opt-in hook: returns the program to
        actually lower. "1"/"on" runs the full rewrite pipeline
        (fold + fuse + cse + dce, analysis/optimize.py); a
        comma-separated value ("fold,dce") selects exactly those
        passes. The rewrites run over an internal CLONE keyed by
        (program uid, fetch set, passes), never the caller's program:
        fetch-set-specific dead-code removal must not leak into a
        program another call site fetches differently from. Constants
        fold on this executor's device. The clone is re-derived when the
        source program's version moves; a rewrite failure degrades to
        running the original with a warning (never blocks the run)."""
        flag = os.environ.get("PADDLE_TPU_OPTIMIZE", "0")
        if flag in ("0", "", "off", "none") or not fetch_list:
            return program
        fetch_names = tuple(
            v.name if isinstance(v, framework.Variable) else v
            for v in fetch_list)
        okey = (program.uid, fetch_names, flag)
        cached = self._opt_cache.get(okey)
        if cached is not None and cached[0] == program.version:
            return cached[1]
        try:
            from ..analysis.optimize import optimize_program, parse_passes
            clone = program.clone(for_test=program._is_test)
            clone._nan_guard = getattr(program, "_nan_guard", False)
            optimize_program(clone, fetch_list=list(fetch_names),
                             passes=parse_passes(flag), device=self.device)
        except Exception as e:   # an optimizer bug must not block runs
            warnings.warn(
                f"PADDLE_TPU_OPTIMIZE rewrite failed ({e!r}); running "
                "the program unoptimized", stacklevel=3)
            clone = program
        if cached is not None:
            # the source program changed: drop step functions built
            # from the stale clone
            for k in [k for k in self._cache if k[0] == cached[1].uid]:
                del self._cache[k]
        self._opt_cache[okey] = (program.version, clone)
        return clone

    def _validate(self, program, fetch_list, feed, validate):
        """Pre-lowering static verification (analysis/), gated by the
        ``validate`` argument / PADDLE_TPU_VALIDATE env var, cached so
        each (program version, fetch set, mode) is checked ONCE — the
        same cadence as building a step, never per step. Cheap mode must
        never block a run: any error-level finding (or a verifier
        crash) degrades to a VerifyWarning. Strict mode runs the full
        pipeline and raises VerifyError before anything is lowered."""
        mode = validate
        if mode is None:
            mode = os.environ.get("PADDLE_TPU_VALIDATE", "1")
        if mode in (False, "0", "off", "none"):
            return
        fetch_names = tuple(
            v.name if isinstance(v, framework.Variable) else v
            for v in (fetch_list or []))
        vkey = (program.uid, program.version, fetch_names, str(mode))
        if vkey in self._validated:
            return
        from ..analysis import VerifyError, VerifyWarning, errors, \
            verify_program
        feed_names = sorted(feed) if feed else []
        if mode == "strict":
            diags = verify_program(program, fetch_list=fetch_names,
                                   feed_names=feed_names, level="full")
            if errors(diags):
                raise VerifyError(diags)
        else:
            try:
                diags = verify_program(program, fetch_list=fetch_names,
                                       feed_names=feed_names,
                                       level="cheap")
                for d in errors(diags):
                    warnings.warn(d.format(), VerifyWarning,
                                  stacklevel=3)
            except Exception as e:  # verifier bug — never block the run
                warnings.warn(f"program validation crashed ({e!r}); "
                              "set PADDLE_TPU_VALIDATE=0 to silence",
                              VerifyWarning, stacklevel=3)
        self._validated.add(vkey)

    # ------------------------------------------------------------------
    def _prepare(self, program, feed, fetch_list, scope, mode):
        """Normalize fetch names, resolve mode, gather the scope's
        persistables (staging host values to the device once), and move
        feeds to the device."""
        gb = program.global_block()
        fetch_names = [v.name if isinstance(v, framework.Variable) else v
                       for v in (fetch_list or [])]
        if mode is None:
            mode = "test" if program._is_test else "train"
        written = written_names(gb)
        state = {}
        for n in sorted(n for n, v in gb.vars.items() if v.persistable):
            val = scope.find_var(n)
            if val is None:
                if n not in written:
                    raise RuntimeError(
                        f"persistable variable {n!r} has no value in the "
                        "scope and is not produced by this program — did "
                        "you forget to run the startup program first?")
                continue  # created by this program (startup initializer)
            if _is_sharded(val):
                # a ParallelExecutor's placed value: its global tensor
                val = global_value(val)
                scope.set(n, val)
            if not isinstance(val, torch.Tensor) \
                    or val.device != self.device:
                # stage once and keep the resident copy in the scope
                val = self._to_tensor(val)
                scope.set(n, val)
            state[n] = val
        feed_vals = {k: self._to_tensor(v) for k, v in feed.items()}
        return fetch_names, mode, state, feed_vals

    def _to_tensor(self, v):
        """A feed on the device: a tensor, an array, or a sequence — a
        SequenceBatch, or any value with ``.data`` and ``.lengths`` (and
        ``.outer_counts``) leaves — as a SequenceBatch of tensors."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        if hasattr(v, "lengths") and hasattr(v, "data"):
            counts = getattr(v, "outer_counts", None)
            return SequenceBatch(
                self._to_tensor(v.data),
                self._to_tensor(v.lengths).to(torch.int64),
                None if counts is None
                else self._to_tensor(counts).to(torch.int64))
        # a copy: a donated update never writes into the caller's array
        return torch.as_tensor(np.array(v), device=self.device)

    # ------------------------------------------------------------------
    # step-build introspection (serving/ warmup leans on this to PROVE
    # bucket reuse: after warming every declared shape bucket,
    # steady-state traffic must not grow these numbers)
    def compile_cache_keys(self):
        """Snapshot of the lowered-program cache keys, each
        ``(program_uid, program_version, mode, fetch_names)`` — one entry
        per distinct lowered step, as :meth:`compile_counts` keys it."""
        return sorted(self._cache)

    def compile_counts(self):
        """``{(program_uid, program_version, mode, fetch_names):
        n_feed_signatures}`` — the distinct step builds
        behind each lowered program, one per feed shape-and-dtype
        signature it has run. The reference counts XLA executables per
        signature; eager torch builds nothing per shape, but the count
        keeps its meaning: each declared serving bucket contributes
        exactly one, and a request shape that escapes the buckets adds
        one. A step loaded from the artifact store counts nowhere —
        that absence is the zero-build cold start; a store miss adds an
        ``("artifact", key)`` entry beside its build."""
        out = {k: len(sigs) for k, (_, sigs) in self._cache.items()}
        out.update(self._store_new)
        return out

    def total_compiles(self):
        """Total step builds across every lowered program — the scalar
        warmup assertions compare."""
        return sum(len(sigs) for _, sigs in self._cache.values())

    def compiled_stats(self, program=None, feed=None, fetch_list=None,
                       scope=None, mode=None, repeats=1, top_k=10):
        """Measured cost of one dispatch of ``run`` for this (program,
        feed, fetch, repeats): the same optimized clone, the same built
        step and rng stream, run once on a copy of the scope's state
        (the step donates its state, and the scope must not move), with
        :func:`compiled_cost_stats` counting — the counterpart of the
        reference's AOT-compiled analysis. Keys as the reference's:
        'flops', 'bytes_accessed', 'n_kernels', 'peak_memory_bytes'
        (the card only), 'kernel_histogram' and 'top_kernels' (with
        ``top_k``); see :func:`compiled_cost_stats`."""
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        program = self._maybe_optimize(program, fetch_list)
        fetch_names, mode, state, feed_vals = \
            self._prepare(program, dict(feed) if feed else {}, fetch_list,
                          scope, mode)
        step_fn = lower_program(program, fetch_names, mode)
        state = {n: v.clone() for n, v in state.items()}

        def step():
            if step_fn.trains:
                grad_mode = contextlib.nullcontext()
            elif mode == "test":
                grad_mode = torch.inference_mode()
            else:
                grad_mode = torch.no_grad()
            cur = state
            with grad_mode:
                for i in range(repeats):
                    new_state, _ = step_fn(cur, feed_vals, self.device,
                                           program.random_seed or 0, 1 + i)
                    cur = {**cur, **new_state}

        return compiled_cost_stats(step, self.device, top_k)

    def close(self):
        self._cache.clear()
        self._opt_cache.clear()
        self._store_fns.clear()
        self._store_new.clear()
        self._akey_cache.clear()
        self._prog_repr.clear()


def _draws_rng(program):
    """Whether a test-mode step of ``program`` draws random numbers: an
    op of any block for which ``registry.draws_rng`` holds (a ``stateful``
    op, but dropout and greedy generation)."""
    key = (program.uid, program.version)
    memo = getattr(program, "_draws_rng_memo", None)
    if memo is None or memo[0] != key:
        from .registry import draws_rng
        hit = any(draws_rng(op) for blk in program.blocks for op in blk.ops)
        memo = program._draws_rng_memo = (key, hit)
    return memo[1]


def check_nan_guard(flags, labels):
    """Raise FloatingPointError naming the first non-finite op outputs
    of a guarded step (``flags``: its bool tensor, one flag a label; None
    when the guard is off). One read back from the device."""
    if flags is None:
        return
    ok = flags.cpu().numpy()
    if not ok.all():
        bad = [labels[i] if i < len(labels) else f"op#{i}"
               for i in np.nonzero(~ok)[0][:8]]
        raise FloatingPointError(
            "NaN/Inf guard tripped — first non-finite op "
            f"outputs: {bad}")


def _is_sharded(v):
    """Whether ``v`` is a value placed on a device mesh (a DTensor of a
    ParallelExecutor's scope)."""
    return hasattr(v, "full_tensor") and hasattr(v, "placements")


def global_value(v):
    """``v`` as one tensor holding its global value: a placed value
    (DTensor) gathered from its shards — a collective, so every rank
    of its mesh calls it alike — anything else as it is."""
    return v.full_tensor() if _is_sharded(v) else v


def to_numpy(t):
    """A fetched tensor as a numpy array of its own on the host (a fetched
    state tensor is updated in place by a later donating step);
    bfloat16 widens to float32 (numpy has no bfloat16 without
    ml_dtypes). A placed value (DTensor) gives its global value; a
    SequenceBatch comes back as one with numpy leaves."""
    if isinstance(t, SequenceBatch):
        return t.map(to_numpy)
    t = global_value(t).detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    a = t.cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


# ----------------------------------------------------------------------
# compiled_stats: what one step dispatches, counted as it runs
# ----------------------------------------------------------------------
_HLO_DTYPE = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bool: "pred", torch.complex64: "c64",
}


def _tensor_bytes(t):
    return t.numel() * t.element_size()


def _shape_str(outs):
    """The reference's HLO shape text of an op's tensor outputs
    (``f32[4,64]``; a tuple for several)."""
    parts = [f"{_HLO_DTYPE.get(t.dtype, str(t.dtype))}"
             f"[{','.join(str(d) for d in t.shape)}]" for t in outs]
    return parts[0] if len(parts) == 1 else f"({', '.join(parts)})"


def _aten_recorder():
    """A dispatch mode recording every non-view aten op a step runs as
    (name, output shape, input + output bytes)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class _Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                ins = [a for a in tree_flatten((args, kwargs or {}))[0]
                       if isinstance(a, torch.Tensor)]
                outs = [o for o in tree_flatten(out)[0]
                        if isinstance(o, torch.Tensor)]
                nbytes = sum(_tensor_bytes(t) for t in ins + outs)
                self.ops.append((func.overloadpacket.__name__,
                                 _shape_str(outs) if outs else "()",
                                 nbytes))
            return out

    return _Recorder()


def _kernel_histogram(kernels):
    """Aggregate [(kind, shape, bytes)] into a kind-keyed table sorted
    by total bytes (the reference's layout)."""
    agg = {}
    for kind, _, b in kernels:
        cnt, tot = agg.get(kind, (0, 0))
        agg[kind] = (cnt + 1, tot + b)
    return [{"kind": k, "count": c, "mbytes": round(t / 2**20, 2)}
            for k, (c, t) in
            sorted(agg.items(), key=lambda kv: -kv[1][1])]


def compiled_cost_stats(step, device, top_k=10):
    """Run ``step()`` once and count what it dispatched — the shared
    assembly behind Executor.compiled_stats and
    ParallelExecutor.compiled_stats, the torch counterpart of the
    reference's XLA analyses of a compiled executable:

    - ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total;
    - ``bytes_accessed``: each aten op's input and output bytes, summed;
    - ``n_kernels``, ``kernel_histogram`` (kind -> count, mbytes) and
      ``top_kernels`` (kind, shape, mbytes; ``top_k`` of them, none for
      ``top_k=0``): on the card the CUDA kernels ``torch.profiler``
      traced (kind = the kernel's name, bytes = 0: a trace gives no
      operand sizes; ``kernel_source`` says ``"cuda"``), and where the
      trace holds none, or on the host, the non-view aten ops
      dispatched (``kernel_source`` ``"aten"``);
    - ``peak_memory_bytes``: the allocator's peak over the step, on the
      card only.

    The reference's ``generated_code_size_bytes`` has no torch
    counterpart (there is no compiled module) and is left out."""
    from torch.utils.flop_counter import FlopCounterMode
    cuda = device.type == "cuda"
    prof = contextlib.nullcontext()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    rec = _aten_recorder()
    with prof as p, FlopCounterMode(display=False) as fc, rec:
        step()
        if cuda:
            torch.cuda.synchronize(device)
    stats = {"flops": float(fc.get_total_flops()),
             "bytes_accessed": float(sum(b for _, _, b in rec.ops))}
    kernels, source = rec.ops, "aten"
    if cuda:
        stats["peak_memory_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
        from torch.autograd import DeviceType
        traced = [(e.name[:80], "", 0) for e in p.events()
                  if e.device_type == DeviceType.CUDA]
        if traced:
            kernels, source = traced, "cuda"
    stats["n_kernels"] = len(kernels)
    stats["kernel_source"] = source
    if top_k:
        stats["kernel_histogram"] = _kernel_histogram(kernels)
        stats["top_kernels"] = [
            {"kind": k, "shape": s, "mbytes": round(b / 2**20, 2)}
            for k, s, b in sorted(kernels, key=lambda t: -t[2])[:top_k]]
    return stats
