"""Executor, Scope, Place.

Port of ``paddle_tpu/core/executor.py``. ``Executor.run`` lowers a
Program into a step function once per (program uid, version, mode,
fetch set) and runs it eagerly on torch tensors on the place's device.

Places are real devices: ``CUDAPlace(i)`` is ``cuda:i`` and
``CPUPlace()`` the host. ``TPUPlace`` is an alias of ``CUDAPlace`` so
reference scripts keep running on the card — the reverse of the
reference, where CUDAPlace aliased the TPU. An Executor built without a
place runs on ``CUDAPlace(0)`` and raises where CUDA is absent: the CPU
is only used when the caller asks for it.

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

Later slices: the artifact store and the profiler hook.
"""
import contextlib
import os
import warnings

import numpy as np
import torch

from . import framework
from .lowering import GUARD, lower_program, written_names
from ..resilience import faultinject as _faultinject
from ..resilience.retry import (TransientDeviceError, default_policy,
                                with_retries)

__all__ = ["Scope", "global_scope", "scope_guard", "Executor",
           "CPUPlace", "TPUPlace", "CUDAPlace", "EOFException"]


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


def _feed_signature(feed):
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in feed.items()))


class Executor:
    """Op-by-op executor over torch tensors (vs. fluid's per-op
    interpreter, reference paddle/fluid/framework/executor.cc)."""

    def __init__(self, place=None, retry_policy=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device      # raises without CUDA
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
        # static verification BEFORE anything is prepared or lowered,
        # once per (program version, fetch set, validate mode)
        self._validate(program, fetch_list, feed, validate)
        # opt-in graph rewrites (PADDLE_TPU_OPTIMIZE): run an optimized
        # clone instead of the caller's program, cached per fetch set
        program = self._maybe_optimize(program, fetch_list)
        fetch_names, mode, state, feed_vals = \
            self._prepare(program, feed, fetch_list, scope, mode)

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

        policy = self._retry_policy or default_policy()
        new_state, fetches = with_retries(
            _dispatch, policy=policy,
            on_retry=lambda exc, n, delay: warnings.warn(
                f"transient device error on dispatch (failure {n}): "
                f"{exc}; retrying in {delay:.3g}s", stacklevel=3))
        guard = new_state.pop(GUARD, None)
        for n, v in new_state.items():
            scope.set(n, v)
        # after the scope is written, so a tripped guard leaves the
        # step's state readable
        check_nan_guard(guard, step_fn.guard_labels)
        if return_numpy:
            fetches = [to_numpy(f) for f in fetches]
        return fetches

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
            if not isinstance(val, torch.Tensor) \
                    or val.device != self.device:
                # stage once and keep the resident copy in the scope
                val = self._to_tensor(val)
                scope.set(n, val)
            state[n] = val
        feed_vals = {}
        for k, v in feed.items():
            var = gb.vars.get(k)
            if var is not None and var.lod_level > 0:
                raise NotImplementedError(
                    f"feed {k!r} is a sequence (lod_level "
                    f"{var.lod_level}); sequences are a later slice of "
                    "the torch port (ROADMAP.md item 'Remaining op "
                    "families')")
            feed_vals[k] = self._to_tensor(v)
        return fetch_names, mode, state, feed_vals

    def _to_tensor(self, v):
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        if hasattr(v, "lengths") and hasattr(v, "data"):
            raise NotImplementedError(
                "SequenceBatch values are a later slice of the torch port "
                "(ROADMAP.md item 'Remaining op families')")
        # a copy: a donated update never writes into the caller's array
        return torch.as_tensor(np.array(v), device=self.device)

    # ------------------------------------------------------------------
    # step-build introspection (serving/ warmup leans on this to PROVE
    # bucket reuse: after warming every declared shape bucket,
    # steady-state traffic must not grow these numbers)
    def compile_counts(self):
        """``{(program_uid, program_version, mode, fetch_names):
        n_feed_signatures}`` — the distinct step builds
        behind each lowered program, one per feed shape-and-dtype
        signature it has run. The reference counts XLA executables per
        signature; eager torch builds nothing per shape, but the count
        keeps its meaning: each declared serving bucket contributes
        exactly one, and a request shape that escapes the buckets adds
        one."""
        return {k: len(sigs) for k, (_, sigs) in self._cache.items()}

    def total_compiles(self):
        """Total step builds across every lowered program — the scalar
        warmup assertions compare."""
        return sum(self.compile_counts().values())

    def close(self):
        self._cache.clear()
        self._opt_cache.clear()


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


def to_numpy(t):
    """A fetched tensor as a numpy array of its own on the host (a fetched
    state tensor is updated in place by a later donating step);
    bfloat16 widens to float32 (numpy has no bfloat16 without
    ml_dtypes)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    a = t.cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a
