"""Program → torch lowering.

Port of ``paddle_tpu/core/lowering.py``. The reference lowers a whole
Program into one pure function that ``jax.jit`` traces; here the same
walk runs eagerly, op by op, on torch tensors that live on the
executor's device.

A program with a ``backward`` marker (``append_backward``) is one train
step, as in the reference: the ops before the marker run under
``torch.enable_grad()`` with each marked parameter a leaf that requires
grad, ``torch.autograd.grad`` of the loss binds the ``<param>@GRAD``
names (zeros for a parameter the loss does not reach, as
``jax.value_and_grad`` gives), and the optimizer ops after the marker
run under ``torch.no_grad()``.

Three program-level switches shape the step, as in the reference:

- AMP (``program._amp``, ``transpiler/amp.py``): the casts of
  ``core/amp_policy.py`` around each op. They are torch ops inside the
  autograd graph, so float32 master parameters get float32 gradients,
  as ``jax.value_and_grad`` gives them through ``astype``.
- Rematerialisation (``program._remat_policy``,
  ``transpiler/memory_optimization.py``): the forward segment runs under
  ``torch.utils.checkpoint`` (non-reentrant), with a selective policy
  where the jax policy saves some values (:data:`REMAT_POLICIES`), or
  the values the conv-net ops tag by name (:data:`NAMED_POLICIES`).
- The NaN guard (``program._nan_guard``, ``debugger.py``): one
  ``isfinite(v).all()`` flag per float op output, labelled
  ``"{op.type} -> {name}"``, stacked into one tensor that the executor
  reads back once per run.

Under a device mesh (``parallel.ParallelExecutor``) the step takes an
``spmd`` object (``parallel/spmd.py``): values are placed DTensors, each
op goes through ``spmd.lower``, the parameters' gradients are brought to
their parameters' placements (``spmd.sync_grads``) and donation works on
the local blocks (``spmd.donate``).
"""
import contextlib
import functools

import torch

from . import framework
from .amp_policy import (AMP_BF16_FLOW_OPS, AMP_MATMUL_OPS,
                         AMP_SELF_MANAGED_DTYPE_OPS)
from .registry import get_op
from .sequence import SequenceBatch

__all__ = ["LoweringContext", "Env", "lower_program", "written_names",
           "read_names", "RANGE_OPTIMIZER", "REMAT_POLICIES",
           "NAMED_POLICIES", "NamedSaves", "remat_saves", "remat_tag",
           "GUARD"]

# the torch.profiler range around a train step's optimizer ops
RANGE_OPTIMIZER = "paddle_tpu_torch.optimizer"
# the new-state entry that carries a guarded step's finite flags
GUARD = "__nan_guard__"

# jax.checkpoint policy names the reference accepts → the aten products
# whose outputs the torch form saves (None: no checkpoint at all; an
# empty tuple: a plain checkpoint that saves nothing). jax's dot_general
# is torch's mm / addmm (products of [.., K] x [K, N], no batch dims) and
# bmm (batched).
_DOTS = ("mm", "addmm", "bmm")
_DOTS_NO_BATCH = ("mm", "addmm")
REMAT_POLICIES = {
    "everything_saveable": None,
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
}


class NamedSaves:
    """The torch form of a conv-net remat policy, which the reference
    writes over values its ops tag by name (``checkpoint_name``): with
    ``save`` True only the ops run under tag ``name`` are saved
    (``save_only_these_names``), with ``save`` False every op but those
    (``save_anything_except_these_names``)."""

    def __init__(self, name, save):
        self.name, self.save = name, save


# the reference's own policies (paddle_tpu/core/lowering.py): conv nets
# save only the conv outputs, or all but the batch_norm outputs
NAMED_POLICIES = {
    "save_conv_only": NamedSaves("conv_out", True),
    "recompute_norms": NamedSaves("batch_norm_out", False),
}
# the reference's other policy names, refused by name
_REFUSED_POLICIES = {
    "offload_dot_with_no_batch_dims": "host offload of saved values is not "
                                      "ported",
    "save_and_offload_only_these_names": "host offload of saved values is "
                                         "not ported",
}
for _n in ("save_anything_except_these_names", "save_any_names_but_these",
           "save_only_these_names", "save_from_both_policies"):
    _REFUSED_POLICIES[_n] = (
        "it is a jax policy factory that takes value names; the named "
        "policies are 'recompute_norms' and 'save_conv_only'")

@contextlib.contextmanager
def remat_tag(ctx, name):
    """Runs its block with the aten ops it dispatches tagged ``name``
    (pushed on ``ctx.remat_tags``) for the selective checkpoint of a
    :data:`NAMED_POLICIES` policy over that name (the reference's
    ``checkpoint_name``). Tagged only when the program's policy reads
    ``name``: every other program runs exactly as it would without the
    tag."""
    named = NAMED_POLICIES.get(getattr(ctx.program, "_remat_policy", None))
    if named is None or named.name != name:
        yield
        return
    ctx.remat_tags.append(name)
    try:
        yield
    finally:
        ctx.remat_tags.pop()


def remat_saves(policy):
    """The torch form of remat ``policy``: the aten products it saves
    (see :data:`REMAT_POLICIES`), or a :class:`NamedSaves`. Raises
    NotImplementedError naming a policy the reference accepts that the
    port has no counterpart for, and ValueError for a name neither
    knows."""
    if policy in REMAT_POLICIES:
        return REMAT_POLICIES[policy]
    if policy in NAMED_POLICIES:
        return NAMED_POLICIES[policy]
    if policy in _REFUSED_POLICIES:
        raise NotImplementedError(
            f"remat policy {policy!r}: {_REFUSED_POLICIES[policy]}")
    valid = (["auto"] + sorted(REMAT_POLICIES) + sorted(NAMED_POLICIES)
             + sorted(_REFUSED_POLICIES))
    raise ValueError(f"unknown remat policy {policy!r}; one of {valid}")


def checkpointed(fn, saves, tags=()):
    """``fn`` under non-reentrant ``torch.utils.checkpoint``: a plain
    checkpoint for ``saves == ()``, selective checkpointing that saves
    the outputs of the aten ops named in ``saves`` (and recomputes the
    rest), or for a :class:`NamedSaves` the ops dispatched while its tag
    is on ``tags`` (the running context's ``remat_tags``; or all but
    those), ``fn`` itself for ``saves is None``.

    The hand kernels launch through ctypes, which the dispatcher cannot
    see; only the ``torch.empty`` of their outputs is an aten op, and no
    policy here saves one, so a kernel's output is either recomputed
    with its launch or kept by its autograd node as a whole."""
    if saves is None:
        return fn
    from torch.utils import checkpoint as ckpt
    if not saves:
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    save, recompute = (ckpt.CheckpointPolicy.MUST_SAVE,
                       ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    if isinstance(saves, NamedSaves):
        def policy(ctx, op, *args, **kwargs):
            return save if (saves.name in tags) == saves.save \
                else recompute
    else:
        keep = {getattr(torch.ops.aten, n).default for n in saves}

        def policy(ctx, op, *args, **kwargs):
            return save if op in keep else recompute

    return functools.partial(
        ckpt.checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy))


class Env:
    """Name → tensor environment with lexical parent chaining, the
    functional analogue of Fluid's Scope hierarchy (reference
    paddle/fluid/framework/scope.h)."""

    __slots__ = ("d", "parent")

    def __init__(self, parent=None):
        self.d = {}
        self.parent = parent

    def __getitem__(self, name):
        e = self
        while e is not None:
            if name in e.d:
                return e.d[name]
            e = e.parent
        raise KeyError(f"variable {name!r} has no value (not fed, not in "
                       f"scope, and not produced by a prior op)")

    def __setitem__(self, name, value):
        self.d[name] = value

    def __contains__(self, name):
        e = self
        while e is not None:
            if name in e.d:
                return True
            e = e.parent
        return False

    def get(self, name, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def update(self, other):
        self.d.update(other)


def _mix_seed(*parts):
    """Deterministic 63-bit mix of (seed, step, count) for a generator
    seed — the counterpart of the reference's jax.random.fold_in chain.
    The two frameworks draw different numbers from the same seed, so
    tests compare by carrying state across, never by drawing."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = ((h ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) \
            & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


class LoweringContext:
    """Carries step-wide services to op lowering rules: the device,
    deterministic per-op random generators, and train/test mode."""

    def __init__(self, program, mode, device, seed, step, read=None,
                 spmd=None, for_export=False):
        self.program = program
        # True while torch.export traces the step (io/aot.py): the
        # recurrences and the host-read control flow lower to torch's
        # higher-order ops (scan, while_loop, cond) instead of loops and
        # branches on the host
        self.for_export = for_export
        # parallel.spmd.Spmd under a device mesh, else None
        self.spmd = spmd
        self.mode = mode  # "train" | "test"
        self.device = device
        self._seed = seed
        self._step = step
        self._key_count = 0
        self._read = read  # names something reads (None: assume all)
        self.op = None    # current op (set by eval_op)
        self.env = None   # current env (set by eval_op)
        # (label, is-finite flag) per float op output when the program's
        # NaN guard is on (debugger.enable_nan_guard); None: not recording
        self.guard = [] if getattr(program, "_nan_guard", False) else None
        # name -> state tensor an optimizer op may update in place (a
        # step that donates its state, during its optimizer segment)
        self.donated = {}
        # the value names the running op rule tags its aten ops with
        # (remat_tag), read by a named remat policy
        self.remat_tags = []

    @property
    def is_test(self):
        return self.mode == "test"

    def wants(self, slot):
        """Whether the current op's ``slot`` output is read by an op,
        fetched or persistable. A rule may skip an optional output that
        nothing wants — the eager counterpart of ``jax.jit`` dropping
        dead code."""
        if self._read is None or self.op is None:
            return True
        return any(n in self._read for n in self.op.outputs.get(slot, ()))

    def donated_output(self, in_slot, out_slot, value):
        """The tensor the current op may write its ``out_slot`` into in
        place: ``value`` — what it reads at ``in_slot`` — when that is a
        donated state tensor and ``out_slot`` writes the same name back;
        else None (a rule then writes a new tensor)."""
        op = self.op
        if not self.donated or op is None:
            return None
        names = op.inputs.get(in_slot, [])
        if len(names) != 1 or op.outputs.get(out_slot) != names:
            return None
        return value if self.donated.get(names[0]) is value else None

    def next_key(self):
        """A fresh ``torch.Generator`` on the device, seeded from
        (program seed, step, draw count) — the reference's
        ``fold_in(key, count)``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.next_seed())
        return g

    def next_seed(self):
        """The seed :meth:`next_key` seeds its generator with, taking the
        same draw — for an op that folds counters of its own into its key
        (the reference's ``fold_in(key, i)`` on one op's key)."""
        seed = _mix_seed(self._seed, self._step, self._key_count)
        self._key_count += 1
        return seed

    def fork(self):
        """A context of the same step for the body of a higher-order op
        that ``torch.export`` traces (``scan``, ``while_loop``,
        ``cond``), made inside that body: such a body may mutate nothing
        made outside it, and evaluating an op sets the context's current
        op, env and draw count."""
        sub = LoweringContext(self.program, self.mode, self.device,
                              self._seed, self._step, self._read, self.spmd,
                              self.for_export)
        sub._key_count = self._key_count
        return sub

    # ------ block evaluation -------------------------------------------
    def eval_block(self, block, env):
        for op in block.ops:
            self.eval_op(op, env)

    def eval_op(self, op, env):
        try:
            return self._eval_op(op, env)
        except Exception as e:
            # re-raise carrying op type, block/op index, and the
            # variable wiring — without changing the exception type.
            # Annotate once, at the innermost op.
            if not getattr(e, "_lowering_ctx_added", False):
                e._lowering_ctx_added = True
                block = op.block
                try:
                    op_idx = block.ops.index(op)
                except ValueError:
                    op_idx = -1
                e.add_note(f"while lowering op {op.type!r} "
                           f"(block {block.idx}, op #{op_idx}): "
                           f"inputs {op.inputs} -> outputs {op.outputs}")
            raise

    def _eval_op(self, op, env):
        opdef = get_op(op.type)
        ins = {}
        seq_lengths = seq_counts = None
        for slot, names in op.inputs.items():
            vals = [env[n] for n in names]
            if not opdef.seq_aware:
                # a dense op gets the padded data of a sequence; its
                # lengths rewrap the outputs whose variables are lod
                unwrapped = []
                for v in vals:
                    if isinstance(v, SequenceBatch):
                        if seq_lengths is None:
                            seq_lengths = v.lengths
                            seq_counts = v.outer_counts
                        v = v.data
                    unwrapped.append(v)
                vals = unwrapped
            ins[slot] = vals
        amp_level = getattr(self.program, "_amp", False)
        amp = bool(amp_level) and op.type in AMP_MATMUL_OPS
        o2 = amp_level == "O2"
        o2_flow = o2 and not amp and op.type in AMP_BF16_FLOW_OPS
        flow_had_bf16 = False
        if amp:
            # matmul-shaped ops compute in bf16; master values stay f32
            ins = _cast_all(ins, torch.float32, torch.bfloat16)
        elif o2 and not o2_flow:
            # O2: any op outside the flow set (softmax, losses, optimizer
            # math) gets f32 inputs
            ins = _cast_all(ins, torch.bfloat16, torch.float32)
        elif o2_flow:
            flow_had_bf16 = any(getattr(v, "dtype", None) == torch.bfloat16
                                for vals in ins.values() for v in vals)
        prev_op, prev_env = self.op, self.env
        self.op, self.env = op, env
        try:
            if self.spmd is not None:
                outs = self.spmd.lower(self, op, opdef.lower, ins, op.attrs)
            else:
                outs = opdef.lower(self, ins, op.attrs)
        finally:
            self.op, self.env = prev_op, prev_env
        if outs is None:
            return
        if amp and not o2:
            outs = _cast_all(outs, torch.bfloat16, torch.float32)
        elif o2_flow and flow_had_bf16 \
                and op.type not in AMP_SELF_MANAGED_DTYPE_OPS:
            # a mixed-dtype flow op (a bf16 activation + an f32 bias)
            # computes in f32, but its write stays bf16
            outs = _cast_all(outs, torch.float32, torch.bfloat16)
        block = op.block
        for slot, names in op.outputs.items():
            if slot not in outs:
                continue
            vals = outs[slot]
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for name, val in zip(names, vals):
                if isinstance(val, list):
                    # a tensor array (write_to_array): a list of tensors
                    env[name] = val
                    continue
                var = block._find_var_recursive(name)
                if (var is not None and var.lod_level > 0
                        and seq_lengths is not None
                        and not isinstance(val, SequenceBatch)
                        and val.dim() >= 2):
                    val = SequenceBatch(val, seq_lengths, seq_counts)
                data = val.data if isinstance(val, SequenceBatch) else val
                if (var is not None and var.stop_gradient
                        and not isinstance(var, framework.Parameter)
                        and data.is_floating_point()):
                    val = detach(val)
                env[name] = val
                if self.guard is not None and data.is_floating_point():
                    # detached: the probe is no part of the autograd
                    # graph, so a remat's recompute saves what the
                    # first run saved
                    self.guard.append((f"{op.type} -> {name}",
                                       torch.isfinite(data.detach()).all()))


def _donate(op, env, state):
    """Write each output of ``op`` that updates a tensor of ``state`` with
    a new tensor into that state tensor and rebind the name to it: the
    new tensor is freed at once, as a donated buffer is."""
    for names in op.outputs.values():
        for n in names:
            old, new = state.get(n), env.d.get(n)
            if (old is None or new is None or new is old
                    or new.shape != old.shape or new.dtype != old.dtype
                    or new.device != old.device):
                continue
            # a rule that wrote into the state itself hands back an alias
            if (new.data_ptr(), new.stride()) != (old.data_ptr(),
                                                  old.stride()):
                old.copy_(new)
            env[n] = old


def detach(v):
    """``v`` detached: a tensor, or a SequenceBatch's data (its lengths
    carry no gradient)."""
    if isinstance(v, SequenceBatch):
        return v.with_data(v.data.detach())
    return v.detach()


def _cast_all(vals_by_slot, from_dtype, to_dtype):
    """Each tensor of ``{slot: value or [values]}`` of ``from_dtype`` cast
    to ``to_dtype`` (a SequenceBatch's data, keeping its lengths); the
    rest as they are."""
    def cast(v):
        if getattr(v, "dtype", None) != from_dtype:
            return v
        if isinstance(v, SequenceBatch):
            return v.with_data(v.data.to(to_dtype))
        return v.to(to_dtype)
    return {slot: [cast(v) for v in (vals if isinstance(vals, (list, tuple))
                                     else [vals])]
            for slot, vals in vals_by_slot.items()}


def written_names(block, recursive=True):
    """Statically computes the set of variable names any op in ``block``
    (and its control-flow sub-blocks) writes. Used by the Executor to
    decide which persistables flow back to the Scope."""
    out = set()
    for op in block.ops:
        for names in op.outputs.values():
            out.update(names)
        if recursive:
            for v in op.attrs.values():
                if isinstance(v, framework.Block):
                    out |= written_names(v, recursive=True)
    return out


def read_names(block):
    """Every name an op of ``block`` or of its sub-blocks reads: its
    inputs and its string attributes (ops that name variables in
    attributes)."""
    out = set()
    for op in block.ops:
        for names in op.inputs.values():
            out.update(names)
        for v in op.attrs.values():
            if isinstance(v, framework.Block):
                out |= read_names(v)
            elif isinstance(v, str):
                out.add(v)
            elif isinstance(v, (list, tuple)):
                out.update(x for x in v if isinstance(x, str))
    return out


def lower_program(program, fetch_names, mode, for_export=False):
    """Builds the step function for a Program.

    Returns ``fn(state, feed, device, seed, step, spmd=None) ->
    (new_state, fetches)`` where ``state`` holds the scope's persistables and
    ``new_state`` every persistable some op of the program wrote — and,
    when the NaN guard is on, :data:`GUARD`: a bool tensor of one flag a
    float op output, whose labels are ``fn.guard_labels``.
    ``fn.trains`` is True when the program has a backward marker: the
    step then manages grad mode itself and must not run under
    ``torch.no_grad()`` or ``torch.inference_mode()``.

    A train step donates ``state`` (the reference's buffer donation):
    each optimizer op's update of a persistable of ``state`` ends in
    that state's own tensor as the op runs, so the old and the new state
    are never both alive. A rule that asks
    (:meth:`LoweringContext.donated_output`, Adam's) writes there
    itself; any other's new tensor is copied in and freed.

    ``for_export`` builds the step ``torch.export`` traces
    (:attr:`LoweringContext.for_export`): the same values, with every
    loop over a padded axis and every host read of a condition a
    higher-order op, so no length or trip count is fixed in the graph.
    """
    gb = program.global_block()
    ops = gb.ops
    bwd_idx = next((i for i, op in enumerate(ops) if op.type == "backward"),
                   None)
    written = written_names(gb)
    persistables = {n for n, v in gb.vars.items() if v.persistable}
    out_names = sorted(persistables & written)
    read = read_names(gb) | set(fetch_names) | persistables
    guarded = bool(getattr(program, "_nan_guard", False))

    if bwd_idx is not None:
        bwd_op = ops[bwd_idx]
        loss_name = bwd_op.input("Loss")[0]
        param_names = list(bwd_op.attr("parameter_names"))
        # only forward values referenced later (fetches, optimizer-op
        # inputs, persistables) outlive the forward segment; the rest
        # (the activations) is dropped before the backward pass runs
        needed_after = set(fetch_names)
        for op in ops[bwd_idx + 1:]:
            for ns in op.inputs.values():
                needed_after.update(ns)
        needed_after.update(persistables)
        # memory_optimize(): the forward segment under torch.utils.
        # checkpoint, saving what the policy saves
        saves = (remat_saves(program._remat_policy)
                 if program._remat_policy else None)

    def train_segment(ctx, env, state):
        base = dict(env.d)
        key0 = ctx._key_count
        runs = []

        def forward(*leaf_vals):
            # a recompute (remat) draws the same random numbers and adds
            # no guard flags: it re-runs what the first run recorded
            ctx._key_count = key0
            guard, ctx.guard = ctx.guard, (ctx.guard if not runs else None)
            runs.append(True)
            try:
                fwd = Env()
                fwd.update(base)
                fwd.update(zip(param_names, leaf_vals))
                for op in ops[:bwd_idx]:
                    ctx.eval_op(op, fwd)
                loss = fwd[loss_name].reshape(())
                # the forward's own values: what came in stays as it is
                return loss, {n: v for n, v in fwd.d.items()
                              if n in needed_after and n not in leaves
                              and v is not base.get(n)}
            finally:
                ctx.guard = guard

        leaves = {p: env[p].detach().requires_grad_() for p in param_names}
        with torch.enable_grad():
            loss, kept = checkpointed(forward, saves, ctx.remat_tags)(
                *(leaves[p] for p in param_names))
            key_after = ctx._key_count
            if loss.requires_grad:
                grads = torch.autograd.grad(
                    loss, [leaves[p] for p in param_names],
                    allow_unused=True)
            else:
                grads = [None] * len(param_names)
        if ctx.spmd is not None:
            grads = ctx.spmd.sync_grads([leaves[p] for p in param_names],
                                        grads)
        ctx._key_count = key_after
        env.update({n: detach(v) for n, v in kept.items()})
        for p, g in zip(param_names, grads):
            env[framework.grad_var_name(p)] = \
                torch.zeros_like(env[p]) if g is None else g
        ctx.donated = state
        with torch.no_grad(), \
                torch.profiler.record_function(RANGE_OPTIMIZER):
            for op in ops[bwd_idx + 1:]:
                ctx.eval_op(op, env)
                if ctx.spmd is not None:
                    ctx.spmd.donate(op, env, state)
                else:
                    _donate(op, env, state)

    def fn(state, feed, device, seed, step, spmd=None):
        ctx = LoweringContext(program, mode, device, seed, step, read, spmd,
                              for_export)
        env = Env()
        env.update(state)
        env.update(feed)
        if bwd_idx is None:
            # exported: the first op after which a sequence feed's
            # padded axis is no longer a symbol (fn.fixed_by)
            watch = _padded_symbols(feed) if for_export else ()
            for op in ops:
                ctx.eval_op(op, env)
                if watch and any(d.node.expr.is_number for d in watch):
                    fn.fixed_by, watch = op.type, ()
        else:
            train_segment(ctx, env, state)
        new_state = {n: env.d[n] for n in out_names if n in env.d}
        fetches = [env[n] for n in fetch_names]
        if guarded:
            # emitted whenever the guard is on, even with no float output
            fn.guard_labels = [label for label, _ in ctx.guard]
            new_state[GUARD] = (
                torch.stack([flag for _, flag in ctx.guard]) if ctx.guard
                else torch.ones((0,), dtype=torch.bool, device=device))
        return new_state, fetches

    fn.trains = bwd_idx is not None
    fn.guard_labels = []
    fn.fixed_by = None
    return fn


def _padded_symbols(feed):
    """The symbolic sizes of the padded axes of the sequence feeds of a
    step ``torch.export`` traces."""
    return [d for v in feed.values() if isinstance(v, SequenceBatch)
            for d in v.data.shape[1:1 + v.lod_level]
            if isinstance(d, torch.SymInt)]
