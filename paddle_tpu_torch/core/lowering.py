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
run under ``torch.no_grad()``. The remat policies, AMP casts and the NaN
guard are refused until they are ported (ROADMAP.md item 'Training').
"""
import torch

from . import framework
from .registry import get_op

__all__ = ["LoweringContext", "Env", "lower_program", "written_names",
           "read_names", "RANGE_OPTIMIZER"]

# the torch.profiler range around a train step's optimizer ops
RANGE_OPTIMIZER = "paddle_tpu_torch.optimizer"


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

    def __init__(self, program, mode, device, seed, step, read=None):
        self.program = program
        self.mode = mode  # "train" | "test"
        self.device = device
        self._seed = seed
        self._step = step
        self._key_count = 0
        self._read = read  # names something reads (None: assume all)
        self.op = None    # current op (set by eval_op)
        self.env = None   # current env (set by eval_op)

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

    def next_key(self):
        """A fresh ``torch.Generator`` on the device, seeded from
        (program seed, step, draw count) — the reference's
        ``fold_in(key, count)``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(_mix_seed(self._seed, self._step, self._key_count))
        self._key_count += 1
        return g

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
        ins = {slot: [env[n] for n in names]
               for slot, names in op.inputs.items()}
        prev_op, prev_env = self.op, self.env
        self.op, self.env = op, env
        try:
            outs = opdef.lower(self, ins, op.attrs)
        finally:
            self.op, self.env = prev_op, prev_env
        if outs is None:
            return
        block = op.block
        for slot, names in op.outputs.items():
            if slot not in outs:
                continue
            vals = outs[slot]
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for name, val in zip(names, vals):
                var = block._find_var_recursive(name)
                if (var is not None and var.stop_gradient
                        and not isinstance(var, framework.Parameter)
                        and val.is_floating_point()):
                    val = val.detach()
                env[name] = val


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


def _refuse_later_slices(program, has_backward):
    for attr, what in (("_amp", "AMP (program._amp)"),
                       ("_nan_guard", "the NaN guard (program._nan_guard)")):
        if getattr(program, attr, False):
            raise NotImplementedError(
                f"{what} is a later slice of the torch port (ROADMAP.md "
                "item 'Training': AMP and the NaN guard)")
    if has_backward and program._remat_policy:
        raise NotImplementedError(
            f"remat policy {program._remat_policy!r} (memory_optimize) is "
            "a later slice of the torch port (ROADMAP.md item 'Training': "
            "remat policies as torch.utils.checkpoint)")


def lower_program(program, fetch_names, mode):
    """Builds the step function for a Program.

    Returns ``fn(state, feed, device, seed, step) -> (new_state,
    fetches)`` where ``state`` holds the scope's persistables and
    ``new_state`` every persistable some op of the program wrote.
    ``fn.trains`` is True when the program has a backward marker: the
    step then manages grad mode itself and must not run under
    ``torch.no_grad()`` or ``torch.inference_mode()``.
    """
    gb = program.global_block()
    ops = gb.ops
    bwd_idx = next((i for i, op in enumerate(ops) if op.type == "backward"),
                   None)
    _refuse_later_slices(program, bwd_idx is not None)
    written = written_names(gb)
    persistables = {n for n, v in gb.vars.items() if v.persistable}
    out_names = sorted(persistables & written)
    read = read_names(gb) | set(fetch_names) | persistables

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

    def train_segment(ctx, env):
        leaves = {p: env[p].detach().requires_grad_() for p in param_names}
        fwd = Env()
        fwd.update(env.d)
        fwd.update(leaves)
        with torch.enable_grad():
            for op in ops[:bwd_idx]:
                ctx.eval_op(op, fwd)
            loss = fwd[loss_name].reshape(())
            kept = {n: v for n, v in fwd.d.items()
                    if n in needed_after and n not in leaves}
            del fwd
            if loss.requires_grad:
                grads = torch.autograd.grad(
                    loss, [leaves[p] for p in param_names],
                    allow_unused=True)
            else:
                grads = [None] * len(param_names)
        env.update({n: v.detach() for n, v in kept.items()})
        for p, g in zip(param_names, grads):
            env[framework.grad_var_name(p)] = \
                torch.zeros_like(env[p]) if g is None else g
        with torch.no_grad(), \
                torch.profiler.record_function(RANGE_OPTIMIZER):
            for op in ops[bwd_idx + 1:]:
                ctx.eval_op(op, env)

    def fn(state, feed, device, seed, step):
        ctx = LoweringContext(program, mode, device, seed, step, read)
        env = Env()
        env.update(state)
        env.update(feed)
        if bwd_idx is None:
            for op in ops:
                ctx.eval_op(op, env)
        else:
            train_segment(ctx, env)
        new_state = {n: env.d[n] for n in out_names if n in env.d}
        fetches = [env[n] for n in fetch_names]
        return new_state, fetches

    fn.trains = bwd_idx is not None
    return fn
