"""Program → torch lowering (forward only).

Port of ``paddle_tpu/core/lowering.py``. The reference lowers a whole
Program into one pure function that ``jax.jit`` traces; here the same
walk runs eagerly, op by op, on torch tensors that live on the
executor's device. The autodiff segment behind a ``backward`` marker,
AMP casts and the NaN guard arrive with training (ROADMAP.md item
'Training').
"""
import torch

from . import framework
from .registry import get_op

__all__ = ["LoweringContext", "Env", "lower_program", "written_names"]


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

    def __init__(self, program, mode, device, seed, step):
        self.program = program
        self.mode = mode  # "train" | "test"
        self.device = device
        self._seed = seed
        self._step = step
        self._key_count = 0
        self.op = None    # current op (set by eval_op)
        self.env = None   # current env (set by eval_op)

    @property
    def is_test(self):
        return self.mode == "test"

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


def lower_program(program, fetch_names, mode):
    """Builds the step function for a forward-only Program.

    Returns ``fn(state, feed, device, seed, step) -> (new_state,
    fetches)`` where ``state`` holds the scope's persistables and
    ``new_state`` every persistable some op of the program wrote.
    """
    gb = program.global_block()
    ops = gb.ops
    for op in ops:
        if op.type == "backward":
            raise NotImplementedError(
                "the program has a backward marker (append_backward); "
                "training is a later slice of the torch port (ROADMAP.md "
                "item 'Training')")
    for attr in ("_amp", "_nan_guard"):
        if getattr(program, attr, False):
            raise NotImplementedError(
                f"program.{attr} is set; AMP and the NaN guard are a "
                "later slice of the torch port (ROADMAP.md item "
                "'Training')")
    written = written_names(gb)
    out_names = sorted(n for n, v in gb.vars.items()
                       if v.persistable and n in written)

    def fn(state, feed, device, seed, step):
        ctx = LoweringContext(program, mode, device, seed, step)
        env = Env()
        env.update(state)
        env.update(feed)
        for op in ops:
            ctx.eval_op(op, env)
        new_state = {n: env.d[n] for n in out_names if n in env.d}
        fetches = [env[n] for n in fetch_names]
        return new_state, fetches

    return fn
