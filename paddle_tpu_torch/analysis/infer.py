"""Static shape/dtype inference over the Program IR (port of
``paddle_tpu/analysis/infer.py``, the same engine).

The engine propagates symbolic shapes — tuples of ints where ``-1`` is
an unknown (batch) dim, or ``None`` for a fully-unknown shape — and
canonical dtype strings through every Block, including the sub-blocks
of ``while``/``if_else``/scan ops, WITHOUT running anything: this module
never imports torch, so it touches no tensor and no device. It is the
counterpart of Fluid's per-op C++ ``InferShape`` (reference
paddle/fluid/framework/shape_inference.h), re-homed as a standalone pass
so it can run over saved programs too.

Per-op rules live in the op modules next to their lowering rules and
register through ``core.registry.register_infer``; ops without a rule
fall to the conservative "unknown" lattice element (shape None, dtype
from the declared Variable when available, marked unconfident so
downstream passes stay silent about them).
"""
from ..core import framework
from ..core.registry import get_infer

__all__ = ["VarInfo", "InferError", "InferenceResult", "infer_program",
           "UNKNOWN", "dim_prod", "merge_dim"]


class InferError(Exception):
    """A statically-provable shape/dtype contradiction, raised by infer
    rules. The engine converts it into a ``shape-mismatch`` diagnostic
    anchored at the op and continues with unknown outputs."""

    def __init__(self, message, hint=None):
        super().__init__(message)
        self.hint = hint


class VarInfo:
    """What static analysis knows about one variable's value.

    shape      tuple of ints (-1 = unknown dim) or None (unknown rank)
    dtype      canonical dtype string or None
    confident  True when the facts came from trusted seeds (data vars,
               parameters, persistables) through registered rules all
               the way — passes only report contradictions between
               confident facts, so a missing rule can never produce a
               false positive downstream.
    """

    __slots__ = ("shape", "dtype", "lod_level", "confident")

    def __init__(self, shape=None, dtype=None, lod_level=0, confident=False):
        self.shape = tuple(int(s) for s in shape) if shape is not None \
            else None
        self.dtype = dtype
        self.lod_level = lod_level
        self.confident = confident

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def with_shape(self, shape):
        return VarInfo(shape, self.dtype, self.lod_level, self.confident)

    def with_dtype(self, dtype):
        return VarInfo(self.shape, dtype, self.lod_level, self.confident)

    def __repr__(self):
        c = "" if self.confident else "?"
        return f"VarInfo({self.shape}, {self.dtype}{c})"


UNKNOWN = VarInfo()


# ---------------------------------------------------------------------------
# symbolic dim arithmetic (-1 = unknown, propagates)
# ---------------------------------------------------------------------------

def dim_prod(dims):
    p = 1
    for d in dims:
        if d < 0:
            return -1
        p *= d
    return p


def merge_dim(a, b):
    """Join two claims about one dim: unknown yields to known; a known
    conflict raises."""
    if a < 0:
        return b
    if b < 0 or a == b:
        return a
    raise InferError(f"dimension mismatch: {a} vs {b}")


def dims_compatible(a, b):
    return a < 0 or b < 0 or a == b


def broadcast_shapes(xs, ys):
    """Numpy-style broadcast of two symbolic shapes."""
    n = max(len(xs), len(ys))
    xs = (1,) * (n - len(xs)) + tuple(xs)
    ys = (1,) * (n - len(ys)) + tuple(ys)
    out = []
    for a, b in zip(xs, ys):
        if a == 1:
            out.append(b)
        elif b == 1 or a == b:
            out.append(a)
        elif a < 0 or b < 0:
            out.append(-1)
        else:
            raise InferError(f"cannot broadcast shapes {xs} and {ys}")
    return tuple(out)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _Env:
    """block-scoped name → VarInfo with lexical parent chaining, the
    static twin of lowering.Env."""

    __slots__ = ("d", "parent")

    def __init__(self, parent=None):
        self.d = {}
        self.parent = parent

    def get(self, name):
        e = self
        while e is not None:
            if name in e.d:
                return e.d[name]
            e = e.parent
        return None

    def set(self, name, info):
        self.d[name] = info


class InferenceResult:
    """vars: (block_idx, var_name) → VarInfo for every binding the
    engine saw; diagnostics: shape-mismatch findings raised by rules."""

    def __init__(self):
        self.vars = {}
        self.diagnostics = []

    def info(self, block_idx, name):
        """Best-known VarInfo for a name as seen from ``block_idx``
        (falls back to the global block's binding)."""
        v = self.vars.get((block_idx, name))
        if v is None and block_idx != 0:
            v = self.vars.get((0, name))
        return v if v is not None else UNKNOWN


def _seed_info(var, confident):
    shape = var.shape if var.shape is not None else None
    return VarInfo(shape, var.dtype, var.lod_level, confident=confident)


def _declared_fallback(block, name):
    """Unknown-lattice element for an op without a rule: keep the
    declared dtype (layers set it deliberately) but mark unconfident
    and drop the shape (declared shapes of temporaries are None
    anyway)."""
    var = block._find_var_recursive(name)
    if var is None:
        return UNKNOWN
    return VarInfo(var.shape, var.dtype, var.lod_level, confident=False)


def infer_program(program, feed_shapes=None):
    """Runs inference over every block of ``program``.

    ``feed_shapes`` optionally refines data variables: {name: shape}
    with concrete (or -1) dims, e.g. the actual feed a lint wants to
    check against the executor's compile cache.

    Returns an :class:`InferenceResult`. Never raises for a malformed
    program — contradictions become diagnostics.
    """
    from .diagnostics import Diagnostic, ERROR

    result = InferenceResult()
    gb = program.global_block()
    env = _Env()
    for name, var in gb.vars.items():
        seed = var.is_data or var.persistable \
            or isinstance(var, framework.Parameter)
        if seed:
            info = _seed_info(var, confident=var.shape is not None)
            if feed_shapes and name in feed_shapes:
                info = VarInfo(feed_shapes[name], var.dtype,
                               var.lod_level, confident=True)
            env.set(name, info)
            result.vars[(0, name)] = info

    def run_block(block, env):
        for i, op in enumerate(block.ops):
            _infer_op(op, i, block, env)

    def _infer_op(op, op_idx, block, env):
        # sub-blocks (while/if_else/scan bodies) see the outer env;
        # their writes stay local — the op's declared outputs carry
        # results out, and those fall to the rule (or unknown)
        for attr in op.attrs.values():
            if isinstance(attr, framework.Block):
                sub_env = _Env(parent=env)
                for name, var in attr.vars.items():
                    if var.is_data or var.persistable:
                        sub_env.set(name, _seed_info(var, var.shape
                                                     is not None))
                for j, sub_op in enumerate(attr.ops):
                    _infer_op(sub_op, j, attr, sub_env)
                for name, info in sub_env.d.items():
                    result.vars[(attr.idx, name)] = info

        if op.type == "backward":
            # the autodiff marker defines <param>@GRAD with the
            # parameter's own shape/dtype (core/backward.py)
            for p in op.attr("parameter_names") or []:
                pv = env.get(p)
                g = framework.grad_var_name(p)
                info = pv if pv is not None else UNKNOWN
                env.set(g, info)
                result.vars[(block.idx, g)] = info
            return

        ins = {slot: [env.get(n) or _declared_fallback(block, n)
                      for n in names]
               for slot, names in op.inputs.items()}
        rule = get_infer(op.type)
        outs = None
        if rule is not None:
            try:
                outs = rule(op, ins, op.attrs)
            except InferError as e:
                result.diagnostics.append(Diagnostic(
                    ERROR, "shape-mismatch",
                    f"op {op.type!r}: {e}", op_idx=op_idx,
                    block_idx=block.idx, hint=e.hint))
            except Exception as e:  # a rule bug must not kill the pass
                result.diagnostics.append(Diagnostic(
                    "warning", "pass-crashed",
                    f"infer rule for {op.type!r} raised "
                    f"{type(e).__name__}: {e}", op_idx=op_idx,
                    block_idx=block.idx))
        for slot, names in op.outputs.items():
            vals = (outs or {}).get(slot)
            for k, name in enumerate(names):
                if vals is not None and k < len(vals) \
                        and vals[k] is not None:
                    info = vals[k]
                else:
                    info = _declared_fallback(block, name)
                env.set(name, info)
                result.vars[(block.idx, name)] = info

    run_block(gb, env)
    return result


# ---------------------------------------------------------------------------
# rule-building helpers (used by the op modules' colocated rules)
# ---------------------------------------------------------------------------

def first_in(ins, *slots):
    """The first VarInfo present in any of ``slots`` (else UNKNOWN)."""
    for s in slots:
        vs = ins.get(s)
        if vs:
            return vs[0]
    return UNKNOWN


def same_as(info, dtype=None):
    """Output VarInfo shaped like ``info`` (optionally re-dtyped)."""
    return VarInfo(info.shape, dtype or info.dtype, info.lod_level,
                   confident=info.confident)


def passthrough(mapping):
    """Infer rule factory: each output slot mirrors the named input slot
    — the shape of every optimizer update op (ParamOut ≡ Param...)."""
    def rule(op, ins, attrs):
        return {out_slot: [same_as(first_in(ins, in_slot))]
                for out_slot, in_slot in mapping.items()}
    return rule
