"""Program / Block / Operator / Variable graph IR.

Port of ``paddle_tpu/core/framework.py``: the same IR, so a program built
with the port's layers is op for op and name for name the program the
JAX package builds. Only the dtype table (torch dtypes, bfloat16 without
ml_dtypes) and the place ``Program.optimize`` folds constants differ.

Capability parity with Fluid's ProgramDesc stack (reference
paddle/fluid/framework/program_desc.h, block_desc.h, op_desc.h and
python/paddle/fluid/framework.py). A Program lowers op by op onto torch
tensors (see lowering.py).
"""
import contextlib
import itertools
import json

import numpy as np
import torch

from . import unique_name

__all__ = [
    "Program",
    "Block",
    "Variable",
    "Parameter",
    "Operator",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "switch_main_program",
    "switch_startup_program",
    "name_scope",
    "grad_var_name",
]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name):
    return name + GRAD_SUFFIX


_np_dtype = {
    "float16": np.float16,
    "bfloat16": None,  # numpy has no bfloat16; see torch_dtype()
    "float32": np.float32,
    "float64": np.float64,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "uint8": np.uint8,
    "bool": np.bool_,
}


_torch_dtype = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


def torch_dtype(dtype):
    """The torch dtype of a dtype spec (str / np.dtype / torch.dtype)."""
    return _torch_dtype[convert_dtype(dtype)]


def convert_dtype(dtype):
    """Normalize a dtype spec (str / np.dtype / torch.dtype) to a canonical string."""
    if isinstance(dtype, str):
        if dtype not in _np_dtype:
            raise ValueError(f"unsupported dtype {dtype!r}")
        return dtype
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = np.dtype(dtype).name if not hasattr(dtype, "name") else dtype.name
    if name not in _np_dtype:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


class Variable:
    """A named tensor in a Block.

    Mirrors fluid.framework.Variable (reference
    python/paddle/fluid/framework.py Variable class): shape may contain -1
    (unknown/batch dims); ``persistable`` marks scope-resident state;
    ``lod_level > 0`` marks variable-length sequence data, represented on
    TPU as padded dense + lengths (see sequence.py) rather than LoD offsets.
    """

    def __init__(self, block, name, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, lod_level=0,
                 is_data=False, type="lod_tensor"):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_data = is_data
        self.type = type  # lod_tensor | lod_tensor_array | selected_rows

    # ------ fluid-compatible convenience -------------------------------
    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def astype(self, dtype):
        from ..layers import tensor as tensor_layers
        return tensor_layers.cast(self, dtype)

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    __str__ = __repr__

    def to_dict(self):
        return {
            "name": self.name, "shape": self.shape, "dtype": self.dtype,
            "persistable": self.persistable, "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level, "is_data": self.is_data,
            "type": self.type, "kind": "var",
        }


class Parameter(Variable):
    """A trainable persistable Variable (reference
    python/paddle/fluid/framework.py Parameter class)."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 regularizer=None, gradient_clip_attr=None, do_model_average=True,
                 initializer=None, **kw):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable, **kw)
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.do_model_average = do_model_average
        self.initializer = initializer

    def to_dict(self):
        d = super().to_dict()
        d.update(kind="param", trainable=self.trainable)
        return d


class Operator:
    """A single op in a Block.

    Mirrors fluid OpDesc (reference paddle/fluid/framework/op_desc.h):
    ``inputs``/``outputs`` map slot names to lists of variable names;
    ``attrs`` hold static attributes. Sub-blocks for control-flow ops are
    stored directly as Block objects in attrs (key ending in 'block').
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: ([v] if isinstance(v, (str, Variable)) else list(v))
                       for k, v in (inputs or {}).items()}
        self.outputs = {k: ([v] if isinstance(v, (str, Variable)) else list(v))
                        for k, v in (outputs or {}).items()}
        # normalize Variable -> name
        for d in (self.inputs, self.outputs):
            for k, vs in d.items():
                d[k] = [v.name if isinstance(v, Variable) else v for v in vs]
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"

    def to_dict(self):
        def enc(v):
            if isinstance(v, Block):
                return {"__block__": v.idx}
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            if isinstance(v, (np.integer,)):
                return int(v)
            if isinstance(v, (np.floating,)):
                return float(v)
            return v
        return {"type": self.type, "inputs": self.inputs, "outputs": self.outputs,
                "attrs": {k: enc(v) for k, v in self.attrs.items()}}


class Block:
    """An ordered list of Operators plus a symbol table of Variables
    (reference paddle/fluid/framework/block_desc.h)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # ------ variables ---------------------------------------------------
    def create_var(self, name=None, **kw):
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name, shape, dtype="float32", **kw):
        # parameters always live in the global (root) block, like fluid
        gb = self.program.global_block()
        p = Parameter(gb, name, shape, dtype=dtype, **kw)
        gb.vars[name] = p
        self.program._bump()
        return p

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # ------ operators ---------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump()
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump()
        return op

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [op.to_dict() for op in self.ops]}


def collect_op_input_names(op, acc):
    """Add every variable name ``op`` reads to the set ``acc``, descending
    into arbitrarily nested sub-blocks (scan/while/if_else bodies)."""
    for ns in op.inputs.values():
        acc.update(ns)
    for v in op.attrs.values():
        if isinstance(v, Block):
            for sub_op in v.ops:
                collect_op_input_names(sub_op, acc)


class Program:
    """A multi-block computation description — Fluid's ProgramDesc
    (reference paddle/fluid/framework/program_desc.h).

    The Executor builds one step function per (program, version, mode,
    fetch set) (lowering.py), so mutation bumps ``version`` to key that
    cache.
    """

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        # monotonic identity for jit-cache keys: id() can be reused after
        # GC, which would let a new Program hit a stale executable
        self.uid = next(Program._uid_counter)
        self.version = 0
        self.random_seed = 0
        self._is_test = False
        # set by append_backward: names involved in autodiff
        self._backward_info = None
        # set by transpiler.memory_optimize: jax.checkpoint policy name
        self._remat_policy = None
        # set by debugger.enable_nan_guard: per-op is-finite probes
        self._nan_guard = False

    def _bump(self):
        self.version += 1

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    @property
    def num_blocks(self):
        """Block count (reference framework.py Program.num_blocks)."""
        return len(self.blocks)

    def block(self, index):
        """Block by index (reference framework.py Program.block)."""
        return self.blocks[index]

    def create_block(self, parent_idx=None):
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump()
        return b

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx
        self._bump()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    # ------ cloning -----------------------------------------------------
    def to_string(self, throw_on_error=True, with_details=False):
        """Readable pseudo-code listing (fluid Program.to_string;
        rendering in debugger.program_to_code)."""
        from ..debugger import program_to_code
        return program_to_code(self)

    def __str__(self):
        return self.to_string()

    def clone(self, for_test=False):
        """Deep-copies the program. ``for_test=True`` sets ``is_test`` on ops
        that behave differently at inference (dropout, batch_norm), matching
        fluid.Program.clone (reference python/paddle/fluid/framework.py)."""
        import copy
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            p.blocks.append(nb)
        # second pass: ops (sub-block attrs must point into the clone)
        for b, nb in zip(self.blocks, p.blocks):
            for op in b.ops:
                attrs = {}
                for k, v in op.attrs.items():
                    if isinstance(v, Block):
                        attrs[k] = p.blocks[v.idx]
                    else:
                        attrs[k] = copy.copy(v) if isinstance(v, (list, dict)) else v
                if for_test and op.type in _IS_TEST_OPS:
                    attrs["is_test"] = True
                nop = Operator(nb, op.type, None, None, attrs)
                nop.inputs = {k: list(vs) for k, vs in op.inputs.items()}
                nop.outputs = {k: list(vs) for k, vs in op.outputs.items()}
                nb.ops.append(nop)
        p.current_block_idx = 0
        p._is_test = for_test
        p._backward_info = copy.copy(self._backward_info)
        p._remat_policy = self._remat_policy
        p._amp = getattr(self, "_amp", False)
        if for_test:
            p._strip_backward()
        p._bump()
        return p

    def prune(self, feed_names, target_names):
        """Keeps only the ops needed to compute ``target_names`` from
        ``feed_names`` + persistables — Fluid's inference pruning
        (reference paddle/fluid/framework/prune.cc) as a reverse
        liveness walk."""
        p = self.clone(for_test=True)
        gb = p.global_block()
        feeds = set(feed_names)
        needed = set(target_names)
        kept = []
        for op in reversed(gb.ops):
            # feeds are boundaries: an op only kept for producing a fed
            # variable is dead (the value arrives from the feed dict)
            produces = any(n in needed and n not in feeds
                           for ns in op.outputs.values() for n in ns)
            if not produces:
                continue
            kept.append(op)
            collect_op_input_names(op, needed)
        gb.ops = list(reversed(kept))
        # drop persistable declarations no kept op touches (optimizer
        # accumulators, LR step counters): a deployment scope loaded
        # from the pruned artifact has no values for them, and the
        # executor's strict persistable check would otherwise refuse
        # to run the saved model in a fresh process (the serving
        # from_saved_model path). Non-persistable vars keep their
        # declarations — they carry shape/dtype metadata and cost the
        # scope nothing.
        live = needed | feeds
        for op in kept:
            for ns in op.outputs.values():
                live.update(ns)
        gb.vars = {n: v for n, v in gb.vars.items()
                   if not v.persistable or n in live}
        p._bump()
        return p

    def _strip_backward(self):
        """Remove backward + optimizer ops (everything at or after the
        backward marker) — used by clone(for_test=True), mirroring fluid's
        prune of grad ops."""
        gb = self.global_block()
        for i, op in enumerate(gb.ops):
            if op.type == "backward":
                gb.ops = gb.ops[:i]
                break
        self._backward_info = None

    # ------ static analysis --------------------------------------------
    def verify(self, startup_program=None, fetch_list=None,
               feed_names=None, strict=False, level="full"):
        """Runs the static verifier over this program (analysis/) and
        returns the list of Diagnostics — the build-time counterpart of
        the reference's per-op C++ InferShape/InferVarType (reference
        paddle/fluid/framework/shape_inference.h). Never traces or
        compiles anything.

        ``startup_program`` enables the parameter-shape-drift check;
        ``fetch_list`` enables dangling-fetch and dead-op analysis;
        ``strict=True`` raises :class:`analysis.VerifyError` when any
        error-level diagnostic is found; ``level="cheap"`` restricts to
        the structural per-compile subset the Executor uses.
        """
        from ..analysis import verify_program, VerifyError, errors
        diags = verify_program(self, startup=startup_program,
                               fetch_list=fetch_list,
                               feed_names=feed_names, level=level)
        if strict and errors(diags):
            raise VerifyError(diags)
        return diags

    def optimize(self, fetch_list=None, passes=None,
                 collect_cost=False):
        """Runs the numerics-preserving rewrite passes (analysis/
        optimize.py) over this program IN PLACE: constant folding,
        elementwise-chain fusion, common-subexpression elimination,
        and dead-op elimination — all proven against the dataflow
        facts in analysis/dataflow.py and held bit-exact by
        tests/test_torch_optimize.py. ``passes`` selects/orders the
        pipeline
        (default ``("fold", "fuse", "cse", "dce")``; also accepts a
        comma-separated string).

        ``fetch_list`` is the observation contract — the names the
        caller will ever fetch. Without it nothing is provably dead
        (any name could be fetched later) and the call is a no-op.
        Stateful ops, persistable/data writes, and control-flow are
        never touched, so fetch outputs and scope writes are
        bit-identical before and after (enforced by
        tests/test_torch_optimize.py's zoo sweep). Returns an
        :class:`analysis.optimize.OptimizeReport`; mutation bumps
        ``version`` so executor step caches refresh.
        ``collect_cost=True`` records per-pass cost-model deltas in
        the report.

        The constant fold evaluates the port's lowering rules on the
        card when CUDA is available and on the CPU otherwise, as the
        reference evaluates its rules on jax's default backend, so a
        folded value is the card's own bit for bit. The executor's
        ``PADDLE_TPU_OPTIMIZE`` hook and the serving engine fold on
        their own device; ``analysis.optimize_program(..., device=)``
        names the device.

        The executor applies this automatically (to an internal clone,
        never the caller's program) when ``PADDLE_TPU_OPTIMIZE`` is
        on, and the serving engines apply it by default
        (``optimize=True``).
        """
        from ..analysis.optimize import (DEFAULT_PASSES,
                                         optimize_program)
        return optimize_program(self, fetch_list=fetch_list,
                                passes=passes or DEFAULT_PASSES,
                                collect_cost=collect_cost)

    # ------ serialization ----------------------------------------------
    def to_json(self):
        return json.dumps({
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        })

    @staticmethod
    def from_json(text):
        data = json.loads(text)
        p = Program()
        p.random_seed = data.get("random_seed", 0)
        p.blocks = []
        for bd in data["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                kind = vd.pop("kind", "var")
                vd.pop("trainable", None) if kind == "var" else None
                if kind == "param":
                    trainable = vd.pop("trainable", True)
                    v = Parameter(b, vd["name"], vd["shape"], dtype=vd["dtype"],
                                  trainable=trainable,
                                  lod_level=vd.get("lod_level", 0))
                else:
                    v = Variable(b, **{k: vd[k] for k in
                                       ("name", "shape", "dtype", "persistable",
                                        "stop_gradient", "lod_level", "is_data",
                                        "type")})
                b.vars[v.name] = v
            p.blocks.append(b)
        for bd, b in zip(data["blocks"], p.blocks):
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__block__" in v:
                        attrs[k] = p.blocks[v["__block__"]]
                    elif isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
                    else:
                        attrs[k] = v
                op = Operator(b, od["type"], None, None, attrs)
                op.inputs = {k: list(vs) for k, vs in od["inputs"].items()}
                op.outputs = {k: list(vs) for k, vs in od["outputs"].items()}
                b.ops.append(op)
        p._bump()
        return p

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for op in b.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


# ops whose behavior flips at inference time
_IS_TEST_OPS = {"dropout", "batch_norm"}


# ---------------------------------------------------------------------------
# default program management (reference python/paddle/fluid/framework.py)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    old = _main_program
    _main_program = program
    return old


def switch_startup_program(program):
    global _startup_program
    old = _startup_program
    _startup_program = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """Cosmetic name scoping for debugging/visualization (parity with
    fluid.name_scope)."""
    _name_scope_stack.append(prefix or "scope")
    try:
        yield
    finally:
        _name_scope_stack.pop()


def get_var(name, program=None):
    """Look up a variable in a program's global block (reference
    framework.py get_var). A miss raises a KeyError that names the
    program and lists near-miss variable names instead of a bare
    'not found'."""
    if program is None:
        program = default_main_program()
    assert isinstance(name, str)
    gb = program.global_block()
    if name in gb.vars:
        return gb.vars[name]
    import difflib
    near = difflib.get_close_matches(name, list(gb.vars), n=5, cutoff=0.6)
    hint = f"; did you mean: {', '.join(repr(n) for n in near)}?" \
        if near else ""
    raise KeyError(
        f"variable {name!r} not found in the global block of program "
        f"uid={program.uid} ({len(gb.vars)} variables){hint}")
