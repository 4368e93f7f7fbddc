"""Control-flow layers (port of ``paddle_tpu/layers/control_flow.py``).

Parity with python/paddle/fluid/layers/control_flow.py: While, Switch,
IfElse, StaticRNN, DynamicRNN, increment, compare ops, tensor arrays,
Print, is_empty. The program they build is the reference's op for op;
its sub-blocks run as host loops and branches over torch tensors (see
ops/control_flow.py, ops/rnn.py).
"""
import contextlib

from ..core.lowering import written_names
from ..layer_helper import LayerHelper
from . import tensor as tensor_layers

__all__ = ["While", "Switch", "IfElse", "StaticRNN", "DynamicRNN",
           "increment", "array_write", "create_array", "array_read",
           "array_length", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "is_empty", "Print",
           "reorder_lod_tensor_by_rank", "ParallelDo"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        shape=x.shape)
    helper.append_op(type="increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"step": float(value)})
    return out


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference(
            "bool", shape=x.shape, stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference(
            "bool", shape=[1], stop_gradient=True)
    helper.append_op(type="is_empty", inputs={"X": [x.name]},
                     outputs={"Out": [cond.name]})
    return cond


def Print(input, first_n=-1, message=None, summarize=-1, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True,
          print_tensor_lod=True, print_phase="both"):
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="print", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"message": message or input.name})
    return out


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------


class While:
    """fluid.layers.While — data-dependent loop: a host loop that reads
    the condition back each turn.

    The loop body must update ``cond``. Variables written inside the body
    that exist outside become the loop carry automatically.

    **Training through the loop** (the reference's WhileGradOp,
    paddle/fluid/operators/while_op.cc:101): a loop whose trip count the
    step does not fix cannot be differentiated. Pass ``max_iters`` to
    run it BOUNDED instead: exactly ``max_iters`` body evaluations run,
    iterations after the condition goes false keep the carry unchanged
    (masked update), the condition is never read back, and the whole
    loop is differentiable. ``append_backward`` raises a clear error if
    it meets a While without this hint. Note: a trainable accumulator carried by the loop must
    have ``stop_gradient = False`` — ``fill_constant`` (the usual
    initializer) marks its output stop_gradient like the reference, and
    an in-loop ``assign`` into such a var severs the chain.

    With ``max_iters`` the body still EXECUTES (result discarded) on
    the frozen carry after the condition goes false, so it must stay
    numerically finite there: an op that divides by a counter that has
    reached zero (or logs a value shrunk to 0) produces NaN in the dead
    branch, and the masking ``where``'s gradient then propagates NaN
    backward even though the forward value is correct. Guard such
    denominators inside the body (``elementwise_max`` with a floor, or
    a ``cond``-selected safe operand).
    """

    def __init__(self, cond, is_test=False, name=None, max_iters=None):
        self.cond_var = cond
        self.max_iters = max_iters
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
            written = written_names(sub_block)
            carry = sorted(n for n in written
                           if parent_block.has_var(n)
                           and not sub_block.has_var_local(n)
                           and n != self.cond_var.name)
            parent_block.append_op(
                type="while",
                inputs={"X": carry + [self.cond_var.name]},
                outputs={"Out": carry, "Condition": [self.cond_var.name]},
                attrs={"sub_block": sub_block,
                       "condition": self.cond_var.name,
                       "carry_names": carry,
                       "max_iters": int(self.max_iters or 0)})


# ---------------------------------------------------------------------------
# Switch / IfElse
# ---------------------------------------------------------------------------


class Switch:
    """fluid.layers.Switch — chained conditional assignment. Cases build
    nested if_else ops; used mainly for LR schedules."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []          # (cond_var_or_None, sub_block)

    @contextlib.contextmanager
    def case(self, condition):
        program = self.helper.main_program
        sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
            self._cases.append((condition, sub_block))

    @contextlib.contextmanager
    def default(self):
        program = self.helper.main_program
        sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
            self._cases.append((None, sub_block))

    @contextlib.contextmanager
    def block(self):
        try:
            yield self
        finally:
            self._finalize()

    def _finalize(self):
        program = self.helper.main_program
        parent = program.current_block()
        # out vars: union of written names existing in parent
        written = set()
        for _, b in self._cases:
            written |= written_names(b)
        outs = sorted(n for n in written if parent.has_var(n))
        # lower as a chain of if_else ops, last default as else
        default_block = None
        chain = []
        for cond, b in self._cases:
            if cond is None:
                default_block = b
            else:
                chain.append((cond, b))
        if default_block is None:
            default_block = program.create_block()
            program.rollback()
        # build nested: evaluate conditions in order
        self._emit(parent, chain, default_block, outs)

    def _emit(self, parent, chain, default_block, outs):
        program = self.helper.main_program
        if not chain:
            # a Switch with only a default case runs it unconditionally:
            # inline the default block into the parent
            if default_block is not None and default_block.ops:
                for name, var in default_block.vars.items():
                    if not parent.has_var(name):
                        parent.vars[name] = var
                parent.ops.extend(default_block.ops)
                default_block.ops = []
            return
        cond, blk = chain[0]
        if len(chain) == 1:
            false_blk = default_block
        else:
            # wrap the remaining chain in a synthetic block
            false_blk = program.create_block()
            program.rollback()
            self._emit(false_blk, chain[1:], default_block, outs)
        parent.append_op(
            type="if_else",
            inputs={"Cond": [cond.name],
                    "X": outs},
            outputs={"Out": outs},
            attrs={"true_block": blk, "false_block": false_blk,
                   "out_names": outs})


class IfElse:
    """fluid.layers.IfElse (reference control_flow.py). Both branches must
    produce the same outputs; one if_else op, whose scalar condition
    picks the branch that runs."""

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.cond = cond
        self.helper = LayerHelper("ifelse", name=name)
        self._blocks = {}
        self._outputs = {}

    @contextlib.contextmanager
    def true_block(self):
        yield from self._branch(True)

    @contextlib.contextmanager
    def false_block(self):
        yield from self._branch(False)

    def _branch(self, is_true):
        program = self.helper.main_program
        sub_block = program.create_block()
        self._current = is_true
        try:
            yield
        finally:
            program.rollback()
            self._blocks[is_true] = sub_block

    def input(self, x):
        return x

    def output(self, *outs):
        self._outputs[self._current] = [o.name for o in outs]

    def __call__(self):
        program = self.helper.main_program
        parent = program.current_block()
        t_names = self._outputs.get(True, [])
        f_names = self._outputs.get(False, [])
        if len(t_names) != len(f_names):
            raise ValueError("IfElse branches must output the same arity")
        outs = []
        out_pairs = list(zip(t_names, f_names))
        # create result vars; sub-blocks assign branch-local names, so emit
        # per-branch assign into a common name
        tb, fb = self._blocks[True], self._blocks[False]
        common = []
        for tn, fn in out_pairs:
            tvar = tb._find_var_recursive(tn) or parent.var(tn)
            res = parent.create_var(
                name=self.helper.name + "_out_" + tn,
                dtype=tvar.dtype, shape=tvar.shape)
            tb.append_op(type="assign", inputs={"X": [tn]},
                         outputs={"Out": [res.name]})
            fb.append_op(type="assign", inputs={"X": [fn]},
                         outputs={"Out": [res.name]})
            common.append(res.name)
            outs.append(res)
        parent.append_op(
            type="if_else",
            inputs={"Cond": [self.cond.name], "X": []},
            outputs={"Out": common},
            attrs={"true_block": tb, "false_block": fb,
                   "out_names": common})
        return outs


# ---------------------------------------------------------------------------
# StaticRNN / DynamicRNN
# ---------------------------------------------------------------------------


class StaticRNN:
    """Unrolled-over-time RNN builder (reference control_flow.py
    StaticRNN), built as one `scan` op.

    with rnn.step():
        x_t = rnn.step_input(x)         # x: [batch, T, D] dense var
        h = rnn.memory(shape=[-1, H], batch_ref=x)
        h_new = some_layers(x_t, h)
        rnn.update_memory(h, h_new)
        rnn.step_output(h_new)
    out = rnn()                          # [batch, T, H]
    """

    def __init__(self, name=None, masked=False):
        self.helper = LayerHelper("static_rnn", name=name)
        self._sub_block = None
        self._seq_vars = []      # (outer var, inner var)
        self._memories = []      # [inner_in, init_var, inner_out]
        self._outputs = []       # inner vars to collect
        self._built = False
        self._masked = masked

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        self._sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
            self._build()

    def step_input(self, x):
        if x.lod_level > 0:
            # lod metadata is flattened [N, D]; time stays implicit
            shape = list(x.shape)
        else:
            shape = [x.shape[0]] + list(x.shape[2:])
        inner = self._sub_block.create_var(
            name=self.helper.name + "_x_" + x.name,
            dtype=x.dtype, shape=shape)
        self._seq_vars.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=0):
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape, batch_ref)")
            # init ops belong to the parent block (they run once, before
            # the scan), so step out of the sub-block while emitting them
            program = self.helper.main_program
            saved = program.current_block_idx
            program.current_block_idx = self._parent_block.idx
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=batch_ref, shape=list(shape), dtype="float32",
                    value=init_value, input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=init_batch_dim_idx)
            finally:
                program.current_block_idx = saved
        inner = self._sub_block.create_var(
            name=self.helper.name + "_mem_" + init.name,
            dtype=init.dtype, shape=init.shape)
        self._memories.append([inner, init, None])
        return inner

    def update_memory(self, mem, var):
        for rec in self._memories:
            if rec[0] is mem:
                rec[2] = var
                return
        raise ValueError("update_memory on unknown memory")

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _build(self):
        if any(rec[2] is None for rec in self._memories):
            raise ValueError("every memory needs update_memory")
        parent = self._parent_block
        outs = []
        for o in self._outputs:
            ov = parent.create_var(
                name=self.helper.name + "_out_" + o.name, dtype=o.dtype,
                shape=[o.shape[0], -1] + list(o.shape[1:]),
                lod_level=1 if self._masked else 0)
            outs.append(ov)
        finals = []
        for inner_in, init, inner_out in self._memories:
            fv = parent.create_var(
                name=self.helper.name + "_final_" + inner_in.name,
                dtype=init.dtype, shape=init.shape)
            finals.append(fv)
        parent.append_op(
            type="scan",
            inputs={"X": [x.name for x, _ in self._seq_vars],
                    "Init": [rec[1].name for rec in self._memories]},
            outputs={"Out": [o.name for o in outs],
                     "FinalState": [f.name for f in finals]},
            attrs={"sub_block": self._sub_block,
                   "x_names": [inner.name for _, inner in self._seq_vars],
                   "state_in_names": [rec[0].name for rec in self._memories],
                   "state_out_names": [rec[2].name for rec in self._memories],
                   "out_names": [o.name for o in self._outputs],
                   "masked": self._masked})
        self._collected = outs
        self._finals = finals
        self._built = True

    def __call__(self, *args):
        if not self._built:
            raise RuntimeError("use `with rnn.step():` first")
        if len(self._collected) == 1:
            return self._collected[0]
        return self._collected


class DynamicRNN(StaticRNN):
    """Variable-length RNN builder (reference control_flow.py DynamicRNN):
    same scan lowering with per-row masking from the SequenceBatch
    lengths, freezing finished sequences."""

    def __init__(self, name=None):
        super().__init__(name=name, masked=True)

    @contextlib.contextmanager
    def block(self):
        with self.step():
            yield


def create_array(dtype):
    """TensorArray variable (lod_tensor_array). Values are python lists of
    tensors when the program runs; inside loops use StaticRNN/DynamicRNN
    collected outputs instead."""
    helper = LayerHelper("array")
    return helper.block.create_var(
        name=helper.name, dtype=dtype, type="lod_tensor_array")


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x.name], "I": [i.name]},
                     outputs={"Out": [array.name]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="read_from_array",
                     inputs={"X": [array.name], "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", shape=[1],
                                                    stop_gradient=True)
    helper.append_op(type="lod_array_length", inputs={"X": [array.name]},
                     outputs={"Out": [out.name]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """No-op under the padded representation: rows are independent and
    never length-sorted (the reference reorders for batch-packing,
    reference reorder_lod_tensor_by_rank_op.cc)."""
    return x


def ParallelDo(places=None, use_nccl=False, name=None):
    raise NotImplementedError(
        "ParallelDo was deprecated in the reference too; use "
        "fluid.ParallelExecutor (mesh data parallelism)")
