"""Fused optimizer updates (port of
``paddle_tpu/transpiler/fuse_optimizer.py``) — collapse per-parameter
update ops.

A convnet-scale program carries hundreds of small parameters (ResNet-50:
161 counting BN scales/shifts), and each per-parameter update op is
several small kernels and their host launches. This pass rewrites each
group of same-type / same-hyperparameter update ops into

    flatten_concat(grads)  -> flat_grad
    flatten_concat(params) -> flat_param
    <update>(flat_param, flat_grad, flat_state)
    fused_param_split(flat_param_out) -> params (one slice per param)

with the optimizer STATE (velocity / moment) living permanently as one
flat buffer per group — it is never split back. The update formulas are
elementwise, so the fused form computes bit-identical parameter values.

Usage::

    fluid.optimizer.Momentum(...).minimize(loss)
    from paddle_tpu_torch.transpiler import fuse_optimizer_ops
    fuse_optimizer_ops(fluid.default_main_program(),
                       fluid.default_startup_program())

The rewrite is pure IR and copied from the reference unchanged.
"""

import numpy as np

from ..core import framework, unique_name

__all__ = ["fuse_optimizer_ops"]

# op type -> param-shaped state slots [(in, out)...] and pass-through
# scalar inputs shared across the group (adam's beta-pow accumulators
# are ONE [1] pair for every param already — optimizer.py)
_FUSABLE = {
    "sgd": {"state": (), "extra": ()},
    "momentum": {"state": (("Velocity", "VelocityOut"),), "extra": ()},
    "adagrad": {"state": (("Moment", "MomentOut"),), "extra": ()},
    "adam": {"state": (("Moment1", "Moment1Out"),
                       ("Moment2", "Moment2Out")),
             "extra": ("Beta1Pow", "Beta2Pow")},
}


def _size(shape):
    return int(np.prod([int(s) for s in shape])) if shape else 1


def fuse_optimizer_ops(program, startup_program, min_group=2):
    """Rewrites ``program`` in place (and appends the fused-state
    initializer to ``startup_program``). Groups update ops by
    (type, learning-rate var, dtype, attrs); sharded parameters keep
    their individual ops (their state shards with them). Returns the
    number of groups fused."""
    gb = program.global_block()
    sb = startup_program.global_block()

    groups = {}
    for i, op in enumerate(gb.ops):
        if op.type not in _FUSABLE:
            continue
        pname = op.input("Param")[0]
        pvar = gb.var(pname)
        if getattr(pvar, "sharding", None) is not None:
            continue
        spec = _FUSABLE[op.type]
        attr_key = tuple(sorted((k, repr(v)) for k, v in op.attrs.items()))
        state_dtypes = tuple(str(gb.var(op.input(sin)[0]).dtype)
                             for sin, _ in spec["state"])
        extra_key = tuple(op.input(e)[0] for e in spec["extra"])
        key = (op.type, op.input("LearningRate")[0], str(pvar.dtype),
               state_dtypes, extra_key, attr_key)
        groups.setdefault(key, []).append((i, op))

    fused = 0
    replaced = {}          # first-op index -> list of replacement ops
    dead = set()           # op indices to drop
    dead_state = set()     # per-param state var names now unused
    for (op_type, lr_name, dtype, state_dtypes, extra_key, _), \
            members in groups.items():
        if len(members) < min_group:
            continue
        spec = _FUSABLE[op_type]
        params = [op.input("Param")[0] for _, op in members]
        if len(set(params)) != len(params):
            # the same param updated twice in one group (e.g. one
            # optimizer minimize()d on two losses sharing weights):
            # the originals apply sequentially, but a fused group would
            # read one pre-update snapshot and let the last split-write
            # win — keep the individual ops
            continue
        grads = [op.input("Grad")[0] for _, op in members]
        shapes = [[int(s) for s in gb.var(p).shape] for p in params]
        total = sum(_size(s) for s in shapes)
        attrs = dict(members[0][1].attrs)

        def tmp(tag):
            return gb.create_var(
                name=unique_name.generate(f"fused_opt_{tag}"),
                shape=[total], dtype=dtype, persistable=False,
                stop_gradient=True)

        fg, fp, fp_out = tmp("grad"), tmp("param"), tmp("param_out")
        seq = [
            framework.Operator(gb, "flatten_concat", {"X": grads},
                               {"Out": [fg.name]}, {}),
            framework.Operator(gb, "flatten_concat", {"X": params},
                               {"Out": [fp.name]}, {}),
        ]
        upd_inputs = {"Param": [fp.name], "Grad": [fg.name],
                      "LearningRate": [lr_name]}
        upd_outputs = {"ParamOut": [fp_out.name]}
        for (state_in, state_out), sdt in zip(spec["state"],
                                              state_dtypes):
            facc_name = unique_name.generate(
                f"fused_{state_in.lower()}")
            gb.create_var(name=facc_name, shape=[total], dtype=sdt,
                          persistable=True, stop_gradient=True)
            sv = sb.create_var(name=facc_name, shape=[total],
                               dtype=sdt, persistable=True,
                               stop_gradient=True)
            sb.append_op(type="fill_constant", inputs={},
                         outputs={"Out": [sv.name]},
                         attrs={"shape": [total], "dtype": sdt,
                                "value": 0.0})
            upd_inputs[state_in] = [facc_name]
            upd_outputs[state_out] = [facc_name]       # in-place
            for _, op in members:
                dead_state.add(op.input(state_in)[0])
        for slot, name in zip(spec["extra"], extra_key):
            upd_inputs[slot] = [name]    # shared scalars pass through
        seq.append(framework.Operator(gb, op_type, upd_inputs,
                                      upd_outputs, attrs))
        seq.append(framework.Operator(
            gb, "fused_param_split", {"X": [fp_out.name]},
            {"Out": params}, {"shapes": shapes}))
        first = members[0][0]
        replaced[first] = seq
        dead.update(i for i, _ in members)
        fused += 1

    if not fused:
        return 0

    new_ops = []
    for i, op in enumerate(gb.ops):
        if i in replaced:
            new_ops.extend(replaced[i])
        elif i not in dead:
            new_ops.append(op)
    gb.ops = new_ops

    # the per-param state vars are fully replaced by the flat buffer:
    # drop their declarations and startup initializers, or they would
    # linger as persistables with no value (strict _prepare rejects
    # that) and waste a param-sized buffer each
    sb.ops = [op for op in sb.ops
              if not (set().union(*op.outputs.values()) & dead_state)]
    for name in dead_state:
        gb.vars.pop(name, None)
        sb.vars.pop(name, None)
    program._bump()
    startup_program._bump()
    return fused
