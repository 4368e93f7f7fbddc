"""Learning-rate schedulers (port of
``paddle_tpu/layers/learning_rate_scheduler.py``; parity with
python/paddle/fluid/layers/learning_rate_scheduler.py): each returns a
Variable computed from the global step counter each executor run, by
ops of the step itself — the counter's ``increment`` is prepended to
the program, so the forward segment computes the step's rate before the
optimizer reads it.
"""
from ..layer_helper import LayerHelper
from ..core import framework
from . import tensor, ops, nn

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "append_LARS"]


def _global_step():
    return nn.autoincreased_step_counter(counter_name="@LR_DECAY_COUNTER@",
                                         begin=0, step=1)


def _as_float(step):
    return tensor.cast(step, "float32")


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) (reference
    learning_rate_scheduler.py noam_decay; used by Transformer)."""
    step = _as_float(_global_step())
    step = ops.elementwise_max(
        step, tensor.fill_constant([1], "float32", 1.0))
    a = ops.pow(step, factor=-0.5)
    b = ops.elementwise_mul(
        step, tensor.fill_constant([1], "float32", warmup_steps ** -1.5))
    lr = ops.scale(ops.elementwise_min(a, b), scale=d_model ** -0.5)
    return lr


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _as_float(_global_step())
    div = ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    factor = ops.elementwise_pow(
        tensor.fill_constant([1], "float32", decay_rate), div)
    return ops.scale(factor, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _as_float(_global_step())
    div = ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    factor = ops.exp(ops.scale(div, scale=-decay_rate))
    return ops.scale(factor, scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _as_float(_global_step())
    div = ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    denom = ops.scale(div, scale=decay_rate, bias=1.0)
    return ops.elementwise_div(
        tensor.fill_constant([1], "float32", float(learning_rate)), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _as_float(_global_step())
    if cycle:
        one = tensor.fill_constant([1], "float32", 1.0)
        div = ops.elementwise_max(
            ops.ceil(ops.scale(step, scale=1.0 / decay_steps)), one)
        decay_steps_var = ops.scale(div, scale=float(decay_steps))
        ratio = ops.elementwise_div(step, decay_steps_var)
    else:
        capped = ops.elementwise_min(
            step, tensor.fill_constant([1], "float32", float(decay_steps)))
        ratio = ops.scale(capped, scale=1.0 / decay_steps)
    base = ops.scale(ratio, scale=-1.0, bias=1.0)
    factor = ops.pow(base, factor=power)
    return ops.scale(factor,
                     scale=float(learning_rate) - float(end_learning_rate),
                     bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """Piecewise-constant schedule: selects values[i] on the segment the
    step falls into. Branch-free: a sum of indicator masks."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("len(values) must be len(boundaries)+1")
    step = _as_float(_global_step())
    lr = tensor.fill_constant([1], "float32", float(values[-1]))
    prev = None
    for i, b in enumerate(boundaries):
        below = tensor.cast(
            ops.logical_not(_ge(step, float(b))), "float32")
        if prev is not None:
            seg = ops.elementwise_sub(below, prev)
        else:
            seg = below
        lr = ops.elementwise_add(
            lr, ops.scale(seg, scale=float(values[i]) - float(values[-1])))
        prev = below
    return lr


def _ge(x, const):
    helper = LayerHelper("ge_const")
    c = tensor.fill_constant([1], "float32", const)
    out = helper.create_variable_for_type_inference("bool", shape=x.shape,
                                                    stop_gradient=True)
    helper.append_op(type="greater_equal",
                     inputs={"X": [x.name], "Y": [c.name]},
                     outputs={"Out": [out.name]})
    return out


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rate scaling (reference
    learning_rate_scheduler.py append_LARS)."""
    helper = LayerHelper("lars")
    if not isinstance(learning_rate, framework.Variable):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    outs = []
    for p, g in params_grads:
        p_norm = helper.create_variable_for_type_inference("float32", [1],
                                                           stop_gradient=True)
        g_norm = helper.create_variable_for_type_inference("float32", [1],
                                                           stop_gradient=True)
        block = p.block.program.global_block()
        block.append_op(type="squared_l2_norm", inputs={"X": [p.name]},
                        outputs={"Out": [p_norm.name]})
        block.append_op(type="squared_l2_norm", inputs={"X": [g.name]},
                        outputs={"Out": [g_norm.name]})
        p_n = ops.sqrt(p_norm)
        g_n = ops.sqrt(g_norm)
        denom = ops.elementwise_add(
            g_n, ops.scale(p_n, scale=float(weight_decay)))
        ratio = ops.elementwise_div(
            ops.elementwise_mul(p_n, learning_rate), denom)
        outs.append(ratio)
    return outs
