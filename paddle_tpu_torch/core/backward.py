"""append_backward — functional autodiff over the Program.

Port of ``paddle_tpu/core/backward.py``; capability parity with
python/paddle/fluid/backward.py append_backward. Fluid walks the op list
emitting per-op grad OpDescs (via each op's GradOpDescMaker); here, as
in the reference, a single ``backward`` marker op is recorded. The
executor's lowering (lowering.py) runs the forward segment with the
marked parameters requiring grad and binds ``torch.autograd.grad``'s
results to the ``<param>@GRAD`` names.
"""
from . import framework

__all__ = ["append_backward"]


_WHILE_ERR = (
    "append_backward cannot differentiate through the 'while' op: "
    "without max_iters it is a host loop that reads its condition "
    "back each turn, with a trip count the step does not fix, and "
    "autograd cannot replay it. Construct the loop as "
    "fluid.layers.While(cond, max_iters=N) — it then runs exactly N "
    "masked steps (those after the exit keep the carry) and is "
    "differentiable — or express the recurrence with "
    "StaticRNN/DynamicRNN (a loop over the padded time axis, always "
    "trainable).")


def _check_whiles_differentiable(gb, loss_name):
    """Backward slice of the global block: reverse-walk ops collecting
    the names the loss depends on; any unbounded while on that path
    (including whiles nested in a reached while's sub_block) raises."""
    def _sub_whiles_ok(block):
        for op in block.ops:
            if op.type == "while":
                if not int(op.attr("max_iters") or 0):
                    raise RuntimeError(_WHILE_ERR)
                _sub_whiles_ok(op.attr("sub_block"))
            else:
                sub = op.attrs.get("sub_block")
                if sub is not None:
                    _sub_whiles_ok(sub)

    needed = {loss_name}
    for op in reversed(gb.ops):
        outs = {n for ns in op.outputs.values() for n in ns}
        if not (outs & needed):
            continue
        for ns in op.inputs.values():
            needed.update(ns)
        if op.type == "while":
            if not int(op.attr("max_iters") or 0):
                raise RuntimeError(_WHILE_ERR)
            _sub_whiles_ok(op.attr("sub_block"))


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Marks the program for autodiff of ``loss`` w.r.t. its trainable
    parameters and creates the ``<param>@GRAD`` variables.

    Returns a list of (parameter, gradient_variable) tuples, like fluid.
    """
    program = loss.block.program
    gb = program.global_block()
    if any(op.type == "backward" for op in gb.ops):
        raise RuntimeError("append_backward called twice on this program")

    if parameter_list is not None:
        params = []
        for p in parameter_list:
            name = p.name if isinstance(p, framework.Variable) else p
            params.append(gb.var(name))
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    no_grad = {v.name if isinstance(v, framework.Variable) else v
               for v in (no_grad_set or set())}
    params = [p for p in params if p.name not in no_grad]

    # Differentiating across a data-dependent While needs a bounded
    # tape (the reference's WhileGradOp, while_op.cc:101, replays a
    # recorded trip count). While(max_iters=N) is bounded and
    # differentiable; a While ON THE LOSS PATH without the hint fails
    # loudly HERE, at append_backward time, as in the JAX package.
    # Whiles whose outputs never reach the loss (e.g. a decode loop
    # fetched only for logging) are fine.
    _check_whiles_differentiable(gb, loss.name)

    params_grads = []
    for p in params:
        gname = framework.grad_var_name(p.name)
        g = gb.create_var(name=gname, shape=p.shape, dtype=p.dtype,
                          stop_gradient=True)
        params_grads.append((p, g))

    gb.append_op(
        type="backward",
        inputs={"Loss": [loss.name]},
        attrs={"parameter_names": [p.name for p in params]})
    program._backward_info = {
        "loss": loss.name,
        "parameters": [p.name for p in params],
    }
    return params_grads
