"""Control-flow op lowering rules: ``while``, ``if_else``,
``select_input``, ``print``, ``is_empty`` and the tensor arrays.

Port of ``paddle_tpu/ops/control_flow.py`` (capability parity with
paddle/fluid/operators/{while_op, conditional_block_op}.cc). The
reference lowers its sub-blocks into ``lax.while_loop`` / ``lax.cond``
inside one compiled program; here a sub-block is evaluated eagerly by
the lowering context (``LoweringContext.eval_block``) in a child
``Env``, and the loop or the branch is a Python loop or branch on the
host:

- ``while`` with ``max_iters > 0`` runs exactly ``max_iters`` body
  evaluations and freezes the carry with ``torch.where(live, new, old)``
  once the condition is false — the reference's bounded ``lax.scan``
  step for step, so values and gradients agree, the NaN hazard of a
  dead body included (``layers.While``). It never reads the condition
  back to the host.
- ``while`` without ``max_iters`` reads the condition back to the host
  each turn, as ``lax.while_loop`` tests it each turn.
- ``if_else`` reads its scalar condition back and evaluates one branch,
  as ``lax.cond`` does.

Tensor arrays are Python lists of tensors, as in the reference.
"""
import torch

from ..core.registry import register_op


def _scalar_bool(v):
    return v.reshape(()).to(torch.bool)


@register_op("while")
def _while(ctx, ins, attrs):
    """attrs: sub_block, condition (var name), carry_names (vars the body
    updates that live on after the loop), max_iters. The body must
    recompute the condition variable each iteration."""
    from ..core.lowering import Env

    sub_block = attrs["sub_block"]
    cond_name = attrs["condition"]
    carry_names = list(attrs["carry_names"])
    outer_env = ctx.env
    carries = [outer_env[n] for n in carry_names]
    cond = outer_env[cond_name]

    def body(cond, carries):
        env = Env(parent=outer_env)
        for n, v in zip(carry_names, carries):
            env[n] = v
        env[cond_name] = cond
        ctx.eval_block(sub_block, env)
        return env[cond_name], [env[n] for n in carry_names]

    max_iters = int(attrs.get("max_iters", 0) or 0)
    if max_iters > 0:
        # bounded and differentiable: every step runs the body, and a
        # step after the exit keeps the carry (the body still runs on
        # the frozen carry; only its result is discarded)
        for _ in range(max_iters):
            live = _scalar_bool(cond)
            new_cond, new = body(cond, carries)
            carries = [torch.where(live, nv, ov)
                       for nv, ov in zip(new, carries)]
            cond = (live & _scalar_bool(new_cond)).reshape(
                cond.shape).to(cond.dtype)
    else:
        while bool(_scalar_bool(cond)):
            cond, carries = body(cond, carries)
    return {"Out": carries, "Condition": [cond]}


@register_op("if_else")
def _if_else(ctx, ins, attrs):
    """attrs: true_block, false_block, out_names (vars both branches
    write). The scalar condition picks the branch on the host."""
    from ..core.lowering import Env

    take = bool(_scalar_bool(ins["Cond"][0]))
    env = Env(parent=ctx.env)
    ctx.eval_block(attrs["true_block" if take else "false_block"], env)
    return {"Out": [env[n] for n in attrs["out_names"]]}


@register_op("select_input")
def _select_input(ctx, ins, attrs):
    mask = ins["Mask"][0].reshape(1).to(torch.int64)
    stacked = torch.stack(ins["X"], dim=0)
    return {"Out": [torch.index_select(stacked, 0, mask)[0]]}


@register_op("print")
def _print(ctx, ins, attrs):
    x = ins["X"][0]
    print(f"{attrs.get('message', '')} {x.detach().cpu().numpy()}")
    return {"Out": [x]}


@register_op("is_empty")
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    x = getattr(x, "data", x)
    return {"Out": [torch.tensor([x.numel() == 0], device=x.device)]}


@register_op("write_to_array")
def _write_to_array(ctx, ins, attrs):
    """Appends X to the array its output names (the reference's order:
    the index input is not read)."""
    arr = ctx.env.get(ctx.op.output("Out")[0])
    return {"Out": [(list(arr) if arr is not None else [])
                    + [ins["X"][0]]]}


@register_op("read_from_array")
def _read_from_array(ctx, ins, attrs):
    """The I-th entry of the stacked array (an index past either end
    clamps, as ``lax.dynamic_index_in_dim`` does)."""
    stacked = torch.stack(ins["X"][0], dim=0)
    i = ins["I"][0].reshape(1).to(torch.int64).clamp(0, stacked.shape[0] - 1)
    return {"Out": [torch.index_select(stacked, 0, i)[0]]}
