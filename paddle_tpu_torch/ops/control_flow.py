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

While ``torch.export`` traces the step (``LoweringContext.for_export``,
io/aot.py) nothing is read back: the unbounded ``while`` is torch's
``while_loop`` over (condition, carries) and ``if_else`` is
``torch.cond`` on the scalar condition, each body evaluated by a fork of
the context (:meth:`LoweringContext.fork`) and handing back fresh
tensors. They take what ``lax.while_loop`` and ``lax.cond`` take: a
carry of one shape and dtype every turn, branches whose outputs agree in
shape and dtype (torch's ``cond`` may also take outputs that differ only
in a size, which it makes a symbol). Any other form raises a ValueError
naming F14 and its cause (ROADMAP.md §3).

Tensor arrays are Python lists of tensors, as in the reference.
"""
import torch

from ..core.registry import register_op

_F14 = "(ROADMAP.md §3, F14)"


def _scalar_bool(v):
    return v.reshape(()).to(torch.bool)


def untraceable(what, cause):
    """The ValueError of a control-flow or recurrent form that no
    higher-order op of torch takes, naming F14 and ``cause``."""
    return ValueError(f"{what} cannot export: {cause} {_F14}")


def export_call(what, fn, args, diagnose):
    """``fn(*args)`` — a higher-order op while the step is exported —
    with its failure a ValueError naming F14 and the cause:
    ``diagnose()`` runs the op's body once outside it and raises
    :func:`untraceable` for a form the op does not take (torch's error
    does not carry an exception the body raised in every version);
    failing that, torch's own first lines."""
    try:
        return fn(*args)
    except Exception as e:                        # noqa: BLE001
        try:
            diagnose()
        except ValueError as found:
            if str(found).endswith(_F14):
                raise found from e
        except Exception:                         # noqa: BLE001
            pass        # the body fails outside the op too: torch says why
        lines = str(e).strip().splitlines() or [type(e).__name__]
        raise untraceable(what, " ".join(ln.strip()
                                         for ln in lines[:3])) from e


def same_meta(what, names, old, new):
    """Raises :func:`untraceable` for the first carry of ``new`` whose
    shape or dtype differs from ``old``'s (a tensor array is neither)."""
    for n, o, v in zip(names, old, new):
        if isinstance(v, list) or isinstance(o, list):
            raise untraceable(what, f"carry {n} is a tensor array, which "
                              "grows in the carry")
        if v.dtype != o.dtype or list(v.shape) != list(o.shape):
            raise untraceable(what, f"carry {n} changes from {o.dtype} "
                              f"{list(o.shape)} to {v.dtype} "
                              f"{list(v.shape)} between turns")


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

    def body(cond, carries, run=ctx):
        env = Env(parent=outer_env)
        for n, v in zip(carry_names, carries):
            env[n] = v
        env[cond_name] = cond
        run.eval_block(sub_block, env)
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
    elif ctx.for_export:
        cond, carries = _export_while(ctx, body, cond, carry_names, carries)
    else:
        while bool(_scalar_bool(cond)):
            cond, carries = body(cond, carries)
    return {"Out": carries, "Condition": [cond]}


def _export_while(ctx, body, cond, carry_names, carries):
    """The unbounded ``while`` as torch's ``while_loop`` over (condition,
    carries): the body runs in a fork of the context and hands back
    fresh tensors of its carries' shapes and dtypes."""
    from torch._higher_order_ops.while_loop import while_loop
    what = "a While without max_iters"
    same_meta(what, carry_names, carries, carries)   # tensor arrays

    def cond_fn(c, *vals):
        return _scalar_bool(c).clone()

    def body_fn(c, *vals):
        new_c, new = body(c, list(vals), ctx.fork())
        same_meta(what, carry_names, vals, new)
        return (new_c.clone(), *(v.clone() for v in new))

    out = export_call(
        what, while_loop, (cond_fn, body_fn, (cond, *carries)),
        lambda: same_meta(what, carry_names, carries,
                          body(cond, carries, ctx.fork())[1]))
    return out[0], list(out[1:])


@register_op("if_else")
def _if_else(ctx, ins, attrs):
    """attrs: true_block, false_block, out_names (vars both branches
    write). The scalar condition picks the branch on the host, or, while
    the step is exported, in ``torch.cond``."""
    from ..core.lowering import Env

    def branch(block, run=ctx):
        env = Env(parent=ctx.env)
        run.eval_block(attrs[block], env)
        return [env[n] for n in attrs["out_names"]]

    if ctx.for_export:
        def taken(block):
            return lambda: [v.clone() for v in branch(block, ctx.fork())]

        def diagnose():
            for n, a, b in zip(attrs["out_names"], taken("true_block")(),
                               taken("false_block")()):
                if a.dtype != b.dtype or list(a.shape) != list(b.shape):
                    raise untraceable("an IfElse", f"output {n} is "
                                      f"{a.dtype} {list(a.shape)} in the "
                                      f"true branch and {b.dtype} "
                                      f"{list(b.shape)} in the false one")

        return {"Out": list(export_call(
            "an IfElse", torch.cond,
            (_scalar_bool(ins["Cond"][0]), taken("true_block"),
             taken("false_block"), ()), diagnose))}
    take = bool(_scalar_bool(ins["Cond"][0]))
    return {"Out": branch("true_block" if take else "false_block")}


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
