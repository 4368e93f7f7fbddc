"""Pipeline parallelism over the mesh 'pp' axis: the GPipe microbatch
schedule and 1F1B (port of ``paddle_tpu/parallel/pipeline.py``).

The reference keeps one SPMD program: stage parameters stacked with a
leading [n_stages] axis sharded over 'pp', activations rotated between
neighbour stages with ``lax.ppermute`` inside ``shard_map``, and a
``lax.scan`` over the ticks. Here each rank is one stage and runs the
same ticks eagerly: the body of the reference's ``per_group``, on this
rank's stage and this rank's block of the batch.

Every rank makes the same ``ppermute`` calls on every tick, sending
zeros where its stage is idle, as the reference's lockstep schedule
does: a point-to-point exchange that one rank skipped would leave its
neighbour waiting. GPipe's backward is autograd through the tick loop
(each permute's gradient goes back along the inverse pairs); every rank
computes every tick, bubbles included, so the ranks' graphs, and so
the order of their backward exchanges, are the same. 1F1B runs its
backward inside the schedule and needs no autograd across ranks.

Arguments: ``stacked_params`` is a pytree whose leaves lead with the
[n_stages] axis (the global stack, of which this rank takes its stage)
or with [1] (this rank's stage already); ``micro`` is this rank's
microbatches [n_micro, micro_batch, ...] — its block over 'dp' where
the mesh has one, as the reference's in_spec ``P(None, 'dp')`` hands
each shard.
"""
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as _ckpt

from . import collectives

__all__ = ["gpipe", "one_f_one_b"]


class _SumGradOver(torch.autograd.Function):
    """The identity, whose gradient is summed over the group: an input
    every rank of the axis holds alike but only some ranks use (the
    microbatches, which feed stage 0), as ``shard_map`` transposes an
    input that is not split over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        collectives._count("all-reduce")
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ShareFrom(torch.autograd.Function):
    """``x`` of the rank where ``mine`` is set, on every rank of the group
    (the reference's psum of the value masked to that rank). Every rank
    then uses it alike, so each holds the whole of its gradient: the
    gradient goes to the owner's ``x`` as it comes."""

    @staticmethod
    def forward(ctx, x, group, mine):
        ctx.mine = mine
        out = x.detach().clone() if mine else torch.zeros_like(x)
        collectives._count("all-reduce")
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        return (dy if ctx.mine else torch.zeros_like(dy)), None, None


def _stage(tree, idx, n_stages):
    """Each leaf's entry for stage ``idx``: a leaf leading with
    [n_stages] gives entry ``idx``, one leading with [1] its only one."""
    def take(a):
        if a.shape[0] == 1:
            return a[0]
        if a.shape[0] == n_stages:
            return a[idx]
        raise ValueError(
            f"a stacked parameter leads with {a.shape[0]}: neither the "
            f"{n_stages} stages of the 'pp' axis nor this rank's 1")
    return pytree.tree_map(take, tree)


def gpipe(stage_fn, mesh, axis="pp", checkpoint_stages=True):
    """Build a pipelined apply over ``mesh.axes[axis]`` stages.

    stage_fn(stage_params, x) -> y, the computation of ONE stage; every
    stage has this signature (x and y of one shape), e.g. a block of
    transformer layers. ``checkpoint_stages`` recomputes each stage in
    the backward pass (non-reentrant ``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``).

    Returns ``pipelined(stacked_params, micro) -> out``, ``out``
    [n_micro, micro_batch, ...]: the last stage's outputs in microbatch
    order, on every rank of the axis. n_micro + n_stages - 1 ticks:
    at tick t stage 0 takes microbatch t and every other stage what its
    predecessor sent at the tick before.
    """
    n_stages = mesh.axes[axis]

    def fn(params, x):
        if checkpoint_stages and torch.is_grad_enabled():
            return _ckpt.checkpoint(stage_fn, params, x,
                                    use_reentrant=False)
        return stage_fn(params, x)

    def pipelined(stacked_params, micro):
        idx = collectives.axis_index(axis, mesh)
        group = collectives._group(axis, mesh, micro)
        params = _stage(stacked_params, idx, n_stages)
        n_micro = micro.shape[0]
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        micro = _SumGradOver.apply(micro, group)
        first = torch.tensor(idx == 0, device=micro.device)
        prev = torch.zeros_like(micro[0])
        outs = []
        for t in range(n_micro + n_stages - 1):
            recv = collectives.ppermute(prev, axis, perm, mesh)
            x_in = torch.where(first, micro[min(t, n_micro - 1)], recv)
            prev = fn(params, x_in)
            if t >= n_stages - 1:
                outs.append(prev)
        # only the last stage holds real outputs: share them along the
        # pipeline axis so every stage returns the same value
        return _ShareFrom.apply(torch.stack(outs), group,
                                idx == n_stages - 1)

    return pipelined


def one_f_one_b(stage_fn, loss_fn, mesh, axis="pp", loss_params=False,
                return_dx=False):
    """1F1B pipeline schedule (PipeDream-flush): each microbatch's
    backward runs as soon as the last stage has its forward, so stage
    ``s`` holds at most ``n_stages - s`` in-flight stage inputs, and the
    parameter gradients accumulate inside the schedule.

    stage_fn(stage_params, x) -> y (one x/y shape across stages);
    loss_fn(y, target) -> scalar per-microbatch loss (mean-reduced).

    Returns ``step(stacked_params, micro_x, micro_y) -> (loss, grads)``:
    ``loss`` the mean over microbatches (and over 'dp'), ``grads`` this
    rank's stage gradients of it, leading with [1] — computed by the
    schedule itself (do not differentiate ``step``).

    ``loss_params=True`` makes it ``loss_fn(lparams, y, target)`` (the
    head / loss weights, alike on every rank) and
    ``step(stacked_params, lparams, micro_x, micro_y)``; the return gains
    ``dlparams``. ``return_dx=True`` appends ``dx_micro``, d loss / d
    micro_x in micro_x's layout — what an upstream embedding needs.

    Tick algebra (stage s, microbatch k, S stages): the forward of k
    runs at tick ``s + 2k``, its backward at ``2S - 1 - s + 2k``; a
    value permuted at a tick arrives when the neighbour consumes it, and
    a ring of S slots holds the in-flight stage inputs. The backward
    recomputes the stage from its slot and calls ``torch.autograd.grad``
    (the reference's ``jax.vjp``): remat is built in. Gradients
    accumulate in float32 and come back in the parameters' dtypes.
    """
    n_stages = mesh.axes[axis]
    has_dp = "dp" in mesh.axes and axis != "dp"

    def step(stacked_params, *rest):
        if loss_params:
            lparams, micro_x, micro_y = rest
        else:
            (micro_x, micro_y), lparams = rest, {}
        idx = collectives.axis_index(axis, mesh)
        n_micro = micro_x.shape[0]
        # last event: the backward of microbatch M-1 at stage 0, tick
        # 2S - 1 + 2(M-1), so 2(M + S) - 2 ticks in all
        ticks = 2 * (n_micro + n_stages) - 2
        fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        bwd_perm = [((i + 1) % n_stages, i) for i in range(n_stages)]
        first, last = idx == 0, idx == n_stages - 1

        p_leaves, p_spec = pytree.tree_flatten(
            _stage(stacked_params, idx, n_stages))
        p_leaves = [p.detach() for p in p_leaves]
        l_leaves, l_spec = pytree.tree_flatten(lparams)
        l_leaves = [p.detach() for p in l_leaves]
        micro_x = micro_x.detach()
        zero_x = torch.zeros_like(micro_x[0])
        grad_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in p_leaves]
        lg_acc = [torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device) for p in l_leaves]
        dx_buf = torch.zeros(micro_x.shape, dtype=torch.float32,
                             device=micro_x.device) if return_dx else None
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=micro_x.device)
        x_ring = [None] * n_stages
        y_send = g_send = zero_x

        def unflat(leaves):
            return pytree.tree_unflatten(leaves, p_spec)

        for t in range(ticks):
            y_in = collectives.ppermute(y_send, axis, fwd_perm, mesh)
            g_in = collectives.ppermute(g_send, axis, bwd_perm, mesh)
            y_send = g_send = zero_x
            if (t - idx) % 2 == 0:
                k = (t - idx) // 2
                if not 0 <= k < n_micro:
                    continue
                x_in = micro_x[k] if first else y_in
                with torch.no_grad():
                    y_send = stage_fn(unflat(p_leaves), x_in)
                x_ring[k % n_stages] = x_in
                continue
            k = (t - (2 * n_stages - 1 - idx)) // 2
            if not 0 <= k < n_micro:
                continue
            with torch.enable_grad():
                ps = [p.detach().requires_grad_() for p in p_leaves]
                x_in = x_ring[k % n_stages].detach().requires_grad_()
                y = stage_fn(unflat(ps), x_in)
                if last:
                    ls = [p.detach().requires_grad_() for p in l_leaves]
                    if loss_params:
                        loss_k = loss_fn(pytree.tree_unflatten(ls, l_spec),
                                         y, micro_y[k])
                    else:
                        loss_k = loss_fn(y, micro_y[k])
                    loss_acc += loss_k.detach().float() / n_micro
                    got = torch.autograd.grad(loss_k / n_micro,
                                              ps + [x_in] + ls,
                                              allow_unused=True)
                    for a, g in zip(lg_acc, got[len(ps) + 1:]):
                        if g is not None:
                            a += g.float()
                else:
                    got = torch.autograd.grad(y, ps + [x_in],
                                              grad_outputs=g_in,
                                              allow_unused=True)
            for a, g in zip(grad_acc, got[:len(ps)]):
                if g is not None:
                    a += g.float()
            dx = got[len(ps)]
            dx = torch.zeros_like(x_in) if dx is None else dx.detach()
            g_send = dx.to(micro_x.dtype)
            if return_dx and first:
                dx_buf[k] = dx.float()
            x_ring[k % n_stages] = None

        # the loss and the head gradients live on the last stage, dx on
        # stage 0, stage gradients on their own stage: share along 'pp',
        # average over 'dp' shards
        loss = collectives.all_reduce(loss_acc, axis, "sum", mesh)
        lg_acc = [collectives.all_reduce(g, axis, "sum", mesh)
                  for g in lg_acc]
        if return_dx:
            dx_buf = collectives.all_reduce(dx_buf, axis, "sum", mesh)
            if has_dp:
                # dx is per-shard data: the global loss is the mean over
                # the dp shards, so each shard's cotangent carries 1/|dp|
                dx_buf = dx_buf / mesh.axes["dp"]
        if has_dp:
            loss = collectives.all_reduce(loss, "dp", "mean", mesh)
            grad_acc = [collectives.all_reduce(g, "dp", "mean", mesh)
                        for g in grad_acc]
            lg_acc = [collectives.all_reduce(g, "dp", "mean", mesh)
                      for g in lg_acc]
        grads = unflat([g.to(p.dtype)[None]
                        for g, p in zip(grad_acc, p_leaves)])
        out = (loss, grads)
        if loss_params:
            out += (pytree.tree_unflatten(
                [g.to(p.dtype) for g, p in zip(lg_acc, l_leaves)], l_spec),)
        if return_dx:
            out += (dx_buf.to(micro_x.dtype),)
        return out

    return step
