"""Collective communication verbs (port of
``paddle_tpu/parallel/collectives.py``).

The reference's verbs are ``lax`` collectives used inside
``shard_map``-ped functions, where each device holds its shard. Here
each process holds its shard, so every verb takes this rank's local
tensor and runs over the process group of one axis of a
:class:`~.mesh.DeviceMesh` (``mesh=``, default the current mesh):
NCCL on the card, gloo on the host. Where the reference differentiates
through a verb, the port's carries its gradient too (an
``autograd.Function`` each).

Every verb adds one to :data:`COUNTS` under the reference's collective
kind (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute``, ``all-to-all``), which
``ParallelExecutor.compiled_stats`` reads beside the collectives of the
placed values.
"""
import contextlib

import torch
import torch.distributed as dist

from .mesh import current_mesh

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "grad_tree_sync", "ppermute", "all_to_all", "axis_index",
           "axis_size", "quantized_all_reduce", "COUNTS",
           "counting"]

#: collective kind -> calls since the last reset (see :func:`counting`)
COUNTS = {}


def _count(kind):
    COUNTS[kind] = COUNTS.get(kind, 0) + 1


@contextlib.contextmanager
def counting():
    """Yields a dict that, after the block, holds the calls made inside
    it, by kind."""
    before = dict(COUNTS)
    seen = {}
    try:
        yield seen
    finally:
        seen.update({k: n - before.get(k, 0) for k, n in COUNTS.items()
                     if n != before.get(k, 0)})


def _mesh(mesh):
    mesh = mesh or current_mesh()
    if mesh is None:
        raise RuntimeError("no device mesh: pass mesh= or enter one "
                           "(mesh_scope / with DeviceMesh(...))")
    return mesh


def _check_device(x, group):
    """A collective the group's backend cannot run on ``x``'s device
    raises; it is never staged through the host."""
    backend = dist.get_backend(group)
    if backend == "nccl" and x.device.type != "cuda":
        raise RuntimeError(
            f"the mesh's NCCL group cannot reduce a {x.device} tensor; "
            "build the mesh on the host (CPUPlace / "
            "PADDLE_TPU_CPU_COLLECTIVES=gloo) to use host tensors")


def _group(axis_name, mesh, x=None):
    g = _mesh(mesh).group(axis_name)
    if x is not None:
        _check_device(x, g)
    return g


def _reduce_op(op):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group; its gradient is summed too (psum's
    transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        dy = dy.clone().contiguous()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


def all_reduce(x, axis_name, op="sum", mesh=None):
    """``lax.psum`` / ``pmean`` / ``pmax`` / ``pmin`` over ``axis_name``.
    Sum and mean carry gradients (the gradient is itself summed over
    the axis, as psum's transpose); max and min do not."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown reduce op {op!r}")
    g = _group(axis_name, mesh, x)
    _count("all-reduce")
    if op in ("sum", "mean"):
        out = _AllReduceSum.apply(x, g)
        return out / dist.get_world_size(g) if op == "mean" else out
    out = x.detach().clone()
    dist.all_reduce(out, op=_reduce_op(op), group=g)
    return out


class _AllGather(torch.autograd.Function):
    """Blocks of every rank stacked on a new leading axis; the gradient
    of a rank's block sums every rank's gradient of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        x = x.contiguous().reshape((1,) + tuple(x.shape))
        out = x.new_empty((n,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        dist.all_reduce(dy, group=ctx.group)
        return dy[dist.get_rank(ctx.group)], None


def all_gather(x, axis_name, axis=0, tiled=True, mesh=None):
    """Every rank's ``x`` along ``axis`` (concatenated with ``tiled``,
    stacked on a new axis otherwise), with gradients."""
    g = _group(axis_name, mesh, x)
    _count("all-gather")
    parts = _AllGather.apply(x, g)
    return torch.cat(list(parts.unbind(0)), dim=axis) if tiled else \
        torch.movedim(parts, 0, axis)


class _ReduceScatter(torch.autograd.Function):
    """blocks [n, ...]: the sum over the group of block r, on rank r;
    the gradient gathers every rank's block back. gloo has no
    reduce-scatter: there it is an all-reduce keeping the rank's
    block."""

    @staticmethod
    def forward(ctx, blocks, group):
        ctx.group = group
        if dist.get_backend(group) == "nccl":
            out = blocks.new_empty(blocks.shape[1:])
            dist.reduce_scatter_tensor(out, blocks.contiguous(),
                                       group=group)
            return out
        total = blocks.detach().clone().contiguous()
        dist.all_reduce(total, group=group)
        return total[dist.get_rank(group)].clone()

    @staticmethod
    def backward(ctx, dy):
        return _AllGather.apply(dy, ctx.group), None


def reduce_scatter(x, axis_name, scatter_dimension=0, mesh=None):
    """``lax.psum_scatter(..., tiled=True)``: the sum over the axis,
    each rank keeping its block of ``scatter_dimension``."""
    g = _group(axis_name, mesh, x)
    n = dist.get_world_size(g)
    _count("reduce-scatter")
    blocks = torch.stack(torch.chunk(x, n, dim=scatter_dimension))
    return _ReduceScatter.apply(blocks, g)


def broadcast(x, axis_name, root=0, mesh=None):
    """Every rank gets the value of the rank at index ``root`` of the
    axis (the reference's masked psum: one all-reduce)."""
    idx = axis_index(axis_name, mesh)
    masked = torch.where(torch.tensor(idx == root, device=x.device), x,
                         torch.zeros_like(x))
    return all_reduce(masked, axis_name, "sum", mesh)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, dy):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(dy.contiguous(), ctx.group, inverse), None, None


def _permute(x, group, perm):
    """Send ``x`` along each (source, destination) pair of axis indices;
    a rank no pair sends to gets zeros (as ``lax.ppermute``). A pair from
    a rank to itself is a copy (a one-rank axis exchanges nothing)."""
    me = dist.get_rank(group)
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


def ppermute(x, axis_name, perm, mesh=None):
    """``lax.ppermute``: ``perm`` is a list of (source, destination)
    axis indices; the gradient goes back along the inverse pairs."""
    g = _group(axis_name, mesh, x)
    _count("collective-permute")
    return _Permute.apply(x, g, [tuple(p) for p in perm])


def _exchange(blocks, group):
    """blocks [n, ...]: block j to group rank j; returns the blocks
    received, [n, ...] in rank order (``all_to_all_single``)."""
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, group):
        ctx.group = group
        return _exchange(blocks.contiguous(), group)

    @staticmethod
    def backward(ctx, dy):
        # the exchange is its own inverse
        return _exchange(dy.contiguous(), ctx.group), None


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True,
               mesh=None):
    """``lax.all_to_all(tiled=True)``: block j of ``split_axis`` goes to
    axis index j, and the blocks received are concatenated along
    ``concat_axis`` in axis order, with gradients."""
    if not tiled:
        raise NotImplementedError("all_to_all supports tiled=True")
    g = _group(axis_name, mesh, x)
    n = dist.get_world_size(g)
    _count("all-to-all")
    blocks = torch.stack(torch.chunk(x, n, dim=split_axis))
    got = _AllToAll.apply(blocks, g)
    return torch.cat(list(got.unbind(0)), dim=concat_axis)


def axis_index(axis_name, mesh=None):
    """This rank's index along ``axis_name``."""
    return _mesh(mesh).coordinate(axis_name)


def axis_size(axis_name, mesh=None):
    return _mesh(mesh).size(axis_name)


def grad_tree_sync(grads, axis_name, op="mean", bits=None, mesh=None):
    """Synchronize a whole gradient tree (a dict, list or tuple of
    tensors, nested) across ``axis_name`` in one call: ``op`` "mean"
    (every replica ends with the global average) or "sum"; ``bits=8``
    carries each leaf through :func:`quantized_all_reduce`."""
    if op not in ("sum", "mean"):
        raise ValueError(f"grad_tree_sync op must be 'sum' or "
                         f"'mean', got {op!r}")
    n = axis_size(axis_name, mesh)

    def sync(g):
        if bits is None:
            return all_reduce(g, axis_name, op=op, mesh=mesh)
        total = quantized_all_reduce(g, axis_name, bits=bits, mesh=mesh)
        return total / n if op == "mean" else total

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return sync(t)

    return walk(grads)


def quantized_all_reduce(x, axis_name, bits=8, mesh=None):
    """Bandwidth-compressed all-reduce (EQuARX, arxiv 2506.17615), the
    reference's recipe: the ranks agree on one per-tensor scale (a max
    all-reduce of each local absmax / 127), quantize against it to the
    int8 value range and sum the integers. The reference sums int16 (2
    bytes an element on the wire); neither NCCL nor gloo reduces 16-bit
    integers, so the port sums int32 — the same exact integers, at the
    float32 reduce's 4 bytes an element. Only ``bits=8``. No gradient
    (the rounding has none)."""
    if bits != 8:
        raise NotImplementedError("quantized_all_reduce supports bits=8")
    g = _group(axis_name, mesh, x)
    r = 127.0
    scale = (torch.clamp(x.detach().abs().max(), min=1e-30) / r).reshape(1)
    scale = scale.float()
    _count("all-reduce")
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=g)
    q = torch.clamp(torch.round(x.detach().float() / scale), -r,
                    r).to(torch.int32)
    _count("all-reduce")
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=g)
    return (q.to(x.dtype) * scale.to(x.dtype)).reshape(x.shape)
