"""One lowered step over values placed on a device mesh.

The reference jits the lowered step with sharding annotations and lets
GSPMD partition it. The port runs the same lowered step
(``core/lowering.py``) eagerly on ``DTensor``s: state and feeds are
placed from their PartitionSpecs (:func:`place`), and op rules see
placed values. How each op runs (:meth:`Spmd.lower`):

- an op whose inputs are all replicated runs its rule on the local
  tensors, and its outputs are replicated: no collective, no DTensor
  dispatch (the optimizer updates of a data-parallel step, say);
- an op with a rule here (:data:`RULES`) runs it. These are the ops
  whose work is local to a shard but whose torch form DTensor cannot
  follow: attention (it folds heads into the batch for the kernels,
  which DTensor would answer with an all-gather of q, k and v; over an
  'sp' axis, the ring on each rank's chunk of the sequence), the
  layer-stacked decoder and the 1F1B loss (over a 'pp' axis, each rank
  runs the schedule on its own stage), the fused loss, the generator,
  the table lookup (a row-sharded table's too), and the MoE FFN (its
  explicit expert dispatch); and control flow (``while``, ``if_else``,
  ``scan``), whose rule runs on the placed values while each op of its
  sub-block goes through :meth:`Spmd.lower`;
- every other op runs its rule on the DTensors, and DTensor's sharding
  propagation inserts the collectives, as GSPMD does: a mean over a
  dp-sharded batch becomes an all-reduce, batch norm's sums become
  all-reduces (global-batch statistics), a row-split matmul's partial
  sums an all-reduce.

A rule that runs locally declares its outputs' placements; an input
that is replicated on a mesh axis where the output is sharded gets a
partial gradient on that axis (each rank's share), which DTensor sums
where it is next used. The gradients of the parameters are brought to
their parameters' placements (:meth:`Spmd.sync_grads`): the dp
all-reduce. Optimizer updates run on local shards: replicated state
locally, a ZeRO-sharded moment on its shard, its parameter gathered
back after the update.
"""
import torch

from ..ops.transformer_ops import (PIPELINE, SP_RING, TOKEN_LOSSES,
                                   pipeline_plan)

__all__ = ["Spmd", "place", "RULES", "spmd_rule"]

#: op type -> rule(spmd, ctx, ins, attrs, lower) for ops that run
#: locally on their shards (see the module docstring)
RULES = {}

# optimizer updates that are elementwise over (param, grad, moments):
# they may run on a shard of their state
_ELEMENTWISE_OPTIMIZERS = frozenset((
    "sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl"))


def spmd_rule(*types):
    def deco(fn):
        for t in types:
            RULES[t] = fn
        return fn
    return deco


def _dt():
    import torch.distributed.tensor as dt
    return dt


def _shard_local(t, mesh, placements):
    """This rank's block of the global tensor ``t`` under ``placements``
    (even blocks, mesh dims left to right, as DTensor lays them)."""
    dt = _dt()
    for m, p in enumerate(placements):
        if isinstance(p, dt.Shard):
            n = mesh.size(m)
            size = t.shape[p.dim] // n
            t = t.narrow(p.dim, mesh.get_local_rank(m) * size, size)
    return t


def place(value, mesh, placements, device):
    """``value`` (a global tensor or array, or a placed value) as a
    DTensor on ``mesh`` with ``placements``."""
    dt = _dt()
    if isinstance(value, dt.DTensor):
        if list(value.placements) == list(placements):
            return value
        return value.redistribute(mesh, placements)
    if not isinstance(value, torch.Tensor):
        import numpy as np
        value = torch.as_tensor(np.array(value))
    value = value.to(device)
    local = _shard_local(value, mesh, placements).contiguous()
    if local.data_ptr() == value.data_ptr() and local is value:
        local = value
    return dt.DTensor.from_local(local, mesh, placements, run_check=False,
                                 shape=value.shape, stride=value.stride())


def _replicated(v):
    dt = _dt()
    return not isinstance(v, dt.DTensor) or all(
        isinstance(p, dt.Replicate) for p in v.placements)


def _no_partial(v):
    """``v`` with every Partial placement reduced (a local block must hold
    real values)."""
    dt = _dt()
    if isinstance(v, dt.DTensor) and any(
            isinstance(p, dt.Partial) for p in v.placements):
        return v.redistribute(v.device_mesh, [
            dt.Replicate() if isinstance(p, dt.Partial) else p
            for p in v.placements])
    return v


def _map(outs, fn):
    out = {}
    for slot, vals in outs.items():
        if isinstance(vals, (list, tuple)):
            out[slot] = [fn(v) for v in vals]
        else:
            out[slot] = fn(vals)
    return out


class Spmd:
    """The step-wide view of a mesh that ``LoweringContext.spmd``
    holds."""

    def __init__(self, mesh):
        self.mesh = mesh                 # parallel.mesh.DeviceMesh
        self.dmesh = mesh.mesh           # torch DeviceMesh

    # ------------------------------------------------------------------
    def lower(self, ctx, op, rule, ins, attrs):
        special = RULES.get(op.type)
        if special is not None:
            return special(self, ctx, ins, attrs, rule)
        if op.type in _ELEMENTWISE_OPTIMIZERS:
            return self._optimizer(ctx, op, rule, ins, attrs)
        if all(_replicated(v) for vals in ins.values() for v in vals):
            return self.run_local(rule, ctx, ins, attrs)
        return rule(ctx, ins, attrs)

    # ------------------------------------------------------------------
    def replicate(self):
        dt = _dt()
        return [dt.Replicate()] * self.dmesh.ndim

    def wrap(self, t, placements):
        """A local result as a DTensor (a plain value passes)."""
        if not isinstance(t, torch.Tensor):
            return t
        return _dt().DTensor.from_local(t, self.dmesh, placements,
                                        run_check=False)

    def local(self, v, out_placements=None):
        """``v``'s local block for a computation whose outputs have
        ``out_placements``: an input replicated on a mesh axis where the
        output is not gets a partial gradient there."""
        dt = _dt()
        if not isinstance(v, dt.DTensor):
            return v
        v = _no_partial(v)
        if out_placements is None or not (v.requires_grad
                                          and torch.is_grad_enabled()):
            return v.to_local()
        grad_pl = [dt.Partial() if isinstance(p, dt.Replicate)
                   and not isinstance(o, dt.Replicate) else p
                   for p, o in zip(v.placements, out_placements)]
        return v.to_local(grad_placements=grad_pl)

    def run_local(self, rule, ctx, ins, attrs, out_placements=None):
        """Run ``rule`` on the local blocks of ``ins``; its outputs carry
        ``out_placements`` (default replicated)."""
        dt = _dt()
        out_pl = out_placements or self.replicate()
        local_ins = {s: [self.local(v, out_pl) for v in vals]
                     for s, vals in ins.items()}
        # a donating step's state, as the local blocks the rule sees
        saved = ctx.donated
        if saved:
            ctx.donated = {n: v.to_local() for n, v in saved.items()
                           if isinstance(v, dt.DTensor)
                           and list(v.placements) == list(out_pl)}
        try:
            outs = rule(ctx, local_ins, attrs)
        finally:
            ctx.donated = saved
        if outs is None:
            return None
        return _map(outs, lambda v: self.wrap(v, out_pl))

    def batch_placements(self, v):
        """Placements of an output that follows ``v`` on its batch
        (leading) dimension only: Shard(0) where ``v`` is, else
        Replicate."""
        dt = _dt()
        if not isinstance(v, dt.DTensor):
            return self.replicate()
        return [p if isinstance(p, dt.Shard) and p.dim == 0
                else dt.Replicate() for p in v.placements]

    def gather_except_batch(self, v):
        """``v`` with every placement but a Shard(0) made Replicate."""
        return self.gather_except(v, (0,))

    def gather_except(self, v, dims):
        """``v`` with every placement but a Shard of one of ``dims`` made
        Replicate."""
        dt = _dt()
        if not isinstance(v, dt.DTensor):
            return v
        target = [p if isinstance(p, dt.Shard) and p.dim in dims
                  else dt.Replicate() for p in _no_partial(v).placements]
        return self.to(v, target)

    def to(self, v, placements):
        """``v`` (a plain value is replicated) at ``placements``."""
        dt = _dt()
        if not isinstance(v, dt.DTensor):
            v = self.wrap(v, self.replicate())
        v = _no_partial(v)
        if list(v.placements) == list(placements):
            return v
        return v.redistribute(self.dmesh, placements)

    def on_axis(self, axis, placement):
        """Placements: ``placement`` on mesh axis ``axis``, Replicate on
        the others."""
        dt = _dt()
        return [placement if n == axis else dt.Replicate()
                for n in self.mesh.axes]

    # ------------------------------------------------------------------
    def sync_grads(self, params, grads):
        """Each gradient at its parameter's placements: a partial
        (per-rank) gradient is all-reduced, a replicated gradient of a
        sharded parameter keeps its shard."""
        dt = _dt()
        out = []
        for p, g in zip(params, grads):
            if isinstance(g, dt.DTensor) and isinstance(p, dt.DTensor) \
                    and list(g.placements) != list(p.placements):
                g = g.redistribute(self.dmesh, p.placements)
            out.append(g)
        return out

    def donate(self, op, env, state):
        """lowering._donate over placed values: each output of ``op`` that
        updates a state value ends in that value's own local tensor (at
        its placements), and the name is rebound to the state value."""
        dt = _dt()
        for names in op.outputs.values():
            for n in names:
                old, new = state.get(n), env.d.get(n)
                if old is None or new is None or new is old:
                    continue
                if not isinstance(old, dt.DTensor):
                    continue
                if not isinstance(new, dt.DTensor):
                    new = self.wrap(new, self.replicate())
                if list(new.placements) != list(old.placements):
                    new = new.redistribute(self.dmesh, old.placements)
                lo, ln = old.to_local(), new.to_local()
                if (ln.shape != lo.shape or ln.dtype != lo.dtype
                        or ln.device != lo.device):
                    continue
                if (ln.data_ptr(), ln.stride()) != (lo.data_ptr(),
                                                    lo.stride()):
                    lo.copy_(ln)
                env[n] = old

    # ------------------------------------------------------------------
    def _optimizer(self, ctx, op, rule, ins, attrs):
        """An elementwise update on the placements of its sharded state
        (a ZeRO moment's shard, or a sharded parameter's), every input
        brought there (a replicated input is sliced, no collective); the
        outputs are written back at their own variables' placements
        (an updated parameter is gathered)."""
        dt = _dt()
        work = None
        for slot in sorted(ins):
            if slot in ("Grad", "LearningRate"):
                continue
            for v in ins[slot]:
                if isinstance(v, dt.DTensor) and v.dim() > 0 and any(
                        not isinstance(p, dt.Replicate)
                        for p in v.placements):
                    work = list(v.placements)
                    break
            if work is not None:
                break
        if work is None:
            return self.run_local(rule, ctx, ins, attrs)

        def to_work(v):
            if not isinstance(v, dt.DTensor) or v.dim() == 0 or \
                    v.numel() == 1:
                return v
            if list(v.placements) != work:
                v = v.redistribute(self.dmesh, work)
            return v

        ins = {s: [to_work(v) for v in vals] for s, vals in ins.items()}
        outs = self.run_local(rule, ctx, ins, attrs, out_placements=work)
        # scalars (beta powers) stayed replicated
        def fix(v):
            if isinstance(v, dt.DTensor) and (v.dim() == 0 or
                                              v.numel() == 1):
                return self.wrap(v.to_local(), self.replicate())
            return v
        return _map(outs, fix)


# ----------------------------------------------------------------------
# local rules
# ----------------------------------------------------------------------
@spmd_rule("multihead_attention")
def _attention(spmd, ctx, ins, attrs, rule):
    """Attention on each rank's own batch and heads: q, k and v keep a
    Shard on B (dim 0) and H (dim 2); any other placement is gathered
    first. K/V heads follow q's head split (the kv-head count divides
    the axis where the wk/wv specs fit); where they cannot, q's heads
    are gathered too. Over an 'sp' axis past 1, q, k and v are split on
    T (dim 1) over it, whatever they came with, and the op runs the ring
    on each rank's chunk (the reference's ring branch)."""
    dt = _dt()
    names = list(spmd.mesh.axes)
    sp = spmd.mesh.axes.get("sp", 1)

    def want(x, dims):
        return [dt.Shard(1) if n == "sp" and sp > 1
                else p if isinstance(p, dt.Shard) and p.dim in dims
                else dt.Replicate()
                for n, p in zip(names, _no_partial(x).placements)]

    q, k, v = (x if isinstance(x, dt.DTensor) else
               spmd.wrap(x, spmd.replicate())
               for x in (ins["Q"][0], ins["K"][0], ins["V"][0]))
    if sp > 1 and q.shape[1] % sp:
        raise ValueError(
            f"multihead_attention: sequence {q.shape[1]} does not split "
            f"over the mesh 'sp' axis of size {sp}")
    q, k, v = (spmd.to(x, want(x, (0, 2))) for x in (q, k, v))
    qp = list(q.placements)
    if list(k.placements) != qp:
        # k/v heads not split as q's: bring all three to the batch split
        qp = want(q, (0,))
        q, k, v = (spmd.to(x, qp) for x in (q, k, v))
    if sp > 1:
        attrs = dict(attrs, **{SP_RING: spmd.mesh})
    return spmd.run_local(rule, ctx, {"Q": [q], "K": [k], "V": [v]},
                          attrs, out_placements=qp)


def _batch_local(x_slot):
    """A rule whose work is per example: the input at ``x_slot`` keeps its
    batch split, every other input (the weights) is gathered where it
    is sharded, and the outputs follow the batch split."""
    def rule_fn(spmd, ctx, ins, attrs, rule):
        x = spmd.gather_except_batch(ins[x_slot][0])
        out_pl = spmd.batch_placements(x)
        dt = _dt()
        local_ins = {}
        for s, vals in ins.items():
            if s == x_slot:
                local_ins[s] = [x]
                continue
            gathered = []
            for v in vals:
                if isinstance(v, dt.DTensor) and v.dim() > 0 \
                        and v.shape[0] == x.shape[0] and s in (
                            "Targets", "Label", "Ids", "Tokens"):
                    v = spmd.gather_except_batch(v)
                elif isinstance(v, dt.DTensor):
                    v = _no_partial(v)
                    if not _replicated(v):
                        v = v.redistribute(spmd.dmesh, spmd.replicate())
                gathered.append(v)
            local_ins[s] = gathered
        return spmd.run_local(rule, ctx, local_ins, attrs,
                              out_placements=out_pl)
    return rule_fn


RULES["fused_head_cross_entropy"] = _batch_local("X")


def _pipeline_ins(spmd, ins, op_name, attrs):
    """A layer-stacked op's inputs on a mesh with a 'pp' axis past 1:
    the stacks at their stage, Shard(0) over 'pp'; X and Targets split
    on the batch over 'dp' (as the reference's in_spec P(None, 'dp')
    splits each microbatch) and replicated elsewhere; the rest
    replicated. Returns (inputs, attrs with the plan, X's placements)."""
    dt = _dt()
    x = ins["X"][0]
    stage = spmd.on_axis("pp", dt.Shard(0))
    batch = spmd.on_axis("dp", dt.Shard(0))
    nm = pipeline_plan(op_name, ins["Wq"][0].shape[0], x.shape[0],
                       attrs.get("n_micro", 0), spmd.mesh)
    placed = {}
    for slot, vals in ins.items():
        pl = batch if slot in ("X", "Targets") else \
            stage if vals[0].dim() > 0 and slot not in (
                "FinalNorm", "LmHead") else spmd.replicate()
        placed[slot] = [spmd.to(v, pl) for v in vals]
    return placed, dict(attrs, **{PIPELINE: (spmd.mesh, nm)}), batch


@spmd_rule("llama_decoder_stack")
def _decoder_stack(spmd, ctx, ins, attrs, rule):
    """Off a 'pp' axis: each rank's batch block through every layer
    (the stacks gathered). On one: the GPipe schedule, each rank running
    its own stage; the output follows X's batch split and is replicated
    over 'pp', as the reference's psum leaves it."""
    if spmd.mesh.axes.get("pp", 1) <= 1:
        return _batch_local("X")(spmd, ctx, ins, attrs, rule)
    ins, attrs, batch = _pipeline_ins(spmd, ins, "llama_decoder_stack",
                                      attrs)
    return spmd.run_local(rule, ctx, ins, attrs, out_placements=batch)


@spmd_rule("llama_stack_1f1b_loss")
def _stack_1f1b(spmd, ctx, ins, attrs, rule):
    """On a 'pp' axis: the 1F1B schedule, each rank running its own
    stage; its loss and gradients come averaged over 'dp' and shared
    along 'pp', so the loss is replicated. Off one: each rank's batch
    block through every layer to per-token losses, whose mean over the
    blocks is the loss."""
    if spmd.mesh.axes.get("pp", 1) <= 1:
        outs = _batch_local("X")(spmd, ctx, ins,
                                 dict(attrs, **{TOKEN_LOSSES: True}), rule)
        return {"Loss": [outs["Loss"][0].mean()]}
    ins, attrs, _ = _pipeline_ins(spmd, ins, "llama_stack_1f1b_loss",
                                  attrs)
    return spmd.run_local(rule, ctx, ins, attrs)


@spmd_rule("lookup_table")
def _lookup(spmd, ctx, ins, attrs, rule):
    """A table lookup on each rank's ids. A row-sharded table
    (``embedding(is_distributed=True)``, P('mp', None)) answers the ids
    in its rows with zeros elsewhere, and the output is partial over
    that axis — summed where it is next used (the vocab-parallel
    embedding); a replicated or column-sharded table looks up locally."""
    dt = _dt()
    w, ids = ins["W"][0], ins["Ids"][0]
    # the ids' batch split, and their sequence split (an 'sp' axis) when
    # the ids have a sequence dim: the output follows both
    seq = isinstance(ids, dt.DTensor) and ids.dim() >= 2 and not (
        ids.dim() == 2 and ids.shape[-1] == 1)
    ids = spmd.gather_except(ids, (0, 1) if seq else (0,))
    out_pl = list(ids.placements) if isinstance(ids, dt.DTensor) \
        else spmd.replicate()
    row_axes = []
    if isinstance(w, dt.DTensor):
        w = _no_partial(w)
        for m, p in enumerate(w.placements):
            if isinstance(p, dt.Shard) and p.dim == 0:
                row_axes.append(m)
            elif isinstance(p, dt.Shard):
                out_pl[m] = dt.Shard(ids.dim() - (
                    1 if ids.dim() and ids.shape[-1] == 1 else 0))
    if not row_axes:
        return spmd.run_local(rule, ctx, {"W": [w], "Ids": [ids]}, attrs,
                              out_placements=out_pl)
    for m in row_axes:
        out_pl[m] = dt.Partial()
    lw = spmd.local(w, out_pl)
    li = spmd.local(ids)
    rows = lw.shape[0]
    lo = 0
    stride = w.shape[0]
    for m in row_axes:
        stride //= spmd.dmesh.size(m)
        lo += spmd.dmesh.get_local_rank(m) * stride
    if li.dim() and li.shape[-1] == 1:
        li = li.reshape(li.shape[:-1])
    li = li.to(torch.int64)
    mine = (li >= lo) & (li < lo + rows)
    local_ids = torch.where(mine, li - lo, torch.zeros_like(li))
    out = lw[local_ids] * mine.unsqueeze(-1).to(lw.dtype)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        out = out * (li != pad).unsqueeze(-1).to(out.dtype)
    return {"Out": [spmd.wrap(out, out_pl)]}


# per-example ops whose torch form DTensor has no rule for (the conv and
# pool backward, the interpolations): each rank's batch block
for _t in ("conv2d", "depthwise_conv2d", "conv3d", "conv2d_transpose",
           "conv3d_transpose"):
    RULES[_t] = _batch_local("Input")
for _t in ("pool2d", "pool3d", "lrn", "bilinear_interp", "nearest_interp"):
    RULES[_t] = _batch_local("X")


def _moe(spmd, ctx, ins, attrs, rule):
    from ..ops.moe import moe_ffn_spmd
    return moe_ffn_spmd(spmd, ctx, ins, attrs, rule)


RULES["moe_ffn"] = _moe


# llama_generate's slots and the dimension a tensor-parallel spec splits
# (models/llama.py's generator table): column blocks of the stacked
# [L, in, out] products, row blocks of the row-split ones; the experts
# split inside each expert
_GEN_TP_DIMS = {"Wq": 2, "Wk": 2, "Wv": 2, "Wo": 1, "WGate": 2, "WUp": 2,
                "WDown": 1, "MoeWGate": 3, "MoeWUp": 3, "MoeWDown": 2}


@spmd_rule("llama_generate")
def _generate(spmd, ctx, ins, attrs, rule):
    """Generation on each rank's batch block. Under a 'tp' axis whose
    Megatron specs fit (float weights, heads dividing the axis), each
    rank keeps its heads and its column / row blocks, and the row-split
    products' partial sums are all-reduced over 'tp' inside the layers
    (decoder_block's ``reduce``); the KV cache holds the rank's kv heads.
    Otherwise the weights are gathered and the batch block generates
    with all of them."""
    dt = _dt()
    from ..ops.transformer_ops import TP_REDUCE
    from . import collectives as C
    tokens = spmd.gather_except_batch(ins["Tokens"][0])
    out_pl = spmd.batch_placements(tokens)
    names = list(spmd.mesh.axes)
    tp = spmd.mesh.axes.get("tp", 1)
    n_heads = attrs["n_heads"]
    n_kv = attrs.get("n_kv_heads", n_heads)

    def tp_split(slot, v):
        if not isinstance(v, dt.DTensor):
            return False
        want = _GEN_TP_DIMS.get(slot)
        pl = v.placements[names.index("tp")]
        return want is not None and isinstance(pl, dt.Shard) \
            and pl.dim == want

    use_tp = (tp > 1 and n_heads % tp == 0 and n_kv % tp == 0
              and not any(s.endswith("Scale") for s in ins)
              and all(tp_split(s, ins[s][0]) for s in _GEN_TP_DIMS
                      if s in ins))
    local_ins = {"Tokens": [tokens]}
    for slot, vals in ins.items():
        if slot == "Tokens":
            continue
        v = _no_partial(vals[0])
        if isinstance(v, dt.DTensor):
            keep = use_tp and slot in _GEN_TP_DIMS
            want = [p if keep and n == "tp" else dt.Replicate()
                    for n, p in zip(names, v.placements)]
            if list(v.placements) != want:
                v = v.redistribute(spmd.dmesh, want)
        local_ins[slot] = [v]
    if use_tp:
        mesh = spmd.mesh
        attrs = dict(attrs, n_heads=n_heads // tp, n_kv_heads=n_kv // tp)
        attrs[TP_REDUCE] = lambda y: C.all_reduce(y, "tp", mesh=mesh)
    return spmd.run_local(rule, ctx, local_ins, attrs, out_placements=out_pl)


@spmd_rule("while", "if_else", "scan")
def _sub_block(spmd, ctx, ins, attrs, rule):
    """Control flow: the rule itself, on the placed values (an if_else's
    condition whole, as every rank reads it back); each op of its
    sub-block goes through :meth:`Spmd.lower` in turn."""
    if "Cond" in ins:
        dt = _dt()
        ins = dict(ins, Cond=[v.full_tensor() if isinstance(v, dt.DTensor)
                              else v for v in ins["Cond"]])
    return rule(ctx, ins, attrs)
