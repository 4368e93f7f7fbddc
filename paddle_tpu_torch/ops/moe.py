"""Mixture-of-Experts FFN op (port of ``paddle_tpu/ops/moe.py``).

The GShard/Switch recipe, as the reference: top-k gating with a static
per-expert capacity, dispatch and combine as einsums over [tokens,
experts, capacity] tensors, SwiGLU experts. Plain torch products: the
reference computes them with einsums under XLA, outside any Pallas
kernel, and the W8A8 serving form runs its expert products int8 x int8
→ int32 through ``int8_einsum`` (exact).

Ties in the routing break toward the lower expert index, as
``jax.lax.top_k`` breaks them (:func:`_top_k`, a stable descending
sort; ``torch.topk`` promises no order among equal values).

Under a device mesh with an 'ep' axis (``parallel/spmd.py``) the op's
rule :func:`moe_ffn_spmd` places the [experts, capacity, dim]
intermediates on 'ep': each rank routes its own tokens with the
capacity and queue order of the whole batch (the token choices are
all-gathered), its [E, C, D] dispatch goes to the experts' owners by an
all-to-all over 'ep', and the expert outputs come back by an all-gather
— the collectives the reference's GSPMD inserts at its
``_ep_constraint``s.
"""
import torch
import torch.nn.functional as F

from ..core.registry import register_op

__all__ = ["top_k_gating", "moe_apply", "moe_apply_no_drop",
           "moe_apply_no_drop_q", "RANGES", "DROPPED"]

# the torch.profiler ranges of the training form's stages: routing, the
# dispatch einsum, the expert products, the combine einsum
RANGES = ("moe.gating", "moe.dispatch", "moe.experts", "moe.combine")
#: while a list (``moe.DROPPED = []``), each training-form call appends
#: the number of (token, choice) pairs its capacity dropped, as a device
#: tensor (no host sync); None (the default) records nothing
DROPPED = None


def _top_k(probs, k):
    """(values, indices) of the ``k`` largest entries of each row, ties
    toward the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(probs, top_k):
    """Each token's top-k experts and their renormalised gates."""
    gates, idx = _top_k(probs, top_k)                      # [T, K]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True),
                                min=1e-9)
    return gates, idx


def _queue_positions(idx, e):
    """[T, K] position of each token's k-th choice within its expert's
    queue: a cumulative sum over tokens, k-slot by k-slot, each slot
    offset by the tokens earlier slots enqueued (the reference's
    order)."""
    counts = torch.zeros(e, dtype=torch.int64, device=idx.device)
    pos = []
    for k in range(idx.shape[1]):
        onehot = F.one_hot(idx[:, k], e)                    # [T, E]
        p = torch.cumsum(onehot, dim=0) - 1 + counts[None, :]
        pos.append((p * onehot).sum(dim=-1))
        counts = counts + onehot.sum(dim=0)
    return torch.stack(pos, dim=1)


def _combine(gates, idx, pos, e, capacity, dtype):
    """[T, E, C] combine weights: token t's gate in expert e's slot c;
    a token past its expert's capacity has a zero row."""
    c_range = torch.arange(capacity, device=gates.device)
    combine = torch.zeros((gates.shape[0], e, capacity), dtype=dtype,
                          device=gates.device)
    for k in range(idx.shape[1]):
        onehot = F.one_hot(idx[:, k], e).to(dtype)           # [T, E]
        fits = (pos[:, k] < capacity).to(dtype) * gates[:, k]
        slot = (pos[:, k][:, None] == c_range[None, :]).to(dtype)
        combine = combine + (fits[:, None, None] * onehot[:, :, None]
                             * slot[:, None, :])
    return combine


def _aux_terms(probs, idx0, e):
    """The two [E] means of the Switch load-balancing loss: router
    probability and top-1 dispatch frequency."""
    top1 = F.one_hot(idx0, e).to(probs.dtype)
    return probs.mean(dim=0), top1.mean(dim=0)


def top_k_gating(probs, top_k, capacity):
    """GShard-style gating. probs: [T, E] router softmax.

    Returns (combine [T, E, C] float, dispatch [T, E, C] bool, aux):
    combine carries the (renormalised) gate weight of token t in expert
    e's capacity slot c; tokens past an expert's capacity are dropped
    (their combine row is zero — the residual stream carries them, as in
    Switch). aux is the Switch load-balancing loss E * sum_e(f_e * P_e).
    """
    e = probs.shape[1]
    gates, idx = _route(probs, top_k)
    pos = _queue_positions(idx, e)
    combine = _combine(gates, idx, pos, e, capacity, probs.dtype)
    mp, mf = _aux_terms(probs, idx[:, 0], e)
    return combine, combine > 0, e * torch.sum(mp * mf)


def _router_probs(xt, wg):
    """Router in float32 for a stable softmax/top-k whatever the dtype."""
    return torch.softmax(xt.float() @ wg.float(), dim=-1)


def _capacity(cap_factor, t, top_k, e):
    return max(1, int(cap_factor * t * top_k / e))


def _experts(expert_in, w_gate, w_up, w_down):
    """SwiGLU experts over [E, C, D] rows."""
    gate_h = torch.einsum("ecd,edh->ech", expert_in, w_gate)
    up_h = torch.einsum("ecd,edh->ech", expert_in, w_up)
    h = (gate_h * torch.sigmoid(gate_h)) * up_h
    return torch.einsum("ech,ehd->ecd", h, w_down)


def moe_apply(xt, wg, w_gate, w_up, w_down, top_k, cap_factor):
    """Training-form MoE on flat tokens xt [T, D]: GShard top-k gating
    with static capacity (tokens past capacity fall back to the
    residual stream). Returns (out [T, D], aux scalar)."""
    from torch.profiler import record_function
    t = xt.shape[0]
    e = w_up.shape[0]
    capacity = _capacity(cap_factor, t, top_k, e)
    with record_function(RANGES[0]):
        probs = _router_probs(xt, wg)
        combine, dispatch, aux = top_k_gating(probs, top_k, capacity)
        if DROPPED is not None:
            DROPPED.append(t * top_k - dispatch.sum())
    cdt = xt.dtype
    with record_function(RANGES[1]):
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(cdt), xt)
    with record_function(RANGES[2]):
        expert_out = _experts(expert_in, w_gate, w_up, w_down)
    with record_function(RANGES[3]):
        out = torch.einsum("tec,ecd->td", combine.to(cdt), expert_out)
    return out, aux


def _topk_combine(probs, top_k):
    """Dense [T, E] combine weights of exact top-k routing (renormed
    gates scattered to their experts) — the one copy of the routing
    semantics shared by the float and W8A8 drop-free paths."""
    e = probs.shape[-1]
    gates, idx = _route(probs, top_k)
    w = torch.zeros_like(probs)
    for k in range(top_k):
        w = w + gates[:, k:k + 1] * F.one_hot(idx[:, k], e).to(probs.dtype)
    return w


def moe_apply_no_drop(xt, wg, w_gate, w_up, w_down, top_k):
    """Inference-form MoE: exact top-k routing with no capacity drops
    (training capacity makes a token's output depend on the other
    tokens of its batch, so cached and recomputed decoding would
    diverge): every expert evaluates every token, the combine mask
    keeps its top-k."""
    w = _topk_combine(_router_probs(xt, wg), top_k)          # [T, E]
    cdt = xt.dtype
    gate_h = torch.einsum("td,edh->teh", xt, w_gate)
    up_h = torch.einsum("td,edh->teh", xt, w_up)
    h = (gate_h * torch.sigmoid(gate_h)) * up_h
    expert_out = torch.einsum("teh,ehd->ted", h, w_down)
    return torch.einsum("te,ted->td", w.to(cdt), expert_out)


def _act_quant(x):
    """Per-row dynamic activation quantization (absmax over the last,
    contracted axis): int8 values and a float32 scale [..., 1]. Both
    divisions are float32 divisions by a tensor (CUDA turns a division by
    a Python scalar into a product with its reciprocal, a bit apart) and
    the rounding is half to even, as the reference's ``jnp.round``, so
    equal inputs quantize bit for bit alike on either device."""
    xf = x.float()
    m = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    s = m / torch.full_like(m, 127.0)
    return torch.round(xf / s).to(torch.int8), s


def moe_apply_no_drop_q(xt, wg, w_gate, w_up, w_down, scales, top_k):
    """W8A8 drop-free MoE serving: the routing and combine of
    :func:`moe_apply_no_drop` (the router stays float — tiny, and its
    ranking is the routing decision), the three expert product stacks
    int8 x int8 → int32 (``int8_einsum``, exact) with dynamic per-row
    activation quantization, as the reference's native int8 dots.

    w_gate/w_up: int8 [E, D, H]; w_down: int8 [E, H, D];
    scales: {"gate": [E,1,H], "up": [E,1,H], "down": [E,1,D]} float.
    """
    from .transformer_ops import int8_einsum
    probs = _router_probs(xt, wg)
    e = probs.shape[-1]
    w = _topk_combine(probs, top_k)                          # [T, E]
    cdt = xt.dtype
    xq, xs = _act_quant(xt)                        # [T,D] i8, [T,1] f32
    sg = scales["gate"].reshape(1, e, -1).float()            # [1,E,H]
    su = scales["up"].reshape(1, e, -1).float()
    sd = scales["down"].reshape(1, e, -1).float()            # [1,E,D]
    g32 = int8_einsum("td,edh->teh", xq, w_gate)
    u32 = int8_einsum("td,edh->teh", xq, w_up)
    gate_h = g32.float() * xs[:, :, None] * sg
    up_h = u32.float() * xs[:, :, None] * su
    h = (gate_h * torch.sigmoid(gate_h)) * up_h              # [T,E,H]
    hq, hs = _act_quant(h)                                   # [T,E,1]
    d32 = int8_einsum("teh,ehd->ted", hq, w_down)
    expert_out = d32.float() * hs * sd                       # [T,E,D]
    return torch.einsum("te,ted->td", w.float(), expert_out).to(cdt)


def _check_ep(e, ep):
    if ep > 1 and e % ep != 0:
        raise ValueError(
            f"moe_ffn: num_experts={e} is not divisible by the mesh "
            f"'ep' axis size {ep}; expert weights cannot shard — "
            "resize the mesh or the expert count")


@register_op("moe_ffn")
def _moe_ffn(ctx, ins, attrs):
    """X [B,S,D]; GateW [D,E]; W_up/W_gate [E,D,H]; W_down [E,H,D].

    SwiGLU experts: down(silu(gate(x)) * up(x)), matching the dense
    Llama FFN so a dense layer can be swapped for an MoE one 1:1.
    Outputs: Out [B,S,D], AuxLoss [] (scalar, pre-weighted by caller).
    Test mode routes drop-free (see moe_apply_no_drop).
    """
    x = ins["X"][0]
    wg = ins["GateW"][0]
    w_up, w_gate, w_down = ins["WUp"][0], ins["WGate"][0], ins["WDown"][0]
    top_k = int(attrs.get("top_k", 2))
    cap_factor = float(attrs.get("capacity_factor", 2.0))
    b, s, d = x.shape
    from ..parallel.mesh import current_mesh
    mesh = current_mesh()
    if mesh is not None:
        _check_ep(w_up.shape[0], mesh.axes.get("ep", 1))
    xt = x.reshape(b * s, d)
    if ctx.is_test:
        out = moe_apply_no_drop(xt, wg, w_gate, w_up, w_down, top_k)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        out, aux = moe_apply(xt, wg, w_gate, w_up, w_down, top_k,
                             cap_factor)
    return {"Out": [out.reshape(b, s, d)], "AuxLoss": [aux.float()]}


# ----------------------------------------------------------------------
# the op over a device mesh (parallel/spmd.py calls it)
# ----------------------------------------------------------------------
class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks over a mesh axis whose result every rank
    then uses alike (replicated): a block's gradient is its own block of
    the (identical) incoming gradient."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        from ..parallel import collectives as C
        ctx.n, ctx.i = C.axis_size(axis, mesh), C.axis_index(axis, mesh)
        with torch.no_grad():
            return C.all_gather(x, axis, axis=0, mesh=mesh)

    @staticmethod
    def backward(ctx, dy):
        return dy.chunk(ctx.n, dim=0)[ctx.i], None, None


def moe_ffn_spmd(spmd, ctx, ins, attrs, rule):
    """``moe_ffn`` over a mesh. X keeps its batch split (dp); expert
    weights are split over 'ep' on their expert dim where the mesh has
    one (replicated elsewhere). Training form: the rank's block of the
    batch is split again over 'ep' (a rank routes T / (dp·ep) tokens);
    the token choices of the whole batch are all-gathered, so capacity
    and queue positions are the single device's; the rank's [E, C, D]
    dispatch rows go to the experts' owners by an all-to-all over 'ep'
    (each capacity slot holds one token of the whole batch, so the
    received rows add up without overlap, and the SwiGLU of a zero row
    is zero), and the expert outputs come back by an all-gather over
    'ep'. The aux loss's two means are partial sums over every token
    split. The training form only: the ParallelExecutor lowers its step
    in train mode, as the reference's does."""
    import torch.distributed.tensor as dt
    from ..parallel import collectives as C
    mesh = spmd.mesh
    names = list(mesh.axes)
    ep = mesh.axes.get("ep", 1)
    x = spmd.gather_except_batch(ins["X"][0])
    wg = ins["GateW"][0]
    w_up, w_gate, w_down = ins["WUp"][0], ins["WGate"][0], ins["WDown"][0]
    e = w_up.shape[0]
    _check_ep(e, ep)
    top_k = int(attrs.get("top_k", 2))
    cap_factor = float(attrs.get("capacity_factor", 2.0))
    d = x.shape[-1]
    x_pl = spmd.batch_placements(x)
    dp_axes = [names[m] for m, p in enumerate(x_pl)
               if isinstance(p, dt.Shard)]

    def expert_w(v):
        want = [dt.Shard(0) if n == "ep" else dt.Replicate() for n in names]
        v = v if not isinstance(v, dt.DTensor) else (
            v if list(v.placements) == want
            else v.redistribute(spmd.dmesh, want))
        if not isinstance(v, dt.DTensor) or not v.requires_grad \
                or not torch.is_grad_enabled():
            return v.to_local() if isinstance(v, dt.DTensor) else v
        # partial over every token split (the dp axes, and 'ep' for the
        # training form's split of the rows)
        return v.to_local(grad_placements=[
            dt.Shard(0) if n == "ep" else
            (dt.Partial() if n in dp_axes else dt.Replicate())
            for n in names])

    split = ep > 1
    token_axes = dp_axes + (["ep"] if split else [])

    def replicated_in(v):
        if not isinstance(v, dt.DTensor):
            return v
        v = v.redistribute(spmd.dmesh, spmd.replicate()) \
            if not all(isinstance(p, dt.Replicate) for p in v.placements) \
            else v
        if not v.requires_grad or not torch.is_grad_enabled():
            return v.to_local()
        return v.to_local(grad_placements=[
            dt.Partial() if n in token_axes else dt.Replicate()
            for n in names])

    lwg = replicated_in(wg)
    lwu, lwgt, lwd = expert_w(w_up), expert_w(w_gate), expert_w(w_down)
    if x.requires_grad and torch.is_grad_enabled():
        lx = x.to_local(grad_placements=[
            dt.Partial() if (n == "ep" and split) else p
            for n, p in zip(names, x_pl)])
    else:
        lx = x.to_local()
    xt = lx.reshape(-1, d)
    t_local = xt.shape[0]
    n_tok = 1
    for a in dp_axes:
        n_tok *= mesh.axes[a]
    t_global = t_local * n_tok
    aux_pl = [dt.Partial() if n in token_axes else dt.Replicate()
              for n in names]

    if split:
        if t_local % ep:
            raise ValueError(
                f"moe_ffn: {t_local} tokens on a rank do not split over "
                f"the mesh 'ep' axis of size {ep}")
        rows = t_local // ep
        j = C.axis_index("ep", mesh)
        xs = xt[j * rows:(j + 1) * rows]
    else:
        xs = xt
    from torch.profiler import record_function
    with record_function(RANGES[0]):
        probs = _router_probs(xs, lwg)
        gates, idx = _route(probs, top_k)
        # every token's choices, in the batch's order (dp-major, then
        # 'ep')
        idx_all = idx
        with torch.no_grad():
            for a in (["ep"] if split else []) + list(reversed(dp_axes)):
                idx_all = C.all_gather(idx_all, a, axis=0, mesh=mesh)
        offset = 0
        stride = t_global
        for a in dp_axes + (["ep"] if split else []):
            stride //= mesh.axes[a]
            offset += C.axis_index(a, mesh) * stride
        pos = _queue_positions(idx_all, e)[offset:offset + xs.shape[0]]
        capacity = _capacity(cap_factor, t_global, top_k, e)
        combine = _combine(gates, idx, pos, e, capacity, probs.dtype)
        dispatch = combine > 0
        if DROPPED is not None:
            DROPPED.append(xs.shape[0] * top_k - dispatch.sum())
    cdt = xs.dtype
    with record_function(RANGES[1]):
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(cdt), xs)
        if ep > 1:
            # [E, C, D] onto the experts' owners: block j of E to 'ep'
            # rank j
            recv = C.all_to_all(expert_in, "ep", split_axis=0,
                                concat_axis=0, mesh=mesh)
            blk = e // ep
            expert_in = recv.reshape(ep, blk, capacity, d).sum(dim=0)
    with record_function(RANGES[2]):
        expert_out = _experts(expert_in, lwgt, lwu, lwd)
    with record_function(RANGES[3]):
        if ep > 1:
            # every rank's tokens read every expert: the gradient of a
            # block sums over the ranks
            expert_out = C.all_gather(expert_out, "ep", axis=0, mesh=mesh)
        out = torch.einsum("tec,ecd->td", combine.to(cdt), expert_out)
        if split:
            out = _GatherRows.apply(out, "ep", mesh)
    mp = probs.sum(dim=0) / t_global
    mf = F.one_hot(idx[:, 0], e).to(probs.dtype).sum(dim=0) / t_global
    mp = spmd.wrap(mp, aux_pl)
    mf = spmd.wrap(mf, aux_pl)
    aux = e * torch.sum(mp.redistribute(spmd.dmesh, spmd.replicate())
                        * mf.redistribute(spmd.dmesh, spmd.replicate()))
    return {"Out": [spmd.wrap(out.reshape(lx.shape), x_pl)],
            "AuxLoss": [aux.float()]}
