"""Transformer-family op lowering rules (port of
``paddle_tpu/ops/transformer_ops.py``): RMSNorm, rotary embeddings,
multi-head attention on the flash kernel, SiLU, the layer-stacked
decoder ``llama_decoder_stack``, the fused KV-cache generators
``llama_generate`` and ``llama_spec_generate`` with their sampling
(``warp_logits``), W8A8 (``qmat``) and int8 KV cache, and the paged-KV
ops of the continuous-batching decode engine (``llama_paged_prefill``,
``llama_paged_prefill_chunk``, ``llama_paged_decode``,
``llama_paged_spec_step``), and the 1F1B pipelined loss
``llama_stack_1f1b_loss``.

rms_norm, rope and silu are plain torch: XLA fused them in the
reference and no Pallas kernel exists for them. Attention goes through
K1 forward and K2/K3 backward (ops/flash_attention.py), except on a
mesh 'sp' axis, where it is the ring (parallel/ring_attention.py,
plain attention a step, as the reference's ring). The generators'
cached attention and the paged ops' attention are plain torch too, as
the reference's are plain jax (grouped einsums against the n_kv cache).
"""
import math

import torch
from torch.utils import checkpoint as _ckpt

from ..core.lowering import _mix_seed
from ..core.registry import register_op
from .flash_attention import flash_attention
from .fused_loss import fused_head_cross_entropy
from .moe import _act_quant, moe_apply_no_drop, moe_apply_no_drop_q

# the attributes under which a mesh's rules (parallel/spmd.py) hand an
# op what its local blocks are; never stored on a program:
# multihead_attention's q, k and v are chunks of the sequence over the
# 'sp' axis of this mesh (the reference's ring branch)
SP_RING = "__sp_ring__"
# the layer-stacked ops run their stage of the pipeline over the 'pp'
# axis: (mesh, microbatches)
PIPELINE = "__pipeline__"
# llama_stack_1f1b_loss off the pipeline gives per-token losses [B, T]
# (the rule averages them over the batch's shards)
TOKEN_LOSSES = "__token_losses__"


def rms_normalize(x, scale=None, eps=1e-6):
    """float32-accumulated RMS norm, output in x.dtype."""
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(dt)


@register_op("rms_norm")
def _rms_norm(ctx, ins, attrs):
    scale = ins["Scale"][0] if ins.get("Scale") else None
    return {"Y": [rms_normalize(ins["X"][0], scale,
                                attrs.get("epsilon", 1e-6))]}


def apply_rope_at(x, positions, base=10000.0):
    """x: [B, T, H, D]; positions: [T] absolute positions shared by the
    batch, or [B, T] per-row positions. Rotates feature pairs
    (d, d + D/2) (neox style) in float32."""
    d = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d))
    freqs = positions.float()[..., None] * inv            # [(B,)T, D/2]
    if freqs.dim() == 2:
        cos = torch.cos(freqs)[None, :, None, :]
        sin = torch.sin(freqs)[None, :, None, :]
    else:
        cos = torch.cos(freqs)[:, :, None, :]
        sin = torch.sin(freqs)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, base=10000.0, position_offset=0):
    """x: [B, T, H, D] at positions offset..offset+T."""
    t = x.shape[1]
    return apply_rope_at(
        x, position_offset + torch.arange(t, device=x.device), base)


def warp_logits(logits, temperature, top_k=0, top_p=1.0):
    """The sampling logits processors — temperature scaling, top-k
    truncation, top-p (nucleus) filtering — on raw logits ([..., V]);
    masked entries go to -1e30. Shared by ``llama_generate``'s sampler
    and ``llama_spec_generate``'s speculative sampler, which must warp
    alike (speculative sampling preserves the WARPED target
    distribution). Deterministic: the reference's own computation, step
    for step. ``temperature`` must be > 0 (greedy is argmax on raw
    logits)."""
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        # top_p == 0 would otherwise take the threshold of the SMALLEST
        # sorted logit and silently disable filtering
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest prefix with cumulative mass >= top_p stays
        cut = (cum - probs < top_p).sum(dim=-1) - 1
        thresh = sorted_l.gather(-1, cut[..., None])
        logits = torch.where(logits < thresh, -1e30, logits)
    return logits


@register_op("rope")
def _rope(ctx, ins, attrs):
    return {"Out": [apply_rope(ins["X"][0], attrs.get("base", 10000.0))]}


def attention_core(q, k, v, causal=True, scale=None, allow_ring=True,
                   ring_mesh=None):
    """GQA-aware attention on [B, T, H, D] tensors: repeats each kv head
    for its group of q heads (``repeat_interleave``, as the reference's
    ``jnp.repeat`` on the head axis), moves heads next to batch and runs
    the flash kernel. Under a device mesh it runs on each rank's own
    batch and heads (parallel/spmd.py). ``ring_mesh``: the mesh whose
    'sp' axis splits q, k and v's sequence (each rank's chunk); with
    ``allow_ring`` and an 'sp' axis past 1 the attention is the ring
    over it, which, as the reference's ring branch, drops ``scale``
    (1/sqrt(D) always: ROADMAP.md section 3, R3)."""
    if k.shape[2] != q.shape[2]:  # GQA repeat kv heads
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if (allow_ring and ring_mesh is not None
            and ring_mesh.axes.get("sp", 1) > 1):
        from ..parallel.ring_attention import ring_attention_sharded
        ot = ring_attention_sharded(qt, kt, vt, ring_mesh, axis="sp",
                                    causal=causal)
    else:
        ot = flash_attention(qt, kt, vt, causal, scale)
    return ot.transpose(1, 2)


@register_op("multihead_attention")
def _mha(ctx, ins, attrs):
    """Q,K,V: [B, T, H, D] (K/V may have fewer heads — GQA). Ring
    attention where a mesh's rule hands the op sequence chunks over a
    real 'sp' axis (long-context sequence parallelism), else the flash
    kernel."""
    return {"Out": [attention_core(ins["Q"][0], ins["K"][0], ins["V"][0],
                                   attrs.get("causal", True),
                                   attrs.get("scale"),
                                   ring_mesh=attrs.get(SP_RING))]}


@register_op("silu")
def _silu(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x * torch.sigmoid(x)]}


_STACK_SLOTS = ("AttnNorm", "Wq", "Wk", "Wv", "Wo",
                "MlpNorm", "WGate", "WUp", "WDown")
_MOE_SLOTS = ("MoeRouter", "MoeWGate", "MoeWUp", "MoeWDown")
# the attribute under which a mesh's rule (parallel/spmd.py) hands
# llama_generate the tensor-parallel sum of decoder_block's ``reduce``;
# never stored on a program
TP_REDUCE = "__tp_reduce__"
_MATMUL_SLOTS = ("Wq", "Wk", "Wv", "Wo", "WGate", "WUp", "WDown")

# int8 x int8 products summed in float32 stay exact while every partial
# sum is an integer below 2**24: at most this many terms of 127**2 each
EXACT_F32_TERMS = 1040
# torch._int_mm on CUDA takes more than 16 rows, and an inner and outer
# width that are multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def int8_mm(a, b):
    """``a @ b`` of int8 [M, K] by int8 [K, N] with an exact int32 sum
    (``torch._int_mm``, the library's int8 GEMM — the reference leaves
    this product to XLA outside any kernel). On CUDA fewer than 17 rows
    are padded with zero rows, which give zero rows and change nothing
    else; a width the GEMM does not take raises."""
    if a.device.type == "cuda":
        k, n = b.shape
        if k % _INT_MM_ALIGN or n % _INT_MM_ALIGN:
            raise ValueError(
                f"int8_mm on CUDA needs the inner and outer widths to be "
                f"multiples of {_INT_MM_ALIGN}, got [{a.shape[0]}, {k}] x "
                f"[{k}, {n}]")
        m = a.shape[0]
        if m < _INT_MM_MIN_ROWS:
            pad = a.new_zeros((_INT_MM_MIN_ROWS - m, k))
            return torch._int_mm(torch.cat([a, pad]), b)[:m]
    return torch._int_mm(a, b)


def int8_einsum(eq, a, b):
    """The int32 ``einsum(eq, a, b)`` of two int8 tensors, exact: torch has
    no batched int8 product, so the operands go to float32 (every int8 is
    exact there, and in TF32) and the one contracted index is summed in
    chunks of at most :data:`EXACT_F32_TERMS` terms, each exact in a
    float32 accumulator, converted to int32 and added."""
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    (c,) = [ch for ch in sa if ch in sb and ch not in out]
    ia, ib = sa.index(c), sb.index(c)
    n = a.shape[ia]
    acc = None
    for s in range(0, n, EXACT_F32_TERMS):
        m = min(EXACT_F32_TERMS, n - s)
        part = torch.einsum(eq, a.narrow(ia, s, m).float(),
                            b.narrow(ib, s, m).float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def qmat(x, p, slot, cdt=None):
    """``x @ p[slot]``, int8-serving aware. When the slot carries a
    ``<Slot>Scale`` companion the weight is int8 and the product is
    W8A8-dynamic, as in the reference: each activation row quantized
    (per-row absmax, :func:`_act_quant`), int8 x int8 → int32 exactly
    (:func:`int8_mm`), then both scales in the reference's order,
    ``(y32 * xs) * scale``, in float32, and the result in ``cdt``
    (default ``x.dtype``)."""
    w = p[slot]
    sc = p.get(slot + "Scale")
    if sc is None:
        return x @ w
    cdt = cdt or x.dtype
    xq, xs = _act_quant(x)
    lead = xq.shape[:-1]
    y32 = int8_mm(xq.reshape(-1, xq.shape[-1]), w).reshape(
        *lead, w.shape[-1])
    y = (y32.float() * xs) * sc.reshape(-1).float()
    return y.to(cdt)


def _reject_quant_scales(ins, op_name):
    """The training-side stack ops never take int8 ``<Slot>Scale``
    companions: a rounded activation has zero gradient, so training
    through it would silently give zero gradients (as the reference's
    ``_reject_quant_scales``)."""
    scales = sorted(k for k in ins if k.endswith("Scale"))
    if scales:
        raise ValueError(
            f"{op_name} got int8 quantization scale inputs {scales}; "
            "the W8A8 path is serving-only (rounding has zero gradient "
            "— training through it would silently produce zero "
            "gradients). Train in bf16/f32 and quantize the trained "
            "scope.")


def decoder_block(p, h, *, n_heads, n_kv, base, eps, pos, attend_fn,
                  moe_top_k=2, reduce=None):
    """One Llama decoder block over one layer's weights ``p`` (the
    ``_STACK_SLOTS``, with ``<Slot>Scale`` companions for int8 weights)
    — the single copy of the block math shared by training
    (``llama_decoder_stack``) and generation (``llama_generate``):
    rms_norm → roped QKV at ``pos`` → ``attend_fn`` → residual →
    rms_norm → SwiGLU → residual. ``attend_fn(q, k, v) -> [b, t,
    n_heads*hd]`` gets the roped q/k and raw v ([b, t, heads, hd]) and
    owns the attention (and any KV-cache side effects). Every product
    goes through :func:`qmat`. With ``MoeRouter`` in ``p`` the FFN is
    the drop-free MoE (ops/moe.py, ``moe_top_k`` experts a token), as
    training's ``moe_ffn`` in test mode, so cached decoding reproduces
    the eval forward; int8 expert stacks (``MoeWGateScale``...) run
    W8A8. ``reduce`` (tensor parallelism: ``p`` holds this rank's
    column / row blocks and ``n_heads``/``n_kv`` its heads) sums the
    row-split products' partial results over the ranks."""
    b, t, _ = h.shape
    hd = p["Wq"].shape[-1] // n_heads
    pre = rms_normalize(h, p["AttnNorm"], eps)
    q = apply_rope_at(qmat(pre, p, "Wq").reshape(b, t, n_heads, hd), pos,
                      base)
    k = apply_rope_at(qmat(pre, p, "Wk").reshape(b, t, n_kv, hd), pos,
                      base)
    v = qmat(pre, p, "Wv").reshape(b, t, n_kv, hd)
    reduce = reduce or (lambda y: y)
    h = h + reduce(qmat(attend_fn(q, k, v), p, "Wo"))
    pre2 = rms_normalize(h, p["MlpNorm"], eps)
    if p.get("MoeRouter") is not None:
        d_model = h.shape[-1]
        xt = pre2.reshape(b * t, d_model)
        if p.get("MoeWGateScale") is not None:      # W8A8 expert stacks
            out = moe_apply_no_drop_q(
                xt, p["MoeRouter"], p["MoeWGate"], p["MoeWUp"],
                p["MoeWDown"],
                {"gate": p["MoeWGateScale"], "up": p["MoeWUpScale"],
                 "down": p["MoeWDownScale"]}, moe_top_k)
        else:
            out = moe_apply_no_drop(xt, p["MoeRouter"], p["MoeWGate"],
                                    p["MoeWUp"], p["MoeWDown"], moe_top_k)
        return h + reduce(out.reshape(b, t, d_model))
    g = qmat(pre2, p, "WGate")
    u = qmat(pre2, p, "WUp")
    return h + reduce(qmat((g * torch.sigmoid(g)) * u, p, "WDown"))


def make_flash_block(n_heads, n_kv, base, eps, remat=True):
    """The training-side decoder block (flash attention, causal). With
    ``remat`` the block runs under non-reentrant
    ``torch.utils.checkpoint`` where autograd records it: only its
    input is kept, and the backward recomputes the block — K1 included —
    before K2 and K3 run (the reference's ``jax.checkpoint``).
    ``allow_ring=False``: the pipeline's stages map only 'pp' and 'dp',
    so the 'sp' ring is not there (and build_llama refuses shard_pp with
    shard_sp)."""
    def block(p, h):
        b, t, _ = h.shape

        def attend(q, k, v):
            return attention_core(q, k, v, causal=True,
                                  allow_ring=False).reshape(b, t, -1)

        return decoder_block(p, h, n_heads=n_heads, n_kv=n_kv, base=base,
                             eps=eps, pos=torch.arange(t, device=h.device),
                             attend_fn=attend)

    if not remat:
        return block

    def remat_block(p, h):
        if not torch.is_grad_enabled():
            return block(p, h)     # nothing to save: no checkpoint
        return _ckpt.checkpoint(block, p, h, use_reentrant=False)

    return remat_block


def pipeline_plan(op_name, n_layers, batch, n_micro, mesh):
    """The microbatch count of a layer-stacked op's pipeline over the
    mesh's 'pp' axis (``n_micro``, default one a stage), with the
    reference's checks on the global sizes: the layers split over the
    stages, the batch over the microbatches, a microbatch over 'dp'."""
    pp = mesh.axes["pp"]
    if n_layers % pp:
        raise ValueError(
            f"{op_name}: {n_layers} layers do not split over the mesh "
            f"'pp' axis of size {pp}")
    nm = int(n_micro) or pp
    if batch % nm:
        raise ValueError(
            f"{op_name}: batch {batch} is not divisible by n_micro={nm} "
            "microbatches")
    dp = mesh.axes.get("dp", 1)
    if (batch // nm) % dp:
        detail = f" (batch {batch} / n_micro {nm})" \
            if op_name == "llama_decoder_stack" else ""
        raise ValueError(
            f"{op_name}: microbatch {batch // nm}{detail} is not divisible "
            f"by the mesh 'dp' axis of size {dp}")
    return nm


def _run_layers(blk, params, h):
    """``blk`` over the layers of the stacked ``params`` (each layer's
    weights ``unbind`` views of the stacks, so the backward writes each
    stack's gradient once)."""
    layers = {s: w.unbind(0) for s, w in params.items()}
    for i in range(len(layers["Wq"])):
        h = blk({s: w[i] for s, w in layers.items()}, h)
    return h


def _micro(x, nm):
    """[B, ...] as [nm, B / nm, ...]."""
    return x.reshape((nm, x.shape[0] // nm) + tuple(x.shape[1:]))


@register_op("llama_decoder_stack")
def _llama_decoder_stack(ctx, ins, attrs):
    """The whole decoder-layer stack as one op with layer-stacked
    weights (leading [L] axis): [rms_norm → GQA attention (rope, flash
    kernels) → rms_norm → SwiGLU] × L, as a Python loop over the layer
    axis — the reference's single-device branch (its ``lax.scan``;
    ``scan_unroll`` changes nothing here).

    Under a mesh with a 'pp' axis past 1 the mesh's rule
    (parallel/spmd.py) hands the op this rank's stage of the stacks and
    its batch block, and the op runs the GPipe schedule over the stages
    (parallel/pipeline.py), ``n_micro`` microbatches (default one a
    stage); the output is the whole stack's on every stage."""
    x = ins["X"][0]                                     # [B, T, D]
    _reject_quant_scales(ins, "llama_decoder_stack")
    n_heads = attrs["n_heads"]
    blk = make_flash_block(n_heads, attrs.get("n_kv_heads", n_heads),
                           attrs.get("rope_base", 10000.0),
                           attrs.get("epsilon", 1e-6),
                           attrs.get("remat", True))
    params = {s: ins[s][0] for s in _STACK_SLOTS}
    pipe = attrs.get(PIPELINE)
    if pipe is None:
        return {"Out": [_run_layers(blk, params, x)]}
    from ..parallel.pipeline import gpipe
    mesh, nm = pipe
    piped = gpipe(lambda sp, h: _run_layers(blk, sp, h), mesh,
                  checkpoint_stages=False)
    stacked = {s: w[None] for s, w in params.items()}
    return {"Out": [piped(stacked, _micro(x, nm)).reshape(x.shape)]}


class _PipeLoss(torch.autograd.Function):
    """The 1F1B schedule's loss, whose gradients the schedule has
    already computed: the backward scales them by the loss's cotangent
    (exact, the output being the scalar loss itself) — the reference's
    ``custom_vjp``."""

    @staticmethod
    def forward(ctx, run, x, tgt, fnorm, head, *weights):
        loss, grads, dx = run(x, tgt, fnorm, head, weights)
        ctx.grads, ctx.dx = grads, dx
        return loss

    @staticmethod
    def backward(ctx, ct):
        def scale(a):
            return (a * ct).to(a.dtype)
        dfnorm, dhead, *dweights = ctx.grads
        out = (None, scale(ctx.dx), None, scale(dfnorm), scale(dhead),
               *(scale(g) for g in dweights))
        del ctx.grads, ctx.dx
        return out


@register_op("llama_stack_1f1b_loss")
def _llama_stack_1f1b_loss(ctx, ins, attrs):
    """The decoder stack plus final norm, lm head and cross entropy as
    one loss-valued op, so that the 1F1B schedule can run the backward
    inside its own forward. Off the pipeline it is the loop over the
    layers and the vocab-chunked loss (``loss_chunk`` columns a chunk,
    ops/fused_loss.py), and autograd applies. Under a mesh with a 'pp'
    axis past 1 the mesh's rule hands the op this rank's stage and
    batch block, and it runs :func:`parallel.pipeline.one_f_one_b`
    (forward and backward interleaved, at most n_stages in-flight
    stage inputs, gradients accumulated in the schedule) inside an
    ``autograd.Function`` whose backward hands the program's autodiff
    those gradients.

    X [B, T, D] embedded tokens; Targets [B, T] int; Loss [] the mean
    cross entropy.
    """
    x = ins["X"][0]
    tgt = ins["Targets"][0]
    _reject_quant_scales(ins, "llama_stack_1f1b_loss")
    params = {s: ins[s][0] for s in _STACK_SLOTS}
    fnorm = ins["FinalNorm"][0]
    head = ins["LmHead"][0]
    n_heads = attrs["n_heads"]
    eps = attrs.get("epsilon", 1e-6)
    blk = make_flash_block(n_heads, attrs.get("n_kv_heads", n_heads),
                           attrs.get("rope_base", 10000.0), eps,
                           attrs.get("remat", True))
    # vocab-chunked: at 128k vocab the [mb*T, vocab] logits would be
    # built a microbatch, and kept for the in-schedule backward
    chunk = min(int(attrs.get("loss_chunk", 8192) or 8192), head.shape[1])

    def token_losses(lp, y, t):
        h2 = rms_normalize(y, lp["fnorm"], eps)
        return fused_head_cross_entropy(
            h2.reshape(-1, h2.shape[-1]), lp["head"],
            t.reshape(-1).to(torch.int64), chunk)

    def ce_loss(lp, y, t):
        return token_losses(lp, y, t).mean()

    lp = {"fnorm": fnorm, "head": head}
    pipe = attrs.get(PIPELINE)
    if pipe is None:
        y = _run_layers(blk, params, x)
        if attrs.get(TOKEN_LOSSES):
            return {"Loss": [token_losses(lp, y, tgt).reshape(tgt.shape)]}
        return {"Loss": [ce_loss(lp, y, tgt)]}

    from ..parallel.pipeline import one_f_one_b
    mesh, nm = pipe
    step = one_f_one_b(lambda sp, h: _run_layers(blk, sp, h), ce_loss, mesh,
                       loss_params=True, return_dx=True)

    def run(x, tgt, fnorm, head, weights):
        stacked = {s: w[None] for s, w in zip(_STACK_SLOTS, weights)}
        loss, grads, lgrads, dx = step(stacked, {"fnorm": fnorm,
                                                 "head": head},
                                       _micro(x, nm), _micro(tgt, nm))
        return loss, [lgrads["fnorm"], lgrads["head"]] + [
            grads[s][0] for s in _STACK_SLOTS], dx.reshape(x.shape)

    return {"Loss": [_PipeLoss.apply(
        run, x, tgt, fnorm, head, *(params[s] for s in _STACK_SLOTS))]}


# ---------------------------------------------------------------------
# KV-cache generation: the reference's fused generators, one op each.
# The reference runs them as one XLA program (a lax.scan over decode
# steps, a bounded lax.while_loop over speculative rounds); here each is
# a Python loop of eager steps with the same trip counts, the same
# masking and the same cache writes (in place: the caches are the op's
# own tensors).
# ---------------------------------------------------------------------

def _generator(device, *parts):
    """A torch.Generator seeded from (seed, fold, ...) — the reference's
    ``jax.random.fold_in(key, i)`` chain."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix_seed(*parts))
    return g


def _categorical(gen, logits):
    """One draw per row from softmax(``logits``) by the Gumbel-max
    trick, as ``jax.random.categorical`` draws (its bits differ)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def _make_cached_runner(params, emb_w, fnorm, head, *, n_heads, n_kv,
                        base, eps, b, total, moe_top_k=2, kv_int8=False,
                        reduce=None):
    """KV-cached model runner shared by llama_generate and
    llama_spec_generate: returns (run_layers, logits_all, k_cache,
    v_cache) over one model's stacked weights ``params`` (slot -> [L,
    ...] tensor, with int8 ``<Slot>Scale`` companions where the caller
    assembled them). The attention is the grouped GQA einsum against the
    small n_kv cache, never expanded to n_heads (that would cost rep x
    the bandwidth the small cache exists to save), with each step's K/V
    written into the cache before it is attended. ``run_layers`` writes
    the caches in place. ``reduce``: see :func:`decoder_block`."""
    n_layers = params["Wq"].shape[0]
    hd = params["Wq"].shape[-1] // n_heads
    rep = n_heads // n_kv
    dev = emb_w.device
    layers = [{s: w[i] for s, w in params.items()} for i in range(n_layers)]
    k_pos = torch.arange(total, device=dev)[None, :]

    def kv_quant(t):
        """Per-(position, kv-head) absmax int8 quantization of a K/V
        block [b, t, g, hd]; the scale [b, t, g] rides beside it."""
        q, s = _act_quant(t)
        return q, s[..., 0]

    def cached_attend(q, kc, vc, q_pos0, t_len):
        qg = q.reshape(b, t_len, n_kv, rep, hd)
        q_pos = q_pos0 + torch.arange(t_len, device=dev)[:, None]
        masked = (k_pos > q_pos)[None, None, None]
        if kv_int8:
            # both contractions int8 x int8 -> int32 (int8_einsum, exact):
            # Q.K^T with per-query-row-quantized q, both scales factored
            # out per output element; the per-position V scale folds into
            # the float32 softmax weights before their row quantization
            qq, qs = _act_quant(qg)                  # qs [b,q,g,r,1]
            l32 = int8_einsum("bqgrd,bkgd->bgrqk", qq, kc["q"])
            logits = (l32.float()
                      * torch.movedim(qs, (1, 2, 3), (3, 1, 2))
                      * kc["s"].transpose(1, 2)[:, :, None, None, :]
                      / math.sqrt(hd))
            w = torch.softmax(logits.masked_fill(masked, -1e30), dim=-1)
            wf = w * vc["s"].transpose(1, 2)[:, :, None, None, :]
            wq8, wsc = _act_quant(wf)                # rows over k
            o32 = int8_einsum("bgrqk,bkgd->bqgrd", wq8, vc["q"])
            out = o32.float() * torch.movedim(wsc, (1, 2, 3), (2, 3, 1))
        else:
            logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                  kc.float()) / math.sqrt(hd)
            w = torch.softmax(logits.masked_fill(masked, -1e30), dim=-1)
            out = torch.einsum("bgrqk,bkgd->bqgrd", w, vc.float())
        return out.to(q.dtype).reshape(b, t_len, n_heads * hd)

    def block_step(i, h, k_caches, v_caches, t0, t_len):
        pos = t0 + torch.arange(t_len, device=dev)

        def attend(q, k, v):
            if kv_int8:
                k8, ks = kv_quant(k)
                v8, vs = kv_quant(v)
                kc = {"q": k_caches["q"][i], "s": k_caches["s"][i]}
                vc = {"q": v_caches["q"][i], "s": v_caches["s"][i]}
                for c, x in ((kc["q"], k8), (kc["s"], ks), (vc["q"], v8),
                             (vc["s"], vs)):
                    c.index_copy_(1, pos, x)
            else:
                kc, vc = k_caches[i], v_caches[i]
                kc.index_copy_(1, pos, k)
                vc.index_copy_(1, pos, v)
            return cached_attend(q, kc, vc, t0, t_len)

        return decoder_block(layers[i], h, n_heads=n_heads, n_kv=n_kv,
                             base=base, eps=eps, pos=pos, attend_fn=attend,
                             moe_top_k=moe_top_k, reduce=reduce)

    def run_layers(h, k_caches, v_caches, t0, t_len):
        """h [b, t_len, D] at positions t0.. (an int or a 0-dim tensor)
        through every layer; writes each layer's K/V at t0.. into the
        caches."""
        for i in range(n_layers):
            h = block_step(i, h, k_caches, v_caches, t0, t_len)
        return h

    def logits_all(h):
        """float32 logits at EVERY position of h [b, t, d] (the verify
        pass scores all candidate positions in one forward)."""
        return (rms_normalize(h, fnorm, eps) @ head).float()

    shape = (n_layers, b, total, n_kv, hd)
    if kv_int8:
        def cache():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=dev)}
        return run_layers, logits_all, cache(), cache()
    return (run_layers, logits_all,
            torch.zeros(shape, dtype=emb_w.dtype, device=dev),
            torch.zeros(shape, dtype=emb_w.dtype, device=dev))


def _refuse_moe(ins, op_name):
    """Speculative decoding is dense-only, as in the reference (whose
    ``build_llama_spec_generator`` refuses MoE configs): MoE generates
    through ``llama_generate``."""
    moe = sorted(s for s in ins if s.startswith("Moe")
                 or s.startswith("DraftMoe"))
    if moe:
        raise NotImplementedError(
            f"{op_name}: got MoE FFN inputs {moe}, but speculative "
            "decoding is dense-only, as in the reference; generate with "
            "an MoE model through build_llama_generator")


@register_op("llama_generate", stateful=True)    # draws iff temperature > 0
def _llama_generate(ctx, ins, attrs):
    """Autoregressive generation with a KV cache as one op: a prefill
    pass over the prompt (causal attention, writing every layer's K/V),
    then ``max_new_tokens - 1`` single-position decode steps that read
    and extend the cache. Greedy at temperature 0, else sampled through
    :func:`warp_logits` (a generator per step from the op's key, as the
    reference folds the step into its key). Weights are the layer-stacked
    tensors the training-side ``llama_decoder_stack`` uses (plus
    embedding, final norm and lm head), so a trained scope generates
    directly; int8 weights with ``<Slot>Scale`` companions (and an int8
    head with ``LmHeadScale``) run W8A8 through :func:`qmat`, and
    ``kv_int8`` keeps an int8 cache.

    Rows that emit ``eos_id`` emit ``pad_id`` from then on; the loop runs
    its fixed count regardless, as the reference's static scan does (no
    early exit). ``unroll_layers`` and ``decode_unroll`` choose XLA's
    unrolling in the reference and change nothing here. MoE inputs
    (``_MOE_SLOTS``, with int8 ``<Slot>Scale`` companions for the expert
    stacks) make every layer's FFN the drop-free MoE.

    Tokens [B, T_prompt] int; Out [B, T_prompt + max_new_tokens]; with
    ``return_probs`` also FirstProbs [B, V], the first decode step's
    distribution from the prefill cache alone.
    """
    tokens = ins["Tokens"][0]
    emb_w = ins["Emb"][0]                               # [V, D]
    params = {s: ins[s][0] for s in _STACK_SLOTS + _MOE_SLOTS if s in ins}
    for s in _MATMUL_SLOTS + ("MoeWGate", "MoeWUp", "MoeWDown"):
        if s + "Scale" in ins:
            params[s + "Scale"] = ins[s + "Scale"][0]
    head_scale = ins["LmHeadScale"][0] if "LmHeadScale" in ins else None
    fnorm = ins["FinalNorm"][0]                         # [D]
    head = ins["LmHead"][0]                             # [D, V]
    n_heads = attrs["n_heads"]
    n_kv = attrs.get("n_kv_heads", n_heads)
    eps = attrs.get("epsilon", 1e-6)
    max_new = attrs["max_new_tokens"]
    eos_id = attrs.get("eos_id", -1)
    eos_id = -1 if eos_id is None else int(eos_id)
    pad_id = int(attrs.get("pad_id", 0) or 0)
    temperature = float(attrs.get("temperature", 0.0))
    top_k = min(int(attrs.get("top_k", 0)), emb_w.shape[0])
    top_p = float(attrs.get("top_p", 1.0))
    # the key is taken whatever the temperature, as the reference's
    # ctx.next_key(): the draw count of later ops stays the reference's
    base_seed = ctx.next_seed()

    b, t_prompt = tokens.shape
    total = t_prompt + max_new
    run_layers, _, k_cache, v_cache = _make_cached_runner(
        params, emb_w, fnorm, head, n_heads=n_heads, n_kv=n_kv,
        base=attrs.get("rope_base", 10000.0), eps=eps, b=b, total=total,
        moe_top_k=int(attrs.get("moe_top_k", 2)),
        kv_int8=bool(attrs.get("kv_int8", False)),
        reduce=attrs.get(TP_REDUCE))

    def logits_of(h_last):
        hn = rms_normalize(h_last, fnorm, eps)
        if head_scale is None:
            return (hn @ head).float()
        return qmat(hn, {"W": head, "WScale": head_scale}, "W",
                    cdt=torch.float32)

    def pick(logits, step):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return _categorical(_generator(logits.device, base_seed, step),
                            warp_logits(logits, temperature, top_k, top_p))

    # prefill over the prompt
    h = run_layers(emb_w[tokens], k_cache, v_cache, 0, t_prompt)
    first_logits = logits_of(h[:, -1])                  # [b, V] float32
    tok = pick(first_logits, 0)                         # [b]
    out = torch.empty((b, total), dtype=tokens.dtype, device=tokens.device)
    out[:, :t_prompt] = tokens
    out[:, t_prompt] = tok
    done = tok == eos_id if eos_id >= 0 else None
    # max_new - 1 decode steps, each emitting the NEXT token (the last new
    # token needs no further forward pass)
    for i in range(max_new - 1):
        pos = t_prompt + i
        x = run_layers(emb_w[tok][:, None, :], k_cache, v_cache, pos, 1)
        tok = pick(logits_of(x[:, 0]), pos)
        if done is not None:
            tok = torch.where(done, torch.full_like(tok, pad_id), tok)
            done = done | (tok == eos_id)
        out[:, pos + 1] = tok
    outs = {"Out": [out]}
    if attrs.get("return_probs", False):
        outs["FirstProbs"] = [torch.softmax(first_logits, dim=-1)]
    return outs


@register_op("llama_spec_generate", stateful=True)   # draws iff temp > 0
def _llama_spec_generate(ctx, ins, attrs):
    """Speculative decoding as one op: a DRAFT model proposes ``gamma``
    tokens autoregressively, the TARGET scores all of them (plus a bonus
    position) in one cached forward, and the longest accepted prefix is
    kept.

    - **greedy** (temperature 0, draws nothing): a draft token is
      accepted iff it equals the target's argmax, so every emitted token
      is the target's argmax at its position — the output equals
      target-only greedy ``llama_generate``.
    - **sampled** (temperature > 0): speculative sampling (Leviathan et
      al. 2022, Chen et al. 2023) — x_j ~ q_j from the draft's warped
      distribution is accepted with probability min(1, p_j(x_j)/q_j(x_j)),
      the first rejection is replaced by a draw from norm(max(p_j - q_j,
      0)), and a fully accepted round draws a bonus token from p_gamma:
      every emitted token is distributed as the warped target
      distribution (distribution-equal to ``llama_generate``'s sampler,
      not bitwise).

    Batch rows advance in lockstep at the minimum per-row acceptance;
    rows that accepted further re-speculate those positions next round.
    The reference's bounded ``lax.while_loop`` is a Python loop over at
    most ``max_new_tokens - 1`` rounds (a round emits at least one
    token) with counters held as tensors, leaving once every token is
    emitted — the reference's loop condition — except while
    ``torch.export`` traces it, where the remaining rounds are traced as
    no-ops (no value may be read back there). int8 scopes and MoE are
    refused, as in the reference. ``Rounds`` counts verification rounds and ``Emitted``
    the tokens emitted, so (Emitted - 1) / Rounds is the achieved
    speculation efficiency.
    """
    _refuse_moe(ins, "llama_spec_generate")
    tokens = ins["Tokens"][0]
    t_params = {s: ins[s][0] for s in _STACK_SLOTS}
    d_params = {s: ins["Draft" + s][0] for s in _STACK_SLOTS}
    emb_w, fnorm, head = (ins["Emb"][0], ins["FinalNorm"][0],
                          ins["LmHead"][0])
    demb, dfnorm, dhead = (ins["DraftEmb"][0], ins["DraftFinalNorm"][0],
                           ins["DraftLmHead"][0])
    for nm, v in [("target", t_params["Wq"]), ("draft", d_params["Wq"]),
                  ("lm_head", head)]:
        if v.dtype == torch.int8:
            raise NotImplementedError(
                f"llama_spec_generate is float-only but the {nm} weights in "
                "the scope are int8 (a quantize_generator_weights'd "
                "scope?): the op declares no <Slot>Scale inputs, so int8 "
                "tensors would flow into float matmuls as garbage. Serve "
                "quantized models through "
                "build_llama_generator(quantize=True).")
    n_heads = attrs["n_heads"]
    n_kv = attrs.get("n_kv_heads", n_heads)
    d_heads = attrs["draft_n_heads"]
    d_kv = attrs.get("draft_n_kv_heads", d_heads)
    base = attrs.get("rope_base", 10000.0)
    eps = attrs.get("epsilon", 1e-6)
    # the draft keeps its own rope base and epsilon
    d_base = attrs.get("draft_rope_base", base)
    d_eps = attrs.get("draft_epsilon", eps)
    max_new = int(attrs["max_new_tokens"])
    gamma = int(attrs.get("gamma", 4))
    eos_id = attrs.get("eos_id", -1)
    eos_id = -1 if eos_id is None else int(eos_id)
    pad_id = int(attrs.get("pad_id", 0) or 0)
    temperature = float(attrs.get("temperature", 0.0))
    top_k = min(int(attrs.get("top_k", 0)), emb_w.shape[0])
    top_p = float(attrs.get("top_p", 1.0))
    sampled = temperature > 0.0
    # greedy takes no key: the draw count of later ops stays unchanged
    base_seed = ctx.next_seed() if sampled else None
    dev = tokens.device

    def warp(logits):
        return warp_logits(logits, temperature, top_k, top_p)

    def gen(*parts):
        return _generator(dev, base_seed, *parts)

    b, t_prompt = tokens.shape
    # room for the largest overshoot: the final round may write gamma + 1
    # tokens starting one short of max_new
    total = t_prompt + max_new + gamma + 1
    t_run, t_logits, tk, tv = _make_cached_runner(
        t_params, emb_w, fnorm, head, n_heads=n_heads, n_kv=n_kv,
        base=base, eps=eps, b=b, total=total)
    d_run, d_logits, dk, dv = _make_cached_runner(
        d_params, demb, dfnorm, dhead, n_heads=d_heads, n_kv=d_kv,
        base=d_base, eps=d_eps, b=b, total=total)

    # prefill both models over the prompt
    th = t_run(emb_w[tokens], tk, tv, 0, t_prompt)
    first_logits = t_logits(th[:, -1:])[:, 0]
    if sampled:
        first = _categorical(gen(0), warp(first_logits))
    else:
        first = torch.argmax(first_logits, dim=-1)           # [b]
    d_run(demb[tokens], dk, dv, 0, t_prompt)

    buf = torch.zeros((b, total), dtype=tokens.dtype, device=dev)
    buf[:, :t_prompt] = tokens
    buf[:, t_prompt] = first
    # pos: the absolute position of cur (the last accepted token, not yet
    # processed by the draft; the target's window starts with it); prev:
    # the token at pos - 1. Counters are 0-dim tensors, so the loop holds
    # no value read back from the device but its eager early exit.
    i64 = dict(dtype=torch.int64, device=dev)
    emitted = torch.ones((), **i64)
    pos = torch.full((), t_prompt, **i64)
    rounds = torch.zeros((), **i64)
    cur, prev = first, tokens[:, -1].to(first.dtype)
    done = first == eos_id if eos_id >= 0 else None
    window = torch.arange(gamma + 1, device=dev)
    # a round emits at least one token: max_new - 1 rounds at most. A
    # round once every token is emitted (possible only when the loop is
    # traced for export, where the eager exit below is off) changes
    # nothing: its writes go to positions nothing reads again, or are
    # masked, and the counters stay.
    for r in range(max_new - 1):
        active = emitted < max_new
        kr = r + 1               # round keys never collide with fold 0
        p0 = torch.where(active, pos, torch.full_like(pos, t_prompt))
        # 1. the draft proposes gamma tokens. The first step processes
        # the 2-token window [prev, cur]: after a fully accepted round
        # the draft never processed its own last proposal, a cache hole
        # at pos - 1 that this fills (and rewrites alike otherwise)
        drafts, qs = [], []
        hx = d_run(demb[torch.stack([prev, cur], dim=1)], dk, dv, p0 - 1, 2)
        dl = d_logits(hx[:, 1:])[:, 0]
        for i in range(gamma):
            if i > 0:
                hx = d_run(demb[d_tok][:, None], dk, dv, p0 + i, 1)
                dl = d_logits(hx)[:, 0]
            if sampled:
                dl = warp(dl)
                d_tok = _categorical(gen(kr, i), dl)
                qs.append(torch.softmax(dl, dim=-1))
            else:
                d_tok = torch.argmax(dl, dim=-1)
            drafts.append(d_tok)
        D = torch.stack(drafts, dim=1)                       # [b, gamma]

        # 2. the target scores cur and every draft in one forward
        cand = torch.cat([cur[:, None], D.to(cur.dtype)], dim=1)
        hx = t_run(emb_w[cand], tk, tv, p0, gamma + 1)
        tl = t_logits(hx)                                    # [b, g+1, V]
        if sampled:
            tl = warp(tl)
            P = torch.softmax(tl, dim=-1)
            Q = torch.stack(qs, dim=1)                       # [b, g, V]
            p_d = P[:, :gamma].gather(-1, D[..., None])[..., 0]
            q_d = Q.gather(-1, D[..., None])[..., 0]
            u = torch.rand((b, gamma), generator=gen(kr, gamma),
                           device=dev, dtype=torch.float32)
            accept = u * q_d < p_d                           # u < p/q
            R = torch.clamp(P[:, :gamma] - Q, min=0.0)
            rs = R.sum(dim=-1, keepdim=True)
            # p == q gives zero residual mass, where a rejection has
            # probability 0: P keeps the (never kept) draw finite
            R = torch.where(rs > 0, R / torch.clamp(rs, min=1e-20),
                            P[:, :gamma])
            res = _categorical(gen(kr, gamma + 1),
                               torch.log(torch.clamp(R, min=1e-30)))
            bonus = _categorical(gen(kr, gamma + 2), tl[:, gamma])
            a_row = torch.cumprod(accept.int(), dim=1).sum(dim=1)
            col = torch.arange(gamma, device=dev)[None, :]
            # column j < a_row: the accepted draft; j == a_row: the
            # residual draw (the bonus at column gamma, kept only when
            # every row accepted all)
            raw = torch.cat([torch.where(col < a_row[:, None], D, res),
                             bonus[:, None]], dim=1)         # [b, g+1]
        else:
            raw = torch.argmax(tl, dim=-1)                   # [b, g+1]

        # 3. the emission window: raw verbatim, or llama_generate's
        # sequential eos rule replayed over it
        if done is not None:
            emits, dones = [], []
            dj = done
            for j in range(gamma + 1):
                e = torch.where(dj, torch.full_like(raw[:, j], pad_id),
                                raw[:, j])
                dj = dj | (e == eos_id)
                emits.append(e)
                dones.append(dj)
            E = torch.stack(emits, dim=1)
            DONES = torch.stack(dones, dim=1)
        else:
            E = raw

        # 4. lockstep acceptance: the longest prefix every row accepted;
        # a done row never throttles the batch (its emissions are pad)
        match = accept if sampled else D == raw[:, :gamma]
        if done is not None:
            match = match | DONES[:, :gamma]
        m = torch.cumprod(match.int(), dim=1).sum(dim=1).min().long()
        m_col = m.expand(b, 1)
        if done is not None:
            done = torch.where(active, DONES.gather(1, m_col)[:, 0], done)
        # columns past m + 1 hold unaccepted values that the next round's
        # write (starting at emitted + m + 1) overwrites before any read
        cols = torch.where(active, t_prompt + emitted + window, window)
        buf.index_copy_(1, cols, torch.where(
            active, E.to(buf.dtype), buf.index_select(1, cols)))
        prev_new = torch.where(m > 0, E.gather(1, (m_col - 1).clamp(min=0))
                               [:, 0], cur)
        cur = torch.where(active, E.gather(1, m_col)[:, 0], cur)
        prev = torch.where(active, prev_new, prev)
        # the draft's caches carry: accepted entries match the emitted
        # tokens, stale ones sit at positions >= pos + m + 1 and are
        # rewritten before any later query attends them
        step = active.long() * (m + 1)
        emitted, pos, rounds = emitted + step, pos + step, \
            rounds + active.long()
        if not torch.compiler.is_exporting() and not bool(
                emitted < max_new):
            break
    return {"Out": [buf[:, :t_prompt + max_new]],
            "Rounds": [rounds.to(torch.int32)],
            "Emitted": [torch.clamp(emitted, max=max_new).to(torch.int32)]}


# ---------------------------------------------------------------------
# Paged KV cache: the continuous-batching decode engine's step ops.
#
# Continuous batching needs requests to join and leave every step while
# the step programs keep one shape, so the cache is a page pool
# [L, n_pages, page_size, g, hd] plus a per-slot page TABLE fed each
# step: allocation is a host-side integer problem (serving/kv_pages.py).
# Page 0 is the null page, never handed out: inactive slots point every
# table entry at it, their writes land there, and nothing a live row
# attends is read from it, because the attention mask bounds each row
# at its own length. Several writes onto page 0 in one index-put (torch
# leaves their order open on CUDA) therefore decide nothing. Reads
# gather pages through the table; writes scatter at (table[pos //
# page_size], pos % page_size), before the position is attended.
#
# Every row's computation depends only on its own row and its own
# pages, so a request's greedy tokens do not depend on its neighbours
# at one step shape. The ops write the pools they are fed in place and
# return them: the engine's pools stay on its device across dispatches
# and are never copied.
# ---------------------------------------------------------------------

class _PagedRunner:
    """Paged twin of :func:`_make_cached_runner` over one model's
    stacked weights, with two forms of the same math:

    - ``forward(h, k_pages, v_pages, table, pos0, t_len)`` works on the
      [L, n_pages, page_size, g, hd] pools through ``table`` [B,
      max_pages] (prefill: one window, one gather a layer);
    - ``gather`` / ``forward_dense`` / ``scatter`` take each row's pages
      into a dense [L, B, kmax, g, hd] cache once, run every step of a
      multi-step op against it, and write it back through the table
      once at the end (the decode and speculative ops).

    The dense view holds the pools' values bit for bit, so both forms
    give the same numbers. int8 ``<Slot>Scale`` companions ride in
    ``params`` as in the contiguous runner (:func:`qmat`)."""

    def __init__(self, params, emb_w, fnorm, head, *, n_heads, n_kv,
                 base, eps, page_size, head_scale=None, moe_top_k=2):
        self.params = params
        self.emb_w = emb_w
        self.fnorm = fnorm
        self.head = head
        self.head_scale = head_scale
        self.n_heads = n_heads
        self.n_kv = n_kv
        self.base = base
        self.eps = eps
        self.page_size = page_size
        self.moe_top_k = moe_top_k
        self.hd = params["Wq"].shape[-1] // n_heads
        self.rep = n_heads // n_kv
        self.layers = [{s: w[i] for s, w in params.items()}
                       for i in range(params["Wq"].shape[0])]

    def _attend_math(self, q, k_all, v_all, q_pos, t_len):
        """GQA attention of a [B, t_len] query window against dense
        [B, kmax] caches in float32, each row masked at its own
        positions: what lies past a row's length gets an exact softmax
        zero (exp(-1e30 - max) is 0.0), so it never reaches a live
        row."""
        b, kmax = k_all.shape[0], k_all.shape[1]
        qg = q.reshape(b, t_len, self.n_kv, self.rep, self.hd)
        keys = torch.arange(kmax, device=q.device)
        visible = keys[None, None] <= q_pos[:, :, None]     # [B, T, K]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                              k_all.float()) / math.sqrt(self.hd)
        logits = logits.masked_fill(~visible[:, None, None], -1e30)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgrqk,bkgd->bqgrd", w, v_all.float())
        return out.to(q.dtype).reshape(b, t_len, self.n_heads * self.hd)

    def _stack_forward(self, h, k_caches, v_caches, q_pos, attend_write):
        """The layer loop shared by both forms: ``attend_write(q, k, v,
        kc, vc) -> out`` writes layer i's caches ``kc``, ``vc`` (views
        of ``k_caches[i]``, ``v_caches[i]``) and attends."""
        for i, p in enumerate(self.layers):
            kc, vc = k_caches[i], v_caches[i]
            h = decoder_block(
                p, h, n_heads=self.n_heads, n_kv=self.n_kv,
                base=self.base, eps=self.eps, pos=q_pos,
                attend_fn=lambda q, k, v, kc=kc, vc=vc: attend_write(
                    q, k, v, kc, vc),
                moe_top_k=self.moe_top_k)
        return h

    # -- paged form (prefill) --------------------------------------------
    def forward(self, h, k_pages, v_pages, table, pos0, t_len):
        """h [B, t_len, D] at positions pos0 [B] + 0.. through every
        layer; writes each position's K/V into its page of the pools
        (in place) before the window attends."""
        b = h.shape[0]
        ps = self.page_size
        kmax = table.shape[1] * ps
        q_pos = pos0.long()[:, None] + torch.arange(t_len,
                                                    device=h.device)[None]
        tbl = table.long()
        pg = torch.gather(tbl, 1, q_pos // ps)              # [B, T]
        off = q_pos % ps

        def attend_write(q, k, v, kp, vp):
            kp[pg, off] = k
            vp[pg, off] = v
            k_all = kp[tbl].reshape(b, kmax, self.n_kv, self.hd)
            v_all = vp[tbl].reshape(b, kmax, self.n_kv, self.hd)
            return self._attend_math(q, k_all, v_all, q_pos, t_len)

        return self._stack_forward(h, k_pages, v_pages, q_pos,
                                   attend_write)

    # -- dense form (decode / spec loops) --------------------------------
    def gather(self, pages, table):
        """[L, P, ps, g, hd] pools -> a dense [L, B, kmax, g, hd] copy of
        each row's pages, in table order."""
        lyr, b = pages.shape[0], table.shape[0]
        return pages[:, table.long()].reshape(
            lyr, b, table.shape[1] * self.page_size, pages.shape[-2],
            pages.shape[-1])

    def scatter(self, pages, dense, table):
        """Write the dense view back through the table, in place, and
        return the pools. Rows' real pages are disjoint; every null
        entry (inactive slots, unallocated tails) lands on page 0,
        which no live row reads."""
        lyr, b = dense.shape[0], dense.shape[1]
        mp = table.shape[1]
        pages[:, table.long()] = dense.reshape(
            lyr, b, mp, self.page_size, dense.shape[-2], dense.shape[-1])
        return pages

    def forward_dense(self, h, k_dense, v_dense, pos0, t_len):
        """h [B, t_len, D] at positions pos0 [B] + 0.. against the dense
        caches, written in place."""
        b = h.shape[0]
        rows = torch.arange(b, device=h.device)[:, None]
        q_pos = pos0.long()[:, None] + torch.arange(t_len,
                                                    device=h.device)[None]

        def attend_write(q, k, v, kd, vd):
            kd[rows, q_pos] = k
            vd[rows, q_pos] = v
            return self._attend_math(q, kd, vd, q_pos, t_len)

        return self._stack_forward(h, k_dense, v_dense, q_pos,
                                   attend_write)

    def logits_of(self, hl):
        hn = rms_normalize(hl, self.fnorm, self.eps)
        if self.head_scale is None:
            return (hn @ self.head).float()
        return qmat(hn, {"W": self.head, "WScale": self.head_scale}, "W",
                    cdt=torch.float32)


def _make_paged_runner(params, emb_w, fnorm, head, *, n_heads, n_kv,
                       base, eps, page_size, head_scale=None,
                       moe_top_k=2):
    return _PagedRunner(params, emb_w, fnorm, head, n_heads=n_heads,
                        n_kv=n_kv, base=base, eps=eps,
                        page_size=page_size, head_scale=head_scale,
                        moe_top_k=moe_top_k)


def _paged_model_inputs(ins, prefix=""):
    """(params, emb, fnorm, head, head_scale) from a paged op's input
    slots, with the int8 ``<Slot>Scale`` companions; ``prefix`` selects
    the draft model's slots of ``llama_paged_spec_step``."""
    params = {s: ins[prefix + s][0] for s in _STACK_SLOTS
              if prefix + s in ins}
    for s in _MATMUL_SLOTS:
        if prefix + s + "Scale" in ins:
            params[s + "Scale"] = ins[prefix + s + "Scale"][0]
    head_scale = (ins[prefix + "LmHeadScale"][0]
                  if prefix + "LmHeadScale" in ins else None)
    return (params, ins[prefix + "Emb"][0], ins[prefix + "FinalNorm"][0],
            ins[prefix + "LmHead"][0], head_scale)


def _target_runner(ins, attrs):
    params, emb_w, fnorm, head, head_scale = _paged_model_inputs(ins)
    run = _make_paged_runner(
        params, emb_w, fnorm, head, n_heads=attrs["n_heads"],
        n_kv=attrs.get("n_kv_heads", attrs["n_heads"]),
        base=attrs.get("rope_base", 10000.0),
        eps=attrs.get("epsilon", 1e-6),
        page_size=attrs["page_size"], head_scale=head_scale)
    return run, emb_w


def _prefill(ins, attrs, offsets):
    """The prefill ops' shared body: the window at ``offsets`` (per row)
    into the pools, and the greedy token after each row's last real
    position."""
    tokens = ins["Tokens"][0]
    lens = ins["Lens"][0].long()
    table = ins["Table"][0]
    kp, vp = ins["KPages"][0], ins["VPages"][0]
    run, emb_w = _target_runner(ins, attrs)
    b = tokens.shape[0]
    h = run.forward(emb_w[tokens], kp, vp, table, offsets, tokens.shape[1])
    last = h[torch.arange(b, device=h.device), lens - 1]
    nxt = torch.argmax(run.logits_of(last), dim=-1).to(tokens.dtype)
    return {"NextTok": [nxt], "KPagesOut": [kp], "VPagesOut": [vp]}


@register_op("llama_paged_prefill")
def _llama_paged_prefill(ctx, ins, attrs):
    """Prefill prompts into paged-KV slots and emit each row's first
    greedy token.

    Tokens [B, T_bucket] int (end-padded to the bucket: pad K/V lands at
    positions >= Lens and is overwritten before it is attended by the
    decode steps that later claim those positions); Lens [B] real prompt
    lengths; Table [B, max_pages] page indices; KPages/VPages [L,
    n_pages, page_size, g, hd]. Outputs NextTok [B] and the pools,
    written in place."""
    tokens = ins["Tokens"][0]
    return _prefill(ins, attrs, torch.zeros(
        (tokens.shape[0],), dtype=torch.long, device=tokens.device))


@register_op("llama_paged_prefill_chunk")
def _llama_paged_prefill_chunk(ctx, ins, attrs):
    """Prefill one slice of each row's prompt at a per-row offset: the
    chunked prefill, which lets a long prompt share dispatches with
    other requests' decode steps.

    Tokens [B, C] int (the slice, end-padded to the chunk width); Lens
    [B] real tokens in this slice; Offsets [B] int the absolute position
    of each row's first slice token; Table, KPages, VPages as in
    ``llama_paged_prefill``. The math is ``llama_paged_prefill``'s
    forward at pos0 = Offsets: every position's K/V depends only on the
    positions up to it, so filling [0, C), [C, 2C), ... writes the
    values one whole-prompt pass writes (the same einsum shapes a
    position attends). NextTok [B] is the greedy token after the
    slice's last real position, meaningful on a prompt's final
    chunk."""
    return _prefill(ins, attrs, ins["Offsets"][0].long())


@register_op("llama_paged_decode")
def _llama_paged_decode(ctx, ins, attrs):
    """``steps`` greedy decode steps over the paged pools, every slot in
    lockstep: one step program per (model, max_batch, steps) whatever
    requests come and go.

    Tokens [B]: each row's last emitted token, not yet cached;
    Positions [B]: the absolute position that token takes (the row's
    cache length). Inactive slots feed token 0, position 1 and an
    all-null table; their outputs are discarded and their writes land
    on the null page. OutTokens [B, steps]. The reference's ``lax.scan``
    over the steps is a Python loop against one dense gather of the
    pools, scattered back once."""
    tok = ins["Tokens"][0]
    pos = ins["Positions"][0].long()
    table = ins["Table"][0]
    kp, vp = ins["KPages"][0], ins["VPages"][0]
    run, emb_w = _target_runner(ins, attrs)
    steps = max(1, int(attrs.get("steps", 1)))
    kd, vd = run.gather(kp, table), run.gather(vp, table)
    toks = []
    for _ in range(steps):
        h = run.forward_dense(emb_w[tok][:, None, :], kd, vd, pos, 1)
        tok = torch.argmax(run.logits_of(h[:, 0]), dim=-1).to(tok.dtype)
        pos = pos + 1
        toks.append(tok)
    return {"OutTokens": [torch.stack(toks, dim=1)],
            "KPagesOut": [run.scatter(kp, kd, table)],
            "VPagesOut": [run.scatter(vp, vd, table)]}


@register_op("llama_paged_spec_step")
def _llama_paged_spec_step(ctx, ins, attrs):
    """One speculative round over the paged pools with per-row
    acceptance (greedy): the draft proposes ``gamma`` tokens a slot, the
    target scores cur and every proposal in one [B, gamma + 1] forward,
    and each row keeps its own longest accepted prefix.

    The draft's first window reprocesses [Prev, Tokens] at pos - 1,
    pos: after a fully accepted round the draft never cached its own
    last proposal, and reprocessing Prev fills that hole (rewriting the
    same values otherwise). Emitted [B, gamma + 1] holds the greedy
    target token after each window position; Accepted [B] (per-row
    m + 1) how many leading entries count. Rejected K/V sits at
    positions >= pos + Accepted and is rewritten before any later query
    attends it."""
    cur = ins["Tokens"][0]
    prev = ins["Prev"][0]
    pos = ins["Positions"][0].long()
    table = ins["Table"][0]
    tkp, tvp = ins["KPages"][0], ins["VPages"][0]
    dkp, dvp = ins["DraftKPages"][0], ins["DraftVPages"][0]
    page_size = attrs["page_size"]
    gamma = max(1, int(attrs.get("gamma", 4)))
    t_run, emb_w = _target_runner(ins, attrs)
    d_params, demb, dfnorm, dhead, d_hscale = \
        _paged_model_inputs(ins, prefix="Draft")
    d_run = _make_paged_runner(
        d_params, demb, dfnorm, dhead, n_heads=attrs["draft_n_heads"],
        n_kv=attrs.get("draft_n_kv_heads", attrs["draft_n_heads"]),
        base=attrs.get("draft_rope_base",
                       attrs.get("rope_base", 10000.0)),
        eps=attrs.get("draft_epsilon", attrs.get("epsilon", 1e-6)),
        page_size=page_size, head_scale=d_hscale)

    dkd, dvd = d_run.gather(dkp, table), d_run.gather(dvp, table)
    tkd, tvd = t_run.gather(tkp, table), t_run.gather(tvp, table)

    # 1. the draft proposes gamma tokens a row
    dh = d_run.forward_dense(demb[torch.stack([prev, cur], dim=1)], dkd,
                             dvd, pos - 1, 2)
    dl = d_run.logits_of(dh[:, 1])
    drafts = []
    for i in range(gamma):
        if i > 0:
            dh = d_run.forward_dense(demb[d_tok][:, None], dkd, dvd,
                                     pos + i, 1)
            dl = d_run.logits_of(dh[:, 0])
        d_tok = torch.argmax(dl, dim=-1).to(cur.dtype)
        drafts.append(d_tok)
    D = torch.stack(drafts, dim=1)                       # [B, gamma]

    # 2. the target scores cur and every proposal in one forward
    cand = torch.cat([cur[:, None], D], dim=1)           # [B, gamma+1]
    th = t_run.forward_dense(emb_w[cand], tkd, tvd, pos, gamma + 1)
    G = torch.argmax(t_run.logits_of(th), dim=-1).to(cur.dtype)

    # 3. each row's longest accepted prefix: row b emits G[b, :m_b + 1]
    match = (D == G[:, :gamma]).to(torch.int32)
    m = torch.cumprod(match, dim=1).sum(dim=1)
    return {"Emitted": [G], "Accepted": [(m + 1).to(torch.int32)],
            "KPagesOut": [t_run.scatter(tkp, tkd, table)],
            "VPagesOut": [t_run.scatter(tvp, tvd, table)],
            "DraftKPagesOut": [d_run.scatter(dkp, dkd, table)],
            "DraftVPagesOut": [d_run.scatter(dvp, dvd, table)]}


# Numerics rule of the paged family (analysis/numcheck.py): tokens are
# finite non-negative integers; each pool output is finite when its pool
# input is (the attention runs in float32 with -1e30 masking: exact
# softmax zeros, never inf arithmetic). One rule covers the four ops,
# each declaring only its own slots.
from ..analysis.numcheck import NumInfo, num_first  # noqa: E402
from ..core.registry import register_numerics  # noqa: E402


def _num_paged_kv(op, ins, attrs):
    tok = NumInfo(0.0, math.inf, finite=True, confident=True)
    out = {"NextTok": [tok], "OutTokens": [tok], "Emitted": [tok],
           "Accepted": [NumInfo(0.0, math.inf, finite=True,
                                confident=True)]}
    for slot, src in (("KPagesOut", "KPages"), ("VPagesOut", "VPages"),
                      ("DraftKPagesOut", "DraftKPages"),
                      ("DraftVPagesOut", "DraftVPages")):
        pool = num_first(ins, src)
        out[slot] = [NumInfo(-math.inf, math.inf, finite=pool.finite,
                             confident=pool.confident)]
    return out


for _t in ("llama_paged_prefill", "llama_paged_prefill_chunk",
           "llama_paged_decode", "llama_paged_spec_step"):
    register_numerics(_t)(_num_paged_kv)
