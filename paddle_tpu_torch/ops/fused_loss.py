"""Fused lm-head + softmax cross-entropy, chunked over the vocabulary
(port of ``paddle_tpu/ops/fused_loss.py``).

``softmax_with_cross_entropy(h @ W, t)`` without the [tokens, vocab]
logits: the forward is an online log-sum-exp over vocab chunks, and the
backward (:class:`FusedHeadCrossEntropy`, the counterpart of the
reference's ``jax.custom_vjp``) recomputes each chunk's logits and
accumulates dH and dW in float32. Extra memory is O(tokens x chunk)
instead of O(tokens x vocab) — at Llama-3's vocabulary (128256) the full
logits and their softmax gradient are gigabytes.

It follows the reference chunk for chunk: chunk i covers columns
[i*chunk, (i+1)*chunk), except the last, which slides back to end at V
(no padded copy of W) with its duplicate columns pushed to -1e30. The
chunk products are plain torch: the reference computes them outside any
Pallas kernel. Each takes its operands in the inputs' dtype and gives
float32 (``preferred_element_type=float32`` in the reference): for
bf16 inputs the logits are never rounded to bf16, on CUDA through
``torch.mm(..., out_dtype=torch.float32)`` and on the CPU as float32
products of the bf16 values, which are exact. The softmax gradient
chunk, float32, enters the two backward products in the inputs' dtype
(float32 for float32 inputs), as the reference's float32 products take
their operands at the TPU's default precision.
"""
import torch

from ..core.registry import register_op

__all__ = ["fused_head_cross_entropy", "FusedHeadCrossEntropy", "NEG_BIG"]

NEG_BIG = -1e30


def _chunk_start(i, chunk, v):
    """Chunk i starts at i*chunk, except the last, slid back to end at
    v."""
    return min(i * chunk, v - chunk)


def _mm_f32(a, b):
    """a @ b with float32 output, the products in a's dtype."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(h, w, i, chunk, v):
    """float32 logits of chunk i, duplicate columns (covered by an
    earlier chunk when the last one slides back) at NEG_BIG. Returns
    (logits, W's chunk, start)."""
    start = _chunk_start(i, chunk, v)
    wc = w[:, start:start + chunk]
    logits = _mm_f32(h, wc)
    dup = i * chunk - start
    if dup > 0:
        logits = torch.cat([torch.full_like(logits[:, :dup], NEG_BIG),
                            logits[:, dup:]], dim=1)
    return logits, wc, start


def _target_hit(t, i, chunk, start):
    """(column of each target in chunk i, whether chunk i holds it as a
    fresh column)."""
    local = t - start
    hit = (local >= 0) & (local < chunk) & (t >= i * chunk)
    return local.clamp(0, chunk - 1), hit


class FusedHeadCrossEntropy(torch.autograd.Function):
    """h [N, D], w [D, V], t [N] int → per-token loss [N] float32; a
    target equal to ``ignore_index`` gets loss 0 and a zero cotangent.
    ``chunk`` must be <= v."""

    @staticmethod
    def forward(ctx, h, w, t, chunk, ignore_index):
        n, v = h.shape[0], w.shape[1]
        m = torch.full((n,), NEG_BIG, dtype=torch.float32, device=h.device)
        s = torch.zeros((n,), dtype=torch.float32, device=h.device)
        tl = torch.zeros((n,), dtype=torch.float32, device=h.device)
        for i in range(-(-v // chunk)):
            logits, _, start = _chunk_logits(h, w, i, chunk, v)
            new_m = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - new_m) \
                + torch.exp(logits - new_m[:, None]).sum(dim=-1)
            m = new_m
            local, hit = _target_hit(t, i, chunk, start)
            picked = torch.gather(logits, 1, local[:, None])[:, 0]
            tl = torch.where(hit, picked, tl)
        loss = torch.log(s) + m - tl
        ctx.save_for_backward(h, w, t, m, s)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return torch.where(t == ignore_index, torch.zeros_like(loss), loss)

    @staticmethod
    def backward(ctx, g):
        h, w, t, m, s = ctx.saved_tensors
        chunk = ctx.chunk
        v = w.shape[1]
        g = torch.where(t == ctx.ignore_index, torch.zeros_like(g),
                        g.float())
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        ht = h.t()
        for i in range(-(-v // chunk)):
            logits, wc, start = _chunk_logits(h, w, i, chunk, v)
            # the softmax chunk times the cotangent, less it at the
            # target; duplicate columns have p == 0 through the mask
            pg = torch.exp(logits - m[:, None]) / s[:, None] * g[:, None]
            local, hit = _target_hit(t, i, chunk, start)
            pg.scatter_add_(1, local[:, None],
                            torch.where(hit, -g, 0.0)[:, None])
            pg = pg.to(h.dtype)
            dh += _mm_f32(pg, wc.t())
            dw[:, start:start + chunk] += _mm_f32(ht, pg)
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


def fused_head_cross_entropy(h, w, t, chunk, ignore_index=-100):
    """Per-token cross entropy of ``h @ w`` against ``t`` ([N, D],
    [D, V], [N]) without the [N, V] logits; ``chunk`` is clamped to V."""
    return FusedHeadCrossEntropy.apply(h, w, t, min(int(chunk), w.shape[1]),
                                       int(ignore_index))


@register_op("fused_head_cross_entropy")
def _fused_head_cross_entropy(ctx, ins, attrs):
    """X [..., D] hidden states, W [D, V] head weight, Label [...] (or
    [..., 1]) int targets → Loss [..., 1] per-token cross entropy."""
    x, w, t = ins["X"][0], ins["W"][0], ins["Label"][0]
    lead = tuple(x.shape[:-1])
    if t.dim() == x.dim() and t.shape[-1] == 1:
        t = t.reshape(t.shape[:-1])
    loss = fused_head_cross_entropy(
        x.reshape(-1, x.shape[-1]), w, t.reshape(-1).to(torch.int64),
        attrs.get("chunk_size", 8192), attrs.get("ignore_index", -100))
    return {"Loss": [loss.reshape(lead + (1,)).float()]}
