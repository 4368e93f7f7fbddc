"""Ring attention — sequence/context parallelism over a mesh axis (port
of ``paddle_tpu/parallel/ring_attention.py``).

The sequence is split over the 'sp' axis: each rank holds one chunk of
q, k and v, and k/v chunks go round the ring with ``ppermute`` while
each rank attends its queries against every chunk in turn, merging the
partial results exactly through their log-sum-exp. A rank holds
O(T/sp) of the sequence.

The reference runs the body inside ``shard_map`` with a ``lax.scan``
over the ring steps; here each rank runs the same steps eagerly on its
own chunk (:func:`ring_attention`). One step is :func:`ring_step`: the
bias from the two chunks' global offsets, the plain biased attention
(``ref_attention_lse`` — the reference's step calls its plain
``_ref_attention_lse``, not the Pallas kernel) and the merge.
"""
import math

import torch

from ..ops.flash_attention import ref_attention_lse
from . import collectives

__all__ = ["ring_attention", "ring_attention_sharded", "ring_step"]

# the reference's mask value (a finite -1e30, so a fully masked chunk
# merges with weight exp(-1e30 - m) = 0 rather than NaN)
_MASKED = -1e30


def _merge(o1, lse1, o2, lse2):
    """Exactly combines two partial attention results with their lse,
    in float32; the output in o1's dtype."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)[..., None]
    w2 = torch.exp(lse2 - m)[..., None]
    o = (o1.float() * w1 + o2.float() * w2) / (w1 + w2)
    lse = m + torch.log(torch.exp(lse1 - m) + torch.exp(lse2 - m))
    return o.to(o1.dtype), lse


def causal_bias(t_local, q_off, k_off, device):
    """[Tl, Tl] float32: 0 where the key's global position is at or
    before the query's, -1e30 elsewhere."""
    rows = q_off + torch.arange(t_local, device=device)[:, None]
    cols = k_off + torch.arange(t_local, device=device)[None, :]
    return torch.where(rows >= cols, 0.0, _MASKED).float()


def attention_with_lse_biased(q, k, v, scale, bias):
    """The reference's ``attention_with_lse_biased``: its plain
    attention with an additive bias."""
    return ref_attention_lse(q, k, v, scale, causal=False, bias=bias)


def ring_step(q, k, v, o_acc, lse_acc, q_off, k_off, causal, scale):
    """One ring step: queries at global offset ``q_off`` attend the
    key/value chunk at ``k_off`` (masked at global positions when
    ``causal``), merged into (``o_acc``, ``lse_acc``)."""
    bias = causal_bias(q.shape[2], q_off, k_off, q.device) if causal \
        else None
    o_part, lse_part = attention_with_lse_biased(q, k, v, scale, bias)
    return _merge(o_acc, lse_acc, o_part, lse_part)


def ring_attention(q, k, v, axis_name, causal=True, scale=None, mesh=None):
    """The body each rank runs: q, k, v [B, H, Tl, D] are this rank's
    chunks of the sequence, chunk i on axis index i. At ring step s the
    rank attends its queries against the chunk that started on index
    (i - s) mod n, with the causal mask at global positions. Every rank
    makes the same ``ppermute`` calls (n - 1 of k and of v; the
    reference's n-th rotation only hands each chunk back to its owner).
    Differentiable: the permutes' gradients go back round the ring."""
    n = collectives.axis_size(axis_name, mesh)
    idx = collectives.axis_index(axis_name, mesh)
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    t_local = q.shape[2]
    o = torch.zeros_like(q)
    lse = torch.full(q.shape[:3], _MASKED, dtype=torch.float32,
                     device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    for s in range(n):
        src = (idx - s) % n
        o, lse = ring_step(q, k, v, o, lse, idx * t_local, src * t_local,
                           causal, scale)
        if s < n - 1:
            k = collectives.ppermute(k, axis_name, perm, mesh)
            v = collectives.ppermute(v, axis_name, perm, mesh)
    return o


def ring_attention_sharded(q, k, v, mesh, axis="sp", causal=True,
                           scale=None):
    """Global entry: q, k, v [B, H, T, D] DTensors with T split as
    ``Shard(2)`` over ``axis`` (other mesh axes as they are); the result
    has the same placements. A plain tensor is this rank's chunk
    already, and the chunk of the result comes back."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(q, DTensor):
        return ring_attention(q, k, v, axis, causal, scale, mesh)
    placements = q.placements
    on_axis = placements[list(mesh.axes).index(axis)]
    if on_axis != Shard(2) or any(x.placements != placements
                                  for x in (k, v)):
        raise ValueError(
            f"ring_attention_sharded takes q, k and v split on T "
            f"(Shard(2)) over {axis!r} with one placement, got "
            f"{[tuple(x.placements) for x in (q, k, v)]}")
    out = ring_attention(q.to_local(), k.to_local(), v.to_local(), axis,
                         causal, scale, mesh)
    return DTensor.from_local(out, q.device_mesh, placements,
                              run_check=False, shape=q.shape,
                              stride=q.stride())
