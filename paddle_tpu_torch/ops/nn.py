"""Neural-network op lowering rules (port of ``paddle_tpu/ops/nn.py``):
the embedding lookup of this slice."""
import torch

from ..core.registry import register_op


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """reference paddle/fluid/operators/lookup_table_op.cc. Ids [..., 1]
    or [...] int; a trailing dim of size 1 is squeezed; padding_idx rows
    return zeros."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    if ids.is_floating_point() or ids.dtype == torch.bool:
        ids = ids.to(torch.int64)
    pad = attrs.get("padding_idx", -1)
    out = w[ids]
    if pad is not None and pad != -1:
        out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}
