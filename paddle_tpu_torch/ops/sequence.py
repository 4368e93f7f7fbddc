"""Sequence op lowering rules (port of ``paddle_tpu/ops/sequence.py``):
``sequence_mask`` on a dense lengths tensor. The other sequence ops and
``SequenceBatch`` wait for ROADMAP.md item 'Remaining op families and
the zoo' (``core/registry.py`` names each), and the executor refuses
sequence feeds until then."""
import torch

from ..core.framework import torch_dtype
from ..core.registry import register_op


@register_op("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    """[b] lengths → [b, maxlen] mask: 1 where the position is below the
    row's length, in ``out_dtype``."""
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError(
            "sequence_mask needs a static maxlen (as the reference "
            "does under XLA); pass maxlen=")
    lengths = ins["X"][0].reshape(-1)
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return {"Y": [(pos < lengths[:, None]).to(
        torch_dtype(attrs.get("out_dtype", "int64")))]}
