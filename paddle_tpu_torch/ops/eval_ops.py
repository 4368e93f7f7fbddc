"""In-graph evaluation op ``chunk_eval`` (sequence labelling P/R/F1).

Port of the ``chunk_eval`` rule of ``paddle_tpu/ops/eval_ops.py``
(capability parity with paddle/fluid/operators/chunk_eval_op.h). The
reference walks LoD sequences on the host; here, as in the JAX
package, chunk segmentation is elementwise begin/end flags over the
padded tags, and matching is a masked scan over the time axis — a torch
loop batched over the rows. ``detection_map`` waits for ROADMAP.md item
'Remaining op families and the zoo' (``core/registry.py`` names it).
"""
import torch

from ..core.registry import canonical_int, register_op
# the reference module's sentinel (its detection_map's), the one
# ops/crf_ctc.py keeps
from .crf_ctc import NEG_INF  # noqa: F401

_SCHEMES = {
    # num_tag_types, tag_begin, tag_inside, tag_end, tag_single
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_flags(labels, num_chunk_types, scheme):
    """Begin/end flags per position (reference chunk_eval_op.h
    ChunkBegin/ChunkEnd). labels [B, T] with out-of-sequence positions
    already set to the 'other' type. Returns (begin, end, type), each
    [B, T]."""
    ntag, t_begin, t_inside, t_end, t_single = _SCHEMES[scheme]
    other = num_chunk_types
    tag = labels % ntag
    typ = labels // ntag
    b = labels.shape[0]

    def edge(v, fill):
        return torch.full((b, 1), fill, dtype=v.dtype, device=v.device)

    prev_tag = torch.cat([edge(tag, -1), tag[:, :-1]], dim=1)
    prev_typ = torch.cat([edge(typ, other), typ[:, :-1]], dim=1)
    next_tag = torch.cat([tag[:, 1:], edge(tag, -1)], dim=1)
    next_typ = torch.cat([typ[:, 1:], edge(typ, other)], dim=1)
    false = torch.zeros_like(labels, dtype=torch.bool)
    true = ~false

    def w(c, a, b_):
        return torch.where(c, a, b_)

    end_or_single = (prev_tag == t_end) | (prev_tag == t_single)
    begin = w(prev_typ == other, typ != other,
            w(typ == other, false,
            w(typ != prev_typ, true,
            w(tag == t_begin, true,
            w(tag == t_inside, end_or_single,
            w(tag == t_end, end_or_single,
            w(tag == t_single, true, false)))))))
    next_begins = (next_tag == t_begin) | (next_tag == t_single)
    end = w(typ == other, false,
          w(next_typ == other, true,
          w(next_typ != typ, true,
          w(tag == t_begin, next_begins,
          w(tag == t_inside, next_begins,
          w((tag == t_end) | (tag == t_single), true, false))))))
    return begin, end, typ


@register_op("chunk_eval", seq_aware=True)
def _chunk_eval(ctx, ins, attrs):
    """Inference/Label: lod_level-1 int sequences of chunk tags.
    Outputs the reference's six: Precision, Recall, F1-Score,
    NumInferChunks, NumLabelChunks, NumCorrectChunks."""
    inf = ins["Inference"][0]
    lab = ins["Label"][0]
    scheme = attrs.get("chunk_scheme", "IOB")
    nct = int(attrs["num_chunk_types"])
    excluded = [int(e) for e in attrs.get("excluded_chunk_types") or []]
    other_tag = nct * _SCHEMES[scheme][0]   # maps to type == other

    inf_data, lengths = inf.data, inf.lengths
    lab_data = lab.data
    if inf_data.dim() == 3:
        inf_data = inf_data[..., 0]
    if lab_data.dim() == 3:
        lab_data = lab_data[..., 0]
    b, t = inf_data.shape
    mask = torch.arange(t, device=inf_data.device)[None, :] \
        < lengths[:, None]
    iseq = torch.where(mask, inf_data, other_tag).to(torch.int64)
    lseq = torch.where(mask, lab_data, other_tag).to(torch.int64)
    ib, ie, ityp = _chunk_flags(iseq, nct, scheme)
    lb, le, ltyp = _chunk_flags(lseq, nct, scheme)
    inc_i, inc_l = ib, lb
    for e in excluded:
        inc_i = inc_i & (ityp != e)
        inc_l = inc_l & (ltyp != e)

    in_match = torch.zeros(b, dtype=torch.bool, device=iseq.device)
    correct = torch.zeros(b, dtype=torch.int64, device=iseq.device)
    for i in range(t):
        # the exclusion applies to match starts too
        starts = ib[:, i] & lb[:, i] & (ityp[:, i] == ltyp[:, i]) \
            & inc_i[:, i]
        # a mismatched boundary or type kills any active match
        in_match = in_match & (ib[:, i] == lb[:, i])
        in_match = in_match | starts
        correct = correct + (in_match & ie[:, i] & le[:, i])
        in_match = in_match & ~(ie[:, i] | le[:, i])
    num_i = inc_i.sum().to(canonical_int())
    num_l = inc_l.sum().to(canonical_int())
    num_c = correct.sum().to(canonical_int())
    p = torch.where(num_i > 0, num_c / torch.clamp(num_i, min=1), 0.0)
    r = torch.where(num_l > 0, num_c / torch.clamp(num_l, min=1), 0.0)
    f1 = torch.where(num_c > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                     0.0)
    return {"Precision": [p.to(torch.float32)],
            "Recall": [r.to(torch.float32)],
            "F1-Score": [f1.to(torch.float32)],
            "NumInferChunks": [num_i],
            "NumLabelChunks": [num_l],
            "NumCorrectChunks": [num_c]}
