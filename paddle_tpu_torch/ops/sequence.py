"""Sequence op lowering rules over SequenceBatch (padded + lengths).

Port of ``paddle_tpu/ops/sequence.py`` (capability parity with
paddle/fluid/operators/sequence_*.cc: sequence_pool, sequence_softmax,
sequence_expand, sequence_conv, sequence_reshape, sequence_pad,
sequence_mask, ...). The reference iterates LoD offset tables on the
host; here, as in the JAX package, every op is a masked dense
computation over [batch, max_len, ...] in plain torch ops. Padding
positions are part of the answer (later dense ops read them), so each
rule writes them exactly as the reference does.
"""
import torch
import torch.nn.functional as F

from ..core.framework import torch_dtype
from ..core.registry import canonical_int, register_op
from ..core.sequence import SequenceBatch, sequence_mask_from_lengths
from .rnn import _recur


def _as_seq(v):
    if isinstance(v, SequenceBatch):
        return v
    raise TypeError(
        f"op expected a SequenceBatch (lod_level>0 input), got {type(v)}; "
        "feed variable-length data via DataFeeder / to_sequence_batch")


def _trail(m, ndim):
    """A [B, T] mask shaped to broadcast over [B, T, ...] of ``ndim``."""
    return m.reshape(tuple(m.shape) + (1,) * (ndim - m.dim()))


@register_op("sequence_pool", seq_aware=True)
def _sequence_pool(ctx, ins, attrs):
    seq = _as_seq(ins["X"][0])
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    if seq.lod_level == 2:
        # multi-level LoD: pooling consumes the INNERMOST level, and the
        # result keeps the outer one: [B, S, T, ...] + lengths [B, S]
        # pools over T into a level-1 [B, S, ...] whose lengths are the
        # subsequence counts
        b, s = seq.data.shape[:2]
        inner = SequenceBatch(seq.data.reshape((b * s,)
                                               + tuple(seq.data.shape[2:])),
                              seq.lengths.reshape(b * s))
        pooled = _pool_level1(inner, ptype)
        out = SequenceBatch(pooled.reshape((b, s) + tuple(pooled.shape[1:])),
                            seq.sub_counts())
        if ptype == "MAX":
            im = _trail(inner.mask(torch.bool), inner.data.dim())
            mi = torch.argmax(torch.where(im, inner.data, -torch.inf), dim=1)
            max_index = mi.reshape((b, s) + tuple(mi.shape[1:]))
        else:
            max_index = torch.zeros(out.data.shape, dtype=canonical_int(),
                                    device=seq.data.device)
        return {"Out": [out], "MaxIndex": [max_index]}
    x = seq.data
    out = _pool_level1(seq, ptype)
    if ptype == "MAX":
        m = _trail(seq.mask(torch.bool), x.dim())
        max_index = torch.argmax(torch.where(m, x, -torch.inf), dim=1)
    else:
        max_index = torch.zeros(out.shape, dtype=canonical_int(),
                                device=x.device)
    return {"Out": [out], "MaxIndex": [max_index]}


def _pool_level1(seq, ptype):
    """Masked pooling over the time axis of a level-1 SequenceBatch."""
    x, lengths = seq.data, seq.lengths
    m = _trail(sequence_mask_from_lengths(lengths, x.shape[1], x.dtype),
               x.dim())
    denom = torch.clamp(lengths.to(x.dtype), min=1).reshape(
        (-1,) + (1,) * (x.dim() - 2))
    if ptype == "AVERAGE":
        return torch.sum(x * m, dim=1) / denom
    if ptype == "SUM":
        return torch.sum(x * m, dim=1)
    if ptype == "SQRT":
        return torch.sum(x * m, dim=1) / torch.sqrt(denom)
    if ptype == "MAX":
        # amax spreads a tie's gradient evenly, as jax's max does
        out = torch.amax(torch.where(m > 0, x, -torch.inf), dim=1)
        return torch.where(lengths.reshape(denom.shape) > 0, out,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    if ptype == "LAST":
        idx = torch.clamp(lengths - 1, min=0)
        idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        return torch.gather(x, 1, idx)[:, 0]
    if ptype == "FIRST":
        return x[:, 0]
    raise ValueError(f"unknown pooltype {ptype}")


def _last_along(data, lengths, axis):
    """data's entry at lengths - 1 (0 for an empty row) along ``axis``."""
    idx = torch.clamp(lengths - 1, min=0)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (data.dim() - idx.dim()))
    shape = list(data.shape)
    shape[axis] = 1
    return torch.gather(data, axis, idx.expand(shape)).squeeze(axis)


@register_op("sequence_first_step", seq_aware=True)
def _sequence_first_step(ctx, ins, attrs):
    seq = _as_seq(ins["X"][0])
    if seq.lod_level == 2:
        # innermost level: first timestep of each subsequence → level-1
        return {"Out": [SequenceBatch(seq.data[:, :, 0], seq.sub_counts())]}
    return {"Out": [seq.data[:, 0]]}


@register_op("sequence_last_step", seq_aware=True)
def _sequence_last_step(ctx, ins, attrs):
    seq = _as_seq(ins["X"][0])
    if seq.lod_level == 2:
        return {"Out": [SequenceBatch(_last_along(seq.data, seq.lengths, 2),
                                      seq.sub_counts())]}
    return {"Out": [_last_along(seq.data, seq.lengths, 1)]}


@register_op("sequence_softmax", seq_aware=True)
def _sequence_softmax(ctx, ins, attrs):
    seq = _as_seq(ins["X"][0])
    x = seq.data
    mask = _trail(seq.mask(torch.bool), x.dim())
    out = torch.softmax(torch.where(mask, x, -torch.inf), dim=1)
    out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                             device=out.device))
    return {"Out": [SequenceBatch(out, seq.lengths)]}


@register_op("sequence_expand", seq_aware=True)
def _sequence_expand(ctx, ins, attrs):
    """x broadcast along y's reference LoD level (padded analogue of
    LoD-expand, reference sequence_expand_op.cc).

    Level-1 y: x [B, D] → [B, T, D] with y's lengths. Level-2 y:
    ``ref_level=0`` expands one x row per OUTER sequence across its
    subsequences ([B, D] → level-1 [B, S, D] with subseq counts as
    lengths); ``ref_level=1``/``-1`` expands one x row per SUBSEQUENCE
    across its timesteps (x level-1 [B, S, D] → level-2 [B, S, T, D]
    with y's inner lengths)."""
    x = ins["X"][0]
    y = _as_seq(ins["Y"][0])
    xd = x.data if isinstance(x, SequenceBatch) else x
    ref_level = int(attrs.get("ref_level", -1))
    if y.lod_level == 2:
        if ref_level == 0:
            out = xd[:, None, :].expand(xd.shape[0], y.data.shape[1],
                                        xd.shape[-1])
            return {"Out": [SequenceBatch(out, y.sub_counts())]}
        out = xd[:, :, None, :].expand(tuple(xd.shape[:2])
                                       + (y.data.shape[2], xd.shape[-1]))
        return {"Out": [SequenceBatch(out, y.lengths, y.outer_counts)]}
    if xd.dim() == 2:
        out = xd[:, None, :].expand(xd.shape[0], y.data.shape[1],
                                    xd.shape[1])
    else:
        out = xd
    return {"Out": [SequenceBatch(out, y.lengths)]}


@register_op("sequence_conv", seq_aware=True)
def _sequence_conv(ctx, ins, attrs):
    """Context-window conv over time (reference sequence_conv_op.cc):
    filter [ctx_len * D, num_filters], zero-padded outside the sequence;
    input and output masked."""
    seq = _as_seq(ins["X"][0])
    w = ins["Filter"][0]
    ctx_len = attrs.get("contextLength", 3)
    ctx_start = attrs.get("contextStart", -(ctx_len // 2))
    x = seq.data
    t = x.shape[1]
    mask = seq.mask(x.dtype)[..., None]
    xm = x * mask
    cols = []
    for i in range(ctx_len):
        off = ctx_start + i
        if off < 0:
            shifted = F.pad(xm, (0, 0, -off, 0))[:, :t]
        elif off > 0:
            shifted = F.pad(xm, (0, 0, 0, off))[:, off:]
        else:
            shifted = xm
        cols.append(shifted)
    stacked = torch.cat(cols, dim=-1)                  # [B, T, ctx*D]
    out = torch.einsum("btc,cf->btf", stacked, w) * mask
    return {"Out": [SequenceBatch(out, seq.lengths)]}


@register_op("sequence_reshape", seq_aware=True)
def _sequence_reshape(ctx, ins, attrs):
    seq = _as_seq(ins["X"][0])
    new_dim = attrs["new_dim"]
    b, t, d = seq.data.shape
    if d % new_dim == 0:
        k = d // new_dim
        out = seq.data.reshape(b, t * k, new_dim)
        lengths = seq.lengths * k
    elif new_dim % d == 0:
        ratio = new_dim // d
        data = seq.data
        if t % ratio:
            pad = ratio - t % ratio
            data = F.pad(data, (0, 0, 0, pad))
            t += pad
        out = data.reshape(b, t // ratio, new_dim)
        # the reference asks each row's len*d to divide by new_dim; the
        # ceiling keeps a partly filled tail row addressable either way
        lengths = (seq.lengths + ratio - 1) // ratio
    else:
        raise ValueError(
            f"sequence_reshape: dim {d} and new_dim {new_dim} must divide "
            "one another")
    return {"Out": [SequenceBatch(out, lengths)]}


@register_op("sequence_concat", seq_aware=True)
def _sequence_concat(ctx, ins, attrs):
    """Time-axis concatenation per row (reference sequence_concat_op.h
    default level): row i becomes x1[i,:l1], x2[i,:l2], ..., padding."""
    seqs = [_as_seq(v) for v in ins["X"]]
    total_t = sum(s.data.shape[1] for s in seqs)
    first = seqs[0].data
    b, tail = first.shape[0], tuple(first.shape[2:])
    out = torch.zeros((b, total_t) + tail, dtype=first.dtype,
                      device=first.device)
    lengths = torch.zeros((b,), dtype=seqs[0].lengths.dtype,
                          device=first.device)
    for s in seqs:
        ts = s.data.shape[1]
        clean = s.data * _trail(s.mask(s.data.dtype), s.data.dim())
        # each row's valid part lands at its running offset; the
        # padding adds zeros, as the reference's row-slice update writes
        pos = lengths[:, None] + torch.arange(ts, device=first.device)
        pos = pos.reshape((b, ts) + (1,) * len(tail)).expand(
            (b, ts) + tail)
        out = out.scatter_add(1, pos, clean)
        lengths = lengths + s.lengths
    out = out * _trail(sequence_mask_from_lengths(lengths, total_t,
                                                  out.dtype), out.dim())
    return {"Out": [SequenceBatch(out, lengths)]}


@register_op("sequence_slice", seq_aware=True)
def _sequence_slice(ctx, ins, attrs):
    seq = _as_seq(ins["X"][0])
    offset = ins["Offset"][0].reshape(-1).to(torch.int64)
    length = ins["Length"][0].reshape(-1).to(torch.int64)
    x = seq.data
    t = x.shape[1]
    # roll each row so its slice starts at 0, then zero the stale tail
    idx = (torch.arange(t, device=x.device)[None, :] + offset[:, None]) % t
    idx = _trail(idx, x.dim()).expand(x.shape)
    rolled = torch.gather(x, 1, idx)
    rolled = rolled * _trail(sequence_mask_from_lengths(length, t,
                                                        rolled.dtype),
                             rolled.dim())
    return {"Out": [SequenceBatch(rolled, length)]}


@register_op("sequence_enumerate", seq_aware=True)
def _sequence_enumerate(ctx, ins, attrs):
    seq = _as_seq(ins["X"][0])
    win = attrs.get("win_size", 2)
    pad = attrs.get("pad_value", 0)
    x = seq.data                         # [B, T] ids
    if x.dim() == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    cols = []
    for i in range(win):
        shifted = F.pad(x, (0, i), value=pad)[:, i:i + t]
        valid = (pos + i) < seq.lengths[:, None]
        cols.append(torch.where(valid, shifted,
                                torch.full((), pad, dtype=x.dtype,
                                           device=x.device)))
    return {"Out": [SequenceBatch(torch.stack(cols, dim=-1), seq.lengths)]}


@register_op("sequence_erase", seq_aware=True)
def _sequence_erase(ctx, ins, attrs):
    """Erases the ``tokens`` by compacting the kept ones to the front
    (padded analogue of sequence_erase_op.cc)."""
    seq = _as_seq(ins["X"][0])
    x = seq.data
    ids = x if x.dim() == 2 else x[..., 0]
    keep = seq.mask(torch.bool)
    for tok in attrs.get("tokens", []):
        keep = keep & (ids != tok)
    # stable compaction: argsort on (not keep)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    data = torch.gather(x, 1, _trail(order, x.dim()).expand(x.shape))
    lengths = keep.sum(dim=1)
    data = data * _trail(sequence_mask_from_lengths(lengths, x.shape[1],
                                                    data.dtype), x.dim())
    return {"Out": [SequenceBatch(data, lengths)]}


@register_op("sequence_mask", seq_aware=True)
def _sequence_mask(ctx, ins, attrs):
    """[b] lengths (or a SequenceBatch's) → [b, maxlen] mask: 1 where the
    position is below the row's length, in ``out_dtype``."""
    x = ins["X"][0]
    lengths = x.lengths if isinstance(x, SequenceBatch) else x.reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError(
            "sequence_mask needs a static maxlen (as the reference "
            "does under XLA); pass maxlen=")
    return {"Y": [sequence_mask_from_lengths(
        lengths, maxlen, torch_dtype(attrs.get("out_dtype", "int64")))]}


@register_op("sequence_pad", seq_aware=True)
def _sequence_pad(ctx, ins, attrs):
    seq = _as_seq(ins["X"][0])
    return {"Out": [seq.data], "Length": [seq.lengths.to(canonical_int())]}


@register_op("sequence_unpad", seq_aware=True)
def _sequence_unpad(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [SequenceBatch(x, ins["Length"][0].reshape(-1)
                                  .to(torch.int64))]}


@register_op("lod_reset", seq_aware=True)
def _lod_reset(ctx, ins, attrs):
    x = ins["X"][0]
    data = x.data if isinstance(x, SequenceBatch) else x
    if ins.get("Y"):
        y = ins["Y"][0]
        lengths = y.lengths if isinstance(y, SequenceBatch) \
            else y.reshape(-1).to(torch.int64)
        return {"Out": [SequenceBatch(data, lengths)]}
    return {"Out": [data]}


@register_op("lod_array_length", seq_aware=True)
def _lod_array_length(ctx, ins, attrs):
    arr = ins["X"][0]
    device = arr.device if isinstance(arr, torch.Tensor) else ctx.device
    return {"Out": [torch.tensor([len(arr)], dtype=canonical_int(),
                                 device=device)]}


# ---------------------------------------------------------------------------
# edit distance (reference edit_distance_op.cc)
# ---------------------------------------------------------------------------


@register_op("edit_distance", seq_aware=True)
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance of each hypothesis row to its reference row,
    the dynamic program run over the padded positions for the whole
    batch at once (rows past a hypothesis's length keep the last row).
    The rows are ``rnn._recur``'s recurrence over the hypothesis's
    padded axis, so an exported distance keeps that length a symbol.
    Within a row, left_m = min(left_{m-1} + 1, a_m) with a_m the
    deletion and substitution costs unrolls to
    left_m = m + min(left_0, min_{k <= m} (a_k - k)): one ``cummin``
    over the reference's padded axis, in integers."""
    hyp = _as_seq(ins["Hyps"][0])
    ref = _as_seq(ins["Refs"][0])
    h = hyp.data if hyp.data.dim() == 2 else hyp.data[..., 0]
    r = ref.data if ref.data.dim() == 2 else ref.data[..., 0]
    dev = h.device
    b, tm, tn = h.shape[0], h.shape[1], r.shape[1]
    cols = torch.arange(tn + 1, device=dev)

    def row_step(carry, hi, v):
        # row i's first cell is i + 1 = prev[:, 0] + 1 on every row that
        # is kept (the rows before a kept row were all kept)
        prev, = carry
        cost = (hi[0][:, None] != r).to(prev.dtype)
        a = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        row = torch.cummin(torch.cat([prev[:, :1] + 1, a], dim=1) - cols,
                           dim=1).values + cols
        return [torch.where(v[:, None], row, prev)], []

    (prev,), _ = _recur(ctx, row_step, [cols.expand(b, tn + 1).contiguous()],
                        [h], torch.arange(tm, device=dev)[None, :]
                        < hyp.lengths[:, None], False)
    d = torch.gather(prev, 1, ref.lengths.reshape(-1, 1).to(torch.int64))
    d = d.to(torch.float32)
    if attrs.get("normalized", True):
        d = d / torch.clamp(ref.lengths.to(torch.float32), min=1.0)[:, None]
    return {"Out": [d.reshape(-1, 1)],
            "SequenceNum": [torch.tensor([h.shape[0]], dtype=canonical_int(),
                                         device=dev)]}
