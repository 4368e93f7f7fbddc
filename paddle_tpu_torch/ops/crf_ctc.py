"""Linear-chain CRF, CTC, and beam-search op lowerings.

Port of ``paddle_tpu/ops/crf_ctc.py`` (capability parity with
paddle/fluid/operators/{linear_chain_crf_op, crf_decoding_op,
warpctc_op, ctc_align_op, beam_search_op, beam_search_decode_op}). The
reference computes each as a masked dense dynamic program, ``lax.scan``
over the padded time axis and ``vmap`` over the batch; here the same
arithmetic runs batched over B in a torch loop over the padded axis,
and autograd differentiates it (the reference needs no grad kernels
either). ``crf_decoding``'s loops are ``rnn._recur``'s, so an exported
decoder keeps its padded length a symbol. ``NEG_INF`` is the
reference's sentinel; an infeasible CTC target costs ``inf``, as
there.
"""
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..core.sequence import SequenceBatch
from .moe import _top_k
from .rnn import _recur

NEG_INF = -1e30


def _crf_split(transition):
    """transition is [K+2, K]: row 0 start weights, row 1 end weights,
    rows 2.. the KxK tag-to-tag matrix (reference linear_chain_crf_op.h
    layout)."""
    return transition[0], transition[1], transition[2:]


def _labels(v):
    """A label sequence's padded ids as [B, T] int64."""
    lab = v.data
    if lab.dim() == 3:
        lab = lab[..., 0]
    return lab.to(torch.int64)


def _valid(lengths, t):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


@register_op("linear_chain_crf", seq_aware=True)
def _linear_chain_crf(ctx, ins, attrs):
    """Negative log-likelihood of each row's tag path: the forward
    algorithm over the padded axis (a row past its length keeps its
    alpha) minus the path score. ``Alpha`` holds, as the reference's
    scan emits it, alpha_0 then the carry entering each later step."""
    em = ins["Emission"][0]
    transition = ins["Transition"][0]
    emission, lengths = em.data, em.lengths
    labels = _labels(ins["Label"][0])
    w_start, w_end, trans = _crf_split(transition)
    _, t, _ = emission.shape
    valid = _valid(lengths, t)

    emit = torch.gather(emission, 2, labels[..., None])[..., 0]
    emit_score = torch.where(valid, emit, 0.0).sum(dim=1)
    trans_score = torch.where(valid[:, 1:], trans[labels[:, :-1],
                                                  labels[:, 1:]],
                              0.0).sum(dim=1)
    last = torch.clamp(lengths - 1, min=0)
    path = (emit_score + trans_score + w_start[labels[:, 0]]
            + w_end[torch.gather(labels, 1, last[:, None])[:, 0]])

    alpha = emission[:, 0] + w_start
    alphas = [alpha]
    for i in range(1, t):
        alphas.append(alpha)
        nxt = torch.logsumexp(alpha[:, :, None] + trans, dim=1) \
            + emission[:, i]
        alpha = torch.where(valid[:, i, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + w_end, dim=-1)
    out = {"LogLikelihood": [(log_z - path)[:, None]]}
    if ctx.wants("Alpha"):
        out["Alpha"] = [SequenceBatch(torch.stack(alphas, dim=1), lengths)]
    if ctx.wants("EmissionExps"):
        out["EmissionExps"] = [SequenceBatch(torch.exp(emission), lengths)]
    if ctx.wants("TransitionExps"):
        out["TransitionExps"] = [torch.exp(transition)]
    return out


@register_op("crf_decoding", seq_aware=True)
def _crf_decoding(ctx, ins, attrs):
    """Viterbi path of each row (positions past its length decode to 0);
    with a Label, 1 marks a mis-decoded position (reference
    crf_decoding_op.h). Ties go to the lower tag, as ``argmax``'s. The
    forward pass and the backtrack are recurrences over the padded axis
    (``rnn._recur``), so an exported decoder keeps its length a symbol."""
    em = ins["Emission"][0]
    emission, lengths = em.data, em.lengths
    transition = ins["Transition"][0]
    b, t, k = emission.shape
    valid = _valid(lengths, t)
    keep = torch.arange(k, device=emission.device).expand(b, k)
    first = (torch.arange(t, device=emission.device) == 0).expand(b, t)

    def forward(carry, e, v):
        # step 0 starts the path; a later step extends the best one (the
        # split is taken here: a scanned step closes over no two views
        # of one tensor)
        w_start, _, trans = _crf_split(transition)
        alpha, = carry
        f, v = v[:, 0, None], v[:, 1, None]
        best, best_prev = (alpha[:, :, None] + trans).max(dim=1)
        alpha = torch.where(f, e[0] + w_start,
                            torch.where(v, best + e[0], alpha))
        return [alpha], [torch.where(v & ~f, best_prev, keep)]

    (alpha,), (back,) = _recur(
        ctx, forward, [torch.zeros_like(emission[:, 0])], [emission],
        torch.stack([first, valid], dim=-1), False)

    def backtrack(carry, bp, v):
        # the tag at this step, then the best previous one
        tag, = carry
        return [torch.gather(bp[0], 1, tag[:, None])[:, 0]], [tag]

    _, (path,) = _recur(ctx, backtrack,
                        [torch.argmax(alpha + transition[1], dim=-1)], [back],
                        valid, True)
    path = torch.where(valid, path, 0).to(torch.int32)
    if ins.get("Label"):
        path = (path != _labels(ins["Label"][0])).to(torch.int32)
    return {"ViterbiPath": [SequenceBatch(path, lengths)]}


# ---------------------------------------------------------------------
# CTC


def _ctc_loss(logits, logit_lens, labels, label_lens, blank):
    """CTC negative log-likelihood of each row. logits [B, T, C] raw
    scores, labels [B, U]."""
    b, t, _ = logits.shape
    u = labels.shape[1]
    s = 2 * u + 1
    dev = logits.device
    log_probs = F.log_softmax(logits, dim=-1)
    # extended label sequence: blank z0 blank z1 ... blank zU blank
    s_idx = torch.arange(s, device=dev)
    if u:
        ext = torch.where(s_idx % 2 == 0, blank,
                          labels[:, torch.clamp(s_idx // 2, max=u - 1)])
    else:
        ext = torch.full((b, s), blank, dtype=labels.dtype, device=dev)
    ext_m2 = torch.cat([torch.full((b, 2), -1, dtype=ext.dtype, device=dev),
                        ext[:, :-2]], dim=1)[:, :s]
    can_skip = (ext != blank) & (ext != ext_m2)

    def neg(n):
        return torch.full((b, n), NEG_INF, dtype=log_probs.dtype, device=dev)

    first = [log_probs[:, 0, blank, None]]
    if u:
        first.append(torch.gather(log_probs[:, 0], 1, ext[:, 1:2]))
    alpha = torch.cat(first + [neg(s - len(first))], dim=1)
    for i in range(1, t):
        shift1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg(2), alpha[:, :-2]], dim=1)[:, :s]
        merged = torch.logaddexp(alpha, shift1)
        merged = torch.where(can_skip, torch.logaddexp(merged, shift2),
                             merged)
        nxt = merged + torch.gather(log_probs[:, i], 1, ext)
        alpha = torch.where((i < logit_lens)[:, None], nxt, alpha)

    end = (2 * label_lens)[:, None]
    ll = torch.logaddexp(
        torch.gather(alpha, 1, end)[:, 0],
        torch.where(label_lens > 0,
                    torch.gather(alpha, 1, torch.clamp(end - 1, min=0))[:, 0],
                    NEG_INF))
    # an infeasible target never reaches the end states: a visible inf
    return torch.where(ll < NEG_INF / 2, float("inf"), -ll)


@register_op("warpctc", seq_aware=True)
def _warpctc(ctx, ins, attrs):
    lg = ins["Logits"][0]
    lab = ins["Label"][0]
    logits, logit_lens = lg.data, lg.lengths
    loss = _ctc_loss(logits, logit_lens, _labels(lab), lab.lengths,
                     attrs.get("blank", 0))
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(logit_lens, min=1).to(loss.dtype)
    return {"Loss": [loss[:, None]],
            "WarpCTCGrad": [SequenceBatch(torch.zeros_like(logits),
                                          logit_lens)]}


@register_op("ctc_greedy_decoder", seq_aware=True)
def _ctc_greedy_decoder(ctx, ins, attrs):
    """Per-frame argmax, repeats merged, blanks dropped, the kept tokens
    moved to the front of their row: a scatter into the row's slots plus
    one spare slot, where every dropped token lands, then cut off."""
    probs = ins["Input"][0]
    blank = attrs.get("blank", 0)
    x, lengths = probs.data, probs.lengths
    b, t = x.shape[0], x.shape[1]
    tok = torch.argmax(x, dim=-1).to(torch.int32)          # [B, T]
    prev = torch.cat([torch.full((b, 1), -1, dtype=tok.dtype,
                                 device=tok.device), tok[:, :-1]], dim=1)
    keep = _valid(lengths, t) & (tok != blank) & (tok != prev)
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t)
    out = torch.zeros((b, t + 1), dtype=tok.dtype, device=tok.device)
    out = out.scatter(1, dest, tok)[:, :t]
    return {"Out": [SequenceBatch(out, keep.sum(dim=1).to(torch.int32))]}


# ---------------------------------------------------------------------
# Beam search (dense, fixed-shape)


@register_op("beam_search")
def _beam_search(ctx, ins, attrs):
    """One expansion step. pre_ids/pre_scores [B, beam]; scores
    [B, beam, V] accumulated log-probs of every candidate. Finished
    beams (pre_id == end_id) propagate themselves with unchanged score.
    Outputs selected ids/scores [B, beam] + parent beam index. Ties go
    to the lower flat index, as ``lax.top_k``'s."""
    pre_ids = ins["pre_ids"][0]
    pre_scores = ins["pre_scores"][0]
    scores = ins["scores"][0]
    cand_ids = ins["ids"][0] if ins.get("ids") else None
    beam = attrs["beam_size"]
    end_id = attrs["end_id"]
    b, w, v = scores.shape

    finished = pre_ids == end_id                      # [B, W]
    # a finished beam contributes one candidate, its own score: at
    # end_id over the full vocabulary, else at its first candidate
    slot = end_id if cand_ids is None else 0
    only = torch.full((b, w, v), NEG_INF, dtype=scores.dtype,
                      device=scores.device)
    only[:, :, slot] = pre_scores
    cand = torch.where(finished[:, :, None], only, scores)
    top_scores, top_idx = _top_k(cand.reshape(b, w * v), beam)
    parent = (top_idx // v).to(torch.int32)
    if cand_ids is None:
        sel_ids = (top_idx % v).to(torch.int32)
    else:
        picked = torch.gather(cand_ids.reshape(b, w * v), 1, top_idx)
        forced_end = torch.gather(finished, 1, parent.to(torch.int64))
        sel_ids = torch.where(forced_end, end_id, picked).to(torch.int32)
    return {"selected_ids": [sel_ids], "selected_scores": [top_scores],
            "parent_idx": [parent]}


@register_op("beam_search_decode")
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack stacked per-step beams into full sequences.
    ids/parents [T, B, beam]; scores [B, beam] final accumulated scores.
    Returns sequences [B, beam, T] (padded with end_id) + scores."""
    ids = ins["ids"][0]
    parents = ins["parents"][0].to(torch.int64)
    end_id = attrs["end_id"]
    t, b, w = ids.shape
    ptr = torch.arange(w, device=ids.device).expand(b, w)
    toks = [None] * t
    for i in range(t - 1, -1, -1):
        toks[i] = torch.gather(ids[i], 1, ptr)
        ptr = torch.gather(parents[i], 1, ptr)
    seqs = torch.stack(toks, dim=-1)                  # [B, W, T]
    # length = position after the first end_id (inclusive), T if none
    is_end = seqs == end_id
    first_end = torch.argmax(is_end.to(torch.int32), dim=-1)
    lens = torch.where(is_end.any(dim=-1), first_end + 1, t)
    return {"sentence_ids": [seqs], "sentence_scores": [ins["scores"][0]],
            "sentence_lens": [lens.to(torch.int32)]}


@register_op("beam_expand")
def _beam_expand(ctx, ins, attrs):
    """Repeat each batch row ``beam`` times along axis 0:
    [b, ...] -> [b*beam, ...]."""
    return {"Out": [torch.repeat_interleave(ins["X"][0], attrs["beam_size"],
                                            dim=0)]}


@register_op("beam_gather")
def _beam_gather(ctx, ins, attrs):
    """Reorder per-beam rows by parent beam index: x [b*beam, ...],
    parent [b, beam] -> [b*beam, ...] where row (i, w) =
    x[i*beam + parent[i, w]]."""
    x = ins["X"][0]
    parent = ins["Parent"][0].to(torch.int64)
    b, w = parent.shape
    flat = (torch.arange(b, device=parent.device)[:, None] * w
            + parent).reshape(-1)
    return {"Out": [torch.index_select(x, 0, flat)]}
