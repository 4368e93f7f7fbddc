"""Neural-network op lowering rules (port of ``paddle_tpu/ops/nn.py``):
the embedding lookup, the losses of the train programs
(``cross_entropy``, ``softmax_with_cross_entropy``) and the
``squared_l2_norm`` of global-norm gradient clipping."""
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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _hard_label(label):
    """Label [..., 1] or [...] int → [...] int64."""
    lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    return lbl.to(torch.int64)


def _pick(x, lbl, ignore):
    """x[..., lbl] with ignored rows reading class 0, as [..., 1]."""
    safe = torch.where(lbl == ignore, torch.zeros_like(lbl), lbl)
    return torch.gather(x, -1, safe[..., None])


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """reference paddle/fluid/operators/cross_entropy_op.cc: X is a
    probability distribution [N, D]; Label is int64 [N, 1] (or soft
    [N, D])."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-9
    if attrs.get("soft_label", False):
        out = -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        lbl = _hard_label(label)
        ignore = attrs.get("ignore_index", -100)
        picked = _pick(x, lbl, ignore)
        out = torch.where((lbl == ignore)[..., None],
                          torch.zeros_like(picked), -torch.log(picked + eps))
    return {"Y": [out]}


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    lsm = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * lsm, dim=-1, keepdim=True)
    else:
        lbl = _hard_label(label)
        ignore = attrs.get("ignore_index", -100)
        picked = _pick(lsm, lbl, ignore)
        loss = torch.where((lbl == ignore)[..., None],
                           torch.zeros_like(picked), -picked)
    out = {"Loss": [loss]}
    if ctx.wants("Softmax"):   # a train step's loss alone does not
        out["Softmax"] = [torch.exp(lsm)]
    return out


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.square(ins["X"][0])).reshape((1,))]}
