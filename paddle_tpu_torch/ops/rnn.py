"""Recurrent op lowering rules: dynamic_lstm, dynamic_gru, lstm_unit,
gru_unit, and the generic ``scan`` op behind StaticRNN / DynamicRNN.

Port of ``paddle_tpu/ops/rnn.py`` (capability parity with
paddle/fluid/operators/{lstm_op, gru_op, lstm_unit_op, gru_unit_op}.cc).
The reference batch-reorders sequences by length and runs per-timestep
kernels; the JAX package runs ``lax.scan`` over the padded time axis;
here each recurrence is a plain torch loop over that axis, with the
reference's validity mask freezing finished rows: a forward recurrence
holds the last valid state at the padded steps, a reversed one (which
flips the whole padded axis) holds its initial state there. ``scan``
evaluates its sub-block once a time step in the same kind of loop.
"""
import torch

from ..core.registry import register_op
from ..core.sequence import SequenceBatch

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda x: x}
# gru_unit's integer activation codes (reference gru_unit_op.h)
_ACT_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(name):
    if isinstance(name, int):
        name = _ACT_CODES.get(name, "sigmoid")
    return _ACTS[name]


def _steps(x, lengths, is_reverse):
    """(time index, [B, 1] validity of that step) in the order the
    recurrence visits the padded axis."""
    t = x.shape[1]
    valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    order = range(t - 1, -1, -1) if is_reverse else range(t)
    return [(i, valid[:, i, None]) for i in order]


def _collect(outs, is_reverse):
    """Per-step [B, H] values in visiting order → [B, T, H] in time
    order."""
    if is_reverse:
        outs = outs[::-1]
    return torch.stack(outs, dim=1)


@register_op("lstm", seq_aware=True)
def _lstm(ctx, ins, attrs):
    """reference paddle/fluid/operators/lstm_op.cc: Input is the projected
    sequence [B, T, 4H] (x @ Wx done outside by fc); Weight [H, 4H] is the
    recurrent weight; Bias [4H] or [7H] (the last 3H the peepholes)."""
    seq = ins["Input"][0]
    if not isinstance(seq, SequenceBatch):
        raise TypeError("dynamic_lstm needs a SequenceBatch input")
    x, lengths = seq.data, seq.lengths
    w = ins["Weight"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    h_dim = w.shape[0]
    is_reverse = attrs.get("is_reverse", False)
    act_g = _act(attrs.get("gate_activation", "sigmoid"))
    act_c = _act(attrs.get("cell_activation", "tanh"))
    act_h = _act(attrs.get("candidate_activation", "tanh"))
    b_gates = peep = None
    if bias is not None:
        b_gates = bias[:4 * h_dim]
        if attrs.get("use_peepholes", False) and bias.shape[0] > 4 * h_dim:
            wic, wfc, woc = torch.split(bias[4 * h_dim:], h_dim)
            peep = True
    b = x.shape[0]
    h = ins["H0"][0] if ins.get("H0") else \
        torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)
    c = ins["C0"][0] if ins.get("C0") else \
        torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)
    hs, cs = [], []
    for t, valid in _steps(x, lengths, is_reverse):
        gates = x[:, t] + h @ w
        if b_gates is not None:
            gates = gates + b_gates
        i, f, c_hat, o = torch.split(gates, h_dim, dim=-1)
        if peep:
            i = i + c * wic
            f = f + c * wfc
        i, f = act_g(i), act_g(f)
        c_new = f * c + i * act_c(c_hat)
        if peep:
            o = o + c_new * woc
        h_new = act_g(o) * act_h(c_new)
        # a finished row keeps its state (m·new + (1 − m)·old for a 0/1
        # mask, which is this choice exactly for finite values)
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [SequenceBatch(_collect(hs, is_reverse), lengths)],
            "Cell": [SequenceBatch(_collect(cs, is_reverse), lengths)]}


@register_op("gru", seq_aware=True)
def _gru(ctx, ins, attrs):
    """reference paddle/fluid/operators/gru_op.cc: Input [B, T, 3H]
    projected; Weight [H, 3H] ([., :2H] update/reset, [., 2H:]
    candidate); h = z·h_prev + (1 − z)·c, as fluid's gru."""
    seq = ins["Input"][0]
    if not isinstance(seq, SequenceBatch):
        raise TypeError("dynamic_gru needs a SequenceBatch input")
    x, lengths = seq.data, seq.lengths
    w = ins["Weight"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    h_dim = w.shape[0]
    is_reverse = attrs.get("is_reverse", False)
    act_g = _act(attrs.get("gate_activation", "sigmoid"))
    act_c = _act(attrs.get("activation", "tanh"))
    w_rz, w_c = w[:, :2 * h_dim], w[:, 2 * h_dim:]
    b = x.shape[0]
    h = ins["H0"][0] if ins.get("H0") else \
        torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)
    hs = []
    for t, valid in _steps(x, lengths, is_reverse):
        xt = x[:, t]
        if bias is not None:
            xt = xt + bias
        rz = act_g(xt[:, :2 * h_dim] + h @ w_rz)
        r, z = torch.split(rz, h_dim, dim=-1)
        c = act_c(xt[:, 2 * h_dim:] + (r * h) @ w_c)
        h = torch.where(valid, z * h + (1 - z) * c, h)
        hs.append(h)
    return {"Hidden": [SequenceBatch(_collect(hs, is_reverse), lengths)]}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """Single LSTM step (reference lstm_unit_op.cc): X [B, 4H] pre-gates,
    C_prev [B, H]."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    forget_bias = attrs.get("forget_bias", 0.0)
    i, f, c_hat, o = torch.chunk(x, 4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev + \
        torch.sigmoid(i) * torch.tanh(c_hat)
    h = torch.sigmoid(o) * torch.tanh(c)
    return {"C": [c], "H": [h]}


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """Single GRU step (reference gru_unit_op.cc): Input [B, 3H] projected,
    HiddenPrev [B, H], Weight [H, 3H]; activations by name or by the
    reference's integer codes."""
    x, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    h_dim = h_prev.shape[-1]
    if ins.get("Bias"):
        x = x + ins["Bias"][0]
    act_g = _act(attrs.get("gate_activation", 1))
    act_c = _act(attrs.get("activation", 2))
    rz = act_g(x[:, :2 * h_dim] + h_prev @ w[:, :2 * h_dim])
    r, z = torch.split(rz, h_dim, dim=-1)
    c = act_c(x[:, 2 * h_dim:] + (r * h_prev) @ w[:, 2 * h_dim:])
    h = z * h_prev + (1 - z) * c
    return {"Hidden": [h], "ResetHiddenPrev": [r * h_prev], "Gate": [rz]}


# ---------------------------------------------------------------------------
# generic scan op — the lowering target of StaticRNN / DynamicRNN
# ---------------------------------------------------------------------------


@register_op("scan", seq_aware=True)
def _scan(ctx, ins, attrs):
    """Runs a sub-block once a time step (the reference's ``lax.scan``)
    in a torch loop over the padded time axis.

    inputs  X:    per-step sequences ([B, T, ...] dense or SequenceBatch)
            Init: initial state values
    attrs   sub_block, x_names, state_in_names, state_out_names,
            out_names, masked (freeze finished rows using X's lengths)
    outputs Out: collected per-step outputs [B, T, ...] (SequenceBatch
                 with the step input's lengths when it was one)
            FinalState: last state values

    The masked update is the reference's arithmetic ``m·new + (1 − m)·
    old``, so gradients agree with it. Each step binds its slices and
    states into a child ``Env`` of the op's own, so the body's sequence
    ops see the outer SequenceBatch values."""
    from ..core.lowering import Env

    sub_block = attrs["sub_block"]
    x_names = attrs.get("x_names", [])
    st_in = attrs.get("state_in_names", [])
    st_out = attrs.get("state_out_names", [])
    out_names = attrs.get("out_names", [])
    masked = attrs.get("masked", False)

    lengths = None
    xs = []
    for v in ins.get("X", []):
        if isinstance(v, SequenceBatch):
            lengths = v.lengths if lengths is None else lengths
            v = v.data
        xs.append(v)
    states = list(ins.get("Init", []))
    t = xs[0].shape[1] if xs else attrs.get("num_steps")
    b = xs[0].shape[0] if xs else states[0].shape[0]
    device = xs[0].device if xs else states[0].device
    if masked and lengths is not None:
        mask = (torch.arange(t, device=device)[None, :]
                < lengths[:, None]).to(torch.float32)
    else:
        mask = torch.ones((b, t), dtype=torch.float32, device=device)

    outer_env = ctx.env
    outs = [[] for _ in out_names]
    for i in range(t):
        env = Env(parent=outer_env)
        for name, x in zip(x_names, xs):
            env[name] = x[:, i]
        for name, val in zip(st_in, states):
            env[name] = val
        ctx.eval_block(sub_block, env)
        new_states = []
        for name, old in zip(st_out, states):
            new = env[name]
            if masked:
                mm = mask[:, i].reshape(
                    (-1,) + (1,) * (new.dim() - 1)).to(new.dtype)
                new = mm * new + (1 - mm) * old
            new_states.append(new)
        states = new_states
        for acc, name in zip(outs, out_names):
            acc.append(env[name])
    collected = [torch.stack(o, dim=1) for o in outs]
    if lengths is not None:
        collected = [SequenceBatch(c, lengths) for c in collected]
    return {"Out": collected, "FinalState": states}
