"""Recurrent op lowering rules: dynamic_lstm, dynamic_gru, lstm_unit,
gru_unit, and the generic ``scan`` op behind StaticRNN / DynamicRNN.

Port of ``paddle_tpu/ops/rnn.py`` (capability parity with
paddle/fluid/operators/{lstm_op, gru_op, lstm_unit_op, gru_unit_op}.cc).
The reference batch-reorders sequences by length and runs per-timestep
kernels; the JAX package runs ``lax.scan`` over the padded time axis;
here each recurrence is one step function over that axis, with the
reference's validity mask freezing finished rows: a forward recurrence
holds the last valid state at the padded steps, a reversed one (which
flips the whole padded axis) holds its initial state there. ``scan``
evaluates its sub-block once a time step.

:func:`_recur` drives the step: a plain torch loop when the step runs
(``Executor.run``, training and autograd included), and torch's ``scan``
higher-order op over the time-major inputs while ``torch.export`` traces
the step (``LoweringContext.for_export``, io/aot.py), so an exported
recurrence keeps its padded length a symbol, as ``lax.scan`` does.
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


def _valid(x, lengths):
    """[B, T] validity of each step of the padded axis 1 of ``x``."""
    return torch.arange(x.shape[1], device=x.device)[None, :] \
        < lengths[:, None]


def _recur(ctx, step, carry, xs, valid, is_reverse, names=None):
    """Runs ``step(carry, xs_t, valid_t) -> (carry, ys_t)`` (lists of
    tensors) over the padded axis 1 of each of ``xs`` and of ``valid``
    [B, T], in the order the recurrence visits it (the last step first
    when ``is_reverse``), and returns (the final carry, each of ``ys``
    stacked [B, T, ...] in time order).

    Eagerly it is a Python loop. While the step is exported
    (``ctx.for_export``) it is torch's ``scan`` over the inputs moved
    time-major, the mask a scanned input, so the padded length is never
    read: a reversed recurrence flips the inputs and the collected
    outputs over that axis, which is the loop's visiting order. The
    scanned step hands back fresh tensors, since ``scan`` refuses a
    carry or an output that aliases an input or another output (a state
    the step does not write, an output that is also a carry); a carry
    (named by ``names``) whose shape or dtype changes raises ValueError
    naming F14, as ``lax.scan`` refuses it."""
    if not ctx.for_export:
        t = valid.shape[1]
        ys = []
        for i in (range(t - 1, -1, -1) if is_reverse else range(t)):
            carry, y = step(carry, [x[:, i] for x in xs], valid[:, i])
            ys.append(y)
        if is_reverse:
            ys = ys[::-1]
        return carry, [torch.stack(col, dim=1) for col in zip(*ys)]
    from torch._higher_order_ops.scan import scan

    from .control_flow import export_call, same_meta

    what = f"a recurrent op {ctx.op.type}"
    seq = [v.transpose(0, 1) for v in [*xs, valid]]
    if is_reverse:
        seq = [v.flip(0) for v in seq]

    def body(carry, sl):
        new, y = step(list(carry), list(sl[:-1]), sl[-1])
        same_meta(what, names or range(len(new)), carry, new)
        return [c.clone() for c in new], [v.clone() for v in y]

    carry, ys = export_call(
        what, scan, (body, list(carry), seq),
        lambda: same_meta(what, names or range(len(carry)), carry, step(
            list(carry), [v[0] for v in seq[:-1]], seq[-1][0])[0]))
    if is_reverse:
        ys = [y.flip(0) for y in ys]
    return list(carry), [y.transpose(0, 1) for y in ys]


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
    peep = bias is not None and attrs.get("use_peepholes", False) \
        and bias.shape[0] > 4 * h_dim
    b = x.shape[0]
    h = ins["H0"][0] if ins.get("H0") else \
        torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)
    c = ins["C0"][0] if ins.get("C0") else \
        torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)

    def step(carry, xt, valid):
        # the bias's views are taken in the step: a scanned step may
        # close over no two views of one tensor
        h, c = carry
        gates = xt[0] + h @ w
        if bias is not None:
            gates = gates + bias[:4 * h_dim]
        if peep:
            wic, wfc, woc = torch.split(bias[4 * h_dim:], h_dim)
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
        valid = valid[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        return [h, c], [h, c]

    _, (hs, cs) = _recur(ctx, step, [h, c], [x], _valid(x, lengths),
                         is_reverse)
    return {"Hidden": [SequenceBatch(hs, lengths)],
            "Cell": [SequenceBatch(cs, lengths)]}


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
    b = x.shape[0]
    h = ins["H0"][0] if ins.get("H0") else \
        torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)

    def step(carry, xt, valid):
        h, = carry
        xt = xt[0]
        if bias is not None:
            xt = xt + bias
        rz = act_g(xt[:, :2 * h_dim] + h @ w[:, :2 * h_dim])
        r, z = torch.split(rz, h_dim, dim=-1)
        c = act_c(xt[:, 2 * h_dim:] + (r * h) @ w[:, 2 * h_dim:])
        h = torch.where(valid[:, None], z * h + (1 - z) * c, h)
        return [h], [h]

    _, (hs,) = _recur(ctx, step, [h], [x], _valid(x, lengths), is_reverse)
    return {"Hidden": [SequenceBatch(hs, lengths)]}


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
    over the padded time axis through :func:`_recur`.

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
    from ..core.lowering import Env, read_names

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
    if ctx.for_export:
        outer_env = _unaliased(outer_env, read_names(sub_block))

    def step(states, xts, m):
        env = Env(parent=outer_env)
        for name, x in zip(x_names, xts):
            env[name] = x
        for name, val in zip(st_in, states):
            env[name] = val
        (ctx.fork() if ctx.for_export else ctx).eval_block(sub_block, env)
        new_states = []
        for name, old in zip(st_out, states):
            new = env[name]
            if masked:
                mm = m.reshape((-1,) + (1,) * (new.dim() - 1)).to(new.dtype)
                new = mm * new + (1 - mm) * old
            new_states.append(new)
        return new_states, [env[name] for name in out_names]

    states, collected = _recur(ctx, step, states, xs, mask, False,
                               st_out)
    if lengths is not None:
        collected = [SequenceBatch(c, lengths) for c in collected]
    return {"Out": collected, "FinalState": states}


def _unaliased(env, names):
    """A child of ``env`` binding a copy of each of ``names`` whose value
    is a view of another tensor (a SequenceBatch's data included): a
    scanned step closes over no two views of one tensor, which torch's
    ``scan`` refuses."""
    from ..core.lowering import Env
    out = Env(parent=env)
    for n in names:
        v = env.get(n)
        if isinstance(v, SequenceBatch) and v.data._base is not None:
            out[n] = v.with_data(v.data.clone())
        elif isinstance(v, torch.Tensor) and v._base is not None:
            out[n] = v.clone()
    return out
