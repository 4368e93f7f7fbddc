"""Optimizer update op lowering rules (port of
``paddle_tpu/ops/optimizer_ops.py``).

Capability parity with paddle/fluid/operators/{sgd,momentum,adam,adagrad,
adamax,adadelta,decayed_adagrad,rmsprop,ftrl}_op.cc, plus lamb and the
proximal rules. Each op consumes Param/Grad/accumulator state and emits
the updated tensors; the step's executor writes them back to the scope.
The arithmetic and its order follow the reference rule for rule.
"""
import torch

from ..core.registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def _f32(*vals):
    """Upcast update ARITHMETIC to f32 — pair with :func:`_like` on
    every output so the STORED dtype never changes (the reference's
    contract: without the cast-back, the f32 learning-rate scalar would
    promote a bf16 parameter's update to f32 and the scope's dtype would
    flip). Storing params/moments in bf16 still rounds each update to
    bf16 on write-back. ``.float()`` returns an f32 input itself, so the
    results are never updated in place."""
    return tuple(None if v is None else v.float() for v in vals)


def _like(val, ref):
    return val.to(ref.dtype)


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    pf, gf = _f32(p, g)
    return {"ParamOut": [_like(pf - _lr(ins) * gf, p)]}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    pf, gf, vf = _f32(p, g, v)
    v_out = mu * vf + gf
    if attrs.get("use_nesterov", False):
        p_out = pf - (gf + mu * v_out) * lr
    else:
        p_out = pf - lr * v_out
    return {"ParamOut": [_like(p_out, p)],
            "VelocityOut": [_like(v_out, v)]}


# elements of a parameter one Adam update takes at a time: its float32
# temporaries are a few of these (64 MB each), not a few float32 copies
# of the whole parameter (2.1 GB each at a 128256 x 4096 table), so the
# optimizer segment does not set a train step's peak memory
ADAM_CHUNK = 1 << 24


def _adam_math(p, g, m1, m2, lr, b1, b2, eps):
    """The reference's arithmetic in its order, in float32: (param,
    moment1, moment2) updated. The f32 temporaries it creates itself are
    updated in place."""
    gf, = _f32(g)
    m1o = b1 * m1.float()
    m1o += (1 - b1) * gf
    m2o = b2 * m2.float()
    m2o += (1 - b2) * torch.square(gf)
    del gf
    upd = lr * m1o
    denom = torch.sqrt(m2o)
    denom += eps
    upd /= denom
    del denom
    return p.float() - upd, m1o, m2o


@register_op("adam")
def _adam(ctx, ins, attrs):
    """Elementwise, so it runs a slice of ADAM_CHUNK elements at a time,
    each slice's float32 results rounded once to the stored dtype as
    they are written — the same numbers as the whole tensor at once.
    A step that donates its state (``LoweringContext.donated_output``)
    has each slice written into the parameter and moments themselves:
    a slice is read whole before it is written."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p = ins["Beta1Pow"][0].reshape(())
    b2p = ins["Beta2Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    outs = []
    for slot, t in (("Param", p), ("Moment1", m1), ("Moment2", m2)):
        dest = ctx.donated_output(slot, slot + "Out", t) \
            if ctx is not None else None
        outs.append(torch.empty_like(t) if dest is None else dest)
    flat = [t.reshape(-1) for t in (p, g, m1, m2)]
    for start in range(0, p.numel(), ADAM_CHUNK):
        part = slice(start, start + ADAM_CHUNK)
        for out, val in zip(outs, _adam_math(*(t[part] for t in flat), lr,
                                             b1, b2, eps)):
            out.view(-1)[part].copy_(val)
    return {"ParamOut": [outs[0]], "Moment1Out": [outs[1]],
            "Moment2Out": [outs[2]]}


@register_op("adamax")
def _adamax(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0].reshape(())
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    pf, gf, mf, inff = _f32(p, g, m, inf)
    mo = b1 * mf + (1 - b1) * gf
    info = torch.maximum(b2 * inff, torch.abs(gf))
    po = pf - (_lr(ins) / (1 - b1p)) * (mo / (info + eps))
    return {"ParamOut": [_like(po, p)], "MomentOut": [_like(mo, m)],
            "InfNormOut": [_like(info, inf)]}


@register_op("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    pf, gf, mf = _f32(p, g, m)
    mo = mf + torch.square(gf)
    po = pf - _lr(ins) * gf / (torch.sqrt(mo) + eps)
    return {"ParamOut": [_like(po, p)], "MomentOut": [_like(mo, m)]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    pf, gf, mf = _f32(p, g, m)
    mo = decay * mf + (1 - decay) * torch.square(gf)
    po = pf - _lr(ins) * gf / (torch.sqrt(mo) + eps)
    return {"ParamOut": [_like(po, p)], "MomentOut": [_like(mo, m)]}


@register_op("adadelta")
def _adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq_g, avg_sq_u = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    pf, gf, asgf, asuf = _f32(p, g, avg_sq_g, avg_sq_u)
    asg = rho * asgf + (1 - rho) * torch.square(gf)
    update = -torch.sqrt((asuf + eps) / (asg + eps)) * gf
    asu = rho * asuf + (1 - rho) * torch.square(update)
    return {"ParamOut": [_like(pf + update, p)],
            "AvgSquaredGradOut": [_like(asg, avg_sq_g)],
            "AvgSquaredUpdateOut": [_like(asu, avg_sq_u)]}


@register_op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    lr = _lr(ins)
    pf, gf, msf, momf = _f32(p, g, ms, mom)
    if attrs.get("centered", False):
        mg = ins["MeanGrad"][0]
        mgf, = _f32(mg)
        mgo = rho * mgf + (1 - rho) * gf
        mso = rho * msf + (1 - rho) * torch.square(gf)
        momo = mu * momf + lr * gf / torch.sqrt(mso - torch.square(mgo)
                                                + eps)
        return {"ParamOut": [_like(pf - momo, p)],
                "MeanSquareOut": [_like(mso, ms)],
                "MomentOut": [_like(momo, mom)],
                "MeanGradOut": [_like(mgo, mg)]}
    mso = rho * msf + (1 - rho) * torch.square(gf)
    momo = mu * momf + lr * gf / torch.sqrt(mso + eps)
    return {"ParamOut": [_like(pf - momo, p)],
            "MeanSquareOut": [_like(mso, ms)],
            "MomentOut": [_like(momo, mom)]}


@register_op("ftrl")
def _ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    pf, gf, sqf, linf = _f32(p, g, sq, lin)
    new_sq = sqf + torch.square(gf)
    if power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sqf)) / lr
    else:
        sigma = (torch.pow(new_sq, -power) - torch.pow(sqf, -power)) / lr
    new_lin = linf + gf - sigma * pf
    x = l1 * torch.sign(new_lin) - new_lin
    if power == -0.5:
        y = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        y = torch.pow(new_sq, -power) / lr + 2 * l2
    po = torch.where(torch.abs(new_lin) > l1, x / y, 0.0)
    return {"ParamOut": [_like(po, p)],
            "SquaredAccumOut": [_like(new_sq, sq)],
            "LinearAccumOut": [_like(new_lin, lin)]}


@register_op("lamb")
def _lamb(ctx, ins, attrs):
    """LAMB (layer-adaptive Adam), as the reference's contrib-capability
    rule."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    pf, gf, m1f, m2f = _f32(p, g, m1, m2)
    m1o = b1 * m1f + (1 - b1) * gf
    m2o = b2 * m2f + (1 - b2) * torch.square(gf)
    update = m1o / (torch.sqrt(m2o) + eps) + wd * pf
    w_norm = torch.sqrt(torch.sum(torch.square(pf)))
    u_norm = torch.sqrt(torch.sum(torch.square(update)))
    one = torch.ones((), dtype=torch.float32, device=pf.device)
    ratio = torch.where(w_norm > 0,
                        torch.where(u_norm > 0, w_norm / u_norm, one), one)
    po = pf - _lr(ins) * ratio * update
    return {"ParamOut": [_like(po, p)], "Moment1Out": [_like(m1o, m1)],
            "Moment2Out": [_like(m2o, m2)]}


# ---- proximal optimizers (reference proximal_gd_op.h,
# proximal_adagrad_op.h): l1/l2-regularized proximal steps ------------

def _prox(prox_param, lr, l1, l2):
    return (torch.sign(prox_param) *
            torch.clamp(torch.abs(prox_param) - lr * l1, min=0.0) /
            (1.0 + lr * l2))


@register_op("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins)
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    pf, gf = _f32(p, g)
    return {"ParamOut": [_like(_prox(pf - lr * gf, lr, l1, l2), p)]}


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    """Per-element adagrad step inside the prox, but the l1/l2
    shrinkage uses the SCALAR learning rate like the reference."""
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _lr(ins)
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    pf, gf, mf = _f32(p, g, m)
    mo = mf + torch.square(gf)
    return {"ParamOut": [_like(_prox(pf - lr * gf / torch.sqrt(mo + 1e-12),
                                     lr, l1, l2), p)],
            "MomentOut": [_like(mo, m)]}
