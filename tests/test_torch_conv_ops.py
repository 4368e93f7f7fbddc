"""The conv-net ops of ROADMAP item 5 (``ops/nn.py``) through the torch
port, each against the reference's rule on the same inputs: the
convolutions (2-D, depthwise, 3-D and the transposed ones, with groups
and dilation), pooling (``ceil_mode`` with padding, exclusive averages),
``batch_norm`` (train and test, with its moving statistics), ``lrn``,
both interpolations up and down, ``roi_pool`` (empty bins, batched rois)
and ``random_crop`` (held to its distribution: the two packages draw
differently). Layout-carrying ops run in NCHW and NHWC.

Forward outputs hold at rtol/atol 1e-5 (2e-5 for the convolutions and
bilinear products, whose sums the two packages order differently), and
the autograd gradient of a random cotangent at 5e-3 — the tiers of
``tests/test_torch_optest.py``, float32. The reference runs on jax's
CPU backend. A rule runs under a ``"train"`` context where it has a
train mode (``batch_norm``), otherwise ``"test"``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core import lowering as jax_lowering
from paddle_tpu.core import registry as jax_registry
import paddle_tpu_torch  # noqa: F401  (registers the port's rules)
from paddle_tpu_torch.core import lowering as pt_lowering
from paddle_tpu_torch.core import registry as pt_registry
import paddle_tpu_torch.ops.nn as tnn

torch.set_num_threads(1)

R = np.random.RandomState(11)


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def run_both(op, ins, attrs, grad=(), mode="test", seed=0):
    """Both rules on ``ins`` ({slot: array or [arrays]}); returns (jax
    outs, port outs, jax grads, port grads) as numpy, the grads of the
    ``grad`` slots through one random cotangent per float output."""
    ins = {s: [np.asarray(a) for a in (v if isinstance(v, list) else [v])]
           for s, v in ins.items()}
    jrule = jax_registry.get_op(op).lower
    trule = pt_registry.get_op(op).lower
    keys = [(s, i) for s in grad for i, a in enumerate(ins[s])
            if _is_float(a)]

    def jfn(diff):
        jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        for (s, i), a in diff.items():
            jins[s][i] = a
        ctx = jax_lowering.LoweringContext(None, mode,
                                           jax.random.PRNGKey(0))
        return jrule(ctx, jins, dict(attrs))

    jdiff = {k: jnp.asarray(ins[k[0]][k[1]]) for k in keys}
    jout = {s: [np.asarray(a) for a in v] for s, v in jfn(jdiff).items()}
    tins = {s: [torch.from_numpy(a.copy()) for a in v]
            for s, v in ins.items()}
    leaves = [tins[s][i].requires_grad_() for s, i in keys]
    ctx = pt_lowering.LoweringContext(None, mode, torch.device("cpu"), 0, 1)
    with torch.enable_grad():
        tout = trule(ctx, tins, dict(attrs))
    tout_np = {s: [t.detach().numpy() for t in v] for s, v in tout.items()}
    if not keys:
        return jout, tout_np, {}, {}
    rng = np.random.RandomState(seed)
    cots = {(s, i): rng.randn(*a.shape).astype(a.dtype)
            for s, v in jout.items() for i, a in enumerate(v)
            if _is_float(a) and tout[s][i].requires_grad}

    def jloss(diff):
        out = jfn(diff)
        return sum(jnp.sum(out[s][i] * c) for (s, i), c in cots.items())

    jgrad = {k: np.asarray(v) for k, v in jax.grad(jloss)(jdiff).items()}
    with torch.enable_grad():
        tl = sum((tout[s][i] * torch.from_numpy(c)).sum()
                 for (s, i), c in cots.items())
        tg = torch.autograd.grad(tl, leaves)
    return jout, tout_np, jgrad, {k: g.numpy() for k, g in zip(keys, tg)}


def check(op, ins, attrs=None, grad=(), mode="test", tol=1e-5,
          gtol=5e-3):
    jout, tout, jgrad, tgrad = run_both(op, ins, attrs or {}, grad, mode)
    assert set(tout) == set(jout), (op, sorted(tout), sorted(jout))
    for s in jout:
        for i, (t, j) in enumerate(zip(tout[s], jout[s])):
            assert t.shape == j.shape, (op, s, t.shape, j.shape)
            if _is_float(j):
                np.testing.assert_allclose(t, j, rtol=tol, atol=tol,
                                           err_msg=f"{op} {s}[{i}]")
            else:
                np.testing.assert_array_equal(
                    t.astype(np.int64), j.astype(np.int64),
                    err_msg=f"{op} {s}[{i}]")
    for k in jgrad:
        np.testing.assert_allclose(tgrad[k], jgrad[k], rtol=gtol, atol=gtol,
                                   err_msg=f"{op} d{k}")
    return tout


def nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

# (input [N, C, H, W], filter [cout, cin/g, kh, kw], strides, paddings,
#  dilations, groups): tests/test_optest_nn.py's sweep shapes and more
CONV2D = {
    "k3p1": ((2, 3, 7, 7), (4, 3, 3, 3), 1, 1, 1, 1),
    "s2-groups2": ((1, 4, 6, 6), (4, 2, 3, 3), 2, 1, 1, 2),
    "dilation2": ((1, 4, 7, 7), (2, 4, 3, 3), 1, 2, 2, 1),
    "stem-7x7-s2": ((2, 3, 16, 16), (8, 3, 7, 7), 2, 3, 1, 1),
    "1x1-s2": ((2, 8, 8, 8), (16, 8, 1, 1), 2, 0, 1, 1),
    "depthwise": ((1, 3, 5, 5), (3, 1, 3, 3), 1, 1, 1, 3),
}


def _conv_attrs(s, p, d, g, nd=2, **kw):
    return dict(strides=[s] * nd, paddings=[p] * nd, dilations=[d] * nd,
                groups=g, **kw)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV2D))
def test_conv2d(case, layout):
    xs, ws, s, p, d, g = CONV2D[case]
    x, w = _f(*xs), _f(*ws)
    op = "depthwise_conv2d" if case == "depthwise" else "conv2d"
    if layout == "NHWC":
        x = nhwc(x)
    check(op, {"Input": x, "Filter": w},
          _conv_attrs(s, p, d, g, data_format=layout),
          grad=("Input", "Filter"), tol=2e-5)


# (input [N, cin, *sp], filter [cin, cout/g, *k], strides, paddings,
#  dilations, groups)
CONV_T = {
    "2d-s2p1": ((1, 2, 3, 3), (2, 3, 3, 3), 2, 1, 1, 1),
    "2d-pad0": ((1, 2, 4, 4), (2, 3, 3, 3), 1, 0, 1, 1),
    "2d-groups2-dil2": ((2, 4, 4, 4), (4, 3, 3, 3), 2, 1, 2, 2),
    "3d-s2": ((1, 2, 2, 3, 3), (2, 3, 2, 2, 2), 2, 0, 1, 1),
    "3d-groups2-dil2": ((1, 4, 3, 3, 3), (4, 2, 3, 3, 3), 1, 1, 2, 2),
}


@pytest.mark.parametrize("case", sorted(CONV_T))
def test_conv_transpose(case):
    xs, ws, s, p, d, g = CONV_T[case]
    nd = len(xs) - 2
    check(f"conv{nd}d_transpose", {"Input": _f(*xs), "Filter": _f(*ws)},
          _conv_attrs(s, p, d, g, nd), grad=("Input", "Filter"), tol=2e-5)


def test_conv2d_transpose_nhwc():
    x, w = _f(2, 4, 4, 4), _f(4, 3, 3, 3)
    check("conv2d_transpose", {"Input": nhwc(x), "Filter": w},
          _conv_attrs(2, 1, 1, 2, data_format="NHWC"),
          grad=("Input", "Filter"), tol=2e-5)


@pytest.mark.parametrize("groups,dil,stride", [(1, 1, 1), (2, 2, 1),
                                               (1, 1, 2)])
def test_conv3d(groups, dil, stride):
    x, w = _f(1, 4, 5, 6, 6), _f(4, 4 // groups, 2, 3, 3)
    check("conv3d", {"Input": x, "Filter": w},
          _conv_attrs(stride, 1, dil, groups, 3), grad=("Input", "Filter"),
          tol=2e-5)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

# distinct values a window (no max ties for the gradient to split)
POOL_X = (np.arange(2 * 3 * 7 * 7, dtype=np.float32)
          [R.permutation(2 * 3 * 7 * 7)].reshape(2, 3, 7, 7) / 50.0)
POOL2D = {
    "max-2s2": dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0]),
    "avg-3s1": dict(ksize=[3, 3], strides=[1, 1], paddings=[0, 0]),
    "stem-max-3s2p1": dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
    "avg-3s2p1-exclusive": dict(ksize=[3, 3], strides=[2, 2],
                                paddings=[1, 1]),
    "ceil-2s2p1": dict(ksize=[2, 2], strides=[2, 2], paddings=[1, 1],
                       ceil_mode=True),
    "ceil-3s2p1": dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                       ceil_mode=True),
    "ceil-3s3p0": dict(ksize=[3, 3], strides=[3, 3], paddings=[0, 0],
                       ceil_mode=True),
    "pad-over-half-2s1p1": dict(ksize=[2, 2], strides=[1, 1],
                                paddings=[1, 1]),
    "global": dict(ksize=[7, 7], global_pooling=True),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("ptype", ["max", "avg"])
@pytest.mark.parametrize("case", sorted(POOL2D))
def test_pool2d(case, ptype, layout):
    x = POOL_X if layout == "NCHW" else nhwc(POOL_X)
    check("pool2d", {"X": x}, dict(POOL2D[case], pooling_type=ptype,
                                   data_format=layout), grad=("X",))


@pytest.mark.parametrize("ptype", ["max", "avg"])
@pytest.mark.parametrize("ceil", [False, True])
def test_pool3d(ptype, ceil):
    x = (np.arange(1 * 2 * 5 * 5 * 5, dtype=np.float32)
         [R.permutation(250)].reshape(1, 2, 5, 5, 5) / 50.0)
    check("pool3d", {"X": x}, dict(ksize=[2, 2, 2], strides=[2, 2, 2],
                                   paddings=[1, 0, 1], pooling_type=ptype,
                                   ceil_mode=ceil), grad=("X",))


def test_bf16_avg_pool_accumulates_in_float32():
    """A bf16 ``avg`` sums in float32 and rounds once: it equals the
    float32 pool of the same values rounded to bf16, as the reference's
    upcast gives (49 bf16 adds would drift by ~1%)."""
    x = torch.randn(2, 8, 7, 7).to(torch.bfloat16)
    attrs = dict(ksize=[7, 7], strides=[1, 1], paddings=[0, 0],
                 pooling_type="avg")
    rule = pt_registry.get_op("pool2d").lower
    ctx = pt_lowering.LoweringContext(None, "test", torch.device("cpu"), 0,
                                      1)
    got = rule(ctx, {"X": [x]}, attrs)["Out"][0]
    want = rule(ctx, {"X": [x.float()]}, attrs)["Out"][0]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=2 ** -8, atol=0)


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------


def _bn_ins(x, c):
    return {"X": x, "Scale": (R.rand(c) + 0.5).astype(np.float32),
            "Bias": _f(c), "Mean": _f(c) * 0.1,
            "Variance": (R.rand(c) + 0.5).astype(np.float32)}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["train", "test", "global_stats"])
def test_batch_norm(mode, layout):
    x = _f(4, 3, 5, 5) * 2.0 + 1.0
    if layout == "NHWC":
        x = nhwc(x)
    attrs = dict(epsilon=1e-5, momentum=0.9, data_layout=layout,
                 use_global_stats=mode == "global_stats")
    check("batch_norm", _bn_ins(x, 3), attrs,
          grad=("X", "Scale", "Bias"),
          mode="train" if mode != "test" else "test")


def test_batch_norm_2d_input():
    """[N, C] input (VGG's fc batch norm): statistics over N."""
    check("batch_norm", _bn_ins(_f(6, 5), 5), dict(momentum=0.8),
          grad=("X", "Scale", "Bias"), mode="train")


def test_batch_norm_backward_matches_autodiff_f64():
    """The hand-derived backward (``ops/nn.py`` ``_BNTrain``) equals
    autograd of the same forward to machine precision in float64, for
    dx, dscale and dbias (the twin of tests/test_optest_grad.py's
    custom-vjp case; rtol/atol 1e-12)."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(4, 5, 5, 3), dtype=torch.float64)
    scale = torch.tensor(rng.rand(3) + 0.5, dtype=torch.float64)
    bias = torch.tensor(rng.randn(3), dtype=torch.float64)
    dy = torch.tensor(rng.randn(4, 5, 5, 3), dtype=torch.float64)
    axes, bshape, eps = (0, 1, 2), (1, 1, 1, 3), 1e-5

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y = fn(*leaves, axes, bshape, eps)[0]
        return torch.autograd.grad((y * dy).sum(), leaves)

    hand = grads(tnn._BNTrain.apply)
    auto = grads(tnn._bn_core)
    for name, a, b in zip(("dx", "dscale", "dbias"), hand, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("autodiff", ["0", "1"])
def test_batch_norm_autodiff_seam_read_at_run_time(autodiff, monkeypatch):
    """``PADDLE_TPU_BN_AUTODIFF`` is read when the op runs, not at
    import: either route gives the reference's gradients."""
    monkeypatch.setenv("PADDLE_TPU_BN_AUTODIFF", autodiff)
    assert tnn._bn_autodiff() == (autodiff == "1")
    check("batch_norm", _bn_ins(_f(4, 3, 3, 3), 3), {},
          grad=("X", "Scale", "Bias"), mode="train")


def test_batch_norm_bf16_stats_match_f32():
    """The twin of tests/test_amp.py's case: a bf16 input takes its
    statistics and normalize in float32; Y comes back bf16 within bf16
    rounding (atol 0.05), the statistics float32 and equal to the f32
    path's (atol 1e-6) for bf16-representable inputs."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(4, 6, 5, 5), dtype=torch.float32) \
        .to(torch.bfloat16).float()
    ins = {"Scale": [torch.full((6,), 1.5)], "Bias": [torch.zeros(6)],
           "Mean": [torch.zeros(6)], "Variance": [torch.ones(6)]}
    ctx = pt_lowering.LoweringContext(None, "train", torch.device("cpu"),
                                      0, 1)
    rule = pt_registry.get_op("batch_norm").lower
    o32 = rule(ctx, dict(ins, X=[x]), {})
    o16 = rule(ctx, dict(ins, X=[x.to(torch.bfloat16)]), {})
    assert o16["Y"][0].dtype == torch.bfloat16
    for s in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert o16[s][0].dtype == torch.float32, s
        np.testing.assert_allclose(o16[s][0].numpy(), o32[s][0].numpy(),
                                   atol=1e-6, err_msg=s)
    np.testing.assert_allclose(o16["Y"][0].float().numpy(),
                               o32["Y"][0].numpy(), atol=0.05)


def test_batch_norm_statistics_follow_the_reference_conventions():
    """Not ``F.batch_norm``: one-pass biased batch variance, moving
    statistics ``old·momentum + batch·(1 − momentum)`` (atol 1e-6)."""
    x = _f(8, 2, 3, 3) + 3.0
    ins = _bn_ins(x, 2)
    out = check("batch_norm", ins, dict(momentum=0.7), mode="train")
    bm = x.mean((0, 2, 3))
    bv = (x * x).mean((0, 2, 3)) - bm * bm
    np.testing.assert_allclose(out["SavedVariance"][0], bv, atol=1e-5)
    np.testing.assert_allclose(out["MeanOut"][0],
                               ins["Mean"] * 0.7 + bm * 0.3, atol=1e-6)
    np.testing.assert_allclose(out["VarianceOut"][0],
                               ins["Variance"] * 0.7 + bv * 0.3, atol=1e-5)


# ---------------------------------------------------------------------------
# lrn, interpolation, roi_pool, random_crop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("n", [3, 5])
def test_lrn(n, layout):
    x = _f(2, 7, 3, 3)
    if layout == "NHWC":
        x = nhwc(x)
    check("lrn", {"X": x}, dict(n=n, alpha=0.3, beta=0.75,
                                data_format=layout), grad=("X",))


def test_lrn_defaults_are_the_ops():
    """k defaults to 2.0 at the op (the layer passes 1.0), and α is not
    divided by n."""
    x = _f(1, 5, 2, 2)
    out = check("lrn", {"X": x}, {})["Out"][0]
    sq = np.pad(x * x, [(0, 0), (2, 2), (0, 0), (0, 0)])
    acc = sum(sq[:, i:i + 5] for i in range(5))
    np.testing.assert_allclose(out, x / (2.0 + 1e-4 * acc) ** 0.75,
                               rtol=1e-5)


INTERP = {"up": (5, 7, 10, 12), "down": (12, 10, 5, 3),
          "down-3x": (12, 9, 4, 3), "mixed": (6, 6, 9, 4),
          "same-h": (6, 8, 6, 3)}


@pytest.mark.parametrize("op", ["bilinear_interp", "nearest_interp"])
@pytest.mark.parametrize("case", sorted(INTERP))
def test_interp(op, case):
    ih, iw, oh, ow = INTERP[case]
    check(op, {"X": _f(2, 3, ih, iw)}, dict(out_h=oh, out_w=ow),
          grad=("X",), tol=2e-5)


def test_nearest_is_half_pixel():
    """tests/test_optest_nn.py's case: out pixel i reads
    in[floor((i + .5) · in / out)]."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    out = check("nearest_interp", {"X": x}, dict(out_h=2, out_w=2))
    np.testing.assert_array_equal(out["Out"][0], x[:, :, 1::2, 1::2])


ROI_X = _f(2, 3, 8, 8)
ROIS = {
    "single": dict(ROIs=np.asarray([[0, 0, 3, 3]], np.float32)),
    "batch-ids-scaled": dict(
        ROIs=np.asarray([[0, 0, 6, 6], [2, 1, 7, 5], [1, 1, 2, 2]],
                        np.float32) * 2.0,
        RoisBatchId=np.asarray([0, 1, 1], np.int64)),
    "empty-bins": dict(ROIs=np.asarray([[6, 6, 12, 14], [9, 9, 12, 12]],
                                       np.float32)),
    "batched": dict(ROIs=np.asarray(
        [[[0, 0, 4, 4], [3, 2, 7, 7]], [[1, 1, 5, 3], [0, 4, 7, 7]]],
        np.float32)),
}


@pytest.mark.parametrize("case", sorted(ROIS))
def test_roi_pool(case):
    scale = 0.5 if case == "batch-ids-scaled" else 1.0
    out = check("roi_pool", dict(ROIS[case], X=ROI_X),
                dict(pooled_height=2, pooled_width=3, spatial_scale=scale),
                grad=("X",))
    if case == "empty-bins":
        assert (out["Out"][0][1] == 0).all()    # never -inf


def test_roi_pool_reference_values():
    """tests/test_optest_nn.py's case: a 4x4 roi of an arange map."""
    x = np.arange(64, dtype=np.float32).reshape(1, 1, 8, 8)
    out = check("roi_pool", {"X": x, "ROIs": np.asarray([[0, 0, 3, 3]],
                                                        np.float32),
                             "RoisBatchId": np.asarray([0], np.int32)},
                dict(pooled_height=2, pooled_width=2))
    np.testing.assert_allclose(out["Out"][0].reshape(2, 2),
                               [[9., 11.], [25., 27.]])


def _crop(x, shape, step):
    ctx = pt_lowering.LoweringContext(None, "train", torch.device("cpu"), 3,
                                      step)
    return pt_registry.get_op("random_crop").lower(
        ctx, {"X": [torch.from_numpy(x)]}, {"shape": shape})["Out"][0]


def test_random_crop_distribution_and_replay():
    """Each start is uniform over [0, size − crop]: over 600 steps every
    start of both axes occurs, with frequencies within 5 sigma of
    uniform; one (seed, step) replays its crop, and the crop is the
    window its first element names."""
    x = np.arange(2 * 6 * 7, dtype=np.float32).reshape(2, 6, 7)
    starts = []
    for step in range(600):
        out = _crop(x, [3, 4], step).numpy()
        assert out.shape == (2, 3, 4)
        i, j = divmod(int(out[0, 0, 0]), 7)
        np.testing.assert_array_equal(out, x[:, i:i + 3, j:j + 4])
        starts.append((i, j))
    rows = np.bincount([s[0] for s in starts], minlength=4)
    cols = np.bincount([s[1] for s in starts], minlength=4)
    for counts, k in ((rows, 4), (cols, 4)):
        assert len(counts) == k and counts.min() > 0
        p = 1 / k
        assert np.abs(counts / 600 - p).max() <= 5 * np.sqrt(
            p * (1 - p) / 600), counts
    np.testing.assert_array_equal(_crop(x, [3, 4], 7), _crop(x, [3, 4], 7))
    assert pt_registry.get_op("random_crop").stateful
    assert jax_registry.get_op("random_crop").stateful


def test_remat_tags_are_inert_without_their_policy():
    """A program without a conv-net remat policy runs the conv and
    batch_norm rules without pushing a tag; under ``save_conv_only`` the
    convolution runs tagged ``conv_out`` and batch_norm untagged."""
    x, w = torch.from_numpy(_f(1, 3, 5, 5)), torch.from_numpy(_f(2, 3, 3, 3))
    bn = {s: [torch.from_numpy(np.asarray(v))]
          for s, v in _bn_ins(_f(4, 2, 3, 3), 2).items()}

    class Spy(list):
        def __init__(self):
            super().__init__()
            self.seen = []

        def append(self, v):
            self.seen.append(v)
            super().append(v)

    class Prog:
        _remat_policy = None

    for policy, want in ((None, []), ("dots_saveable", []),
                         ("save_conv_only", ["conv_out"]),
                         ("recompute_norms", ["batch_norm_out"])):
        Prog._remat_policy = policy
        ctx = pt_lowering.LoweringContext(Prog(), "train",
                                          torch.device("cpu"), 0, 1)
        ctx.remat_tags = Spy()
        pt_registry.get_op("conv2d").lower(ctx, {"Input": [x],
                                                 "Filter": [w]}, {})
        pt_registry.get_op("batch_norm").lower(ctx, bn, {})
        assert ctx.remat_tags.seen == want and not ctx.remat_tags, policy
