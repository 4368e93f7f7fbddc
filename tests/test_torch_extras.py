"""The extras ops of the torch port (``ops/extras.py``: minus,
modified_huber_loss, pad_constant_like, conv_shift,
max_pool2d_with_index, unpool, spp, positive_negative_pair,
precision_recall, the fake quantize pair, weight_norm and its startup
op), ``ops/nn.py``'s ``hierarchical_sigmoid`` and ``nce``, and their
layers against the JAX package.

- Each rule on the same numpy inputs in both packages
  (torch_seq_common.py ``rule_pair``: forwards rtol 2e-4 / atol 2e-5,
  gradients through one random cotangent per output rtol 2e-3 / atol
  2e-4), integer outputs — pooling indices, pair counts, the quantized
  domain — exactly.
- ``nce`` draws its negatives from different generators in the two
  packages: it is compared with identical rows of ``Weight`` and
  ``Bias``, where the cost and dX do not depend on the draw, and its
  draws are held to U[0, n).
- The reference's cases: the 7 op cases of tests/test_extras.py (its
  proximal optimizers are held rule by rule in test_torch_training.py),
  both of tests/test_weight_norm.py, and ``hsigmoid`` and ``nce`` layer
  programs, each against the reference's program.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import lowering as pt_lowering
from paddle_tpu_torch.core import registry as pt_registry
from torch_seq_common import (CPU, FWD, build_both, make_feed, port_scope,
                              program_pair, reference_state, rule_pair)

torch.set_num_threads(1)


def _f(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _ids(seed, hi, *shape):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(
        np.int64)


POOLED = _f(5, 2, 3, 3, 3)
# flat indices into a 6x6 map, one in each 2x2/stride-2 window (what
# max_pool2d_with_index records)
POOL_IDX = ((np.arange(3)[:, None] * 2 + _ids(7, 2, 2, 3, 3, 3)) * 6
            + np.arange(3)[None, :] * 2 + _ids(8, 2, 2, 3, 3, 3))
SAME_ROWS = np.tile(_f(30, 1, 5), (20, 1))

RULES = {
    "minus": ("minus", {"X": [_f(1, 3, 4)], "Y": [_f(2, 3, 4)]}, {},
              ("X", "Y")),
    "modified_huber": ("modified_huber_loss", {
        "X": [np.asarray([[-2.5], [-1.5], [-0.5], [0.3], [0.8], [1.6],
                          [2.2], [-0.2]], np.float32)],
        "Y": [np.asarray([[0], [1], [1], [0], [1], [0], [1], [0]],
                         np.float32)]}, {}, ("X",)),
    "pad_constant_like": ("pad_constant_like", {"X": [_f(3, 4, 5, 6)],
                                                "Y": [_f(4, 2, 3, 6)]},
                          {"pad_value": 1.5}, ("Y",)),
    "conv_shift": ("conv_shift", {"X": [_f(9, 2, 7)], "Y": [_f(10, 2, 3)]},
                   {}, ("X", "Y")),
    "max_pool2d_with_index": ("max_pool2d_with_index",
                              {"X": [_f(11, 2, 3, 6, 6)]},
                              {"ksize": [2, 2], "strides": [2, 2],
                               "paddings": [0, 0]}, ("X",)),
    "max_pool2d_with_index_padded": ("max_pool2d_with_index",
                                     {"X": [_f(12, 2, 2, 7, 5)]},
                                     {"ksize": 3, "strides": 2,
                                      "paddings": 1}, ("X",)),
    "unpool": ("unpool", {"X": [POOLED], "Indices": [POOL_IDX]},
               {"unpooled_height": 6, "unpooled_width": 6}, ("X",)),
    "spp_max": ("spp", {"X": [_f(13, 2, 3, 5, 7)]},
                {"pyramid_height": 3, "pooling_type": "max"}, ("X",)),
    "spp_avg": ("spp", {"X": [_f(13, 2, 3, 5, 7)]},
                {"pyramid_height": 3, "pooling_type": "avg"}, ("X",)),
    "positive_negative_pair": ("positive_negative_pair", {
        "Score": [np.round(_f(14, 12, 1), 1)],
        "Label": [_ids(15, 3, 12, 1).astype(np.float32)],
        "QueryID": [_ids(16, 3, 12, 1)]}, {}, ()),
    "positive_negative_pair_accumulated": ("positive_negative_pair", {
        "Score": [_f(14, 12, 1)],
        "Label": [_ids(15, 3, 12, 1).astype(np.float32)],
        "QueryID": [_ids(16, 3, 12, 1)],
        "AccumulatePositivePair": [np.asarray([3.0], np.float32)],
        "AccumulateNegativePair": [np.asarray([1.0], np.float32)],
        "AccumulateNeutralPair": [np.asarray([2.0], np.float32)]}, {}, ()),
    "precision_recall": ("precision_recall", {
        "Indices": [_ids(17, 4, 12, 1)], "Labels": [_ids(18, 4, 12, 1)]},
        {"class_number": 5}, ()),
    "precision_recall_weighted_states": ("precision_recall", {
        "Indices": [_ids(17, 4, 12, 1)], "Labels": [_ids(18, 4, 12, 1)],
        "Weights": [_f(19, 12, 1, lo=0.5, hi=2.0)],
        "StatesInfo": [np.abs(_f(20, 4, 4)) * 5]},
        {"class_number": 4}, ()),
    "fake_quantize_8": ("fake_quantize_abs_max", {"X": [_f(21, 8, 8)]},
                        {"bit_length": 8}, ("X",)),
    "fake_quantize_4": ("fake_quantize_abs_max", {"X": [_f(22, 3, 4)]},
                        {"bit_length": 4}, ("X",)),
    "fake_dequantize": ("fake_dequantize_max_abs", {
        "X": [np.round(_f(23, 4, 5) * 127)],
        "Scale": [np.asarray([0.75], np.float32)]}, {"max_range": 127.0},
        ("X", "Scale")),
    "weight_norm_dim1": ("weight_norm", {"V": [_f(24, 6, 4)],
                                         "G": [_f(25, 4, lo=0.5)]},
                         {"dim": 1}, ("V", "G")),
    "weight_norm_dim0": ("weight_norm", {"V": [_f(24, 6, 4)],
                                         "G": [_f(26, 6, lo=0.5)]},
                         {"dim": 0}, ("V", "G")),
    "weight_norm_all": ("weight_norm", {"V": [_f(24, 6, 4)],
                                        "G": [np.asarray([1.7],
                                                         np.float32)]},
                        {"dim": -1}, ("V", "G")),
    "weight_norm_g_init": ("weight_norm_g_init", {"V": [_f(27, 6, 4)]},
                           {"dim": 1}, ()),
    "weight_norm_g_init_all": ("weight_norm_g_init", {"V": [_f(27, 6, 4)]},
                               {"dim": -1}, ()),
    "hsigmoid": ("hierarchical_sigmoid", {
        "X": [_f(28, 6, 5)], "Label": [_ids(29, 7, 6, 1)],
        "W": [_f(31, 6, 5)], "Bias": [_f(32, 6)]}, {"num_classes": 7},
        ("X", "W", "Bias")),
    "hsigmoid_nobias_pow2": ("hierarchical_sigmoid", {
        "X": [_f(28, 6, 5)], "Label": [_ids(29, 8, 6, 1)],
        "W": [_f(31, 7, 5)]}, {"num_classes": 8}, ("X", "W")),
    # identical rows: the cost and dX do not depend on the negatives
    "nce_same_rows": ("nce", {
        "Input": [_f(33, 6, 5)], "Label": [_ids(34, 20, 6, 1)],
        "Weight": [SAME_ROWS], "Bias": [np.full((20,), 0.3, np.float32)],
        "SampleWeight": [_f(35, 6, 1, lo=0.5, hi=1.5)]},
        {"num_total_classes": 20, "num_neg_samples": 4}, ("Input",)),
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_rule_matches_reference(case):
    op, ins, attrs, grad = RULES[case]
    jout, tout = rule_pair(op, ins, attrs, grad=grad, jit=True,
                           mode="train" if op == "nce" else "test")
    if op == "fake_quantize_abs_max":
        # the quantized domain's integers, exactly
        np.testing.assert_array_equal(tout["Out"][0].detach().numpy(),
                                      np.asarray(jout["Out"][0]))


def test_nce_negatives_are_uniform_over_the_classes():
    """With x = 0, W = I and no bias every logit is 0, so dX of a row
    counts the classes its negatives drew (one sigmoid(-log(k/n)) each):
    over 1000 rows the 10,000 draws lie in [0, n) and fall on each
    class at the uniform rate; another seed draws anew."""
    n, k, b = 20, 10, 1000
    label = np.zeros((b, 1), np.int64)

    def draws(seed):
        x = torch.zeros((b, n), requires_grad=True)
        ctx = pt_lowering.LoweringContext(None, "train", CPU, seed, 1)
        cost = pt_registry.get_op("nce").lower(ctx, {
            "Input": [x], "Label": [torch.from_numpy(label)],
            "Weight": [torch.eye(n)]},
            {"num_total_classes": n, "num_neg_samples": k})["Cost"][0]
        (dx,) = torch.autograd.grad(cost.sum(), [x])
        g_neg = 1 / (1 + np.exp(np.log(k / n)))          # sigmoid(adjusted)
        g_pos = g_neg - 1.0
        dx = dx.numpy()
        dx[:, 0] -= g_pos
        counts = np.round(dx / g_neg)
        np.testing.assert_allclose(counts * g_neg, dx, atol=1e-4)
        return counts

    counts = draws(0)
    assert (counts >= 0).all() and (counts.sum(1) == k).all()
    per_class = counts.sum(0)
    expect = b * k / n
    assert np.abs(per_class - expect).max() < 5 * np.sqrt(
        expect * (1 - 1 / n)), per_class
    assert not np.array_equal(counts, draws(1))


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_extras.py), against its programs
# ---------------------------------------------------------------------------
def _data(fl, name, shape, dtype="float32"):
    return fl.layers.data(name, shape, dtype=dtype, append_batch_size=False)


def test_minus_and_modified_huber():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 1).astype(np.float32)
    y = (rng.rand(6, 1) > 0.5).astype(np.float32)
    _, (m, h) = program_pair(lambda fl: [
        fl.layers.minus(_data(fl, "x", [-1, 1]), _data(fl, "y", [-1, 1])),
        fl.layers.modified_huber_loss(_data(fl, "x2", [-1, 1]),
                                      _data(fl, "y2", [-1, 1]))],
        {"x": x, "y": y, "x2": x, "y2": y})
    np.testing.assert_allclose(m, x - y, rtol=1e-6)
    val = (2 * y - 1) * x
    want = np.where(val < -1, -4 * val, np.where(val < 1, (1 - val) ** 2, 0))
    np.testing.assert_allclose(h, want, rtol=1e-5, atol=1e-6)


def test_conv_shift():
    rng = np.random.RandomState(1)
    b, m, n = 2, 7, 3
    x, y = rng.randn(b, m).astype(np.float32), rng.randn(b, n).astype(
        np.float32)
    _, (out,) = program_pair(lambda fl: [fl.layers.conv_shift(
        _data(fl, "x", [-1, m]), _data(fl, "y", [-1, n]))], {"x": x, "y": y})
    want = np.zeros_like(x)
    for bi in range(b):
        for i in range(m):
            for j in range(n):
                want[bi, i] += x[bi, (i + j - n // 2) % m] * y[bi, j]
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_pool_with_index_and_unpool():
    x = np.random.RandomState(2).randn(1, 2, 4, 4).astype(np.float32)

    def build(fl):
        out, mask = fl.layers.max_pool2d_with_index(
            _data(fl, "x", [-1, 2, 4, 4]), pool_size=2)
        return [out, mask, fl.layers.unpool(out, mask, 4, 4)]

    _, (out, mask, rec) = program_pair(build, {"x": x})
    assert out.shape == (1, 2, 2, 2) and mask.shape == (1, 2, 2, 2)
    for c in range(2):
        for i in range(2):
            for j in range(2):
                win = x[0, c, 2 * i:2 * i + 2, 2 * j:2 * j + 2]
                assert abs(out[0, c, i, j] - win.max()) < 1e-6
                fi = mask[0, c, i, j]
                assert abs(x[0, c, fi // 4, fi % 4] - win.max()) < 1e-6
    assert abs(rec.sum() - out.sum()) < 1e-4 and (rec != 0).sum() == 8


def test_spp_fixed_length():
    x = np.random.RandomState(3).randn(2, 3, 5, 7).astype(np.float32)
    _, (out,) = program_pair(lambda fl: [fl.layers.spp(
        _data(fl, "x", [-1, 3, 5, 7]), pyramid_height=2)], {"x": x})
    assert out.shape == (2, (1 + 4) * 3)
    np.testing.assert_allclose(out[:, :3], x.max(axis=(2, 3)), rtol=1e-6)


def test_positive_negative_pair():
    _, outs = program_pair(lambda fl: list(fl.layers.positive_negative_pair(
        _data(fl, "s", [-1, 1]), _data(fl, "l", [-1, 1]),
        _data(fl, "q", [-1, 1], "int64"))), {
        "s": np.array([[0.9], [0.1], [0.5], [0.4]], np.float32),
        "l": np.array([[1.0], [0.0], [1.0], [0.0]], np.float32),
        "q": np.array([[0], [0], [1], [1]], np.int64)})
    assert [float(np.asarray(v).reshape(())) for v in outs] == [2.0, 0.0,
                                                                0.0]


def test_precision_recall():
    _, (bm, _, st) = program_pair(lambda fl: list(fl.layers.precision_recall(
        _data(fl, "i", [-1, 1], "int64"), _data(fl, "l", [-1, 1], "int64"),
        class_number=3)), {"i": np.array([[0], [1], [1], [2]], np.int64),
                           "l": np.array([[0], [1], [2], [2]], np.int64)})
    assert abs(bm[3] - 0.75) < 1e-6 and abs(bm[4] - 0.75) < 1e-6
    assert st.shape == (3, 4)
    np.testing.assert_allclose(st[:, 0], [1, 1, 1])


def test_fake_quantize_roundtrip_and_ste():
    x = np.random.RandomState(4).randn(8, 8).astype(np.float32)

    def build(fl):
        q, scale = fl.layers.fake_quantize_abs_max(_data(fl, "x", [-1, 8]),
                                                   bit_length=8)
        return [q, scale, fl.layers.fake_dequantize_max_abs(
            q, scale, max_range=127)]

    jout, (q, scale, deq) = program_pair(build, {"x": x})
    np.testing.assert_array_equal(q, np.asarray(jout[0]))
    s = float(scale)
    assert abs(s - np.abs(x).max()) < 1e-6
    np.testing.assert_allclose(q, np.round(x / s * 127), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(deq, x, atol=s / 127 + 1e-6)


def test_fake_quantize_bits_and_grad():
    """4-bit range, zero-input safety, and the straight-through gradient:
    training through the quantizer matches the reference step for step
    and drops the loss by 80% in 100 Adam steps."""
    def build4(fl):
        xv = _data(fl, "x", [-1, 4])
        q4, scale4 = fl.layers.fake_quantize_abs_max(xv, bit_length=4)
        return [q4, scale4, fl.layers.fake_dequantize_max_abs(
            q4, scale4, max_range=7.0)]

    x = np.array([[-2.0, -0.3, 0.4, 1.6]], np.float32)
    _, (qv, sv, dv) = program_pair(build4, {"x": x})
    assert abs(float(sv) - 2.0) < 1e-6
    np.testing.assert_array_equal(qv, np.round(x / 2.0 * 7.0))
    assert np.abs(dv - x).max() <= 2.0 / 14 + 1e-6
    _, (qz, sz, _) = program_pair(build4, {"x": np.zeros((1, 4),
                                                          np.float32)})
    assert np.isfinite(qz).all() and float(sz) == 0.0

    def build(fl):
        xv = _data(fl, "x", [-1, 4])
        h = fl.layers.fc(xv, size=4, bias_attr=False, param_attr="qw")
        q, s = fl.layers.fake_quantize_abs_max(h, bit_length=8)
        deq = fl.layers.fake_dequantize_max_abs(q, s, max_range=127.0)
        return [fl.layers.mean(fl.layers.square(fl.layers.elementwise_sub(
            deq, _data(fl, "t", [-1, 4]))))]

    rng = np.random.RandomState(0)
    xs = rng.randn(16, 4).astype(np.float32)
    feed = {"x": xs, "t": xs @ np.diag([1.0, 2.0, 3.0, 4.0]).astype(
        np.float32)}
    program_pair(build, feed, grads=True)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = build(tfluid)[0]
        tfluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(())) for _ in range(100)]
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# WeightNormParamAttr (tests/test_weight_norm.py)
# ---------------------------------------------------------------------------
def _norm_except_dim(v, dim):
    if dim is None:
        return np.sqrt((v * v).sum())
    axes = tuple(i for i in range(v.ndim) if i != dim)
    return np.sqrt((v * v).sum(axis=axes, keepdims=True))


def test_weight_norm_initial_w_equals_v():
    """The startup sets g = ||v|| per output column (weight_norm_g_init),
    so the effective weight is v: the fc of the identity returns v, in
    both packages from the reference's startup state."""
    def build(fl):
        x = fl.layers.data(name="x", shape=[6], dtype="float32")
        return [fl.layers.fc(input=x, size=4, param_attr=fl.WeightNormParamAttr(
            dim=1, name="wn"))]

    progs = build_both(build)
    _, js, _, _ = progs["jax"]
    _, state = reference_state(js)
    tm, ts, names, _ = progs["port"]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)             # the port's own startup
    v = scope.find_var("wn.w_v").numpy()
    np.testing.assert_allclose(scope.find_var("wn.w_g").numpy(),
                               _norm_except_dim(v, 1).reshape(-1), rtol=1e-5)
    got = exe.run(tm, feed={"x": np.eye(6, dtype=np.float32)},
                  fetch_list=names, scope=scope)[0]
    np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-5)
    _, (got,) = program_pair(build, {"x": np.eye(6, dtype=np.float32)})
    np.testing.assert_allclose(got, state["wn.w_v"], rtol=1e-4, atol=1e-5)


def test_weight_norm_trains_v_and_g():
    """SGD through W = g v / ||v||: the first step's loss and the
    gradients of v, g and the bias equal the reference's; 40 steps in
    the port fit the target direction, moving both v and g."""
    def build(fl):
        x = fl.layers.data(name="x", shape=[5], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        pred = fl.layers.fc(input=x, size=1, param_attr=fl.WeightNormParamAttr(
            dim=None, name="wn2"))
        return [fl.layers.mean(fl.layers.square_error_cost(input=pred,
                                                           label=y))]

    rng = np.random.RandomState(0)
    w_true = rng.randn(5, 1).astype(np.float32)
    xs = rng.randn(16, 5).astype(np.float32)
    program_pair(build, {"x": xs, "y": xs @ w_true}, grads=True)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = build(tfluid)[0]
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    v0 = scope.find_var("wn2.w_v").numpy().copy()
    g0 = scope.find_var("wn2.w_g").numpy().copy()
    losses = []
    for _ in range(40):
        xs = rng.randn(16, 5).astype(np.float32)
        losses.append(float(exe.run(main, feed={"x": xs, "y": xs @ w_true},
                                    fetch_list=[loss], scope=scope)[0]
                            .reshape(())))
    assert losses[-1] < 0.2 * losses[0], losses
    v, g = scope.find_var("wn2.w_v").numpy(), scope.find_var("wn2.w_g").numpy()
    assert not np.allclose(v, v0) and not np.allclose(g, g0)
    w_eff = g.reshape(()) * v / _norm_except_dim(v, None)
    cos = (w_eff * w_true).sum() / (np.linalg.norm(w_eff)
                                    * np.linalg.norm(w_true))
    assert cos > 0.98, cos


# ---------------------------------------------------------------------------
# hsigmoid and nce layers
# ---------------------------------------------------------------------------
def test_hsigmoid_layer_trains_like_the_reference():
    """layers.hsigmoid over an fc: the loss and every gradient (the tree's
    inner-node weights and biases included) equal the reference's."""
    def build(fl):
        x = fl.layers.data(name="x", shape=[8], dtype="float32")
        lbl = fl.layers.data(name="lbl", shape=[1], dtype="int64")
        h = fl.layers.fc(x, size=6, act="tanh")
        return [fl.layers.mean(fl.layers.hsigmoid(h, lbl, num_classes=11))]

    rng = np.random.RandomState(40)
    program_pair(build, {"x": rng.randn(9, 8).astype(np.float32),
                         "lbl": rng.randint(0, 11, (9, 1))}, grads=True)


def test_nce_layer_with_same_rows_trains_like_the_reference():
    """layers.nce with its table's rows made equal (one ``Constant``
    initializer): the loss and dX-driven gradients of the fc below it
    equal the reference's whatever negatives each package draws."""
    def build(fl):
        x = fl.layers.data(name="x", shape=[8], dtype="float32")
        lbl = fl.layers.data(name="lbl", shape=[1], dtype="int64")
        h = fl.layers.fc(x, size=6, act="tanh",
                         param_attr=fl.ParamAttr(name="fc_w"))
        cost = fl.layers.nce(h, lbl, num_total_classes=30,
                             param_attr=fl.ParamAttr(
                                 name="nce_w",
                                 initializer=fl.initializer.Constant(0.2)),
                             num_neg_samples=5)
        return [fl.layers.mean(cost)]

    progs = build_both(build, grads=True)
    jm, js, names, params = progs["jax"]
    tm = progs["port"][0]
    jscope, state = reference_state(js)
    tscope = port_scope(state)
    feed = {"x": np.random.RandomState(41).randn(7, 8).astype(np.float32),
            "lbl": np.random.RandomState(42).randint(0, 30, (7, 1))}
    fetch = names + ["fc_w@GRAD"]
    import paddle_tpu as jfluid
    jout = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=make_feed("jax", feed), fetch_list=fetch, scope=jscope)
    tout = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=make_feed("port", feed), fetch_list=fetch, scope=tscope)
    np.testing.assert_allclose(tout[0], jout[0], **FWD)
    np.testing.assert_allclose(tout[1], jout[1], rtol=2e-3, atol=2e-4)
