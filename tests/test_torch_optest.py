"""One-op sweep of the torch port over the reference's own spec tables.

The specs are data from the reference's sweeps: ``GRAD_SPECS``
(tests/test_optest_grad.py) and ``UNARY``, ``ELEMENTWISE``, ``REDUCE``,
``COMPARE`` and ``LOGICAL`` (tests/test_optest_math.py). For each spec
whose op the port registers, the port's rule runs on the spec's numpy
inputs beside paddle_tpu's rule:

- the port's forward against the spec's numpy answer (math tables) at
  the spec's ``tol``;
- the port's forward against paddle_tpu's at the spec's ``tol``
  (default 1e-5, as op_test.check);
- the port's autograd gradient of each grad slot against paddle_tpu's
  ``jax.vjp`` gradient, for the same random cotangent, at the spec's
  ``gtol`` (default 5e-3, as op_test.check_grad) as rtol and atol.

Two completeness tests keep the sweep honest: the spec ops it skips
are exactly ``SKIPPED`` (each with the ROADMAP item that ports it), and
every op this slice registers is reached by a spec or by ``EXTRA`` /
the distribution tests below. Integer outputs compare by value (the
port's ``canonical_int()`` is int64, the reference's int32).
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

from test_optest_grad import GRAD_SPECS
from test_optest_math import (BX, BY, COMPARE, ELEMENTWISE, LOGICAL, REDUCE,
                              UNARY, XR)
from test_torch_ops import BASIC_REST, NN_REST

torch.set_num_threads(1)

SEQ = "Remaining op families and the zoo"
# spec ops the port does not register yet, with the ROADMAP item that
# ports each (registry.WAITING names the same)
SKIPPED = {
    "conv_shift": SEQ, "fake_dequantize_max_abs": SEQ,
    "max_pool2d_with_index": SEQ,
    "minus": SEQ, "modified_huber_loss": SEQ, "pad_constant_like": SEQ,
    "spp": SEQ, "ssd_loss": SEQ, "unpool": SEQ,
    "weight_norm": SEQ,
}


def _math_specs():
    """The math tables as {id: spec} in op_test's spec form."""
    specs = {}
    for op, x, want, attrs, grad in UNARY:
        specs[f"unary-{op}"] = {"op": op, "inputs": {"X": x},
                                "attrs": attrs, "want": {"Out": want},
                                "grad": ["X"] if grad else None,
                                "tol": 2e-5}
    for op, x, y, want, grad in ELEMENTWISE:
        specs[f"elementwise-{op}"] = {
            "op": op, "inputs": {"X": x, "Y": y}, "want": {"Out": want},
            "grad": ["X", "Y"] if grad else None}
    for op, attrs, want, grad in REDUCE:
        specs[f"reduce-{op}"] = {"op": op, "inputs": {"X": XR},
                                 "attrs": attrs, "want": {"Out": want},
                                 "grad": ["X"] if grad else None,
                                 "tol": 1e-4}
    for op, x, y, want in COMPARE:
        specs[f"compare-{op}"] = {"op": op, "inputs": {"X": x, "Y": y},
                                  "want": {"Out": want}}
    for op, want in LOGICAL:
        specs[f"logical-{op}"] = {"op": op, "inputs": {"X": BX, "Y": BY},
                                  "want": {"Out": want}}
    return specs


MATH = _math_specs()
GRAD = {f"grad-{op}": dict(spec, op=op) for op, spec in GRAD_SPECS.items()}
ALL_SPECS = {**MATH, **GRAD}


def _ported(specs):
    return sorted(k for k, s in specs.items()
                  if pt_registry.has_op(s["op"]))


def _as_list(v):
    return list(v) if isinstance(v, list) else [v]


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _out_slots(spec):
    """The output slots a spec checks: its ``outputs`` or its ``want``."""
    return spec["outputs"] if "outputs" in spec else spec["want"]


def _dense(v):
    """An output's array: a sequence output's padded data (im2sequence
    emits one), else the value."""
    return v.data if hasattr(v, "lengths") else v


def _run(spec, seed=0):
    """Both rules on the spec's inputs; returns (jax outs, port outs,
    jax grads, port grads) as numpy, the grads by (slot, index) for the
    spec's grad slots, through one random cotangent per float output
    the spec names."""
    op, attrs = spec["op"], dict(spec.get("attrs") or {})
    ins = {s: [np.asarray(a) for a in _as_list(v)]
           for s, v in spec["inputs"].items()}
    grad_slots = spec.get("grad") or []
    out_slots = list(_out_slots(spec))
    jrule = jax_registry.get_op(op).lower
    trule = pt_registry.get_op(op).lower

    def jfn(diff):
        jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        for (s, i), a in diff.items():
            jins[s][i] = a
        ctx = jax_lowering.LoweringContext(None, "test",
                                           jax.random.PRNGKey(0))
        return jrule(ctx, jins, dict(attrs))

    diff_keys = [(s, i) for s in grad_slots for i, a in enumerate(ins[s])
                 if _is_float(a)]
    jdiff = {k: jnp.asarray(ins[k[0]][k[1]]) for k in diff_keys}
    jout = jfn(jdiff)
    jout_np = {s: [np.asarray(_dense(a)) for a in v]
               for s, v in jout.items()}

    tins = {s: [torch.from_numpy(a.copy()) for a in v]
            for s, v in ins.items()}
    leaves = {}
    for k in diff_keys:
        leaves[k] = tins[k[0]][k[1]].requires_grad_()
    tctx = pt_lowering.LoweringContext(None, "test", torch.device("cpu"),
                                       0, 1)
    with torch.enable_grad():
        tout = trule(tctx, tins, dict(attrs))
    tout_np = {s: [_dense(t).detach().numpy() for t in v]
               for s, v in tout.items()}
    if not diff_keys:
        return jout_np, tout_np, {}, {}

    rng = np.random.RandomState(seed)
    cots = {(s, i): np.asarray(rng.randn(*np.shape(a)), np.float32)
            for s in out_slots for i, a in enumerate(jout_np.get(s, []))
            if _is_float(a)}

    def jloss(diff):
        out = jfn(diff)
        return sum(jnp.sum(_dense(out[s][i]) * c)
                   for (s, i), c in cots.items())

    jgrad = jax.grad(jloss)(jdiff)
    with torch.enable_grad():
        tl = sum((_dense(tout[s][i]) * torch.from_numpy(c)).sum()
                 for (s, i), c in cots.items())
        # an output that does not depend on the inputs (fill_zeros_like)
        # has no graph: its gradient is zero
        tgrad = (torch.autograd.grad(tl, [leaves[k] for k in diff_keys],
                                     allow_unused=True)
                 if tl.requires_grad else [None] * len(diff_keys))
    tgrad = {k: (np.zeros_like(ins[k[0]][k[1]]) if g is None
                 else g.numpy()) for k, g in zip(diff_keys, tgrad)}
    return jout_np, tout_np, {k: np.asarray(v) for k, v in jgrad.items()}, \
        tgrad


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=what)


def _check(spec):
    tol = spec.get("tol", 1e-5)
    gtol = spec.get("gtol", 5e-3)
    jout, tout, jgrad, tgrad = _run(spec)
    for s in _out_slots(spec):
        assert len(tout[s]) == len(jout[s]), s
        for i, (t, j) in enumerate(zip(tout[s], jout[s])):
            _close(t, j, tol, f"{spec['op']} {s}[{i}] vs paddle_tpu")
    for s, want in (spec.get("want") or {}).items():
        _close(tout[s][0], np.asarray(want), tol,
               f"{spec['op']} {s} vs numpy")
    assert set(jgrad) == set(tgrad)
    for k in jgrad:
        _close(tgrad[k], jgrad[k], gtol, f"{spec['op']} d{k}")


@pytest.mark.parametrize("key", _ported(MATH))
def test_math_spec(key):
    _check(MATH[key])


@pytest.mark.parametrize("key", _ported(GRAD))
def test_grad_spec(key):
    _check(GRAD[key])


# ---------------------------------------------------------------------------
# ops and attribute variants no spec reaches, held to paddle_tpu the same way
# ---------------------------------------------------------------------------

R = np.random.RandomState(3)
F3 = R.randn(2, 3, 4).astype(np.float32)
F2 = R.randn(3, 5).astype(np.float32)
PROBS = (lambda p: p / p.sum(-1, keepdims=True))(
    R.rand(6, 4).astype(np.float32) + 0.05)
LBL6 = np.asarray([[0], [3], [2], [2], [1], [0]], np.int64)

EXTRA = {
    "fill_constant_batch_size_like": {
        "inputs": {"Input": F2}, "attrs": {"shape": [-1, 7], "value": 2.5,
                                           "dtype": "float32"}},
    "assign_value": {"inputs": {}, "attrs": {
        "values": np.arange(6, dtype=np.float32).reshape(2, 3),
        "dtype": "float32"}},
    "shape": {"inputs": {"Input": F3}},
    "isfinite": {"inputs": {"X": F2}},
    "isfinite-inf": {"op": "isfinite",
                     "inputs": {"X": np.asarray([1.0, np.inf], np.float32)}},
    "logical_not": {"inputs": {"X": F2 > 0}},
    "cumsum": {"inputs": {"X": F2}, "attrs": {"axis": 1}, "grad": ["X"]},
    "cumsum-exclusive-reverse": {
        "op": "cumsum", "inputs": {"X": F2},
        "attrs": {"axis": 1, "exclusive": True, "reverse": True},
        "grad": ["X"]},
    "arg_max": {"inputs": {"X": F3}, "attrs": {"axis": 1}},
    "arg_min": {"inputs": {"X": F3}, "attrs": {"axis": -1}},
    "argsort": {"inputs": {"X": F3}, "attrs": {"axis": 1}, "grad": ["X"]},
    "top_k": {"inputs": {"X": F2}, "attrs": {"k": 2}, "grad": ["X"]},
    "one_hot": {"inputs": {"X": LBL6}, "attrs": {"depth": 4}},
    "one_hot-flat-out-of-range": {
        "op": "one_hot", "inputs": {"X": np.asarray([0, 5, -1, 2],
                                                    np.int64)},
        "attrs": {"depth": 4}},
    "sequence_mask": {"inputs": {"X": np.asarray([3, 0, 5], np.int64)},
                      "attrs": {"maxlen": 6, "out_dtype": "float32"}},
    "sequence_mask-int64": {
        "op": "sequence_mask", "inputs": {"X": np.asarray([2, 4],
                                                          np.int64)},
        "attrs": {"maxlen": 4}},
    "accuracy": {"inputs": {"Out": np.sort(PROBS, -1)[:, ::-1][:, :2],
                            "Indices": np.argsort(-PROBS, -1)[:, :2],
                            "Label": LBL6}},
    "auc": {"inputs": {"Predict": np.stack([1 - PROBS[:, 0],
                                            PROBS[:, 0]], 1),
                       "Label": (LBL6 == 0).astype(np.int64),
                       "StatPos": np.zeros(11, np.float32),
                       "StatNeg": np.zeros(11, np.float32)},
            "attrs": {"num_thresholds": 10}},
    "mean_iou": {"inputs": {"Predictions": np.asarray([0, 1, 2, 2, 1],
                                                      np.int64),
                            "Labels": np.asarray([0, 1, 1, 2, 0],
                                                 np.int64)},
                 "attrs": {"num_classes": 3}},
    # attribute variants of ported ops
    "matmul-transpose-alpha-broadcast": {
        "op": "matmul", "inputs": {"X": R.randn(2, 1, 4, 3).astype(
            np.float32), "Y": R.randn(3, 5, 4).astype(np.float32)},
        "attrs": {"transpose_X": True, "transpose_Y": True, "alpha": 0.5},
        "grad": ["X", "Y"]},
    "matmul-vector": {"op": "matmul",
                      "inputs": {"X": R.randn(4).astype(np.float32),
                                 "Y": R.randn(4, 3).astype(np.float32)},
                      "grad": ["X", "Y"]},
    "split-sections": {"op": "split", "inputs": {"X": F2},
                       "attrs": {"sections": [1, 4], "axis": 1},
                       "grad": ["X"]},
    "strided_slice-negative": {
        "op": "strided_slice", "inputs": {"Input": F2},
        "attrs": {"axes": [1, 0], "starts": [4, 0], "ends": [0, 3],
                  "strides": [-2, 2]}, "grad": ["Input"]},
    "slice-negative": {"op": "slice", "inputs": {"Input": F3},
                       "attrs": {"axes": [2], "starts": [-3], "ends": [99]},
                       "grad": ["Input"]},
    "pad2d-reflect": {"op": "pad2d", "inputs": {"X": R.randn(
        1, 2, 4, 4).astype(np.float32)}, "attrs": {
            "paddings": [1, 2, 2, 1], "mode": "reflect"}, "grad": ["X"]},
    "pad2d-edge-nhwc": {"op": "pad2d", "inputs": {"X": R.randn(
        1, 4, 4, 2).astype(np.float32)}, "attrs": {
            "paddings": [1, 0, 0, 2], "mode": "edge",
            "data_format": "NHWC"}, "grad": ["X"]},
    "scatter-add": {"op": "scatter", "inputs": {
        "X": F2, "Ids": np.asarray([2, 0, 2], np.int64),
        "Updates": R.randn(3, 5).astype(np.float32)},
        "attrs": {"overwrite": False}, "grad": ["X", "Updates"]},
    "squeeze-all": {"op": "squeeze", "inputs": {"X": F2[None, :, None]},
                    "grad": ["X"]},
    "reduce_sum-keep-all": {"op": "reduce_sum", "inputs": {"X": F3},
                            "attrs": {"reduce_all": True,
                                      "keep_dim": True}, "grad": ["X"]},
    "reduce_mean-keep-two": {"op": "reduce_mean", "inputs": {"X": F3},
                             "attrs": {"dim": [0, -1], "keep_dim": True},
                             "grad": ["X"]},
    "layer_norm-axis2-stats": {
        "op": "layer_norm", "inputs": {"X": F3,
                                       "Scale": R.rand(4).astype(np.float32),
                                       "Bias": R.randn(4).astype(np.float32)},
        "attrs": {"begin_norm_axis": 2, "epsilon": 1e-5},
        "outputs": {"Y": None, "Mean": None, "Variance": None},
        "grad": ["X", "Scale", "Bias"]},
    "label_smooth-prior": {
        "op": "label_smooth", "inputs": {
            "X": np.eye(4, dtype=np.float32)[[0, 3, 1]],
            "PriorDist": np.asarray([[0.1, 0.2, 0.3, 0.4]], np.float32)},
        "attrs": {"epsilon": 0.2}, "grad": ["X"]},
    "kldiv_loss-batchmean": {
        "op": "kldiv_loss", "inputs": {"X": F2, "Target": np.abs(F2) + 0.1},
        "attrs": {"reduction": "batchmean"}, "grad": ["X"]},
    "prelu-channel": {"op": "prelu", "inputs": {
        "X": R.randn(2, 3, 2, 2).astype(np.float32),
        "Alpha": R.rand(3).astype(np.float32)},
        "attrs": {"mode": "channel"}, "grad": ["X", "Alpha"]},
    "dropout-test-downgrade": {"op": "dropout", "inputs": {"X": F2},
                               "attrs": {"dropout_prob": 0.3,
                                         "is_test": True},
                               "grad": ["X"]},
    "dropout-test-upscale": {
        "op": "dropout", "inputs": {"X": F2},
        "attrs": {"dropout_prob": 0.3, "is_test": True,
                  "dropout_implementation": "upscale_in_train"},
        "grad": ["X"]},
    "softmax_with_cross_entropy-soft": {
        "op": "softmax_with_cross_entropy",
        "inputs": {"Logits": F2, "Label": (lambda p: p / p.sum(
            -1, keepdims=True))(np.abs(F2) + 0.1)},
        "attrs": {"soft_label": True}, "outputs": {"Loss": None},
        "grad": ["Logits", "Label"]},
    "scaled_dot_product_attention-mask": {
        "op": "scaled_dot_product_attention",
        "inputs": {"Q": R.randn(2, 3, 4).astype(np.float32),
                   "K": R.randn(2, 5, 4).astype(np.float32),
                   "V": R.randn(2, 5, 4).astype(np.float32),
                   "Mask": np.where(R.rand(2, 3, 5) > 0.3, 0.0, -1e9)
                   .astype(np.float32)},
        "attrs": {"scale": 0.3}, "outputs": {"Out": None},
        "grad": ["Q", "K", "V"]},
}


def _extra_spec(key):
    spec = dict(EXTRA[key])
    spec.setdefault("op", key)
    if "outputs" not in spec:
        jout, _, _, _ = _run(dict(spec, outputs={}, grad=None))
        spec["outputs"] = {s: None for s in jout}
    return spec


@pytest.mark.parametrize("key", sorted(EXTRA))
def test_extra_case(key):
    _check(_extra_spec(key))


# ---------------------------------------------------------------------------
# the random ops: distributions and replay (draws cannot match jax's)
# ---------------------------------------------------------------------------


def _draw(op, ins, attrs, step=1, seed=0):
    ctx = pt_lowering.LoweringContext(None, "train", torch.device("cpu"),
                                      seed, step)
    out = pt_registry.get_op(op).lower(
        ctx, {s: [torch.from_numpy(np.asarray(a)) for a in v]
              for s, v in ins.items()}, dict(attrs))
    return {s: [t.numpy() for t in v] for s, v in out.items()}


REF = {"Input": [np.zeros((4000, 3), np.float32)]}
RANDOM = {
    "uniform_random_batch_size_like": (
        REF, {"shape": [-1, 50], "min": -2.0, "max": 3.0}, (4000, 50),
        0.5, 25 / 12),
    "gaussian_random_batch_size_like": (
        REF, {"shape": [-1, 50], "mean": 1.0, "std": 2.0}, (4000, 50),
        1.0, 4.0),
    # a normal truncated at +-2 std has variance 0.7737 std^2
    "truncated_gaussian_random": (
        {}, {"shape": [4000, 50], "mean": -1.0, "std": 0.5},
        (4000, 50), -1.0, 0.7737 * 0.25),
}


@pytest.mark.parametrize("op", sorted(RANDOM))
def test_random_op_distribution_and_replay(op):
    ins, attrs, shape, mean, var = RANDOM[op]
    a = _draw(op, ins, attrs)["Out"][0]
    assert a.shape == shape and a.dtype == np.float32
    n = a.size
    assert abs(a.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(a.var() - var) / var < 0.02
    if op == "truncated_gaussian_random":
        assert np.abs(a - mean).max() <= 2 * 0.5 + 1e-6
    np.testing.assert_array_equal(_draw(op, ins, attrs)["Out"][0], a)
    assert not np.array_equal(_draw(op, ins, attrs, step=2)["Out"][0], a)


def test_sampling_id_follows_the_row_probabilities():
    p = np.asarray([[0.7, 0.2, 0.1, 0.0]] * 20000, np.float32)
    ids = _draw("sampling_id", {"X": [p]}, {})["Out"][0]
    assert ids.shape == (20000,) and ids.dtype == np.int64
    freq = np.bincount(ids, minlength=4) / ids.size
    sd = np.sqrt(p[0] * (1 - p[0]) / ids.size)
    assert (np.abs(freq - p[0]) <= 5 * sd + 1e-12).all(), freq
    np.testing.assert_array_equal(
        _draw("sampling_id", {"X": [p]}, {})["Out"][0], ids)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_train_distribution_and_replay(impl):
    x = np.random.RandomState(5).randn(64, 512).astype(np.float32) + 3.0
    p = 0.1
    out = _draw("dropout", {"X": [x]},
                {"dropout_prob": p, "dropout_implementation": impl})
    y, mask = out["Out"][0], out["Mask"][0]
    kept = mask.mean()
    assert abs(kept - (1 - p)) < 5 * np.sqrt(p * (1 - p) / x.size)
    scale = 1.0 / (1 - p) if impl == "upscale_in_train" else 1.0
    np.testing.assert_allclose(y, x * mask * scale, rtol=1e-6, atol=0)
    again = _draw("dropout", {"X": [x]},
                  {"dropout_prob": p, "dropout_implementation": impl})
    np.testing.assert_array_equal(again["Mask"][0], mask)


# ---------------------------------------------------------------------------
# completeness
# ---------------------------------------------------------------------------


def test_the_sweep_skips_exactly_the_named_ops():
    skipped = {s["op"] for s in ALL_SPECS.values()
               if not pt_registry.has_op(s["op"])}
    assert skipped == set(SKIPPED)
    for op, item in SKIPPED.items():
        assert pt_registry.WAITING[op] == item, op


OWN_TESTS = {"uniform_random_batch_size_like", "sampling_id",
             "gaussian_random_batch_size_like", "truncated_gaussian_random",
             "dropout"}


def test_every_slice_op_is_reached():
    reached = ({s["op"] for s in ALL_SPECS.values()}
               | {_extra_spec(k)["op"] for k in EXTRA} | OWN_TESTS)
    assert (BASIC_REST | NN_REST | {"sequence_mask"}) - reached == set()
