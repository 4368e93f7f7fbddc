"""The transpilers of ROADMAP item 5 through the torch port, against the
JAX package: the cases of tests/test_transpilers.py (the conv +
batch_norm fold in both layouts, the conv-net remat policies),
tests/test_quantize.py (weight-only int8 for mul and conv2d) and
tests/test_fuse_optimizer.py (fused updates, exact for each rule, with
resume).

Tolerances: the folded program against the unfolded test program at
rtol 1e-4 / atol 1e-5 and the int8 serving outputs within 0.05 (the
reference tests' own); the folded filters and bias bit-equal, and the
int8 weights and ``@scale`` byte-equal, to the reference's numpy
transpile of the same scope (both float32 on the CPU); fused and
per-parameter updates bit-equal, as in the reference; remat against no
remat at rtol 1e-5 in float32 (the reference's tight pin).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as jfluid
from paddle_tpu.transpiler import QuantizeTranspiler as JQuantize

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.models.resnet import resnet_cifar10
from paddle_tpu_torch.transpiler import (QuantizeTranspiler,
                                         amp_transpile, fuse_optimizer_ops)

torch.set_num_threads(1)

CPU = torch.device("cpu")
EXE = tfluid.Executor(tfluid.CPUPlace())


def _host(v):
    return np.asarray(weights.to_host(v))


def _conv_bn_net(fluid, layout="NCHW"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[3, 8, 8])
        x = img
        if layout == "NHWC":
            x = fluid.layers.transpose(x, perm=[0, 2, 3, 1])
        conv = fluid.layers.conv2d(x, num_filters=4, filter_size=3,
                                   padding=1, bias_attr=False,
                                   data_format=layout)
        bn = fluid.layers.batch_norm(conv, is_test=False,
                                     data_layout=layout)
        out = fluid.layers.relu(bn)
    return main, startup, out


def _bn_stats(rng):
    return {"batch_norm_0.global_0": rng.randn(4).astype(np.float32) * 0.1,
            "batch_norm_0.global_1": (rng.rand(4) + 0.5).astype(np.float32),
            "batch_norm_0.w_0": (rng.rand(4) + 0.5).astype(np.float32),
            "batch_norm_0.b_0": rng.randn(4).astype(np.float32)}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_inference_transpiler_fold_matches_unfolded(layout):
    """tests/test_transpilers.py's case on the port: no batch_norm is
    left, and the folded program matches the unfolded test program."""
    main, startup, out = _conv_bn_net(tfluid, layout)
    scope = tfluid.Scope()
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    EXE.run(startup, scope=scope)
    for n, v in _bn_stats(rng).items():
        assert scope.has(n), n
        scope.set(n, torch.from_numpy(v))
    want = EXE.run(main.clone(for_test=True), feed={"img": x},
                   fetch_list=[out], scope=scope)
    folded = tfluid.InferenceTranspiler().transpile(main, scope=scope)
    assert "batch_norm" not in [op.type for op in
                                folded.global_block().ops]
    got = EXE.run(folded, feed={"img": x}, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_fold_is_bit_equal_to_the_reference(layout):
    """From one scope, the port's folded filter and bias equal the
    reference's numpy fold bit for bit, and the two folded programs are
    the same ops."""
    jmain, jstartup, _ = _conv_bn_net(jfluid, layout)
    tmain, _, _ = _conv_bn_net(tfluid, layout)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    for n, v in _bn_stats(np.random.RandomState(1)).items():
        jscope.set(n, v)
    state = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    tscope = weights.load_state(tfluid.Scope(), state, CPU)
    jf = jfluid.InferenceTranspiler().transpile(jmain, scope=jscope)
    tf = tfluid.InferenceTranspiler().transpile(tmain, scope=tscope)
    assert [(op.type, op.inputs, op.outputs, op.attrs)
            for op in tf.global_block().ops] == \
        [(op.type, op.inputs, op.outputs, op.attrs)
         for op in jf.global_block().ops]
    for n in ("conv2d_0.w_0", "conv2d_0.w_0@bn_folded_bias"):
        got, want = _host(tscope.find_var(n)), np.asarray(jscope.find_var(n))
        assert got.dtype == want.dtype == np.float32, n
        np.testing.assert_array_equal(got, want, err_msg=n)


def test_inference_transpiler_leaves_scope_consistent():
    main, startup, out = _conv_bn_net(tfluid)
    scope = tfluid.Scope()
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    EXE.run(startup, scope=scope)
    folded = tfluid.InferenceTranspiler().transpile(main, scope=scope)
    res = EXE.run(folded, feed={"img": x}, fetch_list=[out], scope=scope)
    assert np.isfinite(res[0]).all()


# ---------------------------------------------------------------------------
# QuantizeTranspiler
# ---------------------------------------------------------------------------


def _fc_net(fluid):
    main, sup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, sup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        pred = fluid.layers.fc(input=h, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=y))
        test_p = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, sup, test_p, pred, loss


def test_quantized_fc_close_to_float():
    main, sup, test_p, pred, loss = _fc_net(tfluid)
    scope = tfluid.Scope()
    rng = np.random.RandomState(0)
    EXE.run(sup, scope=scope)
    for _ in range(5):
        EXE.run(main, feed={"x": rng.randn(8, 16).astype(np.float32),
                            "y": rng.randint(0, 10, (8, 1))},
                fetch_list=[loss], scope=scope)
    xs = rng.randn(12, 16).astype(np.float32)
    feed = {"x": xs, "y": np.zeros((12, 1), np.int64)}
    ref = EXE.run(test_p, feed=feed, fetch_list=[pred], mode="test",
                  scope=scope)[0]
    qp = QuantizeTranspiler().transpile(test_p, scope=scope)
    types = [op.type for op in qp.global_block().ops]
    assert types.count("quantized_mul") == 2, types
    for name in list(scope.keys()):
        if name.endswith("@scale"):
            assert scope.find_var(name[:-len("@scale")]).dtype == \
                torch.int8
    got = EXE.run(qp, feed=feed, fetch_list=[pred], mode="test",
                  scope=scope)[0]
    assert np.abs(got - ref).max() < 0.05, np.abs(got - ref).max()
    assert np.argmax(got, -1).tolist() == np.argmax(ref, -1).tolist()


def _conv_fc(fluid):
    main, sup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, sup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16],
                                dtype="float32")
        c = fluid.layers.conv2d(input=img, num_filters=8, filter_size=3,
                                act="relu")
        out = fluid.layers.fc(input=c, size=5)
    return main, sup, out


def test_quantized_conv_close_to_float_and_byte_equal_to_reference():
    """tests/test_quantize.py's conv case (relative max error < 0.05),
    with the int8 weights and scales byte-equal to the reference's, and
    the quantized outputs of both packages within rtol/atol 1e-5."""
    jmain, jsup, jout = _conv_fc(jfluid)
    tmain, _, tout = _conv_fc(tfluid)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jsup, scope=jscope)
    state = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    tscope = weights.load_state(tfluid.Scope(), state, CPU)
    xs = np.random.RandomState(1).randn(4, 3, 16, 16).astype(np.float32)
    ref = EXE.run(tmain, feed={"img": xs}, fetch_list=[tout], mode="test",
                  scope=tscope)[0]
    jq = JQuantize().transpile(jmain, scope=jscope)
    tq = QuantizeTranspiler().transpile(tmain, scope=tscope)
    types = [op.type for op in tq.global_block().ops]
    assert types == [op.type for op in jq.global_block().ops]
    assert "quantized_conv2d" in types and "quantized_mul" in types
    scales = [n for n in jscope.keys() if n.endswith("@scale")]
    assert len(scales) == 2
    for s in scales:
        for n in (s, s[:-len("@scale")]):
            got, want = _host(tscope.find_var(n)), np.asarray(
                jscope.find_var(n))
            assert got.dtype == want.dtype, n
            assert got.tobytes() == want.tobytes(), n
    got = EXE.run(tq, feed={"img": xs}, fetch_list=[tout], mode="test",
                  scope=tscope)[0]
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)
    assert rel < 0.05, rel
    want = jexe.run(jq, feed={"img": xs}, fetch_list=[jout], mode="test",
                    scope=jscope)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_quantize_skips_non_persistable_matmul():
    main, sup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, sup):
        a = tfluid.layers.data(name="a", shape=[4, 6],
                               append_batch_size=False, dtype="float32")
        b = tfluid.layers.data(name="b", shape=[6, 3],
                               append_batch_size=False, dtype="float32")
        tfluid.layers.mul(a, b)
    qp = QuantizeTranspiler().transpile(main, scope=tfluid.Scope())
    assert [op.type for op in qp.global_block().ops] == ["mul"]


# ---------------------------------------------------------------------------
# fuse_optimizer_ops
# ---------------------------------------------------------------------------


def _fuse_net(opt_name):
    main, sup = tfluid.Program(), tfluid.Program()
    with unique_name.guard(), tfluid.program_guard(main, sup):
        img = tfluid.layers.data("img", shape=[3, 8, 8])
        label = tfluid.layers.data("label", shape=[1], dtype="int64")
        x = tfluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                 padding=1)
        x = tfluid.layers.batch_norm(x, act="relu")
        x = tfluid.layers.conv2d(x, num_filters=4, filter_size=3,
                                 padding=1)
        pred = tfluid.layers.fc(x, size=3, act="softmax")
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(pred, label))
        opt = {"momentum": lambda: tfluid.optimizer.Momentum(
                   learning_rate=0.05, momentum=0.9),
               "adagrad": lambda: tfluid.optimizer.Adagrad(
                   learning_rate=0.05),
               "adam": lambda: tfluid.optimizer.Adam(learning_rate=0.05),
               "sgd": lambda: tfluid.optimizer.SGD(learning_rate=0.05)}
        opt[opt_name]().minimize(loss)
    return main, sup, loss


def _fuse_feed(rng):
    lab = rng.randint(0, 3, (4, 1))
    xs = (rng.randn(4, 3, 8, 8) * 0.1
          + lab[:, :, None, None]).astype(np.float32)
    return {"img": xs, "label": lab.astype(np.int64)}


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adagrad",
                                      "adam"])
def test_fused_updates_are_exact(opt_name):
    main_a, sup_a, loss_a = _fuse_net(opt_name)
    main_b, sup_b, loss_b = _fuse_net(opt_name)
    assert fuse_optimizer_ops(main_b, sup_b) >= 1
    types = [op.type for op in main_b.global_block().ops]
    assert types.count(opt_name) == 1
    assert "flatten_concat" in types and "fused_param_split" in types
    rng = np.random.RandomState(0)
    feeds = [_fuse_feed(rng) for _ in range(3)]
    scope_a, scope_b = tfluid.Scope(), tfluid.Scope()
    EXE.run(sup_a, scope=scope_a)
    init = {k: _host(scope_a.find_var(k)) for k in scope_a.keys()}
    EXE.run(sup_b, scope=scope_b)
    for k, v in init.items():
        if scope_b.has(k):
            scope_b.set(k, torch.from_numpy(v.copy()))
    for f in feeds:
        la = EXE.run(main_a, feed=f, fetch_list=[loss_a], scope=scope_a)[0]
        lb = EXE.run(main_b, feed=f, fetch_list=[loss_b], scope=scope_b)[0]
        np.testing.assert_array_equal(la, lb)
    params = [p.name for p in main_a.all_parameters()]
    assert params
    for name in params:
        np.testing.assert_array_equal(_host(scope_a.find_var(name)),
                                      _host(scope_b.find_var(name)),
                                      err_msg=name)


def test_fused_program_matches_the_reference_rewrite():
    """The rewrite is the reference's IR pass: the same op sequence and
    the same fused state declarations."""
    from paddle_tpu.transpiler import fuse_optimizer_ops as jfuse
    jm, js = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jm, js):
        img = jfluid.layers.data("img", shape=[3, 8, 8])
        label = jfluid.layers.data("label", shape=[1], dtype="int64")
        x = jfluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                 padding=1)
        x = jfluid.layers.batch_norm(x, act="relu")
        x = jfluid.layers.conv2d(x, num_filters=4, filter_size=3,
                                 padding=1)
        pred = jfluid.layers.fc(x, size=3, act="softmax")
        loss = jfluid.layers.mean(jfluid.layers.cross_entropy(pred, label))
        jfluid.optimizer.Momentum(learning_rate=0.05,
                                  momentum=0.9).minimize(loss)
    tm, ts, _ = _fuse_net("momentum")
    with jfluid.unique_name.guard():
        nj = jfuse(jm, js)
    with unique_name.guard():
        assert fuse_optimizer_ops(tm, ts) == nj
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert sorted(tm.global_block().vars) == sorted(jm.global_block().vars)


def test_per_param_state_is_gone_and_resume_works():
    main, sup, loss = _fuse_net("momentum")
    fuse_optimizer_ops(main, sup)
    gb = main.global_block()
    assert not any("velocity" in n for n in gb.vars
                   if not n.startswith("fused_")), list(gb.vars)
    flat = [n for n in gb.vars if n.startswith("fused_velocity")]
    assert len(flat) == 1 and gb.vars[flat[0]].persistable
    rng = np.random.RandomState(1)
    scope = tfluid.Scope()
    EXE.run(sup, scope=scope)
    f0, f1 = _fuse_feed(rng), _fuse_feed(rng)
    EXE.run(main, feed=f0, fetch_list=[loss], scope=scope)
    vals = {k: _host(scope.find_var(k)) for k in scope.keys()}
    want = EXE.run(main, feed=f1, fetch_list=[loss], scope=scope)[0]
    # a checkpoint round-trip resumes bit for bit
    scope2 = weights.load_state(tfluid.Scope(), vals, CPU)
    got = EXE.run(main, feed=f1, fetch_list=[loss], scope=scope2)[0]
    np.testing.assert_array_equal(got, want)
    for k in vals:
        np.testing.assert_array_equal(_host(scope2.find_var(k)),
                                      _host(scope.find_var(k)), err_msg=k)


def test_repeated_param_group_is_left_unfused():
    main, sup = tfluid.Program(), tfluid.Program()
    with unique_name.guard(), tfluid.program_guard(main, sup):
        x = tfluid.layers.data("x", shape=[8])
        h = tfluid.layers.fc(x, size=8)
        loss = tfluid.layers.mean(h)
        tfluid.optimizer.Momentum(learning_rate=0.1,
                                  momentum=0.9).minimize(loss)
        gb = main.global_block()
        for op in [op for op in gb.ops if op.type == "momentum"]:
            gb.append_op(type="momentum", inputs=dict(op.inputs),
                         outputs=dict(op.outputs), attrs=dict(op.attrs))
    assert fuse_optimizer_ops(main, sup) == 0
    types = [op.type for op in main.global_block().ops]
    assert types.count("momentum") == 4 and "flatten_concat" not in types


# ---------------------------------------------------------------------------
# the conv-net remat policies
# ---------------------------------------------------------------------------


def _train_cifar(policy, amp_level=None, steps=6):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data("img", [3, 8, 8], dtype="float32")
        label = tfluid.layers.data("label", [1], dtype="int64")
        pred = resnet_cifar10(img, class_num=4, depth=8)
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(
            input=pred, label=label))
        tfluid.optimizer.Momentum(0.05, 0.9).minimize(loss)
    if amp_level:
        amp_transpile(main, level=amp_level)
    if policy:
        tfluid.memory_optimize(main, policy=policy)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(8, 3, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].reshape(()))
            for _ in range(steps)], main, feed, scope, loss


@pytest.mark.parametrize("amp_level", [None, "O2"])
@pytest.mark.parametrize("policy", ["recompute_norms", "save_conv_only"])
def test_conv_net_remat_policies_agree_and_converge(policy, amp_level):
    """tests/test_transpilers.py's conv-net case: each policy matches no
    remat (float32 rtol 1e-5; under O2 the reference's bf16 allowance,
    rtol 2e-2 / atol 2e-3, for save_conv_only) and the loss falls."""
    base = _train_cifar(None, amp_level)[0]
    remat = _train_cifar(policy, amp_level)[0]
    assert np.isfinite(remat).all(), remat
    tight = amp_level is None or policy == "recompute_norms"
    np.testing.assert_allclose(remat, base, rtol=1e-5 if tight else 2e-2,
                               atol=0.0 if tight else 2e-3)
    assert remat[-1] < remat[0], remat


class _Count(TorchDispatchMode):
    def __init__(self, names):
        super().__init__()
        self.names = names
        self.counts = dict.fromkeys(names, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,convs,norms", [
    (None, 1, 1), ("nothing_saveable", 2, 2),
    ("save_conv_only", 1, 2), ("recompute_norms", 1, 2)])
def test_conv_net_policies_recompute_what_they_name(policy, convs, norms):
    """Counted over one step of the depth-8 cifar net (7 convs, 7
    batch_norms): save_conv_only runs each convolution once and
    recomputes each batch_norm's normalize (rsqrt) in the backward;
    recompute_norms recomputes the normalize and keeps the convolutions;
    nothing_saveable recomputes both."""
    _, main, feed, scope, loss = _train_cifar(policy, steps=1)
    count = _Count(("convolution", "rsqrt"))
    with count:
        EXE.run(main, feed=feed, fetch_list=[loss], scope=scope)
    n_conv = sum(op.type == "conv2d" for op in main.global_block().ops)
    n_bn = sum(op.type == "batch_norm" for op in main.global_block().ops)
    assert count.counts["convolution"] == convs * n_conv, count.counts
    assert count.counts["rsqrt"] == norms * n_bn, count.counts
