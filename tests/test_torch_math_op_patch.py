"""Variable operator sugar in the torch port (layers/math_op_patch.py),
the cases of tests/test_math_op_patch.py: each program is built in both
packages with the same code, must hold the same ops, and its fetches
must equal numpy's answer and the JAX package's (float32 elementwise
math in the same order: rtol 1e-6; compares and booleans exactly)."""
import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights

torch.set_num_threads(1)


def _both(build, feed, train_steps=0):
    """Build ``build(fluid) -> fetch vars`` in both packages, check the
    op lists agree, run the startup in the reference, carry the scope,
    and return (port fetches, reference fetches)."""
    progs = {}
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            outs = build(fluid)
        progs[fluid] = main, startup, outs
    (jm, js, jo), (tm, _, to) = progs[jfluid], progs[tfluid]
    assert [o.type for o in jm.global_block().ops] == \
        [o.type for o in tm.global_block().ops]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope = weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, torch.device("cpu"))
    texe = tfluid.Executor(tfluid.CPUPlace())
    return (texe.run(tm, feed=feed, fetch_list=to, scope=tscope),
            jexe.run(jm, feed=feed, fetch_list=jo, scope=jscope))


def test_arithmetic_operators():
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.data(name="y", shape=[3], dtype="float32")
        return [x + y, x - y, x * y, x / y, x + 2.0, 3.0 - x, 2 * x,
                x / 2.0, -x, x ** 2.0]
    xs = np.array([[1., 2., 4.]], np.float32)
    ys = np.array([[2., 4., 8.]], np.float32)
    got, ref = _both(build, {"x": xs, "y": ys})
    want = [xs + ys, xs - ys, xs * ys, xs / ys, xs + 2, 3 - xs, 2 * xs,
            xs / 2, -xs, xs ** 2]
    for g, r, w in zip(got, ref, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
        np.testing.assert_allclose(g, r, rtol=1e-6)


def test_compare_operators():
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.data(name="y", shape=[3], dtype="float32")
        return [x < y, x <= y, x > y, x >= y, x == y, x != y, x > 2.0]
    xs = np.array([[1., 3., 3.]], np.float32)
    ys = np.array([[2., 3., 1.]], np.float32)
    got, ref = _both(build, {"x": xs, "y": ys})
    want = [xs < ys, xs <= ys, xs > ys, xs >= ys, xs == ys, xs != ys,
            xs > 2]
    for g, r, w in zip(got, ref, want):
        assert g.dtype == np.bool_
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)


def test_eq_fallback_and_hash_preserved():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
    # comparisons with non-variables fall back to identity semantics
    assert (x == "something") is False
    assert (x == None) is False            # noqa: E711
    assert x != "something"
    d = {x: 1}                             # hashable (identity hash)
    assert d[x] == 1
    assert isinstance(x == x, tfluid.Variable)   # a Variable builds an op


def test_operators_train_through():
    """A loss written with the sugar trains, step for step as the
    reference (losses rtol 1e-5)."""
    main, startup = {}, {}
    for fluid in (jfluid, tfluid):
        m, s = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(m, s):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            h = fluid.layers.fc(input=x, size=1)
            # mean((h - y)^2) * 0.5
            loss = fluid.layers.mean((h - y) * (h - y)) * 0.5
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        main[fluid], startup[fluid] = (m, loss), s
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(startup[jfluid], scope=jscope)
    tscope = weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, torch.device("cpu"))
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    w = rng.randn(4, 1).astype(np.float32)
    losses = []
    for _ in range(25):
        xs = rng.randn(16, 4).astype(np.float32)
        feed = {"x": xs, "y": xs @ w}
        m, loss = main[tfluid]
        got = texe.run(m, feed=feed, fetch_list=[loss], scope=tscope)[0]
        m, loss = main[jfluid]
        want = jexe.run(m, feed=feed, fetch_list=[loss], scope=jscope)[0]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        losses.append(float(got.reshape(())))
    assert losses[-1] < 0.2 * losses[0], losses


def test_reversed_scalar_op_keeps_tensor_shape():
    shapes = []

    def build(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = 2.0 / x
        shapes.append(tuple(y.shape) == tuple(x.shape))
        # shape-driven consumers see the tensor shape, not the scalar's
        return [y, fluid.layers.fc(input=1.0 / x, size=3)]
    xs = np.array([[1., 2., 4., 8.]], np.float32)
    got, ref = _both(build, {"x": xs})
    assert shapes == [True, True]
    np.testing.assert_allclose(got[0], 2.0 / xs, rtol=1e-6)
    assert got[1].shape == (1, 3)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-6)
