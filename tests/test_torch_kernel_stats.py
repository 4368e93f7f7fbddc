"""Executor.compiled_stats (F9): the reference's keys (less XLA's
generated code size), counted over one step exactly as ``run`` would
dispatch it — the non-HLO assertions of tests/test_kernel_stats.py and
tests/test_fuse_optimizer.py:94-98. On the host the kernels are the
dispatched aten ops."""
import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.transpiler import fuse_optimizer_ops


def _small_train(top_k=10, opt="adam"):
    main_p, startup_p = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main_p, startup_p):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, size=10), y))
        if opt == "adam":
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        else:
            fluid.optimizer.Momentum(learning_rate=0.01,
                                     momentum=0.9).minimize(loss)
    return main_p, startup_p, loss


def _feed():
    return {"x": np.zeros((4, 64), np.float32),
            "y": np.zeros((4, 1), np.int64)}


def _stats(top_k=10):
    main_p, startup_p, loss = _small_train()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup_p, scope=scope)
    return exe.compiled_stats(main_p, feed=_feed(), fetch_list=[loss],
                              scope=scope, top_k=top_k)


def test_histogram_attributes_every_kernel():
    st = _stats()
    assert st["n_kernels"] > 0 and st["kernel_source"] == "aten"
    # forward, both weight gradients, and the hidden layer's input
    # gradient (the data needs none)
    assert st["flops"] == 2 * 4 * (2 * (64 * 32 + 32 * 10) + 32 * 10)
    assert st["bytes_accessed"] > 0
    assert "generated_code_size_bytes" not in st
    hist = st["kernel_histogram"]
    assert sum(h["count"] for h in hist) == st["n_kernels"]
    kinds = {h["kind"] for h in hist}
    assert "mm" in kinds                       # the fc products
    mb = [h["mbytes"] for h in hist]
    assert mb == sorted(mb, reverse=True)


def test_top_kernels_shape_and_order():
    top = _stats(top_k=5)["top_kernels"]
    assert 0 < len(top) <= 5
    for k in top:
        assert set(k) == {"kind", "shape", "mbytes"}
        assert "[" in k["shape"]
    mb = [k["mbytes"] for k in top]
    assert mb == sorted(mb, reverse=True)


def test_top_k_zero_disables_attribution():
    st = _stats(top_k=0)
    assert st["n_kernels"] > 0
    assert "kernel_histogram" not in st and "top_kernels" not in st


def test_stats_leave_the_scope_as_it_was():
    """The step runs on a copy of the state: the scope does not move."""
    main_p, startup_p, loss = _small_train()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup_p, scope=scope)
    before = {k: to_numpy(v) for k, v in scope.vars.items()}
    exe.compiled_stats(main_p, feed=_feed(), fetch_list=[loss], scope=scope)
    for k, v in before.items():
        np.testing.assert_array_equal(v, to_numpy(scope.find_var(k)))


def test_fused_kernel_count_drops():
    """fuse_optimizer_ops' one flat update dispatches fewer kernels."""
    counts = []
    for fuse in (False, True):
        main_p, startup_p, loss = _small_train(opt="momentum")
        if fuse:
            fuse_optimizer_ops(main_p, startup_p)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup_p, scope=scope)
        counts.append(exe.compiled_stats(main_p, feed=_feed(),
                                         fetch_list=[loss],
                                         scope=scope)["n_kernels"])
    assert counts[1] < counts[0], counts
