"""User-error paths of the torch port's Executor against the JAX package
on the CPU: every case of ``tests/test_error_paths.py`` runs the same
program and feed through both packages and holds the port's error to
the reference's — its type and the variable its message names.

Reference test → port case:

- ``test_missing_feed_names_the_variable`` → ``test_missing_feed_names_the_variable``
- ``test_run_main_before_startup_is_diagnosed`` → ``test_run_main_before_startup_is_diagnosed``
- ``test_unknown_fetch_name`` → ``test_unknown_fetch_name``
- ``test_bad_feed_shape_raises_before_device_work`` → ``test_bad_feed_shape_raises_before_device_work``
  (both raise TypeError since F24's repair, ROADMAP §3), and its
  ``matmul`` form, ``test_matmul_of_mismatched_widths_raises_type_error``
"""
import numpy as np
import pytest
import torch

from torch_serving_common import both, to_numpy

torch.set_num_threads(1)


def _net(fluid):
    """The reference's net, with an SGD update, in fresh programs."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        pred = fluid.layers.fc(input=x, size=3, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _error_of(p, feed, fetch=None, startup=True):
    """Run ``_net``'s main program on ``feed``; return (error type name,
    message, the parameters before and after)."""
    fluid = p.fluid
    main, start, loss = _net(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        if startup:
            exe.run(start)
        before = {n: to_numpy(scope.find_var(n)).copy() for n in scope.keys()}
        with pytest.raises(Exception) as e:
            exe.run(main, feed=feed, fetch_list=[fetch or loss])
        after = {n: to_numpy(scope.find_var(n)) for n in scope.keys()}
    return type(e.value).__name__, str(e.value), before, after


def _feed(x_cols=4, with_y=True):
    feed = {"x": np.zeros((2, x_cols), np.float32)}
    if with_y:
        feed["y"] = np.zeros((2, 1), np.int64)
    return feed


def test_missing_feed_names_the_variable():
    out = both(lambda p: _error_of(p, _feed(with_y=False))[:2])
    for kind, msg in out.values():
        assert kind == "KeyError" and "'y'" in msg
    assert out["port"] == out["jax"]


def test_run_main_before_startup_is_diagnosed():
    out = both(lambda p: _error_of(p, _feed(), startup=False)[:2])
    for kind, msg in out.values():
        assert kind in ("KeyError", "RuntimeError")
        # the message points at uninitialized state, not a deep trace
        assert "scope" in msg or "not " in msg
    assert out["port"] == out["jax"]


def test_unknown_fetch_name():
    out = both(lambda p: _error_of(p, _feed(),
                                   fetch="definitely_not_a_var")[:2])
    for kind, msg in out.values():
        assert kind == "KeyError" and "definitely_not_a_var" in msg
    assert out["port"] == out["jax"]


def test_bad_feed_shape_raises_before_device_work():
    """A feed of 7 columns where the program declares 4 raises at the
    first op whose shapes disagree, and no parameter is written. Both
    packages raise TypeError (the reference's jax while tracing, the
    port's mul and matmul rules before their product: F24 repaired), and
    both messages give the two sizes."""
    out = both(lambda p: _error_of(p, _feed(x_cols=7)))
    assert out["jax"][0] == out["port"][0] == "TypeError"
    for kind, msg, before, after in out.values():
        assert "7" in msg and "4" in msg
        assert sorted(after) == sorted(before)
        for n in before:
            np.testing.assert_array_equal(after[n], before[n])


def test_matmul_of_mismatched_widths_raises_type_error():
    """A ``matmul`` whose contracted sizes differ (a fed [2, 7] against a
    [4, 3] parameter) raises TypeError in both packages, naming both
    sizes, before its product runs."""
    def run(p):
        fluid = p.fluid
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            w = fluid.layers.create_parameter([4, 3], "float32", name="w")
            out = fluid.layers.matmul(x, w)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            with pytest.raises(Exception) as e:
                exe.run(main, feed=_feed(x_cols=7, with_y=False),
                        fetch_list=[out])
        return type(e.value).__name__, str(e.value)

    out = both(run)
    for kind, msg in out.values():
        assert kind == "TypeError" and "7" in msg and "4" in msg
