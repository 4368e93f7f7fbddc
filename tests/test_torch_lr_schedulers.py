"""The learning-rate schedulers (layers/learning_rate_scheduler.py)
through the torch port's Executor, against the JAX package.

Each schedule feeds SGD on a small fc regression; both packages build
the program with the same layer code and start from the same state. The
schedule's rate and the loss are fetched for 12 steps: the rate at
rtol 1e-6 (the same float32 elementwise ops on the same counter), the
loss at rtol 1e-5; the ``@LR_DECAY_COUNTER@`` counter compares by value
(int64 in the port, int32 in the reference without x64).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights

torch.set_num_threads(1)

COUNTER = "@LR_DECAY_COUNTER@"
STEPS = 12

SCHEDULES = {
    "exponential": ("exponential_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5)),
    "exponential-staircase": ("exponential_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5, staircase=True)),
    "natural_exp": ("natural_exp_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5)),
    "natural_exp-staircase": ("natural_exp_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5, staircase=True)),
    "inverse_time": ("inverse_time_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5)),
    "inverse_time-staircase": ("inverse_time_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5, staircase=True)),
    "polynomial": ("polynomial_decay", dict(
        learning_rate=0.1, decay_steps=5, end_learning_rate=0.001,
        power=2.0)),
    "polynomial-cycle": ("polynomial_decay", dict(
        learning_rate=0.1, decay_steps=5, end_learning_rate=0.001,
        power=2.0, cycle=True)),
    "piecewise": ("piecewise_decay", dict(boundaries=[3, 7],
                                          values=[0.1, 0.05, 0.01])),
    "noam": ("noam_decay", dict(d_model=64, warmup_steps=4)),
}


def _build(fluid, schedule, lars=False):
    fn, kw = SCHEDULES[schedule]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, size=1), y))
        lr = getattr(fluid.layers, fn)(**kw)
        _, params_grads = fluid.optimizer.SGD(lr).minimize(loss)
        extra = fluid.layers.append_LARS(params_grads, lr, 0.01) \
            if lars else []
    return main, startup, loss, lr, extra


def _feed(step):
    r = np.random.RandomState(40 + step)
    x = r.randn(16, 8).astype(np.float32)
    return {"x": x, "y": x[:, :1] * 2.0 - x[:, 1:2] + 0.5}


def _pair(schedule, lars=False):
    jp = _build(jfluid, schedule, lars)
    tp = _build(tfluid, schedule, lars)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jp[1], scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    tscope = weights.load_state(tfluid.Scope(), arrays, torch.device("cpu"))
    return jp, tp, jscope, tscope


def _counter(scope):
    return int(np.asarray(scope.find_var(COUNTER)).reshape(()))


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_matches_reference_for_12_steps(schedule):
    (jm, _, jl, jlr, _), (tm, _, tl, tlr, _), jscope, tscope = \
        _pair(schedule)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    rates = []
    for step in range(STEPS):
        w = jexe.run(jm, feed=_feed(step), fetch_list=[jl, jlr],
                     scope=jscope)
        g = texe.run(tm, feed=_feed(step), fetch_list=[tl, tlr],
                     scope=tscope)
        np.testing.assert_allclose(g[1], w[1], rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(g[0], w[0], rtol=1e-5, err_msg=str(step))
        assert _counter(tscope) == _counter(jscope) == step
        rates.append(float(np.asarray(g[1]).reshape(())))
    # the schedule moved (piecewise and the staircases step, the rest slide)
    assert len(set(rates)) > 2, rates


def test_noam_is_its_closed_form():
    """lr = d^-0.5 * min(s^-0.5, s * warmup^-1.5), s = max(counter, 1)."""
    _, (tm, _, _, tlr, _), _, tscope = _pair("noam")
    exe = tfluid.Executor(tfluid.CPUPlace())
    for c in range(STEPS):
        got = exe.run(tm, feed=_feed(c), fetch_list=[tlr], scope=tscope)[0]
        s = max(c, 1)
        want = 64 ** -0.5 * min(s ** -0.5, s * 4 ** -1.5)
        np.testing.assert_allclose(got, [want], rtol=1e-6)


def test_append_lars_matches_reference():
    (jm, _, jl, _, jx), (tm, _, tl, _, tx), jscope, tscope = \
        _pair("exponential", lars=True)
    assert len(tx) == len(jx) == 2           # fc weight and bias
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for step in range(3):
        w = jexe.run(jm, feed=_feed(step), fetch_list=[jl] + jx,
                     scope=jscope)
        g = texe.run(tm, feed=_feed(step), fetch_list=[tl] + tx,
                     scope=tscope)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["noam", "piecewise"])
def test_counter_counts_once_a_step_under_repeats(schedule):
    """run(repeats=k) advances the counter by k, once a step, and its
    fetches are those of the k-th of k separate runs."""
    (jm, _, jl, jlr, _), (tm, _, tl, tlr, _), jscope, tscope = \
        _pair(schedule)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    feed = _feed(0)
    for _ in range(5):
        want = jexe.run(jm, feed=feed, fetch_list=[jl, jlr], scope=jscope)
    got = texe.run(tm, feed=feed, fetch_list=[tl, tlr], scope=tscope,
                   repeats=5)
    assert _counter(tscope) == _counter(jscope) == 4
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    got = texe.run(tm, feed=feed, fetch_list=[tlr], scope=tscope,
                   repeats=3)
    assert _counter(tscope) == 7
