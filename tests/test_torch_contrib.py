"""The port's ``contrib.memory_usage_calc`` against the JAX package's:
tests/test_contrib.py's memory cases.

``memory_usage`` (a copy of the reference's shape walk) gives the
reference's (min, max, unit) on the same program, for every zoo entry
and at several batch sizes. ``compiled_memory_usage`` keeps the
reference's keys but measures one step instead of reading XLA's
analysis: on the host ``argument_bytes`` is exactly the state the step
reads plus the feeds, ``output_bytes`` the fetches plus the state it
writes, ``temp_bytes`` None (torch keeps no host allocator statistics)
and ``generated_code_bytes`` 0; the caller's scope is left untouched.
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import zoo as jzoo

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.contrib import compiled_memory_usage, memory_usage
from paddle_tpu_torch.models import zoo as tzoo

torch.set_num_threads(1)


def _softmax_program(fluid, width=784, train=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[width], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(x, size=10), y))
        if train:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_memory_usage_estimate():
    """tests/test_contrib.py::test_memory_usage_estimate on the port,
    equal to the reference's numbers."""
    main, _, _ = _softmax_program(tfluid)
    lo, hi, unit = memory_usage(main, batch_size=32)
    assert unit in ("B", "KB", "MB") and 0 < lo < hi
    assert (lo, hi, unit) == jfluid.contrib.memory_usage(
        _softmax_program(jfluid)[0], batch_size=32)
    with pytest.raises(TypeError):
        memory_usage("not a program", 32)
    with pytest.raises(ValueError):
        memory_usage(main, 0)


@pytest.mark.parametrize("name", tzoo.zoo_model_names())
def test_memory_usage_equals_the_reference_on_the_zoo(name):
    jp, tp = jzoo.build_zoo_program(name), tzoo.build_zoo_program(name)
    for batch in (1, 32, 128):
        try:
            want = jfluid.contrib.memory_usage(jp.main, batch)
        except ValueError as e:         # two -1 dims: the same refusal
            with pytest.raises(ValueError, match=re.escape(str(e))):
                memory_usage(tp.main, batch)
            continue
        assert memory_usage(tp.main, batch) == want


def _bytes(t):
    return t.numel() * t.element_size()


def test_compiled_memory_usage_on_the_host():
    """tests/test_contrib.py::test_compiled_memory_usage on the port:
    the reference's keys, the arguments and outputs counted exactly,
    and the caller's scope and executor left as they were."""
    main, startup, loss = _softmax_program(tfluid, width=64, train=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    before = {n: scope.find_var(n).clone() for n in scope.keys()}
    step = exe._step
    stats = compiled_memory_usage(
        main, {"x": ((8, 64), "float32"), "y": ((8, 1), "int64")},
        fetch_list=[loss], scope=scope, place=tfluid.CPUPlace())
    want = jfluid.contrib.compiled_memory_usage(
        _softmax_program(jfluid, width=64, train=True)[0],
        {"x": ((8, 64), "float32"), "y": ((8, 1), "int64")},
        fetch_list=["mean_0.tmp_0"])
    assert set(stats) == set(want)
    persist = [n for n, v in main.global_block().vars.items()
               if v.persistable]
    state = sum(_bytes(scope.find_var(n)) for n in persist)
    assert stats["argument_bytes"] == state + 8 * 64 * 4 + 8 * 1 * 8
    # SGD writes every parameter; the fetch is one float
    params = sum(_bytes(scope.find_var(p.name))
                 for p in main.all_parameters())
    assert stats["output_bytes"] == params + 4
    assert stats["temp_bytes"] is None
    assert stats["generated_code_bytes"] == 0
    assert exe._step == step
    for n, v in before.items():
        assert torch.equal(scope.find_var(n), v), n


def test_compiled_memory_usage_without_a_startup_run():
    """A persistable the scope lacks is made as zeros of its declared
    shape (the reference's abstract state from the var metadata)."""
    main, _, loss = _softmax_program(tfluid, width=16, train=True)
    stats = compiled_memory_usage(
        main, {"x": ((4, 16), "float32"), "y": ((4, 1), "int64")},
        fetch_list=[loss], scope=tfluid.Scope(), place=tfluid.CPUPlace())
    weights = 16 * 10 * 4 + 10 * 4 + 4          # w, b and the rate
    assert stats["argument_bytes"] == weights + 4 * 16 * 4 + 4 * 8
    assert stats["temp_bytes"] is None


def test_compiled_memory_usage_of_an_inference_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[32], dtype="float32")
        y = tfluid.layers.fc(x, size=5, act="softmax")
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    stats = compiled_memory_usage(main.clone(for_test=True),
                                  {"x": ((3, 32), "float32")}, mode="test",
                                  fetch_list=[y], scope=scope,
                                  place=tfluid.CPUPlace())
    assert stats["argument_bytes"] == (32 * 5 + 5) * 4 + 3 * 32 * 4
    assert stats["output_bytes"] == 3 * 5 * 4      # nothing written
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": np.zeros((3, 32), np.float32)}, fetch_list=[y],
        scope=scope)[0]
    assert out.shape == (3, 5)
