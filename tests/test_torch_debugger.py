"""The port's program printers (``debugger.program_to_code``,
``pprint_program_codes``, ``pprint_block_codes``,
``draw_block_graphviz``, ``Program.to_string`` / ``str(program)``)
against the JAX package's: tests/test_debugger.py's printer cases, and
the same text and dot file from the same layer code on dense,
control-flow, sequence and AMP programs and on every zoo entry.

The text carries each variable's dtype string and each attribute's
repr; the port keeps the reference's dtype strings (``"int64"`` for an
int64 variable, though the port's ``canonical_int`` is int64 where the
reference's is int32: the program records the declared dtype), so no
difference is kept. The NaN guard's cases are in
tests/test_torch_training_stack.py.
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import zoo as jzoo

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import zoo as tzoo

torch.set_num_threads(1)

PACKAGES = {"jax": jfluid, "torch": tfluid}


def _build(fluid, body):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        body(fluid)
    return main


def _both(body):
    """(reference program, port program) built by ``body(fluid)``."""
    return _build(jfluid, body), _build(tfluid, body)


def _same_text(jmain, tmain):
    want = jfluid.debugger.program_to_code(jmain)
    got = tfluid.debugger.program_to_code(tmain)
    assert got == want
    assert str(tmain) == got == tmain.to_string()
    for bj, bt in zip(jmain.blocks, tmain.blocks):
        assert tfluid.debugger.draw_block_graphviz(bt, path=None) == \
            jfluid.debugger.draw_block_graphviz(bj, path=None)
    return got


def _simple(fluid):
    x = fluid.layers.data("x", shape=[4])
    h = fluid.layers.fc(x, size=3, act="relu")
    fluid.layers.mean(h)


def _while(fluid):
    i = fluid.layers.fill_constant([1], "float32", 0.0)
    limit = fluid.layers.fill_constant([1], "float32", 3.0)
    cond = fluid.layers.less_than(i, limit)
    w = fluid.layers.While(cond)
    with w.block():
        ni = fluid.layers.increment(i, value=1.0, in_place=False)
        fluid.layers.assign(ni, output=i)
        fluid.layers.less_than(i, limit, cond=cond)


def _if_else(fluid):
    x = fluid.layers.data("x", shape=[4], dtype="float32")
    zero = fluid.layers.fill_constant([1], "float32", 0.0)
    cond = fluid.layers.less_than(fluid.layers.reduce_sum(x), zero)
    ie = fluid.layers.IfElse(cond)
    with ie.true_block():
        ie.output(fluid.layers.scale(ie.input(x), scale=-1.0))
    with ie.false_block():
        ie.output(fluid.layers.scale(ie.input(x), scale=2.0))
    ie()


def _static_rnn(fluid):
    x = fluid.layers.data("x", shape=[5, 2, 4], dtype="float32",
                          append_batch_size=False)
    rnn = fluid.layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[-1, 4], batch_ref=xt)
        nh = fluid.layers.fc([xt, h], size=4, act="tanh")
        rnn.update_memory(h, nh)
        rnn.output(nh)
    fluid.layers.mean(rnn())


def _sequence(fluid):
    w = fluid.layers.data(name="w", shape=[1], dtype="int64", lod_level=1)
    emb = fluid.layers.embedding(w, size=[10, 4])
    proj = fluid.layers.fc(emb, size=8)
    h, _ = fluid.layers.dynamic_lstm(proj, size=8)
    fluid.layers.sequence_pool(h, "max")


def _amp_train(fluid):
    x = fluid.layers.data("x", shape=[8], dtype="float32")
    y = fluid.layers.data("y", shape=[1], dtype="int64")
    h = fluid.layers.fc(x, size=16, act="relu")
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        fluid.layers.fc(h, size=4), y))
    fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    fluid.transpiler.amp_transpile(fluid.default_main_program(),
                                   level="O2")


def test_program_to_string():
    """tests/test_debugger.py::test_program_to_string on the port."""
    jmain, tmain = _both(_simple)
    code = _same_text(jmain, tmain)
    assert "mul(" in code and "relu(" in code
    assert "param" in code          # parameters annotated
    assert str(tmain) == code
    tfluid.debugger.pprint_program_codes(tmain)


def test_to_string_includes_sub_blocks():
    code = _same_text(*_both(_while))
    assert "// block" in code and "while(" in code
    assert "increment(" in code     # sub-block ops rendered inline


def test_draw_block_graphviz(tmp_path):
    jmain, tmain = _both(_simple)
    path = str(tmp_path / "g.dot")
    dot = tfluid.debugger.draw_block_graphviz(tmain.global_block(),
                                              path=path)
    assert open(path).read() == dot
    assert dot == jfluid.debugger.draw_block_graphviz(
        jmain.global_block(), path=str(tmp_path / "ref.dot"))
    assert dot.startswith("digraph G {") and dot.rstrip().endswith("}")
    assert "shape=box" in dot and "shape=ellipse" in dot
    assert 'label="mul"' in dot
    assert "peripheries=2" in dot   # parameter nodes double-bordered
    declared = set(re.findall(r"^\s+(\w+) \[", dot, re.M))
    for a, b in re.findall(r"^\s+(\w+) -> (\w+);", dot, re.M):
        assert a in declared and b in declared
    hot = tfluid.debugger.draw_block_graphviz(
        tmain.global_block(), highlights=["fc_0.tmp_0"], path=None)
    assert hot == jfluid.debugger.draw_block_graphviz(
        jmain.global_block(), highlights=["fc_0.tmp_0"], path=None)
    assert "lightcoral" in hot


@pytest.mark.parametrize("body", [_while, _if_else, _static_rnn, _sequence,
                                  _amp_train],
                         ids=lambda f: f.__name__.strip("_"))
def test_control_flow_sequence_and_amp_text_equals_the_reference(body,
                                                                  capsys):
    jmain, tmain = _both(body)
    code = _same_text(jmain, tmain)
    if body is _sequence:
        assert "lod=1" in code
    if len(tmain.blocks) > 1:
        assert "<block 1>" in code
    printed = []
    for fluid, main in ((jfluid, jmain), (tfluid, tmain)):
        fluid.debugger.pprint_block_codes(main.global_block())
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] == code + "\n"


def test_pprint_prints_what_program_to_code_returns(capsys):
    jmain, tmain = _both(_if_else)
    tfluid.debugger.pprint_program_codes(tmain)
    got = capsys.readouterr().out
    jfluid.debugger.pprint_program_codes(jmain)
    assert got == capsys.readouterr().out
    assert got == tfluid.debugger.program_to_code(tmain) + "\n"
    tfluid.debugger.pprint_block_codes(tmain.blocks[1])
    got = capsys.readouterr().out
    jfluid.debugger.pprint_block_codes(jmain.blocks[1])
    assert got == capsys.readouterr().out


@pytest.mark.parametrize("name", tzoo.zoo_model_names())
def test_zoo_text_and_dot_equal_the_reference(name):
    """Every zoo entry (dense, conv, sequence, control-flow, detection
    models) prints the reference's text and dot file."""
    jp, tp = jzoo.build_zoo_program(name), tzoo.build_zoo_program(name)
    code = _same_text(jp.main, tp.main)
    assert np.all([op.type + "(" in code
                   for op in tp.main.global_block().ops])
