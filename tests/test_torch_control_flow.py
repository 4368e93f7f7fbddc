"""Control flow and ``scan`` in the torch port (``ops/control_flow.py``,
``ops/rnn.py``'s ``scan``, ``layers/control_flow.py``) against the JAX
package, whose sub-blocks lower to ``lax.while_loop``, ``lax.cond`` and
``lax.scan``.

The cases are the reference's own: all of tests/test_control_flow.py,
tests/test_sequence.py's ``test_static_rnn_matches_manual_scan`` and
``test_while_loop``, and tests/test_review_fixes.py's
``test_switch_default_only`` and
``test_save_inference_model_subblock_params``. Each program is built in
both packages, started from the reference's startup state and compared
whole (torch_seq_common.py: forwards rtol 2e-4 / atol 2e-5, gradients
rtol 2e-3 / atol 2e-4, integers exactly), and each case also checks the
reference test's own expected value. Beside them: a DynamicRNN whose
step reads outer sequences through ``sequence_expand`` and
``sequence_softmax``, its gradients; the bounded While's NaN hazard; the
wording of the refusal (F15); the AOT export of ``scan``, ``while`` and
``if_else`` programs and the forms it refuses naming F14; and control
flow under a one-rank mesh.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import backward as pt_backward
from torch_seq_common import (FWD, assert_same, build_both, make_feed,
                              port_scope, program_pair, reference_state,
                              seqs)

torch.set_num_threads(1)


def _value(out):
    return float(np.asarray(out).reshape(()))


def _sum_to_ten(f, max_iters=None):
    i = f.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    total = f.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    limit = f.layers.fill_constant(shape=[1], dtype="float32", value=5.0)
    cond = f.layers.less_than(i, limit)
    w = f.layers.While(cond, max_iters=max_iters)
    with w.block():
        ni = f.layers.elementwise_add(
            i, f.layers.fill_constant([1], "float32", 1.0))
        nt = f.layers.elementwise_add(total, ni)
        f.layers.assign(ni, output=i)
        f.layers.assign(nt, output=total)
        f.layers.less_than(i, limit, cond=cond)
    return [total, i, cond]


# ---------------------------------------------------------------------------
# tests/test_control_flow.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_iters", [None, 7])
def test_while_loop_sums_to_ten(max_iters):
    """test_while_loop_sums_to_ten and
    test_while_max_iters_matches_unbounded_forward: 1+2+3+4+5, the
    counter and the final (false) condition, unbounded and bounded."""
    _, got = program_pair(lambda f: _sum_to_ten(f, max_iters), {})
    assert abs(_value(got[0]) - 15.0) < 1e-5
    assert _value(got[1]) == 5.0 and not bool(np.asarray(got[2]).any())


@pytest.mark.parametrize("flag,want", [(1.0, 5.0), (-1.0, -10.0)])
def test_ifelse_both_branches(flag, want):
    def build(f):
        x = f.layers.data("x", shape=[1], append_batch_size=False)
        zero = f.layers.fill_constant([1], "float32", 0.0)
        ie = f.layers.IfElse(f.layers.greater_than(x, zero))
        with ie.true_block():
            ie.output(f.layers.scale(x, scale=5.0))
        with ie.false_block():
            ie.output(f.layers.scale(x, scale=10.0))
        return [ie()[0]]
    _, got = program_pair(build, {"x": np.asarray([flag], np.float32)})
    assert abs(_value(got[0]) - want) < 1e-5


@pytest.mark.parametrize("step_val,want", [(0.0, 1.0), (5.0, 0.1),
                                           (15.0, 0.01)])
def test_switch_lr_schedule(step_val, want):
    def build(f):
        step = f.layers.fill_constant([1], "float32", step_val)
        lr = f.layers.fill_constant([1], "float32", 0.0)
        b1 = f.layers.fill_constant([1], "float32", 5.0)
        b2 = f.layers.fill_constant([1], "float32", 15.0)
        with f.layers.Switch().block() as sw:
            with sw.case(f.layers.less_than(step, b1)):
                f.layers.assign(f.layers.fill_constant([1], "float32", 1.0),
                                output=lr)
            with sw.case(f.layers.less_than(step, b2)):
                f.layers.assign(f.layers.fill_constant([1], "float32", 0.1),
                                output=lr)
            with sw.default():
                f.layers.assign(
                    f.layers.fill_constant([1], "float32", 0.01), output=lr)
        return [lr]
    _, got = program_pair(build, {})
    assert abs(_value(got[0]) - want) < 1e-6


def test_tensor_array_write_read_length():
    def build(f):
        x = f.layers.data("x", shape=[3], append_batch_size=False)
        i0 = f.layers.fill_constant([1], "int64", 0)
        i1 = f.layers.fill_constant([1], "int64", 1)
        arr = f.layers.array_write(x, i0)
        f.layers.array_write(f.layers.scale(x, scale=2.0), i1, array=arr)
        return [f.layers.array_read(arr, i1), f.layers.array_length(arr),
                f.layers.array_read(arr, i0)]
    xv = np.asarray([1.0, 2.0, 3.0], np.float32)
    _, got = program_pair(build, {"x": xv})
    np.testing.assert_allclose(got[0], 2 * xv)
    assert int(np.asarray(got[1]).reshape(())) == 2
    np.testing.assert_allclose(got[2], xv)


@pytest.mark.parametrize("rows,want", [(0, True), (3, False)])
def test_is_empty_and_print(rows, want, capfd):
    def build(f):
        x = f.layers.data("x", shape=[-1, 2], append_batch_size=False)
        f.layers.Print(x, message="optest")
        return [f.layers.is_empty(x)]
    _, got = program_pair(build, {"x": np.ones((rows, 2), np.float32)})
    assert bool(np.asarray(got[0]).reshape(())) is want


def test_print_prints_message_and_value(capfd):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[-1, 2], append_batch_size=False)
        p = tfluid.layers.Print(x, message="optest")
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": np.full((1, 2), 7.0, np.float32)}, fetch_list=[p],
        scope=tfluid.Scope())
    np.testing.assert_array_equal(out[0], np.full((1, 2), 7.0, np.float32))
    printed = capfd.readouterr().out
    assert "optest" in printed and "7." in printed


@pytest.mark.parametrize("mask", [0, 1])
def test_select_input(mask):
    def build(f):
        a = f.layers.data("a", shape=[2], append_batch_size=False)
        b = f.layers.data("b", shape=[2], append_batch_size=False)
        m = f.layers.data("m", shape=[1], dtype="int32",
                          append_batch_size=False)
        gb = f.default_main_program().global_block()
        out = gb.create_var(name="sel_out", dtype="float32", shape=[2])
        gb.append_op(type="select_input",
                     inputs={"X": [a.name, b.name], "Mask": [m.name]},
                     outputs={"Out": [out.name]})
        return [out]
    av = np.asarray([1.0, 2.0], np.float32)
    bv = np.asarray([3.0, 4.0], np.float32)
    _, got = program_pair(build, {"a": av, "b": bv,
                                  "m": np.asarray([mask], np.int32)})
    np.testing.assert_allclose(got[0], (av, bv)[mask])


def _cumsum_rnn(f, batch_dim):
    x = f.layers.data("x", shape=[batch_dim, 4, 3],
                      append_batch_size=False)
    rnn = f.layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[batch_dim, 3], batch_ref=x, init_value=0.0)
        nh = f.layers.elementwise_add(h, xt)
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    return [rnn()]


@pytest.mark.parametrize("batch_dim", [2, -1])
def test_static_rnn_cumulative_sum(batch_dim):
    """test_control_flow.py's test_static_rnn_cumulative_sum (batch 2)
    and test_sequence.py's test_static_rnn_matches_manual_scan (batch
    -1): the step outputs stack on the time axis."""
    xv = np.random.RandomState(0).randn(2, 4, 3).astype(np.float32)
    _, got = program_pair(lambda f: _cumsum_rnn(f, batch_dim), {"x": xv})
    np.testing.assert_allclose(got[0], np.cumsum(xv, axis=1), rtol=1e-5,
                               atol=1e-6)


def _loop_with_param(f, max_iters, name):
    w_param = f.layers.create_parameter(
        [1], "float32", attr=f.ParamAttr(name=name),
        default_initializer=f.initializer.Constant(2.0))
    i = f.layers.fill_constant([1], "float32", 0.0)
    acc = f.layers.fill_constant([1], "float32", 0.0)
    acc.stop_gradient = False
    limit = f.layers.fill_constant([1], "float32", 3.0)
    cond = f.layers.less_than(i, limit)
    w = f.layers.While(cond, max_iters=max_iters)
    with w.block():
        ni = f.layers.elementwise_add(
            i, f.layers.fill_constant([1], "float32", 1.0))
        na = f.layers.elementwise_add(
            acc, f.layers.elementwise_mul(w_param, ni))
        f.layers.assign(ni, output=i)
        f.layers.assign(na, output=acc)
        f.layers.less_than(i, limit, cond=cond)
    return f.layers.reduce_sum(acc)


def test_while_without_max_iters_fails_loudly_under_backward():
    """Both packages refuse an unbounded While on the loss path at
    append_backward, naming max_iters; the port's message speaks of its
    own loop (F15)."""
    for f in (jfluid, tfluid):
        main, startup = f.Program(), f.Program()
        with f.unique_name.guard(), f.program_guard(main, startup):
            loss = _loop_with_param(f, None, "ww")
            with pytest.raises(RuntimeError, match="max_iters"):
                f.append_backward(loss, parameter_list=["ww"])


def test_while_refusal_speaks_of_the_port_f15():
    msg = pt_backward._WHILE_ERR
    assert "max_iters" in msg and "host loop" in msg
    assert "autograd cannot replay" in msg and "differentiable" in msg
    for word in ("lax", "jax", "scan", "XLA"):
        assert word not in msg, word


def test_while_with_max_iters_is_differentiable():
    """loss = sum_i w*i for i=1..3 with w = 2 => 12, dloss/dw = 6; the
    masked iterations past the exit add nothing, in both packages."""
    _, got = program_pair(lambda f: [_loop_with_param(f, 8, "ww2")], {},
                          grads=True)
    assert abs(_value(got[0]) - 12.0) < 1e-5
    assert abs(_value(got[1]) - 6.0) < 1e-5


def test_bounded_while_dead_branch_nan_hazard_matches():
    """The documented hazard (layers.While): the body runs on the frozen
    carry after the exit, 1/(n - i) divides by zero there, and the
    masking where's gradient carries the NaN back — in both packages,
    forward right and gradient NaN alike."""
    def build(f):
        w_param = f.layers.create_parameter(
            [1], "float32", attr=f.ParamAttr(name="wn"),
            default_initializer=f.initializer.Constant(1.5))
        i = f.layers.fill_constant([1], "float32", 0.0)
        acc = f.layers.fill_constant([1], "float32", 0.0)
        acc.stop_gradient = False
        n = f.layers.fill_constant([1], "float32", 2.0)
        one = f.layers.fill_constant([1], "float32", 1.0)
        cond = f.layers.less_than(i, n)
        w = f.layers.While(cond, max_iters=4)
        with w.block():
            ni = f.layers.elementwise_add(i, one)
            inv = f.layers.elementwise_div(one,
                                           f.layers.elementwise_sub(n, i))
            na = f.layers.elementwise_add(
                acc, f.layers.elementwise_mul(w_param, inv))
            f.layers.assign(ni, output=i)
            f.layers.assign(na, output=acc)
            f.layers.less_than(i, n, cond=cond)
        return [f.layers.reduce_sum(acc)]
    progs = build_both(build, grads=True)
    jm, js, names, _ = progs["jax"]
    jscope, state = reference_state(js)
    fetch = names + ["wn@GRAD"]
    want = jfluid.Executor(jfluid.CPUPlace()).run(jm, fetch_list=fetch,
                                                  scope=jscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        progs["port"][0], fetch_list=fetch, scope=port_scope(state))
    # 1.5 * (1/2 + 1/1)
    assert abs(_value(got[0]) - 2.25) < 1e-6
    assert_same(got[0], want[0], FWD)
    assert np.isnan(_value(want[1])) and np.isnan(_value(got[1]))


def test_off_loss_path_while_does_not_block_backward():
    """An unbounded While whose outputs never reach the loss (a decode
    loop fetched for logging) does not trip append_backward."""
    def build(f):
        w_param = f.layers.create_parameter(
            [1], "float32", attr=f.ParamAttr(name="wp"))
        x = f.layers.data("x", shape=[1], append_batch_size=False)
        loss = f.layers.reduce_sum(f.layers.elementwise_mul(w_param, x))
        i = f.layers.fill_constant([1], "float32", 0.0)
        lim = f.layers.fill_constant([1], "float32", 2.0)
        cond = f.layers.less_than(i, lim)
        w = f.layers.While(cond)
        with w.block():
            ni = f.layers.elementwise_add(
                i, f.layers.fill_constant([1], "float32", 1.0))
            f.layers.assign(ni, output=i)
            f.layers.less_than(i, lim, cond=cond)
        return [loss, i]
    _, got = program_pair(build, {"x": np.ones(1, np.float32)}, grads=True)
    assert _value(got[1]) == 2.0
    assert abs(_value(got[2]) - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# tests/test_sequence.py, tests/test_review_fixes.py
# ---------------------------------------------------------------------------
def test_while_loop_with_increment():
    """test_sequence.py's test_while_loop: increment in place and an
    accumulator, i = 5 and acc = 15."""
    def build(f):
        i = f.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        limit = f.layers.fill_constant(shape=[1], dtype="float32",
                                       value=5.0)
        acc = f.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        i.stop_gradient = True
        acc.stop_gradient = True
        cond = f.layers.less_than(i, limit)
        w = f.layers.While(cond)
        with w.block():
            f.layers.increment(i, value=1.0)
            f.layers.assign(f.layers.elementwise_add(acc, i), acc)
            f.layers.less_than(i, limit, cond=cond)
        return [i, acc]
    _, got = program_pair(build, {})
    assert _value(got[0]) == 5.0 and _value(got[1]) == 15.0


def test_switch_default_only():
    """A Switch with only a default runs it unconditionally, writing a
    persistable the scope keeps."""
    for f in (jfluid, tfluid):
        main, startup = f.Program(), f.Program()
        with f.unique_name.guard(), f.program_guard(main, startup):
            lr = f.layers.create_global_var(
                shape=[1], value=0.0, dtype="float32", persistable=True,
                name="sw_lr")
            two = f.layers.fill_constant(shape=[1], dtype="float32",
                                         value=2.0)
            sw = f.layers.Switch()
            with sw.block():
                with sw.default():
                    f.layers.assign(two, lr)
        scope = f.Scope()
        exe = f.Executor(f.CPUPlace())
        exe.run(startup, scope=scope)
        exe.run(main, fetch_list=[], scope=scope)
        assert _value(np.asarray(scope.find_var("sw_lr"))) == 2.0
        assert not any(op.type == "if_else"
                       for op in main.global_block().ops)


# ---------------------------------------------------------------------------
# scan: DynamicRNN over sequences, gradients
# ---------------------------------------------------------------------------
T, D = 5, 4
LENS = [3, 5, 1]


def _seq_rows(seed, width):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, width).astype(np.float32) for n in LENS]


def _attention_rnn(f):
    """A DynamicRNN whose step reads the outer sequences through
    sequence_expand and sequence_softmax (machine_translation.py's
    attention) and updates a memory booted from an outer dense value."""
    src = f.layers.data("src", shape=[D], dtype="float32", lod_level=1)
    trg = f.layers.data("trg", shape=[D], dtype="float32", lod_level=1)
    boot = f.layers.fc(f.layers.sequence_last_step(src), size=D,
                       act="tanh")
    proj = f.layers.fc(src, size=D, bias_attr=False)
    proj.lod_level = 1
    rnn = f.layers.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(trg)
        mem = rnn.memory(init=boot)
        expand = f.layers.sequence_expand(
            x=f.layers.fc(mem, size=D, bias_attr=False), y=proj)
        mixed = f.layers.elementwise_add(proj, expand)
        mixed.lod_level = 1
        score = f.layers.fc(f.layers.tanh(mixed), size=1, bias_attr=False)
        score.lod_level = 1
        weights = f.layers.sequence_softmax(score)
        scaled = f.layers.elementwise_mul(src, weights)
        scaled.lod_level = 1
        context = f.layers.sequence_pool(scaled, "sum")
        h = f.layers.fc(f.layers.concat([context, word, mem], axis=1),
                        size=D, act="tanh")
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    out = rnn()
    loss = f.layers.mean(f.layers.sequence_pool(out, "sum"))
    return [loss, out]


def test_dynamic_rnn_with_outer_sequences_and_gradients():
    """The scan's masked state update (m·new + (1 − m)·old), its
    collected outputs rewrapped with the step input's lengths, the
    body's sequence ops on the outer SequenceBatch values, and every
    parameter's gradient, against the reference's lax.scan."""
    feed = {"src": seqs(_seq_rows(0, D), bucket=4),
            "trg": seqs([r[:max(1, n - 1)] for r, n in
                         zip(_seq_rows(1, D), LENS)], bucket=4)}
    _, got = program_pair(_attention_rnn, feed, grads=True)
    assert isinstance(got[1], tfluid.SequenceBatch)


def test_static_rnn_over_a_sequence_input_is_unmasked():
    """StaticRNN (masked=False) over a sequence input runs every padded
    step; its outputs keep the input's lengths."""
    def build(f):
        x = f.layers.data("x", shape=[D], dtype="float32", lod_level=1)
        rnn = f.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[-1, D], batch_ref=x)
            nh = f.layers.fc(f.layers.concat([xt, h], axis=1), size=D,
                             act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        return [rnn()]
    program_pair(build, {"x": seqs(_seq_rows(2, D), bucket=8)}, grads=False)


# ---------------------------------------------------------------------------
# save/load and the AOT export of control-flow programs (F14)
# ---------------------------------------------------------------------------
def _gru_program(f):
    x = f.layers.data(name="x", shape=[6], dtype="float32", lod_level=1)
    h = f.layers.dynamic_gru(f.layers.fc(x, size=9, num_flatten_dims=1),
                             size=3)
    return [f.layers.sequence_last_step(h)]


def _subblock_program(f):
    """A parameter read only inside the scan's sub-block."""
    x = f.layers.data(name="x", shape=[6], dtype="float32", lod_level=1)
    rnn = f.layers.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(x)
        mem = rnn.memory(shape=[-1, 3], batch_ref=x)
        h = f.layers.fc(f.layers.concat([xt, mem], axis=1), size=3,
                        act="tanh", param_attr="inner_w")
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    return [f.layers.sequence_last_step(rnn())]


def _save(f, d, build, **kw):
    main, startup = f.Program(), f.Program()
    with f.unique_name.guard(), f.program_guard(main, startup):
        out = build(f)
    scope = f.Scope()
    exe = f.Executor(f.CPUPlace())
    exe.run(startup, scope=scope)
    with f.scope_guard(scope):
        f.io.save_inference_model(d, ["x"], out, exe, main_program=main,
                                  **kw)
    return main, scope


@pytest.mark.parametrize("build,param", [(_gru_program, "gru"),
                                         (_subblock_program, "inner_w")])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_inference_model_subblock_params(tmp_path, build, param,
                                              writer):
    """Persistables read only inside a sub-block are saved, and the
    directory serves in the other package equal to the writer's own
    executor (files crossing both ways)."""
    wf, rf = (jfluid, tfluid) if writer == "jax" else (tfluid, jfluid)
    d = str(tmp_path / "inf")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main, scope = _save(wf, d, build)
    saved = np.load(os.path.join(d, "params.npz"))
    assert [k for k in saved.files if param in k], list(saved.files)
    feed_rows = _seq_rows(3, 6)
    want = wf.Executor(wf.CPUPlace()).run(
        main, feed={"x": wf.to_sequence_batch(feed_rows)},
        fetch_list=[main.global_block().ops[-1].output("Out")[0]],
        scope=scope, mode="test")[0]
    prog, feeds, fetches = rf.io.load_inference_model(
        d, rf.Executor(rf.CPUPlace()))
    got = rf.Executor(rf.CPUPlace()).run(
        prog, feed={"x": rf.to_sequence_batch(feed_rows)},
        fetch_list=fetches)[0]
    assert_same(got, want, FWD)


def test_aot_scan_program_exports_at_its_fixed_length(tmp_path):
    """A DynamicRNN program saved with serving buckets that declare a
    padded length exports with that length a symbol (F14 closed): the
    artifact serves the declared length and another, equal to the
    executor, and its meta fixes none. An artifact whose meta holds
    ``fixed_seq_len``, as earlier exports of a recurrent program wrote
    it, still serves that length and refuses another by name."""
    from paddle_tpu_torch.io import load_compiled_predictor
    d = str(tmp_path / "scan")
    main, scope = _save(tfluid, d, _subblock_program,
                        serving_buckets=tfluid.serving.BucketSpec(
                            batch_sizes=(1, 4), seq_lens={"x": (8,)}))
    meta_path = os.path.join(d, "__compiled_meta__.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert "fixed_seq_len" not in meta["feed_specs"][0]
    pred = load_compiled_predictor(d, device="cpu")
    fetch = [main.global_block().ops[-1].output("Out")[0]]
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed8 = {"x": tfluid.to_sequence_batch(_seq_rows(4, 6), bucket=8)}
    feed4 = {"x": tfluid.to_sequence_batch(
        [r[:2] for r in _seq_rows(4, 6)], bucket=4)}
    for feed in (feed8, feed4):
        want = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       mode="test")[0]
        np.testing.assert_allclose(pred.run(feed)[0], want, **FWD)
    # the meta an earlier export wrote for this program
    meta["feed_specs"][0]["fixed_seq_len"] = [8]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    old = load_compiled_predictor(d, device="cpu")
    np.testing.assert_allclose(old.run(feed8)[0], pred.run(feed8)[0],
                               **FWD)
    with pytest.raises(ValueError, match="F14"):
        old.run(feed4)


def _loop_program(f, max_iters):
    x = f.layers.data("x", shape=[1], append_batch_size=False)
    acc = f.layers.scale(x, scale=1.0)
    i = f.layers.fill_constant([1], "float32", 0.0)
    limit = f.layers.fill_constant([1], "float32", 3.0)
    cond = f.layers.less_than(i, limit)
    w = f.layers.While(cond, max_iters=max_iters)
    with w.block():
        f.layers.assign(f.layers.elementwise_add(
            i, f.layers.fill_constant([1], "float32", 1.0)), output=i)
        f.layers.assign(f.layers.elementwise_mul(acc, i), output=acc)
        f.layers.less_than(i, limit, cond=cond)
    return [f.layers.scale(acc, scale=1.0)]


def _ifelse_program(f):
    x = f.layers.data("x", shape=[1], append_batch_size=False)
    ie = f.layers.IfElse(f.layers.greater_than(
        x, f.layers.fill_constant([1], "float32", 0.0)))
    with ie.true_block():
        ie.output(f.layers.scale(x, scale=5.0))
    with ie.false_block():
        ie.output(f.layers.scale(x, scale=10.0))
    return [ie()[0]]


def _growing_carry_program(f):
    """An unbounded While whose carry grows a row each turn."""
    x = f.layers.data("x", shape=[1], append_batch_size=False)
    acc = f.layers.scale(x, scale=1.0)
    i = f.layers.fill_constant([1], "float32", 0.0)
    limit = f.layers.fill_constant([1], "float32", 3.0)
    cond = f.layers.less_than(i, limit)
    w = f.layers.While(cond)
    with w.block():
        f.layers.assign(f.layers.elementwise_add(
            i, f.layers.fill_constant([1], "float32", 1.0)), output=i)
        f.layers.assign(f.layers.concat([acc, x], axis=0), output=acc)
        f.layers.less_than(i, limit, cond=cond)
    return [f.layers.reduce_sum(acc)]


def _differing_branches_program(f):
    """An IfElse whose branches return [1] and [1, 1]."""
    x = f.layers.data("x", shape=[1], append_batch_size=False)
    ie = f.layers.IfElse(f.layers.greater_than(
        x, f.layers.fill_constant([1], "float32", 0.0)))
    with ie.true_block():
        ie.output(f.layers.scale(x, scale=5.0))
    with ie.false_block():
        ie.output(f.layers.reshape(x, [1, 1]))
    return [f.layers.reduce_sum(ie()[0])]


def _growing_array_program(f):
    """An unbounded While that appends to a tensor array it carries."""
    x = f.layers.data("x", shape=[1], append_batch_size=False)
    i = f.layers.fill_constant([1], "int64", 0)
    arr = f.layers.array_write(x, i)
    limit = f.layers.fill_constant([1], "int64", 3)
    cond = f.layers.less_than(i, limit)
    w = f.layers.While(cond)
    with w.block():
        f.layers.increment(i, value=1)
        f.layers.array_write(f.layers.scale(x, scale=2.0), i, array=arr)
        f.layers.less_than(i, limit, cond=cond)
    return [f.layers.scale(f.layers.array_read(arr, i), scale=1.0)]


# case -> (program, the cause the refusal names, the JSON program's
# answer at x = 2)
_UNTRACEABLE = {
    "while": (_growing_carry_program,
              r"changes from torch.float32 \[1\] to torch.float32 \[2\]",
              8.0),
    "if_else": (_differing_branches_program,
                r"\[1\] in the true branch and torch.float32 \[1, 1\]",
                10.0),
    "array": (_growing_array_program, "tensor array, which grows", 4.0),
}


@pytest.mark.parametrize("case", ["while", "if_else", "array"])
def test_aot_host_control_flow_is_refused_naming_f14(tmp_path, case):
    """The unbounded While and the IfElse export as torch's while_loop
    and cond, which take what lax.while_loop and lax.cond take; a form
    they do not (a carry whose shape changes, branches whose outputs
    differ, a tensor array grown in the carry) makes the export raise a
    ValueError naming F14 and the cause, save_inference_model warns "AOT
    export skipped", and the JSON program serves."""
    from paddle_tpu_torch.io.aot import export_compiled
    build, cause, want = _UNTRACEABLE[case]
    d = str(tmp_path / case)
    with pytest.warns(UserWarning, match="AOT export skipped.*F14"):
        main, scope = _save(tfluid, d, build)
    assert not os.path.exists(os.path.join(d, "__compiled__.pt2"))
    with pytest.raises(ValueError, match=f"{cause}.*F14"):
        export_compiled(str(tmp_path / "again"), main, ["x"],
                        [main.global_block().ops[-1].output("Out")[0]],
                        scope, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    prog, _, fetches = tfluid.io.load_inference_model(d, exe)
    got = exe.run(prog, feed={"x": np.asarray([2.0], np.float32)},
                  fetch_list=fetches)[0]
    assert _value(got) == want


def test_aot_bounded_while_exports(tmp_path):
    """A While with max_iters never reads back: it exports, and the
    predictor answers as the executor does."""
    from paddle_tpu_torch.io import load_compiled_predictor
    d = str(tmp_path / "bounded")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        _save(tfluid, d, lambda f: _loop_program(f, 5))
    pred = load_compiled_predictor(d, device="cpu")
    assert _value(pred.run({"x": np.asarray([2.0], np.float32)})[0]) == 12.0


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------
def test_control_flow_under_a_one_rank_mesh_matches():
    """The ParallelExecutor on the one-rank mesh runs a program with a
    While, an IfElse and a StaticRNN and fetches what the reference's
    executor fetches; a DynamicRNN over a sequence feed is refused there,
    as every sequence feed is (the reference's ParallelExecutor stages
    every feed as one dense array)."""
    from paddle_tpu_torch import parallel

    def build(f):
        total = _sum_to_ten(f)[0]
        x = f.layers.data("x", shape=[-1, 4, 3], append_batch_size=False)
        flag = f.layers.data("flag", shape=[1], append_batch_size=False)
        ie = f.layers.IfElse(f.layers.greater_than(flag, total))
        with ie.true_block():
            ie.output(f.layers.scale(flag, scale=5.0))
        with ie.false_block():
            ie.output(f.layers.scale(total, scale=2.0))
        rnn = f.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[-1, 3], batch_ref=x)
            nh = f.layers.fc(f.layers.concat([xt, h], axis=1), size=3,
                             act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        return [ie()[0], f.layers.reduce_sum(rnn())]
    progs = build_both(build)
    jm, js, names, _ = progs["jax"]
    jscope, state = reference_state(js)
    feed = {"x": np.random.RandomState(5).randn(2, 4, 3).astype(np.float32),
            "flag": np.asarray([3.0], np.float32)}
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=names, scope=jscope)
    mesh = parallel.make_mesh({"dp": 1}, place=tfluid.CPUPlace())
    pe = tfluid.ParallelExecutor(main_program=progs["port"][0],
                                 scope=port_scope(state), mesh=mesh)
    got = pe.run(names, feed=feed)
    for name, a, b in zip(names, got, want):
        assert_same(a, b, FWD, name)

    seq = build_both(lambda f: _attention_rnn(f)[:1])
    _, seq_state = reference_state(seq["jax"][1])
    pe = tfluid.ParallelExecutor(main_program=seq["port"][0],
                                 scope=port_scope(seq_state), mesh=mesh)
    rows = {"src": seqs(_seq_rows(0, D), bucket=4),
            "trg": seqs(_seq_rows(1, D), bucket=4)}
    with pytest.raises(NotImplementedError,
                       match="takes no sequence feed"):
        pe.run(seq["port"][2], feed=make_feed("port", rows))
