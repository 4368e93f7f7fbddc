"""AMP (``transpiler.amp_transpile``, O1 and O2) through the torch port,
against the JAX package: bf16 products over float32 master state.

Both packages build each program with the same layer code and the same
``amp_transpile``; the JAX startup initializes the float32 state and the
scope crosses as numpy. The reference's attention runs as its own tests
run it on the CPU (``_FORCE_INTERPRET``; the head dims here are off its
Pallas gate, so it takes the plain path).

The bf16 tier: both packages round each product's output (and, under
O2, the activations between ops) to bf16, but at different places
inside attention's backward (the reference's vjp rounds scores and
probabilities to bf16, the port's plain K2/K3 keep them in float32) and
in the fused loss's backward (the port feeds its softmax-gradient chunk
to the bf16 products as bf16), so one-ulp flips (2**-8) propagate. The
step-1 loss is held at rtol 1e-3, each gradient to a relative RMS error
of 3e-2 (measured at most 1.01e-2), and the losses of 3 Adam steps at
rtol 5e-2 — tests/test_amp.py's own tier between a bf16 and a float32
trajectory (measured at most 2.1e-2: Adam normalises the small
gradients whose signs those flips decide). The dtype of every
parameter, gradient and Adam moment must equal the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.ops.pallas_attention as pa
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.core import amp_policy
from paddle_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-3
GRAD_REL_RMS = 3e-2
ADAM_RTOL = 5e-2
TINY = dict(vars(jllama.LLAMA_TINY))                    # head dim 16
HD64 = dict(TINY, dim=128, n_heads=2, n_kv_heads=1)     # head dim 64


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)


def _mlp(fluid, level):
    """fc → fc → fc (no activation: the port has no relu rule yet) →
    softmax_with_cross_entropy → mean → Adam."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, 16],
                              append_batch_size=False)
        y = fluid.layers.data(name="y", shape=[-1, 1], dtype="int64",
                              append_batch_size=False)
        h = x
        for size in (32, 32, 8):
            h = fluid.layers.fc(h, size=size)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(h, y))
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    fluid.transpiler.amp_transpile(main, level=level)
    return main, startup, loss


def _mlp_feed(step):
    rng = np.random.RandomState(40 + step)
    return {"x": rng.randn(16, 16).astype(np.float32),
            "y": rng.randint(0, 8, (16, 1)).astype(np.int64)}


def _llama(fluid, level, cfg, **kw):
    llama = jllama if fluid is jfluid else tllama
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        targets = fluid.layers.data(name="targets", shape=[-1, -1],
                                    dtype="int64", append_batch_size=False)
        _, loss = llama.build_llama(llama.LlamaConfig(**cfg), tokens,
                                    targets, **kw)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    fluid.transpiler.amp_transpile(main, level=level)
    return main, startup, loss


def _llama_feed(step):
    toks = np.random.RandomState(500 + step).randint(0, 256, (2, 16)) \
        .astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _rel_rms(got, want):
    want = np.asarray(want, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - want
    return np.sqrt((err ** 2).mean()) / max(np.sqrt((want ** 2).mean()),
                                            1e-30)


def _check(build, feed):
    """Step 1's loss and gradients, then 3 Adam steps' losses, and the
    dtype of every piece of state, port against reference."""
    jm, js, jl = build(jfluid)
    tm, _, tl = build(tfluid)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope = weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, CPU)
    texe = tfluid.Executor(tfluid.CPUPlace())
    grads = sorted(v for v in tm.global_block().vars if v.endswith("@GRAD"))
    assert grads
    want = jexe.run(jm, feed=feed(0), fetch_list=[jl] + grads, scope=jscope)
    got = texe.run(tm, feed=feed(0), fetch_list=[tl] + grads, scope=tscope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=LOSS_RTOL)
    for name, g, w in zip(grads, got[1:], want[1:]):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.float32, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, name
        assert _rel_rms(g, w) <= GRAD_REL_RMS, (name, _rel_rms(g, w))
    jls, tls = [], []
    for s in range(1, 4):
        jls.append(float(np.asarray(jexe.run(
            jm, feed=feed(s), fetch_list=[jl], scope=jscope)[0]).reshape(())))
        tls.append(float(np.asarray(texe.run(
            tm, feed=feed(s), fetch_list=[tl], scope=tscope)[0]).reshape(())))
    assert all(np.isfinite(tls))
    np.testing.assert_allclose(tls, jls, rtol=ADAM_RTOL)
    # float32 master parameters, moments and accumulators, as the
    # reference's
    assert set(tscope.keys()) == set(jscope.keys())
    for n in jscope.keys():
        want_dt = str(np.asarray(jscope.find_var(n)).dtype)
        assert str(tscope.find_var(n).dtype) == f"torch.{want_dt}", n


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_mlp_matches_reference(level):
    _check(lambda fluid: _mlp(fluid, level), _mlp_feed)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("model", ["hd16_unrolled", "hd64_unrolled",
                                   "hd64_stacked_fused"])
def test_amp_llama_matches_reference(model, level):
    cfg = TINY if model.startswith("hd16") else HD64
    kw = dict(shard_pp=True, fused_head_chunk=48) \
        if model.endswith("stacked_fused") else {}
    _check(lambda fluid: _llama(fluid, level, cfg, **kw), _llama_feed)


def test_amp_casts_follow_the_policy(monkeypatch):
    """Under O1 a matmul op gets bf16 inputs and gives f32; under O2 it
    gives bf16, a flow op keeps bf16 and any other op gets f32 inputs.
    Seen by the rules themselves."""
    from paddle_tpu_torch.core import registry
    seen = {}
    for op_type in ("mul", "elementwise_add", "softmax_with_cross_entropy"):
        opdef = registry.get_op(op_type)
        real = opdef.lower

        def spy(ctx, ins, attrs, _real=real, _t=op_type):
            outs = _real(ctx, ins, attrs)
            seen.setdefault(_t, []).append(
                ({s: [v.dtype for v in vs] for s, vs in ins.items()},
                 {s: [v.dtype for v in vs] for s, vs in outs.items()}))
            return outs

        monkeypatch.setattr(opdef, "lower", spy)
    bf16, f32 = torch.bfloat16, torch.float32
    for level in ("O1", "O2"):
        seen.clear()
        tm, ts, tl = _mlp(tfluid, level)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(ts, scope=scope)
        exe.run(tm, feed=_mlp_feed(0), fetch_list=[tl], scope=scope)
        mul_ins, _ = seen["mul"][0]
        assert mul_ins == {"X": [bf16], "Y": [bf16]}
        add_ins, _ = seen["elementwise_add"][0]
        swce_ins, _ = seen["softmax_with_cross_entropy"][-1]
        if level == "O1":
            assert add_ins == {"X": [f32], "Y": [f32]}
            assert swce_ins["Logits"] == [f32]
        else:
            # the bf16 product flows into the bias add, whose f32
            # result is written back as bf16; the loss upcasts
            assert add_ins == {"X": [bf16], "Y": [f32]}
            assert swce_ins["Logits"] == [f32]
        assert {"mul", "elementwise_add"} <= amp_policy.AMP_MATMUL_OPS \
            | amp_policy.AMP_BF16_FLOW_OPS


def test_amp_transpile_flags():
    main, _, _ = _mlp(tfluid, "O2")
    assert main._amp == "O2" and main.clone(for_test=True)._amp == "O2"
    v = main.version
    tfluid.transpiler.amp_transpile(main, enable=False)
    assert main._amp is False and main.version > v
    with pytest.raises(ValueError, match="O1"):
        tfluid.transpiler.amp_transpile(main, level="O3")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[-1, 4],
                               append_batch_size=False)
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=2))
        tfluid.transpiler.decorate_amp(
            tfluid.optimizer.SGD(learning_rate=0.1)).minimize(loss)
    assert main._amp == "O1"


# ---------------------------------------------------------------------------
# conv nets under O2 (the cases of tests/test_amp.py:173-236)
# ---------------------------------------------------------------------------


def _convnet(fluid, level, layout="NCHW"):
    """tests/test_amp.py's conv + bn + pool residual net with a
    Momentum(0.05, 0.9) step, transpiled to ``level``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, 8, 8], dtype="float32")
        label = fluid.layers.data("label", [1], dtype="int64")
        x = img
        if layout == "NHWC":
            x = fluid.layers.transpose(x, perm=[0, 2, 3, 1])
        y = fluid.layers.conv2d(input=x, num_filters=8, filter_size=3,
                                padding=1, bias_attr=False,
                                data_format=layout)
        y = fluid.layers.batch_norm(input=y, act="relu", data_layout=layout)
        y = fluid.layers.pool2d(input=y, pool_type="max", pool_size=2,
                                pool_stride=2, data_format=layout)
        y = fluid.layers.conv2d(input=y, num_filters=8, filter_size=3,
                                padding=1, bias_attr=False,
                                data_format=layout)
        y = fluid.layers.batch_norm(input=y, act=None, data_layout=layout)
        y = fluid.layers.elementwise_add(x=y, y=y, act="relu")
        y = fluid.layers.pool2d(input=y, pool_type="avg",
                                global_pooling=True, data_format=layout)
        logits = fluid.layers.fc(y, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=logits, label=label))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    if level:
        fluid.transpiler.amp_transpile(main, level=level)
    return main, startup, loss


def _convnet_state():
    """The reference's startup state of the conv net (one for every
    level and layout: the same parameter names)."""
    _, js, _ = _convnet(jfluid, None)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(js, scope=jscope)
    return {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}


def _convnet_feed():
    rng = np.random.RandomState(3)
    return {"img": rng.randn(16, 3, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (16, 1)).astype(np.int64)}


def _train_convnet(level, layout="NCHW", steps=8, state=None):
    main, _, loss = _convnet(tfluid, level, layout)
    scope = weights.load_state(tfluid.Scope(), state or _convnet_state(),
                               CPU)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = _convnet_feed()
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].reshape(()))
            for _ in range(steps)], scope


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_amp_o2_convnet_matches_o1_and_trains(layout):
    """O2 (bf16 activation flow) tracks O1 on a conv + bn + pool residual
    net (first losses within 0.05, the reference test's), converges, and
    its losses follow the reference's O2 run at the bf16 tier (rtol
    5e-2)."""
    state = _convnet_state()
    o1, _ = _train_convnet("O1", layout, state=state)
    o2, _ = _train_convnet("O2", layout, state=state)
    assert all(np.isfinite(o2)), o2
    assert abs(o2[0] - o1[0]) < 0.05, (o1[0], o2[0])
    assert o2[-1] < o2[0], o2
    jm, _, jl = _convnet(jfluid, "O2", layout)
    jscope = jfluid.Scope()
    for n, v in state.items():
        jscope.set(n, v)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    want = [float(np.asarray(jexe.run(jm, feed=_convnet_feed(),
                                      fetch_list=[jl], scope=jscope)[0])
                  .reshape(())) for _ in range(8)]
    np.testing.assert_allclose(o2, want, rtol=ADAM_RTOL)


def test_amp_o2_master_state_stays_f32():
    """Parameters, optimizer state and BN moving statistics stay float32
    in the scope under O2: bf16 lives only inside the step."""
    _, scope = _train_convnet("O2", steps=2)
    for name, val in scope.vars.items():
        if val.is_floating_point():
            assert val.dtype == torch.float32, (name, val.dtype)


def test_amp_o2_biased_conv_keeps_bf16_flow():
    """A conv with a bias under O2: the bias add computes bf16 + f32 in
    f32 but writes its activation back as bf16; reduce_sum is no flow op
    and is fetched in f32."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data("img", [3, 8, 8], dtype="float32")
        y = tfluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                 padding=1)
        r = tfluid.layers.relu(y)
        out = tfluid.layers.reduce_sum(r)
    tfluid.transpiler.amp_transpile(main, level="O2")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    from paddle_tpu_torch.core.lowering import lower_program
    fn = lower_program(main, [r.name, out.name], "test")
    _, (rel, tot) = fn(dict(scope.vars),
                       {"img": torch.ones((2, 3, 8, 8))}, CPU, 0, 1)
    assert rel.dtype == torch.bfloat16, rel.dtype
    assert tot.dtype == torch.float32, tot.dtype
