"""The Transformer encoder-decoder (models/transformer.py) through the
torch port's Executor, against the JAX package.

Both packages build the program with the same layer code; the JAX
startup initializes the state, which crosses as numpy
(``weights.load_state``). Two configurations, each padded (source and
target lengths: the biased attention path for the encoder and the
cross-attention, the flash path for the causal decoder) and unpadded
(every attention on the flash path, cross-attention with tq != tk):
``TRANSFORMER_TINY`` (head dim 8) and a head-dim-64 model (d_model 128,
2 heads, 2 + 2 layers, label smoothing 0.1), source 16 and target 12
tokens, dropout 0 for the parity checks.

Tolerances, the f32 tiers of tests/test_attention.py and
tests/test_torch_training.py: logits rtol 1e-4 / atol 1e-4 (matmuls sum
in another order); loss and gradients rtol 2e-3 / atol 2e-4; losses over
noam + Adam steps rtol 2e-3; the learning rate rtol 1e-6; the step
counter exactly (by value: the reference's int64 is int32 without x64).
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as jtf

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import transformer as ttf

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
LOSS_RTOL = 2e-3
SRC, TGT, BATCH = 16, 12, 3
COUNTER = "@LR_DECAY_COUNTER@"

CONFIGS = {
    "tiny": {},
    "hd64": dict(d_model=128, n_head=2, n_encoder_layers=2,
                 n_decoder_layers=2, d_ff=256, label_smooth_eps=0.1),
}


def _cfg(tf, name, **kw):
    return dataclasses.replace(tf.TRANSFORMER_TINY,
                               **{**CONFIGS[name], **kw})


def _build(fluid, tf, cfg, padded, labels=True, warmup=4):
    """(main, startup, logits, loss, lr): build_transformer, then
    noam_decay feeding Adam(beta2 0.98, eps 1e-9), the base recipe."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        data = lambda n, shape: fluid.layers.data(  # noqa: E731
            name=n, shape=shape, dtype="int64", append_batch_size=False)
        src, tgt = data("src", [-1, SRC]), data("tgt", [-1, TGT])
        lbl = data("lbl", [-1, TGT]) if labels else None
        kw = dict(src_lengths=data("src_len", [-1]),
                  tgt_lengths=data("tgt_len", [-1])) if padded else {}
        logits, loss = tf.build_transformer(cfg, src, tgt, lbl, **kw)
        lr = None
        if labels:
            lr = fluid.layers.noam_decay(cfg.d_model, warmup)
            fluid.optimizer.Adam(lr, beta1=0.9, beta2=0.98,
                                 epsilon=1e-9).minimize(loss)
    return main, startup, logits, loss, lr


def _feed(step, padded, vocab=64, labels=True):
    r = np.random.RandomState(300 + step)
    feed = {"src": r.randint(0, vocab, (BATCH, SRC)).astype(np.int64),
            "tgt": r.randint(0, vocab, (BATCH, TGT)).astype(np.int64)}
    if labels:
        feed["lbl"] = r.randint(0, vocab, (BATCH, TGT)).astype(np.int64)
    if padded:
        feed["src_len"] = np.asarray([SRC, 9, 4], np.int64)
        feed["tgt_len"] = np.asarray([TGT, 7, 2], np.int64)
    return feed


def _pair(name, padded, labels=True, **cfg_kw):
    """Both programs and one JAX startup scope carried into a port
    scope."""
    jp = _build(jfluid, jtf, _cfg(jtf, name, **cfg_kw), padded, labels)
    tp = _build(tfluid, ttf, _cfg(ttf, name, **cfg_kw), padded, labels)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jp[1], scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    tscope = weights.load_state(tfluid.Scope(), arrays, CPU)
    return jp, tp, jscope, tscope


def _same_attrs(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def _grad_names(prog):
    return sorted(v for v in prog.global_block().vars if v.endswith("@GRAD"))


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_program_is_the_reference_program(name, padded):
    """Identical op types, wiring, attrs and variables in the main and
    startup programs (parameters, @GRAD vars, Adam accumulators, the
    LR counter)."""
    jp = _build(jfluid, jtf, _cfg(jtf, name), padded)
    tp = _build(tfluid, ttf, _cfg(ttf, name), padded)
    for jprog, tprog in zip(jp[:2], tp[:2]):
        jops, tops = jprog.global_block().ops, tprog.global_block().ops
        assert [o.type for o in jops] == [o.type for o in tops]
        for jo, to in zip(jops, tops):
            assert (jo.inputs, jo.outputs) == (to.inputs, to.outputs)
            _same_attrs(jo.attrs, to.attrs)
        jvars, tvars = jprog.global_block().vars, tprog.global_block().vars
        assert sorted(jvars) == sorted(tvars)
        for n, jv in jvars.items():
            tv = tvars[n]
            assert (jv.shape, jv.dtype, jv.persistable) == \
                (tv.shape, tv.dtype, tv.persistable), n
    types = [o.type for o in tp[0].global_block().ops]
    assert types[0] == "increment"           # the counter, prepended
    n_layers = CONFIGS[name].get("n_decoder_layers", 2)
    # the flash path: causal decoder self-attention, plus encoder and
    # cross-attention when unpadded
    assert types.count("multihead_attention") == (
        n_layers if padded else 3 * n_layers)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_and_noam_adam_steps_match_reference(name, padded):
    """Step 1: logits, loss and every parameter's gradient; then the
    losses, the noam rate and the counter over 3 noam + Adam steps."""
    (jm, _, jlog, jl, jlr), (tm, _, tlog, tl, tlr), jscope, tscope = \
        _pair(name, padded)
    grads = _grad_names(tm)
    assert grads == _grad_names(jm) and grads
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    fetch = lambda log, loss, lr: [log, loss, lr] + grads  # noqa: E731
    want = jexe.run(jm, feed=_feed(0, padded), fetch_list=fetch(
        jlog, jl, jlr), scope=jscope)
    got = texe.run(tm, feed=_feed(0, padded), fetch_list=fetch(
        tlog, tl, tlr), scope=tscope)
    np.testing.assert_allclose(got[0], want[0], **LOGIT_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
    for n, g, w in zip(grads, got[3:], want[3:]):
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g, w, err_msg=n, **GRAD_TOL)
    for step in range(1, 4):
        w = jexe.run(jm, feed=_feed(step, padded), fetch_list=[jl, jlr],
                     scope=jscope)
        g = texe.run(tm, feed=_feed(step, padded), fetch_list=[tl, tlr],
                     scope=tscope)
        np.testing.assert_allclose(g[0], w[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g[1], w[1], rtol=1e-6)
    assert int(np.asarray(tscope.find_var(COUNTER)).reshape(())) == \
        int(np.asarray(jscope.find_var(COUNTER)).reshape(())) == 3


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_inference_clone_scales_dropout_by_keep_rate(padded):
    """``clone(for_test=True)`` of a program with dropout 0.1 serves the
    trained scope with every dropout at test time: the
    ``downgrade_in_infer`` scaling by 1 - p, as the reference."""
    (jm, _, jlog, _, _), (tm, _, tlog, _, _), jscope, tscope = \
        _pair("hd64", padded, labels=False, dropout=0.1)
    jinfer, tinfer = jm.clone(for_test=True), tm.clone(for_test=True)
    assert all(o.attrs["is_test"] for o in tinfer.global_block().ops
               if o.type == "dropout")
    feed = _feed(7, padded, labels=False)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jinfer, feed=feed, fetch_list=[jlog], scope=jscope)[0]
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tinfer, feed=feed, fetch_list=[tlog], scope=tscope)[0]
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    # the scaling is there: without it the logits move
    nodrop = _pair("hd64", padded, labels=False, dropout=0.0)[1]
    plain = tfluid.Executor(tfluid.CPUPlace()).run(
        nodrop[0].clone(for_test=True), feed=feed, fetch_list=[nodrop[2]],
        scope=tscope)[0]
    assert np.abs(plain - got).max() > 1e-2


def test_train_mode_dropout_draws_per_step():
    """Train-mode dropout inside a program: a p = 0.1 mask keeps 1 - p of
    the elements (within 5 sigma), replays for the same program seed and
    step, and changes with the step."""
    p = 0.1
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 11
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[-1, 256, 128],
                               dtype="float32", append_batch_size=False)
        y = tfluid.layers.dropout(x, p)
    feed = {"x": np.ones((8, 256, 128), np.float32)}

    def run(exe):
        return exe.run(main, feed=feed, fetch_list=[y],
                       scope=tfluid.Scope())[0]

    exe = tfluid.Executor(tfluid.CPUPlace())
    a, b = run(exe), run(exe)
    n = a.size
    kept = (a != 0).mean()
    assert abs(kept - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    assert set(np.unique(a)) <= {0.0, 1.0}       # downgrade_in_infer
    assert not np.array_equal(a, b)               # the step moved on
    np.testing.assert_array_equal(run(tfluid.Executor(tfluid.CPUPlace())),
                                  a)             # same seed and step


def test_loss_without_lengths_is_the_mean_and_with_lengths_the_masked_mean():
    """The two loss heads of build_transformer agree where every target
    position is valid."""
    (_, _, _, _, _), (tm, _, _, tl, _), _, tscope = _pair("tiny", True)
    (_, _, _, _, _), (um, _, _, ul, _), _, _ = _pair("tiny", False)
    feed = _feed(0, True)
    feed["src_len"] = np.full((BATCH,), SRC, np.int64)
    feed["tgt_len"] = np.full((BATCH,), TGT, np.int64)
    exe = tfluid.Executor(tfluid.CPUPlace())
    a = exe.run(tm.clone(for_test=True), feed=feed, fetch_list=[tl],
                scope=tscope)[0]
    unfeed = {k: v for k, v in feed.items() if not k.endswith("_len")}
    b = exe.run(um.clone(for_test=True), feed=unfeed, fetch_list=[ul],
                scope=tscope)[0]
    np.testing.assert_allclose(a, b, rtol=1e-5)
