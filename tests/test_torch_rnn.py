"""The recurrent ops of the torch port (``ops/rnn.py``: ``lstm``, ``gru``,
``lstm_unit``, ``gru_unit``) and their layers (``dynamic_lstm``,
``dynamic_lstmp``, ``dynamic_gru``, ``gru_unit``, ``lstm_unit``) against
the JAX package, whose ``lstm``/``gru`` run ``lax.scan``.

Each rule runs on the same numpy inputs in both packages and every
output is compared whole: a forward recurrence holds its last valid
state at the padded steps, a reversed one its initial state, and later
dense ops read those positions. Forwards rtol 2e-4 / atol 2e-5;
gradients (autograd against jax.grad, through one random cotangent per
output) rtol 2e-3 / atol 2e-4 (torch_seq_common.py). The program cases
are tests/test_seq_grads.py's lstm and gru cases and
tests/test_sequence.py's ``test_dynamic_lstm_and_gru_train``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import registry as pt_registry
from torch_seq_common import (S, build_both, make_feed, port_scope,
                              program_pair, reference_state, rule_pair,
                              seqs)

torch.set_num_threads(1)

H = 3
LENS = np.asarray([4, 1, 6, 0], np.int64)


def _f(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


X4 = S(_f(0, 4, 6, 4 * H), LENS)          # lstm input [B, T, 4H]
X3 = S(_f(1, 4, 6, 3 * H), LENS)          # gru input [B, T, 3H]
W4, W3 = _f(2, H, 4 * H, scale=0.5), _f(3, H, 3 * H, scale=0.5)
B7, B4, B3 = _f(4, 7 * H), _f(5, 4 * H), _f(6, 3 * H)
H0, C0 = _f(7, 4, H), _f(8, 4, H)

LSTM = {"Input": [X4], "Weight": [W4], "Bias": [B7]}
RULES = {
    "lstm-peephole": ("lstm", LSTM, {"use_peepholes": True}),
    "lstm-peephole-reverse": ("lstm", LSTM, {"use_peepholes": True,
                                             "is_reverse": True}),
    "lstm-no-peephole": ("lstm", {**LSTM, "Bias": [B4]},
                         {"use_peepholes": False}),
    "lstm-no-bias": ("lstm", {"Input": [X4], "Weight": [W4]}, {}),
    "lstm-h0-c0-reverse": ("lstm", {**LSTM, "H0": [H0], "C0": [C0]},
                           {"use_peepholes": True, "is_reverse": True}),
    "lstm-activations": ("lstm", {**LSTM, "H0": [H0]},
                         {"use_peepholes": True,
                          "gate_activation": "sigmoid",
                          "cell_activation": "relu",
                          "candidate_activation": "identity"}),
    "gru": ("gru", {"Input": [X3], "Weight": [W3], "Bias": [B3]}, {}),
    "gru-reverse": ("gru", {"Input": [X3], "Weight": [W3], "Bias": [B3]},
                    {"is_reverse": True}),
    "gru-h0-no-bias": ("gru", {"Input": [X3], "Weight": [W3], "H0": [H0]},
                       {"activation": "relu"}),
    "lstm_unit": ("lstm_unit", {"X": [_f(9, 5, 4 * H)],
                                "C_prev": [_f(10, 5, H)]}, {}),
    "lstm_unit-forget-bias": ("lstm_unit", {"X": [_f(9, 5, 4 * H)],
                                            "C_prev": [_f(10, 5, H)]},
                              {"forget_bias": 1.0}),
    "gru_unit": ("gru_unit", {"Input": [_f(11, 5, 3 * H)],
                              "HiddenPrev": [_f(12, 5, H)],
                              "Weight": [W3], "Bias": [B3.reshape(1, -1)]},
                 {}),
    "gru_unit-codes": ("gru_unit", {"Input": [_f(11, 5, 3 * H)],
                                    "HiddenPrev": [_f(12, 5, H)],
                                    "Weight": [W3]},
                       {"gate_activation": 1, "activation": 3}),
    "gru_unit-names": ("gru_unit", {"Input": [_f(11, 5, 3 * H)],
                                    "HiddenPrev": [_f(12, 5, H)],
                                    "Weight": [W3]},
                       {"gate_activation": "sigmoid",
                        "activation": "tanh"}),
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_recurrent_rule_matches_reference(case):
    op, ins, attrs = RULES[case]
    rule_pair(op, ins, attrs, grad=sorted(ins))


def test_padding_holds_the_reference_states():
    """The padded steps hold the last valid state (forward) or the
    initial state (reversed), and a row of length 0 holds h0 throughout
    — spelled out on the port's own output."""
    for reverse in (False, True):
        _, out = rule_pair("lstm", {**LSTM, "H0": [H0], "C0": [C0]},
                           {"use_peepholes": True, "is_reverse": reverse})
        h = out["Hidden"][0].data.detach().numpy()
        for b, n in enumerate(LENS):
            held = h0 = H0[b]
            if not reverse and n:
                held = h[b, n - 1]
            np.testing.assert_array_equal(
                h[b, n:], np.broadcast_to(held if not reverse else h0,
                                          h[b, n:].shape))


def test_recurrent_ops_are_ported_and_seq_aware_as_the_reference():
    from paddle_tpu.core import registry as jregistry
    for op in ("lstm", "gru", "lstm_unit", "gru_unit", "scan"):
        assert op not in pt_registry.WAITING
        assert pt_registry.get_op(op).seq_aware == \
            jregistry.get_op(op).seq_aware
    with pytest.raises(TypeError, match="SequenceBatch"):
        rule_pair("lstm", {"Input": [X4.data], "Weight": [W4]})


# ---------------------------------------------------------------------------
# the layers, through both executors
# ---------------------------------------------------------------------------
V, D = 12, 4
SEQS = [np.asarray([[1], [3], [7]], np.int64),
        np.asarray([[2], [5]], np.int64),
        np.asarray([[4], [6], [8], [9]], np.int64)]


def _emb(f):
    ids = f.layers.data("ids", shape=[1], dtype="int64", lod_level=1)
    return f.layers.embedding(
        ids, size=[V, D],
        param_attr=f.ParamAttr(name="seqgrad_emb",
                               initializer=f.initializer.Normal(0.0, 1.0)))


def _lstm_program(reverse, peep):
    def build(f):
        proj = f.layers.fc(_emb(f), size=12, param_attr=f.ParamAttr(
            name="lstm_proj_w", initializer=f.initializer.Normal(0.0, 0.5)))
        proj.lod_level = 1
        hidden, cell = f.layers.dynamic_lstm(
            proj, size=12, use_peepholes=peep, is_reverse=reverse,
            param_attr=f.ParamAttr(
                name="lstm_w", initializer=f.initializer.Normal(0.0, 0.5)),
            bias_attr=f.ParamAttr(
                name="lstm_b", initializer=f.initializer.Normal(0.0, 0.5)))
        return [f.layers.reduce_sum(hidden), hidden, cell]
    return build


def _gru_program(reverse):
    def build(f):
        proj = f.layers.fc(_emb(f), size=9, param_attr=f.ParamAttr(
            name="gru_proj_w", initializer=f.initializer.Normal(0.0, 0.5)))
        proj.lod_level = 1
        hidden = f.layers.dynamic_gru(
            proj, size=3, is_reverse=reverse,
            param_attr=f.ParamAttr(
                name="gru_w", initializer=f.initializer.Normal(0.0, 0.5)),
            bias_attr=f.ParamAttr(
                name="gru_b", initializer=f.initializer.Normal(0.0, 0.5)))
        return [f.layers.reduce_sum(hidden), hidden]
    return build


def _lstmp(f):
    proj = f.layers.fc(_emb(f), size=12)
    proj.lod_level = 1
    p, cell = f.layers.dynamic_lstmp(proj, size=12, proj_size=2)
    return [f.layers.reduce_sum(f.layers.sequence_pool(p, "last")), p, cell]


def _units(f):
    x = f.layers.data("x", shape=[4], dtype="float32")
    h0 = f.layers.data("h0", shape=[3], dtype="float32")
    c0 = f.layers.data("c0", shape=[3], dtype="float32")
    h, c = f.layers.lstm_unit(x, h0, c0, forget_bias=0.5)
    g_in = f.layers.fc(x, size=9)
    gh, reset, gate = f.layers.gru_unit(g_in, h0, size=9)
    total = f.layers.elementwise_add(
        f.layers.reduce_sum(h), f.layers.reduce_sum(gh))
    return [total, h, c, gh, reset, gate]


PROGRAMS = {
    "dynamic_lstm": _lstm_program(False, True),
    "dynamic_lstm-reverse": _lstm_program(True, True),
    "dynamic_lstm-no-peephole": _lstm_program(False, False),
    "dynamic_gru": _gru_program(False),
    "dynamic_gru-reverse": _gru_program(True),
    "dynamic_lstmp": _lstmp,
}


@pytest.mark.parametrize("case", sorted(PROGRAMS))
def test_recurrent_layer_gradients_match_reference(case):
    """tests/test_seq_grads.py's lstm and gru cases, held to the
    reference: the loss, the whole padded hidden (and cell) sequences and
    every parameter's gradient — the projection weight's crosses the
    whole recurrence, the recurrent weight's the carry chain."""
    program_pair(PROGRAMS[case], {"ids": seqs(SEQS)}, grads=True)


def test_step_units_match_reference():
    rng = np.random.RandomState(3)
    program_pair(_units, {"x": rng.randn(5, 4).astype(np.float32),
                          "h0": rng.randn(5, 3).astype(np.float32),
                          "c0": rng.randn(5, 3).astype(np.float32)},
                 grads=True)


def test_dynamic_lstm_and_gru_train():
    """tests/test_sequence.py's case: an LSTM and a GRU over one
    embedding, pooled and classified, learn a rule that clusters words
    by label (the port's losses fall over 15 Adam steps from the
    reference's initial state; its first loss equals the reference's)."""
    def build(f):
        data = f.layers.data(name="words", shape=[1], dtype="int64",
                             lod_level=1)
        label = f.layers.data(name="label", shape=[1], dtype="int64")
        emb = f.layers.embedding(input=data, size=[50, 16])
        proj = f.layers.fc(input=emb, size=4 * 16)
        proj.lod_level = 1
        h, _ = f.layers.dynamic_lstm(input=proj, size=4 * 16)
        proj2 = f.layers.fc(input=emb, size=3 * 16)
        proj2.lod_level = 1
        g = f.layers.dynamic_gru(input=proj2, size=16)
        pooled = f.layers.concat([f.layers.sequence_pool(h, "max"),
                                  f.layers.sequence_pool(g, "max")], axis=1)
        pred = f.layers.fc(pooled, size=2, act="softmax")
        loss = f.layers.mean(f.layers.cross_entropy(pred, label))
        f.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return [loss]

    progs = build_both(build)
    jscope, state = reference_state(progs["jax"][1])
    scope = port_scope(state)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    losses = []
    for step in range(15):
        words, labels = [], []
        for _ in range(8):
            lab = rng.randint(0, 2)
            length = rng.randint(2, 7)
            words.append(rng.randint(lab * 25, lab * 25 + 25, (length, 1)))
            labels.append([lab])
        feed = {"words": seqs(words, np.int64, 4),
                "label": np.asarray(labels, np.int64)}
        if step == 0:
            import paddle_tpu as jfluid
            want = jfluid.Executor(jfluid.CPUPlace()).run(
                progs["jax"][0], feed=make_feed("jax", feed),
                fetch_list=progs["jax"][2], scope=jscope)[0]
        out = exe.run(progs["port"][0], feed=make_feed("port", feed),
                      fetch_list=progs["port"][2], scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(())))
        if step == 0:
            np.testing.assert_allclose(losses[0], float(np.asarray(want)
                                       .reshape(())), rtol=2e-4)
    assert losses[-1] < losses[0], losses
