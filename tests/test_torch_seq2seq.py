"""The models of ROADMAP item 7b in the torch port against the JAX
package: seq2seq attention machine translation (``seq_to_seq_net``,
``greedy_decode``), semantic role labelling (``db_lstm`` with the CRF),
CRNN-CTC OCR, and ``contrib``'s decoders, with their zoo entries.

- Two steps of each zoo model (Adam, or SGD for the SRL model) in both
  packages from the reference's initial state: the losses (rtol 2e-4 /
  atol 2e-5), every trainable parameter's gradient of both steps, and
  every persistable after them (rtol 2e-3 / atol 2e-4), read back
  through ``weights.dump_state``.
- The reference's cases, from its initial state: tests/
  test_seq_models.py ``test_seq2seq_attention_trains``, tests/
  test_book_models.py ``test_label_semantic_roles_trains_and_decodes``
  and tests/test_contrib.py ``test_training_decoder_trains`` and
  ``test_beam_search_decoder_decodes``; the greedy and beam decodes'
  tokens, beam ids, parents' paths and Viterbi tags equal the
  reference's exactly (random weights at these widths leave every
  top-2 margin far above float32 rounding).
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import zoo as jzoo
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import zoo as tzoo
from torch_seq_common import (FWD, GRAD, assert_same, build_both, make_feed,
                              port_scope, program_pair, reference_state,
                              seqs)

torch.set_num_threads(1)

NEW_ZOO = ("machine_translation", "ocr_recognition", "label_semantic_roles")


def _model(f, name):
    return importlib.import_module(f"{f.__name__}.models.{name}")


@pytest.mark.parametrize("case", NEW_ZOO)
def test_two_steps_match_reference(case):
    progs = {}
    for which, zoo in (("jax", jzoo), ("port", tzoo)):
        zp = zoo.build_zoo_program(case)
        progs[which] = (zp.main, zp.startup, [v.name for v in zp.fetch_list])
    jmain, jstart, names = progs["jax"]
    tmain, _, tnames = progs["port"]
    assert names == tnames
    params = sorted(p.name for p in jmain.all_parameters() if p.trainable)
    assert params == sorted(p.name for p in tmain.all_parameters()
                            if p.trainable)
    grads = [p + "@GRAD" for p in params]
    jscope, state = reference_state(jstart)
    tscope = port_scope(state)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for step in range(2):
        want = jexe.run(jmain, feed=jzoo.example_feed(case, 4, step),
                        fetch_list=names + grads, scope=jscope)
        got = texe.run(tmain, feed=tzoo.example_feed(case, 4, step),
                       fetch_list=names + grads, scope=tscope)
        for n, a, b in zip(names + grads, got, want):
            assert_same(a, b, GRAD if n.endswith("@GRAD") else FWD,
                        f"step {step} {n}")
    if case == "ocr_recognition":
        # each conv's bias feeds a batch norm, which cancels it: its
        # gradient is rounding noise (~1e-9) in both packages, and
        # Adam's normalised step turns that noise into ±lr. The
        # parameters after two steps are held in the SGD case below.
        return
    _assert_persistables(jmain, jscope, tscope)


def _assert_persistables(jmain, jscope, tscope):
    dumped = weights.dump_state(tscope)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    assert persist and set(persist) <= set(dumped)
    for n in persist:
        assert_same(dumped[n], np.asarray(jscope.find_var(n)), GRAD, n)


def test_ocr_two_sgd_steps_match_reference():
    """The zoo's OCR model with SGD: losses, gradients, and every
    persistable after two steps (batch norm's moving statistics too)."""
    def build(f):
        images = f.layers.data(name="images", shape=[1, 8, 16],
                               dtype="float32")
        label = f.layers.data(name="label", shape=[1], dtype="int64",
                              lod_level=1)
        loss, _ = _model(f, "ocr_recognition").ctc_train_net(
            images, label, num_classes=3, rnn_hidden=16, conv_filters=(8,))
        f.optimizer.SGD(learning_rate=5e-2).minimize(loss)
        return [loss]
    progs = build_both(build)
    jm, js, names, _ = progs["jax"]
    params = sorted(p.name for p in jm.all_parameters())
    fetch = names + [p + "@GRAD" for p in params]
    jscope, state = reference_state(js)
    tscope = port_scope(state)
    for step in range(2):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            jm, feed=jzoo.example_feed("ocr_recognition", 4, step),
            fetch_list=fetch, scope=jscope)
        got = tfluid.Executor(tfluid.CPUPlace()).run(
            progs["port"][0], feed=tzoo.example_feed("ocr_recognition", 4,
                                                     step),
            fetch_list=fetch, scope=tscope)
        for n, a, b in zip(fetch, got, want):
            assert_same(a, b, GRAD if n.endswith("@GRAD") else FWD, n)
    _assert_persistables(jm, jscope, tscope)


def test_zoo_feeds_match_the_reference():
    for name in NEW_ZOO:
        a, b = tzoo.example_feed(name, 4, 1), jzoo.example_feed(name, 4, 1)
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k], FWD, f"{name}.{k}")


# ---------------------------------------------------------------------------
# machine translation
# ---------------------------------------------------------------------------
def _copy_task(rng, b):
    srcs, lbls = [], []
    for _ in range(b):
        s = rng.randint(0, 40, (rng.randint(3, 6), 1))
        srcs.append(s)
        lbls.append(np.roll(s, -1, 0))
    return {"src": seqs(srcs, np.int64, bucket=4),
            "trg": seqs(srcs, np.int64, bucket=4),
            "lbl": seqs(lbls, np.int64, bucket=4)}


def _seq2seq(f):
    src, trg, lbl = (f.layers.data(name=n, shape=[1], dtype="int64",
                                   lod_level=1)
                     for n in ("src", "trg", "lbl"))
    loss, pred = _model(f, "machine_translation").seq_to_seq_net(
        src, trg, lbl, src_dict_size=40, trg_dict_size=40,
        embedding_dim=16, encoder_size=16, decoder_size=16)
    f.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return [loss, pred]


def test_seq2seq_attention_trains():
    """Overfitting one copy-task batch halves the loss in 30 Adam steps;
    the first step's loss and the DynamicRNN's prediction (a sequence
    with the target's lengths) equal the reference's."""
    progs = build_both(_seq2seq)
    jm, js, names, _ = progs["jax"]
    jscope, state = reference_state(js)
    tscope = port_scope(state)
    feed = _copy_task(np.random.RandomState(0), 4)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=make_feed("jax", feed), fetch_list=names, scope=jscope,
        return_numpy=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = []
    for step in range(30):
        got = exe.run(progs["port"][0], feed=make_feed("port", feed),
                      fetch_list=names, scope=tscope, return_numpy=False)
        if step == 0:
            for n, a, b in zip(names, got, want):
                assert_same(a, b, FWD, n)
            assert isinstance(got[1], tfluid.SequenceBatch)
        losses.append(float(np.asarray(got[0]).reshape(())))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


@pytest.mark.parametrize("max_len", [1, 6])
def test_greedy_decode_tokens_match_reference(max_len):
    """greedy_decode's StaticRNN feeds back each step's argmax: the
    tokens of every step equal the reference's."""
    def build(f):
        src = f.layers.data(name="src", shape=[1], dtype="int64",
                            lod_level=1)
        return [_model(f, "machine_translation").greedy_decode(
            src, 40, 40, max_len, embedding_dim=16, encoder_size=16,
            decoder_size=16, bos_id=1)]
    rng = np.random.RandomState(1)
    _, got = program_pair(build, {"src": seqs(
        [rng.randint(0, 40, (n, 1)) for n in (3, 5, 1)], np.int64,
        bucket=4)}, mode="test")
    assert got[0].shape == (3, max_len, 1)


# ---------------------------------------------------------------------------
# semantic role labelling
# ---------------------------------------------------------------------------
WORD_N, LABEL_N, PRED_N = 40, 9, 12
SRL_NAMES = ["word", "predicate", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
             "ctx_p2", "mark"]


def _srl_feed(rng, batch=4):
    feats = {n: [] for n in SRL_NAMES + ["target"]}
    for _ in range(batch):
        n = rng.randint(3, 7)
        for name in ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
                     "ctx_p2"):
            feats[name].append(rng.randint(0, WORD_N, (n, 1)))
        feats["predicate"].append(rng.randint(0, PRED_N, (n, 1)))
        feats["mark"].append(rng.randint(0, 2, (n, 1)))
        feats["target"].append(rng.randint(0, LABEL_N, (n, 1)))
    return {k: seqs(v, np.int64, bucket=4) for k, v in feats.items()}


def test_label_semantic_roles_trains_and_decodes():
    """db_lstm + linear_chain_crf with SGD: 8 steps from the reference's
    initial state lower the loss, the first step equals the reference's,
    and the Viterbi tags (and chunk_eval's counts over them) of the
    trained model equal the reference's own after the same steps."""
    def build(f):
        ins = [f.layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
               for n in SRL_NAMES]
        target = f.layers.data(name="target", shape=[1], dtype="int64",
                               lod_level=1)
        feature_out = _model(f, "label_semantic_roles").db_lstm(
            *ins, word_dict_len=WORD_N, label_dict_len=LABEL_N,
            pred_dict_len=PRED_N, word_dim=8, mark_dim=4, hidden_dim=16,
            depth=4)
        avg_cost = f.layers.mean(f.layers.linear_chain_crf(
            input=feature_out, label=target,
            param_attr=f.ParamAttr(name="crfw")))
        decoded = f.layers.crf_decoding(
            input=feature_out, param_attr=f.ParamAttr(name="crfw"))
        counts = f.layers.chunk_eval(decoded, target, chunk_scheme="IOB",
                                     num_chunk_types=(LABEL_N - 1) // 2)
        f.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
        return [avg_cost, decoded] + list(counts[3:])

    progs = build_both(build)
    jm, js, names, _ = progs["jax"]
    jscope, state = reference_state(js)
    tscope = port_scope(state)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    losses = []
    for step in range(8):
        feed = _srl_feed(rng)
        got = texe.run(progs["port"][0], feed=make_feed("port", feed),
                       fetch_list=names[:1], scope=tscope)
        want = jexe.run(jm, feed=make_feed("jax", feed),
                        fetch_list=names[:1], scope=jscope)
        if step == 0:
            assert_same(got[0], want[0], FWD)
        losses.append(float(np.asarray(got[0]).reshape(())))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    feed = _srl_feed(rng)
    got = texe.run(progs["port"][0], feed=make_feed("port", feed),
                   fetch_list=names[1:], scope=tscope, mode="test",
                   return_numpy=False)
    want = jexe.run(jm, feed=make_feed("jax", feed), fetch_list=names[1:],
                    scope=jscope, mode="test", return_numpy=False)
    for n, a, b in zip(names[1:], got, want):
        assert_same(a, b, FWD, n)
    tags = np.asarray(got[0].data)
    valid = np.asarray(got[0].mask()) > 0
    assert ((tags[valid] >= 0) & (tags[valid] < LABEL_N)).all()


# ---------------------------------------------------------------------------
# contrib's decoders (tests/test_contrib.py)
# ---------------------------------------------------------------------------
VOCAB, EMB, HID = 37, 16, 24
BOS, EOS = 0, 1


def _make_cell(f, prefix):
    """A GRU-flavored state cell: h' = tanh(W_x x + W_h h)."""
    dec = importlib.import_module(f"{f.__name__}.contrib.decoder")
    init = dec.InitState(init=f.layers.data(
        name=f"{prefix}_boot", shape=[-1, HID], dtype="float32",
        append_batch_size=False))
    cell = dec.StateCell(inputs={"x": None}, states={"h": init},
                         out_state="h")

    @cell.state_updater
    def updater(c):
        nh = f.layers.fc(c.get_input("x"), size=HID, bias_attr=False,
                         num_flatten_dims=1, param_attr=f"{prefix}_wx")
        hh = f.layers.fc(c.get_state("h"), size=HID, bias_attr=False,
                         num_flatten_dims=1, param_attr=f"{prefix}_wh")
        c.set_state("h", f.layers.tanh(f.layers.elementwise_add(nh, hh)))

    return cell, dec


def test_training_decoder_trains():
    """TrainingDecoder teacher-forces target sequences; the next-token
    loss falls by 0.3 in 60 Adam steps, and the first step's loss and
    gradients equal the reference's."""
    def build(f):
        trg = f.layers.data(name="trg", shape=[-1, 8], dtype="int64",
                            append_batch_size=False)
        label = f.layers.data(name="label", shape=[-1, 8], dtype="int64",
                              append_batch_size=False)
        cell, dec = _make_cell(f, "td")
        decoder = dec.TrainingDecoder(cell)
        emb = f.layers.embedding(trg, size=[VOCAB, EMB], dtype="float32",
                                 param_attr="td_emb")
        with decoder.block():
            cell.compute_state(inputs={"x": decoder.step_input(emb)})
            cell.update_states()
            decoder.output(cell.out_state())
        logits = f.layers.fc(decoder(), size=VOCAB, num_flatten_dims=2)
        loss = f.layers.mean(f.layers.softmax_with_cross_entropy(
            logits, f.layers.unsqueeze(label, axes=[2])))
        return [loss]

    def feed(rng):
        toks = rng.randint(2, VOCAB, (16, 8)).astype(np.int64)
        toks[:, 1::2] = toks[:, 0::2]        # learnable repeats
        return {"trg": toks, "td_boot": np.zeros((16, HID), np.float32),
                "label": np.roll(toks, -1, 1)}

    program_pair(build, feed(np.random.RandomState(9)), grads=True)

    def train(f):
        loss = build(f)[0]
        f.optimizer.Adam(learning_rate=0.02).minimize(loss)
        return [loss]
    progs = build_both(train)
    _, state = reference_state(progs["jax"][1])
    scope = port_scope(state)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    losses = [float(np.asarray(exe.run(
        progs["port"][0], feed=feed(rng), fetch_list=progs["port"][2],
        scope=scope)[0]).reshape(())) for _ in range(60)]
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_beam_search_decoder_decodes():
    """BeamSearchDecoder: [batch, beam, T] token sequences with
    descending per-beam scores, equal to the reference's ids and scores
    from the same weights."""
    batch, beam, max_len = 4, 3, 6

    def build(f):
        init_ids = f.layers.data(name="init_ids", shape=[-1, 1],
                                 dtype="int64", append_batch_size=False)
        init_scores = f.layers.data(name="init_scores", shape=[-1, 1],
                                    dtype="float32",
                                    append_batch_size=False)
        cell, dec = _make_cell(f, "bsd")
        decoder = dec.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=VOCAB, word_dim=EMB, topk_size=10,
            max_len=max_len, beam_size=beam, end_id=EOS, name="bsd")
        ids, scores = decoder.decode()
        assert decoder() == (ids, scores)
        return [ids, scores]

    feed = {"init_ids": np.full((batch, 1), BOS, np.int64),
            "init_scores": np.zeros((batch, 1), np.float32),
            "bsd_boot": np.random.RandomState(3).randn(
                batch, HID).astype(np.float32)}
    _, (got_ids, got_scores) = program_pair(build, feed, mode="test")
    assert got_ids.shape == (batch, beam, max_len)
    assert got_scores.shape == (batch, beam)
    assert np.isfinite(got_scores).all()
    assert (np.diff(got_scores, axis=1) <= 1e-5).all()
    assert ((got_ids >= 0) & (got_ids < VOCAB)).all()

