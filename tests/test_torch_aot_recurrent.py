"""The AOT export of recurrent and control-flow programs (io/aot.py with
``lower_program(for_export=True)``) against the JAX package's.

The reference exports every padded sequence axis as a symbol, with its
recurrences and control flow traced into ``lax.scan``,
``lax.while_loop`` and ``lax.cond`` (tests/test_aot_export.py's
``test_aot_exports_sequence_program``). Here each program is built in
both packages, the port's scope is the reference's initialized one
(``weights.py``), each package exports it through its own
``save_inference_model`` with no declared length, and one artifact of
each serves every geometry below through its ``load_compiled_predictor``.
The port's answers are held to the reference's predictor and to the
port's own Executor at the forward tier (rtol 2e-4 / atol 2e-5), and the
port's meta holds no ``fixed_seq_len``.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from torch_seq_common import (FWD, build_both, port_scope,
                              reference_state)

torch.set_num_threads(1)


def _words(rng, lens, vocab=100):
    return [rng.randint(1, vocab, (n, 1)).astype(np.int64) for n in lens]


def _seq_model(f):
    """tests/test_aot_export.py's ``_seq_model``: a dynamic_gru."""
    words = f.layers.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
    emb = f.layers.embedding(input=words, size=[100, 16])
    gru = f.layers.dynamic_gru(f.layers.fc(emb, size=48), size=16)
    pool = f.layers.sequence_pool(gru, pool_type="max")
    return [f.layers.fc(pool, size=3, act="softmax")]


def _lstm_model(f):
    """A peephole LSTM run in reverse, its hidden and cell pooled."""
    words = f.layers.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
    emb = f.layers.embedding(input=words, size=[100, 8])
    h, c = f.layers.dynamic_lstm(f.layers.fc(emb, size=24), size=24,
                                 use_peepholes=True, is_reverse=True)
    return [f.layers.fc(f.layers.concat(
        [f.layers.sequence_pool(h, "max"), f.layers.sequence_last_step(c)],
        axis=1), size=3, act="softmax")]


def _subblock_model(f):
    """test_torch_control_flow.py's ``_subblock_program`` over ids: a
    DynamicRNN whose parameter is read only inside its sub-block."""
    words = f.layers.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
    x = f.layers.embedding(input=words, size=[100, 6])
    rnn = f.layers.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(x)
        mem = rnn.memory(shape=[-1, 3], batch_ref=x)
        h = f.layers.fc(f.layers.concat([xt, mem], axis=1), size=3,
                        act="tanh", param_attr="inner_w")
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    return [f.layers.sequence_last_step(rnn())]


def _two_views_model(f):
    """A DynamicRNN whose step reads two views of one outer tensor (the
    halves of a ``split``)."""
    words = f.layers.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
    x = f.layers.embedding(input=words, size=[100, 6])
    a, b = f.layers.split(f.layers.fc(f.layers.sequence_pool(x, "sum"),
                                      size=6), num_or_sections=2, dim=1)
    rnn = f.layers.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(x)
        mem = rnn.memory(shape=[-1, 3], batch_ref=x)
        h = f.layers.fc(f.layers.concat([xt, mem, a, b], axis=1), size=3,
                        act="tanh")
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    return [f.layers.sequence_last_step(rnn())]


def _static_rnn_model(f):
    """A StaticRNN over a dense [B, T, 4] feed whose T is free."""
    x = f.layers.data("x", shape=[-1, -1, 4], append_batch_size=False)
    rnn = f.layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(shape=[-1, 3], batch_ref=x)
        nh = f.layers.fc(f.layers.concat([xt, h], axis=1), size=3,
                         act="tanh")
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    return [f.layers.reduce_sum(rnn(), dim=1)]


def _while_model(f):
    """An unbounded While whose trip count is the fed ``lim``."""
    x = f.layers.data("x", shape=[-1, 4], append_batch_size=False)
    lim = f.layers.data("lim", shape=[1], append_batch_size=False)
    w = f.layers.create_parameter(
        [4], "float32", attr=f.ParamAttr(name="cf_w"),
        default_initializer=f.initializer.Normal(0.0, 1.0))
    i = f.layers.fill_constant([1], "float32", 0.0)
    acc = f.layers.scale(x, scale=1.0)
    cond = f.layers.less_than(i, lim)
    loop = f.layers.While(cond)
    with loop.block():
        f.layers.assign(f.layers.elementwise_add(
            i, f.layers.fill_constant([1], "float32", 1.0)), output=i)
        f.layers.assign(f.layers.tanh(f.layers.elementwise_add(
            f.layers.elementwise_mul(acc, w), x)), output=acc)
        f.layers.less_than(i, lim, cond=cond)
    return [f.layers.reduce_sum(acc, dim=1), f.layers.scale(i, scale=1.0)]


def _ifelse_model(f):
    """An IfElse on the sign of the feed's sum."""
    x = f.layers.data("x", shape=[-1, 4], append_batch_size=False)
    ie = f.layers.IfElse(f.layers.greater_than(
        f.layers.reduce_sum(x), f.layers.fill_constant([1], "float32", 0.0)))
    with ie.true_block():
        ie.output(f.layers.tanh(f.layers.scale(x, scale=2.0)))
    with ie.false_block():
        ie.output(f.layers.sigmoid(x))
    return [ie()[0]]


def _seq_feeds(lens_list):
    rng = np.random.RandomState(3)
    return [{"words": _words(rng, lens)} for lens in lens_list]


def _dense(b, t, seed):
    return np.random.RandomState(seed).randn(b, t, 4).astype(np.float32)


def _flat(b, sign, seed):
    return sign * np.abs(np.random.RandomState(seed).randn(b, 4)).astype(
        np.float32)


# name -> (build, feed names, feeds: one per geometry); a sequence feed
# is a list of rows (to_sequence_batch pads it to the longest row)
CASES = {
    # the reference's own: batch 3 at padded length 7, batch 5 at 9
    "seq_model_gru": (_seq_model, ["words"],
                      _seq_feeds([(5, 3, 7), (2, 9, 4, 6, 1)])),
    "lstm_peepholes_reversed": (_lstm_model, ["words"],
                                _seq_feeds([(5, 3, 7), (2, 9, 4, 6, 1),
                                            (12,)])),
    "dynamic_rnn_subblock_param": (_subblock_model, ["words"],
                                   _seq_feeds([(5, 3, 7),
                                               (2, 9, 4, 6, 1)])),
    "dynamic_rnn_two_views": (_two_views_model, ["words"],
                              _seq_feeds([(5, 3, 7), (2, 9, 4, 6, 1)])),
    "static_rnn": (_static_rnn_model, ["x"],
                   [{"x": _dense(3, 7, 0)}, {"x": _dense(5, 9, 1)}]),
    # trip counts 2, 5 and 0
    "while_unbounded": (_while_model, ["x", "lim"],
                        [{"x": _flat(3, 1, 0), "lim": [2.0]},
                         {"x": _flat(5, -1, 1), "lim": [5.0]},
                         {"x": _flat(2, 1, 2), "lim": [0.0]}]),
    # the true branch, then the false one
    "ifelse_both_branches": (_ifelse_model, ["x"],
                             [{"x": _flat(3, 1, 0)}, {"x": _flat(5, -1, 1)}]),
}


def _feed(pkg, spec):
    out = {}
    for k, v in spec.items():
        if k == "words":
            out[k] = pkg.to_sequence_batch(v, bucket=1)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _save(pkg, d, main, feeds, fetches, scope):
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope), warnings.catch_warnings():
        warnings.simplefilter("error")            # no silent fallback
        pkg.io.save_inference_model(d, feeds, fetches, exe,
                                    main_program=main)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_artifact_serves_every_length_as_the_reference(tmp_path, case):
    from paddle_tpu.io import load_compiled_predictor as jload
    from paddle_tpu_torch.io import load_compiled_predictor as tload
    build, feed_names, geometries = CASES[case]
    progs = build_both(build)
    jmain, jstart, names, _ = progs["jax"]
    tmain = progs["port"][0]
    jscope, state = reference_state(jstart)
    tscope = port_scope(state)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _save(jfluid, jd, jmain, feed_names, names, jscope)
    _save(tfluid, td, tmain, feed_names, names, tscope)
    assert os.path.exists(os.path.join(jd, "__compiled__.stablehlo"))
    assert os.path.exists(os.path.join(td, "__compiled__.pt2"))
    with open(os.path.join(td, "__compiled_meta__.json")) as f:
        specs = json.load(f)["feed_specs"]
    assert not any("fixed_seq_len" in s for s in specs), specs
    jpred, tpred = jload(jd), tload(td, device="cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    for spec in geometries:
        tfeed = _feed(tfluid, spec)
        got = tpred.run(tfeed)
        want = jpred.run(_feed(jfluid, spec))
        own = exe.run(tmain, feed=tfeed, fetch_list=names, scope=tscope,
                      mode="test")
        assert len(got) == len(want) == len(names)
        for n, g, w, o in zip(names, got, want, own):
            o = np.asarray(getattr(o, "data", o))
            assert g.shape == np.asarray(w).shape == o.shape, (n, g.shape)
            np.testing.assert_allclose(g, np.asarray(w), err_msg=n, **FWD)
            np.testing.assert_allclose(g, o, err_msg=n, **FWD)


def test_seq2seq_attention_exports_both_lengths_symbolic(tmp_path):
    """The seq2seq-attention model's teacher-forced prediction at a
    narrow width: a DynamicRNN whose step attends over the encoder's
    outer SequenceBatch. One artifact with ``src`` and ``trg`` both
    symbolic serves (src, trg) lengths that differ, equal to the
    Executor and to the reference's Executor (the reference's export
    refuses a fetched SequenceBatch; the port's predictor returns its
    padded data)."""
    from paddle_tpu_torch.io import load_compiled_predictor as tload

    def build(f):
        from importlib import import_module
        mt = import_module(f.__name__ + ".models.machine_translation")
        src, trg, lbl = (f.layers.data(name=n, shape=[1], dtype="int64",
                                       lod_level=1)
                         for n in ("src", "trg", "lbl"))
        _, pred = mt.seq_to_seq_net(src, trg, lbl, 40, 30,
                                    embedding_dim=8, encoder_size=8,
                                    decoder_size=8)
        return [pred]

    progs = build_both(build)
    jmain, jstart, names, _ = progs["jax"]
    tmain = progs["port"][0]
    jscope, state = reference_state(jstart)
    tscope = port_scope(state)
    td = str(tmp_path / "port")
    _save(tfluid, td, tmain, ["src", "trg"], names, tscope)
    with open(os.path.join(td, "__compiled_meta__.json")) as f:
        assert not any("fixed_seq_len" in s
                       for s in json.load(f)["feed_specs"])
    tpred = tload(td, device="cpu")
    exe, jexe = tfluid.Executor(tfluid.CPUPlace()), \
        jfluid.Executor(jfluid.CPUPlace())
    rng = np.random.RandomState(4)
    for src_lens, trg_lens in (((5, 3, 7), (4, 6, 2)),
                               ((2, 9, 4, 6, 1), (3, 3, 5, 2, 4))):
        s, t = _words(rng, src_lens, 40), _words(rng, trg_lens, 30)
        tfeed = {"src": tfluid.to_sequence_batch(s, bucket=1),
                 "trg": tfluid.to_sequence_batch(t, bucket=1)}
        got = tpred.run(tfeed)[0]
        jt = jfluid.to_sequence_batch(t, bucket=1)
        want = jexe.run(jmain, feed={
            "src": jfluid.to_sequence_batch(s, bucket=1), "trg": jt,
            "lbl": jt}, fetch_list=names, scope=jscope, mode="test")[0]
        own = exe.run(tmain, feed=dict(tfeed, lbl=tfeed["trg"]),
                      fetch_list=names, scope=tscope, mode="test")[0]
        assert got.shape == (len(s), max(trg_lens), 30)
        np.testing.assert_allclose(got, np.asarray(want.data), **FWD)
        np.testing.assert_allclose(got, np.asarray(own.data), **FWD)


def test_eager_step_is_unchanged_by_the_export_form():
    """The Executor's step stays the eager loop: a recurrent program's
    loss and gradients are the reference's (the export form runs only
    while torch.export traces)."""
    from torch_seq_common import program_pair, seqs

    def build(f):
        x = f.layers.data(name="x", shape=[6], dtype="float32",
                          lod_level=1)
        h, _ = f.layers.dynamic_lstm(f.layers.fc(x, size=12), size=12,
                                     use_peepholes=True, is_reverse=True)
        g = f.layers.dynamic_gru(f.layers.fc(h, size=9), size=3)
        return [f.layers.mean(f.layers.sequence_pool(g, "sum"))]

    rng = np.random.RandomState(5)
    program_pair(build, {"x": seqs([rng.randn(n, 6).astype(np.float32)
                                    for n in (4, 2, 7)])}, grads=True)


def test_crf_decoding_exports_its_length_symbolic(tmp_path):
    """crf_decoding's Viterbi pass and backtrack are recurrences over the
    padded axis: an exported tagger (label_semantic_roles' inference
    form) serves any padded length, equal to the port's Executor and to
    the reference's (whose export refuses a fetched SequenceBatch)."""
    from paddle_tpu_torch.io import load_compiled_predictor as tload

    def build(f):
        words = f.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
        emb = f.layers.embedding(input=words, size=[100, 8])
        f.layers.create_parameter([7, 5], "float32",
                                  attr=f.ParamAttr(name="crfw"))
        return [f.layers.crf_decoding(input=f.layers.fc(emb, size=5),
                                      param_attr=f.ParamAttr(name="crfw"))]

    progs = build_both(build)
    jmain, jstart, names, _ = progs["jax"]
    tmain = progs["port"][0]
    jscope, state = reference_state(jstart)
    tscope = port_scope(state)
    td = str(tmp_path / "port")
    _save(tfluid, td, tmain, ["words"], names, tscope)
    with open(os.path.join(td, "__compiled_meta__.json")) as f:
        assert not any("fixed_seq_len" in s
                       for s in json.load(f)["feed_specs"])
    tpred = tload(td, device="cpu")
    exe, jexe = tfluid.Executor(tfluid.CPUPlace()), \
        jfluid.Executor(jfluid.CPUPlace())
    for spec in _seq_feeds([(5, 3, 7), (2, 9, 4, 6, 1), (1,)]):
        got = tpred.run(_feed(tfluid, spec))[0]
        want = jexe.run(jmain, feed=_feed(jfluid, spec), fetch_list=names,
                        scope=jscope, mode="test")[0]
        own = exe.run(tmain, feed=_feed(tfluid, spec), fetch_list=names,
                      scope=tscope, mode="test")[0]
        np.testing.assert_array_equal(got, np.asarray(want.data))
        np.testing.assert_array_equal(got, np.asarray(own.data))


# F14's last ops: linear_chain_crf's forward algorithm, warpctc's alpha
# recursion and chunk_eval's matching are recurrences over the padded
# axis (rnn._recur), as the reference's lax.scans are


def _crf_model(f, alpha=False):
    """A tagger's linear-chain CRF cost over 5 tags, the fed ids its own
    gold tags (one sequence feed), with its Alpha fetched too."""
    words = f.layers.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
    emb = f.layers.embedding(input=words, size=[5, 8])
    ll = f.layers.linear_chain_crf(input=f.layers.fc(emb, size=5),
                                   label=words,
                                   param_attr=f.ParamAttr(name="crfw"))
    if not alpha:
        return [ll]
    block = f.default_main_program().global_block()
    op, = [op for op in block.ops if op.type == "linear_chain_crf"]
    return [ll, block.var(op.output("Alpha")[0])]


def _ctc_model(f, norm_by_times):
    """An OCR head's CTC cost over projected frames."""
    x = f.layers.data(name="x", shape=[8], dtype="float32", lod_level=1)
    lab = f.layers.data(name="lab", shape=[1], dtype="int64", lod_level=1)
    return [f.layers.warpctc(input=f.layers.fc(x, size=6), label=lab,
                             blank=0, norm_by_times=norm_by_times)]


def _chunk_model(f, scheme, n_tags):
    """chunk_eval's six outputs over 3 chunk types (type 1 excluded):
    a CRF tagger's Viterbi tags against the fed ids as gold tags."""
    words = f.layers.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
    emb = f.layers.embedding(input=words, size=[n_tags, 8])
    f.layers.create_parameter([n_tags + 2, n_tags], "float32",
                              attr=f.ParamAttr(name="crfw"))
    tags = f.layers.crf_decoding(input=f.layers.fc(emb, size=n_tags),
                                 param_attr=f.ParamAttr(name="crfw"))
    return list(f.layers.chunk_eval(input=tags, label=words,
                                    chunk_scheme=scheme, num_chunk_types=3,
                                    excluded_chunk_types=[1]))


def _edit_model(f):
    """edit_distance of hypotheses to references, normalized."""
    hyp, ref = (f.layers.data(name=n, shape=[1], dtype="int64",
                              lod_level=1) for n in ("hyp", "ref"))
    return [f.layers.edit_distance(input=hyp, label=ref)[0]]


def _rows(seed, lens, hi=100, width=None):
    rng = np.random.RandomState(seed)
    if width:
        return [rng.randn(n, width).astype(np.float32) for n in lens]
    return [rng.randint(0, hi, (n, 1)).astype(np.int64) for n in lens]


def _ctc_feeds():
    return [{"x": _rows(4, (8, 5, 9), width=8), "lab": _rows(5, (3, 1, 2), 6)},
            {"x": _rows(6, (4, 12, 6, 7, 3), width=8),
             "lab": _rows(7, (2, 4, 1, 3, 1), 6)}]


def _word_feeds(hi):
    return [{"words": _rows(0, (5, 3, 7), hi)},
            {"words": _rows(1, (2, 9, 4, 6, 1), hi)}]


# name -> (build, whether the reference's export takes it, two batch x
# padded-length geometries)
F14_CASES = {
    "linear_chain_crf": (_crf_model, False, _word_feeds(5)),
    "linear_chain_crf_alpha": (lambda f: _crf_model(f, alpha=True), False,
                               _word_feeds(5)),
    "warpctc": (lambda f: _ctc_model(f, False), False, _ctc_feeds()),
    "warpctc_norm_by_times": (lambda f: _ctc_model(f, True), False,
                              _ctc_feeds()),
    "chunk_eval_iob": (lambda f: _chunk_model(f, "IOB", 7), False,
                       _word_feeds(7)),
    "chunk_eval_iobes": (lambda f: _chunk_model(f, "IOBES", 13), False,
                         _word_feeds(13)),
    "edit_distance": (_edit_model, True, [
        {"hyp": _rows(8, (5, 3, 7), 6), "ref": _rows(9, (4, 6, 2), 6)},
        {"hyp": _rows(10, (2, 9, 4, 6, 1), 6),
         "ref": _rows(11, (3, 3, 8, 5, 2), 6)}]),
}


@pytest.mark.parametrize("case", sorted(F14_CASES))
def test_f14_op_exports_with_its_length_symbolic(tmp_path, case):
    """Each program exports from the reference's scope through the
    port's ``save_inference_model`` with no declared padded length (its
    meta fixes none), and one artifact serves both geometries within
    the forward tier of the port's Executor and of the reference's
    Executor, and of the reference's own artifact where its export takes
    the program (edit_distance's). The reference's export does not take
    the others: its ``lax.scan`` over ``x[1:]`` asks whether the
    symbolic length minus one is at least one, which shape polymorphism
    cannot decide, so its ``save_inference_model`` warns that it skipped
    the export (ROADMAP §3, R7)."""
    from paddle_tpu.io import load_compiled_predictor as jload
    from paddle_tpu_torch.io import load_compiled_predictor as tload
    build, ref_exports, geometries = F14_CASES[case]
    progs = build_both(build)
    jmain, jstart, names, _ = progs["jax"]
    tmain = progs["port"][0]
    jscope, state = reference_state(jstart)
    tscope = port_scope(state)
    feed_names = sorted(geometries[0])
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _save(tfluid, td, tmain, feed_names, names, tscope)
    with open(os.path.join(td, "__compiled_meta__.json")) as f:
        assert not any("fixed_seq_len" in s
                       for s in json.load(f)["feed_specs"])
    tpred = tload(td, device="cpu")
    if ref_exports:
        _save(jfluid, jd, jmain, feed_names, names, jscope)
        jpred = jload(jd)
    else:
        with jfluid.scope_guard(jscope), \
                pytest.warns(UserWarning, match="AOT export skipped.*"
                             "inconclusive"):
            jfluid.io.save_inference_model(
                jd, feed_names, names, jfluid.Executor(jfluid.CPUPlace()),
                main_program=jmain)
    exe, jexe = tfluid.Executor(tfluid.CPUPlace()), \
        jfluid.Executor(jfluid.CPUPlace())
    for spec in geometries:
        tfeed = {n: tfluid.to_sequence_batch(v, bucket=1)
                 for n, v in spec.items()}
        jfeed = {n: jfluid.to_sequence_batch(v, bucket=1)
                 for n, v in spec.items()}
        got = tpred.run(tfeed)
        wants = [exe.run(tmain, feed=tfeed, fetch_list=names, scope=tscope,
                         mode="test"),
                 jexe.run(jmain, feed=jfeed, fetch_list=names, scope=jscope,
                          mode="test")]
        if ref_exports:
            wants.append(jpred.run(jfeed))
        for want in wants:
            assert len(got) == len(want) == len(names)
            for n, g, w in zip(names, got, want):
                w = np.asarray(getattr(w, "data", w))
                assert g.shape == w.shape, (n, g.shape, w.shape)
                np.testing.assert_allclose(g, w, err_msg=n, **FWD)
