"""The models of this slice in the torch port against the JAX package:
DeepFM and wide&deep (``models/ctr.py``), word2vec, the recommender
(sequence feeds through ``sequence_pool`` and ``sequence_conv_pool``)
and the stacked dynamic LSTM, with their zoo entries.

- Two Adam steps of each model in both packages from the reference's
  initial state (carried across with ``weights.py``): the losses (rtol
  2e-4 / atol 2e-5), every parameter's gradient of both steps, and every
  parameter and Adam moment after them (rtol 2e-3 / atol 2e-4), the
  scope crossing back to numpy through ``weights.dump_state``.
- The reference's convergence cases (tests/test_model_zoo.py
  ``TestWord2Vec``, ``TestRecommender``, ``TestCTR``; tests/
  test_seq_models.py ``test_stacked_lstm_trains``) on the port, from
  the reference's initial state, so the reference's ratios hold.
- F13: ``embedding(is_sparse=True)`` on a single-device table of at
  least 1,000,000 rows warns, as the reference does
  (tests/test_sparse_embedding.py).
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import zoo as jzoo
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import zoo as tzoo
from torch_seq_common import (FWD, GRAD, assert_same, port_scope,
                              reference_state)

torch.set_num_threads(1)

NEW_ZOO = ("word2vec", "recommender", "ctr", "stacked_dynamic_lstm")


def _model(f, name):
    """Package ``f``'s module ``models.<name>``."""
    import importlib
    return importlib.import_module(f"{f.__name__}.models.{name}")


def _wide_deep(f):
    from_ = _model(f, "ctr")
    wide = f.layers.data(name="wide", shape=[-1, 4], dtype="int64",
                         append_batch_size=False)
    deep = f.layers.data(name="deep", shape=[-1, 6], dtype="int64",
                         append_batch_size=False)
    label = f.layers.data(name="label", shape=[-1, 1], dtype="float32",
                          append_batch_size=False)
    _, loss = from_.build_wide_deep(wide, deep, label, num_features=64,
                                    embed_size=4, hidden_sizes=(16,))
    f.optimizer.Adam(learning_rate=2e-2).minimize(loss)
    return [loss]


def _stacked3(f):
    """bench.py's stacked LSTM shape at a tiny width: three LSTMs, the
    middle one reversed."""
    data = f.layers.data(name="words", shape=[1], dtype="int64",
                         lod_level=1)
    label = f.layers.data(name="label", shape=[1], dtype="int64")
    loss, acc, _ = _model(f, "stacked_dynamic_lstm").stacked_lstm_net(
        data, label, dict_dim=100, emb_dim=16, hid_dim=16, stacked_num=3)
    f.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return [loss, acc]


def _wide_deep_feed(rng, b):
    return {"wide": rng.randint(0, 64, (b, 4)).astype(np.int64),
            "deep": rng.randint(0, 64, (b, 6)).astype(np.int64),
            "label": rng.randint(0, 2, (b, 1)).astype(np.float32)}


def _programs(case):
    """{which: (main, startup, fetch names)} and a feed maker
    (which, step) -> feed, for a zoo entry or a custom build."""
    if case in NEW_ZOO:
        out = {}
        for which, zoo in (("jax", jzoo), ("port", tzoo)):
            zp = zoo.build_zoo_program(case)
            out[which] = (zp.main, zp.startup,
                          [v.name for v in zp.fetch_list])

        def feed(which, step):
            return (jzoo if which == "jax" else tzoo).example_feed(
                case, 4, step)
        return out, feed
    build = {"wide_deep": _wide_deep, "stacked_lstm_3": _stacked3}[case]
    out = {}
    for which, f in (("jax", jfluid), ("port", tfluid)):
        main, startup = f.Program(), f.Program()
        with f.unique_name.guard(), f.program_guard(main, startup):
            out[which] = (main, startup, [v.name for v in build(f)])

    def feed(which, step):
        rng = np.random.RandomState(step)
        if case == "wide_deep":
            return _wide_deep_feed(rng, 8)
        seq = (jzoo if which == "jax" else tzoo)._seqs(rng, 4, 0, 100)[0]
        return {"words": seq,
                "label": rng.randint(0, 2, (4, 1)).astype(np.int64)}
    return out, feed


@pytest.mark.parametrize("case", list(NEW_ZOO) + ["wide_deep",
                                                  "stacked_lstm_3"])
def test_two_adam_steps_match_reference(case):
    progs, feed = _programs(case)
    jmain, jstart, names = progs["jax"]
    tmain, _, tnames = progs["port"]
    assert names == tnames
    params = sorted(p.name for p in jmain.all_parameters())
    assert params == sorted(p.name for p in tmain.all_parameters())
    grads = [p + "@GRAD" for p in params]
    jscope, state = reference_state(jstart)
    tscope = port_scope(state)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for step in range(2):
        want = jexe.run(jmain, feed=feed("jax", step),
                        fetch_list=names + grads, scope=jscope)
        got = texe.run(tmain, feed=feed("port", step),
                       fetch_list=names + grads, scope=tscope)
        for n, a, b in zip(names + grads, got, want):
            assert_same(a, b, GRAD if n.endswith("@GRAD") else FWD,
                        f"step {step} {n}")
    # every persistable after two steps — parameters, both Adam moments,
    # the beta powers — crossing back through weights.py
    dumped = weights.dump_state(tscope)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    assert persist and set(persist) <= set(dumped)
    for n in persist:
        assert_same(dumped[n], np.asarray(jscope.find_var(n)), GRAD, n)


def test_zoo_feeds_match_the_reference():
    """The port's example feeds are the reference's, sequences included
    (SequenceBatch values for the lod_level inputs)."""
    for name in NEW_ZOO:
        a, b = tzoo.example_feed(name, 4, 1), jzoo.example_feed(name, 4, 1)
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k], FWD, f"{name}.{k}")
    assert isinstance(tzoo.example_feed("recommender")["title"],
                      tfluid.SequenceBatch)


# ---------------------------------------------------------------------------
# the reference's convergence cases, from its initial state
# ---------------------------------------------------------------------------
def _converge(build, feeds):
    """Losses of the port over ``feeds``, starting from the reference's
    initial state of the same program."""
    progs = {}
    for which, f in (("jax", jfluid), ("port", tfluid)):
        main, startup = f.Program(), f.Program()
        with f.unique_name.guard(), f.program_guard(main, startup):
            loss = build(f)
        progs[which] = (main, startup, loss.name)
    _, state = reference_state(progs["jax"][1])
    scope = port_scope(state)
    main, _, loss = progs["port"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    return [float(np.asarray(exe.run(main, feed=feed(main), fetch_list=[loss],
                                     scope=scope)[0]).reshape(()))
            for feed in feeds]


def test_word2vec_ngram_converges():
    dict_size = 30

    def build(f):
        words = [f.layers.data(name=f"w{i}", shape=[1], dtype="int64")
                 for i in range(4)]
        nxt = f.layers.data(name="next", shape=[1], dtype="int64")
        _, loss = _model(f, "word2vec").build_word2vec(
            words, nxt, dict_size, embed_size=16, hidden_size=32)
        f.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return loss

    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(40):
        base = rng.randint(0, dict_size - 5, size=(32, 1))
        feed = {f"w{i}": base + i for i in range(4)}
        feed["next"] = base + 4
        feed = {k: v.astype(np.int64) for k, v in feed.items()}
        feeds.append(lambda main, feed=feed: feed)
    losses = _converge(build, feeds)
    assert losses[-1] < losses[0] * 0.5, losses


def test_recommender_towers_converge():
    sizes = dict(uid=8, gender=2, age=4, job=4, mid=8, category=6,
                 title=20)
    names = ["uid", "gender", "age", "job", "mid", "cats", "title",
             "rating"]

    def build(f):
        ins = [f.layers.data(name=n, shape=[1], dtype="int64",
                             lod_level=1 if n in ("cats", "title") else 0)
               for n in names[:-1]]
        rating = f.layers.data(name="rating", shape=[1], dtype="float32")
        _, loss = _model(f, "recommender").build_recommender(
            *ins, rating, sizes=sizes)
        f.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        return loss

    rng = np.random.RandomState(0)
    batches = []
    for _ in range(30):
        batch = []
        for _ in range(16):
            u, m = rng.randint(0, 8), rng.randint(0, 8)
            batch.append((
                np.array([u], np.int64), np.array([u % 2], np.int64),
                np.array([u % 4], np.int64), np.array([u % 4], np.int64),
                np.array([m], np.int64),
                rng.randint(0, 6, size=rng.randint(1, 4)).astype(np.int64),
                rng.randint(0, 20, size=rng.randint(3, 7)).astype(np.int64),
                np.array([float((u + m) % 6)], np.float32)))
        batches.append(batch)
    feeds = [lambda main, b=b: tfluid.DataFeeder(names, program=main).feed(b)
             for b in batches]
    losses = _converge(build, feeds)
    assert losses[-1] < losses[0], losses


def _ids_and_labels(rng, batch, fields, vocab):
    ids = rng.randint(0, vocab, size=(batch, fields)).astype(np.int64)
    # the planted rule: click iff any even-bucket id below vocab/4
    label = ((ids < vocab // 4) & (ids % 2 == 0)).any(1)
    return ids, label.astype(np.float32).reshape(-1, 1)


def test_deepfm_converges():
    def build(f):
        feat = f.layers.data(name="feat", shape=[-1, 6], dtype="int64",
                             append_batch_size=False)
        label = f.layers.data(name="label", shape=[-1, 1], dtype="float32",
                              append_batch_size=False)
        _, loss = _model(f, "ctr").build_deepfm(feat, label, num_features=64,
                                            num_fields=6, embed_size=4,
                                            hidden_sizes=(16,))
        f.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        return loss

    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(40):
        ids, lbl = _ids_and_labels(rng, 64, 6, 64)
        feeds.append(lambda main, ids=ids, lbl=lbl: {"feat": ids,
                                                     "label": lbl})
    losses = _converge(build, feeds)
    assert losses[-1] < losses[0] * 0.8, losses


def test_wide_deep_converges():
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(40):
        deep, lbl = _ids_and_labels(rng, 64, 6, 64)
        wide = rng.randint(0, 64, size=(64, 4)).astype(np.int64)
        feeds.append(lambda main, w=wide, d=deep, lbl=lbl: {
            "wide": w, "deep": d, "label": lbl})
    losses = _converge(lambda f: _wide_deep(f)[0], feeds)
    assert losses[-1] < losses[0] * 0.8, losses


def test_stacked_lstm_trains():
    def build(f):
        data = f.layers.data(name="words", shape=[1], dtype="int64",
                             lod_level=1)
        label = f.layers.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = _model(f, "stacked_dynamic_lstm").stacked_lstm_net(
            data, label, dict_dim=100, emb_dim=16, hid_dim=16,
            stacked_num=2)
        f.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return loss

    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(12):
        words, labels = [], []
        for _ in range(8):
            lab = rng.randint(0, 2)
            n = rng.randint(3, 8)
            words.append(rng.randint(lab * 50, lab * 50 + 50, (n, 1)))
            labels.append([lab])
        sb = tfluid.to_sequence_batch(words, np.int64, bucket=4)
        feeds.append(lambda main, sb=sb, lb=np.asarray(labels, np.int64): {
            "words": sb, "label": lb})
    losses = _converge(build, feeds)
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------
def test_zoo_builds_the_slice_models_and_refuses_the_rest():
    assert set(NEW_ZOO) <= set(tzoo.zoo_model_names())
    assert set(tzoo.WAITING) == {"faster_rcnn"}
    assert set(tzoo.zoo_model_names()) | set(tzoo.WAITING) == \
        set(jzoo.zoo_model_names())
    for name, item in tzoo.WAITING.items():
        with pytest.raises(NotImplementedError, match=item):
            tzoo.build_zoo_program(name)


# ---------------------------------------------------------------------------
# F13 (tests/test_sparse_embedding.py)
# ---------------------------------------------------------------------------
def test_is_sparse_on_big_single_device_table_warns():
    """is_sparse=True is accepted and changes nothing (the lookup is a
    gather, its gradient a dense scatter-add); on a single-device
    million-row table, where the reference's flag existed to skip the
    dense optimizer sweep, the port says so, as the reference does."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        ids = tfluid.layers.data("ids", shape=[1], dtype="int64")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tfluid.layers.embedding(ids, size=[1_000_000, 8],
                                    is_sparse=True)
        msgs = [str(x.message) for x in w]
        assert any("is_distributed=True" in m and "card" in m
                   and "TPU" not in m for m in msgs), msgs
        # sharded tables and small tables stay silent
        with warnings.catch_warnings(record=True) as w2:
            warnings.simplefilter("always")
            tfluid.layers.embedding(ids, size=[1_000_000, 8],
                                    is_sparse=True, is_distributed=True)
            tfluid.layers.embedding(ids, size=[1000, 8], is_sparse=True)
            tfluid.layers.embedding(ids, size=[1_000_000, 8])
        assert not [x for x in w2 if "is_distributed" in str(x.message)]
