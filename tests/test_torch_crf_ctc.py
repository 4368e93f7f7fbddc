"""The CRF, CTC, beam-search, ``chunk_eval``, ``im2sequence`` and
``row_conv`` ops of the torch port (``ops/crf_ctc.py``,
``ops/eval_ops.py``, ``ops/nn.py``) and their layers against the JAX
package, whose rules are masked ``lax.scan`` programs ``vmap``'d over
the batch.

- Each rule on the same numpy inputs in both packages, every output
  compared whole and the float inputs' gradients through one random
  cotangent per output (torch_seq_common.py ``rule_pair``: forwards
  rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 2e-4, integers —
  Viterbi tags, greedy CTC tokens, beam ids and parents, chunk counts —
  exactly).
- The reference's cases: the 7 of tests/test_crf_ctc.py (the CRF held
  to brute force, CTC to ``torch.nn.functional.ctc_loss``), with a beam
  step whose scores tie; the 6 ``chunk_eval`` cases of
  tests/test_eval_ops.py; tests/test_ocr.py's CRNN-CTC model.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jax_registry
from paddle_tpu_torch.core import registry as pt_registry
from torch_seq_common import (FWD, S, assert_same, program_pair,
                              rule_pair, seqs)

torch.set_num_threads(1)

LENS = np.asarray([4, 1, 6, 0], np.int64)


def _f(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _ids(seed, hi, *shape):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(
        np.int64)


K = 3
EM = S(_f(0, 4, 6, K), LENS)
TRANS = _f(1, K + 2, K, scale=0.5)
TAGS = S(_ids(2, K, 4, 6, 1), LENS)
C = 5
LOGITS = S(_f(3, 4, 7, C), np.asarray([7, 3, 5, 1], np.int64))
LABELS = S(_ids(4, C - 1, 4, 3, 1) + 1, np.asarray([3, 1, 2, 0], np.int64))

RULES = {
    "crf": ("linear_chain_crf", {"Emission": [EM], "Transition": [TRANS],
                                 "Label": [TAGS]}, {},
            ("Emission", "Transition")),
    "crf_decoding": ("crf_decoding", {"Emission": [EM],
                                      "Transition": [TRANS]}, {}, ()),
    "crf_decoding_label": ("crf_decoding", {"Emission": [EM],
                                            "Transition": [TRANS],
                                            "Label": [TAGS]}, {}, ()),
    "warpctc": ("warpctc", {"Logits": [LOGITS], "Label": [LABELS]},
                {"blank": 0}, ("Logits",)),
    "warpctc_norm": ("warpctc", {"Logits": [LOGITS], "Label": [LABELS]},
                     {"blank": 0, "norm_by_times": True}, ("Logits",)),
    "ctc_greedy": ("ctc_greedy_decoder", {"Input": [LOGITS]},
                   {"blank": 0}, ()),
    "beam_search_full_vocab": (
        "beam_search", {"pre_ids": [np.asarray([[1, 0, 2], [3, 4, 0]])],
                        "pre_scores": [_f(5, 2, 3)],
                        "scores": [_f(6, 2, 3, 6)]},
        {"beam_size": 3, "end_id": 0}, ("pre_scores", "scores")),
    "beam_search_cand_ids": (
        "beam_search", {"pre_ids": [np.asarray([[1, 0, 2], [3, 4, 0]])],
                        "pre_scores": [_f(7, 2, 3)],
                        "ids": [_ids(8, 9, 2, 3, 4)],
                        "scores": [_f(9, 2, 3, 4)]},
        {"beam_size": 3, "end_id": 0}, ("pre_scores", "scores")),
    "beam_search_decode": (
        "beam_search_decode", {"ids": [_ids(10, 5, 4, 2, 3)],
                               "parents": [_ids(11, 3, 4, 2, 3)],
                               "scores": [_f(12, 2, 3)]},
        {"beam_size": 3, "end_id": 0}, ()),
    "beam_expand": ("beam_expand", {"X": [_f(13, 2, 4)]},
                    {"beam_size": 3}, ("X",)),
    "beam_gather": ("beam_gather", {"X": [_f(14, 6, 4)],
                                    "Parent": [_ids(15, 3, 2, 3)]}, {},
                    ("X",)),
    "im2sequence": ("im2sequence", {"X": [_f(16, 2, 3, 5, 6)]},
                    {"kernels": [2, 3], "strides": [1, 2],
                     "paddings": [1, 0, 0, 1]}, ("X",)),
    "im2sequence_column": ("im2sequence", {"X": [_f(17, 2, 4, 3, 7)]},
                           {"kernels": [3, 1], "strides": [1, 1]}, ("X",)),
    "row_conv": ("row_conv", {"X": [_f(18, 2, 5, 4)],
                              "Filter": [_f(19, 3, 4)]}, {},
                 ("X", "Filter")),
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_rule_matches_reference(case):
    op, ins, attrs, grad = RULES[case]
    rule_pair(op, ins, attrs, grad=grad)


def test_beam_search_ties_break_toward_the_lower_flat_index():
    """Equal candidate scores (across beams and within one) pick the
    lower flat index first, as lax.top_k does: ids and parents exact."""
    scores = np.full((2, 3, 4), -5.0, np.float32)
    scores[:, :, 1] = -1.0          # a three-way tie across the beams
    scores[0, 2, 3] = -1.0          # and one more within beam 2
    jout, tout = rule_pair(
        "beam_search", {"pre_ids": [np.asarray([[1, 2, 3], [1, 2, 3]])],
                        "pre_scores": [np.zeros((2, 3), np.float32)],
                        "scores": [scores]},
        {"beam_size": 3, "end_id": 0})
    np.testing.assert_array_equal(tout["parent_idx"][0].numpy(),
                                  [[0, 1, 2], [0, 1, 2]])
    np.testing.assert_array_equal(tout["selected_ids"][0].numpy(),
                                  [[1, 1, 1], [1, 1, 1]])


def test_warpctc_infeasible_target_costs_inf():
    """A target longer than its frames cannot be aligned: inf, in both
    packages, with a zero (not NaN) gradient."""
    logits = S(_f(20, 2, 4, C), np.asarray([4, 2], np.int64))
    labels = S(np.asarray([[[1], [2], [1]], [[3], [3], [3]]]),
               np.asarray([2, 3], np.int64))
    _, tout = rule_pair("warpctc", {"Logits": [logits], "Label": [labels]},
                        {"blank": 0})
    loss = tout["Loss"][0].detach().numpy()[:, 0]
    assert np.isfinite(loss[0]) and np.isinf(loss[1])


def test_rules_register_with_the_reference_flags():
    for op in ("linear_chain_crf", "crf_decoding", "warpctc",
               "ctc_greedy_decoder", "beam_search", "beam_search_decode",
               "beam_expand", "beam_gather", "chunk_eval", "im2sequence",
               "row_conv"):
        assert pt_registry.get_op(op).seq_aware == \
            jax_registry.get_op(op).seq_aware, op


# ---------------------------------------------------------------------------
# tests/test_crf_ctc.py
# ---------------------------------------------------------------------------
def _crf_brute(emission, trans_full, labels):
    """Brute-force NLL and best path: enumerate every tag path."""
    k = emission.shape[1]
    start, end, trans = trans_full[0], trans_full[1], trans_full[2:]
    t = emission.shape[0]

    def score(path):
        s = start[path[0]] + end[path[-1]]
        s += sum(emission[i, path[i]] for i in range(t))
        s += sum(trans[path[i - 1], path[i]] for i in range(1, t))
        return s

    paths = list(itertools.product(range(k), repeat=t))
    log_z = np.logaddexp.reduce([score(p) for p in paths])
    return log_z - score(labels), max(paths, key=score)


def _crf_build(k, name):
    def build(f):
        em = f.layers.data(name="em", shape=[k], dtype="float32",
                           lod_level=1)
        lab = f.layers.data(name="lab", shape=[1], dtype="int64",
                            lod_level=1)
        nll = f.layers.linear_chain_crf(em, lab,
                                        param_attr=f.ParamAttr(name=name))
        path = f.layers.crf_decoding(em, param_attr=f.ParamAttr(name=name))
        return [nll, path, f.default_main_program().global_block().var(
            name)]
    return build


def test_linear_chain_crf_and_decoding_match_brute_force():
    """test_linear_chain_crf_matches_brute_force and
    test_crf_decoding_matches_brute_force: the NLL of each row and its
    Viterbi path, in both packages, against enumeration."""
    rng = np.random.RandomState(0)
    rows = [rng.randn(4, K).astype(np.float32),
            rng.randn(2, K).astype(np.float32),
            rng.randn(3, K).astype(np.float32)]
    labels = [np.array([0, 2, 1, 0]), np.array([1, 1]), np.array([2, 0, 1])]
    feed = {"em": seqs(rows), "lab": seqs([l.reshape(-1, 1)
                                           for l in labels])}
    _, got = program_pair(_crf_build(K, "crfw"), feed, return_numpy=False)
    nll = np.asarray(got[0]).reshape(-1)
    path = np.asarray(got[1].data)
    trans_full = np.asarray(got[2])
    for i, (row, lab) in enumerate(zip(rows, labels)):
        want, best = _crf_brute(row, trans_full, lab)
        np.testing.assert_allclose(nll[i], want, rtol=1e-4)
        np.testing.assert_array_equal(path[i, :len(row)], best)


def test_crf_trains():
    """NLL falls by 40% fitting a tiny tagging problem with SGD, and
    every step's loss and gradients equal the reference's."""
    k = 4
    rng = np.random.RandomState(2)
    rows = [rng.randn(5, k).astype(np.float32) for _ in range(4)]
    labels = [np.argmax(r, axis=1).reshape(-1, 1) for r in rows]

    def build(f):
        em = f.layers.data(name="em", shape=[k], dtype="float32",
                           lod_level=1)
        lab = f.layers.data(name="lab", shape=[1], dtype="int64",
                            lod_level=1)
        feat = f.layers.fc(em, size=k, num_flatten_dims=1)
        loss = f.layers.mean(f.layers.linear_chain_crf(
            feat, lab, param_attr=f.ParamAttr(name="crfw3")))
        f.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss]

    from torch_seq_common import build_both, port_scope, reference_state
    progs = build_both(build)
    jm, js, names, _ = progs["jax"]
    jscope, state = reference_state(js)
    tscope = port_scope(state)
    feed = {"em": seqs(rows), "lab": seqs(labels)}
    from torch_seq_common import make_feed
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    losses = []
    for step in range(30):
        got = texe.run(progs["port"][0], feed=make_feed("port", feed),
                       fetch_list=names, scope=tscope)[0]
        losses.append(float(np.asarray(got).reshape(())))
        if step < 2:
            want = jexe.run(jm, feed=make_feed("jax", feed),
                            fetch_list=names, scope=jscope)[0]
            assert_same(got, want, FWD)
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


def test_warpctc_matches_torch_ctc_loss():
    rng = np.random.RandomState(3)
    frames = [rng.randn(6, C).astype(np.float32),
              rng.randn(4, C).astype(np.float32)]
    targets = [np.array([1, 2, 2]), np.array([3, 1])]

    def build(f):
        x = f.layers.data(name="x", shape=[C], dtype="float32", lod_level=1)
        y = f.layers.data(name="y", shape=[1], dtype="int64", lod_level=1)
        return [f.layers.warpctc(x, y, blank=0)]

    _, got = program_pair(build, {"x": seqs(frames),
                                  "y": seqs([t.reshape(-1, 1)
                                             for t in targets])})
    got = np.asarray(got[0]).reshape(-1)
    for i, (fr, t) in enumerate(zip(frames, targets)):
        lp = torch.log_softmax(torch.tensor(fr), dim=-1)[:, None, :]
        want = torch.nn.functional.ctc_loss(
            lp, torch.tensor(t[None]), torch.tensor([len(fr)]),
            torch.tensor([len(t)]), blank=0, reduction="none")
        np.testing.assert_allclose(got[i], float(want[0]), rtol=1e-4)


def test_ctc_greedy_decoder():
    """Frames argmax to [1, 1, 0(blank), 2, 2, 3] -> decode [1, 2, 3]."""
    path = [1, 1, 0, 2, 2, 3]
    c = 4
    frames = np.full((len(path), c), -5.0, np.float32)
    for t, k in enumerate(path):
        frames[t, k] = 5.0

    def build(f):
        x = f.layers.data(name="x", shape=[c], dtype="float32", lod_level=1)
        return [f.layers.ctc_greedy_decoder(x, blank=0)]

    _, got = program_pair(build, {"x": seqs([frames, frames[:3]])},
                          return_numpy=False)
    out = got[0]
    np.testing.assert_array_equal(np.asarray(out.lengths), [3, 1])
    np.testing.assert_array_equal(np.asarray(out.data)[0, :3], [1, 2, 3])


def test_beam_search_step_and_decode():
    v, beam, end_id = 6, 2, 0

    def build(f):
        pre_ids = f.layers.data(name="pre_ids", shape=[-1, beam],
                                dtype="int64", append_batch_size=False)
        pre_scores = f.layers.data(name="pre_scores", shape=[-1, beam],
                                   dtype="float32", append_batch_size=False)
        scores = f.layers.data(name="scores", shape=[-1, beam, v],
                               dtype="float32", append_batch_size=False)
        return list(f.layers.beam_search(pre_ids, pre_scores, None, scores,
                                         beam_size=beam, end_id=end_id))

    sc = np.full((1, beam, v), -100.0, np.float32)
    sc[0, 0, 3] = -1.0   # best: beam 0 -> token 3
    sc[0, 1, 4] = -2.0   # second: beam 1 -> token 4
    _, (ids, scs, par) = program_pair(build, {
        "pre_ids": np.array([[1, 2]], np.int64),
        "pre_scores": np.array([[-1.0, -2.0]], np.float32), "scores": sc})
    np.testing.assert_array_equal(ids[0], [3, 4])
    np.testing.assert_array_equal(par[0], [0, 1])
    np.testing.assert_allclose(scs[0], [-1.0, -2.0])
    # a finished beam keeps itself: pre_id == end_id
    _, (ids2, scs2, _) = program_pair(build, {
        "pre_ids": np.array([[end_id, 2]], np.int64),
        "pre_scores": np.array([[-0.5, -2.0]], np.float32), "scores": sc})
    assert ids2[0, 0] == end_id
    np.testing.assert_allclose(scs2[0, 0], -0.5)


def test_beam_search_decode_backtrack():
    beam, end_id = 2, 0
    ids = np.array([[[5, 5]], [[6, 7]], [[0, 0]]], np.int64)       # [T,1,W]
    parents = np.array([[[0, 1]], [[0, 0]], [[0, 1]]], np.int64)

    def build(f):
        step_ids = f.layers.data(name="ids", shape=[-1, 1, beam],
                                 dtype="int64", append_batch_size=False)
        step_parents = f.layers.data(name="par", shape=[-1, 1, beam],
                                     dtype="int64", append_batch_size=False)
        scores = f.layers.data(name="sc", shape=[-1, beam],
                               dtype="float32", append_batch_size=False)
        return list(f.layers.beam_search_decode(
            (step_ids, step_parents), scores, beam_size=beam,
            end_id=end_id))

    _, (out, _) = program_pair(build, {
        "ids": ids, "par": parents,
        "sc": np.array([[-1.0, -2.0]], np.float32)})
    np.testing.assert_array_equal(out[0, 0], [5, 6, 0])
    np.testing.assert_array_equal(out[0, 1], [5, 7, 0])


# ---------------------------------------------------------------------------
# tests/test_eval_ops.py's chunk_eval cases
# ---------------------------------------------------------------------------
CHUNK_CASES = {
    # IOB, 2 types: chunks (0-1, t0), (3-4, t1) vs (0-1, t0), (3-3, t1)
    "iob": ("IOB", 2, [[0, 1, 4, 2, 4]], [[0, 1, 4, 2, 3]], (2, 2, 1)),
    "perfect": ("IOB", 2, [[0, 1, 1, 4, 2], [2, 3]],
                [[0, 1, 1, 4, 2], [2, 3]], (3, 3, 3)),
    "ioe": ("IOE", 1, [[0, 1, 2, 0, 1]], [[0, 1, 0, 1, 2]], (2, 2, 1)),
    "iobes": ("IOBES", 1, [[3, 0, 2, 4, 3]], [[3, 0, 1, 2, 4]], (3, 2, 1)),
    "plain": ("plain", 2, [[0, 0, 1, 2, 2, 0]], [[0, 0, 1, 1, 2, 0]],
              (3, 3, 2)),
    "adjacent_iob": ("IOB", 1, [[0, 1, 1]], [[0, 0, 1]], (1, 2, 0)),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_eval_counts(case):
    scheme, types, inf, lab, want = CHUNK_CASES[case]

    def build(f):
        iv = f.layers.data("inf", shape=[1], dtype="int64", lod_level=1)
        lv = f.layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        return list(f.layers.chunk_eval(iv, lv, chunk_scheme=scheme,
                                        num_chunk_types=types))

    def rows(v):
        return seqs([np.asarray(r, np.int64).reshape(-1, 1) for r in v])

    _, got = program_pair(build, {"inf": rows(inf), "lab": rows(lab)})
    p, r, f1, ni, nl, nc = [np.asarray(v).reshape(()) for v in got]
    assert (int(ni), int(nl), int(nc)) == want
    if case == "iob":
        assert abs(p - 0.5) < 1e-6 and abs(r - 0.5) < 1e-6
        assert abs(f1 - 0.5) < 1e-6
    if case == "perfect":
        assert abs(f1 - 1.0) < 1e-6


def test_chunk_eval_rule_with_exclusions_matches_reference():
    tags = S(_ids(21, 7, 4, 6), LENS)
    guess = S(_ids(22, 7, 4, 6), LENS)
    for scheme, types in (("IOB", 3), ("IOE", 3), ("IOBES", 1),
                          ("plain", 6)):
        rule_pair("chunk_eval", {"Inference": [guess], "Label": [tags]},
                  {"chunk_scheme": scheme, "num_chunk_types": types,
                   "excluded_chunk_types": [1]})


# ---------------------------------------------------------------------------
# tests/test_ocr.py
# ---------------------------------------------------------------------------
N_CLASSES, H, W = 3, 8, 16


def _ocr_sample(rng):
    """Two glyphs drawn as bright column bands; label = their classes."""
    img = rng.randn(1, H, W).astype(np.float32) * 0.1
    classes = rng.randint(0, N_CLASSES, 2)
    for k, c in enumerate(classes):
        x0 = 2 + 8 * k
        img[0, 2 * c:2 * c + 2, x0:x0 + 4] = 2.0
    return img, classes.reshape(-1, 1).astype(np.int64)


def test_ocr_ctc_trains_and_decodes():
    """CRNN-CTC from the reference's initial state: the loss falls by
    40% in 25 Adam steps, and the greedy decode gives class ids."""
    from torch_seq_common import build_both, port_scope, reference_state

    def build(f):
        from importlib import import_module
        ocr = import_module(f"{f.__name__}.models.ocr_recognition")
        images = f.layers.data(name="images", shape=[1, H, W],
                               dtype="float32")
        label = f.layers.data(name="label", shape=[1], dtype="int64",
                              lod_level=1)
        loss, decoded = ocr.ctc_train_net(images, label, N_CLASSES,
                                          rnn_hidden=16, conv_filters=(8,))
        f.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        return [loss, decoded]

    progs = build_both(build)
    _, state = reference_state(progs["jax"][1])
    main, _, names, _ = progs["port"]
    scope = port_scope(state)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(25):
        imgs, labs = zip(*[_ocr_sample(rng) for _ in range(8)])
        feed = {"images": np.stack(imgs),
                "label": tfluid.to_sequence_batch(list(labs), np.int64,
                                                  bucket=2)}
        out = exe.run(main, feed=feed, fetch_list=names[:1], scope=scope)
        losses.append(float(out[0].reshape(())))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.6 * losses[0], losses
    imgs, labs = zip(*[_ocr_sample(rng) for _ in range(4)])
    dec = exe.run(main, feed={"images": np.stack(imgs),
                              "label": tfluid.to_sequence_batch(
                                  list(labs), np.int64, bucket=2)},
                  fetch_list=names[1:], scope=scope, mode="test")[0]
    tags = np.asarray(dec.data)
    valid = np.asarray(dec.mask()) > 0
    assert ((tags[valid] >= 0) & (tags[valid] < N_CLASSES)).all()
