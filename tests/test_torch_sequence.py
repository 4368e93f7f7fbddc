"""The sequence core of the torch port against the JAX package: the
sequence op rules on SequenceBatch inputs, the executor's sequence feeds
and fetches (``to_sequence_batch``, ``DataFeeder``, ``create_lod_tensor``,
readers with ``lod_levels``), the lowering's unwrap and rewrap of
SequenceBatch values around dense ops, 2-level LoD, AMP over sequences
and the AOT export of sequence programs.

The cases are the reference's own (tests/test_sequence.py but the
StaticRNN and While cases, the sequence cases of test_seq_grads.py, all
of test_multilevel_lod.py, the lod_tensor cases of test_api_shims.py,
the sequence_reshape cases of test_review_fixes.py, the sequence cases
of test_amp.py and test_aot_export.py), each run through both packages
on the same numpy inputs and compared whole, padded positions included:
forwards rtol 2e-4 / atol 2e-5, gradients (autograd against jax.grad)
rtol 2e-3 / atol 2e-4, integers by value (torch_seq_common.py).
"""
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core.sequence import (SequenceBatch,
                                            to_nested_sequence_batch)
from torch_seq_common import (FWD, S, assert_same, build_both,
                              make_feed, nested, port_scope, program_pair,
                              reference_state, rule_pair, seqs)

torch.set_num_threads(1)

RNG = np.random.RandomState(0)
LENS = np.asarray([3, 5, 1, 0], np.int64)


def _padded(lengths, t, d, seed=0, dtype=np.float32):
    """[B, t, d] random data with garbage (not zeros) in the padding, so
    a rule that reads padding shows it."""
    rng = np.random.RandomState(seed)
    return rng.randn(len(lengths), t, d).astype(dtype)


X1 = S(_padded(LENS, 6, 4), LENS)
X2 = S(_padded([2, 2], 3, 4, seed=1)[:, :, :], [2, 2])
NEST_LENS = np.asarray([[2, 3, 0], [1, 0, 0]], np.int64)
XN = S(np.random.RandomState(2).randn(2, 3, 4, 5).astype(np.float32),
       NEST_LENS, [2, 1])
IDS = S(np.asarray([[[3], [1], [4], [1], [5]], [[9], [2], [6], [0], [0]],
                    [[5], [3], [5], [8], [9]]], np.int64), [5, 3, 4])


# ---------------------------------------------------------------------------
# each op rule against the reference's, on SequenceBatch inputs
# ---------------------------------------------------------------------------
RULE_CASES = {
    **{f"pool-{p}": ("sequence_pool", {"X": [X1]}, {"pooltype": p}, ["X"])
       for p in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")},
    **{f"pool-level2-{p}": ("sequence_pool", {"X": [XN]}, {"pooltype": p},
                            ["X"]) for p in ("SUM", "MAX", "LAST")},
    "first_step": ("sequence_first_step", {"X": [X1]}, {}, ["X"]),
    "last_step": ("sequence_last_step", {"X": [X1]}, {}, ["X"]),
    "first_step-level2": ("sequence_first_step", {"X": [XN]}, {}, ["X"]),
    "last_step-level2": ("sequence_last_step", {"X": [XN]}, {}, ["X"]),
    "softmax": ("sequence_softmax",
                {"X": [S(_padded([3, 5, 1], 6, 1), [3, 5, 1])]}, {}, ["X"]),
    "expand": ("sequence_expand",
               {"X": [RNG.randn(4, 3).astype(np.float32)], "Y": [X1]},
               {}, ["X"]),
    "expand-level2-ref0": ("sequence_expand",
                           {"X": [RNG.randn(2, 4).astype(np.float32)],
                            "Y": [XN]}, {"ref_level": 0}, ["X"]),
    "expand-level2-inner": ("sequence_expand",
                            {"X": [S(RNG.randn(2, 3, 4).astype(np.float32),
                                     [2, 1])], "Y": [XN]},
                            {"ref_level": -1}, ["X"]),
    "conv-3": ("sequence_conv",
               {"X": [X1], "Filter": [RNG.randn(12, 5).astype(np.float32)]},
               {"contextLength": 3, "contextStart": -1}, ["X", "Filter"]),
    "conv-4-start0": ("sequence_conv",
                      {"X": [X1],
                       "Filter": [RNG.randn(16, 2).astype(np.float32)]},
                      {"contextLength": 4, "contextStart": 0},
                      ["X", "Filter"]),
    "reshape-split": ("sequence_reshape", {"X": [X1]}, {"new_dim": 2},
                      ["X"]),
    "reshape-merge-odd": ("sequence_reshape",
                          {"X": [S(_padded([3, 5, 1], 5, 4), [3, 5, 1])]},
                          {"new_dim": 8}, ["X"]),
    "concat-2": ("sequence_concat",
                 {"X": [X1, S(_padded([2, 1, 3, 2], 3, 4, seed=3),
                              [2, 1, 3, 2])]}, {}, ["X"]),
    "concat-3": ("sequence_concat",
                 {"X": [X1, X1, S(_padded([1, 0, 2, 2], 2, 4, seed=4),
                                  [1, 0, 2, 2])]}, {}, ["X"]),
    "slice": ("sequence_slice",
              {"X": [X1], "Offset": [np.asarray([[1], [2], [0], [0]],
                                                np.int64)],
               "Length": [np.asarray([[2], [3], [1], [0]], np.int64)]},
              {}, ["X"]),
    "enumerate": ("sequence_enumerate", {"X": [IDS]},
                  {"win_size": 3, "pad_value": 7}, []),
    "erase": ("sequence_erase", {"X": [IDS]}, {"tokens": [1, 5]}, []),
    "erase-float": ("sequence_erase", {"X": [X1]}, {"tokens": []}, ["X"]),
    "mask": ("sequence_mask", {"X": [X1]},
             {"maxlen": 7, "out_dtype": "float32"}, []),
    "mask-dense": ("sequence_mask", {"X": [LENS]}, {"maxlen": 6}, []),
    "pad": ("sequence_pad", {"X": [X1]}, {}, ["X"]),
    "unpad": ("sequence_unpad", {"X": [X1.data],
                                 "Length": [LENS.reshape(-1, 1)]}, {},
              ["X"]),
    "lod_reset-seq": ("lod_reset", {"X": [X1], "Y": [S(X1.data,
                                                       [6, 1, 2, 3])]},
                      {}, ["X"]),
    "lod_reset-dense": ("lod_reset", {"X": [X1.data],
                                      "Y": [np.asarray([2, 2, 2, 2])]},
                        {}, ["X"]),
    "lod_reset-none": ("lod_reset", {"X": [X1]}, {}, ["X"]),
    "lod_array_length": ("lod_array_length", {"X": [X1.data]}, {}, []),
    "edit_distance": ("edit_distance",
                      {"Hyps": [IDS], "Refs": [S(IDS.data[::-1].copy(),
                                                 [4, 3, 0])]},
                      {"normalized": False}, []),
    "edit_distance-normalized": (
        "edit_distance",
        {"Hyps": [S(IDS.data[:, :, 0], [5, 2, 4])],
         "Refs": [S(IDS.data[:, ::-1, 0].copy(), [3, 3, 5])]},
        {"normalized": True}, []),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_sequence_rule_matches_reference(case):
    op, ins, attrs, grad = RULE_CASES[case]
    rule_pair(op, ins, attrs, grad)


def test_every_sequence_op_is_seq_aware_and_ported():
    """The 16 ops of ops/sequence.py and sequence_mask are registered,
    seq-aware exactly where the reference's are, and each has a rule
    case above."""
    from paddle_tpu.core import registry as jregistry
    ops = {"sequence_pool", "sequence_first_step", "sequence_last_step",
           "sequence_softmax", "sequence_expand", "sequence_conv",
           "sequence_reshape", "sequence_concat", "sequence_slice",
           "sequence_enumerate", "sequence_erase", "sequence_pad",
           "sequence_unpad", "lod_reset", "lod_array_length",
           "edit_distance", "sequence_mask"}
    assert ops == {c[0] for c in RULE_CASES.values()}
    for op in ops:
        assert pt_registry.get_op(op).seq_aware
        assert pt_registry.has_op(op)
    for op in pt_registry.registered_ops():
        assert pt_registry.get_op(op).seq_aware == \
            jregistry.get_op(op).seq_aware, op


def test_sequence_reshape_refuses_dims_that_do_not_divide():
    with pytest.raises(ValueError, match="divide"):
        rule_pair("sequence_reshape", {"X": [X1]}, {"new_dim": 3})


# ---------------------------------------------------------------------------
# tests/test_sequence.py, through both executors
# ---------------------------------------------------------------------------
def test_sequence_pool_types():
    pools = ["sum", "average", "max", "last", "first", "sqrt"]

    def build(f):
        x = f.layers.data(name="x", shape=[3], dtype="float32", lod_level=1)
        return [f.layers.sequence_pool(x, pt) for pt in pools]

    arrs = [np.arange(6).reshape(2, 3), np.arange(3, 12).reshape(3, 3)]
    _, got = program_pair(build, {"x": seqs(arrs, np.float32, 4)})
    vals = dict(zip(pools, got))
    np.testing.assert_allclose(vals["sum"][0], [3, 5, 7])
    np.testing.assert_allclose(vals["average"][1], np.mean(arrs[1], 0))
    np.testing.assert_allclose(vals["max"][1], [9, 10, 11])
    np.testing.assert_allclose(vals["last"][0], [3, 4, 5])
    np.testing.assert_allclose(vals["first"][0], [0, 1, 2])


def test_sequence_softmax_masks_padding():
    def build(f):
        x = f.layers.data(name="x", shape=[1], dtype="float32", lod_level=1)
        return [f.layers.sequence_softmax(x)]

    _, (out,) = program_pair(
        build, {"x": seqs([np.zeros((2, 1)), np.zeros((4, 1))],
                          np.float32, 4)}, return_numpy=False)
    assert isinstance(out, SequenceBatch)
    val = out.data.numpy()
    np.testing.assert_allclose(val[0, :2, 0], [0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(val[0, 2:, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(val[1, :4, 0], 0.25, atol=1e-6)


def test_edit_distance():
    def build(f):
        hyp = f.layers.data(name="hyp", shape=[1], dtype="int64",
                            lod_level=1)
        ref = f.layers.data(name="ref", shape=[1], dtype="int64",
                            lod_level=1)
        return list(f.layers.edit_distance(hyp, ref, normalized=False))

    _, got = program_pair(build, {
        "hyp": seqs([[[1], [2], [3]], [[1], [2]]], np.int64, 4),
        "ref": seqs([[[1], [3]], [[1], [2]]], np.int64, 4)})
    np.testing.assert_allclose(got[0].reshape(-1), [1.0, 0.0])


def test_edit_distance_ignored_tokens():
    def build(f):
        hyp = f.layers.data(name="hyp", shape=[1], dtype="int64",
                            lod_level=1)
        ref = f.layers.data(name="ref", shape=[1], dtype="int64",
                            lod_level=1)
        return list(f.layers.edit_distance(hyp, ref, ignored_tokens=[0]))

    program_pair(build, {
        "hyp": seqs([[[1], [0], [3], [4]], [[0], [2]]], np.int64),
        "ref": seqs([[[1], [3]], [[5], [0], [2]]], np.int64)})


# ---------------------------------------------------------------------------
# tests/test_seq_grads.py's sequence cases: the loss and every
# parameter's gradient through the program, against the reference's
# ---------------------------------------------------------------------------
V, D = 12, 4
GRAD_SEQS = [np.asarray([[1], [3], [7]], np.int64),
             np.asarray([[2], [5]], np.int64),
             np.asarray([[4], [6], [8], [9]], np.int64)]


def _ids_to_emb(f):
    ids = f.layers.data("ids", shape=[1], dtype="int64", lod_level=1)
    return f.layers.embedding(
        ids, size=[V, D],
        param_attr=f.ParamAttr(name="seqgrad_emb",
                               initializer=f.initializer.Normal(0.0, 1.0)))


def _scalar(f, x):
    return f.layers.reduce_sum(x)


def _pool(pool):
    return lambda f: f.layers.tanh(f.layers.sequence_pool(_ids_to_emb(f),
                                                          pool))


def _softmax(f):
    score = f.layers.fc(_ids_to_emb(f), size=1,
                        param_attr=f.ParamAttr(name="seqgrad_w"))
    score.lod_level = 1
    return f.layers.square(f.layers.sequence_softmax(score))


def _expand(f):
    emb = _ids_to_emb(f)
    pooled = f.layers.sequence_pool(emb, "sum")
    return f.layers.tanh(f.layers.sequence_expand(pooled, emb))


def _conv(f):
    return f.layers.tanh(f.layers.sequence_conv(
        _ids_to_emb(f), num_filters=3, filter_size=3,
        param_attr=f.ParamAttr(name="seqconv_w",
                               initializer=f.initializer.Normal(0.0, 1.0))))


def _pad(f):
    padded, _ = f.layers.sequence_pad(_ids_to_emb(f))
    return f.layers.tanh(padded)


def _pad_unpad(f):
    padded, length = f.layers.sequence_pad(_ids_to_emb(f))
    return f.layers.tanh(f.layers.sequence_unpad(padded, length))


def _slice(f):
    emb = _ids_to_emb(f)
    off = f.layers.fill_constant([3, 1], "int64", 0)
    ln = f.layers.fill_constant([3, 1], "int64", 2)
    return f.layers.tanh(f.layers.sequence_slice(emb, off, ln))


GRAD_CASES = {
    **{f"pool-{p}": _pool(p) for p in ("sum", "average", "sqrt", "max",
                                       "last", "first")},
    "softmax": _softmax,
    "first_step": lambda f: f.layers.tanh(
        f.layers.sequence_first_step(_ids_to_emb(f))),
    "last_step": lambda f: f.layers.tanh(
        f.layers.sequence_last_step(_ids_to_emb(f))),
    "expand": _expand,
    "conv": _conv,
    "pad": _pad,
    "pad_unpad": _pad_unpad,
    "reshape": lambda f: f.layers.tanh(
        f.layers.sequence_reshape(_ids_to_emb(f), D // 2)),
    "concat": lambda f: f.layers.tanh(f.layers.sequence_concat(
        [_ids_to_emb(f)] * 2)),
    "slice": _slice,
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_sequence_layer_gradients_match_reference(case):
    def build(f):
        out = GRAD_CASES[case](f)
        return [_scalar(f, out), out]

    program_pair(build, {"ids": seqs(GRAD_SEQS)}, grads=True)


# ---------------------------------------------------------------------------
# tests/test_multilevel_lod.py
# ---------------------------------------------------------------------------
def test_create_lod_tensor_two_level_reference_example():
    data = np.arange(7, dtype=np.int64).reshape(7, 1)
    t = tfluid.create_lod_tensor(data, [[2, 1], [2, 2, 3]])
    want = jfluid.create_lod_tensor(data, [[2, 1], [2, 2, 3]])
    assert_same(t, want)
    assert t.lod_level == 2
    assert tuple(t.data.shape[:2]) == (2, 2)
    np.testing.assert_array_equal(t.lengths.numpy(), [[2, 2], [3, 0]])
    np.testing.assert_array_equal(t.sub_counts().numpy(), [2, 1])
    np.testing.assert_array_equal(t.data.numpy()[0, 0, :2, 0], [0, 1])
    np.testing.assert_array_equal(t.data.numpy()[0, 1, :2, 0], [2, 3])
    np.testing.assert_array_equal(t.data.numpy()[1, 0, :3, 0], [4, 5, 6])


def test_create_lod_tensor_three_levels_rejected():
    for f in (jfluid, tfluid):
        with pytest.raises(NotImplementedError, match="2 levels"):
            f.create_lod_tensor(np.zeros((4, 1), np.int64),
                                [[1, 1], [2], [2, 2]])


def _nested_float():
    rng = np.random.RandomState(0)
    return [[rng.randn(2, 4).astype(np.float32),
             rng.randn(3, 4).astype(np.float32)],
            [rng.randn(1, 4).astype(np.float32)]]


def test_two_level_sequence_pool_pools_innermost_level():
    nest = _nested_float()

    def build(f):
        x = f.layers.data("x", shape=[-1, 4], dtype="float32", lod_level=2,
                          append_batch_size=False)
        sent = f.layers.sequence_pool(x, "sum")
        return [sent, f.layers.sequence_pool(sent, "sum")]

    _, (sent, doc) = program_pair(build, {"x": nested(nest)})
    want_sent = [[s.sum(0) for s in outer] for outer in nest]
    np.testing.assert_allclose(sent.data[0, 0], want_sent[0][0], rtol=1e-5)
    np.testing.assert_allclose(sent.data[0, 1], want_sent[0][1], rtol=1e-5)
    np.testing.assert_allclose(sent.data[1, 0], want_sent[1][0], rtol=1e-5)
    np.testing.assert_array_equal(sent.lengths, [2, 1])
    np.testing.assert_allclose(doc, np.stack([sum(ws) for ws in want_sent]),
                               rtol=1e-5, atol=1e-6)


def test_two_level_first_last_step():
    nest = _nested_float()

    def build(f):
        x = f.layers.data("x", shape=[-1, 4], dtype="float32", lod_level=2,
                          append_batch_size=False)
        return [f.layers.sequence_pool(f.layers.sequence_first_step(x),
                                       "sum"),
                f.layers.sequence_pool(f.layers.sequence_last_step(x),
                                       "sum")]

    _, (first, last) = program_pair(build, {"x": nested(nest)})
    np.testing.assert_allclose(
        first, np.stack([sum(s[0] for s in o) for o in nest]), rtol=1e-5)
    np.testing.assert_allclose(
        last, np.stack([sum(s[-1] for s in o) for o in nest]), rtol=1e-5)


def test_sequence_expand_ref_level_0():
    def build(f):
        x = f.layers.data("x", shape=[-1, 2], dtype="float32",
                          append_batch_size=False)
        y = f.layers.data("y", shape=[-1, 4], dtype="float32", lod_level=2,
                          append_batch_size=False)
        ex = f.layers.sequence_expand(x, y, ref_level=0)
        return [f.layers.sequence_pool(ex, "sum")]

    _, (out,) = program_pair(build, {
        "x": np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32),
        "y": nested(_nested_float())})
    np.testing.assert_allclose(out, [[2.0, 4.0], [3.0, 4.0]], rtol=1e-5)


def test_sequence_expand_ref_level_inner():
    nest = _nested_float()

    def build(f):
        y = f.layers.data("y", shape=[-1, 4], dtype="float32", lod_level=2,
                          append_batch_size=False)
        sent = f.layers.sequence_pool(y, "average")
        ex = f.layers.sequence_expand(sent, y, ref_level=-1)
        sq = f.layers.square(f.layers.elementwise_sub(y, ex))
        inner = f.layers.sequence_pool(sq, "sum")
        return [f.layers.reduce_sum(f.layers.sequence_pool(inner, "sum"))]

    _, (out,) = program_pair(build, {"y": nested(nest)})
    want = sum(((s - s.mean(0, keepdims=True)) ** 2).sum()
               for outer in nest for s in outer)
    assert abs(float(np.asarray(out).reshape(())) - want) < 1e-3


def test_data_feeder_level2():
    rows = [([[1, 2], [3]],), ([[4]],)]
    progs = build_both(lambda f: [f.layers.sequence_pool(
        f.layers.sequence_pool(f.layers.embedding(
            f.layers.data("x", shape=[1], dtype="int64", lod_level=2),
            size=[10, 3]), "sum"), "sum")])
    outs = {}
    _, state = reference_state(progs["jax"][1])
    for which, f in (("jax", jfluid), ("port", tfluid)):
        main, _, names, _ = progs[which]
        feed = f.DataFeeder(feed_list=["x"], place=f.CPUPlace(),
                            program=main).feed(rows)
        assert feed["x"].lod_level == 2
        scope = port_scope(state) if which == "port" else \
            reference_state(progs["jax"][1])[0]
        outs[which] = f.Executor(f.CPUPlace()).run(
            main, feed=feed, fetch_list=names, scope=scope)[0]
    assert outs["port"].shape == (2, 3)
    assert_same(outs["port"], outs["jax"])


def test_zero_length_subsequence_distinct_from_padding():
    data = np.arange(5, dtype=np.int64).reshape(5, 1)
    lod = [[2, 1], [0, 2, 3]]
    t = tfluid.create_lod_tensor(data, lod)
    np.testing.assert_array_equal(t.sub_counts().numpy(), [2, 1])
    np.testing.assert_array_equal(t.lengths.numpy(), [[0, 2], [3, 0]])

    def build(f):
        x = f.layers.data("x", shape=[1], dtype="int64", lod_level=2)
        sent = f.layers.sequence_pool(f.layers.embedding(x, size=[10, 3]),
                                      "sum")
        return [sent, f.layers.sequence_last_step(sent)]

    progs = build_both(build)
    jscope, state = reference_state(progs["jax"][1])
    jout = jfluid.Executor(jfluid.CPUPlace()).run(
        progs["jax"][0], feed={"x": jfluid.create_lod_tensor(data, lod)},
        fetch_list=progs["jax"][2], scope=jscope)
    tout = tfluid.Executor(tfluid.CPUPlace()).run(
        progs["port"][0], feed={"x": t}, fetch_list=progs["port"][2],
        scope=port_scope(state))
    for a, b in zip(tout, jout):
        assert_same(a, b)
    np.testing.assert_array_equal(tout[0].lengths, [2, 1])
    assert tout[1].shape == (2, 3) and np.abs(tout[1][0]).sum() > 0


# ---------------------------------------------------------------------------
# tests/test_api_shims.py's lod_tensor cases
# ---------------------------------------------------------------------------
def test_create_lod_tensor_from_array_and_list():
    flat = np.arange(10, dtype=np.float32).reshape(5, 2)
    sb = tfluid.create_lod_tensor(flat, [[2, 3]])
    assert isinstance(sb, SequenceBatch)
    assert_same(sb, jfluid.create_lod_tensor(flat, [[2, 3]]))
    assert list(sb.lengths.numpy()) == [2, 3]
    np.testing.assert_array_equal(sb.data.numpy()[0, :2], flat[:2])
    np.testing.assert_array_equal(sb.data.numpy()[1, :3], flat[2:])
    sb2 = tfluid.create_lod_tensor([[1, 2], [3, 4, 5]], [[2, 3]])
    assert_same(sb2, jfluid.create_lod_tensor([[1, 2], [3, 4, 5]],
                                              [[2, 3]]))
    assert sb2.data.shape[-1] == 1 and sb2.data.dtype == torch.int64
    with pytest.raises(ValueError):
        tfluid.create_lod_tensor(flat, [[2, 2]])
    nest = tfluid.create_lod_tensor(flat, [[1, 1], [2, 3]])
    assert nest.lod_level == 2
    np.testing.assert_array_equal(nest.sub_counts().numpy(), [1, 1])
    # re-lodding a level-1 batch
    assert_same(tfluid.create_lod_tensor(sb, [[1, 4]]),
                jfluid.create_lod_tensor(jfluid.create_lod_tensor(
                    flat, [[2, 3]]), [[1, 4]]))


def test_create_random_int_lodtensor_feeds_a_program():
    np.random.seed(5)
    sb = tfluid.create_random_int_lodtensor([[3, 5, 2]], [1], low=0, high=9)
    np.random.seed(5)
    want = jfluid.create_random_int_lodtensor([[3, 5, 2]], [1], low=0,
                                              high=9)
    assert_same(sb, want)
    assert list(sb.lengths.numpy()) == [3, 5, 2]
    assert sb.data.min() >= 0 and sb.data.max() <= 9

    def build(f):
        w = f.layers.data(name="w", shape=[1], dtype="int64", lod_level=1)
        emb = f.layers.embedding(input=w, size=[10, 4])
        return [f.layers.sequence_pool(input=emb, pool_type="sum")]

    progs = build_both(build)
    jscope, state = reference_state(progs["jax"][1])
    a = tfluid.Executor(tfluid.CPUPlace()).run(
        progs["port"][0], feed={"w": sb}, fetch_list=progs["port"][2],
        scope=port_scope(state))[0]
    b = jfluid.Executor(jfluid.CPUPlace()).run(
        progs["jax"][0], feed={"w": want}, fetch_list=progs["jax"][2],
        scope=jscope)[0]
    assert a.shape == (3, 4)
    assert_same(a, b)


# ---------------------------------------------------------------------------
# tests/test_review_fixes.py's sequence_reshape cases
# ---------------------------------------------------------------------------
def test_sequence_reshape_merge_and_split():
    def build(f):
        x = f.layers.data(name="x", shape=[4], dtype="float32", lod_level=1)
        return [f.layers.sequence_reshape(x, new_dim=2),
                f.layers.sequence_reshape(x, new_dim=8)]

    _, (s, m) = program_pair(build, {"x": seqs(
        [np.arange(8, dtype=np.float32).reshape(2, 4),
         np.arange(16, dtype=np.float32).reshape(4, 4)])})
    assert s.lengths[0] == 4
    np.testing.assert_allclose(s.data[0, :4].reshape(-1), np.arange(8))
    assert m.lengths[1] == 2
    np.testing.assert_allclose(m.data[1, :2].reshape(-1), np.arange(16))


def test_sequence_reshape_bad_dims():
    progs = build_both(lambda f: [f.layers.sequence_reshape(
        f.layers.data(name="x", shape=[5], dtype="float32", lod_level=1),
        new_dim=2)])
    main, startup, names, _ = progs["port"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError):
        exe.run(main, feed={"x": tfluid.to_sequence_batch(
            [np.zeros((2, 5), np.float32)])}, fetch_list=names, scope=scope)


# ---------------------------------------------------------------------------
# the executor and lowering around sequences
# ---------------------------------------------------------------------------
def test_dense_ops_unwrap_and_rewrap_by_the_declared_lod_level():
    """A dense op (fc's bias add, concat, elementwise) gets the padded
    data; its output is a SequenceBatch again exactly where its variable
    has lod_level > 0 — so sequence_pool after it is masked, the padding
    values are the reference's, and a dense var stays dense."""
    def build(f):
        x = f.layers.data("x", shape=[3], dtype="float32", lod_level=1)
        h = f.layers.fc(x, size=5, act="relu")           # lod 1
        c = f.layers.concat([h, x], axis=-1)             # lod 1
        c2 = f.layers.elementwise_mul(c, c)
        dense = f.layers.reduce_mean(c2)                 # lod 0
        return [h, c, c2, f.layers.sequence_pool(c2, "max"), dense]

    arrs = [np.random.RandomState(i).randn(n, 3).astype(np.float32)
            for i, n in enumerate((2, 5, 3))]
    _, got = program_pair(build, {"x": seqs(arrs)}, return_numpy=False)
    assert [isinstance(g, SequenceBatch) for g in got] == \
        [True, True, True, False, False]
    np.testing.assert_array_equal(got[0].lengths.numpy(), [2, 5, 3])


def test_fetch_returns_sequences_with_numpy_leaves():
    progs = build_both(lambda f: [f.layers.embedding(
        f.layers.data("w", shape=[1], dtype="int64", lod_level=1),
        size=[10, 2])])
    main, startup, names, _ = progs["port"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"w": tfluid.to_sequence_batch([[[1], [2]], [[3]]])}
    out = exe.run(main, feed=feed, fetch_list=names, scope=scope)[0]
    assert isinstance(out, SequenceBatch)
    assert isinstance(out.data, np.ndarray) and out.data.shape == (2, 8, 2)
    np.testing.assert_array_equal(out.lengths, [2, 1])
    out = exe.run(main, feed=feed, fetch_list=names, scope=scope,
                  return_numpy=False)[0]
    assert isinstance(out.data, torch.Tensor)


def test_each_padded_length_is_its_own_step_signature():
    """The step-build count grows once per padded length (the
    reference's retrace), not per batch of the same geometry."""
    progs = build_both(lambda f: [f.layers.sequence_pool(
        f.layers.embedding(f.layers.data("w", shape=[1], dtype="int64",
                                         lod_level=1), size=[10, 2]),
        "sum")])
    main, startup, names, _ = progs["port"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    before = exe.total_compiles()
    for lens in ((2, 3), (1, 7), (9, 2), (12, 1)):
        exe.run(main, feed={"w": tfluid.to_sequence_batch(
            [np.ones((n, 1), np.int64) for n in lens])},
            fetch_list=names, scope=scope)
    # padded lengths 8, 8, 16, 16
    assert exe.total_compiles() - before == 2


def test_duck_typed_sequence_feed():
    """Any value with .data and .lengths feeds a sequence (numpy leaves
    here), as the reference's CompiledPredictor accepts."""
    class Seq:
        data = np.asarray([[[1], [2], [0]], [[3], [0], [0]]], np.int64)
        lengths = np.asarray([2, 1], np.int32)

    progs = build_both(lambda f: [f.layers.sequence_pool(
        f.layers.embedding(f.layers.data("w", shape=[1], dtype="int64",
                                         lod_level=1), size=[10, 2]),
        "sum")])
    _, state = reference_state(progs["jax"][1])
    main, _, names, _ = progs["port"]
    a = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"w": Seq()}, fetch_list=names, scope=port_scope(state))
    b = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"w": tfluid.to_sequence_batch([[[1], [2]], [[3]]],
                                                  bucket=3)},
        fetch_list=names, scope=port_scope(state))
    np.testing.assert_array_equal(a[0], b[0])


def test_readers_with_lod_levels_feed_sequences():
    rows = [(np.asarray([[1], [2], [3]], np.int64),
             np.asarray([1], np.int64)),
            (np.asarray([[4]], np.int64), np.asarray([0], np.int64))]
    outs = {}
    for which, f in (("jax", jfluid), ("port", tfluid)):
        main, startup = f.Program(), f.Program()
        with f.unique_name.guard(), f.program_guard(main, startup):
            reader = f.layers.py_reader(capacity=2,
                                        shapes=[[-1, 1], [-1, 1]],
                                        dtypes=["int64", "int64"],
                                        lod_levels=[1, 0])
            words, label = f.layers.read_file(reader)
            emb = f.layers.embedding(words, size=[10, 3],
                                     param_attr=f.ParamAttr(
                                         name="emb",
                                         initializer=f.initializer.Constant(
                                             0.5)))
            pooled = f.layers.sequence_pool(emb, "sum")
        reader.decorate_paddle_reader(lambda: iter([rows]))
        exe = f.Executor(f.CPUPlace())
        scope = f.Scope()
        exe.run(startup, scope=scope)
        reader.start()
        outs[which] = exe.run(main, fetch_list=[pooled, label],
                              scope=scope)
    for a, b in zip(outs["port"], outs["jax"]):
        assert_same(a, b)
    np.testing.assert_allclose(outs["port"][0], [[1.5] * 3, [0.5] * 3])


def test_data_feeder_level1_and_dense():
    rows = [([1, 2, 3], [0.5]), ([4], [1.5])]
    feeds = {}
    for which, f in (("jax", jfluid), ("port", tfluid)):
        main = f.Program()
        with f.unique_name.guard(), f.program_guard(main, f.Program()):
            w = f.layers.data("w", shape=[1], dtype="int64", lod_level=1)
            y = f.layers.data("y", shape=[1], dtype="float32")
        feeds[which] = f.DataFeeder([w, y], program=main).feed(rows)
    assert isinstance(feeds["port"]["w"], SequenceBatch)
    assert_same(feeds["port"]["w"], feeds["jax"]["w"])
    np.testing.assert_array_equal(feeds["port"]["y"], feeds["jax"]["y"])


def test_nested_sequence_batch_matches_reference():
    from paddle_tpu.core.sequence import to_nested_sequence_batch as jnest
    nest = [[[1, 2], [3]], [[4, 5, 6]], [[], [7]]]
    assert_same(to_nested_sequence_batch(nest, np.int64),
                jnest(nest, np.int64))
    with pytest.raises(ValueError, match="list of lists"):
        to_nested_sequence_batch([np.zeros(3)])


# ---------------------------------------------------------------------------
# tests/test_amp.py's sequence cases
# ---------------------------------------------------------------------------
def test_amp_cast_handles_sequence_batch():
    from paddle_tpu_torch.core.lowering import _cast_all
    sb = SequenceBatch(torch.ones((2, 3, 4)), torch.tensor([3, 2]))
    out = _cast_all({"X": [sb]}, torch.float32, torch.bfloat16)["X"][0]
    assert isinstance(out, SequenceBatch)
    assert out.data.dtype == torch.bfloat16
    assert out.lengths is sb.lengths
    assert _cast_all({"X": sb}, torch.bfloat16, torch.float32)["X"][0] is sb


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_on_sequence_model_trains(level):
    """AMP O1/O2 over embedding → fc → dynamic_lstm → sequence_pool:
    losses finite and falling over 6 steps, and the first loss equal to
    the reference's under the same AMP within a bf16 tier (rtol 2e-2)."""
    words_ = [[1, 4, 2, 7], [3, 5], [6, 1, 2]]
    labels = np.array([[0], [1], [0]], np.int64)

    def build(f):
        words = f.layers.data("words", [1], dtype="int64", lod_level=1)
        label = f.layers.data("label", [1], dtype="int64")
        emb = f.layers.embedding(input=words, size=[16, 8])
        fc = f.layers.fc(input=emb, size=16)
        lstm, _ = f.layers.dynamic_lstm(input=fc, size=16)
        pooled = f.layers.sequence_pool(input=lstm, pool_type="max")
        pred = f.layers.fc(input=pooled, size=2, act="softmax")
        loss = f.layers.mean(f.layers.cross_entropy(input=pred,
                                                    label=label))
        f.optimizer.Adam(learning_rate=0.05).minimize(loss)
        return [loss]

    progs = build_both(build)
    from paddle_tpu.transpiler.amp import amp_transpile as jamp
    jamp(progs["jax"][0], level=level)
    tfluid.transpiler.amp_transpile(progs["port"][0], level=level)
    jscope, state = reference_state(progs["jax"][1])
    tscope = port_scope(state)
    feed = {"words": seqs([np.asarray(s, np.int64).reshape(-1, 1)
                           for s in words_]), "label": labels}
    want = float(np.asarray(jfluid.Executor(jfluid.CPUPlace()).run(
        progs["jax"][0], feed=make_feed("jax", feed),
        fetch_list=progs["jax"][2], scope=jscope)[0]).reshape(()))
    exe = tfluid.Executor(tfluid.CPUPlace())
    ls = [float(np.asarray(exe.run(progs["port"][0],
                                   feed=make_feed("port", feed),
                                   fetch_list=progs["port"][2],
                                   scope=tscope)[0]).reshape(()))
          for _ in range(6)]
    assert all(np.isfinite(ls)), (level, ls)
    assert ls[-1] < ls[0], (level, ls)
    np.testing.assert_allclose(ls[0], want, rtol=2e-2)


# ---------------------------------------------------------------------------
# tests/test_aot_export.py's sequence cases
# ---------------------------------------------------------------------------
def _seq_conv_model(f):
    words = f.layers.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
    emb = f.layers.embedding(input=words, size=[100, 16])
    conv = f.nets.sequence_conv_pool(emb, num_filters=8, filter_size=3,
                                     act="tanh", pool_type="sum")
    return [f.layers.fc(conv, size=3, act="softmax")]


def _words(rng, lens):
    return [rng.randint(1, 100, (n, 1)).astype(np.int64) for n in lens]


def _saved(tmp_path, build, name, **save_kw):
    from paddle_tpu_torch.io import load_compiled_predictor
    progs = build_both(build)
    _, state = reference_state(progs["jax"][1])
    main, _, names, _ = progs["port"]
    scope = port_scope(state)
    exe = tfluid.Executor(tfluid.CPUPlace())
    d = str(tmp_path / name)
    with tfluid.scope_guard(scope), warnings.catch_warnings():
        warnings.simplefilter("error")       # no silent fallback
        tfluid.io.save_inference_model(d, ["words"], [names[0]], exe,
                                       main, **save_kw)
    assert os.path.exists(os.path.join(d, "__compiled__.pt2"))
    return (main, names, scope, exe,
            load_compiled_predictor(d, device="cpu"))


def test_aot_exports_sequence_program(tmp_path):
    """A sequence program exports with batch AND padded length
    symbolic (the reference's contract): one artifact serves any
    geometry, fed a SequenceBatch, a (data, lengths) tuple or a dict."""
    main, names, scope, exe, pred = _saved(tmp_path, _seq_conv_model, "sc")
    rng = np.random.RandomState(0)
    for lens in ((5, 3, 7), (2, 9, 4, 6, 1), (17,)):
        sb = tfluid.to_sequence_batch(_words(rng, lens))
        ref = exe.run(main, feed={"words": sb}, fetch_list=names,
                      scope=scope, mode="test")[0]
        np.testing.assert_allclose(pred.run({"words": sb})[0], ref, **FWD)
        np.testing.assert_allclose(
            pred.run({"words": (sb.data.numpy(), sb.lengths.numpy())})[0],
            ref, **FWD)
        np.testing.assert_allclose(
            pred.run({"words": {"data": sb.data.numpy(),
                                "lengths": sb.lengths.numpy()}})[0],
            ref, **FWD)
        # rows of ids without the trailing unit dim (DataFeeder's form)
        np.testing.assert_allclose(
            pred.run({"words": (sb.data.numpy()[..., 0],
                                sb.lengths.numpy())})[0], ref, **FWD)
    with pytest.raises(TypeError, match="sequence feed"):
        pred.run({"words": sb.data.numpy()})


def _seq_crf_cost_model(f):
    """linear_chain_crf's cost of tagging each word with its own id."""
    words = f.layers.data(name="words", shape=[1], dtype="int64",
                          lod_level=1)
    emb = f.layers.embedding(input=words, size=[100, 8])
    return [f.layers.linear_chain_crf(
        input=f.layers.fc(emb, size=100), label=words,
        param_attr=f.ParamAttr(name="crfw"))]


def test_aot_recurrent_program_exports_at_its_fixed_length(tmp_path):
    """F14, narrowed: the recurrences export with the padded length a
    symbol (test_torch_aot_recurrent.py), but an op that still loops
    over the padded axis on the host (linear_chain_crf's forward
    algorithm) fixes it. Such a program exports at the largest padded
    length its serving buckets declare for the feed; the predictor
    serves it there, equal to the executor, and refuses any other padded
    length by name; with no declared length the export raises naming
    F14 and the op."""
    spec = tfluid.serving.BucketSpec(batch_sizes=(1, 4),
                                     seq_lens={"words": (8, 16)})
    main, names, scope, exe, pred = _saved(
        tmp_path, _seq_crf_cost_model, "crf", serving_buckets=spec)
    rng = np.random.RandomState(1)
    for lens in ((5, 3, 7), (16, 2)):
        sb = tfluid.to_sequence_batch(_words(rng, lens), max_len=16)
        ref = exe.run(main, feed={"words": sb}, fetch_list=names,
                      scope=scope, mode="test")[0]
        np.testing.assert_allclose(pred.run({"words": sb})[0], ref, **FWD)
    sb = tfluid.to_sequence_batch(_words(rng, (5, 3)))        # padded 8
    with pytest.raises(ValueError, match="F14"):
        pred.run({"words": sb})
    # with no declared length there is nothing to export at
    from paddle_tpu_torch.io.aot import export_compiled
    with pytest.raises(ValueError, match="'linear_chain_crf'.*F14"):
        export_compiled(str(tmp_path / "none"), main, ["words"], names,
                        scope, torch.device("cpu"))


def test_aot_exports_two_level_lod_program(tmp_path):
    from paddle_tpu_torch.io import load_compiled_predictor

    def build(f):
        x = f.layers.data(name="x", shape=[4], dtype="float32", lod_level=2)
        sent = f.layers.sequence_pool(x, "sum")
        return [f.layers.fc(f.layers.sequence_pool(sent, "sum"), size=2)]

    progs = build_both(build)
    _, state = reference_state(progs["jax"][1])
    main, _, names, _ = progs["port"]
    scope = port_scope(state)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(2)
    nest = [[rng.randn(t, 4).astype(np.float32) for t in ts]
            for ts in ((3, 2), (4,), (1, 2, 5))]
    sb = to_nested_sequence_batch(nest)
    d = str(tmp_path / "lod2")
    with tfluid.scope_guard(scope), warnings.catch_warnings():
        warnings.simplefilter("error")
        tfluid.io.save_inference_model(d, ["x"], [names[0]], exe, main)
    ref = exe.run(main, feed={"x": sb}, fetch_list=names, scope=scope,
                  mode="test")[0]
    pred = load_compiled_predictor(d, device="cpu")
    np.testing.assert_allclose(pred.run({"x": sb})[0], ref, **FWD)
    with pytest.raises(TypeError, match="outer_counts"):
        pred.run({"x": (sb.data.numpy(), sb.lengths.numpy())})


# ---------------------------------------------------------------------------
# the passes and the mesh around sequences
# ---------------------------------------------------------------------------
def test_lod_value_never_joins():
    """tests/test_layout.py's case: the layout pass never moves a value
    with lod_level > 0 into an NHWC region (its padded axis is not an
    image axis), in either package."""
    from paddle_tpu.analysis.layout import FIXED as JFIXED
    from paddle_tpu.analysis.layout import analyze_layout as janalyze
    from paddle_tpu_torch.analysis.layout import FIXED, analyze_layout
    for f, analyze, fixed in ((jfluid, janalyze, JFIXED),
                              (tfluid, analyze_layout, FIXED)):
        main = f.Program()
        with f.unique_name.guard(), f.program_guard(main, f.Program()):
            img = f.layers.data(name="img", shape=[1, 16, 16],
                                dtype="float32")
            y = f.layers.conv2d(input=img, num_filters=8, filter_size=3,
                                bias_attr=False)
            gb = main.global_block()
            gb.create_var(name="seqish", dtype="float32", lod_level=1)
            gb.append_op("relu", inputs={"X": [y.name]},
                         outputs={"Out": ["seqish"]})
        plan = analyze(main, fetch_list=["seqish"])
        assert all("seqish" not in r.values for r in plan.regions)
        assert plan.value_layout.get("seqish") == fixed


def test_parallel_executor_refuses_sequence_feeds():
    """A sequence feed under a device mesh raises — its rows would shard
    over 'dp' apart from its lengths — rather than running mis-sharded
    (the reference's ParallelExecutor stages every feed as one dense
    array and takes no sequence either)."""
    import torch.distributed as dist
    from paddle_tpu_torch import parallel
    fresh = not dist.is_initialized()
    try:
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                              startup):
            w = tfluid.layers.data("w", shape=[1], dtype="int64",
                                   lod_level=1)
            loss = tfluid.layers.mean(tfluid.layers.sequence_pool(
                tfluid.layers.embedding(w, size=[10, 2]), "sum"))
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
        pe = tfluid.ParallelExecutor(
            loss_name=loss.name, main_program=main, scope=scope,
            mesh=parallel.make_mesh({"dp": 1}, place=tfluid.CPUPlace()))
        with pytest.raises(NotImplementedError,
                           match="takes no sequence feed"):
            pe.run([loss.name], feed={"w": tfluid.to_sequence_batch(
                [[[1], [2]], [[3]]])})
    finally:
        if fresh and dist.is_initialized():
            dist.destroy_process_group()
