"""Each op rule the torch port registers, against the JAX package's rule
for the same op on the same inputs (made from a seed with numpy).

f32 tolerance rtol/atol 1e-5 unless stated (elementwise math in the same
order; matmuls and reductions may sum in another order). Integer outputs
compare by value: the port emits int64 where the reference's
canonical_int() is int32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops.pallas_attention as pa
from paddle_tpu.core import lowering as jax_lowering
from paddle_tpu.core import registry as jax_registry
import paddle_tpu_torch  # noqa: F401  (registers the port's rules)
from paddle_tpu_torch.core import lowering as pt_lowering
from paddle_tpu_torch.core import registry as pt_registry

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _run_both(op_type, ins, attrs):
    """Run ``op_type``'s rule in both packages on numpy inputs; return
    ({slot: [np]} jax, {slot: [np]} torch)."""
    jctx = jax_lowering.LoweringContext(None, "test", jax.random.PRNGKey(0))
    tctx = pt_lowering.LoweringContext(None, "test", torch.device("cpu"),
                                       0, 1)
    jout = jax_registry.get_op(op_type).lower(
        jctx, {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs))
    tout = pt_registry.get_op(op_type).lower(
        tctx, {s: [torch.from_numpy(np.asarray(a)) for a in v]
               for s, v in ins.items()}, dict(attrs))
    to_np = lambda t: t.float().numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()                                     # noqa: E731
    return ({s: [np.asarray(jnp.asarray(a, jnp.float32)
                            if a.dtype == jnp.bfloat16 else a)
                 for a in v] for s, v in jout.items()},
            {s: [to_np(a) for a in v] for s, v in tout.items()})


def _rng(seed):
    return np.random.RandomState(seed)


def _assert_same(jout, tout, **tol):
    assert set(jout) == set(tout)
    for slot in jout:
        for a, b in zip(jout[slot], tout[slot]):
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            np.testing.assert_allclose(b, a, **(tol or TOL))


OPTIMIZER_RULES = {"sgd", "momentum", "adam", "adamax", "adagrad",
                   "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
                   "proximal_gd", "proximal_adagrad"}
# the Llama train and serve paths, their startups and the
# optimizers' helper ops
LLAMA_SLICES = {"fill_constant", "uniform_random", "gaussian_random",
                "cast", "mul", "elementwise_add", "elementwise_mul",
                "elementwise_div", "elementwise_max", "scale", "sum", "mean",
                "sqrt", "sign", "softmax", "clip", "clip_by_norm",
                "increment", "reshape", "reshape2", "lookup_table",
                "cross_entropy", "softmax_with_cross_entropy",
                "squared_l2_norm", "rms_norm", "rope", "multihead_attention",
                "silu", "llama_decoder_stack", "fused_head_cross_entropy"}
# ROADMAP item 1b: the rest of ops/basic.py but load and the
# fused rewrite ops, ops/nn.py but conv/pool/batch_norm/lrn/interp/
# roi_pool/random_crop and the sequence-model ops, and sequence_mask
BASIC_REST = {
    "fill_constant_batch_size_like", "fill_zeros_like", "assign",
    "assign_value", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "truncated_gaussian_random",
    "sampling_id", "shape", "matmul", "elementwise_sub", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "relu", "sigmoid", "logsigmoid", "tanh", "tanh_shrink", "exp", "log",
    "rsqrt", "abs", "square", "reciprocal", "floor", "ceil", "round",
    "sin", "cos", "softplus", "softsign", "softshrink", "hard_shrink",
    "thresholded_relu", "relu6", "elu", "leaky_relu", "gelu", "swish",
    "stanh", "brelu", "soft_relu", "hard_sigmoid", "pow", "mish",
    "logical_not", "prelu", "maxout", "log_softmax", "reduce_sum",
    "reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "cumsum",
    "squeeze", "unsqueeze", "transpose", "transpose2", "flatten",
    "concat", "split", "stack", "unstack", "slice", "strided_slice",
    "expand", "reverse", "gather", "scatter", "gather_nd", "pad", "pad2d",
    "crop", "one_hot", "multiplex", "arg_max", "arg_min", "argsort",
    "top_k", "norm", "isfinite", "cos_sim", "dot",
    "bilinear_tensor_product", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal", "not_equal", "logical_and", "logical_or",
    "logical_xor"}
NN_REST = {"layer_norm", "group_norm", "dropout",
           "sigmoid_cross_entropy_with_logits", "square_error_cost",
           "smooth_l1_loss", "huber_loss", "rank_loss", "margin_rank_loss",
           "hinge_loss", "log_loss", "kldiv_loss", "dice_loss",
           "label_smooth", "l1_norm", "squared_l2_distance", "mean_iou",
           "accuracy", "auc", "scaled_dot_product_attention"}
# ROADMAP item 2: the optimize pass's fused chain
REWRITE = {"fused_elementwise"}
# ROADMAP item 3: IO, persistables and Inferencer
IO = {"load"}
# ROADMAP item 4a: the fused KV-cache generators
GENERATE = {"llama_generate", "llama_spec_generate"}
# ROADMAP item 4b: the paged decode engine's step ops
PAGED = {"llama_paged_prefill", "llama_paged_prefill_chunk",
         "llama_paged_decode", "llama_paged_spec_step"}
# ROADMAP item 5: conv nets and the transpilers
CONV = {"conv2d", "depthwise_conv2d", "conv2d_transpose", "conv3d",
        "conv3d_transpose", "pool2d", "pool3d", "batch_norm", "lrn",
        "bilinear_interp", "nearest_interp", "roi_pool", "random_crop",
        "flatten_concat", "fused_param_split", "quantized_mul",
        "quantized_conv2d"}
# ROADMAP items 6a and 6b: the MoE FFN, the 1F1B pipelined loss
MESH = {"moe_ffn", "llama_stack_1f1b_loss"}
# ROADMAP item 7a: ops/sequence.py's 16 waiting ops, and ops/rnn.py's
# four recurrent ops (scan waits with control flow, 7b)
SEQUENCE = {"sequence_pool", "sequence_first_step", "sequence_last_step",
            "sequence_softmax", "sequence_expand", "sequence_conv",
            "sequence_reshape", "sequence_concat", "sequence_slice",
            "sequence_enumerate", "sequence_erase", "sequence_pad",
            "sequence_unpad", "lod_reset", "lod_array_length",
            "edit_distance"}
RNN = {"lstm", "gru", "lstm_unit", "gru_unit"}
# ROADMAP item 7b: ops/rnn.py's scan, ops/control_flow.py's 7,
# ops/crf_ctc.py's 8, ops/nn.py's im2sequence and row_conv, and
# eval_ops.py's chunk_eval
CONTROL_FLOW = {"scan", "while", "if_else", "select_input", "print",
                "is_empty", "write_to_array", "read_from_array"}
CRF_CTC = {"linear_chain_crf", "crf_decoding", "warpctc",
           "ctc_greedy_decoder", "beam_search", "beam_search_decode",
           "beam_expand", "beam_gather", "im2sequence", "row_conv",
           "chunk_eval"}
# ROADMAP item 7c: ops/detection.py's 12, eval_ops.py's detection_map,
# ops/extras.py's 13, and ops/nn.py's hierarchical_sigmoid and nce
DETECTION = {"iou_similarity", "box_coder", "prior_box", "bipartite_match",
             "target_assign", "multiclass_nms", "polygon_box_transform",
             "ssd_loss", "anchor_generator", "rpn_target_assign",
             "generate_proposals", "generate_proposal_labels",
             "detection_map"}
EXTRAS = {"minus", "modified_huber_loss", "pad_constant_like", "conv_shift",
          "max_pool2d_with_index", "unpool", "spp", "positive_negative_pair",
          "precision_recall", "fake_quantize_abs_max",
          "fake_dequantize_max_abs", "weight_norm", "weight_norm_g_init",
          "hierarchical_sigmoid", "nce"}
PORTED = (LLAMA_SLICES | BASIC_REST | NN_REST | {"sequence_mask"}
          | OPTIMIZER_RULES | REWRITE | IO | GENERATE | PAGED | CONV | MESH
          | SEQUENCE | RNN | CONTROL_FLOW | CRF_CTC | DETECTION | EXTRAS)


def test_port_registers_exactly_the_slice_ops():
    assert set(pt_registry.registered_ops()) == PORTED
    assert PORTED <= set(jax_registry.registered_ops())
    with pytest.raises(NotImplementedError, match="no lowering rule"):
        pt_registry.get_op("no_such_op")


@pytest.mark.parametrize("op_type", sorted(CONV))
def test_conv_net_ops_register_with_the_reference_rules(op_type):
    """Each op of item 5 has a lowering rule, and an infer and a numerics
    rule exactly where the reference has one; ``random_crop`` draws
    (``stateful``), as in the reference."""
    assert pt_registry.has_op(op_type)
    assert pt_registry.has_infer(op_type) == jax_registry.has_infer(op_type)
    assert pt_registry.has_numerics(op_type) == \
        jax_registry.has_numerics(op_type)
    assert pt_registry.get_op(op_type).stateful == \
        jax_registry.get_op(op_type).stateful


@pytest.mark.parametrize("op_type", sorted(SEQUENCE | RNN))
def test_sequence_and_rnn_ops_register_with_the_reference_flags(op_type):
    """Each op of item 7a has a lowering rule with the reference's
    ``seq_aware`` and ``stateful`` flags, and an infer and a numerics
    rule exactly where the reference has one (none)."""
    assert pt_registry.has_op(op_type)
    for flag in ("seq_aware", "stateful"):
        assert getattr(pt_registry.get_op(op_type), flag) == \
            getattr(jax_registry.get_op(op_type), flag)
    assert pt_registry.has_infer(op_type) == jax_registry.has_infer(op_type)
    assert pt_registry.has_numerics(op_type) == \
        jax_registry.has_numerics(op_type)


@pytest.mark.parametrize("op_type", sorted(CONTROL_FLOW | CRF_CTC))
def test_control_flow_and_crf_ops_register_with_the_reference_flags(
        op_type):
    """Each op of item 7b has a lowering rule with the reference's
    ``seq_aware`` and ``stateful`` flags, and an infer and a numerics
    rule exactly where the reference has one (none)."""
    assert pt_registry.has_op(op_type)
    for flag in ("seq_aware", "stateful"):
        assert getattr(pt_registry.get_op(op_type), flag) == \
            getattr(jax_registry.get_op(op_type), flag)
    assert pt_registry.has_infer(op_type) == jax_registry.has_infer(op_type)
    assert pt_registry.has_numerics(op_type) == \
        jax_registry.has_numerics(op_type)


# the op types that waited, by name, for item 7c until it landed
STILL_REFUSED = dict.fromkeys((
    "prior_box", "iou_similarity", "hierarchical_sigmoid", "nce",
    "bipartite_match", "multiclass_nms", "fake_quantize_abs_max",
    "target_assign", "ssd_loss", "anchor_generator", "generate_proposals",
    "spp", "weight_norm", "box_coder", "detection_map"),
    "Remaining op families and the zoo")


@pytest.mark.parametrize("op_type", sorted(STILL_REFUSED))
def test_waiting_ops_refuse_naming_their_roadmap_item(op_type):
    """Each op that waited for item 7c now has a lowering rule with the
    reference's ``stateful`` and ``seq_aware`` flags, no refusal, and an
    infer and a numerics rule exactly where the reference has one."""
    assert pt_registry.has_op(op_type)
    od, ref = pt_registry.get_op(op_type), jax_registry.get_op(op_type)
    assert (od.stateful, od.seq_aware) == (ref.stateful, ref.seq_aware)
    assert pt_registry.has_infer(op_type) == jax_registry.has_infer(op_type)
    assert pt_registry.has_numerics(op_type) == \
        jax_registry.has_numerics(op_type)


@pytest.mark.parametrize("op_type", sorted(DETECTION | EXTRAS))
def test_detection_and_extras_ops_register_with_the_reference_flags(
        op_type):
    """Each op of item 7c has a lowering rule with the reference's
    ``seq_aware`` and ``stateful`` flags (the two samplers and ``nce``
    draw), and an infer and a numerics rule exactly where the reference
    has one (the fake quantize pair)."""
    od, ref = pt_registry.get_op(op_type), jax_registry.get_op(op_type)
    assert (od.stateful, od.seq_aware) == (ref.stateful, ref.seq_aware)
    assert pt_registry.has_infer(op_type) == jax_registry.has_infer(op_type)
    assert pt_registry.has_numerics(op_type) == \
        jax_registry.has_numerics(op_type)


def test_every_reference_op_is_ported_or_named_as_waiting():
    """The port registers every op type of the reference's registry;
    none waits any more, and the registry keeps no map of waiting ops."""
    ref = set(jax_registry.registered_ops())
    assert ref - PORTED == set()
    assert not hasattr(pt_registry, "WAITING")


def test_registry_counts():
    """253 reference ops: all 253 ported, none waiting; both generators
    registered ``stateful`` (they draw at temperature > 0), as in the
    reference."""
    ref = set(jax_registry.registered_ops())
    assert (len(ref), len(PORTED)) == (253, 253)
    for op in GENERATE:
        assert pt_registry.get_op(op).stateful
        assert jax_registry.get_op(op).stateful


def test_double_registration_is_loud():
    with pytest.raises(ValueError, match="registered twice"):
        pt_registry.register_op("mul")(lambda ctx, ins, attrs: {})


@pytest.mark.parametrize("xshape,yshape,xn", [((2, 3, 4), (4, 5), 2),
                                              ((2, 3, 4), (12, 5), 1),
                                              ((6, 8), (8, 3), 1)])
def test_mul(xshape, yshape, xn):
    r = _rng(0)
    ins = {"X": [r.randn(*xshape).astype(np.float32)],
           "Y": [r.randn(*yshape).astype(np.float32)]}
    _assert_same(*_run_both("mul", ins, {"x_num_col_dims": xn,
                                         "y_num_col_dims": 1}))


# fluid axis broadcast (_bcast): same shape, scalar Y, trailing Y,
# Y aligned at an explicit axis, 2-D span at axis 1, Y of higher rank
BCAST_CASES = [((2, 3, 4), (2, 3, 4), -1), ((2, 3, 4), (), -1),
               ((2, 3, 4), (4,), -1), ((2, 3, 4), (3,), 1),
               ((2, 3, 4), (3, 4), 1), ((2, 3, 4), (2,), 0),
               ((3, 4), (2, 3, 4), -1)]


@pytest.mark.parametrize("op_type", ["elementwise_add", "elementwise_mul",
                                     "elementwise_div", "elementwise_max"])
@pytest.mark.parametrize("xshape,yshape,axis", BCAST_CASES)
def test_elementwise_axis_broadcast(op_type, xshape, yshape, axis):
    r = _rng(1)
    ins = {"X": [r.randn(*xshape).astype(np.float32)],
           "Y": [np.asarray(r.randn(*yshape), np.float32)]}
    _assert_same(*_run_both(op_type, ins, {"axis": axis}))


@pytest.mark.parametrize("shape", [[0, 0, 2, 4], [-1, 8], [0, -1],
                                   [6, 8]])
def test_reshape_and_reshape2(shape):
    x = _rng(2).randn(2, 3, 8).astype(np.float32)
    _assert_same(*_run_both("reshape", {"X": [x]}, {"shape": shape}))
    j, t = _run_both("reshape2", {"X": [x]}, {"shape": shape})
    _assert_same(j, t)
    assert t["XShape"][0].shape == (0, 2, 3, 8)


@pytest.mark.parametrize("ids_shape", [(2, 5, 1), (2, 5), (7,)])
@pytest.mark.parametrize("pad", [-1, 3])
def test_lookup_table_squeezes_trailing_one(ids_shape, pad):
    r = _rng(3)
    w = r.randn(10, 6).astype(np.float32)
    ids = r.randint(0, 10, ids_shape).astype(np.int64)
    ids.flat[0] = 3                               # hit the padding row
    j, t = _run_both("lookup_table", {"W": [w], "Ids": [ids]},
                     {"padding_idx": pad})
    _assert_same(j, t)
    squeezed = ids_shape[:-1] if ids_shape[-1] == 1 else ids_shape
    assert t["Out"][0].shape == tuple(squeezed) + (6,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    r = _rng(4)
    x = (r.randn(2, 5, 32) * 3).astype(np.float32)
    scale = r.randn(32).astype(np.float32)
    if dtype == "bfloat16":
        ins = {"X": [jnp.asarray(x, jnp.bfloat16)],
               "Scale": [jnp.asarray(scale, jnp.bfloat16)]}
        jctx = jax_lowering.LoweringContext(None, "test",
                                            jax.random.PRNGKey(0))
        want = jax_registry.get_op("rms_norm").lower(
            jctx, ins, {"epsilon": 1e-5})["Y"][0]
        got = pt_registry.get_op("rms_norm").lower(
            None, {"X": [torch.from_numpy(x).bfloat16()],
                   "Scale": [torch.from_numpy(scale).bfloat16()]},
            {"epsilon": 1e-5})["Y"][0]
        assert got.dtype == torch.bfloat16
        # f32 accumulate then one bf16 rounding: at most 1 bf16 ulp apart
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)
    else:
        _assert_same(*_run_both("rms_norm", {"X": [x], "Scale": [scale]},
                                {"epsilon": 1e-5}))


@pytest.mark.parametrize("base", [10000.0, 500000.0])
def test_rope(base):
    x = _rng(5).randn(2, 9, 3, 16).astype(np.float32)
    _assert_same(*_run_both("rope", {"X": [x]}, {"base": base}))


def test_silu():
    x = (_rng(6).randn(4, 7) * 4).astype(np.float32)
    _assert_same(*_run_both("silu", {"X": [x]}, {}))


def test_fill_constant():
    for dtype in ("float32", "int64"):
        _assert_same(*_run_both("fill_constant", {},
                                {"shape": [3, 2], "dtype": dtype,
                                 "value": 1.5 if dtype == "float32"
                                 else 7.0}))


def test_gaussian_random_distribution_and_determinism():
    """The two frameworks draw different numbers from one seed, so the
    draw is held to its distribution, and to determinism per
    (seed, step, draw)."""
    attrs = {"shape": [200, 100], "dtype": "float32", "mean": 0.5,
             "std": 0.02}
    rule = pt_registry.get_op("gaussian_random").lower

    def draw(seed, step):
        ctx = pt_lowering.LoweringContext(None, "train",
                                          torch.device("cpu"), seed, step)
        return rule(ctx, {}, attrs)["Out"][0]

    a = draw(0, 1)
    assert a.shape == (200, 100) and a.dtype == torch.float32
    assert abs(float(a.mean()) - 0.5) < 0.001
    assert abs(float(a.std()) - 0.02) < 0.001
    assert torch.equal(a, draw(0, 1))
    assert not torch.equal(a, draw(0, 2))
    assert not torch.equal(a, draw(1, 1))
    ctx = pt_lowering.LoweringContext(None, "train", torch.device("cpu"),
                                      0, 1)
    b1 = rule(ctx, {}, attrs)["Out"][0]
    b2 = rule(ctx, {}, attrs)["Out"][0]
    assert not torch.equal(b1, b2)                # per-draw streams
    bf = rule(ctx, {}, dict(attrs, dtype="bfloat16"))["Out"][0]
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("causal", [True, False])
def test_multihead_attention_gqa(causal):
    """GQA (4 q heads over 2 kv heads): the reference's jnp.repeat on the
    head axis is repeat_interleave. Head dim 16 takes the reference's
    plain path."""
    r = _rng(7)
    q = r.randn(2, 24, 4, 16).astype(np.float32)
    k = r.randn(2, 24, 2, 16).astype(np.float32)
    v = r.randn(2, 24, 2, 16).astype(np.float32)
    _assert_same(*_run_both("multihead_attention",
                            {"Q": [q], "K": [k], "V": [v]},
                            {"causal": causal}), rtol=2e-4, atol=2e-5)


def test_multihead_attention_gqa_pallas_interpreted(monkeypatch):
    """Head dim 128 at T = 128: the reference runs its Pallas K1 (here
    through the interpreter)."""
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    r = _rng(8)
    q = (r.randn(1, 128, 2, 128) * 0.5).astype(np.float32)
    k = (r.randn(1, 128, 1, 128) * 0.5).astype(np.float32)
    v = (r.randn(1, 128, 1, 128) * 0.5).astype(np.float32)
    _assert_same(*_run_both("multihead_attention",
                            {"Q": [q], "K": [k], "V": [v]},
                            {"causal": True, "scale": 0.1}),
                 rtol=2e-4, atol=2e-5)


def test_gqa_repeat_is_interleave_not_tile():
    """Guard the GQA mapping itself: q head h reads kv head h // rep."""
    from paddle_tpu_torch.ops.transformer_ops import attention_core
    r = _rng(9)
    q = torch.from_numpy(r.randn(1, 8, 4, 16).astype(np.float32))
    k = torch.from_numpy(r.randn(1, 8, 2, 16).astype(np.float32))
    v = torch.from_numpy(r.randn(1, 8, 2, 16).astype(np.float32))
    out = attention_core(q, k, v, causal=True)
    for h in range(4):
        alone = attention_core(q[:, :, h:h + 1], k[:, :, h // 2:h // 2 + 1],
                               v[:, :, h // 2:h // 2 + 1], causal=True)
        torch.testing.assert_close(out[:, :, h:h + 1], alone)


@pytest.mark.parametrize("attrs", [{"scale": 0.9},
                                   {"scale": 2.0, "bias": 0.5},
                                   {"scale": 2.0, "bias": 0.5,
                                    "bias_after_scale": False}])
def test_scale(attrs):
    x = _rng(10).randn(3, 4).astype(np.float32)
    _assert_same(*_run_both("scale", {"X": [x]}, attrs))


def test_sum_mean_sqrt_sign_squared_l2_norm():
    r = _rng(11)
    xs = [r.randn(3, 5).astype(np.float32) for _ in range(3)]
    _assert_same(*_run_both("sum", {"X": xs}, {}))
    j, t = _run_both("mean", {"X": [xs[0]]}, {})
    _assert_same(j, t)
    assert t["Out"][0].shape == (1,)
    _assert_same(*_run_both("sqrt", {"X": [np.abs(xs[1])]}, {}))
    _assert_same(*_run_both("sign", {"X": [xs[2]]}, {}))
    _assert_same(*_run_both("squared_l2_norm", {"X": [xs[0]]}, {}))


@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_cast(dtype):
    x = (_rng(12).randn(4, 3) * 10).astype(np.float32)
    j, t = _run_both("cast", {"X": [x]}, {"in_dtype": "float32",
                                          "out_dtype": dtype})
    _assert_same(j, t, rtol=0, atol=0)


def test_clip_clip_by_norm_increment_softmax():
    r = _rng(13)
    x = (r.randn(4, 6) * 3).astype(np.float32)
    _assert_same(*_run_both("clip", {"X": [x]}, {"min": -1.0, "max": 2.0}))
    for mn in (1.0, 1e3):                 # clipped and not
        _assert_same(*_run_both("clip_by_norm", {"X": [x]},
                                {"max_norm": mn}))
    _assert_same(*_run_both("increment", {"X": [x[:1, :1]]},
                            {"step": 2.0}))
    for axis in (-1, 0):
        _assert_same(*_run_both("softmax", {"X": [x]}, {"axis": axis}))


@pytest.mark.parametrize("label_shape", ["n1", "n"])
@pytest.mark.parametrize("ignore", [-100, 2])
def test_softmax_with_cross_entropy_and_cross_entropy(label_shape, ignore):
    """Hard labels ([N, 1] or [N]), with ignore_index hitting some rows;
    cross_entropy on the softmax of the same logits."""
    r = _rng(14)
    logits = (r.randn(2, 5, 7) * 2).astype(np.float32)
    label = r.randint(0, 7, (2, 5, 1)).astype(np.int64)
    label[0, :2, 0] = 2
    if label_shape == "n":
        label = label[..., 0]
    attrs = {"soft_label": False, "ignore_index": ignore}
    j, t = _run_both("softmax_with_cross_entropy",
                     {"Logits": [logits], "Label": [label]}, attrs)
    _assert_same(j, t)
    assert t["Loss"][0].shape == (2, 5, 1)
    if ignore == 2:
        assert not t["Loss"][0][0, :2].any()
    probs = np.array(j["Softmax"][0])
    _assert_same(*_run_both("cross_entropy",
                            {"X": [probs], "Label": [label]}, attrs))


def test_soft_label_losses():
    r = _rng(15)
    logits = r.randn(6, 4).astype(np.float32)
    soft = np.abs(r.randn(6, 4)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    j, t = _run_both("softmax_with_cross_entropy",
                     {"Logits": [logits], "Label": [soft]},
                     {"soft_label": True})
    _assert_same(j, t)
    _assert_same(*_run_both("cross_entropy",
                            {"X": [np.array(j["Softmax"][0])],
                             "Label": [soft]},
                            {"soft_label": True}))


def test_uniform_random_distribution_and_determinism():
    attrs = {"shape": [300, 100], "dtype": "float32", "min": -0.5,
             "max": 1.5}
    rule = pt_registry.get_op("uniform_random").lower

    def draw(seed, step):
        ctx = pt_lowering.LoweringContext(None, "train",
                                          torch.device("cpu"), seed, step)
        return rule(ctx, {}, attrs)["Out"][0]

    a = draw(0, 1)
    assert a.shape == (300, 100) and a.dtype == torch.float32
    assert float(a.min()) >= -0.5 and float(a.max()) < 1.5
    assert abs(float(a.mean()) - 0.5) < 0.01
    assert torch.equal(a, draw(0, 1)) and not torch.equal(a, draw(0, 2))
