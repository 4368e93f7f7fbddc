"""High-level neural network layers (port of ``paddle_tpu/layers/nn.py``).

The layers over the ops the port registers, copied from the reference
with only the sharding annotation type changed: ``fc``, ``embedding``,
the norms, ``dropout``, the losses, the reductions, the shape and
gather/scatter layers, ``autoincreased_step_counter`` (the LR
schedulers' counter), the activation layers, and the conv-net layers
(the convolutions, pools, ``batch_norm``, ``lrn``, image resize,
``roi_pool`` and ``random_crop``), ``im2sequence``, ``row_conv``, the
CRF, CTC and beam-search layers, and ``hsigmoid`` and ``nce``.
Each layer builds Program ops; shapes are inferred in Python (batch
dims stay -1) so parameters can be sized.
"""
import numpy as np

from ..core import framework
from ..layer_helper import LayerHelper
from ..sharding import PartitionSpec as P
from .. import initializer as init_mod

__all__ = [
    "fc", "embedding", "layer_norm", "group_norm", "dropout", "softmax",
    "cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
    "smooth_l1", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "split", "matmul", "topk", "transpose", "reshape",
    "squeeze", "unsqueeze", "one_hot", "l2_normalize", "pad", "pad2d",
    "label_smooth", "dice_loss", "gather", "scatter", "mean_iou", "relu",
    "log", "crop", "rank_loss", "prelu", "flatten", "stack", "unstack",
    "expand", "autoincreased_step_counter", "cos_sim", "hsigmoid", "nce",
    "multiplex",
    "maxout", "brelu", "hard_sigmoid", "conv2d", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "pool2d", "pool3d",
    "batch_norm", "lrn", "roi_pool", "image_resize", "resize_bilinear",
    "image_resize_short", "random_crop", "im2sequence", "row_conv",
    "linear_chain_crf", "crf_decoding", "warpctc", "ctc_greedy_decoder",
    "beam_search", "beam_search_decode", "beam_expand", "beam_gather",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, use_mkldnn=False, name=None):
    """Fully connected layer (reference python/paddle/fluid/layers/nn.py
    fc): out = act(sum_i(x_i @ w_i) + b)."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input("input").dtype if not isinstance(input, (list, tuple)) \
        else input[0].dtype
    inputs = helper.multiple_input()
    param_attrs = helper.param_attr
    if not isinstance(param_attrs, list):
        param_attrs = [param_attrs] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        in_dims = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(pattr, [in_dims, size], dtype)
        out_shape = list(inp.shape[:num_flatten_dims]) + [size]
        tmp = helper.create_variable_for_type_inference(
            dtype, shape=out_shape,
            lod_level=inp.lod_level if num_flatten_dims == 1 else 0)
        helper.append_op(type="mul",
                         inputs={"X": [inp.name], "Y": [w.name]},
                         outputs={"Out": [tmp.name]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            dtype, shape=mul_results[0].shape,
            lod_level=mul_results[0].lod_level)
        helper.append_op(type="sum",
                         inputs={"X": [m.name for m in mul_results]},
                         outputs={"Out": [pre_bias.name]})
    bias = helper.create_parameter(helper.bias_attr, [size], dtype,
                                   is_bias=True)
    pre_act = helper.append_bias_op(pre_bias, bias)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup (reference lookup_table_op.cc).

    ``is_sparse`` is accepted for parity (the lookup is a gather); for
    a single-device table of at least 1,000,000 rows it warns, as the
    reference does, that the dense optimizer sweep remains.

    ``is_distributed`` annotates the table ``P('mp', None)`` as the
    reference does: under a ParallelExecutor whose mesh has an 'mp'
    axis the table and its optimizer state (which inherits the spec)
    are row-sharded over it, each rank looking up the ids in its rows.
    """
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    if is_sparse and not is_distributed and size[0] >= 1_000_000:
        # the reference's warning (paddle_tpu/layers/nn.py): the flag
        # exists to avoid a dense optimizer sweep over a huge table, and
        # on one device the sweep still happens (the gradient is a dense
        # scatter-add, the optimizer updates every row)
        import warnings
        warnings.warn(stacklevel=2, message=(
            f"embedding(is_sparse=True) is a no-op on the card (the "
            f"lookup is a gather, its gradient a scatter-add); for a "
            f"{size[0]}-row table the dense optimizer sweep is the real "
            "cost — shard it with is_distributed=True on a mesh with an "
            "'mp' axis instead"))
    if is_distributed:
        w.sharding = P(*(("mp",) + (None,) * (len(size) - 1)))
    out_shape = list(input.shape)
    if out_shape and out_shape[-1] == 1:
        out_shape = out_shape[:-1]
    out_shape = out_shape + [size[1]]
    out = helper.create_variable_for_type_inference(
        dtype, shape=out_shape, lod_level=input.lod_level)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type="lookup_table",
                     inputs={"W": [w.name], "Ids": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"padding_idx": pad, "is_sparse": is_sparse})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out_shape = list(shape)
    known = [s for s in out_shape if s not in (-1,)]
    # resolve 0 (copy dim) for shape inference
    resolved = [x.shape[i] if s == 0 else s for i, s in enumerate(out_shape)]
    if -1 in resolved:
        total = int(np.prod([s for s in x.shape])) if -1 not in x.shape else -1
        if total != -1:
            rest = int(np.prod([s for s in resolved if s != -1]))
            resolved = [total // rest if s == -1 else s for s in resolved]
    out = helper.create_variable_for_type_inference(x.dtype, shape=resolved)
    helper.append_op(type="reshape", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def softmax(input, use_cudnn=True, name=None, axis=-1,
            param_attr=None, bias_attr=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=input.shape, lod_level=input.lod_level)
    helper.append_op(type="softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out_shape = list(input.shape[:-1]) + [1]
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=out_shape, lod_level=input.lod_level)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss_shape = list(logits.shape[:-1]) + [1]
    loss = helper.create_variable_for_type_inference(logits.dtype,
                                                     shape=loss_shape)
    sm = helper.create_variable_for_type_inference(logits.dtype,
                                                   shape=logits.shape)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name], "Label": [label.name]},
                     outputs={"Loss": [loss.name], "Softmax": [sm.name]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    if return_softmax:
        return loss, sm
    return loss


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(helper.param_attr, norm_shape, dtype,
                                    default_initializer=init_mod.Constant(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(helper.bias_attr, norm_shape, dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    mean = helper.create_variable_for_type_inference(
        dtype, shape=list(input.shape[:begin_norm_axis]), stop_gradient=True)
    var = helper.create_variable_for_type_inference(
        dtype, shape=list(input.shape[:begin_norm_axis]), stop_gradient=True)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out.name], "Mean": [mean.name],
                              "Variance": [var.name]},
                     attrs={"begin_norm_axis": begin_norm_axis,
                            "epsilon": epsilon})
    return helper.append_activation(out)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    c = int(input.shape[1])
    inputs = {"X": [input.name]}
    if helper.param_attr is not False:
        s = helper.create_parameter(helper.param_attr, [c], dtype,
                                    default_initializer=init_mod.Constant(1.0))
        inputs["Scale"] = [s.name]
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [c], dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    mean = helper.create_variable_for_type_inference(
        dtype, shape=[input.shape[0], groups], stop_gradient=True)
    var = helper.create_variable_for_type_inference(
        dtype, shape=[input.shape[0], groups], stop_gradient=True)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": [out.name], "Mean": [mean.name],
                              "Variance": [var.name]},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(
        x.dtype, shape=x.shape, lod_level=x.lod_level)
    mask = helper.create_variable_for_type_inference(x.dtype, shape=x.shape,
                                                     stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation": dropout_implementation})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [out.name]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1")
    diff = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    out = helper.create_variable_for_type_inference(x.dtype,
                                                    shape=[x.shape[0], 1])
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [out.name], "Diff": [diff.name]},
                     attrs={"sigma": sigma or 1.0})
    return out


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    if dim is None:
        reduce_all, dims = True, [0]
        shape = [1]
    else:
        reduce_all = False
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        nd = len(input.shape)
        axes = sorted(d % nd for d in dims)
        if keep_dim:
            shape = [1 if i in axes else s for i, s in enumerate(input.shape)]
        else:
            shape = [s for i, s in enumerate(input.shape) if i not in axes]
        if not shape:
            shape = [1]
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type=op_type, inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dim": list(dims), "keep_dim": keep_dim,
                            "reduce_all": reduce_all})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    nd = len(input.shape)
    axis = dim % nd
    in_size = input.shape[axis]
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
        sizes = [in_size // num if in_size != -1 else -1] * num
    else:
        sections = list(num_or_sections)
        num, sizes = 0, sections
    outs = []
    for s in sizes:
        shp = list(input.shape)
        shp[axis] = s
        outs.append(helper.create_variable_for_type_inference(input.dtype,
                                                              shape=shp))
    helper.append_op(type="split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]},
                     attrs={"axis": axis, "num": num, "sections": sections})
    return outs


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) > 1:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) > 1:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) >= 2 and len(ys) >= 2:
        shape = (xs[:-2] if len(xs) >= len(ys) else ys[:-2]) + [xs[-2], ys[-1]]
    else:
        shape = [1]
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shape = list(input.shape[:-1]) + [k]
    vals = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    idx = helper.create_variable_for_type_inference("int64", shape=shape,
                                                    stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input.name]},
                     outputs={"Out": [vals.name], "Indices": [idx.name]},
                     attrs={"k": k})
    return vals, idx


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    shape = [x.shape[p] for p in perm]
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="transpose", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": list(perm)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    shape = [s for i, s in enumerate(input.shape)
             if not (i in [a % len(input.shape) for a in axes] and s == 1)] \
        if axes else [s for s in input.shape if s != 1]
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="squeeze", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    shape = list(input.shape)
    for a in sorted(axes):
        shape.insert(a, 1)
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="unsqueeze", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axes": list(axes)})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    shape = list(input.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    out = helper.create_variable_for_type_inference("float32",
                                                    shape=shape + [depth])
    helper.append_op(type="one_hot", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"depth": depth})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    norm = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="norm", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Norm": [norm.name]},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    shape = [s if s == -1 else s + paddings[2 * i] + paddings[2 * i + 1]
             for i, s in enumerate(x.shape)]
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="pad", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    shape = list(input.shape)
    hi, wi = (2, 3) if data_format == "NCHW" else (1, 2)
    if shape[hi] != -1:
        shape[hi] += paddings[0] + paddings[1]
    if shape[wi] != -1:
        shape[wi] += paddings[2] + paddings[3]
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="pad2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value),
                            "data_format": data_format})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype, shape=label.shape)
    inputs = {"X": [label.name]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist.name]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out.name]}, attrs={"epsilon": epsilon})
    return out


def dice_loss(input, label, epsilon=1e-5):
    helper = LayerHelper("dice_loss")
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=[input.shape[0]])
    helper.append_op(type="dice_loss",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Out": [out.name]}, attrs={"epsilon": epsilon})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    shape = [index.shape[0]] + list(input.shape[1:])
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="gather",
                     inputs={"X": [input.name], "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="scatter",
                     inputs={"X": [input.name], "Ids": [index.name],
                             "Updates": [updates.name]},
                     outputs={"Out": [out.name]},
                     attrs={"overwrite": overwrite})
    return out


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32", shape=[1])
    wrong = helper.create_variable_for_type_inference("int32",
                                                      shape=[num_classes])
    correct = helper.create_variable_for_type_inference("int32",
                                                        shape=[num_classes])
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input.name],
                             "Labels": [label.name]},
                     outputs={"OutMeanIou": [miou.name],
                              "OutWrong": [wrong.name],
                              "OutCorrect": [correct.name]},
                     attrs={"num_classes": num_classes})
    return miou, wrong, correct


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper("crop", name=name)
    if isinstance(shape, framework.Variable):
        raise NotImplementedError(
            "crop with a runtime shape tensor is data-dependent, and the "
            "reference refuses it (its programs have static shapes); pass "
            "a python list of dims")
    shape = list(shape)
    offsets = offsets or [0] * len(x.shape)
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="crop", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"offsets": list(offsets), "shape": shape})
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference("float32",
                                                    shape=label.shape)
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label.name], "Left": [left.name],
                             "Right": [right.name]},
                     outputs={"Out": [out.name]})
    return out


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [int(x.shape[1])]
    else:
        alpha_shape = [int(np.prod([s for s in x.shape[1:]]))]
    alpha = helper.create_parameter(
        helper.param_attr, alpha_shape, x.dtype,
        default_initializer=init_mod.Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="prelu",
                     inputs={"X": [x.name], "Alpha": [alpha.name]},
                     outputs={"Out": [out.name]}, attrs={"mode": mode})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 and -1 not in x.shape[:axis] else -1
    tail = int(np.prod(x.shape[axis:])) if -1 not in x.shape[axis:] else -1
    out = helper.create_variable_for_type_inference(x.dtype,
                                                    shape=[lead, tail])
    helper.append_op(type="flatten", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    shape = list(xs[0].shape)
    shape.insert(axis % (len(shape) + 1), len(xs))
    out = helper.create_variable_for_type_inference(xs[0].dtype, shape=shape)
    helper.append_op(type="stack", inputs={"X": [v.name for v in xs]},
                     outputs={"Y": [out.name]}, attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num or x.shape[axis]
    shape = [s for i, s in enumerate(x.shape) if i != axis % len(x.shape)]
    outs = [helper.create_variable_for_type_inference(x.dtype, shape=shape)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x.name]},
                     outputs={"Y": [o.name for o in outs]},
                     attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    shape = [s if s == -1 else s * t for s, t in zip(x.shape, expand_times)]
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="expand", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"expand_times": list(expand_times)})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable int64 counter incremented once per executor run
    (reference layers/nn.py autoincreased_step_counter) — drives LR
    schedulers."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    gb = helper.main_program.global_block()
    if gb.has_var_local(name):
        return gb.var(name)
    counter = helper.create_global_variable(shape=[1], dtype="int64",
                                            persistable=True, name=name)
    helper.set_variable_initializer(
        counter, init_mod.Constant(float(begin - step)))
    helper.main_program.global_block().prepend_op(
        type="increment", inputs={"X": [counter.name]},
        outputs={"Out": [counter.name]}, attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype,
                                                    shape=[X.shape[0], 1])
    xn = helper.create_variable_for_type_inference(X.dtype,
                                                   shape=[X.shape[0], 1])
    yn = helper.create_variable_for_type_inference(X.dtype,
                                                   shape=[Y.shape[0], 1])
    helper.append_op(type="cos_sim",
                     inputs={"X": [X.name], "Y": [Y.name]},
                     outputs={"Out": [out.name], "XNorm": [xn.name],
                              "YNorm": [yn.name]})
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid via a complete binary tree, composed from dense
    ops (reference hierarchical_sigmoid_op.cc): the per-sample
    code path is a fixed-depth gather + dense dot."""
    from . import hsig_impl
    return hsig_impl.hsigmoid(input, label, num_classes, param_attr,
                              bias_attr, name)


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None):
    from . import nce_impl
    return nce_impl.nce(input, label, num_total_classes, sample_weight,
                        param_attr, bias_attr, num_neg_samples, name)


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype,
                                                    shape=inputs[0].shape)
    helper.append_op(type="multiplex",
                     inputs={"X": [v.name for v in inputs],
                             "Ids": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="relu", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def log(x, name=None):
    helper = LayerHelper("log", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="log", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    shape = list(x.shape)
    shape[1] = shape[1] // groups if shape[1] != -1 else -1
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="maxout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"groups": groups})
    return out


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    helper = LayerHelper("brelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="brelu", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"t_min": t_min, "t_max": t_max})
    return out


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    helper = LayerHelper("hard_sigmoid", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="hard_sigmoid", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"slope": slope, "offset": offset})
    return out


# ---------------------------------------------------------------------------
# conv nets (ROADMAP item 5)
# ---------------------------------------------------------------------------


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None, data_format="NCHW"):
    """2D convolution (reference conv_op.cc). ``use_cudnn`` accepted
    and ignored: the op runs cuDNN on the card either way.
    ``data_format``: "NCHW" (fluid default) or "NHWC" — channels-last;
    the filter stays [cout, cin/g, kh, kw] in both so checkpoints are
    layout-portable."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, "
                         f"got {data_format!r}")
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    c_axis = 1 if data_format == "NCHW" else 3
    sp0 = 2 if data_format == "NCHW" else 1
    num_channels = int(input.shape[c_axis])
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) else list(dilation)
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)

    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, filter_shape, dtype,
        default_initializer=init_mod.Normal(0.0, std))

    h = _conv_out(input.shape[sp0], filter_size[0], stride[0], padding[0],
                  dilation[0])
    wd = _conv_out(input.shape[sp0 + 1], filter_size[1], stride[1],
                   padding[1], dilation[1])
    if data_format == "NCHW":
        out_shape = [input.shape[0], num_filters, h, wd]
    else:
        out_shape = [input.shape[0], h, wd, num_filters]
    out = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    helper.append_op(type="conv2d",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "data_format": data_format})
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_filters], dtype,
                                    is_bias=True)
        pre_act = helper.create_variable_for_type_inference(dtype,
                                                            shape=out.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [pre_act.name]},
                         attrs={"axis": c_axis})
        out = pre_act
    return helper.append_activation(out)


def _conv_out(size, k, s, p, d=1):
    if size == -1 or size is None:
        return -1
    k_eff = d * (k - 1) + 1
    return (size + 2 * p - k_eff) // s + 1


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None):
    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    nc = int(input.shape[1])
    fs = [filter_size] * 3 if isinstance(filter_size, int) else list(filter_size)
    stride = [stride] * 3 if isinstance(stride, int) else list(stride)
    padding = [padding] * 3 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 3 if isinstance(dilation, int) else list(dilation)
    w = helper.create_parameter(helper.param_attr,
                                [num_filters, nc // groups] + fs, dtype)
    dims = [_conv_out(input.shape[2 + i], fs[i], stride[i], padding[i],
                      dilation[i]) for i in range(3)]
    out = helper.create_variable_for_type_inference(
        dtype, shape=[input.shape[0], num_filters] + dims)
    helper.append_op(type="conv3d",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_filters], dtype,
                                    is_bias=True)
        pre = helper.create_variable_for_type_inference(dtype, shape=out.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [pre.name]}, attrs={"axis": 1})
        out = pre
    return helper.append_activation(out)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    nc = int(input.shape[1])
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) else list(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = [output_size] * 2 if isinstance(output_size, int) \
            else list(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1 for i in range(2)]
    else:
        filter_size = [filter_size] * 2 if isinstance(filter_size, int) \
            else list(filter_size)
    g = groups or 1
    w = helper.create_parameter(helper.param_attr,
                                [nc, num_filters // g] + filter_size, dtype)
    dims = [(input.shape[2 + i] - 1) * stride[i] - 2 * padding[i]
            + dilation[i] * (filter_size[i] - 1) + 1
            if input.shape[2 + i] != -1 else -1 for i in range(2)]
    out = helper.create_variable_for_type_inference(
        dtype, shape=[input.shape[0], num_filters] + dims)
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": g})
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_filters], dtype,
                                    is_bias=True)
        pre = helper.create_variable_for_type_inference(dtype, shape=out.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [pre.name]}, attrs={"axis": 1})
        out = pre
    return helper.append_activation(out)


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None):
    """3D transposed convolution, NCDHW (reference conv3d_transpose)."""
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    nc = int(input.shape[1])
    stride = [stride] * 3 if isinstance(stride, int) else list(stride)
    padding = [padding] * 3 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 3 if isinstance(dilation, int) \
        else list(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        output_size = [output_size] * 3 if isinstance(output_size, int) \
            else list(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1 for i in range(3)]
    else:
        filter_size = [filter_size] * 3 \
            if isinstance(filter_size, int) else list(filter_size)
    g = groups or 1
    w = helper.create_parameter(helper.param_attr,
                                [nc, num_filters // g] + filter_size,
                                dtype)
    dims = [(input.shape[2 + i] - 1) * stride[i] - 2 * padding[i]
            + dilation[i] * (filter_size[i] - 1) + 1
            if input.shape[2 + i] != -1 else -1 for i in range(3)]
    out = helper.create_variable_for_type_inference(
        dtype, shape=[input.shape[0], num_filters] + dims)
    helper.append_op(type="conv3d_transpose",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": g})
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_filters],
                                    dtype, is_bias=True)
        pre = helper.create_variable_for_type_inference(dtype,
                                                        shape=out.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [pre.name]}, attrs={"axis": 1})
        out = pre
    return helper.append_activation(out)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None,
           data_format="NCHW"):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, "
                         f"got {data_format!r}")
    helper = LayerHelper("pool2d", name=name)
    ps = [pool_size] * 2 if isinstance(pool_size, int) else list(pool_size)
    st = [pool_stride] * 2 if isinstance(pool_stride, int) else list(pool_stride)
    pd = [pool_padding] * 2 if isinstance(pool_padding, int) else list(pool_padding)
    sp0 = 2 if data_format == "NCHW" else 1
    if global_pooling:
        h = w = 1
    else:
        h = _pool_out(input.shape[sp0], ps[0], st[0], pd[0], ceil_mode)
        w = _pool_out(input.shape[sp0 + 1], ps[1], st[1], pd[1], ceil_mode)
    if data_format == "NCHW":
        out_shape = [input.shape[0], input.shape[1], h, w]
    else:
        out_shape = [input.shape[0], h, w, input.shape[3]]
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=out_shape)
    helper.append_op(type="pool2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ksize": ps, "strides": st, "paddings": pd,
                            "pooling_type": pool_type,
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode,
                            "data_format": data_format})
    return out


def _pool_out(size, k, s, p, ceil_mode):
    if size == -1 or size is None:
        return -1
    if ceil_mode:
        return int(np.ceil((size + 2 * p - k) / s)) + 1
    return (size + 2 * p - k) // s + 1


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None):
    helper = LayerHelper("pool3d", name=name)
    ps = [pool_size] * 3 if isinstance(pool_size, int) else list(pool_size)
    st = [pool_stride] * 3 if isinstance(pool_stride, int) else list(pool_stride)
    pd = [pool_padding] * 3 if isinstance(pool_padding, int) else list(pool_padding)
    if global_pooling:
        dims = [1, 1, 1]
    else:
        dims = [_pool_out(input.shape[2 + i], ps[i], st[i], pd[i], ceil_mode)
                for i in range(3)]
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=[input.shape[0], input.shape[1]] + dims)
    helper.append_op(type="pool3d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ksize": ps, "strides": st, "paddings": pd,
                            "pooling_type": pool_type,
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False,
               use_global_stats=False, use_mkldnn=False,
               fuse_with_relu=False):
    """Batch normalization (reference batch_norm_op.cc). Moving stats are
    persistable vars updated functionally each step."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    c = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    scale = helper.create_parameter(helper.param_attr, [c], dtype,
                                    default_initializer=init_mod.Constant(1.0))
    bias = helper.create_parameter(helper.bias_attr, [c], dtype, is_bias=True)
    mean = helper.create_global_variable(
        shape=[c], dtype=dtype, name=moving_mean_name, persistable=True)
    helper.set_variable_initializer(mean, init_mod.Constant(0.0))
    var = helper.create_global_variable(
        shape=[c], dtype=dtype, name=moving_variance_name, persistable=True)
    helper.set_variable_initializer(var, init_mod.Constant(1.0))

    saved_mean = helper.create_variable_for_type_inference(dtype, shape=[c],
                                                           stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, shape=[c],
                                                          stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name],
                "Bias": [bias.name], "Mean": [mean.name],
                "Variance": [var.name]},
        outputs={"Y": [out.name], "MeanOut": [mean.name],
                 "VarianceOut": [var.name], "SavedMean": [saved_mean.name],
                 "SavedVariance": [saved_var.name]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    mid = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape,
                                                    stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "MidOut": [mid.name]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             rois_batch_id=None):
    """rois: [R, 4] (+ rois_batch_id) like the reference, or batched
    [B, S, 4] — the generate_proposal_labels output — in which case
    batch ids are derived and the output is [B*S, C, ph, pw]."""
    helper = LayerHelper("roi_pool")
    n_rois = rois.shape[0] if len(rois.shape) == 2 else \
        rois.shape[0] * rois.shape[1]
    shape = [n_rois, input.shape[1], pooled_height, pooled_width]
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    argmax = helper.create_variable_for_type_inference("int64", shape=shape,
                                                       stop_gradient=True)
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_batch_id is not None:
        inputs["RoisBatchId"] = [rois_batch_id.name]
    helper.append_op(type="roi_pool", inputs=inputs,
                     outputs={"Out": [out.name], "Argmax": [argmax.name]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None):
    helper = LayerHelper("image_resize", name=name)
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    op = {"BILINEAR": "bilinear_interp", "NEAREST": "nearest_interp"}[resample]
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=[input.shape[0], input.shape[1]] + list(out_shape))
    helper.append_op(type=op, inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_h": out_shape[0], "out_w": out_shape[1]})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None):
    return image_resize(input, out_shape, scale, name, "BILINEAR")


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    h, w = int(input.shape[2]), int(input.shape[3])
    short = min(h, w)
    oh = int(h * out_short_len / short)
    ow = int(w * out_short_len / short)
    return image_resize(input, [oh, ow], resample=resample)


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop")
    out_shape = list(x.shape[:len(x.shape) - len(shape)]) + list(shape)
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(type="random_crop", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"shape": list(shape)})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    if input_image_size is not None:
        raise NotImplementedError(
            "im2sequence(input_image_size=...) computes per-image true "
            "sizes from a runtime tensor (reference im2sequence_op.cc "
            "variable-size batches); the port, as the JAX package, treats "
            "every image as full-size — crop/pad the batch to one size "
            "instead (out_stride only applies with input_image_size)")
    helper = LayerHelper("im2sequence", name=name)
    fs = [filter_size] * 2 if isinstance(filter_size, int) else list(filter_size)
    st = [stride] * 2 if isinstance(stride, int) else list(stride)
    pd = [padding] * 4 if isinstance(padding, int) else list(padding)
    c = input.shape[1]
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=[-1, int(c * fs[0] * fs[1])], lod_level=1)
    helper.append_op(type="im2sequence", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"kernels": fs, "strides": st, "paddings": pd})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (reference row_conv_op.cc) over
    [batch, time, dim] padded sequences."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    d = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                [future_context_size + 1, d], input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="row_conv",
                     inputs={"X": [input.name], "Filter": [w.name]},
                     outputs={"Out": [out.name]})
    return helper.append_activation(out)


# ---------------------------------------------------------------------
# Structured prediction: CRF, CTC, beam search
# (reference python/paddle/fluid/layers/nn.py linear_chain_crf 815,
#  crf_decoding 859, beam_search 2710, beam_search_decode 2822,
#  ctc_greedy_decoder 3640, warpctc 3713)


def linear_chain_crf(input, label, param_attr=None):
    """Linear-chain CRF training cost. ``input`` are per-tag emission
    scores (lod_level=1, [sum_len, K]); learns a [K+2, K] transition
    parameter (row 0 start, row 1 end weights). Returns the per-sequence
    negated log-likelihood [N, 1] — minimize its mean."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    alpha = helper.create_variable_for_type_inference(
        input.dtype, shape=input.shape, lod_level=input.lod_level)
    emission_exps = helper.create_variable_for_type_inference(
        input.dtype, shape=input.shape, lod_level=input.lod_level)
    transition_exps = helper.create_variable_for_type_inference(
        input.dtype, shape=[size + 2, size])
    log_likelihood = helper.create_variable_for_type_inference(
        input.dtype, shape=[-1, 1])
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input.name], "Transition": [transition.name],
                "Label": [label.name]},
        outputs={"Alpha": [alpha.name],
                 "EmissionExps": [emission_exps.name],
                 "TransitionExps": [transition_exps.name],
                 "LogLikelihood": [log_likelihood.name]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """Viterbi decode with the transition learned by linear_chain_crf
    (share it via ``param_attr`` name). Without ``label`` returns the
    decoded tag sequence; with it, per-position error indicators."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    transition = helper.get_parameter(helper.param_attr.name)
    out = helper.create_variable_for_type_inference(
        "int32", shape=list(input.shape[:-1]), lod_level=max(
            input.lod_level, 1))
    inputs = {"Emission": [input.name], "Transition": [transition.name]}
    if label is not None:
        inputs["Label"] = [label.name]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [out.name]})
    return out


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss. ``input``: unnormalized per-frame class scores
    (lod_level=1, [sum_frames, C] with C including the blank);
    ``label``: target token sequences (lod_level=1). Returns the
    per-sequence loss [N, 1]."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(
        input.dtype, shape=[-1, 1])
    grad = helper.create_variable_for_type_inference(
        input.dtype, shape=input.shape, lod_level=input.lod_level)
    helper.append_op(
        type="warpctc",
        inputs={"Logits": [input.name], "Label": [label.name]},
        outputs={"Loss": [loss.name], "WarpCTCGrad": [grad.name]},
        attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """Greedy CTC decode: per-frame argmax, merge repeats, drop blanks.
    Returns the decoded token sequences (lod_level=1)."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    out = helper.create_variable_for_type_inference(
        "int32", shape=list(input.shape[:-1]),
        lod_level=max(input.lod_level, 1))
    helper.append_op(type="ctc_greedy_decoder",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"blank": blank})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, name=None):
    """One beam-expansion step over dense fixed-shape beams
    ([batch, beam] state — the dense form of the reference's LoD beams).
    ``scores``: accumulated candidate log-probs [batch, beam, K] for the
    candidate ``ids`` (or K == vocab with ids=None). Returns
    (selected_ids, selected_scores, parent_idx), each [batch, beam]."""
    helper = LayerHelper("beam_search", name=name)
    b, w = pre_ids.shape[0], pre_ids.shape[1]
    sel_ids = helper.create_variable_for_type_inference("int32",
                                                        shape=[b, beam_size])
    sel_scores = helper.create_variable_for_type_inference(
        scores.dtype, shape=[b, beam_size])
    parent = helper.create_variable_for_type_inference("int32",
                                                       shape=[b, beam_size])
    inputs = {"pre_ids": [pre_ids.name], "pre_scores": [pre_scores.name],
              "scores": [scores.name]}
    if ids is not None:
        inputs["ids"] = [ids.name]
    helper.append_op(type="beam_search", inputs=inputs,
                     outputs={"selected_ids": [sel_ids.name],
                              "selected_scores": [sel_scores.name],
                              "parent_idx": [parent.name]},
                     attrs={"beam_size": beam_size, "end_id": end_id,
                            "level": level})
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    """Backtrack per-step beam selections (ids stacked [T, batch, beam],
    parents from the matching ``parent_idx`` stack) into full sequences.
    ``ids`` is a pair (step_ids, step_parents); returns
    (sentence_ids [batch, beam, T], sentence_scores [batch, beam])."""
    helper = LayerHelper("beam_search_decode", name=name)
    step_ids, step_parents = ids
    t, b, w = step_ids.shape
    sent = helper.create_variable_for_type_inference("int32",
                                                     shape=[b, w, t])
    sent_scores = helper.create_variable_for_type_inference(
        scores.dtype, shape=[b, w])
    sent_lens = helper.create_variable_for_type_inference("int32",
                                                          shape=[b, w])
    helper.append_op(type="beam_search_decode",
                     inputs={"ids": [step_ids.name],
                             "parents": [step_parents.name],
                             "scores": [scores.name]},
                     outputs={"sentence_ids": [sent.name],
                              "sentence_scores": [sent_scores.name],
                              "sentence_lens": [sent_lens.name]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return sent, sent_scores


def beam_expand(x, beam_size, name=None):
    """Fan each batch row out to its beam candidates:
    [batch, ...] -> [batch*beam, ...] (row i repeats beam times)."""
    helper = LayerHelper("beam_expand", name=name)
    shape = list(x.shape)
    if shape:
        shape[0] = -1 if shape[0] in (-1, None) else shape[0] * beam_size
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="beam_expand", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"beam_size": beam_size})
    return out


def beam_gather(x, parent, name=None):
    """Reorder beam-major rows by parent beam index (used after a
    beam_search step to pull each selected beam's state forward):
    x [batch*beam, ...], parent [batch, beam] -> [batch*beam, ...]."""
    helper = LayerHelper("beam_gather", name=name)
    out = helper.create_variable_for_type_inference(x.dtype,
                                                    shape=list(x.shape))
    helper.append_op(type="beam_gather",
                     inputs={"X": [x.name], "Parent": [parent.name]},
                     outputs={"Out": [out.name]})
    return out
