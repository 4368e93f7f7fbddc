"""Inference transpiler (port of
``paddle_tpu/transpiler/inference_transpiler.py``; parity with
python/paddle/fluid/transpiler/inference_transpiler.py): folds each
test-mode batch_norm into the conv2d before it, at the program level,
rewriting the scope's filter and adding a bias.

The fold runs in torch on the filter's own device (the scope's tensors
live on the card), in float32 as the reference's numpy does, with every
quotient a tensor division: on the CPU the folded filters equal the
reference's numpy fold bit for bit.
"""
import numpy as np
import torch

from ..core import framework
from ..core.executor import global_scope

__all__ = ["InferenceTranspiler"]


def _tensor(v, device=None):
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t if device is None else t.to(device)


def fold_conv_bn(w, scale, bias, mean, var, eps):
    """(folded filter, folded bias) for a conv filter ``w`` [cout, ...]
    followed by a test-mode batch_norm: w' = w·γ/√(var + ε) per output
    channel, b' = β − μ·γ/√(var + ε), in ``w``'s dtype."""
    dev = w.device
    scale, bias, mean, var = (_tensor(v, dev)
                              for v in (scale, bias, mean, var))
    inv = scale / torch.sqrt(var + eps)
    folded = (w * inv.reshape((-1,) + (1,) * (w.dim() - 1))).to(w.dtype)
    return folded, (bias - mean * inv).to(w.dtype)


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        """Returns a test-mode program with conv+batch_norm folded.

        For a conv2d (no bias) directly followed by batch_norm in test
        mode:  w' = w * gamma / sqrt(var + eps) (per out-channel),
               b' = beta - gamma * mean / sqrt(var + eps).
        """
        scope = scope or global_scope()
        p = program.clone(for_test=True)
        gb = p.global_block()
        new_ops = []
        i = 0
        while i < len(gb.ops):
            op = gb.ops[i]
            nxt = gb.ops[i + 1] if i + 1 < len(gb.ops) else None
            if (op.type == "conv2d" and nxt is not None
                    and nxt.type == "batch_norm"
                    and nxt.input("X") == op.output("Output")):
                w_name = op.input("Filter")[0]
                stats = [scope.find_var(nxt.input(s)[0]) for s in
                         ("Scale", "Bias", "Mean", "Variance")]
                w = scope.find_var(w_name)
                if all(v is not None for v in stats + [w]):
                    w, new_bias = fold_conv_bn(
                        _tensor(w), *stats, nxt.attr("epsilon", 1e-5))
                    scope.set(w_name, w)
                    bias_name = w_name + "@bn_folded_bias"
                    gb.create_var(name=bias_name,
                                  shape=list(new_bias.shape),
                                  dtype=str(new_bias.dtype).replace(
                                      "torch.", ""),
                                  persistable=True)
                    scope.set(bias_name, new_bias)
                    new_ops.append(op)
                    c_axis = (3 if op.attr("data_format") == "NHWC"
                              else 1)
                    add = framework.Operator(
                        gb, "elementwise_add",
                        {"X": op.output("Output"), "Y": [bias_name]},
                        {"Out": nxt.output("Y")}, {"axis": c_axis})
                    new_ops.append(add)
                    i += 2
                    continue
            new_ops.append(op)
            i += 1
        gb.ops = new_ops
        p._bump()
        return p
