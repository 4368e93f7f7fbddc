"""Weight-only int8 inference quantization (port of
``paddle_tpu/transpiler/quantize_transpiler.py``).

``QuantizeTranspiler.transpile(program)`` returns a test-mode program
with every ``mul``/``conv2d`` whose weight is a persistable scope
parameter rewritten to ``quantized_mul``/``quantized_conv2d``
(``ops/extras.py``), and rewrites the scope: weight → int8, plus a
``<w>@scale`` float32 vector. The quantization runs in torch on the
weight's own device; its int8 values and scales are the reference's
numpy recipe byte for byte (every quotient a tensor division).
"""
import numpy as np
import torch

from ..core import framework
from ..core.executor import global_scope

__all__ = ["QuantizeTranspiler"]


def _quantize(w, axis):
    """Symmetric per-channel int8: scale = max|w| / 127 over all axes
    except ``axis`` (at least 1e-10), values rounded half to even and
    clipped to [-127, 127]. Returns (int8 weight, float32 scale)."""
    red = tuple(i for i in range(w.dim()) if i != axis)
    m = torch.amax(torch.abs(w), dim=red)
    scale = torch.clamp(m / torch.full_like(m, 127.0), min=1e-10) \
        .to(torch.float32)
    shape = [1] * w.dim()
    shape[axis] = -1
    wq = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127)
    return wq.to(torch.int8), scale


class QuantizeTranspiler:
    # op type -> (weight slot, channel axis of the weight)
    _TARGETS = {"mul": ("Y", 1), "conv2d": ("Filter", 0)}

    def transpile(self, program, place=None, scope=None):
        """Returns the quantized test-mode program; scope weights are
        rewritten in place (int8 + ``@scale``)."""
        scope = scope or global_scope()
        p = program.clone(for_test=True)
        gb = p.global_block()
        new_ops = []
        for op in gb.ops:
            slot_axis = self._TARGETS.get(op.type)
            if slot_axis is None:
                new_ops.append(op)
                continue
            slot, axis = slot_axis
            w_name = op.input(slot)[0]
            w_var = gb.var(w_name) if gb.has_var_local(w_name) else None
            w = scope.find_var(w_name)
            if w is None or w_var is None or not w_var.persistable:
                new_ops.append(op)
                continue
            if not isinstance(w, torch.Tensor):
                w = torch.as_tensor(np.asarray(w))
            if w.dtype != torch.int8:    # int8: already quantized (shared)
                wq, scale = _quantize(w, axis)
                scope.set(w_name, wq)
                scope.set(w_name + "@scale", scale)
                w_var.dtype = "int8"
                gb.create_var(name=w_name + "@scale",
                              shape=[int(w.shape[axis])], dtype="float32",
                              persistable=True)
            inputs = {k: list(v) for k, v in op.inputs.items()}
            inputs["Scale"] = [w_name + "@scale"]
            outputs = {k: list(v) for k, v in op.outputs.items()}
            new_ops.append(framework.Operator(
                gb, "quantized_" + op.type, inputs, outputs,
                dict(op.attrs)))
        gb.ops = new_ops
        p._bump()
        return p
