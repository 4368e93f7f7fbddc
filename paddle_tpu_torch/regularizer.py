"""Weight-decay regularizers (port of ``paddle_tpu/regularizer.py``, a
copy).

Parity with python/paddle/fluid/regularizer.py: L1/L2 decay append ops
that add the penalty gradient onto each parameter's gradient before the
optimizer op consumes it.
"""
__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def _append_ops(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_ops(self, param, grad, block):
        # grad += coeff * param
        tmp = block.create_var(
            name=grad.name + "@L2", shape=param.shape, dtype=param.dtype,
            stop_gradient=True)
        block.append_op(type="scale", inputs={"X": [param.name]},
                        outputs={"Out": [tmp.name]},
                        attrs={"scale": self._coeff})
        block.append_op(type="elementwise_add",
                        inputs={"X": [grad.name], "Y": [tmp.name]},
                        outputs={"Out": [grad.name]}, attrs={"axis": -1})


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_ops(self, param, grad, block):
        sign = block.create_var(
            name=grad.name + "@L1SIGN", shape=param.shape, dtype=param.dtype,
            stop_gradient=True)
        block.append_op(type="sign", inputs={"X": [param.name]},
                        outputs={"Out": [sign.name]})
        tmp = block.create_var(
            name=grad.name + "@L1", shape=param.shape, dtype=param.dtype,
            stop_gradient=True)
        block.append_op(type="scale", inputs={"X": [sign.name]},
                        outputs={"Out": [tmp.name]},
                        attrs={"scale": self._coeff})
        block.append_op(type="elementwise_add",
                        inputs={"X": [grad.name], "Y": [tmp.name]},
                        outputs={"Out": [grad.name]}, attrs={"axis": -1})


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Per-param regularizer wins over the optimizer-wide default, like
    fluid (reference python/paddle/fluid/regularizer.py
    append_regularization_ops)."""
    out = []
    for param, grad in parameters_and_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is not None:
            reg._append_ops(param, grad, grad.block)
        out.append((param, grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
