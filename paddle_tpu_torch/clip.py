"""Gradient clipping (port of ``paddle_tpu/clip.py``, a copy).

Parity with python/paddle/fluid/clip.py: GradientClipByValue/ByNorm/
ByGlobalNorm + set_gradient_clip + ErrorClipByValue.
"""
from .core import framework
from .layer_helper import LayerHelper

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops"]


class BaseErrorClipAttr:
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process(self, params_grads):
        return params_grads


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _process(self, params_grads):
        for p, g in params_grads:
            g.block.append_op(type="clip", inputs={"X": [g.name]},
                              outputs={"Out": [g.name]},
                              attrs={"min": self.min, "max": self.max})
        return params_grads


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        for p, g in params_grads:
            g.block.append_op(type="clip_by_norm", inputs={"X": [g.name]},
                              outputs={"Out": [g.name]},
                              attrs={"max_norm": self.clip_norm})
        return params_grads


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        # group_name (reference clip.py): all grads whose attr shares a
        # group_name are clipped against ONE joint global norm, even
        # across separate attr instances (append_gradient_clip_ops
        # groups by this name). clip_norm of the group comes from the
        # first instance seen, like the reference's group_scale.
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process(self, params_grads):
        if not params_grads:
            return params_grads
        block = params_grads[0][1].block
        helper = LayerHelper("global_norm_clip")
        sq_vars = []
        for p, g in params_grads:
            sq = helper.create_variable_for_type_inference("float32",
                                                           shape=[1],
                                                           stop_gradient=True)
            block.append_op(type="squared_l2_norm", inputs={"X": [g.name]},
                            outputs={"Out": [sq.name]})
            sq_vars.append(sq)
        total = helper.create_variable_for_type_inference("float32",
                                                          shape=[1],
                                                          stop_gradient=True)
        block.append_op(type="sum", inputs={"X": [v.name for v in sq_vars]},
                        outputs={"Out": [total.name]})
        gnorm = helper.create_variable_for_type_inference("float32",
                                                          shape=[1],
                                                          stop_gradient=True)
        block.append_op(type="sqrt", inputs={"X": [total.name]},
                        outputs={"Out": [gnorm.name]})
        # scale = clip_norm / max(gnorm, clip_norm)
        clip_var = helper.create_variable_for_type_inference(
            "float32", shape=[1], stop_gradient=True)
        block.append_op(type="fill_constant", outputs={"Out": [clip_var.name]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": self.clip_norm})
        denom = helper.create_variable_for_type_inference("float32",
                                                          shape=[1],
                                                          stop_gradient=True)
        block.append_op(type="elementwise_max",
                        inputs={"X": [gnorm.name], "Y": [clip_var.name]},
                        outputs={"Out": [denom.name]}, attrs={"axis": -1})
        factor = helper.create_variable_for_type_inference("float32",
                                                           shape=[1],
                                                           stop_gradient=True)
        block.append_op(type="elementwise_div",
                        inputs={"X": [clip_var.name], "Y": [denom.name]},
                        outputs={"Out": [factor.name]}, attrs={"axis": -1})
        for p, g in params_grads:
            block.append_op(type="elementwise_mul",
                            inputs={"X": [g.name], "Y": [factor.name]},
                            outputs={"Out": [g.name]}, attrs={"axis": -1})
        return params_grads


_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip
    if param_list:
        for p in param_list:
            v = p if isinstance(p, framework.Variable) else \
                framework.default_main_program().global_block().var(p)
            v.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """Applies per-param clip attrs, falling back to set_gradient_clip's
    global clip. Global-norm clip groups params by ``group_name`` — two
    attr instances with the same group share ONE joint global norm,
    like the reference (clip.py group_scale_name)."""
    global_groups = {}
    out = []
    for p, g in param_grads:
        clip = getattr(p, "gradient_clip_attr", None) or _global_clip
        if clip is None:
            out.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            global_groups.setdefault(clip.group_name,
                                     (clip, []))[1].append((p, g))
            out.append((p, g))
        else:
            clip._process([(p, g)])
            out.append((p, g))
    for clip, pgs in global_groups.values():
        clip._process(pgs)
    return out
