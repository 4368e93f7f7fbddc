"""LayerHelper — shared plumbing for layer functions.

Parity with python/paddle/fluid/layer_helper.py: creates parameters (in
the main program, with their init ops in the startup program), temp
variables, and appends activation ops.
"""
from .core import framework, unique_name
from .param_attr import ParamAttr, WeightNormParamAttr
from . import initializer as init_mod

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # ------------------------------------------------------------------
    def input(self, name="input"):
        return self.kwargs[name]

    def multiple_input(self, name="input"):
        v = self.kwargs[name]
        return list(v) if isinstance(v, (list, tuple)) else [v]

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    # ------------------------------------------------------------------
    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        suffix = "b" if is_bias else "w"
        name = attr._name_with_prefix(self.name, suffix)
        if default_initializer is None:
            default_initializer = (init_mod.Constant(0.0) if is_bias
                                   else init_mod.Xavier())
        initr = attr.initializer or default_initializer
        shape = [int(s) for s in shape]

        if isinstance(attr, WeightNormParamAttr) and not is_bias:
            return self._create_weight_normalized(attr, name, shape, dtype,
                                                  initr)

        param = self.main_program.global_block().create_parameter(
            name=name, shape=shape, dtype=dtype,
            trainable=attr.trainable, regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            do_model_average=attr.do_model_average, initializer=initr)
        param.optimize_attr = {"learning_rate": attr.learning_rate}

        # mirror into startup program with the init op
        sb = self.startup_program.global_block()
        if not sb.has_var_local(name):
            sv = sb.create_parameter(name=name, shape=shape, dtype=dtype,
                                     trainable=attr.trainable)
            initr(sv, sb)
        return param

    def _create_weight_normalized(self, attr, name, shape, dtype, initr):
        """Weight normalization (reference layer_helper.py
        _create_weight_normalize:112): the trainable state is direction
        ``name.w_v`` (layer initializer) and magnitude ``name.w_g``
        (startup-initialized to ||v|| so training starts at w = v); the
        layer consumes the derived W = g * v/||v||, one fused op in the
        step executable."""
        dim = -1 if attr.dim is None else int(attr.dim)
        block = self.main_program.global_block()
        mk = dict(trainable=attr.trainable, regularizer=attr.regularizer,
                  gradient_clip_attr=attr.gradient_clip,
                  do_model_average=attr.do_model_average)
        gshape = [1] if dim < 0 else [int(shape[dim])]
        v = block.create_parameter(name=name + ".w_v", shape=shape,
                                   dtype=dtype, initializer=initr, **mk)
        g = block.create_parameter(name=name + ".w_g", shape=gshape,
                                   dtype=dtype,
                                   initializer=init_mod.Constant(1.0), **mk)
        v.optimize_attr = {"learning_rate": attr.learning_rate}
        g.optimize_attr = {"learning_rate": attr.learning_rate}

        sb = self.startup_program.global_block()
        if not sb.has_var_local(v.name):
            sv = sb.create_parameter(name=v.name, shape=shape, dtype=dtype,
                                     trainable=attr.trainable)
            initr(sv, sb)
            sb.create_parameter(name=g.name, shape=gshape, dtype=dtype,
                                trainable=attr.trainable)
            sb.append_op(type="weight_norm_g_init",
                         inputs={"V": [v.name]}, outputs={"G": [g.name]},
                         attrs={"dim": dim})

        w = self.create_variable_for_type_inference(dtype, shape=shape)
        self.append_op(type="weight_norm",
                       inputs={"V": [v.name], "G": [g.name]},
                       outputs={"W": [w.name]}, attrs={"dim": dim})
        return w

    def get_parameter(self, name):
        """Look up an existing parameter by name (reference
        layer_helper.py get_parameter) — used to share weights across
        layers, e.g. crf_decoding reusing linear_chain_crf's
        transition."""
        param = self.main_program.global_block().var(name)
        return param

    def create_variable_for_type_inference(self, dtype="float32", shape=None,
                                           stop_gradient=False, lod_level=0):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, shape=shape, stop_gradient=stop_gradient,
            lod_level=lod_level)

    # fluid old-API alias
    create_tmp_variable = create_variable_for_type_inference

    def create_global_variable(self, shape, dtype="float32", persistable=True,
                               name=None, stop_gradient=True):
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(".".join([self.name, "global"])),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def set_variable_initializer(self, var, initializer):
        """Registers ``var`` (a persistable main-program var) in the startup
        program with ``initializer`` — used for optimizer accumulators,
        batch-norm stats, global counters."""
        sb = self.startup_program.global_block()
        if not sb.has_var_local(var.name):
            sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                               persistable=True)
            initializer(sv, sb)
        return var

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape,
            lod_level=input_var.lod_level)
        self.append_op(type=act_type, inputs={"X": [input_var.name]},
                       outputs={"Out": [out.name]}, attrs=act)
        return out

    def append_bias_op(self, input_var, bias, dim_start=1):
        if bias is None:
            return input_var
        out = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape,
            lod_level=input_var.lod_level)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var.name], "Y": [bias.name]},
                       outputs={"Out": [out.name]}, attrs={"axis": -1})
        return out
