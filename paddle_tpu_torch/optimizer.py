"""Optimizers (port of ``paddle_tpu/optimizer.py``, a copy).

Parity with python/paddle/fluid/optimizer.py: SGD, Momentum, Adagrad,
Adam, Adamax, DecayedAdagrad, Ftrl, RMSProp, Adadelta, ModelAverage, plus
LAMB — each appends its update ops to the program after
``append_backward``, so one ``Executor.run`` is one whole train step
(forward, backward, update). The update rules are
``ops/optimizer_ops.py``.
"""

from .core import framework, unique_name
from .core.backward import append_backward
from .layer_helper import LayerHelper
from . import initializer as init_mod
from .regularizer import append_regularization_ops
from . import clip as clip_mod

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
    "Ftrl", "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
    "AdamOptimizer", "AdamaxOptimizer", "DecayedAdagradOptimizer",
    "RMSPropOptimizer", "FtrlOptimizer", "Adadelta", "AdadeltaOptimizer",
    "ModelAverage", "LambOptimizer", "Optimizer",
    "ProximalGD", "ProximalGDOptimizer", "ProximalAdagrad",
    "ProximalAdagradOptimizer",
]


class Optimizer:
    """Base optimizer (reference python/paddle/fluid/optimizer.py)."""

    def __init__(self, learning_rate, regularization=None,
                 LARS_weight_decay=0.0, name=None):
        if not isinstance(learning_rate, (float, int, framework.Variable)):
            raise TypeError("learning rate should be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._lr_var = None
        self._accumulators = {}
        self.helper = None

    # -- learning rate --------------------------------------------------
    def _create_lr_var(self, program):
        if isinstance(self._learning_rate, framework.Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        helper = LayerHelper("learning_rate")
        var = helper.create_global_variable(
            shape=[1], dtype="float32", persistable=True,
            name=unique_name.generate("learning_rate"))
        helper.set_variable_initializer(
            var, init_mod.Constant(float(self._learning_rate)))
        self._lr_var = var

    @property
    def global_learning_rate(self):
        return self._lr_var

    def _lr_input(self, param):
        """Honors ParamAttr(learning_rate=mult) by scaling the global LR
        once per distinct multiplier (reference optimizer.py
        _create_param_lr)."""
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return {"LearningRate": [self._lr_var.name]}
        if not hasattr(self, "_scaled_lr_vars"):
            self._scaled_lr_vars = {}
        if mult not in self._scaled_lr_vars:
            block = framework.default_main_program().global_block()
            v = block.create_var(
                name=unique_name.generate(self._lr_var.name + "_scaled"),
                shape=[1], dtype="float32", stop_gradient=True)
            block.append_op(type="scale", inputs={"X": [self._lr_var.name]},
                            outputs={"Out": [v.name]},
                            attrs={"scale": float(mult)})
            self._scaled_lr_vars[mult] = v
        return {"LearningRate": [self._scaled_lr_vars[mult].name]}

    # -- accumulators ---------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                        dtype=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        helper = LayerHelper(name)
        acc_shape = shape if shape is not None else list(param.shape)
        var = helper.create_global_variable(
            shape=acc_shape,
            dtype=dtype or param.dtype, persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"))
        helper.set_variable_initializer(var,
                                        init_mod.Constant(float(fill_value)))
        # a param-shaped accumulator (momentum, adam moments, ...) must
        # shard like its parameter: for a vocab-sharded embedding table
        # the optimizer state would otherwise replicate the full table
        # on every device
        psharding = getattr(param, "sharding", None)
        if psharding is not None and list(acc_shape) == list(param.shape):
            var.sharding = psharding
        self._accumulators[key] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    # -- hooks ----------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- main entry -----------------------------------------------------
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        if not params_grads:
            raise ValueError(
                "no trainable parameters to optimize: every parameter is "
                "either trainable=False or in no_grad_set")
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        prog = loss.block.program
        block = prog.global_block()
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_lr_var(prog)
        self._create_accumulators(block, [p for p, g in params_grads])
        opt_ops = []
        for pg in params_grads:
            opt_ops.append(self._append_optimize_op(block, pg))
        self._finish_update(block, params_grads)
        return opt_ops, params_grads


def append_gradient_clip_ops(params_grads):
    return clip_mod.append_gradient_clip_ops(params_grads)


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            type="sgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    **self._lr_input(p)},
            outputs={"ParamOut": [p.name]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Velocity": [v.name], **self._lr_input(p)},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    **self._lr_input(p)},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    """``moment_dtype`` (default: the parameter dtype) sets the stored
    dtype of both moments — pass "float32" to keep f32 optimizer state
    over bf16 parameters (update math always runs in f32 either way;
    see ops/optimizer_ops.py _f32)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, moment_dtype=None, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._moment_dtype = moment_dtype

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p, dtype=self._moment_dtype)
            self._add_accumulator("moment2", p, dtype=self._moment_dtype)
        # ALWAYS f32: in bf16, 0.999 rounds to 1.0, which makes the
        # bias-corrected lr sqrt(1 - beta2^t)/(1 - beta1^t) exactly 0 —
        # a bf16-param model would silently never update
        self._beta1_pow = self._add_accumulator(
            "beta1_pow_acc", parameters[0], fill_value=self._beta1,
            shape=[1], dtype="float32")
        self._beta2_pow = self._add_accumulator(
            "beta2_pow_acc", parameters[0], fill_value=self._beta2,
            shape=[1], dtype="float32")

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        return block.append_op(
            type="adam",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "Beta1Pow": [self._beta1_pow.name],
                    "Beta2Pow": [self._beta2_pow.name],
                    **self._lr_input(p)},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        for pow_acc, beta in [(self._beta1_pow, self._beta1),
                              (self._beta2_pow, self._beta2)]:
            block.append_op(type="scale", inputs={"X": [pow_acc.name]},
                            outputs={"Out": [pow_acc.name]},
                            attrs={"scale": beta})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
        self._beta1_pow = self._add_accumulator(
            "beta1_pow_acc", parameters[0], fill_value=self._beta1,
            shape=[1], dtype="float32")

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        return block.append_op(
            type="adamax",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "InfNorm": [inf.name],
                    "Beta1Pow": [self._beta1_pow.name],
                    **self._lr_input(p)},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name],
                     "InfNormOut": [inf.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        block.append_op(type="scale", inputs={"X": [self._beta1_pow.name]},
                        outputs={"Out": [self._beta1_pow.name]},
                        attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    **self._lr_input(p)},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        asg = self._get_accumulator("__avg_squared_grad", p)
        asu = self._get_accumulator("__avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "AvgSquaredGrad": [asg.name],
                    "AvgSquaredUpdate": [asu.name]},
            outputs={"ParamOut": [p.name], "AvgSquaredGradOut": [asg.name],
                     "AvgSquaredUpdateOut": [asu.name]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        inputs = {"Param": [p.name], "Grad": [g.name], "Moment": [mom.name],
                  "MeanSquare": [ms.name], **self._lr_input(p)}
        outputs = {"ParamOut": [p.name], "MomentOut": [mom.name],
                   "MeanSquareOut": [ms.name]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            inputs["MeanGrad"] = [mg.name]
            outputs["MeanGradOut"] = [mg.name]
        return block.append_op(
            type="rmsprop", inputs=inputs, outputs=outputs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "SquaredAccumulator": [sq.name],
                    "LinearAccumulator": [lin.name], **self._lr_input(p)},
            outputs={"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    """Layer-adaptive large-batch optimizer — TPU pods want big batches."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        return block.append_op(
            type="lamb",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    **self._lr_input(p)},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon,
                   "weight_decay": self._weight_decay})


class ModelAverage(Optimizer):
    """Maintains an exponential/windowed average of parameters for eval
    (reference python/paddle/fluid/optimizer.py ModelAverage). As in the
    JAX package: accumulates sum+count persistably; ``apply()`` swaps
    averaged params into the scope, ``restore()`` swaps back."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self._params = []
        program = framework.default_main_program()
        for p in program.all_parameters():
            if getattr(p, "do_model_average", True):
                self._params.append(p)
        block = program.global_block()
        self._sums, self._cnt = {}, None
        helper = LayerHelper("model_average")
        for p in self._params:
            s = helper.create_global_variable(shape=list(p.shape),
                                              dtype=p.dtype, persistable=True,
                                              name=p.name + "_sum")
            helper.set_variable_initializer(s, init_mod.Constant(0.0))
            block.append_op(type="elementwise_add",
                            inputs={"X": [s.name], "Y": [p.name]},
                            outputs={"Out": [s.name]}, attrs={"axis": -1})
            self._sums[p.name] = s
        cnt = helper.create_global_variable(shape=[1], dtype="float32",
                                            persistable=True,
                                            name=unique_name.generate("ma_cnt"))
        helper.set_variable_initializer(cnt, init_mod.Constant(0.0))
        block.append_op(type="increment", inputs={"X": [cnt.name]},
                        outputs={"Out": [cnt.name]}, attrs={"step": 1.0})
        self._cnt = cnt

    def apply(self, executor, need_restore=True):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            from .core.executor import global_scope
            scope = global_scope()
            backup = {}
            cnt = max(float(scope.find_var(self._cnt.name).reshape(-1)[0]),
                      1.0)
            for p in self._params:
                backup[p.name] = scope.find_var(p.name)
                s = scope.find_var(self._sums[p.name].name)
                scope.set(p.name, s / cnt)
            try:
                yield
            finally:
                if need_restore:
                    for k, v in backup.items():
                        scope.set(k, v)
        return ctx()

    def restore(self, executor):
        pass


# fluid aliases
class ProximalGDOptimizer(Optimizer):
    """Proximal gradient descent with l1/l2 regularization (reference
    proximal_gd_op.h): param = prox_{lr*l1,lr*l2}(param - lr * grad)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            type="proximal_gd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    **self._lr_input(p)},
            outputs={"ParamOut": [p.name]},
            attrs={"l1": self._l1, "l2": self._l2})


class ProximalAdagradOptimizer(Optimizer):
    """Proximal Adagrad (reference proximal_adagrad_op.h)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="proximal_adagrad",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment": [m.name], **self._lr_input(p)},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"l1": self._l1, "l2": self._l2})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
