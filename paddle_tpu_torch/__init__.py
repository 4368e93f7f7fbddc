"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package grows
beside it slice by slice, with the same Fluid-style API, so reference
scripts run with ``import paddle_tpu_torch as fluid``::

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.llama import LLAMA3_8B, build_llama
    tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                               dtype="int64", append_batch_size=False)
    targets = fluid.layers.data(name="targets", shape=[-1, -1],
                                dtype="int64", append_batch_size=False)
    _, loss = build_llama(LLAMA3_8B, tokens, targets)
    fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    exe = fluid.Executor()                  # the card: CUDAPlace(0)
    exe.run(fluid.default_startup_program())
    exe.run(feed={"tokens": ..., "targets": ...}, fetch_list=[loss])

Programs run op by op on torch tensors; the reference's Pallas kernels
are hand-written Hopper kernels (``csrc/``), built with nvcc at first
use. Entry points run on the card unless the caller passes
``CPUPlace()``. The package imports torch and numpy, never jax and
nothing of paddle_tpu.
"""
# op lowering rules must register before any program executes
from .ops import basic as _ops_basic          # noqa: F401
from .ops import nn as _ops_nn                # noqa: F401
from .ops import transformer_ops as _ops_tf   # noqa: F401
from .ops import optimizer_ops as _ops_opt    # noqa: F401
from .ops import fused_loss as _ops_loss      # noqa: F401

from .core.framework import (                  # noqa: F401
    Program, Block, Variable, Parameter, Operator,
    default_main_program, default_startup_program, program_guard,
    switch_main_program, switch_startup_program, name_scope, get_var)
from .core.executor import (                   # noqa: F401
    Executor, Scope, global_scope, scope_guard, _switch_scope,
    CPUPlace, TPUPlace, CUDAPlace)
from .core import unique_name                  # noqa: F401

from . import layers                           # noqa: F401
from . import initializer                      # noqa: F401
from . import optimizer                        # noqa: F401
from . import regularizer                      # noqa: F401
from . import clip                             # noqa: F401
from .core.backward import append_backward     # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from . import resilience                       # noqa: F401
from . import serving                          # noqa: F401
from . import weights                          # noqa: F401
from . import debugger                         # noqa: F401
from . import transpiler                       # noqa: F401
from .transpiler import memory_optimize        # noqa: F401

__version__ = "0.1.0"
