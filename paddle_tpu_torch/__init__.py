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
``CPUPlace()`` (or calls ``force_cpu()`` for the whole process). The package imports torch and numpy, never jax and
nothing of paddle_tpu.
"""
# op lowering rules must register before any program executes
from .ops import basic as _ops_basic          # noqa: F401
from .ops import nn as _ops_nn                # noqa: F401
from .ops import transformer_ops as _ops_tf   # noqa: F401
from .ops import optimizer_ops as _ops_opt    # noqa: F401
from .ops import fused_loss as _ops_loss      # noqa: F401
from .ops import sequence as _ops_seq         # noqa: F401
from .ops import rnn as _ops_rnn              # noqa: F401
from .ops import control_flow as _ops_cf      # noqa: F401
from .ops import crf_ctc as _ops_crf          # noqa: F401
from .ops import eval_ops as _ops_eval        # noqa: F401
from .ops import detection as _ops_det        # noqa: F401
from .ops import extras as _ops_extras        # noqa: F401

from .core.framework import (                  # noqa: F401
    Program, Block, Variable, Parameter, Operator,
    default_main_program, default_startup_program, program_guard,
    switch_main_program, switch_startup_program, name_scope, get_var)
from .core.executor import (                   # noqa: F401
    Executor, Scope, global_scope, scope_guard, _switch_scope,
    CPUPlace, TPUPlace, CUDAPlace, force_cpu)
from .core import unique_name                  # noqa: F401
from .core.sequence import SequenceBatch, to_sequence_batch  # noqa: F401
from . import lod_tensor                       # noqa: F401
from .lod_tensor import (create_lod_tensor,    # noqa: F401
                         create_random_int_lodtensor)

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
from . import analysis                         # noqa: F401
from . import transpiler                       # noqa: F401
from .transpiler import (memory_optimize, release_memory,  # noqa: F401
                         InferenceTranspiler)
from .data_feeder import DataFeeder            # noqa: F401
from . import io                               # noqa: F401
from . import reader                           # noqa: F401
from .reader import batch                      # noqa: F401
from .trainer import (Trainer, BeginEpochEvent, EndEpochEvent,  # noqa: F401
                      BeginStepEvent, EndStepEvent, CheckpointConfig)
from .inferencer import Inferencer             # noqa: F401
from . import models                           # noqa: F401
from . import nets                             # noqa: F401
from . import parallel                         # noqa: F401
from . import contrib                          # noqa: F401
from . import evaluator                        # noqa: F401
from . import metrics                          # noqa: F401
from . import average                          # noqa: F401
from . import dataset                          # noqa: F401
from . import profiler                         # noqa: F401
from . import recordio_writer                  # noqa: F401
from . import default_scope_funcs              # noqa: F401
from . import concurrency                      # noqa: F401
from .concurrency import (make_channel, channel_send, channel_recv,  # noqa: F401
                          channel_close, Select)
from .parallel import (ParallelExecutor, ExecutionStrategy,  # noqa: F401
                       BuildStrategy, DistributeTranspiler)
from .waiting import FLEET, module_getattr

__version__ = "0.1.0"

# the reference's top-level names of a later ROADMAP.md item
WAITING = {"cluster": FLEET}
__getattr__ = module_getattr(__name__, WAITING)
