"""Program transpilers (port of ``paddle_tpu/transpiler``): AMP,
rematerialisation, the inference conv+batch_norm fold, weight-only int8
quantization and the fused optimizer updates. The distribute transpilers
are a later slice of the torch port (ROADMAP.md item 'Multi-device
parallelism') and are refused by name."""
from ..waiting import MESH, module_getattr
from .amp import amp_transpile, decorate_amp                      # noqa: F401
from .fuse_optimizer import fuse_optimizer_ops                    # noqa: F401
from .inference_transpiler import InferenceTranspiler             # noqa: F401
from .memory_optimization import memory_optimize, release_memory  # noqa: F401
from .quantize_transpiler import QuantizeTranspiler               # noqa: F401

__all__ = ["amp_transpile", "decorate_amp", "fuse_optimizer_ops",
           "InferenceTranspiler", "QuantizeTranspiler", "memory_optimize",
           "release_memory"]

WAITING = dict.fromkeys(("DistributeTranspiler",
                         "DistributeTranspilerConfig", "ShardingTranspiler",
                         "HashName", "RoundRobin"), MESH)
__getattr__ = module_getattr(__name__, WAITING)
