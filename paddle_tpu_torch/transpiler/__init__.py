"""Program transpilers (port of ``paddle_tpu/transpiler``): AMP and
rematerialisation. The distribute, inference, quantize and
fuse-optimizer transpilers are later slices of the torch port
(ROADMAP.md items 'Conv nets and the transpilers' and 'Multi-device
parallelism') and are refused by name."""
from ..waiting import CONV, MESH, module_getattr
from .amp import amp_transpile, decorate_amp                      # noqa: F401
from .memory_optimization import memory_optimize, release_memory  # noqa: F401

__all__ = ["amp_transpile", "decorate_amp", "memory_optimize",
           "release_memory"]

WAITING = {**dict.fromkeys(("InferenceTranspiler", "QuantizeTranspiler",
                            "fuse_optimizer_ops"), CONV),
           **dict.fromkeys(("DistributeTranspiler",
                            "DistributeTranspilerConfig",
                            "ShardingTranspiler", "HashName",
                            "RoundRobin"), MESH)}
__getattr__ = module_getattr(__name__, WAITING)
