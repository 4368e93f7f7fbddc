"""Program transpilers (port of ``paddle_tpu/transpiler``): AMP,
rematerialisation, the inference conv+batch_norm fold, weight-only int8
quantization, the fused optimizer updates, and the distribute
transpilers (parallel/transpiler.py)."""
from ..parallel.transpiler import (DistributeTranspiler,          # noqa: F401
                                   DistributeTranspilerConfig,
                                   ShardingTranspiler)
from .amp import amp_transpile, decorate_amp                      # noqa: F401
from .fuse_optimizer import fuse_optimizer_ops                    # noqa: F401
from .inference_transpiler import InferenceTranspiler             # noqa: F401
from .memory_optimization import memory_optimize, release_memory  # noqa: F401
from .quantize_transpiler import QuantizeTranspiler               # noqa: F401

__all__ = ["amp_transpile", "decorate_amp", "fuse_optimizer_ops",
           "InferenceTranspiler", "QuantizeTranspiler", "memory_optimize",
           "release_memory", "DistributeTranspiler",
           "DistributeTranspilerConfig", "ShardingTranspiler", "HashName",
           "RoundRobin"]


class HashName:
    """fluid-compat pserver dispatcher (reference ps_dispatcher.py);
    meaningless on a mesh but kept for API parity."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)

    def dispatch(self, varlist):
        return [self._eps[hash(v.name) % len(self._eps)] for v in varlist]


class RoundRobin:
    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._i = 0

    def dispatch(self, varlist):
        out = []
        for v in varlist:
            out.append(self._eps[self._i])
            self._i = (self._i + 1) % len(self._eps)
        return out
