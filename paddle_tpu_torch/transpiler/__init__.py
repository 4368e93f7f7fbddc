"""Program transpilers (port of ``paddle_tpu/transpiler``): AMP and
rematerialisation. The distribute, inference, quantize and
fuse-optimizer transpilers are later slices of the torch port
(ROADMAP.md items 'Conv nets and the transpilers' and 'Multi-device
parallelism')."""
from .amp import amp_transpile, decorate_amp                      # noqa: F401
from .memory_optimization import memory_optimize                  # noqa: F401

__all__ = ["amp_transpile", "decorate_amp", "memory_optimize"]
