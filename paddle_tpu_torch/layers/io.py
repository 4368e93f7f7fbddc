"""Data-input layers (port of ``paddle_tpu/layers/io.py``). This slice
carries ``data``; the in-graph readers arrive with the io slice
(ROADMAP.md item 'IO, persistables and Inferencer')."""
from ..core import framework

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=None):
    """Declares an input variable (reference
    python/paddle/fluid/layers/io.py data()): prepends a -1 batch dim when
    ``append_batch_size`` and none of the dims is already -1."""
    shape = list(shape)
    if append_batch_size and -1 not in shape:
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, stop_gradient=stop_gradient,
                            is_data=True)
