"""PartitionSpec — the port's own sharding annotation type.

The reference annotates variables with ``jax.sharding.PartitionSpec``
(``var.sharding = P("mp", None)``) and its ParallelExecutor reads them.
The port keeps the annotations on the program, so both packages build
the same program, with this small type in place of jax's. Nothing reads
them until multi-device execution is ported (ROADMAP.md item
'Multi-device parallelism').
"""

__all__ = ["PartitionSpec"]


class PartitionSpec(tuple):
    """Per-dimension mesh-axis names (None = replicated), like
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"
