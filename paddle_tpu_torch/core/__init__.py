"""Core IR and execution (port of ``paddle_tpu.core``)."""
from .executor import EOFException                     # noqa: F401
