"""Models (port of ``paddle_tpu/models``): the Llama flagship."""
from . import llama           # noqa: F401
