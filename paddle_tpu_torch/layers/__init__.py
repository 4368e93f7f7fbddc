"""Layers namespace (port of ``paddle_tpu/layers``)."""
from . import ops
from .ops import *            # noqa: F401,F403
from . import io
from .io import *             # noqa: F401,F403
from . import tensor
from .tensor import *         # noqa: F401,F403
from . import nn
from .nn import *             # noqa: F401,F403
from . import transformer
from .transformer import *    # noqa: F401,F403

__all__ = (ops.__all__ + io.__all__ + tensor.__all__ + nn.__all__
           + transformer.__all__)
