"""Layers namespace (port of ``paddle_tpu/layers``)."""
from . import ops
from .ops import *            # noqa: F401,F403
from . import tensor
from .tensor import *         # noqa: F401,F403
from . import io
from .io import *             # noqa: F401,F403
from . import nn
from .nn import *             # noqa: F401,F403
from . import metric_op
from .metric_op import *      # noqa: F401,F403
from . import learning_rate_scheduler
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import transformer
from .transformer import *    # noqa: F401,F403
from . import sequence_layers
from .sequence_layers import *  # noqa: F401,F403

from .math_op_patch import monkey_patch_variable
monkey_patch_variable()

__all__ = (ops.__all__ + tensor.__all__ + io.__all__ + nn.__all__
           + metric_op.__all__ + learning_rate_scheduler.__all__
           + transformer.__all__ + sequence_layers.__all__)
