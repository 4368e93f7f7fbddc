"""Layers namespace (port of ``paddle_tpu/layers``). The layers of later
ROADMAP.md items (detection, ``hsigmoid``, ``nce``) are refused by
name."""
from ..waiting import REST, module_getattr
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
from . import control_flow
from .control_flow import *   # noqa: F401,F403

from .math_op_patch import monkey_patch_variable
monkey_patch_variable()

__all__ = (ops.__all__ + tensor.__all__ + io.__all__ + nn.__all__
           + metric_op.__all__ + learning_rate_scheduler.__all__
           + transformer.__all__ + sequence_layers.__all__
           + control_flow.__all__)

# the reference's detection.py layers, and each submodule's own waiting
# names
WAITING = {**dict.fromkeys((
    "prior_box", "multi_box_head", "bipartite_match",
    "target_assign", "detection_output", "ssd_loss", "iou_similarity",
    "box_coder", "polygon_box_transform", "multiclass_nms",
    "anchor_generator", "rpn_target_assign", "generate_proposals",
    "generate_proposal_labels", "detection_map"), REST),
    **nn.WAITING, **sequence_layers.WAITING}
__getattr__ = module_getattr(__name__, WAITING)
