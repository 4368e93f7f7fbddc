"""Distributed / parallel execution over a device mesh (port of
``paddle_tpu/parallel``): the mesh, the collectives, the
ParallelExecutor and the sharding transpilers. The pipeline schedules
(``gpipe``, ``one_f_one_b``) and ring attention come with the second
part of ROADMAP.md item 'Multi-device parallelism' and are refused by
name."""
from ..waiting import MESH, module_getattr
from .mesh import (DeviceMesh, make_mesh, PartitionSpec, NamedSharding,
                   current_mesh, mesh_scope, init_distributed)  # noqa: F401
from .executor import (ParallelExecutor, ExecutionStrategy,
                       BuildStrategy)                          # noqa: F401
from .transpiler import (ShardingTranspiler, DistributeTranspiler,
                         DistributeTranspilerConfig)           # noqa: F401
from . import collectives                                      # noqa: F401

WAITING = dict.fromkeys(("gpipe", "one_f_one_b", "pipeline",
                         "ring_attention"), MESH)
__getattr__ = module_getattr(__name__, WAITING)
