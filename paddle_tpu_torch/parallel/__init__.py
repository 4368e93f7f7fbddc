"""Distributed / parallel execution over a device mesh (port of
``paddle_tpu/parallel``): the mesh, the collectives, the
ParallelExecutor, the sharding transpilers, the pipeline schedules
(``gpipe``, ``pipeline.one_f_one_b``) and ring attention
(``ring_attention``)."""
from .mesh import (DeviceMesh, make_mesh, PartitionSpec, NamedSharding,
                   current_mesh, mesh_scope, init_distributed)  # noqa: F401
from .executor import (ParallelExecutor, ExecutionStrategy,
                       BuildStrategy)                          # noqa: F401
from .transpiler import (ShardingTranspiler, DistributeTranspiler,
                         DistributeTranspilerConfig)           # noqa: F401
from . import collectives                                      # noqa: F401
from . import ring_attention                                   # noqa: F401
from .pipeline import gpipe                                    # noqa: F401
