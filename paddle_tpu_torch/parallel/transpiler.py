"""Sharding transpiler (port of ``paddle_tpu/parallel/transpiler.py``).

Capability parity with python/paddle/fluid/transpiler/
distribute_transpiler.py: where Fluid splits the program into trainer
graphs (send/recv ops) and pserver graphs (param shards and optimizer
blocks), distribution here is declarative: the transpiler walks the
program and annotates variables with PartitionSpecs; the
ParallelExecutor places each value per its spec and the collectives
follow from the placements (parallel/spmd.py), doing what the pserver
send/recv used to do.

Three strategies, mirroring the reference's deployment modes:
  * data_parallel()     — pure replication + dp-sharded batch
                          (≈ NCCL allreduce mode)
  * shard_optimizer()   — ZeRO-style: params replicated, optimizer
                          accumulators sharded over dp
                          (≈ pserver keeping the optimizer state)
  * tensor_parallel()   — fc/embedding weights split over 'tp' with
                          alternating column/row splits
                          (≈ model-parallel pserver sharding)
"""
from ..sharding import PartitionSpec as P

from ..core import framework

__all__ = ["ShardingTranspiler", "DistributeTranspiler",
           "DistributeTranspilerConfig"]


class DistributeTranspilerConfig:
    """fluid-compat config (reference distribute_transpiler.py). slice size
    maps loosely onto our sharding granularity decisions."""

    slice_var_up = True
    min_block_size = 8192
    split_method = None


class ShardingTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()

    # ------------------------------------------------------------------
    def data_parallel(self, program=None):
        """All params replicated; batch sharded by the executor's feed
        sharding. Nothing to annotate (replicated is the default)."""
        return program or framework.default_main_program()

    # ------------------------------------------------------------------
    def shard_optimizer(self, program=None, axis="dp"):
        """ZeRO-1: optimizer accumulators sharded on their largest dim over
        ``axis``; params stay replicated. The update runs on each
        rank's shard and the updated params are all-gathered."""
        program = program or framework.default_main_program()
        gb = program.global_block()
        acc_names = self._optimizer_state_names(program)
        for name in acc_names:
            var = gb.vars.get(name)
            if var is None or not var.shape or len(var.shape) == 0:
                continue
            if getattr(var, "sharding", None) is not None:
                # already annotated — e.g. moments of a distributed
                # embedding table inherit the param's P('mp', ...) spec;
                # re-annotating over 'dp' would split the state on a
                # different axis than the param it updates
                continue
            shape = var.shape
            if len(shape) >= 1 and shape[0] not in (-1, 0, 1):
                spec = [None] * len(shape)
                spec[0] = axis
                var.sharding = P(*spec)
        return program

    # ------------------------------------------------------------------
    def tensor_parallel(self, program=None, axis="tp"):
        """Megatron-style alternating split for fc chains: even mul ops
        column-split their weight [in, out/tp], odd ones row-split
        [in/tp, out]; embeddings split the vocab dim. The row-split
        matmul's partial sums are all-reduced where they are next
        used."""
        program = program or framework.default_main_program()
        gb = program.global_block()
        col = True
        for op in gb.ops:
            if op.type == "mul":
                wname = op.input("Y")[0]
                var = gb.vars.get(wname)
                if isinstance(var, framework.Parameter) and len(var.shape) == 2:
                    var.sharding = P(None, axis) if col else P(axis, None)
                    col = not col
            elif op.type == "lookup_table":
                wname = op.input("W")[0]
                var = gb.vars.get(wname)
                if isinstance(var, framework.Parameter):
                    var.sharding = P(None, axis)
        return program

    # ------------------------------------------------------------------
    @staticmethod
    def _optimizer_state_names(program):
        """Accumulator vars = persistable inputs of optimizer ops other
        than Param/Grad/LearningRate."""
        out = set()
        opt_types = {"sgd", "momentum", "adam", "adamax", "adagrad",
                     "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
                     "lamb"}
        for op in program.global_block().ops:
            if op.type in opt_types:
                for slot, names in op.inputs.items():
                    if slot in ("Param", "Grad", "LearningRate"):
                        continue
                    out.update(names)
        return out


class DistributeTranspiler(ShardingTranspiler):
    """fluid-compat entry point. ``transpile(trainer_id, pservers=...,
    trainers=N)`` maps the pserver deployment onto mesh sharding: the
    param/optimizer-state distribution the pservers provided becomes
    shard_optimizer(); trainer replication becomes data_parallel."""

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None):
        self.trainer_id = trainer_id
        self.trainers = trainers
        program = program or framework.default_main_program()
        self.shard_optimizer(program)
        self._program = program
        return program

    def get_trainer_program(self):
        return self._program

    def get_pserver_program(self, endpoint):
        raise NotImplementedError(
            "a mesh deployment has no parameter servers: optimizer state "
            "is mesh-sharded (ZeRO) and synced by collectives. Use "
            "transpile() + ParallelExecutor.")

    def get_startup_program(self, endpoint=None, pserver_program=None):
        return framework.default_startup_program()
