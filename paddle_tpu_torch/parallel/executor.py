"""ParallelExecutor — SPMD execution of a Program over a device mesh
(port of ``paddle_tpu/parallel/executor.py``).

Fluid's ParallelExecutor replicated the graph per GPU, scattered the
batch and inserted NCCL all-reduces on every gradient; the reference
jits the lowered step with sharding annotations and lets GSPMD insert
the collectives. The port runs one process per device and the same
lowered step (``core/lowering.py``) on values placed on the mesh
(``parallel/spmd.py``): feeds sharded over 'dp', each variable per its
transpiler-assigned PartitionSpec (or replicated), the collectives
coming from DTensor's sharding propagation and the port's local rules.
Gradient averaging falls out of the math, as in the reference: the loss
mean over a dp-sharded batch is an all-reduce, and so are batch norm's
statistics (global-batch, SyncBN semantics).

Every rank passes the same global feed, as the reference's caller does,
and every fetch comes back as its global value on every rank. After a
run the scope holds placed values (DTensors); ``to_numpy``, a plain
Executor and ``weights.py`` read them as global values.
"""
import contextlib

import numpy as np
import torch

from ..core import framework
from ..core.executor import (check_nan_guard, global_scope, to_numpy,
                             compiled_cost_stats)
from ..core.lowering import GUARD, lower_program, written_names
from . import collectives
from .mesh import make_mesh, mesh_scope
from .spmd import Spmd, place

__all__ = ["ParallelExecutor", "ExecutionStrategy", "BuildStrategy"]

# the reference's collective kinds, by the functional collectives
# DTensor issues (names without underscores)
_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
          ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
          ("broadcast", "all-reduce"), ("permute", "collective-permute"))


class ExecutionStrategy:
    """fluid-compat knob bag (reference ExecutionStrategy). The knobs
    change nothing in eager execution; kept for API parity."""

    def __init__(self):
        self.num_threads = 0
        self.use_cuda = False
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 1


class BuildStrategy:
    """fluid-compat build options. gradient_scale maps to loss scaling;
    reduce_strategy is subsumed by the placements."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""


def _axes(entry):
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


class ParallelExecutor:
    """``use_cuda`` is kept and ignored, as in the reference: the mesh's
    place decides (the card, or the host after ``fluid.force_cpu()`` or
    for a mesh built with ``place=CPUPlace()``)."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, mesh=None):
        self.program = main_program or framework.default_main_program()
        self.scope = scope or global_scope()
        self.mesh = mesh or make_mesh()
        self.device = self.mesh.device
        self.loss_name = loss_name
        self._cache = {}
        self._step = 0
        if share_vars_from is not None:
            self.scope = share_vars_from.scope

    # ------------------------------------------------------------------
    def _spec_fits(self, spec, shape):
        """A PartitionSpec only applies if every sharded dim divides by the
        mesh axis size."""
        if shape is None:
            return True
        for dim, axes in zip(shape, spec):
            n = 1
            for a in _axes(axes):
                n *= self.mesh.axes.get(a, 1)
            if dim % n != 0:
                return False
        return True

    def _spec_axes_known(self, spec):
        """A spec naming a mesh axis this mesh doesn't have (e.g. 'ep'
        weights on a dp-only mesh) falls back to replicated."""
        return all(a in self.mesh.axes for axes in spec for a in _axes(axes))

    def _var_spec(self, name, value=None):
        """The spec a persistable is placed with: its annotation where it
        names this mesh's axes and divides its shape, else replicated."""
        var = self.program.global_block().vars.get(name)
        spec = getattr(var, "sharding", None) if var is not None else None
        if spec is None or not self._spec_axes_known(spec):
            return ()
        shape = None
        if var.shape is not None and -1 not in var.shape:
            shape = var.shape
        elif value is not None:
            shape = tuple(value.shape)
        if not self._spec_fits(spec, shape):
            return ()
        return tuple(spec)

    def _feed_spec(self, name):
        var = self.program.global_block().vars.get(name)
        spec = getattr(var, "sharding", None) if var is not None else None
        if spec is not None and self._spec_axes_known(spec):
            return tuple(spec)
        if "dp" in self.mesh.axes:
            return ("dp",)
        return ()

    # ------------------------------------------------------------------
    def _prepare(self, feed, fetch_list):
        """run()/compiled_stats() shared preamble: fetch names, the
        scope's state placed per its specs, feeds placed and checked."""
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, framework.Variable) else v
                       for v in fetch_list]
        gb = self.program.global_block()
        written = written_names(gb)
        state = {}
        for n in sorted(n for n, v in gb.vars.items() if v.persistable):
            val = self.scope.find_var(n)
            if val is None:
                if n not in written:
                    raise RuntimeError(
                        f"persistable variable {n!r} uninitialized — run "
                        "the startup program on a plain Executor first")
                continue
            pl = self.mesh.placements(self._var_spec(n, val))
            placed = place(val, self.mesh.mesh, pl, self.device)
            if placed is not val:
                self.scope.set(n, placed)
            state[n] = placed
        feed_vals = {}
        for k, v in feed.items():
            var = gb.vars.get(k)
            if (var is not None and var.lod_level > 0) or (
                    hasattr(v, "lengths") and hasattr(v, "data")):
                # a sequence's rows would shard over 'dp' apart from its
                # lengths: refused rather than mis-sharded
                from ..waiting import FLEET
                raise NotImplementedError(
                    f"feed {k!r} is a sequence: sequence feeds under a "
                    "device mesh are not ported yet (ROADMAP.md item "
                    f"'{FLEET}'); run the program through Executor")
            v = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.array(v))
            spec = self._feed_spec(k)
            for dim, axes in zip(v.shape, spec):
                n = int(np.prod([self.mesh.axes.get(a, 1)
                                 for a in _axes(axes)]))
                if dim % n != 0:
                    raise ValueError(
                        f"feed {k!r} dim of size {dim} is not divisible by "
                        f"the mesh axes {_axes(axes)} (size {n}); pad the "
                        "batch or resize the mesh")
            feed_vals[k] = place(v, self.mesh.mesh, self.mesh.placements(spec),
                                 self.device)
        return fetch_names, state, feed_vals

    def _step_fn(self, fetch_names):
        key = (self.program.uid, self.program.version, tuple(fetch_names))
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = lower_program(self.program, fetch_names,
                                                  "train")
        return fn

    def _dispatch(self, step_fn, state, feed_vals, step):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        grad_mode = contextlib.nullcontext() if step_fn.trains \
            else torch.no_grad()
        with mesh_scope(self.mesh), implicit_replication(), grad_mode:
            return step_fn(state, feed_vals, self.device,
                           self.program.random_seed or 0, step,
                           spmd=Spmd(self.mesh))

    # ------------------------------------------------------------------
    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else (feed_dict or {})
        fetch_names, state, feed_vals = self._prepare(feed, fetch_list)
        step_fn = self._step_fn(fetch_names)
        self._step += 1
        new_state, fetches = self._dispatch(step_fn, state, feed_vals,
                                            self._step)
        guard = new_state.pop(GUARD, None)
        for n, v in new_state.items():
            self.scope.set(n, v)
        if guard is not None:
            guard = to_numpy(guard)
            check_nan_guard(torch.as_tensor(guard), step_fn.guard_labels)
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    # ------------------------------------------------------------------
    def compiled_stats(self, fetch_list, feed=None, top_k=10):
        """Measured cost of one step as ``run`` dispatches it (same
        placements, same lowered step, on a copy of the state):
        Executor.compiled_stats's keys (``compiled_cost_stats``) plus
        ``mesh`` and a ``collectives`` histogram under the reference's
        kinds — the collectives DTensor issued
        (``torch.distributed.tensor.debug.CommDebugMode``) and the
        port's own verbs (``collectives.COUNTS``)."""
        from torch.distributed.tensor.debug import CommDebugMode
        fetch_names, state, feed_vals = self._prepare(feed or {},
                                                      fetch_list)
        step_fn = lower_program(self.program, fetch_names, "train")
        state = {n: v.clone() for n, v in state.items()}
        comm = CommDebugMode()

        def step():
            with comm, collectives.counting() as own:
                self._dispatch(step_fn, state, feed_vals, 1)
            step.own = own

        stats = compiled_cost_stats(step, self.device, top_k)
        stats["mesh"] = dict(self.mesh.axes)
        coll = dict(step.own)
        for op, n in comm.get_comm_counts().items():
            name = str(op).replace("_", "").lower()
            if "functional" not in name:
                continue      # an eager c10d call: a port verb, counted
            kind = next((k for key, k in _KINDS if key in name), name)
            coll[kind] = coll.get(kind, 0) + n
        stats["collectives"] = {k: v for k, v in coll.items() if v}
        return stats

    @property
    def device_count(self):
        return self.mesh.size()
