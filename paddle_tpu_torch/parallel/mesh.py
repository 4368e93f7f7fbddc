"""Device mesh (port of ``paddle_tpu/parallel/mesh.py``).

The reference builds one logical ``jax.sharding.Mesh`` over every chip
of one process and lets XLA's GSPMD insert the collectives. PyTorch's
idiom is one process per device: the port's :class:`DeviceMesh` names
the axes of ``torch.distributed.device_mesh.init_device_mesh`` over the
ranks of the default process group, and values placed on it are
``torch.distributed.tensor.DTensor``s (``Shard(i)`` for an axis named in
dimension i of a :class:`PartitionSpec`, ``Replicate()`` for the rest).

Axis conventions (used across the framework):
  dp — data parallel          tp — tensor (model) parallel
  pp — pipeline stages        sp — sequence/context parallel
  ep — expert parallel        mp — model-parallel (row-sharded) tables

Ranks come from ``torchrun`` or from :func:`init_distributed` (the
reference's ``PADDLE_*`` environment variables). With no process group,
:func:`make_mesh` starts a one-rank group on the caller's place: the
configuration of a one-card user. A mesh larger than the world raises;
the port does not fall back to host devices as the reference does
when one accelerator is visible.
"""
import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ..sharding import PartitionSpec

__all__ = ["DeviceMesh", "make_mesh", "PartitionSpec", "NamedSharding",
           "current_mesh", "mesh_scope", "init_distributed"]

P = PartitionSpec


def _backend_for(device_type):
    """NCCL for the card; gloo for host tensors, or wherever
    ``PADDLE_TPU_CPU_COLLECTIVES=gloo`` asks for it (the reference's
    knob for its host collectives)."""
    if os.environ.get("PADDLE_TPU_CPU_COLLECTIVES", "") == "gloo":
        return "gloo"
    return "nccl" if device_type == "cuda" else "gloo"


def _default_device():
    from ..core.executor import default_place
    return default_place().device


def _rank_device(device_type):
    """The device of this rank: ``cuda:LOCAL_RANK`` (or the rank modulo
    the visible cards) on the card, the host otherwise."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else \
        dist.get_rank() % max(1, torch.cuda.device_count())
    return torch.device("cuda", idx)


def _one_rank_group(device):
    """A process group of this process alone, over an in-process store:
    no address, no port, no file."""
    dist.init_process_group(_backend_for(device.type),
                            store=dist.HashStore(), rank=0, world_size=1)


class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (jax's ``NamedSharding``): its
    DTensor placements are :meth:`placements`."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def placements(self):
        return self.mesh.placements(self.spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class DeviceMesh:
    """A named mesh over the ranks of the default process group."""

    def __init__(self, axes, devices=None, place=None):
        """axes: dict axis_name -> size (one size may be -1 to absorb the
        remaining ranks). ``devices`` (the reference's device list) may
        name the device type, ``"cuda"`` or ``"cpu"``; by default it is
        the type of ``place`` (default: the entry points' default
        place, the card unless ``force_cpu()``)."""
        if isinstance(devices, str):
            device_type = devices
        elif place is not None:
            device_type = place.device.type
        else:
            device_type = _default_device().type
        if not dist.is_initialized():
            _one_rank_group(torch.device(device_type))
        world = dist.get_world_size()
        sizes = dict(axes)
        known = int(np.prod([s for s in sizes.values() if s != -1])) or 1
        for k, v in sizes.items():
            if v == -1:
                sizes[k] = world // known
        total = int(np.prod(list(sizes.values())))
        if total != world:
            raise ValueError(
                f"mesh axes {axes} (resolved sizes {sizes}) need {total} "
                f"ranks but the process group has {world}: start one "
                "process per device (torchrun, or init_distributed with "
                "the PADDLE_TRAINERS / PADDLE_TRAINER_ID environment "
                "variables) and size the mesh to the world")
        self.axes = sizes
        self.device_type = device_type
        self.device = _rank_device(device_type)
        if device_type == "cuda":
            torch.cuda.set_device(self.device)
        from torch.distributed.device_mesh import init_device_mesh
        self.mesh = init_device_mesh(device_type, tuple(sizes.values()),
                                     mesh_dim_names=tuple(sizes))

    @property
    def axis_names(self):
        return tuple(self.axes)

    def size(self, axis=None):
        if axis is None:
            return int(np.prod(list(self.axes.values())))
        return self.axes[axis]

    def group(self, axis):
        """The process group of this rank's line along ``axis``."""
        return self.mesh.get_group(axis)

    def coordinate(self, axis):
        """This rank's index along ``axis``."""
        return self.mesh.get_local_rank(axis)

    def placements(self, spec):
        """DTensor placements of ``spec``: per mesh axis, ``Shard(i)``
        where dimension i of the spec names the axis, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.axes:
            dim = None
            for i, ax in enumerate(spec):
                names = (ax,) if isinstance(ax, str) else (ax or ())
                if name in names:
                    dim = i
            out.append(Replicate() if dim is None else Shard(dim))
        return out

    def sharding(self, *spec):
        return NamedSharding(self, P(*spec))

    def replicated(self):
        return NamedSharding(self, P())

    def __enter__(self):
        global _current
        self._prev = _current
        _current = self
        return self

    def __exit__(self, *a):
        global _current
        _current = self._prev
        return False

    def __repr__(self):
        return f"DeviceMesh({self.axes})"


_current = None


def make_mesh(axes=None, devices=None, place=None):
    """Default: a 1-D data-parallel mesh over every rank."""
    if axes is None:
        axes = {"dp": -1}
    return DeviceMesh(axes, devices, place)


def current_mesh():
    return _current


@contextlib.contextmanager
def mesh_scope(mesh):
    global _current
    old = _current
    _current = mesh
    try:
        yield mesh
    finally:
        _current = old


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, backend=None):
    """Join this process to a multi-process group (reference: the
    trainer/pserver bootstrap read from ``PADDLE_TRAINER_ID`` /
    ``PADDLE_TRAINERS`` / ``PADDLE_PSERVER_ENDPOINTS``). Explicit
    arguments win; else the fluid-style environment variables; else
    ``torchrun``'s (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``), which
    ``init_process_group`` reads itself. ``local_device_ids`` (its first
    entry) picks this process's card. The backend is NCCL on the card
    and gloo for host tensors or with ``PADDLE_TPU_CPU_COLLECTIVES=gloo``.
    Returns the world size."""
    if coordinator_address is None:
        eps = os.environ.get("PADDLE_PSERVER_ENDPOINTS") or \
            os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        coordinator_address = eps.split(",")[0] or None
    if num_processes is None and os.environ.get("PADDLE_TRAINERS"):
        num_processes = int(os.environ["PADDLE_TRAINERS"])
    if process_id is None and os.environ.get("PADDLE_TRAINER_ID"):
        process_id = int(os.environ["PADDLE_TRAINER_ID"])
    if backend is None:
        backend = _backend_for(_default_device().type)
    if local_device_ids:
        os.environ["LOCAL_RANK"] = str(list(local_device_ids)[0])
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, **kwargs)
    return dist.get_world_size()
