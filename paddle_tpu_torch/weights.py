"""Carrying state between the JAX package and the port as numpy.

A JAX scope dumps to ``{name: np.asarray(value)}``; because both
packages build their programs with the same layer code, parameter names
match one for one, so the dump loads straight into a port Scope.

bfloat16 needs care: JAX hands out ml_dtypes ``bfloat16`` arrays, and the
port does not import ml_dtypes. Such arrays are recognized by their
dtype name, read as their 16-bit patterns and viewed as
``torch.bfloat16`` — bit for bit. The reverse widens nothing: bfloat16
tensors come back as the same bits, viewed as the ``bfloat16`` numpy
dtype the caller passes (e.g. ``ml_dtypes.bfloat16``), or as float32
(exact) when it passes none.
"""
import numpy as np
import torch

__all__ = ["array_to_tensor", "tensor_to_array", "load_state",
           "dump_state"]


def array_to_tensor(arr, device):
    """One numpy array (ml_dtypes bfloat16 included) as a tensor on
    ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def tensor_to_array(t, bfloat16=None):
    """One tensor as a host numpy array of its own (never a view of the
    tensor: a train step that donates its state updates the scope's
    tensors in place). bfloat16 comes back as its bits viewed as
    ``bfloat16`` (a numpy dtype) when given, else as float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bfloat16 is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().copy().view(bfloat16)
    return t.numpy().copy()


def load_state(scope, arrays, device):
    """Load ``{name: np.ndarray}`` into ``scope`` as tensors on
    ``device`` (a torch.device or a place's ``.device``)."""
    for name, arr in arrays.items():
        scope.set(name, array_to_tensor(arr, device))
    return scope


def dump_state(scope, names=None, bfloat16=None):
    """``{name: np.ndarray}`` of the scope's tensors (all, or ``names``)."""
    names = list(scope.keys()) if names is None else names
    return {n: tensor_to_array(scope.find_var(n), bfloat16) for n in names
            if scope.find_var(n) is not None}
