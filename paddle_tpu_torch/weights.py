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

Files: numpy writes an ml_dtypes bfloat16 array to ``.npy`` (and so to
``.npz``) as the 2-byte void type ``<V2``, and ``np.load`` gives it back
as ``|V2``, never as bfloat16. :func:`write_npy` writes a bfloat16 tensor
as exactly those bytes, and :func:`array_to_tensor` reads a 2-byte void
array as bfloat16 when the caller names that dtype (the program's
declaration or a checkpoint manifest's) — so ``params.npz`` and
checkpoints are byte-compatible with the JAX package's.
"""
import zipfile

import numpy as np
import torch

__all__ = ["array_to_tensor", "tensor_to_array", "load_state",
           "dump_state", "dtype_name", "to_host", "write_npy", "savez"]

# the header numpy writes for an ml_dtypes bfloat16 array
_BF16_DESCR = "<V2"


def _is_bf16(dtype):
    return dtype in ("bfloat16", torch.bfloat16) or \
        getattr(dtype, "name", None) == "bfloat16"


def array_to_tensor(arr, device, dtype=None):
    """One numpy array (ml_dtypes bfloat16 included) as a tensor on
    ``device``. A 2-byte void array (bfloat16 as ``np.load`` reads it
    from a file) needs ``dtype`` = ``"bfloat16"``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        if arr.dtype.name != "bfloat16" and not _is_bf16(dtype):
            raise ValueError(
                f"a 2-byte void array ({arr.dtype.str}) is a bfloat16 "
                "array as numpy writes it to a file; its declared dtype "
                f"is {dtype!r}, not bfloat16")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def tensor_to_array(t, bfloat16=None):
    """One tensor as a host numpy array of its own (never a view of the
    tensor: a train step that donates its state updates the scope's
    tensors in place). bfloat16 comes back as its bits viewed as
    ``bfloat16`` (a numpy dtype) when given, else as float32. A placed
    value (a ParallelExecutor's DTensor) gives its global value."""
    from .core.executor import global_value
    t = global_value(t).detach().cpu()
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


def dtype_name(v):
    """The dtype of a tensor or an array as the JAX package names it
    (``"float32"``, ``"bfloat16"``, ...)."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return str(np.asarray(v).dtype)


def to_host(v):
    """A tensor or an array as a host numpy array of its own; bfloat16
    as its 16-bit patterns in a 2-byte void array (what ``np.load``
    gives for one)."""
    if isinstance(v, torch.Tensor):
        return tensor_to_array(v, bfloat16=np.dtype("V2"))
    return np.asarray(v)


def write_npy(f, arr, dtype=None):
    """``np.save(f, arr)`` as numpy writes it for the JAX package's
    array: a bfloat16 value (``dtype`` ``"bfloat16"``, or an ml_dtypes
    array) gets the header ``'descr': '<V2'`` and its raw bits."""
    arr = to_host(arr)
    if not (_is_bf16(dtype) or arr.dtype.name == "bfloat16"):
        np.lib.format.write_array(f, arr, allow_pickle=False)
        return
    arr = np.ascontiguousarray(arr)
    np.lib.format.write_array_header_1_0(
        f, {"descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
    f.write(arr.view(np.uint8).tobytes())


def savez(path, arrays):
    """``np.savez(path, **arrays)`` with :func:`write_npy` for each
    member (an uncompressed zip of ``<key>.npy``, as numpy writes it);
    values are tensors or arrays."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                write_npy(f, val, dtype_name(val))
