"""Port of ``paddle_tpu/io/batcher.py``: the same binding over the
port's own copy of ``native/batcher.cc``, ``paddle_tpu_torch/csrc/
batcher.cc``, built with g++ into ``paddle_tpu_torch/_build/``. The copy
draws its buffered shuffle over the first ``shuffle_buf`` samples of the
pool, so with one producer thread (``n_threads=1``, or one file) the
order is a function of the seed alone; the reference draws over however
many samples its producers have pooled, which follows thread timing.
Files are the reference's: either package reads what the other writes.

Native batch pipeline binding — fixed-shape samples assembled into
batches by C++ worker threads (csrc/batcher.cc; the native
counterpart of the reference's C++ reader op stack, reference
paddle/fluid/operators/reader/create_batch_reader_op.cc /
create_shuffle_reader_op.cc).

Write samples with :func:`write_fixed` (raw little-endian field bytes,
one record per sample, recordio container), then iterate
:class:`FixedBatcher` — each step returns ready [batch, *shape] numpy
arrays memcpy'd by the native side while Python holds no GIL. Compose
with DeviceLoader for the host→device leg.
"""
import ctypes
import os

import numpy as np

from .recordio import Writer, _BUILD_DIR, build_native_lib

__all__ = ["write_fixed", "FixedBatcher"]

_SO_PATH = os.path.join(_BUILD_DIR, "libptbatcher.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = build_native_lib("batcher.cc", _SO_PATH)
    lib.ptru_batcher_open.restype = ctypes.c_void_p
    lib.ptru_batcher_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.c_int, ctypes.c_long, ctypes.c_ulong, ctypes.c_int,
        ctypes.c_int]
    lib.ptru_batcher_next.restype = ctypes.c_long
    lib.ptru_batcher_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.ptru_batcher_error.restype = ctypes.c_char_p
    lib.ptru_batcher_error.argtypes = [ctypes.c_void_p]
    lib.ptru_batcher_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _normalize_specs(specs):
    out = []
    for shape, dtype in specs:
        dtype = np.dtype(dtype)
        shape = tuple(int(s) for s in shape)
        out.append((shape, dtype,
                    int(np.prod(shape, dtype=np.int64)) * dtype.itemsize))
    return out


def write_fixed(path, example_iter, specs, max_chunk_records=1000,
                compressor="none"):
    """Write samples as raw fixed-size field bytes (no per-sample npy
    header — the native assembler memcpys them directly). ``specs``:
    list of (per-sample shape, dtype) per field. Returns records
    written."""
    norm = _normalize_specs(specs)
    n = 0
    with Writer(path, max_chunk_records, compressor) as w:
        for example in example_iter:
            if not isinstance(example, (list, tuple)):
                example = [example]
            if len(example) != len(norm):
                raise ValueError(
                    f"sample has {len(example)} fields, specs {len(norm)}")
            parts = []
            for value, (shape, dtype, nbytes) in zip(example, norm):
                arr = np.ascontiguousarray(value, dtype=dtype)
                if arr.shape != shape:
                    raise ValueError(
                        f"field shape {arr.shape} != spec {shape}")
                parts.append(arr.tobytes())
            w.write(b"".join(parts))
            n += 1
    return n


class FixedBatcher:
    """Iterate [batch, *shape] numpy batches assembled natively from one
    or more record files, with an in-pool buffered shuffle.

    >>> for imgs, labels in FixedBatcher(paths, [((3072,), "float32"),
    ...                                          ((1,), "int64")], 128,
    ...                                  shuffle_buf=4096):
    ...     exe.run(..., feed={"img": imgs, "label": labels})
    """

    def __init__(self, paths, specs, batch_size, shuffle_buf=0, seed=0,
                 n_threads=2, drop_last=False):
        if isinstance(paths, str):
            paths = [paths]
        self._lib = _load()
        self._specs = _normalize_specs(specs)
        self._batch = int(batch_size)
        c_paths = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        c_bytes = (ctypes.c_long * len(self._specs))(
            *[nb for _, _, nb in self._specs])
        self._h = self._lib.ptru_batcher_open(
            c_paths, len(paths), c_bytes, len(self._specs),
            self._batch, int(shuffle_buf), int(seed), int(n_threads),
            1 if drop_last else 0)
        if not self._h:
            raise ValueError("ptru_batcher_open failed (bad arguments)")

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        bufs = [np.empty((self._batch,) + shape, dtype)
                for shape, dtype, _ in self._specs]
        ptrs = (ctypes.c_void_p * len(bufs))(
            *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
        got = self._lib.ptru_batcher_next(self._h, ptrs)
        if got < 0:
            err = self._lib.ptru_batcher_error(self._h).decode()
            self.close()
            raise IOError(f"native batcher failed: {err}")
        if got == 0:
            self.close()
            raise StopIteration
        if got < self._batch:
            bufs = [b[:got] for b in bufs]
        return tuple(bufs)

    def close(self):
        if self._h is not None:
            self._lib.ptru_batcher_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
