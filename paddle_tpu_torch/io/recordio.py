"""ctypes binding for the native chunked record format
(``paddle_tpu_torch/csrc/recordio.cc``).

Port of ``paddle_tpu/io/recordio.py``: the same ctypes binding over the
port's own copy of the reference's ``native/recordio.cc``, byte for
byte, so a file written by either package reads in the other. The
library builds with ``g++`` at first use into ``paddle_tpu_torch/_build/``.

Capability parity with the reference's paddle/fluid/recordio (writer /
scanner, CRC-checked chunks, compression) plus a threaded native
prefetch loader so record decode overlaps device steps. Records are bytes;
`write_arrays` / array readers layer a numpy (.npy) framing on top so a
record can carry one training example of several ndarrays.
"""
import ctypes
import io as _pyio
import os
import subprocess

import numpy as np

__all__ = ["Writer", "Scanner", "DataLoader", "write_arrays",
           "array_scanner", "array_reader"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libptrecordio.so")

_lib = None


def build_native_lib(src_name, so_path):
    """Compile the port's ``csrc/<src_name>`` to ``so_path`` on first use,
    or when the source is newer than the library, and return a CDLL —
    shared by every native binding (recordio, batcher). Builds to a
    per-pid temp path and renames into place so N data-parallel worker
    processes racing on first use never load a partially written .so
    (rename is atomic on posix)."""
    src = os.path.join(_CSRC_DIR, src_name)
    if not os.path.exists(src):
        raise RuntimeError(f"native source not found; expected {src}")
    if not os.path.exists(so_path) \
            or os.path.getmtime(so_path) < os.path.getmtime(src):
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.check_call(
            [os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-fPIC",
             "-Wall", "-shared", "-o", tmp, src, "-lz", "-lpthread"])
        os.replace(tmp, so_path)
    return ctypes.CDLL(so_path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = build_native_lib("recordio.cc", _SO_PATH)
    lib.ptru_last_error.restype = ctypes.c_char_p
    lib.ptru_writer_open.restype = ctypes.c_void_p
    lib.ptru_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.ptru_writer_write.restype = ctypes.c_int
    lib.ptru_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64]
    lib.ptru_writer_close.restype = ctypes.c_int
    lib.ptru_writer_close.argtypes = [ctypes.c_void_p]
    lib.ptru_scanner_open.restype = ctypes.c_void_p
    lib.ptru_scanner_open.argtypes = [ctypes.c_char_p]
    lib.ptru_scanner_next.restype = ctypes.c_long
    lib.ptru_scanner_next.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_void_p)]
    lib.ptru_scanner_close.argtypes = [ctypes.c_void_p]
    lib.ptru_loader_open.restype = ctypes.c_void_p
    lib.ptru_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.ptru_loader_next.restype = ctypes.c_long
    lib.ptru_loader_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_void_p)]
    lib.ptru_record_free.argtypes = [ctypes.c_void_p]
    lib.ptru_loader_error.restype = ctypes.c_char_p
    lib.ptru_loader_error.argtypes = [ctypes.c_void_p]
    lib.ptru_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _err(lib):
    return lib.ptru_last_error().decode("utf-8", "replace")


class Writer:
    """Append records (bytes) to a recordio file.

    compressor: "none" | "gzip". Usable as a context manager.
    """

    def __init__(self, path, max_chunk_records=1000, compressor="none"):
        self._lib = _load()
        comp = {"none": 0, "gzip": 1}[compressor]
        self._h = self._lib.ptru_writer_open(
            path.encode(), max_chunk_records, comp)
        if not self._h:
            raise IOError(_err(self._lib))

    def write(self, record):
        if self._h is None:
            raise ValueError("write on closed Writer")
        if not isinstance(record, (bytes, bytearray)):
            raise TypeError("record must be bytes")
        if self._lib.ptru_writer_write(self._h, bytes(record),
                                       len(record)) != 0:
            raise IOError(_err(self._lib))

    def close(self):
        if self._h:
            rc = self._lib.ptru_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError(_err(self._lib))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Scanner:
    """Sequential record iterator (synchronous, no prefetch thread)."""

    def __init__(self, path):
        self._lib = _load()
        self._h = self._lib.ptru_scanner_open(path.encode())
        if not self._h:
            raise IOError(_err(self._lib))

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        data = ctypes.c_void_p()
        n = self._lib.ptru_scanner_next(self._h, ctypes.byref(data))
        if n == -1:
            self.close()
            raise StopIteration
        if n == -2:
            msg = _err(self._lib)
            self.close()
            raise IOError(msg)
        return ctypes.string_at(data, n)

    def close(self):
        if self._h:
            self._lib.ptru_scanner_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DataLoader:
    """Threaded prefetch iterator: a native background thread decodes
    chunks into a bounded queue (capacity records) while the host loop
    feeds the device. stride/offset shard records round-robin across
    data-parallel workers (record i goes to worker i % stride)."""

    def __init__(self, path, capacity=256, stride=1, offset=0):
        self._lib = _load()
        self._h = self._lib.ptru_loader_open(
            path.encode(), capacity, stride, offset)
        if not self._h:
            raise IOError(_err(self._lib))

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        handle, data = ctypes.c_void_p(), ctypes.c_void_p()
        n = self._lib.ptru_loader_next(self._h, ctypes.byref(handle),
                                       ctypes.byref(data))
        if n == -1:
            self.close()
            raise StopIteration
        if n == -2:
            # the failure happened on the worker thread; its message
            # lives on the loader handle, not in this thread's g_error
            msg = self._lib.ptru_loader_error(self._h).decode(
                "utf-8", "replace")
            self.close()
            raise IOError(msg)
        try:
            return ctypes.string_at(data, n)
        finally:
            self._lib.ptru_record_free(handle)

    def close(self):
        if self._h:
            self._lib.ptru_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------ array layer
def _encode_arrays(arrays):
    out = _pyio.BytesIO()
    out.write(np.uint32(len(arrays)).tobytes())
    for a in arrays:
        buf = _pyio.BytesIO()
        np.save(buf, np.asarray(a), allow_pickle=False)
        blob = buf.getvalue()
        out.write(np.uint64(len(blob)).tobytes())
        out.write(blob)
    return out.getvalue()


def _decode_arrays(record):
    view = memoryview(record)
    count = int(np.frombuffer(view[:4], np.uint32)[0])
    pos = 4
    arrays = []
    for _ in range(count):
        n = int(np.frombuffer(view[pos:pos + 8], np.uint64)[0])
        pos += 8
        arrays.append(np.load(_pyio.BytesIO(bytes(view[pos:pos + n])),
                              allow_pickle=False))
        pos += n
    return arrays


def write_arrays(path, example_iter, max_chunk_records=1000,
                 compressor="none"):
    """Write an iterable of examples (each a list/tuple of ndarrays) as
    one record per example. Returns the number of records written."""
    n = 0
    with Writer(path, max_chunk_records, compressor) as w:
        for example in example_iter:
            if not isinstance(example, (list, tuple)):
                example = [example]
            w.write(_encode_arrays(example))
            n += 1
    return n


def array_scanner(path):
    """Generator over examples (lists of ndarrays), synchronous."""
    with Scanner(path) as s:
        for rec in s:
            yield _decode_arrays(rec)


def array_reader(path, capacity=256, stride=1, offset=0):
    """Reader-decorator-compatible factory: returns a callable that,
    when invoked, yields examples via the threaded native prefetcher.
    Composes with paddle_tpu_torch.reader.batch/shuffle/... and DataFeeder."""

    def reader():
        with DataLoader(path, capacity, stride, offset) as dl:
            for rec in dl:
                yield _decode_arrays(rec)

    return reader
