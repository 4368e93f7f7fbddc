"""Convert python readers into native recordio files (port of
``paddle_tpu/recordio_writer.py``) — parity with
python/paddle/fluid/recordio_writer.py (convert_reader_to_recordio_file
:34, convert_reader_to_recordio_files:69).

One record per sample, each record the per-variable arrays encoded by
``paddle_tpu_torch.io.recordio`` (the C++ chunked format in
native/recordio.cc, the reference's byte for byte) — exactly what
``layers.open_recordio_file`` / ``open_files`` read back, in either
package. The ``feeder`` supplies per-variable dtype/LoD metadata,
mirroring the reference's DataFeeder-mediated serialization.
"""
import numpy as np

from .io.recordio import Writer, _encode_arrays

__all__ = [
    "convert_reader_to_recordio_file", "convert_reader_to_recordio_files",
]


def _map_compressor(name):
    return {"none": "none", "gzip": "gzip", "snappy": "gzip"}[name]


def _sample_arrays(sample, feed_vars):
    out = []
    for value, var in zip(sample, feed_vars):
        dtype = np.dtype(var.dtype)
        arr = np.asarray(value, dtype=dtype)
        if var.lod_level > 0 and arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        out.append(arr)
    return out


def convert_reader_to_recordio_file(filename, reader_creator, feeder,
                                    compressor="snappy",
                                    max_num_records=1000, feed_order=None):
    """Write every sample of ``reader_creator()`` to ``filename``.
    Returns the number of records written. The reference's Snappy codec
    maps onto the native writer's gzip (native/recordio.cc supports
    none|gzip)."""
    feed_vars = feeder.feed_vars
    if feed_order is not None:
        by_name = {v.name: v for v in feed_vars}
        feed_vars = [by_name[n] for n in feed_order]
    n = 0
    with Writer(filename, max_num_records,
                _map_compressor(compressor)) as w:
        for sample in reader_creator():
            w.write(_encode_arrays(_sample_arrays(sample, feed_vars)))
            n += 1
    return n


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder,
                                     compressor="snappy",
                                     max_num_records=1000,
                                     feed_order=None):
    """Shard the reader across files of ``batch_per_file`` records each,
    named ``<filename>-00000`` etc. Returns the list of paths written."""
    feed_vars = feeder.feed_vars
    if feed_order is not None:
        by_name = {v.name: v for v in feed_vars}
        feed_vars = [by_name[n] for n in feed_order]
    paths, w, n = [], None, 0
    try:
        for sample in reader_creator():
            if w is None or n % batch_per_file == 0:
                if w is not None:
                    w.close()
                paths.append("%s-%05d" % (filename, len(paths)))
                w = Writer(paths[-1], max_num_records,
                           _map_compressor(compressor))
            w.write(_encode_arrays(_sample_arrays(sample, feed_vars)))
            n += 1
    finally:
        if w is not None:
            w.close()
    return paths
