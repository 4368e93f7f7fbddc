"""DataFeeder — converts python minibatch data into feed dicts.

Port of ``paddle_tpu/data_feeder.py`` (parity with
python/paddle/fluid/data_feeder.py): takes a list of feed Variables;
``feed(batch_of_rows)`` transposes row-major reader output into
per-variable arrays. Variables with ``lod_level > 0`` become
SequenceBatch values (padded + lengths; at level 2 rows carry lists of
subsequences) instead of LoDTensors. A batch that is already a feed
dict (``io.DeviceLoader``'s) passes through as it is.
"""
import numpy as np

from .core import framework
from .core.sequence import to_nested_sequence_batch, to_sequence_batch

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = []
        program = program or framework.default_main_program()
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable):
        if isinstance(iterable, dict):
            return iterable
        rows = list(iterable)
        feed = {}
        for i, var in enumerate(self.feed_vars):
            col = [r[i] for r in rows]
            if var.lod_level == 2:
                feed[var.name] = to_nested_sequence_batch(
                    col, dtype=np.dtype(var.dtype))
            elif var.lod_level > 0:
                feed[var.name] = to_sequence_batch(
                    col, dtype=np.dtype(var.dtype))
            else:
                arr = np.asarray(col, dtype=np.dtype(var.dtype))
                want = [s for s in var.shape if s != -1]
                if list(arr.shape[1:]) != want and want:
                    arr = arr.reshape([arr.shape[0]] + want)
                feed[var.name] = arr
        return feed
