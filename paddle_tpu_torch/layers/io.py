"""Data-input layers (port of ``paddle_tpu/layers/io.py``; parity with
python/paddle/fluid/layers/io.py).

The reference implements readers as C++ reader ops inside the graph
(create_py_reader, open_files, batch/shuffle/double_buffer decorating
ReaderHolders, reference python/paddle/fluid/layers/io.py +
paddle/fluid/operators/reader/). Here, as in the JAX package, the
*pipeline* (files, shuffling, batching, prefetch) runs host-side on
threads — overlapping device steps like the reference's double_buffer —
while ``Executor.run`` pulls the next batch automatically for any
program whose in-graph readers are started (an exhausted reader raises
``EOFException``, which ends an epoch; explicit feed keys win). The
layer API keeps the reference's shape: py_reader / open_files /
open_recordio_file return reader handles, read_file(reader) yields the
data variables, batch/shuffle/double_buffer wrap readers, and
Preprocessor builds its transform as ordinary program ops.

A reader variable with ``lod_levels[i] > 0`` gets each batch's rows of
variable-length sequences as a SequenceBatch (``to_sequence_batch``),
as the reference's readers do.
"""
import numpy as np

from ..core import framework
from ..core.executor import EOFException
from ..core.sequence import to_sequence_batch
from ..layer_helper import LayerHelper
from ..core import unique_name as _un

__all__ = ["data", "py_reader", "read_file", "open_files",
           "open_recordio_file", "batch", "shuffle", "double_buffer",
           "random_data_generator", "Preprocessor", "load",
           "EOFException"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=None):
    """Declares an input variable (reference
    python/paddle/fluid/layers/io.py data()): prepends a -1 batch dim when
    ``append_batch_size`` and none of the dims is already -1."""
    shape = list(shape)
    if append_batch_size and -1 not in shape:
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, stop_gradient=stop_gradient,
                            is_data=True)


class Reader:
    """In-graph reader handle (the ReaderHolder equivalent). Owns the
    data variables it produces and a host-side source pipeline."""

    def __init__(self, shapes, dtypes, lod_levels=None, name=None,
                 source=None, batched=False, program=None):
        self.program = program or framework.default_main_program()
        self.name = name or _un.generate("reader")
        lod_levels = lod_levels or [0] * len(shapes)
        self._vars = [
            data(f"{self.name}.out{i}", shape=list(s), dtype=dt,
                 lod_level=ll, append_batch_size=False)
            for i, (s, dt, ll) in enumerate(zip(shapes, dtypes, lod_levels))]
        self._source = source          # zero-arg callable -> iterator
        self._mode = "rows"            # rows | arrays
        self._batched = batched
        self._iter = None
        readers = getattr(self.program, "_readers", None)
        if readers is None:
            readers = self.program._readers = []
        readers.append(self)

    # -- pipeline plumbing ----------------------------------------------
    def decorate_paddle_reader(self, reader):
        """``reader()`` yields batches of sample rows (the output of
        paddle_tpu.reader.batch), matching the reference's
        decorate_paddle_reader contract."""
        self._source, self._mode = reader, "rows"
        self._batched = True
        return self

    def decorate_tensor_provider(self, reader):
        """``reader()`` yields tuples of ready ndarrays, one per var."""
        self._source, self._mode = reader, "arrays"
        return self

    def start(self):
        if self._source is None:
            raise RuntimeError(f"reader {self.name} has no data source")
        self._iter = iter(self._source())

    def reset(self):
        self._iter = None

    def started(self):
        return self._iter is not None

    # -- executor hook ---------------------------------------------------
    def var_names(self):
        return [v.name for v in self._vars]

    def next_feed(self):
        if self._iter is None:
            raise RuntimeError(
                f"reader {self.name} not started — call .start() first")
        try:
            item = next(self._iter)
        except StopIteration:
            self._iter = None
            raise EOFException(f"reader {self.name} exhausted")
        feed = {}
        if self._mode == "arrays":
            for v, arr in zip(self._vars, item):
                feed[v.name] = arr
            return feed
        rows = item if self._batched else [item]
        for i, v in enumerate(self._vars):
            col = [r[i] for r in rows]
            if v.lod_level > 0:
                feed[v.name] = to_sequence_batch(
                    col, dtype=np.dtype(v.dtype))
            else:
                feed[v.name] = np.asarray(col, dtype=np.dtype(v.dtype))
        return feed


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Feed-from-python reader (reference io.py py_reader). ``capacity``
    and ``use_double_buffer`` size the host-side prefetch buffer."""
    r = Reader(shapes, dtypes, lod_levels, name=name)
    r._capacity = capacity
    r._double_buffer = use_double_buffer
    return r


def read_file(reader=None, file_obj=None):
    """Returns the data variables of a reader (reference io.py
    read_file). The reference names the arg ``reader``; ``file_obj``
    is accepted as an alias."""
    file_obj = file_obj if file_obj is not None else reader
    if file_obj is None:
        raise TypeError("read_file() needs a reader (pass `reader=`, "
                        "the reference argument name, or `file_obj=`)")
    vars = file_obj._vars
    return vars[0] if len(vars) == 1 else vars


def open_recordio_file(filename, shapes, dtypes, lod_levels=None,
                       pass_num=1, for_parallel=True):
    """Reader over one native recordio file (reference io.py
    open_recordio_file; format: native/recordio.cc). Yields samples;
    compose with batch()/shuffle()/double_buffer()."""
    from ..io.recordio import array_reader

    def source():
        for _ in range(pass_num):
            for rec in array_reader(filename)():
                yield rec

    return Reader(shapes, dtypes, lod_levels, source=source, batched=False)


def open_files(filenames, shapes, dtypes, lod_levels=None, thread_num=1,
               buffer_size=None, pass_num=1, is_test=None,
               for_parallel=True):
    """Reader over many record files (reference io.py open_files):
    samples are drawn round-robin across the files (the multi-file
    interleave the reference gets from its multi-threaded reader), with
    an optional host-side prefetch buffer of ``buffer_size``."""
    from ..io.recordio import array_reader
    from ..reader import buffered

    def interleave():
        for _ in range(pass_num):
            iters = [iter(array_reader(f)()) for f in filenames]
            while iters:
                alive = []
                for it in iters:
                    try:
                        yield next(it)
                        alive.append(it)
                    except StopIteration:
                        pass
                iters = alive

    source = interleave
    if buffer_size:
        source = buffered(interleave, buffer_size)
    return Reader(shapes, dtypes, lod_levels, source=source, batched=False)


def _derived(parent, source, batched):
    r = Reader.__new__(Reader)
    r.program = parent.program
    r.name = _un.generate(parent.name + ".d")
    r._vars = parent._vars          # same data variables
    r._source = source
    r._mode = parent._mode
    r._batched = batched
    r._iter = None
    readers = parent.program._readers
    readers[readers.index(parent)] = r   # the pipeline head replaces it
    return r


def batch(reader, batch_size):
    """Group a sample-level reader into fixed batches (reference io.py
    batch — the in-graph form of paddle.batch)."""
    from ..reader import batch as batch_dec
    return _derived(reader, batch_dec(lambda: iter(reader._source()),
                                      batch_size), batched=True)


def shuffle(reader, buffer_size):
    """Buffered shuffle (reference io.py shuffle → shuffle_reader)."""
    from ..reader import shuffle as shuffle_dec
    return _derived(reader, shuffle_dec(lambda: iter(reader._source()),
                                        buffer_size),
                    batched=reader._batched)


def double_buffer(reader, place=None, name=None):
    """Prefetch on a host thread so reading overlaps device steps
    (reference io.py double_buffer → double_buffer_reader)."""
    from ..reader import buffered
    return _derived(reader, buffered(lambda: iter(reader._source()), 2),
                    batched=reader._batched)


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=True):
    """Endless uniform-random batches (reference io.py
    random_data_generator): shapes are full batch shapes."""
    rng = np.random.RandomState(0)

    def source():
        while True:
            yield tuple(rng.uniform(low, high, s).astype(np.float32)
                        for s in shapes)

    r = Reader(shapes, ["float32"] * len(shapes), lod_levels,
               source=source)
    r._mode = "arrays"
    return r


class Preprocessor:
    """Reader transform (reference io.py Preprocessor). The reference
    builds a sub-block executed by the preprocessing thread; here, as in
    the JAX package, the transform's ops go straight into the main
    program and run inside the step on the device."""

    def __init__(self, reader, name=None):
        self.reader = reader
        self.outputs_vars = None
        self._inside = False

    def block(self):
        import contextlib

        @contextlib.contextmanager
        def guard():
            self._inside = True
            try:
                yield self
            finally:
                self._inside = False
            # only checked on clean exit so a real exception inside the
            # block isn't masked by the missing-outputs complaint
            if self.outputs_vars is None:
                raise RuntimeError(
                    "Preprocessor.block() must call .outputs(...)")
        return guard()

    def inputs(self):
        assert self._inside, "inputs() only valid inside block()"
        return list(self.reader._vars)

    def outputs(self, *outs):
        assert self._inside, "outputs() only valid inside block()"
        self.outputs_vars = list(outs)

    def __call__(self):
        view = Reader.__new__(Reader)
        view.program = self.reader.program
        view.name = _un.generate(self.reader.name + ".pre")
        view._vars = self.outputs_vars
        view._source = self.reader._source
        view._mode = self.reader._mode
        view._batched = self.reader._batched
        view._iter = None
        view._feeder = self.reader      # pulls arrive via the raw vars
        readers = self.reader.program._readers
        readers[readers.index(self.reader)] = view
        view.next_feed = self.reader.next_feed
        view.start = self.reader.start
        view.reset = self.reader.reset
        view.started = self.reader.started
        return view


def load(out, file_path, load_as_fp16=False):
    """Load a persistable variable from a file written by io.save_vars
    (reference load_op.cc — but files are numpy format here). The file
    is read each time the op runs."""
    helper = LayerHelper("load")
    helper.append_op(type="load", inputs={},
                     outputs={"Out": [out.name]},
                     attrs={"file_path": file_path,
                            "load_as_fp16": load_as_fp16})
    return out
