"""The input pipeline of the torch port against the JAX package: the
native recordio and batcher files (paddle_tpu_torch/io/recordio.py over
``native/recordio.cc``, batcher.py over the port's own
``csrc/batcher.cc``, each through the port's ctypes binding, built into
``paddle_tpu_torch/_build/``), the in-graph readers feeding
``Executor.run`` until ``EOFException`` (layers/io.py), the reader
decorators, DataFeeder, and DeviceLoader on the CPU.

Files written by either package read in the other byte for byte; the
readers' training losses equal the reference's from the same initial
scope at the f32 loss tier (rtol 2e-3, tests/test_torch_transformer.py).
The port's shuffled batcher order is a function of its seed with one
producer thread; the reference's follows thread timing (ROADMAP §3 R5),
so the two are held to the same samples.

``tests/test_batcher.py`` → here: ``test_batches_cover_all_samples``
[jax, port], ``test_shuffle_changes_order_but_not_content``,
``test_drop_last_and_bad_record_error``, ``test_feeds_training``.
"""
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.io import batcher as jbatcher
from paddle_tpu.io import recordio as jrecordio

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.io import DeviceLoader
from paddle_tpu_torch.io import batcher as tbatcher
from paddle_tpu_torch.io import recordio as trecordio
from paddle_tpu_torch.resilience import faultinject

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOSS_RTOL = 2e-3
PACKAGES = {"jax": (jrecordio, jbatcher), "port": (trecordio, tbatcher)}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.disarm()
    yield
    faultinject.disarm()


def test_native_libraries_build_into_the_port():
    trecordio._load()
    tbatcher._load()
    build = os.path.join(os.path.dirname(tfluid.__file__), "_build")
    assert trecordio._SO_PATH == os.path.join(build, "libptrecordio.so")
    assert tbatcher._SO_PATH == os.path.join(build, "libptbatcher.so")
    assert os.path.exists(trecordio._SO_PATH)
    assert os.path.exists(tbatcher._SO_PATH)


@pytest.mark.parametrize("compressor", ["none", "gzip"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_recordio_files_cross(tmp_path, writer, reader, compressor):
    w, r = PACKAGES[writer][0], PACKAGES[reader][0]
    path = str(tmp_path / "recs.recordio")
    recs = [bytes([i]) * (i + 1) for i in range(40)]
    with w.Writer(path, max_chunk_records=7, compressor=compressor) as f:
        for rec in recs:
            f.write(rec)
    with r.Scanner(path) as s:
        assert list(s) == recs
    assert list(r.DataLoader(path, capacity=4)) == recs
    # numpy framing (write_arrays / array_reader) crosses too
    apath = str(tmp_path / "arrays.recordio")
    rows = [(np.full((2, 3), i, np.float32), np.arange(i, dtype=np.int64))
            for i in range(5)]
    w.write_arrays(apath, rows)
    got = list(r.array_reader(apath)())
    assert len(got) == 5
    for g, want in zip(got, rows):
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(g, want))


def test_recordio_same_bytes_and_corruption_detected(tmp_path):
    a, b = str(tmp_path / "a.rio"), str(tmp_path / "b.rio")
    for mod, path in ((jrecordio, a), (trecordio, b)):
        with mod.Writer(path, max_chunk_records=3) as f:
            for i in range(10):
                f.write(b"x" * i)
    assert open(a, "rb").read() == open(b, "rb").read()
    data = bytearray(open(b, "rb").read())
    data[-3] ^= 0xFF
    open(b, "wb").write(bytes(data))
    with pytest.raises(IOError):
        list(trecordio.Scanner(b))


SPECS = [((3,), "float32"), ((1,), "int64")]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_fixed_batcher_files_cross(tmp_path, writer, reader):
    w, r = PACKAGES[writer][1], PACKAGES[reader][1]
    path = str(tmp_path / "fixed.rio")
    rows = [(np.full(3, i, np.float32), np.asarray([i], np.int64))
            for i in range(10)]
    assert w.write_fixed(path, rows, SPECS) == 10
    batches = list(r.FixedBatcher(path, SPECS, 4, n_threads=1))
    assert [b[0].shape for b in batches] == [(4, 3), (4, 3), (2, 3)]
    xs = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    assert np.array_equal(xs[:, 0], np.arange(10, dtype=np.float32))
    assert np.array_equal(ys[:, 0], np.arange(10))
    # a shuffled pass of either package yields every sample exactly once;
    # the reference's order follows its producer thread's timing (ROADMAP
    # §3 R5), so the packages are held to the same samples, and the
    # port's order to its seed (test_port_batcher_order_is_a_function_of
    # _the_seed)
    passes = {name: [int(v) for b in mod[1].FixedBatcher(
        path, SPECS, 4, shuffle_buf=6, seed=3, n_threads=1)
        for v in b[1][:, 0]] for name, mod in PACKAGES.items()}
    for order in passes.values():
        assert sorted(order) == list(range(10))
    assert len(list(r.FixedBatcher(path, SPECS, 4, n_threads=1,
                                   drop_last=True))) == 2


def _shuffle_files(tmp_path, n_files=8, per_file=16):
    """Small gzip files: the one producer thread reads and inflates a
    file at a time, so between files the pool runs dry and the consumer
    waits on it (the producer held back)."""
    paths = []
    for f in range(n_files):
        p = str(tmp_path / f"shuf-{f}.rio")
        rows = [(np.full(3, f * per_file + i, np.float32),
                 np.asarray([f * per_file + i], np.int64))
                for i in range(per_file)]
        tbatcher.write_fixed(p, rows, SPECS, compressor="gzip")
        paths.append(p)
    return paths


def _port_order(paths, seed, lead_s):
    """One shuffled pass of the port's batcher (one producer thread);
    ``lead_s`` > 0 lets the producer fill its pool to capacity before the
    first batch is taken."""
    with tbatcher.FixedBatcher(paths, SPECS, 5, shuffle_buf=12, seed=seed,
                               n_threads=1) as it:
        if lead_s:
            time.sleep(lead_s)
        return [int(v) for _, lab in it for v in lab[:, 0]]


def test_port_batcher_order_is_a_function_of_the_seed(tmp_path):
    """F20: the port's buffered shuffle draws over the first
    ``shuffle_buf`` slots of its pool, so with one producer thread the
    order of a pass is the same in 20 passes — ten where the producer ran
    far ahead (the pool at capacity before the first batch) and ten where
    it was held back (consumed at once, the pool refilled file by
    file) — every sample exactly once, and another seed gives another
    order."""
    paths = _shuffle_files(tmp_path)
    n = 8 * 16
    want = _port_order(paths, seed=3, lead_s=0.0)
    assert sorted(want) == list(range(n)) and want != list(range(n))
    for k in range(20):
        assert _port_order(paths, seed=3,
                           lead_s=0.05 if k % 2 else 0.0) == want, k
    other = _port_order(paths, seed=4, lead_s=0.0)
    assert sorted(other) == list(range(n)) and other != want
    # the reference's pass holds the same samples, in an order of its own
    got = [int(v) for _, lab in jbatcher.FixedBatcher(
        paths, SPECS, 5, shuffle_buf=12, seed=3, n_threads=1)
        for v in lab[:, 0]]
    assert sorted(got) == list(range(n))


# tests/test_batcher.py's cases, each package reading the same files
BATCHER_SPECS = [((4,), "float32"), ((1,), "int64")]


def _write_parts(tmp_path, n_files=3, per_file=10):
    paths, k = [], 0
    for f in range(n_files):
        p = str(tmp_path / f"part-{f}.rec")
        rows = [(np.full(4, k + i, np.float32), np.array([k + i], np.int64))
                for i in range(per_file)]
        assert tbatcher.write_fixed(p, rows, BATCHER_SPECS) == per_file
        paths.append(p)
        k += per_file
    return paths


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_batches_cover_all_samples(tmp_path, pkg):
    """Three files on two producer threads, batches of 7: every sample
    once, the fields of a sample aligned."""
    paths = _write_parts(tmp_path)
    seen = []
    with PACKAGES[pkg][1].FixedBatcher(paths, BATCHER_SPECS,
                                       batch_size=7) as it:
        for imgs, labels in it:
            assert imgs.dtype == np.float32 and labels.dtype == np.int64
            assert imgs.shape[1:] == (4,) and labels.shape[1:] == (1,)
            np.testing.assert_array_equal(imgs[:, 0],
                                          labels[:, 0].astype(np.float32))
            seen.extend(labels[:, 0].tolist())
    assert sorted(seen) == list(range(30))


def test_shuffle_changes_order_but_not_content(tmp_path):
    """One file: the plain order is the file's in both packages; the
    shuffled one is another order of the same samples."""
    paths = _write_parts(tmp_path, n_files=1, per_file=64)
    orders = {}
    for name, (_, mod) in PACKAGES.items():
        plain = [int(v) for _, lab in mod.FixedBatcher(paths,
                                                       BATCHER_SPECS, 8)
                 for v in lab[:, 0]]
        shuf = [int(v) for _, lab in mod.FixedBatcher(
            paths, BATCHER_SPECS, 8, shuffle_buf=32, seed=3)
            for v in lab[:, 0]]
        assert sorted(shuf) == sorted(plain) == list(range(64))
        assert shuf != plain
        orders[name] = plain
    assert orders["port"] == orders["jax"]


def test_drop_last_and_bad_record_error(tmp_path):
    paths = _write_parts(tmp_path, n_files=1, per_file=10)
    out = {}
    for name, (_, mod) in PACKAGES.items():
        n = sum(len(lab) for _, lab in mod.FixedBatcher(
            paths, BATCHER_SPECS, 4, drop_last=True))
        assert n == 8                  # 10 -> two full batches of 4
        # wrong specs: the size mismatch surfaces as IOError
        with pytest.raises(IOError, match="expected") as e:
            list(mod.FixedBatcher(paths, [((3,), "float32"),
                                          ((1,), "int64")], 4))
        out[name] = (n, str(e.value))
    assert out["port"] == out["jax"]


def _batcher_training(fluid, mod, path, specs, state, **kw):
    """SGD over FixedBatcher's batches from ``state``'s initial values
    (the reference's startup when ``state`` is empty)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    if fluid is jfluid:
        scope = jfluid.Scope()
        exe.run(startup, scope=scope)
        state.update({n: np.asarray(scope.find_var(n))
                      for n in scope.keys()})
    else:
        scope = weights.load_state(tfluid.Scope(), state, CPU)
    losses = []
    for xs, ys in mod.FixedBatcher(path, specs, 16, **kw):
        out = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                      scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(())))
    return losses


def test_feeds_training(tmp_path):
    """200 samples in batches of 16 train a linear fit: through the
    port's shuffled batcher the loss falls as in the reference test; in
    file order (one producer, no shuffle) the losses equal the
    reference's from the same initial scope at the f32 loss tier."""
    rng = np.random.RandomState(0)
    w_true = rng.randn(4, 1).astype(np.float32)
    rows = []
    for _ in range(200):
        x = rng.randn(4).astype(np.float32)
        rows.append((x, (x @ w_true).astype(np.float32)))
    p = str(tmp_path / "train.rec")
    specs = [((4,), "float32"), ((1,), "float32")]
    tbatcher.write_fixed(p, rows, specs)
    state = {}
    want = _batcher_training(jfluid, jbatcher, p, specs, state,
                             n_threads=1)
    got = _batcher_training(tfluid, tbatcher, p, specs, state, n_threads=1)
    assert len(got) == len(want) == 13     # 200/16 -> 12 full + 1 short
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    shuffled = _batcher_training(tfluid, tbatcher, p, specs, state,
                                 shuffle_buf=64, seed=1)
    assert len(shuffled) == 13
    assert shuffled[-1] < 0.3 * shuffled[0], shuffled


def _py_reader_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        reader = fluid.layers.py_reader(
            capacity=8, shapes=[[-1, 4], [-1, 1]],
            dtypes=["float32", "int64"])
        x, y = fluid.layers.read_file(reader)
        fc = fluid.layers.fc(x, size=2)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(fc, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, reader, loss


def _samples():
    rng = np.random.RandomState(0)
    return [(rng.rand(4).astype(np.float32), np.array([i % 2], np.int64))
            for i in range(20)]


def _run_until_eof(fluid, main, reader, loss, exe, scope):
    losses = []
    with fluid.scope_guard(scope):
        reader.start()
        with pytest.raises(EOF[fluid.__name__]):
            while True:
                out = exe.run(main, fetch_list=[loss])
                losses.append(float(np.asarray(out[0]).reshape(())))
    return losses


EOF = {"paddle_tpu": jfluid.core.EOFException,
       "paddle_tpu_torch": tfluid.core.executor.EOFException}


def test_py_reader_trains_until_eof_as_the_reference():
    """py_reader decorated with a batched python reader feeds every run
    until EOFException; four SGD steps give the reference's losses from
    the same initial scope; the reader restarts."""
    jm, js, jr, jl = _py_reader_program(jfluid)
    tm, ts, tr, tl = _py_reader_program(tfluid)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(js, scope=jscope)
    for n in jscope.keys():
        tscope.set(n, weights.array_to_tensor(
            np.asarray(jscope.find_var(n)), CPU))
    samples = _samples()
    jr.decorate_paddle_reader(jfluid.reader.batch(lambda: iter(samples), 5))
    tr.decorate_paddle_reader(tfluid.reader.batch(lambda: iter(samples), 5))
    want = _run_until_eof(jfluid, jm, jr, jl, jexe, jscope)
    got = _run_until_eof(tfluid, tm, tr, tl, texe, tscope)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # explicit feed keys win over a started reader, which then keeps
    # its place; it restarts after EOF
    names = tr.var_names()
    feed = {names[0]: np.zeros((3, 4), np.float32),
            names[1]: np.zeros((3, 1), np.int64)}
    test = tm.clone(for_test=True)
    with tfluid.scope_guard(tscope):
        alone = texe.run(test, feed=feed, fetch_list=[tl])[0]
        tr.start()
        fed = texe.run(test, feed=feed, fetch_list=[tl])[0]
        first = texe.run(tm, fetch_list=[x.name for x in tr._vars])[0]
    assert np.array_equal(alone, fed)
    assert np.array_equal(first, np.stack([s[0] for s in samples[:5]]))


def test_reader_composition_and_preprocessor(tmp_path):
    """open_recordio_file -> shuffle -> batch -> double_buffer ->
    Preprocessor (its transform ops in the main program): 12 rows in
    batches of 4 reach the program as 3 runs, each sum the reference's
    for the same rows."""
    path = str(tmp_path / "data.recordio")
    rng = np.random.RandomState(1)
    rows = [(rng.rand(3).astype(np.float32),) for _ in range(12)]
    trecordio.write_arrays(path, rows)
    sums = {}
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            r = fluid.layers.open_recordio_file(
                path, shapes=[[-1, 3]], dtypes=["float32"])
            r = fluid.layers.batch(r, batch_size=4)
            r = fluid.layers.double_buffer(r)
            pre = fluid.layers.Preprocessor(reader=r)
            with pre.block():
                (xv,) = pre.inputs()
                pre.outputs(fluid.layers.scale(xv, scale=2.0))
            r2 = pre()
            total = fluid.layers.reduce_sum(r2._vars[0])
        exe = fluid.Executor(fluid.CPUPlace())
        got = []
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            r2.start()
            try:
                while True:
                    got.append(float(np.asarray(
                        exe.run(main, fetch_list=[total])[0])))
            except EOF[fluid.__name__]:
                pass
        sums[fluid.__name__] = got
    assert len(sums["paddle_tpu_torch"]) == 3
    np.testing.assert_allclose(sums["paddle_tpu_torch"], sums["paddle_tpu"],
                               rtol=1e-6)
    # shuffle and open_files compose too
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        r = tfluid.layers.open_files([path, path], shapes=[[-1, 3]],
                                     dtypes=["float32"], buffer_size=4)
        r = tfluid.layers.batch(tfluid.layers.shuffle(r, buffer_size=8), 6)
        total = tfluid.layers.reduce_sum(tfluid.layers.read_file(r))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        r.start()
        got = []
        with pytest.raises(EOF["paddle_tpu_torch"]):
            while True:
                got.append(exe.run(main, fetch_list=[total])[0].item())
    assert len(got) == 4
    np.testing.assert_allclose(sum(got), 2 * sum(float(x.sum())
                                                 for (x,) in rows),
                               rtol=1e-5)


def test_random_data_generator():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        r = tfluid.layers.random_data_generator(
            low=0.0, high=1.0, shapes=[[8, 4]])
        m = tfluid.layers.mean(tfluid.layers.read_file(r))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        r.start()
        v = exe.run(main, fetch_list=[m])[0].item()
    assert 0.2 < v < 0.8


def test_reader_decorators_equal_the_reference():
    def src():
        return iter(range(10))
    for name, args in (("batch", (3,)), ("firstn", (4,)),
                       ("buffered", (2,)), ("cache", ())):
        want = list(getattr(jfluid.reader, name)(src, *args)())
        got = list(getattr(tfluid.reader, name)(src, *args)())
        assert got == want, name
    want = list(jfluid.reader.chain(src, src)())
    assert list(tfluid.reader.chain(src, src)()) == want
    assert list(tfluid.reader.compose(src, src)()) == \
        list(jfluid.reader.compose(src, src)())
    assert list(tfluid.reader.map_readers(lambda a: a * 2, src)()) == \
        list(range(0, 20, 2))
    assert sorted(tfluid.reader.shuffle(src, 4)()) == list(range(10))


def test_data_feeder_as_the_reference():
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(
                main, fluid.Program()):
            fluid.layers.data("img", shape=[2, 2])
            fluid.layers.data("lbl", shape=[1], dtype="int64")
        feeder = fluid.DataFeeder(["img", "lbl"], program=main)
        rows = [(np.arange(4, dtype=np.float32) + i, [i]) for i in range(3)]
        out = feeder.feed(rows)
        if fluid is jfluid:
            want = out
        else:
            assert sorted(out) == sorted(want)
            for k in want:
                assert out[k].dtype == want[k].dtype
                assert np.array_equal(out[k], want[k])
    assert feeder.feed(want) is want       # a feed dict passes through


def _reader(n=10):
    def reader():
        rng = np.random.RandomState(0)
        for _ in range(n):
            x = rng.rand(8, 4).astype(np.float32)
            yield x, (x.sum(1, keepdims=True) > 2.0).astype(np.int64)
    return reader


def test_device_loader_on_the_cpu_order_and_errors():
    """Every batch, in order, as CPU tensors of their own; dict readers
    need no feed_names; a reader's error reaches the consumer."""
    seen = []
    with DeviceLoader(_reader(), feed_names=["x", "y"], buffer_size=3,
                      device=tfluid.CPUPlace()) as dl:
        for feed in dl:
            assert isinstance(feed["x"], torch.Tensor)
            assert feed["x"].device == CPU
            seen.append(feed["x"].numpy())
    want = [x for x, _ in _reader()()]
    assert len(seen) == 10
    assert all(np.array_equal(g, w) for g, w in zip(seen, want))

    def dict_reader():
        for i in range(3):
            yield {"a": np.full((2,), i, np.float32)}

    got = [float(f["a"][0]) for f in DeviceLoader(dict_reader,
                                                  device="cpu")]
    assert got == [0.0, 1.0, 2.0]

    def bad_reader():
        yield {"a": np.zeros(1)}
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(DeviceLoader(bad_reader, device="cpu"))
    with pytest.raises(ValueError, match="feed_names"):
        list(DeviceLoader(_reader(), device="cpu"))
    with pytest.raises(ValueError, match="buffer_size"):
        DeviceLoader(_reader(), buffer_size=0, device="cpu")


def test_device_loader_buffer_size_bounds_the_prefetch():
    """The producer runs at most ``buffer_size`` batches ahead of the
    consumer (plus the one it holds while the queue is full)."""
    import threading
    pulled = []
    gate = threading.Event()

    def reader():
        for i in range(20):
            pulled.append(i)
            yield {"a": np.full((1,), i, np.float32)}

    dl = DeviceLoader(reader, buffer_size=2, device="cpu")
    it = iter(dl)
    first = next(it)
    gate.wait(0.3)
    assert float(first["a"][0]) == 0.0
    assert len(pulled) <= 1 + 2 + 1
    rest = [float(f["a"][0]) for f in it]
    assert rest == [float(i) for i in range(1, 20)]


def test_device_loader_early_break_releases_worker():
    def reader():
        for i in range(100):
            yield {"a": np.full((4,), i, np.float32)}

    dl = DeviceLoader(reader, buffer_size=2, device="cpu")
    for _ in dl:
        break
    assert dl._thread is None
    assert float(next(iter(dl))["a"][0]) == 0.0
    dl.stop()


def test_device_loader_retries_reader():
    def source():
        for i in range(4):
            yield {"x": np.full((2, 2), i, np.float32)}

    faultinject.arm("reader_io_error", at=1, times=1)
    dl = DeviceLoader(source, buffer_size=2, reader_retries=3,
                      device="cpu")
    assert [float(f["x"][0, 0]) for f in dl] == [0.0, 1.0, 2.0, 3.0]


def test_device_loader_feeds_training_like_direct_feeding():
    """Training through DeviceLoader's tensors equals training on the
    same arrays fed directly, bit for bit."""
    losses = {}
    for mode in ("direct", "loader"):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                              startup):
            x = tfluid.layers.data("x", shape=[4])
            y = tfluid.layers.data("y", shape=[1], dtype="int64")
            loss = tfluid.layers.mean(tfluid.layers.softmax_with_cross_entropy(
                tfluid.layers.fc(x, size=2), y))
            tfluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        src = (DeviceLoader(_reader(), feed_names=["x", "y"],
                            device="cpu") if mode == "loader" else
               ({"x": a, "y": b} for a, b in _reader()()))
        losses[mode] = [exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0].item() for f in src]
    assert losses["direct"] == losses["loader"]
    assert losses["direct"][-1] < losses["direct"][0]
