"""The port's API shims against the JAX package's: tests/test_api_shims.py's
``recordio_writer``, ``default_scope_funcs`` and host-side channel cases
(``concurrency``: ``make_channel``, ``channel_send``, ``channel_recv``,
``channel_close``, ``Select``, exported at the package's top level).

Each channel case runs on both packages (``fluid`` parametrized) and
asserts what the reference test asserts; every thread a case starts is
joined with a timeout and asserted finished, so no case can hang the
suite. Recordio files cross in both directions: what either package's
``convert_reader_to_recordio_file(s)`` writes, the other's scanner and
``open_recordio_file`` program read back sample for sample.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.io import recordio as jrecordio

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.io import recordio as trecordio

torch.set_num_threads(1)

FLUIDS = {"jax": jfluid, "torch": tfluid}
RECORDIO = {"jax": jrecordio, "torch": trecordio}
EOF = {"jax": jfluid.core.executor.EOFException,
       "torch": tfluid.core.executor.EOFException}
JOIN_S = 5.0


def _join(*threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


@pytest.fixture(params=sorted(FLUIDS))
def fluid(request):
    return FLUIDS[request.param]


# ---------------------------------------------------------------- recordio
def _feeder(fluid):
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                        fluid.Program()):
        img = fluid.layers.data(name="img", shape=[4], dtype="float32")
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
    return fluid.DataFeeder(feed_list=[img, lbl], place=fluid.CPUPlace(),
                            program=prog)


SAMPLES = [(np.random.RandomState(i).randn(4).astype(np.float32),
            [int(i % 3)]) for i in range(7)]


def _read_program(fluid, paths, batch):
    """The rows of ``paths`` read back through ``open_recordio_file`` ->
    ``batch`` -> ``read_file`` in ``fluid``'s program: a list of
    (img, lbl) batches."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        r = fluid.layers.open_files(paths, shapes=[[-1, 4], [-1, 1]],
                                    dtypes=["float32", "int64"]) \
            if len(paths) > 1 else fluid.layers.open_recordio_file(
                paths[0], shapes=[[-1, 4], [-1, 1]],
                dtypes=["float32", "int64"])
        r = fluid.layers.batch(r, batch)
        img, lbl = fluid.layers.read_file(r)
    exe = fluid.Executor(fluid.CPUPlace())
    out = []
    name = "jax" if fluid is jfluid else "torch"
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        r.start()
        try:
            while True:
                a, b = exe.run(main, fetch_list=[img, lbl])
                out.append((np.asarray(a), np.asarray(b)))
        except EOF[name]:
            pass
    return out


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
@pytest.mark.parametrize("compressor", ["none", "snappy", "gzip"])
def test_recordio_files_cross(tmp_path, writer, reader, compressor):
    """tests/test_api_shims.py::test_convert_reader_to_recordio_roundtrip:
    a file one package writes, the other's scanner and reading program
    read back; the two writers' files are byte for byte the same."""
    w = FLUIDS[writer]
    path = str(tmp_path / "samples.recordio")
    n = w.recordio_writer.convert_reader_to_recordio_file(
        path, lambda: iter(SAMPLES), _feeder(w), compressor=compressor)
    assert n == 7
    back = list(RECORDIO[reader].array_scanner(path))
    assert len(back) == 7
    for (img, lbl), (want_img, want_lbl) in zip(back, SAMPLES):
        np.testing.assert_array_equal(img, want_img)
        assert lbl.dtype == np.int64 and int(lbl[0]) == want_lbl[0]
    batches = _read_program(FLUIDS[reader], [path], 4)
    assert [len(b[0]) for b in batches] == [4, 3]
    np.testing.assert_array_equal(np.concatenate([b[0] for b in batches]),
                                  np.stack([s[0] for s in SAMPLES]))
    np.testing.assert_array_equal(
        np.concatenate([b[1] for b in batches]).reshape(-1),
        [s[1][0] for s in SAMPLES])
    other = str(tmp_path / "other.recordio")
    FLUIDS["jax" if writer == "torch" else "torch"] \
        .recordio_writer.convert_reader_to_recordio_file(
            other, lambda: iter(SAMPLES), _feeder(w), compressor=compressor)
    if compressor == "none":
        assert open(path, "rb").read() == open(other, "rb").read()


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_recordio_shards_cross(tmp_path, writer, reader):
    paths = FLUIDS[writer].recordio_writer.convert_reader_to_recordio_files(
        str(tmp_path / "shard"), 3, lambda: iter(SAMPLES),
        _feeder(FLUIDS[writer]), feed_order=["img", "lbl"])
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "shard-00000", "shard-00001", "shard-00002"]
    counts = [len(list(RECORDIO[reader].array_scanner(p))) for p in paths]
    assert counts == [3, 3, 1]
    rows = sum((len(b[0]) for b in _read_program(FLUIDS[reader], paths, 2)),
               0)
    assert rows == 7


# --------------------------------------------------------- scope functions
def test_default_scope_funcs(fluid):
    dsf = fluid.default_scope_funcs
    root = dsf.get_cur_scope()
    assert root is fluid.global_scope()
    root.set("a", 1)
    local = dsf.enter_local_scope()
    assert dsf.get_cur_scope() is local
    dsf.var("b")
    dsf.get_cur_scope().set("b", 2)
    assert dsf.find_var("b") == 2
    assert dsf.find_var("a") == 1          # falls back to the outer scope
    dsf.leave_local_scope()
    assert dsf.find_var("b") is None
    assert dsf.scoped_function(lambda: dsf.find_var("a")) == 1
    with pytest.raises(RuntimeError):
        while True:
            dsf.leave_local_scope()


def test_scope_stacks_are_per_thread():
    dsf = tfluid.default_scope_funcs
    seen = {}

    def worker():
        local = dsf.enter_local_scope()
        local.set("t", "worker")
        seen["own"] = dsf.find_var("t")
        seen["depth"] = len(dsf._stack())
        dsf.leave_local_scope()

    t = threading.Thread(target=worker)
    t.start()
    _join(t)
    assert seen == {"own": "worker", "depth": 2}
    assert dsf.find_var("t") is None and len(dsf._stack()) == 1


# ---------------------------------------------------------------- channels
def test_channel_names_at_the_top_level():
    for name in ("make_channel", "channel_send", "channel_recv",
                 "channel_close", "Select"):
        assert getattr(tfluid, name) is getattr(tfluid.concurrency, name)
        assert name in tfluid.concurrency.__all__


def test_channels_buffered_and_closed(fluid):
    ch = fluid.make_channel(capacity=2)
    assert fluid.channel_send(ch, 1)
    assert fluid.channel_send(ch, 2)
    assert fluid.channel_recv(ch) == (1, True)
    fluid.channel_close(ch)
    assert fluid.channel_recv(ch) == (2, True)   # drain after close
    assert fluid.channel_recv(ch) == (None, False)
    assert not fluid.channel_send(ch, 3)


def test_channel_send_copies_on_request(fluid):
    ch = fluid.make_channel(capacity=2)
    value = [1, 2]
    fluid.channel_send(ch, value, is_copy=True)
    fluid.channel_send(ch, value)
    value.append(3)
    assert fluid.channel_recv(ch) == ([1, 2], True)
    assert fluid.channel_recv(ch) == ([1, 2, 3], True)


def test_channels_rendezvous_producer_consumer(fluid):
    ch = fluid.make_channel(capacity=0)
    got = []

    def producer():
        for i in range(5):
            fluid.channel_send(ch, i)
        fluid.channel_close(ch)

    t = threading.Thread(target=producer)
    t.start()
    while True:
        v, ok = fluid.channel_recv(ch, timeout=JOIN_S)
        if not ok:
            break
        got.append(v)
    _join(t)
    assert got == [0, 1, 2, 3, 4]


def test_select_picks_ready_case(fluid):
    a, b = fluid.make_channel(capacity=1), fluid.make_channel(capacity=1)
    fluid.channel_send(b, "hi")
    result = (fluid.Select()
              .case_recv(a, lambda v: ("a", v))
              .case_recv(b, lambda v: ("b", v))
              .execute())
    assert result == ("b", "hi")
    # default fires when nothing is ready
    assert fluid.Select().case_recv(a, lambda v: v).default(
        lambda: "idle").execute() == "idle"
    with pytest.raises(ValueError):
        fluid.Select().execute()


def test_select_blocks_until_a_sender_arrives(fluid):
    ch = fluid.make_channel(capacity=1)
    t = threading.Thread(target=lambda: (time.sleep(0.05),
                                         fluid.channel_send(ch, 5)))
    t.start()
    assert fluid.Select().case_recv(ch, lambda v: v * 2).execute() == 10
    _join(t)


def test_close_wakes_blocked_sender(fluid):
    ch = fluid.make_channel(capacity=1)
    assert fluid.channel_send(ch, 1)          # fills the buffer
    result = {}
    t = threading.Thread(
        target=lambda: result.update(ok=fluid.channel_send(ch, 2)))
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()                       # genuinely blocked
    fluid.channel_close(ch)
    _join(t)
    assert result["ok"] is False
    # rendezvous sender with no receiver: close unblocks, reports False,
    # and the value is not visible to a post-close drain
    ch2 = fluid.make_channel(capacity=0)
    result2 = {}
    t2 = threading.Thread(
        target=lambda: result2.update(ok=fluid.channel_send(ch2, 9)))
    t2.start()
    t2.join(timeout=0.2)
    assert t2.is_alive()
    fluid.channel_close(ch2)
    _join(t2)
    assert result2["ok"] is False
    assert fluid.channel_recv(ch2) == (None, False)


def test_recv_timeout_is_not_close(fluid):
    ch = fluid.make_channel(capacity=2)
    with pytest.raises(TimeoutError):
        fluid.channel_recv(ch, timeout=0.05)  # open + empty -> timeout
    fluid.channel_send(ch, 7)
    assert fluid.channel_recv(ch, timeout=0.05) == (7, True)
    fluid.channel_close(ch)
    assert fluid.channel_recv(ch, timeout=0.05) == (None, False)


def test_select_send_on_closed_channel_fires_not_ok(fluid):
    ch = fluid.make_channel(capacity=1)
    fluid.channel_close(ch)
    result = (fluid.Select()
              .case_send(ch, 42, lambda ok: ("sent", ok))
              .execute())
    assert result == ("sent", False)


def test_rendezvous_send_timeout_is_one_deadline(fluid):
    """A capacity-0 send with a timeout waits one window in all, not a
    window for buffer space and another for the receiver's take."""
    ch = fluid.make_channel(capacity=0)
    parked = threading.Thread(target=lambda: fluid.channel_send(
        ch, "A", timeout=JOIN_S))
    parked.start()
    time.sleep(0.05)                          # A is parked in the buffer

    def late_taker():
        time.sleep(0.2)
        fluid.channel_recv(ch, timeout=JOIN_S)   # takes A's value

    taker = threading.Thread(target=late_taker)
    taker.start()
    t0 = time.monotonic()
    assert not fluid.channel_send(ch, "B", timeout=0.5)
    dt = time.monotonic() - t0
    assert dt < 0.64, dt
    fluid.channel_close(ch)
    _join(parked, taker)


# -------------------------------------------------------------- utils.plot
def test_ploter_collects_and_plots_as_the_reference(tmp_path, monkeypatch):
    """utils.plot (a copy of the reference's): the same curves collected,
    an unknown title refused, DISABLE_PLOT a no-op that keeps the data,
    and a figure saved with matplotlib imported only by ``plot``."""
    from paddle_tpu.utils.plot import Ploter as JPloter
    from paddle_tpu_torch.utils import Ploter
    plots = [P("train cost", "test cost") for P in (JPloter, Ploter)]
    for p in plots:
        for step in range(3):
            p.append("train cost", step, 1.0 / (step + 1))
        p.append("test cost", 2, 0.25)
        with pytest.raises(KeyError):
            p.append("nope", 0, 0.0)
    for title in ("train cost", "test cost"):
        assert vars(plots[1].data(title)) == vars(plots[0].data(title))
    monkeypatch.setenv("DISABLE_PLOT", "True")
    plots[1].plot(str(tmp_path / "off.png"))
    assert not (tmp_path / "off.png").exists()
    monkeypatch.delenv("DISABLE_PLOT")
    plots[1].plot(str(tmp_path / "on.png"))
    assert (tmp_path / "on.png").stat().st_size > 0
    plots[1].reset()
    assert plots[1].data("train cost").step == []
