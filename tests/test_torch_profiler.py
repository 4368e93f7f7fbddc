"""The port's profiler (``paddle_tpu_torch.profiler``) against the JAX
package's: tests/test_trainer.py's profiler cases, the Executor's hook
(one ``dispatch step N`` slice a run), and the same host-timeline event
names as the reference for the same loop.

The port's device view is ``torch.profiler``'s trace (``torch_trace.json``
beside ``host_timeline.json``); on the host a session traces the CPU
only, so ``device_kernel_profile`` reports ``n_kernels`` 0, and None for a
directory with no trace.
"""
import json
import os
import re
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import profiler

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_records():
    profiler.reset_profiler()
    jfluid.profiler.reset_profiler()
    yield
    profiler.reset_profiler()
    jfluid.profiler.reset_profiler()


def _fc_program(fluid, width=4, train=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [width], dtype="float32")
        y = fluid.layers.fc(x, size=2)
        if train:
            loss = fluid.layers.mean(y)
            fluid.optimizer.SGD(0.1).minimize(loss)
            y = loss
    return main, startup, y


def _loop(fluid, path, steps=3, repeats=1):
    """The same loop in either package: a session around ``steps`` runs,
    each feed under record_event("feed") and each run under "step"."""
    main, startup, y = _fc_program(fluid, train=True)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        with fluid.profiler.profiler("All", sorted_key="total",
                                     profile_path=path):
            for _ in range(steps):
                with fluid.profiler.record_event("feed"):
                    feed = {"x": np.ones((2, 4), np.float32)}
                with fluid.profiler.record_event("step"):
                    exe.run(main, feed=feed, fetch_list=[y],
                            repeats=repeats)
    return json.load(open(os.path.join(path, "host_timeline.json")))


def test_profiler_context(capsys):
    with profiler.profiler("All", sorted_key="total"):
        with profiler.record_event("step"):
            pass
    out = capsys.readouterr().out
    assert "Event" in out and "step" in out and "<session>" in out


def test_profiler_chrome_trace_export(tmp_path, capsys):
    """tests/test_trainer.py::test_profiler_chrome_trace_export on the
    port: record_event slices and >= 2 dispatch slices, each an 'X'
    event with epoch-anchored microseconds."""
    trace = _loop(tfluid, str(tmp_path), steps=2)
    capsys.readouterr()
    evs = trace["traceEvents"]
    names = [e["name"] for e in evs]
    assert "feed" in names
    assert sum(n.startswith("dispatch step") for n in names) >= 2
    now_us = time.time_ns() / 1e3
    for e in evs:
        assert e["ph"] == "X" and "ts" in e and "dur" in e
        assert abs(e["ts"] - now_us) < 3600e6
    assert trace["displayTimeUnit"] == "ms"


def test_one_dispatch_slice_a_run_with_consecutive_steps(tmp_path, capsys):
    trace = _loop(tfluid, str(tmp_path), steps=5, repeats=3)
    capsys.readouterr()
    steps = [int(m.group(1)) for e in trace["traceEvents"]
             for m in [re.fullmatch(r"dispatch step (\d+)", e["name"])] if m]
    assert len(steps) == 5
    # each run takes 3 steps: its slice names its first
    assert np.diff(steps).tolist() == [3] * 4
    for e in trace["traceEvents"]:
        if e["name"].startswith("dispatch"):
            assert e["args"]["repeats"] == 3
            assert e["tid"] == "executor"
    # a run's dispatch lies inside its "step" region
    regions = [e for e in trace["traceEvents"] if e["name"] == "step"]
    disp = [e for e in trace["traceEvents"]
            if e["name"].startswith("dispatch")]
    for r, d in zip(regions, disp):
        assert r["ts"] <= d["ts"] and d["ts"] + d["dur"] <= \
            r["ts"] + r["dur"] + 1.0


def test_host_timeline_names_equal_the_reference(tmp_path, capsys):
    """The same loop in both packages gives the same timeline: the same
    event names in the same order, on the same tids, with the same
    dispatch step numbers."""
    want = _loop(jfluid, str(tmp_path / "jax"))
    got = _loop(tfluid, str(tmp_path / "torch"))
    out = capsys.readouterr().out
    key = [(e["name"], e["tid"], e["ph"]) for e in want["traceEvents"]]
    assert [(e["name"], e["tid"], e["ph"])
            for e in got["traceEvents"]] == key
    assert out.count("<session>") == 2
    # the printed summaries have the reference's rows (names by rank)
    tables = [t for t in out.split("Event") if t.strip()][-2:]
    assert [re.findall(r"^(\S+)\s", t, re.M) for t in tables][0] == \
        [re.findall(r"^(\S+)\s", t, re.M) for t in tables][1]


def test_no_slice_without_a_session(tmp_path):
    main, startup, y = _fc_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed={"x": np.ones((1, 4), np.float32)},
                fetch_list=[y])
    assert profiler._events == [] and not profiler.profiling_active()
    with profiler.record_event("outside"):
        pass
    assert profiler._records[-1][0] == "outside" and profiler._events == []


def test_nested_sessions_keep_the_reference_depth(tmp_path, capsys):
    """An inner start/stop pair neither opens a second trace nor closes
    the outer session; only the outermost stop writes and prints."""
    path = str(tmp_path)
    profiler.start_profiler("All", path)
    outer = profiler._active
    profiler.start_profiler("GPU", path)
    assert profiler._active is outer and profiler._depth == 2
    with profiler.record_event("inner"):
        pass
    profiler.stop_profiler(None, path)
    assert profiler.profiling_active()
    assert not os.path.exists(os.path.join(path, "host_timeline.json"))
    assert capsys.readouterr().out == ""
    profiler.stop_profiler(None, path)
    assert not profiler.profiling_active() and profiler._depth == 0
    assert "<session>" in capsys.readouterr().out
    names = [e["name"] for e in json.load(open(os.path.join(
        path, "host_timeline.json")))["traceEvents"]]
    assert names == ["inner"]
    profiler.stop_profiler(None, path)          # no session: a no-op
    with pytest.raises(ValueError):
        profiler.start_profiler("TPU", path)


def test_device_kernel_profile(tmp_path, capsys):
    """tests/test_trainer.py::test_device_kernel_profile on the port: no
    trace -> None; a host session's trace parses with the reference's
    keys and no device kernel."""
    assert profiler.device_kernel_profile(str(tmp_path / "missing")) is None
    main, startup, y = _fc_program(tfluid, width=64)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with profiler.profiler("All", profile_path=str(tmp_path)):
            exe.run(main, feed={"x": np.ones((8, 64), np.float32)},
                    fetch_list=[y])
    capsys.readouterr()
    assert sorted(os.listdir(tmp_path)) == ["host_timeline.json",
                                            profiler.TORCH_TRACE]
    r = profiler.device_kernel_profile(str(tmp_path))
    assert set(r) == {"planes", "device_total_ms", "n_kernels",
                      "top_kernels"}
    assert r["planes"] == ["/host:CPU"] and r["n_kernels"] == 0
    assert r["device_total_ms"] == 0.0 and r["top_kernels"] == []
    # the host trace holds the session's record_function ranges
    trace = json.load(open(tmp_path / profiler.TORCH_TRACE))
    assert any(e.get("name") == "aten::addmm" or e.get("name") == "aten::mm"
               for e in trace["traceEvents"])


def test_device_kernel_profile_reads_cuda_kernel_events(tmp_path):
    """The parser on a trace holding CUDA kernel events (the format
    torch.profiler writes on the card: category "kernel", microsecond
    durations, the device in args): per-kernel totals, counts, the
    device planes."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "sm90_gemm", "dur": 1500.0,
         "ts": 0, "pid": 0, "tid": 7, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "sm90_gemm", "dur": 500.0,
         "ts": 2000, "pid": 0, "tid": 7, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "bn_fw", "dur": 250.0,
         "ts": 3000, "pid": 0, "tid": 7, "args": {"device": 0}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9000.0,
         "ts": 0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "dur": 800.0, "ts": 0, "pid": 0, "tid": 8}]
    with open(tmp_path / profiler.TORCH_TRACE, "w") as f:
        json.dump({"traceEvents": events}, f)
    r = profiler.device_kernel_profile(str(tmp_path), top_k=1)
    assert r == {"planes": ["/host:CPU", "/device:GPU:0"],
                 "device_total_ms": 2.25, "n_kernels": 3,
                 "top_kernels": [{"name": "sm90_gemm", "total_ms": 2.0,
                                  "count": 2}]}


def test_cuda_profiler_delegates(tmp_path, capsys):
    with profiler.cuda_profiler(str(tmp_path / "out")):
        with profiler.record_event("r"):
            pass
    assert "<session>" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "out" / "host_timeline.json")


def test_export_chrome_tracing_and_reset(tmp_path):
    profiler.add_timeline_event("x", 1.0, 1.5, tid="t", args={"k": 1})
    path = profiler.export_chrome_tracing(str(tmp_path / "a" / "t.json"))
    (ev,) = json.load(open(path))["traceEvents"]
    assert ev["name"] == "x" and ev["dur"] == pytest.approx(5e5)
    assert ev["args"] == {"k": 1} and ev["tid"] == "t"
    profiler.reset_profiler()
    assert profiler._events == [] and profiler._records == []
