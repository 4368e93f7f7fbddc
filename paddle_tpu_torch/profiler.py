"""Profiler (port of ``paddle_tpu/profiler.py``; reference
python/paddle/fluid/profiler.py).

Fluid profiles per-op kernel launches and can emit a chrome tracing
timeline (python/paddle/fluid/profiler.py:221,
paddle/fluid/platform/profiler.cc). The port keeps the reference's
names and its host side: (name, seconds) records for the printed
summary, and a chrome://tracing timeline of executor dispatches and
``record_event`` regions, written by ``stop_profiler`` /
``export_chrome_tracing`` as ``host_timeline.json``.

The device view comes from ``torch.profiler`` (the reference's
``jax.profiler`` trace): a session opens one ``torch.profiler.profile``
— CPU and CUDA activities when the process's default place is the card,
CPU only on the host — and ``stop_profiler`` writes its chrome trace
into ``profile_path`` as ``torch_trace.json``, beside the host timeline.
``device_kernel_profile`` reads that trace's CUDA kernel events back.
"""
import contextlib
import glob
import json
import os
import tempfile
import time

import torch

__all__ = ["cuda_profiler", "reset_profiler", "start_profiler",
           "stop_profiler", "profiler", "record_event",
           "export_chrome_tracing", "device_kernel_profile"]

#: the file a session's torch.profiler trace is written to, in
#: ``profile_path``
TORCH_TRACE = "torch_trace.json"

_DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "paddle_tpu_profile")

_records = []          # (name, seconds)
_events = []           # chrome-trace events: dicts with name/ts/dur (us)
_active = None         # (state, trace, t0, wall0)
_depth = 0             # nesting level; only the outermost start/stop act

# Wall-clock anchor pairing one time.time_ns() with one
# time.perf_counter(): perf_counter's origin is arbitrary per process,
# so timeline ts are emitted as epoch-anchored microseconds — timelines
# from different processes (or torch.profiler's trace) share a timebase.
_EPOCH_NS = time.time_ns()
_EPOCH_PERF = time.perf_counter()


def _to_epoch_us(perf_seconds):
    return _EPOCH_NS / 1e3 + (perf_seconds - _EPOCH_PERF) * 1e6


def profiling_active():
    """True while a profiler session is open (the Executor uses this to
    decide whether to record dispatch timeline events)."""
    return _active is not None


def add_timeline_event(name, t0, t1, tid="executor", args=None):
    """Record one complete chrome-trace slice ('X' phase). ``t0``/``t1``
    are time.perf_counter() seconds; stored as epoch-anchored
    microseconds (see ``_EPOCH_NS``) as the chrome tracing spec
    wants."""
    ev = {"name": name, "ph": "X", "ts": _to_epoch_us(t0),
          "dur": max(0.0, (t1 - t0) * 1e6), "pid": os.getpid(),
          "tid": tid}
    if args:
        ev["args"] = args
    _events.append(ev)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """Kept for source compatibility: delegates to the session profiler
    with ``output_file`` as the trace directory, as the reference does."""
    with profiler("All", profile_path=output_file):
        yield


def reset_profiler():
    _records.clear()
    _events.clear()


def _on_the_card():
    """Whether the process's entry points run on the card (the default
    place is CUDA), so a session traces CUDA activity too."""
    from .core import executor
    return torch.cuda.is_available() and not executor._FORCED_CPU


def _open_trace():
    """A started ``torch.profiler.profile``, or None where tracing
    cannot start (the timers still run, as the reference's do)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if _on_the_card():
        acts.append(ProfilerActivity.CUDA)
    trace = profile(activities=acts)
    try:
        trace.start()
    except RuntimeError:   # the profiler backend failed to start
        return None
    return trace


def start_profiler(state, profile_path=_DEFAULT_PATH):
    """state: 'CPU' | 'GPU' | 'All' (accepted for parity; all mean the
    same thing — the host timers and the torch.profiler trace)."""
    global _active, _depth
    if state not in ("CPU", "GPU", "All"):
        raise ValueError("state must be 'CPU', 'GPU' or 'All'")
    _depth += 1
    if _active is not None:
        return
    # the timeline file is PER SESSION (unlike _records, whose
    # cross-session aggregate matches the reference's summary): a new
    # outermost session starts a fresh trace
    _events.clear()
    _active = (state, _open_trace(), time.perf_counter(), time.time())


def stop_profiler(sorted_key=None, profile_path=_DEFAULT_PATH):
    global _active, _depth
    if _active is None:
        return
    _depth = max(0, _depth - 1)
    if _depth > 0:          # inner stop of a nested session: outer still owns it
        return
    state, trace, t0, wall0 = _active
    _active = None
    if trace is not None:
        try:
            trace.stop()
        except RuntimeError:
            trace = None
    total = time.perf_counter() - t0
    _records.append(("<session>", total))
    if profile_path:
        try:
            export_chrome_tracing(os.path.join(profile_path,
                                               "host_timeline.json"))
            if trace is not None:
                trace.export_chrome_trace(
                    os.path.join(profile_path, TORCH_TRACE))
        except OSError:
            pass               # unwritable path: keep the printed summary
    _print_summary(sorted_key)
    if trace is not None and profile_path \
            and _has_trace_since(profile_path, wall0):
        # device-side view of the same session (the reference's
        # device_tracer summary): top kernels by device time. Gated on
        # a trace written SINCE this session started, so a leftover
        # file of an earlier session is never reported as this one's.
        try:
            prof = device_kernel_profile(profile_path, top_k=10)
        except Exception:
            prof = None        # parsing must never break a session
        if prof and prof["n_kernels"]:
            print(f"Device kernels: {prof['n_kernels']} events, "
                  f"{prof['device_total_ms']:.3f} ms total")
            for k in prof["top_kernels"]:
                # a CUDA kernel's name is its whole C++ signature
                print(f"  {k['total_ms']:10.3f} ms  x{k['count']:<6} "
                      f"{k['name'][:120]}")


def export_chrome_tracing(path):
    """Write the host-side timeline (executor dispatches + record_event
    regions) as chrome://tracing / Perfetto-loadable JSON — the
    reference's profile-proto → chrome-trace path, host-side. The
    device timeline itself is the session's ``torch_trace.json``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": _events,
                   "displayTimeUnit": "ms"}, f)
    return path


def _trace_paths(trace_dir):
    return glob.glob(os.path.join(trace_dir, "**", TORCH_TRACE),
                     recursive=True)


def _has_trace_since(trace_dir, wall0):
    try:
        return any(os.path.getmtime(p) >= wall0 - 1.0
                   for p in _trace_paths(trace_dir))
    except OSError:
        return False


def device_kernel_profile(trace_dir, top_k=25):
    """Parse a ``profiler()`` session's torch.profiler trace in
    ``trace_dir`` into per-kernel DEVICE durations — the reference
    device_tracer's role (paddle/fluid/platform/device_tracer.cc: CUPTI
    activity records → per-op device spans), from the trace's CUDA
    kernel events (category ``kernel``).

    Returns {"planes": [names...], "device_total_ms", "n_kernels",
    "top_kernels": [{"name", "total_ms", "count"}...]} — ``planes``
    names the host and each device the trace holds kernels of
    (``/device:GPU:<n>``); ``n_kernels`` is 0 for a host-only session —
    or None when the directory holds no trace."""
    paths = _trace_paths(trace_dir)
    if not paths:
        return None
    with open(max(paths, key=os.path.getmtime)) as f:
        events = json.load(f).get("traceEvents", [])
    agg, devices = {}, set()
    for ev in events:
        if ev.get("cat") != "kernel" or ev.get("ph") != "X":
            continue
        devices.add(ev.get("args", {}).get("device", ev.get("pid")))
        ms = float(ev.get("dur", 0.0)) / 1e3
        tot, cnt = agg.get(ev["name"], (0.0, 0))
        agg[ev["name"]] = (tot + ms, cnt + 1)
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top_k]
    return {
        "planes": ["/host:CPU"] + [f"/device:GPU:{d}"
                                   for d in sorted(devices, key=str)],
        "device_total_ms": round(float(sum(t for t, _ in agg.values())), 3),
        "n_kernels": sum(c for _, c in agg.values()),
        "top_kernels": [{"name": n, "total_ms": round(t, 3), "count": c}
                        for n, (t, c) in top],
    }


def _print_summary(sorted_key):
    rows = list(_records)
    if sorted_key in ("total", "max", "ave"):
        rows.sort(key=lambda r: r[1], reverse=True)
    width = max([len(n) for n, _ in rows] + [8])
    print(f"{'Event':<{width}}  Time(s)")
    for name, secs in rows:
        print(f"{name:<{width}}  {secs:.6f}")


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=_DEFAULT_PATH):
    start_profiler(state, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def record_event(name):
    """Host-side named timer; shows up in the printed summary, the
    chrome timeline, and (when a trace is active) as a
    ``torch.profiler.record_function`` range in the torch trace."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        t1 = time.perf_counter()
        _records.append((name, t1 - t0))
        if _active is not None:
            add_timeline_event(name, t0, t1, tid="events")
