"""Shared helpers of the serving, chaos, resilience and error-path port
tests (``test_torch_serving.py``, ``test_torch_serving_chaos.py``,
``test_torch_resilience.py``, ``test_torch_error_paths.py``): the
reference tests' tiny programs built the same way in both packages, the
reference initializing and the port receiving the same weights through
``paddle_tpu_torch/weights.py``; ``ServingEngine``s over them on the
CPU; and the two packages' fault injectors, which hold separate global
state, disarmed together.

A case runs the same input and fault schedule through each package
(``both``) and compares what comes out: answers at ANSWER_TOL (the
reference's own tolerance for a served answer against a direct run,
``tests/test_serving.py`` ``test_serving_from_saved_model_and_inferencer``),
counters, error types and the backoff a recording ``sleep`` saw,
exactly.
"""
import types

import numpy as np
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.resilience import faultinject as jfaultinject
from paddle_tpu.resilience import retry as jretry

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import weights
from paddle_tpu_torch.resilience import faultinject as tfaultinject
from paddle_tpu_torch.resilience import retry as tretry

CPU = torch.device("cpu")
ANSWER_TOL = dict(rtol=1e-6, atol=1e-7)
PKG_NAMES = ("jax", "port")
PKGS = {
    "jax": types.SimpleNamespace(name="jax", fluid=jfluid,
                                 serving=jserving,
                                 faultinject=jfaultinject, retry=jretry),
    "port": types.SimpleNamespace(name="port", fluid=tfluid,
                                  serving=tserving,
                                  faultinject=tfaultinject, retry=tretry),
}


class FakeClock:
    """A settable clock for the policy units (``clock=``)."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def disarm_all():
    """Disarm every fault point in both packages."""
    for p in PKGS.values():
        p.faultinject.disarm()


def to_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def scope_arrays(scope):
    """The reference scope's values as numpy, by name."""
    return {n: np.asarray(scope.find_var(n)) for n in scope.keys()
            if scope.find_var(n) is not None}


def mlp(fluid):
    """The reference tests' per-row model (``tests/test_serving.py``
    ``_make_model``): fc-relu-fc-softmax on [rows, 8]. Returns (main,
    startup, pred) built in fresh programs under a fresh name
    generator, so both packages name the parameters alike."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h, size=10, act="softmax")
    return main, startup, pred


def model_pair(build=mlp):
    """``build(fluid) -> (main, startup, fetch)`` in both packages: the
    reference's startup initializes, the port's scope gets the same
    arrays. Returns {"jax"|"port": (test clone, fetch, scope)}."""
    out = {}
    jmain, jstartup, jfetch = build(jfluid)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    out["jax"] = (jmain.clone(for_test=True), jfetch, jscope)
    tmain, _, tfetch = build(tfluid)
    tscope = weights.load_state(tfluid.Scope(), scope_arrays(jscope), CPU)
    out["port"] = (tmain.clone(for_test=True), tfetch, tscope)
    return out


def engine(p, model, feed_names=("x",), **kw):
    """A ``ServingEngine`` of package ``p`` over ``model`` on the CPU,
    with the reference tests' default buckets and config."""
    infer, fetch, scope = model
    kw.setdefault("buckets", p.serving.BucketSpec(batch_sizes=(1, 2, 4, 8)))
    kw.setdefault("config", p.serving.ServingConfig(max_wait_ms=1.0,
                                                    max_queue=32))
    return p.serving.ServingEngine(infer, list(feed_names), [fetch],
                                   scope=scope, place=p.fluid.CPUPlace(),
                                   **kw)


def both(case, *args, **kw):
    """``case(p, *args, **kw)`` for each package, faults disarmed around
    each run. Returns {"jax": ..., "port": ...}."""
    out = {}
    for name in PKG_NAMES:
        disarm_all()
        try:
            out[name] = case(PKGS[name], *args, **kw)
        finally:
            disarm_all()
    return out


def assert_answers_close(got, want):
    """Each request's fetch list of the port within ANSWER_TOL of the
    reference's."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a, b = to_numpy(a), to_numpy(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **ANSWER_TOL)


def counters(stats, names):
    """The named entries of an engine's stats snapshot."""
    return {n: stats[n] for n in names}
