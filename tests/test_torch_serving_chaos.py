"""The serving engines' failure paths, the torch port against the JAX
package on the CPU (paddle_tpu_torch/serving/health.py and the engines'
breaker, drain, watchdog and retry wiring): every case of
``tests/test_serving_chaos.py``, and the ``DecodeEngine`` under the same
``serving_device_error`` schedule in both packages.

Each case arms the same faults in each package's own injector (the two
hold separate global state; ``tests/torch_serving_common.py`` disarms
both around every run), holds each package to the reference test's own
assertions, and holds the port's outcome to the reference's wherever the
outcome follows from the input and the fault schedule: answers at
ANSWER_TOL, error types, health states and the breaker, error and retry
counters exactly. Outcomes that follow thread timing (how many requests
a drain deadline cut, how many retries fit a deadline) are held in each
package to the reference's bounds. Policy units run under fake clocks;
engine waits are bounded (``infer(timeout=…)``, ``result(timeout=…)``).

Reference test → port case:

- ``test_serving_fault_points_registered`` → ``test_serving_fault_points_registered``
- ``test_health_monitor_states_and_heartbeat`` → ``test_health_monitor_states_and_heartbeat``
- ``test_breaker_opens_after_consecutive_failures_only`` → ``test_breaker_opens_after_consecutive_failures_only``
- ``test_breaker_half_open_probe_cycle`` → ``test_breaker_half_open_probe_cycle``
- ``test_with_retries_deadline_caps_the_loop`` → ``test_with_retries_deadline_caps_the_loop``
- ``test_breaker_open_shed_half_open_recover`` → ``test_breaker_open_shed_half_open_recover``
- ``test_graceful_drain_completes_all_inflight_work`` → ``test_graceful_drain_completes_all_inflight_work``
- ``test_drain_deadline_bounds_a_wedged_shutdown`` → ``test_drain_deadline_bounds_a_wedged_shutdown``
- ``test_watchdog_fails_pending_on_worker_crash_and_restart_recovers`` →
  ``test_watchdog_fails_pending_on_worker_crash_and_restart_recovers``
- ``test_infer_detects_dead_worker_without_watchdog`` → ``test_infer_detects_dead_worker_without_watchdog``
- ``test_dispatch_retries_never_outlive_the_request_deadline`` →
  ``test_dispatch_retries_never_outlive_the_request_deadline``
- ``test_submit_while_draining_or_stopped_is_refused`` → ``test_submit_while_draining_or_stopped_is_refused``
- (no reference test: the decode engine's fault point, armed by no
  reference test) → ``test_decode_engine_device_error_schedule_equals_the_reference``
"""
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import llama as tllama

from torch_serving_common import (CPU, FakeClock, assert_answers_close,
                                  both, counters, disarm_all, engine,
                                  model_pair, scope_arrays)

torch.set_num_threads(1)

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True)
def _clean_faults():
    disarm_all()
    yield
    disarm_all()


def _feed(n=1):
    return {"x": np.zeros((n, 8), np.float32)}


# ---------------------------------------------------------------------------
# health.py units — deterministic under a fake clock
# ---------------------------------------------------------------------------

def test_serving_fault_points_registered():
    def case(p):
        fired = []
        for kind in ("serving_device_error", "serving_slow_batch",
                     "serving_worker_crash"):
            assert kind in p.faultinject.KNOWN_POINTS
            spec = p.faultinject.arm(kind, at=1)
            fired.append([spec.should_fire(), spec.should_fire()])
        p.faultinject.disarm()
        assert fired == [[False, True]] * 3
        return fired, sorted(p.faultinject.KNOWN_POINTS)

    out = both(case)
    assert out["port"] == out["jax"]


def test_health_monitor_states_and_heartbeat():
    def case(p):
        clk = FakeClock()
        h = p.serving.HealthMonitor(clock=clk)
        states = [h.state]
        assert h.state == p.serving.HealthState.STARTING
        assert h.heartbeat_age() is None    # never beat != infinitely stale
        h.beat()
        clk.t += 2.5
        age = h.heartbeat_age()
        assert age == pytest.approx(2.5)
        prev = h.to(p.serving.HealthState.READY)
        assert prev == p.serving.HealthState.STARTING
        states += [prev, h.state]
        with pytest.raises(ValueError):
            h.to("SORT_OF_OK")
        return states, age

    out = both(case)
    assert out["port"] == out["jax"]


def test_breaker_opens_after_consecutive_failures_only():
    def case(p):
        Breaker = p.serving.CircuitBreaker
        clk = FakeClock()
        br = Breaker(failure_threshold=3, cooldown_s=5.0, clock=clk)
        trace = [br.state]
        for step in ("f", "f", "s", "f", "f"):
            (br.record_failure if step == "f" else br.record_success)()
            trace.append(br.state)
        assert br.state == Breaker.CLOSED
        edge = br.record_failure()          # the 3rd consecutive: the edge
        assert edge is True and br.state == Breaker.OPEN
        assert br.opens_total == 1
        return trace + [edge, br.state, br.opens_total]

    out = both(case)
    assert out["port"] == out["jax"]


def test_breaker_half_open_probe_cycle():
    def case(p):
        Breaker = p.serving.CircuitBreaker
        clk = FakeClock()
        br = Breaker(failure_threshold=1, cooldown_s=5.0, clock=clk)
        br.record_failure()
        trace = [br.state, br.admits(), br.allow()]
        assert trace == [Breaker.OPEN, False, False]     # cooling down
        clk.t += 5.0
        trace += [br.admits(), br.state]                 # read-only
        assert trace[-2:] == [True, Breaker.OPEN]
        trace += [br.allow(), br.state]                  # flips
        assert trace[-2:] == [True, Breaker.HALF_OPEN]
        br.record_failure()                              # the probe failed
        trace.append(br.state)
        assert br.state == Breaker.OPEN
        clk.t += 5.0
        trace.append(br.allow())
        br.record_success()                              # the probe passed
        trace += [br.state, br.opens_total]
        assert br.state == Breaker.CLOSED and br.opens_total == 2
        snap = br.snapshot()
        assert snap["state"] == "closed" and snap["opens_total"] == 2
        return trace, snap

    out = both(case)
    assert out["port"] == out["jax"]


def test_with_retries_deadline_caps_the_loop():
    """The retry loop stops re-dispatching once backing off would reach
    the deadline; without one the policy burns every attempt."""
    def case(p):
        t = [0.0]
        calls = []

        def fail():
            calls.append(t[0])
            raise p.retry.TransientDeviceError("UNAVAILABLE")

        policy = p.retry.RetryPolicy(
            max_attempts=5, initial_backoff=1.0, multiplier=1.0,
            sleep=lambda d: t.__setitem__(0, t[0] + d))
        with pytest.raises(p.retry.TransientDeviceError):
            p.retry.with_retries(fail, policy=policy, deadline=2.5,
                                 clock=lambda: t[0])
        capped = list(calls)
        assert capped == [0.0, 1.0, 2.0]
        t[0] = 0.0
        calls.clear()
        with pytest.raises(p.retry.TransientDeviceError):
            p.retry.with_retries(fail, policy=policy, clock=lambda: t[0])
        assert len(calls) == 5
        return capped, list(calls)

    out = both(case)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# engine end to end — real threads, injected faults
# ---------------------------------------------------------------------------

BREAKER_COUNTERS = ("breaker_open_total", "breaker_shed_total",
                    "breaker_probe_total", "errors_total", "retries_total",
                    "responses_total", "warmup_compiles")


def test_breaker_open_shed_half_open_recover():
    """Two consecutive batch failures open the engine's and the bucket's
    breakers; an open breaker sheds at submit with
    ServiceUnavailableError; after the cooldown a half-open probe closes
    them. The counters, health states and the probe's answer equal the
    reference's on the same schedule."""
    models = model_pair()

    def case(p):
        HealthState = p.serving.HealthState
        cfg = p.serving.ServingConfig(
            max_wait_ms=1.0, breaker_threshold=2, breaker_cooldown_s=0.05,
            retry_policy=p.retry.RetryPolicy(max_attempts=1))
        with engine(p, models[p.name], config=cfg) as eng:
            eng.warmup()
            p.faultinject.arm("serving_device_error", at=0, times=2)
            for _ in range(2):
                with pytest.raises(p.retry.TransientDeviceError):
                    eng.infer(_feed(), timeout=10.0)
            opened = eng.stats()
            assert opened["health_state"] == HealthState.DEGRADED
            assert opened["breaker"]["state"] == "open"
            assert opened["breaker_open_total"] == 2
            assert opened["errors_total"] == 2
            assert opened["bucket_breakers_not_closed"]
            with pytest.raises(p.serving.ServiceUnavailableError):
                eng.submit(_feed())
            assert eng.stats()["breaker_shed_total"] == 1
            time.sleep(0.06)                   # the cooldown elapses
            out = eng.infer(_feed(), timeout=10.0)   # the half-open probe
            assert out[0].shape == (1, 10)
            stats = eng.stats()
            assert stats["breaker"]["state"] == "closed"
            assert stats["health_state"] == HealthState.READY
            assert stats["breaker_probe_total"] >= 1
            eng.assert_no_recompiles()
        json.dumps(stats)
        return ([out], (opened["health_state"], opened["breaker"]["state"],
                        sorted(opened["bucket_breakers_not_closed"])),
                (stats["health_state"], stats["breaker"]["state"]),
                counters(stats, BREAKER_COUNTERS))

    out = both(case)
    assert out["port"][1:] == out["jax"][1:]
    assert out["port"][3]["breaker_probe_total"] == 1
    assert_answers_close(out["port"][0], out["jax"][0])


def test_graceful_drain_completes_all_inflight_work():
    """close(drain=True) finishes every admitted request; the engine
    then refuses new ones."""
    models = model_pair()

    def case(p):
        eng = engine(p, models[p.name], auto_start=False,
                     buckets=p.serving.BucketSpec(batch_sizes=(1, 2)),
                     config=p.serving.ServingConfig(max_wait_ms=1.0))
        eng.warmup()
        # the first batch stalls 0.25 s, so close() lands mid-drain
        p.faultinject.arm("serving_slow_batch", at=0, times=1)
        reqs = [eng.submit(_feed(), timeout=30.0) for _ in range(6)]
        eng.start()
        eng.close(drain=True, drain_timeout=20.0)
        outs = [req.result(timeout=1.0) for req in reqs]
        for o in outs:
            assert o[0].shape == (1, 10)
        stats = eng.stats()
        assert stats["responses_total"] == 6
        assert stats["errors_total"] == 0
        assert stats["drained_total"] >= 4     # batches 2..3 ran post-close
        assert stats["health_state"] == p.serving.HealthState.STOPPED
        with pytest.raises(p.serving.ServerClosedError):
            eng.submit(_feed())
        return outs, counters(stats, ("responses_total", "errors_total",
                                      "health_state", "batches_total"))

    out = both(case)
    assert out["port"][1] == out["jax"][1]
    assert_answers_close(out["port"][0], out["jax"][0])


def test_drain_deadline_bounds_a_wedged_shutdown(monkeypatch):
    """A wedged device cannot turn close(drain=True) into a hang: at the
    drain deadline everything still queued gets ServerClosedError and
    close() returns; every request ends with a result or a typed
    error."""
    monkeypatch.setenv("PADDLE_TPU_FAULT_SLOW_S", "0.6")
    models = model_pair()

    def case(p):
        eng = engine(p, models[p.name], auto_start=False,
                     buckets=p.serving.BucketSpec(batch_sizes=(1, 2)),
                     config=p.serving.ServingConfig(max_wait_ms=1.0))
        eng.warmup()
        p.faultinject.arm("serving_slow_batch", at=0, times=3)  # every batch
        reqs = [eng.submit(_feed(), timeout=30.0) for _ in range(6)]
        eng.start()
        t0 = time.monotonic()
        eng.close(drain=True, drain_timeout=0.2)
        closed_in = time.monotonic() - t0
        assert closed_in < 3.0, "drain deadline did not bind"
        served, refused = 0, 0
        for req in reqs:
            try:
                out = req.result(timeout=2.0)
                assert out[0].shape == (1, 10)
                served += 1
            except p.serving.ServerClosedError:
                refused += 1
        assert served + refused == 6           # none lost or hung
        assert refused >= 4                    # the deadline cut in
        assert served >= 1                     # the in-flight batch ended
        return served + refused

    out = both(case)
    assert out["port"] == out["jax"] == 6


def test_watchdog_fails_pending_on_worker_crash_and_restart_recovers():
    """An injected worker crash leaves queued requests with no server:
    the watchdog fails them with WorkerDiedError, health reads DEGRADED,
    and start() serves again."""
    models = model_pair()

    def case(p):
        HealthState = p.serving.HealthState
        cfg = p.serving.ServingConfig(max_wait_ms=1.0,
                                      watchdog_interval_s=0.02)
        eng = engine(p, models[p.name], auto_start=False, config=cfg)
        try:
            eng.warmup()
            req = eng.submit(_feed(), timeout=30.0)
            p.faultinject.arm("serving_worker_crash", at=0, times=1)
            eng.start()                    # the worker dies on iteration 0
            with pytest.raises(p.serving.WorkerDiedError):
                req.result(timeout=5.0)
            died = eng.stats()
            assert died["worker_died_total"] == 1
            assert died["health_state"] == HealthState.DEGRADED
            p.faultinject.disarm()
            eng.start()                    # revive
            revived = eng.stats()["health_state"]
            assert revived == HealthState.READY
            out = eng.infer(_feed(), timeout=10.0)
            assert out[0].shape == (1, 10)
            after = eng.stats()
            assert after["worker_died_total"] == 1   # one event, once
        finally:
            eng.close()
        return ([out], died["health_state"], revived,
                counters(after, ("worker_died_total", "responses_total",
                                 "errors_total")))

    out = both(case)
    assert out["port"][1:] == out["jax"][1:]
    assert_answers_close(out["port"][0], out["jax"][0])


def test_infer_detects_dead_worker_without_watchdog():
    """With the watchdog effectively off, infer() still raises
    WorkerDiedError in polling time, not after the deadline + grace."""
    models = model_pair()

    def case(p):
        cfg = p.serving.ServingConfig(max_wait_ms=1.0,
                                      watchdog_interval_s=60.0,
                                      hang_timeout_s=0.0)
        eng = engine(p, models[p.name], auto_start=False, config=cfg)
        try:
            eng.warmup()
            p.faultinject.arm("serving_worker_crash", at=0, times=1)
            eng.start()
            deadline = time.monotonic() + 2.0
            while eng._worker.is_alive() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not eng._worker.is_alive()
            t0 = time.monotonic()
            with pytest.raises(p.serving.WorkerDiedError) as e:
                eng.infer(_feed(), timeout=30.0)
            assert time.monotonic() - t0 < 5.0, \
                "dead-worker detection waited out the grace bound"
        finally:
            p.faultinject.disarm()
            eng.close()
        return type(e.value).__name__

    out = both(case)
    assert out["port"] == out["jax"] == "WorkerDiedError"


def test_dispatch_retries_never_outlive_the_request_deadline():
    """The batch's tightest request deadline caps the retry loop: under a
    persistent fault the caller gets the typed device error as soon as
    another retry could not finish in time."""
    models = model_pair()

    def case(p):
        policy = p.retry.RetryPolicy(max_attempts=10, initial_backoff=0.2,
                                     multiplier=1.0, max_backoff=0.2)
        cfg = p.serving.ServingConfig(max_wait_ms=1.0, retry_policy=policy)
        with engine(p, models[p.name], config=cfg) as eng:
            eng.warmup()
            p.faultinject.arm("serving_device_error", at=0, times=10)
            t0 = time.monotonic()
            with pytest.raises(p.retry.TransientDeviceError):
                eng.infer(_feed(), timeout=0.3)
            elapsed = time.monotonic() - t0
            stats = eng.stats()
        # the full schedule is ~1.8 s of backoff; the deadline cut it
        assert elapsed < 1.2, f"retries outlived the caller: {elapsed:.2f}s"
        assert stats["retries_total"] <= 2
        assert stats["errors_total"] == 1
        return counters(stats, ("errors_total", "responses_total"))

    out = both(case)
    assert out["port"] == out["jax"]


def test_submit_while_draining_or_stopped_is_refused():
    models = model_pair()

    def case(p):
        with engine(p, models[p.name]) as eng:
            eng.warmup()
            out = eng.infer(_feed(), timeout=10.0)
            assert out[0].shape == (1, 10)
        state = eng.stats()["health_state"]
        assert state == p.serving.HealthState.STOPPED
        with pytest.raises(p.serving.ServerClosedError):
            eng.submit(_feed())
        return [out], state

    out = both(case)
    assert out["port"][1] == out["jax"][1]
    assert_answers_close(out["port"][0], out["jax"][0])


# ---------------------------------------------------------------------------
# the decode engine's serving_device_error point, both packages
# ---------------------------------------------------------------------------

LLAMA_KW = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                ffn_hidden=64, dtype="float32")
DECODE_CONF = dict(max_batch=4, prompt_buckets=(4, 8), max_new_tokens=8,
                   page_size=8, decode_block=4, prefill_batch=2,
                   default_timeout_s=120.0, breaker_threshold=1,
                   breaker_cooldown_s=0.05)
DECODE_COUNTERS = ("retries_total", "errors_total", "breaker_open_total",
                   "breaker_shed_total", "retired_total", "warmup_compiles")


def _llama_scope():
    """The reference's generator startup (tests/test_torch_decode_serving.py
    ``_jax_generator_scope``): its arrays serve both packages."""
    gen_p, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(gen_p, startup):
        ptok = jfluid.layers.data(name="ptok", shape=[1, 6], dtype="int64",
                                  append_batch_size=False)
        jllama.build_llama_generator(jllama.LlamaConfig(**LLAMA_KW), ptok,
                                     max_new_tokens=8)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return scope


def test_decode_engine_device_error_schedule_equals_the_reference():
    """``serving_device_error`` fires inside the decode engine's retried
    dispatch (``decode_engine.py`` ``_maybe_inject_fault``). On the same
    schedule in both packages: two faults under a 3-attempt policy are
    retried on the policy's backoff and the tokens equal an unfaulted
    run's; one fault under a 1-attempt policy fails the request, opens
    the breaker (threshold 1), which sheds the next submit; after the
    cooldown the probe's tokens equal the unfaulted run's. Tokens equal
    the reference's exactly, and so do the counters."""
    jscope = _llama_scope()
    arrays = scope_arrays(jscope)
    prompt = np.arange(1, 6, dtype=np.int64)

    def case(p):
        if p.name == "jax":
            cfg, scope = jllama.LlamaConfig(**LLAMA_KW), jscope
        else:
            cfg = tllama.LlamaConfig(**LLAMA_KW)
            scope = weights.load_state(p.fluid.Scope(), arrays, CPU)
        sleeps = []
        retrying = p.retry.RetryPolicy(max_attempts=3, initial_backoff=0.01,
                                       sleep=sleeps.append)
        eng = p.serving.DecodeEngine(
            cfg, scope=scope, place=p.fluid.CPUPlace(),
            config=p.serving.DecodeConfig(retry_policy=retrying,
                                          **DECODE_CONF))
        try:
            warm = eng.warmup()
            clean = np.asarray(eng.generate(prompt, timeout=60.0))
            p.faultinject.arm("serving_device_error", at=0, times=2)
            retried = np.asarray(eng.generate(prompt, timeout=60.0))
            p.faultinject.disarm()
            assert sleeps == [0.01, 0.02]
            np.testing.assert_array_equal(retried, clean)
            # the breaker: no retries (the worker holds this policy
            # object), one failure opens it
            retrying.max_attempts = 1
            p.faultinject.arm("serving_device_error", at=0, times=1)
            with pytest.raises(p.retry.TransientDeviceError):
                eng.generate(prompt, timeout=60.0)
            p.faultinject.disarm()
            opened = eng.stats()["breaker"]["state"]
            assert opened == "open"
            with pytest.raises(p.serving.ServiceUnavailableError):
                eng.submit(prompt)
            time.sleep(0.06)                   # the cooldown elapses
            probe = np.asarray(eng.generate(prompt, timeout=60.0))
            np.testing.assert_array_equal(probe, clean)
            stats = eng.stats()
            assert stats["breaker"]["state"] == "closed"
            eng.assert_no_recompiles()
        finally:
            eng.close()
        c = counters(stats, DECODE_COUNTERS)
        assert c["retries_total"] == 2 and c["errors_total"] == 1
        assert c["breaker_open_total"] == 1 and c["breaker_shed_total"] == 1
        assert c["warmup_compiles"] == warm["compiles"] > 0
        return clean, sleeps, opened, c

    out = both(case)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1:] == out["jax"][1:]
