"""The fault injector, the retry layer and the Trainer's NaN guard of the
torch port against the JAX package on the CPU
(paddle_tpu_torch/resilience/faultinject.py, retry.py, reader/,
core/executor.py's ``device_error`` point, trainer.py): the cases of
``tests/test_resilience.py:236-423`` and ``:538-640`` run the same
schedule through both packages (``tests/torch_serving_common.py``
``both``; each package's injector armed on its own) and hold the port to
the reference — the firing pattern, the backoff a recording ``sleep``
saw, the error's type and the variable its message names exactly;
answers at ANSWER_TOL; the Trainers' losses from the same initial scope
at the f32 loss tier (rtol 2e-3, tests/test_torch_checkpoint.py's).

Reference test → port case:

- ``test_fault_spec_fires_deterministically`` → ``test_fault_spec_fires_deterministically``
- ``test_env_arming`` → ``test_env_arming``
- ``test_unknown_fault_point_rejected`` → ``test_unknown_fault_point_rejected``
- ``test_with_retries_backoff_schedule`` → ``test_with_retries_backoff_schedule``
- ``test_with_retries_gives_up_and_propagates`` → ``test_with_retries_gives_up_and_propagates``
- ``test_non_transient_never_retried`` → ``test_non_transient_never_retried``
- ``test_transient_classification`` → ``test_transient_classification``;
  the port's own CUDA errors → ``test_cuda_errors_are_not_transient``
  (ROADMAP §3 F23)
- ``test_retry_reader_backoff_schedule_and_recovery``,
  ``test_retry_reader_skip_budget``,
  ``test_retry_reader_budget_exhausted_raises``,
  ``test_retry_reader_dead_generator_poison_surfaces`` → ``test_retry_reader``
  [schedule, skip_budget, budget_exhausted, dead_generator]
- ``test_executor_retries_injected_device_error`` → ``test_executor_retries_injected_device_error``
- ``test_executor_retry_exhaustion_propagates`` → ``test_executor_retry_exhaustion_propagates``
- ``test_device_loader_retries_reader`` → ``tests/test_torch_readers.py``
  ``test_device_loader_retries_reader`` (already held)
- ``test_nan_guard_rolls_back_instead_of_crashing`` → ``test_nan_guard_rolls_back_instead_of_crashing``
  (the port alone also in ``tests/test_torch_checkpoint.py``
  ``test_trainer_test_save_params_and_nan_guard``)
- ``test_nan_guard_budget_exhausted_raises`` → ``test_nan_guard_budget_exhausted_raises``
- ``test_nan_guard_off_by_default`` → ``test_nan_guard_off_by_default``
- ``test_checkpoint_config_env_default`` → ``test_checkpoint_config_env_default``
- ``test_save_vars_names_missing_variable`` → ``test_save_vars_names_missing_variable``
- ``test_save_inference_model_names_missing_variable`` → ``test_save_inference_model_names_missing_variable``
- ``test_io_checkpoint_falls_back_past_corruption`` → ``tests/test_torch_checkpoint.py``
  ``test_io_save_and_load_checkpoint_fall_back_past_corruption`` (already held)
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import weights
from paddle_tpu_torch.resilience import retry as tretry

from torch_serving_common import (CPU, assert_answers_close, both,
                                  disarm_all, to_numpy)

torch.set_num_threads(1)

pytestmark = pytest.mark.resilience

LOSS_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _clean_faults():
    disarm_all()
    yield
    disarm_all()


# ---------------------------------------------------------------------------
# the fault injector
# ---------------------------------------------------------------------------

def test_fault_spec_fires_deterministically():
    def case(p):
        fi = p.faultinject
        fi.arm("device_error", at=2, times=2)
        fired = [fi.fires("device_error") for _ in range(6)]
        assert fired == [False, False, True, True, False, False]
        fi.arm("device_error", at=0)          # re-arming resets the counts
        again = [fi.fires("device_error"), fi.fires("device_error")]
        assert again == [True, False]
        return fired, again

    out = both(case)
    assert out["port"] == out["jax"]


def test_env_arming(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "crash_at_step@5,nan_step@3x2")

    def case(p):
        fi = p.faultinject
        monkeypatch.setattr(fi, "_env_consumed", False)
        crash, nan = fi.armed("crash_at_step"), fi.armed("nan_step")
        got = [(crash.at, crash.times), (nan.at, nan.times)]
        assert got == [(5, 1), (3, 2)]
        fi.disarm()
        assert fi.armed("nan_step") is None
        return got

    out = both(case)
    assert out["port"] == out["jax"]


def test_unknown_fault_point_rejected():
    def case(p):
        with pytest.raises(ValueError, match="unknown fault point") as e:
            p.faultinject.arm("cosmic_ray")
        return type(e.value).__name__, str(e.value)

    out = both(case)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# retry policies
# ---------------------------------------------------------------------------

def test_with_retries_backoff_schedule():
    def case(p):
        sleeps, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise p.retry.TransientDeviceError("UNAVAILABLE: injected")
            return "ok"

        policy = p.retry.RetryPolicy(max_attempts=5, initial_backoff=0.05,
                                     sleep=sleeps.append)
        assert p.retry.with_retries(flaky, policy=policy) == "ok"
        assert sleeps == [0.05, 0.1, 0.2]      # exponential, 2x multiplier
        return sleeps, len(calls)

    out = both(case)
    assert out["port"] == out["jax"]


def test_with_retries_gives_up_and_propagates():
    def case(p):
        calls = []

        def fail():
            calls.append(1)
            raise p.retry.TransientDeviceError("UNAVAILABLE")

        policy = p.retry.RetryPolicy(max_attempts=2, sleep=lambda s: None)
        with pytest.raises(p.retry.TransientDeviceError):
            p.retry.with_retries(fail, policy=policy)
        return len(calls)

    out = both(case)
    assert out["port"] == out["jax"] == 2


def test_non_transient_never_retried():
    def case(p):
        calls = []

        def broken():
            calls.append(1)
            raise ValueError("deterministic bug")

        policy = p.retry.RetryPolicy(max_attempts=5, sleep=lambda s: None)
        with pytest.raises(ValueError):
            p.retry.with_retries(broken, policy=policy)
        assert len(calls) == 1
        return len(calls)

    out = both(case)
    assert out["port"] == out["jax"]


TRANSIENT_CASES = [
    ("TransientDeviceError", "x"),
    ("RuntimeError", "UNAVAILABLE: socket closed"),
    ("OSError", "Connection reset by peer"),
    ("RuntimeError", "RESOURCE_EXHAUSTED: OOM"),
    ("ValueError", "UNAVAILABLE"),
]


def test_transient_classification():
    def case(p):
        types = {"TransientDeviceError": p.retry.TransientDeviceError,
                 "RuntimeError": RuntimeError, "OSError": OSError,
                 "ValueError": ValueError}
        got = [p.retry.is_transient(types[t](m)) for t, m in TRANSIENT_CASES]
        assert got == [True, True, True, False, False]
        return got

    out = both(case)
    assert out["port"] == out["jax"]


# the error texts the port raises on the card, built on the CPU: torch's
# out-of-memory error, torch's accelerator error for sticky CUDA errors
# (as torch words them, before and since its AcceleratorError type), the
# kernel wrappers' launch failure (ops/flash_attention.py ``_launch``),
# and CUDA and NCCL texts that hold one of the reference's transient
# patterns ("unavailable", "aborted")
_CUDA_TAIL = ("\nCUDA kernel errors might be asynchronously reported at "
              "some other API call, so the stacktrace below might be "
              "incorrect.\nFor debugging consider passing "
              "CUDA_LAUNCH_BLOCKING=1\nCompile with `TORCH_USE_CUDA_DSA` to "
              "enable device-side assertions.\n")


def _accelerator_error(msg):
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    return cls(msg)


PORT_ERRORS = {
    "out_of_memory": lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 3.06 GiB is free. Of the allocated "
        "memory 70.12 GiB is allocated by PyTorch, and 1.44 GiB is "
        "reserved by PyTorch but unallocated."),
    "illegal_address": lambda: _accelerator_error(
        "CUDA error: an illegal memory access was encountered\nSearch for "
        "`cudaErrorIllegalAddress' in https://docs.nvidia.com/cuda/"
        "cuda-runtime-api/group__CUDART__TYPES.html for more information."
        + _CUDA_TAIL),
    "illegal_address_runtime_error": lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered" + _CUDA_TAIL),
    "launch_failure": lambda: _accelerator_error(
        "CUDA error: unspecified launch failure" + _CUDA_TAIL),
    "kernel_launch_failed": lambda: RuntimeError(
        "flash_fwd_mma kernel launch failed: CUDA error 700 (bh=128, "
        "tq=256, tk=256, d=128, dtype=torch.bfloat16)"),
    "devices_unavailable": lambda: _accelerator_error(
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable"
        + _CUDA_TAIL),
    "nccl_aborted": lambda: RuntimeError(
        "NCCL communicator was aborted on rank 0."),
}


@pytest.mark.parametrize("name", sorted(PORT_ERRORS))
def test_cuda_errors_are_not_transient(name):
    """No CUDA or NCCL failure of the port is retried: an out-of-memory
    error is deterministic (as the reference's RESOURCE_EXHAUSTED), a
    sticky CUDA error leaves the context dead, and the wrapper's launch
    failure names such an error. The reference's patterns would call the
    last two texts transient (F23); the port's checks them first. A
    TransientDeviceError and the reference's network texts stay
    transient, under the same policy the serving worker retries by."""
    exc = PORT_ERRORS[name]()
    assert isinstance(exc, RuntimeError)
    assert not tretry.is_transient(exc)
    assert not tretry.RetryPolicy().is_retryable(exc)
    if name in ("devices_unavailable", "nccl_aborted"):
        from paddle_tpu.resilience import retry as jretry
        assert jretry.is_transient(RuntimeError(str(exc)))
    for still in (tretry.TransientDeviceError("injected (UNAVAILABLE)"),
                  RuntimeError("UNAVAILABLE: socket closed"),
                  OSError("Connection reset by peer"),
                  RuntimeError("DEADLINE_EXCEEDED: rpc"),
                  ConnectionResetError("broken pipe")):
        assert tretry.is_transient(still), still


# ---------------------------------------------------------------------------
# retry_reader
# ---------------------------------------------------------------------------

class _PoisonedSource:
    """Map-style source: index 2 always raises, but iteration can go on
    past it (decode-after-read)."""

    def __init__(self, n=5, poison=2):
        self.n, self.poison = n, poison

    def __call__(self):
        outer = iter(range(self.n))
        poison = self.poison

        class It:
            def __iter__(self_i):
                return self_i

            def __next__(self_i):
                i = next(outer)
                if i == poison:
                    raise IOError(f"undecodable record {i}")
                return i
        return It()


def _reader_schedule(p):
    p.faultinject.arm("reader_io_error", at=3, times=2)
    sleeps = []
    r = p.fluid.reader.retry_reader(lambda: iter(range(6)), max_attempts=3,
                                    initial_backoff=0.05,
                                    sleep=sleeps.append)
    got = list(r())
    assert got == [0, 1, 2, 3, 4, 5]          # nothing lost
    assert sleeps == [0.05, 0.1]              # two failures, backed off
    return got, sleeps


def _reader_skip_budget(p):
    sleeps = []
    r = p.fluid.reader.retry_reader(_PoisonedSource(), max_attempts=2,
                                    skip_budget=1, sleep=sleeps.append)
    got = list(r())
    assert got == [0, 1, 3, 4]                # the poisoned record skipped
    assert len(sleeps) == 1
    return got, sleeps


def _reader_budget_exhausted(p):
    r = p.fluid.reader.retry_reader(_PoisonedSource(), max_attempts=2,
                                    skip_budget=0, sleep=lambda s: None)
    with pytest.raises(IOError, match="undecodable record 2") as e:
        list(r())
    return type(e.value).__name__, str(e.value)


def _reader_dead_generator(p):
    def source():
        for i in range(5):
            if i == 2:
                raise IOError("generator poison")
            yield i

    r = p.fluid.reader.retry_reader(source, max_attempts=2, skip_budget=3,
                                    sleep=lambda s: None)
    # a plain generator dies where it raises: the original error
    # surfaces, not a silently truncated epoch
    with pytest.raises(IOError, match="generator poison") as e:
        list(r())
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", [_reader_schedule, _reader_skip_budget,
                                  _reader_budget_exhausted,
                                  _reader_dead_generator],
                         ids=["schedule", "skip_budget", "budget_exhausted",
                              "dead_generator"])
def test_retry_reader(case):
    out = both(case)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# retrying execution: the executor's device_error point
# ---------------------------------------------------------------------------

def _tiny_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        y = fluid.layers.fc(x, size=2)
        loss = fluid.layers.mean(y)
    return main, startup, loss


def _tiny_scope(p, state):
    """``_tiny_program``'s main with the reference's startup values."""
    main, startup, loss = _tiny_program(p.fluid)
    if p.name == "jax":
        scope = p.fluid.Scope()
        p.fluid.Executor(p.fluid.CPUPlace()).run(startup, scope=scope)
        state.update({n: np.asarray(scope.find_var(n))
                      for n in scope.keys()})
    else:
        scope = weights.load_state(p.fluid.Scope(), state, CPU)
    return main, loss, scope


def test_executor_retries_injected_device_error():
    """Two injected device errors: the executor's retry policy re-runs
    the step twice (warning each time) and the answer equals the
    reference's."""
    state = {}

    def case(p):
        main, loss, scope = _tiny_scope(p, state)
        sleeps = []
        exe = p.fluid.Executor(p.fluid.CPUPlace(),
                               retry_policy=p.retry.RetryPolicy(
                                   max_attempts=3, sleep=sleeps.append))
        p.faultinject.arm("device_error", times=2)
        with pytest.warns(UserWarning, match="transient device error"):
            out = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                          fetch_list=[loss], scope=scope)
        assert np.isfinite(to_numpy(out[0])).all()
        assert len(sleeps) == 2
        return [out], sleeps

    out = both(case)
    assert out["port"][1] == out["jax"][1]
    assert_answers_close(out["port"][0], out["jax"][0])


def test_executor_retry_exhaustion_propagates():
    state = {}

    def case(p):
        main, loss, scope = _tiny_scope(p, state)
        exe = p.fluid.Executor(p.fluid.CPUPlace(),
                               retry_policy=p.retry.RetryPolicy(
                                   max_attempts=2, sleep=lambda s: None))
        p.faultinject.arm("device_error", times=10)
        with pytest.raises(p.retry.TransientDeviceError) as e:
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[loss], scope=scope)
        spec = p.faultinject.armed("device_error")
        return type(e.value).__name__, spec.fired

    out = both(case)
    assert out["port"] == out["jax"]
    assert out["port"][1] == 2                 # both attempts hit the fault


# ---------------------------------------------------------------------------
# the Trainer's NaN guard
# ---------------------------------------------------------------------------

def _train_func_of(fluid):
    def train_func():
        x = fluid.layers.data("x", shape=[8])
        y = fluid.layers.data("y", shape=[1])
        pred = fluid.layers.fc(x, size=1)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    return train_func


def _reader():
    rng = np.random.RandomState(0)
    w = rng.randn(8, 1).astype(np.float32)
    for _ in range(3):                       # 3 steps an epoch
        x = rng.randn(4, 8).astype(np.float32)
        yield [(x[i], (x[i] @ w).astype(np.float32)) for i in range(4)]


def _trainer(p, d, step_interval, state):
    """The reference test's Trainer (SGD 0.05) in package ``p``; the
    port's starts from the reference's initial parameters."""
    fluid = p.fluid
    t = fluid.Trainer(
        _train_func_of(fluid),
        lambda: fluid.optimizer.SGD(learning_rate=0.05),
        place=fluid.CPUPlace(),
        checkpoint_config=fluid.CheckpointConfig(
            checkpoint_dir=d, step_interval=step_interval))
    if p.name == "jax":
        state.update({n: np.asarray(t.scope.find_var(n))
                      for n in t.scope.keys()})
    else:
        for n, v in state.items():
            t.scope.set(n, weights.array_to_tensor(v, CPU))
    return t


def _lr(p, t):
    lr = [to_numpy(t.scope.find_var(n)) for n in t.scope.keys()
          if n.startswith("learning_rate")]
    return float(np.ravel(lr[0])[0]) if lr else None


def test_nan_guard_rolls_back_instead_of_crashing(tmp_path, monkeypatch):
    """A NaN-injected step rolls back to the last good checkpoint and
    halves the rate; training finishes. The steps seen, the rate and the
    losses equal the reference's."""
    monkeypatch.setenv("PADDLE_TPU_NAN_GUARD", "1")
    state = {}

    def case(p):
        t = _trainer(p, str(tmp_path / p.name), 2, state)
        p.faultinject.arm("nan_step", at=4)    # poison the 5th step's loss
        seen = {}

        def handler(event):
            if isinstance(event, p.fluid.EndStepEvent):
                loss = float(np.ravel(to_numpy(event.metrics[0]))[0])
                assert np.isfinite(loss)
                seen[(event.epoch, event.step)] = loss

        with pytest.warns(UserWarning, match="rolled back to checkpoint"):
            t.train(num_epochs=3, event_handler=handler, reader=_reader)
        assert (1, 1) not in seen              # the poisoned step
        assert (2, 2) in seen                  # ran to completion
        lr = _lr(p, t)
        assert lr == pytest.approx(0.025)
        return seen, lr

    out = both(case)
    (jseen, jlr), (tseen, tlr) = out["jax"], out["port"]
    assert sorted(tseen) == sorted(jseen) and tlr == jlr
    for k in jseen:
        np.testing.assert_allclose(tseen[k], jseen[k], rtol=LOSS_RTOL)


def test_nan_guard_budget_exhausted_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_NAN_GUARD", "1")
    monkeypatch.setenv("PADDLE_TPU_NAN_MAX_ROLLBACKS", "1")
    state = {}

    def case(p):
        t = _trainer(p, str(tmp_path / p.name), 2, state)
        p.faultinject.arm("nan_step", times=10)   # every step diverges
        with pytest.raises(FloatingPointError, match="after 1 rollback") \
                as e:
            with pytest.warns(UserWarning):
                t.train(num_epochs=2, event_handler=lambda e: None,
                        reader=_reader)
        return type(e.value).__name__, str(e.value)

    out = both(case)
    assert out["port"] == out["jax"]


def test_nan_guard_off_by_default(tmp_path):
    state = {}

    def case(p):
        t = _trainer(p, str(tmp_path / p.name), 100, state)
        p.faultinject.arm("nan_step", at=1, times=1)
        nan_steps = []

        def handler(event):
            if isinstance(event, p.fluid.EndStepEvent):
                if not np.isfinite(np.ravel(to_numpy(
                        event.metrics[0]))).all():
                    nan_steps.append(event.step)

        t.train(num_epochs=1, event_handler=handler, reader=_reader)
        assert nan_steps == [1]    # surfaced to the handler, no rollback
        return nan_steps

    out = both(case)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# configuration defaults and io error messages
# ---------------------------------------------------------------------------

def test_checkpoint_config_env_default(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHECKPOINT_DIR", str(tmp_path / "env"))

    def case(p):
        from_env = p.fluid.CheckpointConfig().checkpoint_dir
        assert from_env == str(tmp_path / "env")
        given = p.fluid.CheckpointConfig(
            checkpoint_dir=str(tmp_path / "x")).checkpoint_dir
        assert given == str(tmp_path / "x")        # an explicit dir wins
        return from_env, given

    out = both(case)
    assert out["port"] == out["jax"]


def test_save_vars_names_missing_variable(tmp_path):
    def case(p):
        fluid = p.fluid
        main, startup, _ = _tiny_program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            with pytest.raises(ValueError, match="no_such_var") as e:
                fluid.io.save_vars(exe, str(tmp_path / p.name),
                                   main_program=main, vars=["no_such_var"])
        return type(e.value).__name__, str(e.value)

    out = both(case)
    assert out["port"] == out["jax"]


def test_save_inference_model_names_missing_variable(tmp_path):
    def case(p):
        fluid = p.fluid
        main, startup, loss = _tiny_program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            with pytest.raises(ValueError, match="not_a_feed") as e:
                fluid.io.save_inference_model(
                    str(tmp_path / p.name / "m"), ["not_a_feed"], [loss],
                    exe, main_program=main)
            # deep parent directories are created, not stumbled over
            deep = str(tmp_path / p.name / "a" / "b" / "c")
            fluid.io.save_inference_model(deep, ["x"], [loss], exe,
                                          main_program=main)
        assert os.path.exists(os.path.join(deep, "__model__.json"))
        return type(e.value).__name__, str(e.value)

    out = both(case)
    assert out["port"] == out["jax"]
