"""The crash-safe checkpoint store and the Trainer of the torch port
(paddle_tpu_torch/resilience/checkpoint.py, trainer.py) against the JAX
package.

The store's cases are tests/test_resilience.py's, run with numpy and
with torch values; checkpoint directories cross between the packages in
both directions, bfloat16 included (the file bytes are the same). The
Trainer's kill-and-resume (tests/test_trainer_resume.py,
tests/test_resilience.py) holds the resumed run to the uninterrupted one
bit for bit — with dropout, because the checkpoint carries the step
counter that seeds each step's draws — and, with dropout 0, its losses
to the reference Trainer's from the same initial scope at the f32 loss
tier (rtol 2e-3, tests/test_torch_transformer.py's).
"""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.resilience import checkpoint as jckpt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.resilience import checkpoint as ckpt
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.resilience import ChecksumMismatch, SimulatedCrash

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOSS_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.disarm()
    yield
    faultinject.disarm()


def _flip_last_byte(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def _state(seed=0, kind="numpy"):
    rng = np.random.RandomState(seed)
    st = {"fc_0.w_0": rng.randn(4, 3).astype(np.float32),
          "fc_0.b_0": rng.randn(3).astype(np.float32),
          "nested/name": np.arange(5, dtype=np.int64)}
    if kind == "torch":
        st = {k: torch.from_numpy(v) for k, v in st.items()}
    return st


def _equal(got, want):
    got = weights.to_host(got) if isinstance(got, torch.Tensor) else got
    want = weights.to_host(want) if isinstance(want, torch.Tensor) else want
    return got.dtype == want.dtype and np.array_equal(got, want)


KINDS = ["numpy", "torch"]


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_and_manifest(tmp_path, kind):
    d = str(tmp_path)
    path = ckpt.save_state(d, _state(0, kind), serial=7,
                           meta={"epoch_id": 3})
    assert os.path.basename(path) == "ckpt_7"
    manifest = ckpt.verify(path)
    assert manifest["format"] == ckpt.FORMAT == jckpt.FORMAT
    assert manifest["serial"] == 7 and manifest["meta"]["epoch_id"] == 3
    for spec in manifest["arrays"].values():
        assert set(spec) >= {"file", "sha256", "shape", "dtype", "bytes"}
    state, _, serial, _ = ckpt.load_latest_valid(d)
    assert serial == 7
    assert all(_equal(state[k], v) for k, v in _state(0).items())
    tstate, _, _, _ = ckpt.load_latest_valid(d, device=CPU)
    assert all(isinstance(v, torch.Tensor) for v in tstate.values())
    assert all(_equal(tstate[k], v) for k, v in _state(0).items())


def test_empty_and_missing_dirs_are_no_checkpoints(tmp_path):
    assert ckpt.list_serials(str(tmp_path / "nonexistent")) == []
    assert ckpt.list_serials(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError):
        ckpt.load_latest_valid(str(tmp_path))


@pytest.mark.parametrize("kind", KINDS)
def test_torn_write_leaves_previous_serial_valid(tmp_path, monkeypatch,
                                                 kind):
    d = str(tmp_path)
    ckpt.save_state(d, _state(0, kind), serial=1)
    faultinject.arm("torn_write")
    with pytest.raises(SimulatedCrash):
        ckpt.save_state(d, _state(1, kind), serial=2)
    temps = [e for e in os.listdir(d) if e.startswith(".tmp_ckpt_")]
    assert temps and not os.path.exists(os.path.join(d, "ckpt_2"))
    assert ckpt.list_serials(d) == [1]
    state, _, serial, _ = ckpt.load_latest_valid(d)
    assert serial == 1 and _equal(state["fc_0.w_0"], _state(0)["fc_0.w_0"])
    monkeypatch.setattr(ckpt, "TMP_GRACE_SECONDS", 0)
    ckpt.prune(d, keep=3)
    assert not [e for e in os.listdir(d) if e.startswith(".tmp_ckpt_")]


def test_checksum_mismatch_quarantined_with_fallback(tmp_path):
    d = str(tmp_path)
    ckpt.save_state(d, _state(0, "torch"), serial=1)
    ckpt.save_state(d, _state(1, "torch"), serial=2)
    manifest = ckpt.verify(os.path.join(d, "ckpt_2"))
    _flip_last_byte(os.path.join(d, "ckpt_2",
                                 manifest["arrays"]["fc_0.w_0"]["file"]))
    with pytest.raises(ChecksumMismatch):
        ckpt.verify(os.path.join(d, "ckpt_2"))
    with pytest.warns(UserWarning, match="damaged checkpoint serial 2"):
        state, _, serial, _ = ckpt.load_latest_valid(d, device=CPU)
    assert serial == 1 and _equal(state["fc_0.b_0"], _state(0)["fc_0.b_0"])
    assert os.path.isdir(os.path.join(d, "quarantine", "ckpt_2"))
    assert ckpt.list_serials(d) == [1]


def test_manifestless_dir_is_invisible(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "ckpt_9"))
    assert ckpt.list_serials(d) == []
    ckpt.save_state(d, _state(), serial=3)
    assert ckpt.load_latest_valid(d)[2] == 3


def test_retention_prune_and_followers(tmp_path, monkeypatch):
    d = str(tmp_path / "keep")
    for s in range(1, 6):
        ckpt.save_state(d, _state(s), serial=s, max_num_checkpoints=2)
    assert ckpt.list_serials(d) == [4, 5]
    f = str(tmp_path / "followers")
    for s in range(1, 5):
        ckpt.save_state(f, _state(s), serial=s, max_num_checkpoints=1,
                        leader=False)
    assert ckpt.list_serials(f) == [1, 2, 3, 4]
    ckpt.save_state(f, _state(5), serial=5, max_num_checkpoints=2)
    assert ckpt.list_serials(f) == [4, 5]
    e = str(tmp_path / "env")
    monkeypatch.setenv("PADDLE_TPU_CKPT_KEEP", "2")
    for s in range(1, 5):
        ckpt.save_state(e, _state(s), serial=s)
    assert ckpt.list_serials(e) == [3, 4]
    ckpt.save_state(e, _state(5), serial=5, max_num_checkpoints=3)
    assert ckpt.list_serials(e) == [3, 4, 5]
    monkeypatch.setenv("PADDLE_TPU_CKPT_KEEP", "0")
    ckpt.save_state(e, _state(6), serial=6)
    assert ckpt.list_serials(e) == [3, 4, 5, 6]
    assert ckpt.retention_keep(5) == 5 and ckpt.retention_keep(0) is None


def test_concurrent_savers_never_reap_inflight(tmp_path):
    d = str(tmp_path)
    errors = []

    def saver(serials):
        try:
            for s in serials:
                ckpt.save_state(d, _state(s, "torch"), serial=s,
                                max_num_checkpoints=1)
        except Exception as exc:    # noqa: BLE001 — surfaced below
            errors.append(exc)

    t1 = threading.Thread(target=saver, args=(range(1, 20, 2),))
    t2 = threading.Thread(target=saver, args=(range(2, 21, 2),))
    t1.start(); t2.start(); t1.join(); t2.join()          # noqa: E702
    assert not errors, errors
    assert not [e for e in os.listdir(d) if e.startswith(".tmp_ckpt_")]
    for s in ckpt.list_serials(d):
        ckpt.verify(os.path.join(d, f"ckpt_{s}"))
    state, _, serial, _ = ckpt.load_latest_valid(d)
    assert serial == 20 and _equal(state["fc_0.w_0"],
                                   _state(20)["fc_0.w_0"])


def test_prune_spares_foreign_young_temp(tmp_path, monkeypatch):
    d = str(tmp_path)
    foreign = os.path.join(d, ".tmp_ckpt_5_deadbeef")
    os.makedirs(foreign)
    ckpt.save_state(d, _state(1), serial=1, max_num_checkpoints=1)
    assert os.path.isdir(foreign)
    monkeypatch.setattr(ckpt, "TMP_GRACE_SECONDS", 0)
    ckpt.prune(d, keep=1)
    assert not os.path.isdir(foreign)


def test_state_sha_equals_the_reference():
    """The fleet's determinism probe gives the reference's hex for the
    same numpy state, and the same hex for its tensors."""
    a = _state(3)
    assert ckpt.state_sha(a) == jckpt.state_sha(a)
    assert ckpt.state_sha(_state(3, "torch")) == jckpt.state_sha(a)
    b = dict(reversed(list(a.items())))
    assert ckpt.state_sha(b) == ckpt.state_sha(a)
    c = {k: v.copy() for k, v in a.items()}
    c["fc_0.w_0"][0, 0] += 1
    assert ckpt.state_sha(c) != ckpt.state_sha(a)


def _bf16_state():
    import ml_dtypes
    st = _state(4)
    st["bf"] = np.random.RandomState(5).randn(3, 2).astype(
        ml_dtypes.bfloat16)
    return st


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_both_ways_bf16_included(tmp_path, direction):
    """A checkpoint directory written by one package loads in the other:
    same manifest (sha256 included), same file bytes, every value equal
    — a bfloat16 array comes back in the port as a torch.bfloat16 tensor
    by the manifest's dtype."""
    want = _bf16_state()
    d = str(tmp_path)
    if direction == "jax_to_port":
        jckpt.save_state(d, want, serial=1, meta={"step": 4})
        state, manifest, _, _ = ckpt.load_latest_valid(d, device=CPU)
        assert state["bf"].dtype == torch.bfloat16
        for k, v in want.items():
            got = state[k]
            if k == "bf":
                assert np.array_equal(
                    weights.tensor_to_array(got).astype(np.float32),
                    v.astype(np.float32))
            else:
                assert _equal(got, v), k
    else:
        tstate = {k: weights.array_to_tensor(v, CPU)
                  for k, v in want.items()}
        ckpt.save_state(d, tstate, serial=1, meta={"step": 4})
        state, manifest, _, _ = jckpt.load_latest_valid(d)
        for k, v in want.items():
            assert state[k].tobytes() == np.asarray(v).tobytes(), k
    assert manifest["meta"] == {"step": 4}
    assert manifest["arrays"]["bf"]["dtype"] == "bfloat16"
    # byte for byte the other package's own checkpoint of the same state
    other = str(tmp_path / "other")
    if direction == "jax_to_port":
        ckpt.save_state(other, {k: weights.array_to_tensor(v, CPU)
                                for k, v in want.items()}, serial=1,
                        meta={"step": 4})
    else:
        jckpt.save_state(other, want, serial=1, meta={"step": 4})
    m1 = ckpt.verify(os.path.join(d, "ckpt_1"))
    m2 = ckpt.verify(os.path.join(other, "ckpt_1"))
    assert m1["arrays"] == m2["arrays"]


def test_io_save_and_load_checkpoint_fall_back_past_corruption(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=2))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": np.ones((2, 4), np.float32)}
    d = str(tmp_path / "ck")
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        tfluid.io.save_checkpoint(exe, d, step=1, main_program=main)
        pname = main.all_parameters()[0].name
        good = weights.tensor_to_array(
            tfluid.global_scope().find_var(pname))
        exe.run(main, feed=feed, fetch_list=[loss])
        tfluid.io.save_checkpoint(exe, d, step=2, main_program=main)
        manifest = ckpt.verify(os.path.join(d, "ckpt_2"))
        with open(os.path.join(d, "ckpt_2",
                               manifest["arrays"][pname]["file"]),
                  "r+b") as f:
            f.seek(-1, os.SEEK_END)
            f.write(b"\x00")
        with pytest.warns(UserWarning, match="damaged checkpoint serial 2"):
            path = tfluid.io.load_checkpoint(exe, d)
        assert path.endswith("ckpt_1")
        got = tfluid.global_scope().find_var(pname)
        assert isinstance(got, torch.Tensor)
        assert np.array_equal(weights.tensor_to_array(got), good)


# ---------------------------------------------------------------------------
# Trainer: kill, resume, the reference's losses
# ---------------------------------------------------------------------------


def _train_func_of(fluid, dropout):
    def train_func():
        x = fluid.layers.data("x", shape=[8])
        y = fluid.layers.data("y", shape=[1])
        h = fluid.layers.fc(x, size=16, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        pred = fluid.layers.fc(h, size=1)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    return train_func


def _opt_func_of(fluid):
    return lambda: fluid.optimizer.Adam(learning_rate=0.01)


def _reader():
    rng = np.random.RandomState(0)
    w = rng.randn(8, 1).astype(np.float32)
    for _ in range(3):                       # 3 steps per epoch
        x = rng.randn(4, 8).astype(np.float32)
        yield [(x[i], (x[i] @ w).astype(np.float32)) for i in range(4)]


def _trainer(fluid, d, dropout, **cfg_kw):
    cfg = fluid.CheckpointConfig(checkpoint_dir=d, step_interval=100,
                                 **cfg_kw)
    return fluid.Trainer(_train_func_of(fluid, dropout),
                         _opt_func_of(fluid), place=fluid.CPUPlace(),
                         checkpoint_config=cfg), cfg


def _losses(trainer, num_epochs, fluid=tfluid):
    out = {}

    def handler(event):
        if isinstance(event, fluid.EndStepEvent):
            out[(event.epoch, event.step)] = float(
                np.ravel(event.metrics[0])[0])
    trainer.train(num_epochs=num_epochs, event_handler=handler,
                  reader=_reader)
    return out


def test_kill_mid_checkpoint_resumes_bit_for_bit_with_dropout(tmp_path):
    """The torn_write fault kills the second (epoch-1-end) checkpoint
    write; a fresh Trainer resumes from the epoch-0-end serial, and its
    losses and final persistables equal an uninterrupted run's exactly —
    the dropout masks after the resume included, because the checkpoint
    restores the executor's step counter."""
    control, _ = _trainer(tfluid, str(tmp_path / "control"), 0.3)
    control_losses = _losses(control, 3)
    d = str(tmp_path / "victim")
    victim, _ = _trainer(tfluid, d, 0.3)
    faultinject.arm("torn_write", at=1)
    with pytest.raises(SimulatedCrash):
        _losses(victim, 3)
    faultinject.disarm()
    assert ckpt.list_serials(d) == [1]
    assert [e for e in os.listdir(d) if e.startswith(".tmp_ckpt_")]
    import shutil
    shutil.copytree(d, str(tmp_path / "victim_copy"))
    resumed, cfg = _trainer(tfluid, d, 0.3)
    assert cfg.epoch_id == 1
    got = _losses(resumed, 3)
    assert set(got) == {(e, s) for e in (1, 2) for s in range(3)}
    assert all(got[k] == control_losses[k] for k in got)
    for n in control.scope.keys():
        assert torch.equal(resumed.scope.find_var(n),
                           control.scope.find_var(n)), n
    assert resumed.exe._step == control.exe._step
    # without the restored counter the masks, hence the losses, differ
    again, _ = _trainer(tfluid, str(tmp_path / "victim_copy"), 0.3)
    again.exe._step = 1
    assert _losses(again, 3)[(1, 0)] != control_losses[(1, 0)]


def test_resume_after_crash_during_first_save(tmp_path):
    d = str(tmp_path / "first")
    victim, _ = _trainer(tfluid, d, 0.0)
    victim._checkpoint_cfg.step_interval = 2
    faultinject.arm("torn_write", at=0)
    with pytest.raises(SimulatedCrash):
        _losses(victim, 2)
    faultinject.disarm()
    assert ckpt.list_serials(d) == []
    fresh, cfg = _trainer(tfluid, d, 0.0)
    assert cfg.epoch_id == 0
    assert len(_losses(fresh, 1)) == 3


def test_trainer_losses_equal_the_reference_trainer(tmp_path):
    """Dropout 0, the same initial scope (the JAX Trainer's startup
    values carried into the port's Trainer): the port's losses over two
    epochs, a checkpoint and a resume equal the reference Trainer's at
    the f32 loss tier; the reference resumes the port's checkpoint
    directory."""
    jt, _ = _trainer(jfluid, str(tmp_path / "j"), 0.0)
    tt, _ = _trainer(tfluid, str(tmp_path / "t"), 0.0)
    for n in jt.scope.keys():
        tt.scope.set(n, weights.array_to_tensor(
            np.asarray(jt.scope.find_var(n)), CPU))
    want = _losses(jt, 2, jfluid)
    got = _losses(tt, 2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL)
    # the reference Trainer resumes from the port's checkpoints
    jr, jcfg = _trainer(jfluid, str(tmp_path / "t"), 0.0)
    assert jcfg.epoch_id == 2
    for n in tt.scope.keys():
        assert np.array_equal(np.asarray(jr.scope.find_var(n)),
                              weights.tensor_to_array(tt.scope.find_var(n)))


def test_trainer_test_save_params_and_nan_guard(tmp_path, monkeypatch):
    """``test`` averages the outputs over a reader with the test clone;
    ``save_params`` writes persistables the JAX package loads; the
    PADDLE_TPU_NAN_GUARD sentinel rolls back to the last checkpoint and
    halves the learning rate instead of crashing."""
    t, _ = _trainer(tfluid, str(tmp_path / "ck"), 0.0)
    avg = t.test(_reader)
    assert len(avg) == 1 and np.isfinite(avg[0])
    p = str(tmp_path / "params")
    t.save_params(p)
    jm = jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jm,
                                                          jfluid.Program()):
        _train_func_of(jfluid, 0.0)()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.io.load_params(jfluid.Executor(jfluid.CPUPlace()), p,
                              main_program=jm)
    for n in jscope.keys():
        assert np.array_equal(np.asarray(jscope.find_var(n)),
                              weights.tensor_to_array(t.scope.find_var(n)))
    monkeypatch.setenv("PADDLE_TPU_NAN_GUARD", "1")
    g, _ = _trainer(tfluid, str(tmp_path / "nan"), 0.0)
    g._checkpoint_cfg.step_interval = 2
    faultinject.arm("nan_step", at=4)
    seen = []

    def handler(event):
        if isinstance(event, tfluid.EndStepEvent):
            seen.append((event.epoch, event.step))

    with pytest.warns(UserWarning, match="rolled back to checkpoint"):
        g.train(num_epochs=3, event_handler=handler, reader=_reader)
    assert (1, 1) not in seen and (2, 2) in seen
    lr = [g.scope.find_var(n) for n in g.scope.keys()
          if n.startswith("learning_rate")]
    assert lr and float(lr[0].reshape(-1)[0]) == pytest.approx(0.005)
