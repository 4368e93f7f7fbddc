"""Elastic fault-tolerant training fabric, the torch port on the CPU:
the cases of tests/test_train_fabric.py run on the port
(cluster/train_fabric.py, cluster/train_worker.py), and the port is
held against the JAX package: ``LinRegTask`` steps (pure numpy) and a
whole fabric run's committed (serial, sha) sequence are bit-equal to
the reference's, and ``ProgramGradTask`` gradient sums on the same
state and shard agree within f32 2e-4 / 2e-5.

What is pinned here:

* **determinism is world-size invariant** — fixed logical shards,
  shard-index-order reduction: the committed (serial, sha) sequence is
  bit-identical at world size 1 and 2;
* **every failure mode is typed and recoverable** — a worker crash
  mid-step, a straggler past the deadline, and a vanished RPC route
  each evict the worker, the step retries at reduced world size, and
  NO committed step is lost; a healed partition rejoins;
* **the commit barrier is leader-writes / followers-verify**;
* **coordinator crash** — a NEW coordinator over the same checkpoint
  dir resumes from the last committed serial to sha parity;
* **the program tier provisions over the wire** — by the port's rule
  (ROADMAP.md §3 F6) the store holds no train step, so a replacement
  builds its one gradient step;
* **ops plane** — per-worker rows and namespaced metrics.

All CPU (``_host`` makes the host the default place), all loopback
sockets. The card's run is chip_smoke.py's ``train_fabric`` phase.
"""
import tempfile
import time

import numpy as np
import pytest
import torch

from paddle_tpu.cluster import train_fabric as jfab
from paddle_tpu.cluster import train_worker as jworker

from paddle_tpu_torch.cluster.net import RemoteUnavailableError
from paddle_tpu_torch.cluster.train_fabric import (LinRegTask,
                                             NoTrainWorkersError,
                                             ProgramGradTask,
                                             TrainCoordinator,
                                             TrainTaskError,
                                             WorkerClient,
                                             task_from_spec)
from paddle_tpu_torch.cluster.train_worker import TrainWorkerServer
from paddle_tpu_torch.core.executor import CPUPlace
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.resilience.checkpoint import state_sha
from paddle_tpu_torch.resilience.faultinject import SimulatedCrash
from paddle_tpu_torch.serving.health import ServiceUnavailableError

torch.set_num_threads(1)

pytestmark = pytest.mark.cluster


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    """The process's default place is the host: a program task's worker
    computes on the CPU (the card is chip_smoke.py's train_fabric)."""
    from paddle_tpu_torch.core import executor
    monkeypatch.setattr(executor, "_FORCED_CPU", True)


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.disarm()
    yield
    faultinject.disarm()


def _fleet(tmp_path, n=2, seed=5, **kw):
    workers = [TrainWorkerServer() for _ in range(n)]
    kw.setdefault("step_deadline_s", 5.0)
    kw.setdefault("admit_deadline_s", 2.0)
    kw.setdefault("readmit_interval_s", 0.05)
    co = TrainCoordinator(LinRegTask(seed=seed),
                          [w.addr for w in workers],
                          str(tmp_path / "ckpts"),
                          commit_interval=5, n_shards=4, **kw)
    return co, workers


def _teardown(co, workers):
    co.close()
    for w in workers:
        w.close()


def _baseline(seed=5, steps=10):
    """Single-worker run: the sha/loss parity target for every drill."""
    d = tempfile.mkdtemp(prefix="trainfab_base_")
    w = TrainWorkerServer()
    co = TrainCoordinator(LinRegTask(seed=seed), [w.addr], d,
                          commit_interval=5, n_shards=4)
    co.run(steps)
    commits, losses = co.commits(), co.losses()
    _teardown(co, [w])
    return commits, losses


# ---------------------------------------------------------------------------
# task specs
# ---------------------------------------------------------------------------


def test_task_spec_roundtrip_and_typed_refusals():
    task = LinRegTask(dim=6, rows_per_shard=3, lr=0.2, seed=9)
    clone = task_from_spec(task.spec())
    assert isinstance(clone, LinRegTask)
    assert clone.spec() == task.spec()
    prog = task_from_spec(ProgramGradTask(seed=2).spec(),
                          artifact_dir="/tmp/nowhere")
    assert isinstance(prog, ProgramGradTask)
    assert prog.artifact_dir == "/tmp/nowhere"   # host-local, not wire
    with pytest.raises(TrainTaskError):
        task_from_spec({"no": "kind"})
    with pytest.raises(TrainTaskError):
        task_from_spec({"kind": "warp-drive"})
    with pytest.raises(TrainTaskError):
        task_from_spec(None)


def test_linreg_task_grad_sums_are_deterministic():
    t = LinRegTask(seed=3)
    s = t.init_state()
    a = t.grad_sums(s, step=4, shard=2, n_shards=4)
    b = t.grad_sums(s, step=4, shard=2, n_shards=4)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1]["w"], b[1]["w"])
    # different shard / step → different data
    c = t.grad_sums(s, step=4, shard=3, n_shards=4)
    assert a[0] != c[0]


# ---------------------------------------------------------------------------
# determinism + elasticity
# ---------------------------------------------------------------------------


def test_commits_are_world_size_invariant(tmp_path):
    base, base_losses = _baseline()
    co, ws = _fleet(tmp_path, n=2)
    co.run(10)
    assert co.commits() == base
    assert co.losses() == pytest.approx(base_losses)
    _teardown(co, ws)


def test_shard_assignment_is_deterministic_round_robin(tmp_path):
    co, ws = _fleet(tmp_path, n=2)
    co.run(1)                           # admission happens lazily
    live = co.live_workers()
    assert len(live) == 2
    assignment = co._assignment(live)
    flat = sorted(s for shards in assignment.values() for s in shards)
    assert flat == list(range(co.n_shards))
    # name-sorted order, round-robin: worker order is by name, not by
    # admit order, so reconnection order can never change the split
    names = sorted(c.name for c in live)
    by_name = {c.name: shards for c, shards in assignment.items()}
    assert by_name[names[0]] == [0, 2]
    assert by_name[names[1]] == [1, 3]
    _teardown(co, ws)


def test_worker_crash_evicts_retries_and_loses_nothing(tmp_path):
    base, _ = _baseline()
    co, ws = _fleet(tmp_path, n=2)
    co.run(2)
    faultinject.arm("trainer_crash_at_step", at=0)
    co.run(8)
    assert co.commits() == base, "a committed step was lost"
    assert co.evictions_total == 1
    events = co.events()
    assert [e["kind"] for e in events] == ["evicted"]
    assert events[0]["step"] > 2
    _teardown(co, ws)


def test_straggler_evicted_at_deadline(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_STRAGGLE_S", "2.0")
    base, _ = _baseline()
    co, ws = _fleet(tmp_path, n=2, step_deadline_s=0.3)
    co.run(2)
    faultinject.arm("trainer_straggle", at=0)
    t0 = time.monotonic()
    co.run(8)
    wall = time.monotonic() - t0
    assert co.commits() == base
    assert co.evictions_total == 1
    assert wall < 2.0, (
        f"coordinator waited {wall:.1f}s — the straggler deadline "
        "did not cut the stall short")
    _teardown(co, ws)


def test_partition_typed_evict_then_rejoin(tmp_path):
    base, _ = _baseline()
    co, ws = _fleet(tmp_path, n=2)
    co.run(2)
    faultinject.arm("train_net_partition", at=0, times=2)
    co.run(8)
    assert co.commits() == base
    assert co.evictions_total >= 1
    assert co.rejoins_total >= 1, "healed partition never rejoined"
    assert co.last_recover_s is not None and co.last_recover_s >= 0
    reasons = [e["reason"] for e in co.events()
               if e["kind"] == "evicted"]
    assert any("RemoteUnavailableError" in r for r in reasons), reasons
    _teardown(co, ws)


def test_all_workers_gone_is_typed_unavailable(tmp_path):
    co, ws = _fleet(tmp_path, n=1, admit_deadline_s=0.3,
                    step_deadline_s=0.5)
    co.run(1)
    ws[0].close()
    with pytest.raises(NoTrainWorkersError) as ei:
        co.run(3)
    assert isinstance(ei.value, ServiceUnavailableError)
    _teardown(co, ws)


def test_late_replacement_worker_catches_up(tmp_path):
    """Elastic up: a worker admitted mid-run receives the task and the
    last committed state, then serves shards for subsequent steps."""
    base, _ = _baseline()
    co, ws = _fleet(tmp_path, n=1)
    co.run(6)
    w2 = TrainWorkerServer()
    co.admit(w2.addr)
    co.run(4)
    assert co.commits() == base
    assert w2.last_step == 10
    assert w2.committed_step == 10      # verified the commit barrier
    _teardown(co, ws + [w2])


# ---------------------------------------------------------------------------
# commit barrier
# ---------------------------------------------------------------------------


def test_followers_verify_and_refuse_wrong_sha(tmp_path):
    w = TrainWorkerServer()
    client = WorkerClient(w.addr)
    state = {"w": np.arange(4, dtype=np.float32)}
    good = client.commit(3, state, state_sha(state))
    assert good["ok"] is True
    assert w.committed_step == 3
    bad = client.commit(4, state, "0" * 64)
    assert bad["ok"] is False
    assert bad["sha"] == state_sha(state)   # reports what IT computed
    assert w.committed_step == 3            # refused commit not taken
    assert w.stats()["commit_mismatches_total"] == 1
    client.close()
    w.close()


def test_coordinator_crash_parks_workers_resume_sha_parity(tmp_path):
    base, _ = _baseline()
    co, ws = _fleet(tmp_path, n=2)
    co.run(5)
    faultinject.arm("coordinator_crash", at=1)
    with pytest.raises(SimulatedCrash):
        co.run(5)
    faultinject.disarm()
    assert co.step == 6                 # one step ran, then the crash
    co.close()                          # the process is "gone"
    # workers are parked: alive, counting coordinator silence
    for w in ws:
        assert w.coordinator_age_s() >= 0
    co2 = TrainCoordinator(LinRegTask(seed=5),
                           [w.addr for w in ws],
                           str(tmp_path / "ckpts"),
                           commit_interval=5, n_shards=4)
    assert co2.step == 5                # resumed at last COMMITTED
    co2.run(5)
    assert co2.commits()[-1] == base[-1]
    _teardown(co2, ws)


def test_resume_discards_uncommitted_tail_bit_deterministically(
        tmp_path):
    """Kill between commits: steps past the last barrier are recomputed
    on resume and land on the SAME bits (the headline guarantee)."""
    base, _ = _baseline(steps=20)
    co, ws = _fleet(tmp_path, n=2)
    co.run(13)                          # 3 steps past the serial-10
    co.close()                          # barrier die uncommitted
    co2, _ = _fleet(tmp_path, n=0)
    co2._clients = []                   # reuse dir; fresh workers below
    for w in ws:
        co2.admit(w.addr)
    assert co2.step == 10
    co2.run(10)
    # co2's first recorded commit is the resumed serial-10 one
    assert co2.commits() == base[1:], (co2.commits(), base)
    _teardown(co2, ws)


# ---------------------------------------------------------------------------
# ops plane
# ---------------------------------------------------------------------------


def test_stats_worker_rows_and_namespaced_metrics(tmp_path):
    co, ws = _fleet(tmp_path, n=2)
    co.run(6)
    co.membership.refresh_once()        # one heartbeat sweep caches
    snap = co.stats()                   # each worker's remote stats
    assert snap["step"] == 6
    assert snap["committed_step"] == 5
    assert snap["world_size"] == 2
    assert len(snap["workers"]) == 2
    for row in snap["workers"]:
        assert row["admitted"] is True
        assert row["last_step"] == 6
        assert row["step_time_p50_ms"] is not None
        assert row["heartbeat_age_s"] is not None
        assert row["evictions"] == 0 and row["rejoins"] == 0
        # the remote worker's own stats ride along (heartbeat payload)
        assert row["remote"].get("steps_total", 0) > 0
    # merged metrics: per-worker namespaces, no collisions
    names = [row["name"] for row in snap["workers"]]
    for name in names:
        assert snap["metrics"][f"{name}/train_steps_total"] > 0
        assert f"{name}/step_time_s" in snap["metrics"]
    assert snap["membership"]["members"] == 2
    _teardown(co, ws)


def test_membership_heartbeat_counts_eviction_and_rejoin(tmp_path):
    co, ws = _fleet(tmp_path, n=2)
    co.run(2)
    assert co.membership.refresh_once() == 2
    faultinject.arm("train_net_partition", at=0, times=2)
    assert co.membership.refresh_once() < 2     # partitioned member
    assert co.membership.refresh_once() == 2    # healed
    assert co.membership.stats()["rejoins_total"] >= 1
    _teardown(co, ws)


def test_worker_server_stats_surface(tmp_path):
    w = TrainWorkerServer(artifact_dir=str(tmp_path / "af"))
    client = WorkerClient(w.addr)
    client.configure(LinRegTask(seed=1).spec())
    reply = client.rpc({"type": "stats"})
    snap = reply["value"]
    assert snap["task"]["kind"] == "linreg"
    assert snap["total_compiles"] == 0
    assert snap["coordinator_age_s"] >= 0
    # an unknown verb comes back as a typed wire error, not a hang
    from paddle_tpu_torch.serving.batching import ServingError
    with pytest.raises(ServingError, match="unknown verb"):
        client.rpc({"type": "warp"})
    client.close()
    w.close()


# ---------------------------------------------------------------------------
# compiled tier: provisioning gate
# ---------------------------------------------------------------------------


def test_program_task_replacement_provisions_zero_compiles(tmp_path):
    """The elastic-up path of the compiled tier, by the port's rule
    (ROADMAP.md §3 F6): the port's artifact store holds no train step
    (a program with a ``backward`` op bypasses it), so the peer's store
    stays empty, the wire provisioning copies what it holds (nothing),
    and the replacement builds its gradient step once, as the peer did,
    then serves real program gradients from the committed state. The
    reference's replacement loads the peer's compiled step and counts
    zero compiles."""
    from paddle_tpu_torch.cluster.net_worker import provision_from_remote
    wa = TrainWorkerServer(artifact_dir=str(tmp_path / "a"))
    co = TrainCoordinator(ProgramGradTask(seed=1), [wa.addr],
                          str(tmp_path / "ckpts"),
                          commit_interval=3, n_shards=2)
    co.run(3)
    assert wa.total_compiles() == 1     # the peer built its step once
    store = wa._task._exe().store_stats()
    assert store["bypass_total"] >= 1 and store["entries"] == 0
    report = provision_from_remote(wa.addr, str(tmp_path / "c"))
    assert report["files"] == 0 and report["bytes"] == 0
    wc = TrainWorkerServer(artifact_dir=str(tmp_path / "c"))
    co.admit(wc.addr)
    co.run(3)
    assert wc.last_step == 6
    assert wc.total_compiles() == 1, \
        "the replacement builds its one gradient step"
    assert co.commits()[-1][0] == 6
    _teardown(co, [wa, wc])


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def test_linreg_steps_bit_equal_to_the_reference(tmp_path):
    """LinRegTask is pure numpy in both packages: every grad sum and
    update is bit-equal, and a two-worker fabric run commits the
    reference's (serial, sha) sequence and losses."""
    jt, tt = jfab.LinRegTask(seed=4), LinRegTask(seed=4)
    js, ts = jt.init_state(), tt.init_state()
    for step in range(4):
        jg = [jt.grad_sums(js, step, k, 4) for k in range(4)]
        tg = [tt.grad_sums(ts, step, k, 4) for k in range(4)]
        for (jl, jgs, jn), (tl, tgs, tn) in zip(jg, tg):
            assert jl == tl and jn == tn
            assert jgs["w"].tobytes() == tgs["w"].tobytes()
        jsum = sum(g[1]["w"] for g in jg)
        tsum = sum(g[1]["w"] for g in tg)
        js = jt.apply(js, {"w": jsum}, 16, step)
        ts = tt.apply(ts, {"w": tsum}, 16, step)
        assert js["w"].tobytes() == ts["w"].tobytes()
    runs = {}
    for name, fab, wmod in (("jax", jfab, jworker),
                            ("port", None, None)):
        ws = ([wmod.TrainWorkerServer() for _ in range(2)] if wmod
              else [TrainWorkerServer() for _ in range(2)])
        Co = fab.TrainCoordinator if fab else TrainCoordinator
        Task = fab.LinRegTask if fab else LinRegTask
        co = Co(Task(seed=4), [w.addr for w in ws],
                str(tmp_path / name), commit_interval=3, n_shards=4)
        co.run(6)
        runs[name] = (co.commits(), co.losses())
        _teardown(co, ws)
    assert runs["port"] == runs["jax"]


def test_program_grad_sums_match_the_reference():
    """ProgramGradTask on the same state and shard: the port's gradient
    sums (fetched through its Executor on the host, as numpy) are
    within f32 2e-4 / 2e-5 of the reference's, under the same
    parameter names; the coordinator's update is the same numpy."""
    jt = jfab.ProgramGradTask(seed=3)
    tt = ProgramGradTask(seed=3, place=CPUPlace())
    state = jt.init_state()
    assert sorted(tt.init_state()) == sorted(state)
    for name, v in tt.init_state().items():
        assert v.tobytes() == state[name].tobytes()
    for step, shard in ((0, 0), (2, 1)):
        jl, jg, jn = jt.grad_sums(state, step, shard, 2)
        tl, tg, tn = tt.grad_sums(state, step, shard, 2)
        assert jn == tn and sorted(jg) == sorted(tg)
        np.testing.assert_allclose(tl, jl, rtol=2e-4, atol=2e-5)
        for name in jg:
            assert isinstance(tg[name], np.ndarray)
            np.testing.assert_allclose(tg[name], jg[name], rtol=2e-4,
                                       atol=2e-5, err_msg=name)
    new_j = jt.apply(state, jg, jn, 2)
    new_t = tt.apply(state, jg, jn, 2)
    for name in new_j:
        assert new_j[name].tobytes() == new_t[name].tobytes()
