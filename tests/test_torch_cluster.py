"""Cluster subsystem, the torch port on the CPU: the cases of
tests/test_cluster.py run on the port (paddle_tpu_torch/cluster/), the
replica pool + router that lift serving from one engine to N.

What is pinned here:

* **routing is pure policy over replica state** — the balancing
  policies are unit-tested against fake replicas, and the router's
  reroute/shed/failover ladder is driven through every refusal type
  with deterministic fakes, no threads;
* **the pool orchestrates, engines serve** — scale_up/scale_down,
  revival of dead replicas, and rolling_restart's one-at-a-time
  drain→rebuild rotation are exercised on fakes AND on real engines
  under concurrent load (zero lost requests, never fewer than N-1
  READY);
* **cluster results are bit-exact** — a request through the pool
  returns exactly what a lone engine returns (replicas share one
  read-only parameter scope, held once);
* **ServingMetrics.merge** combines counters and latency windows;
* **the warmup manifest round-trips**;
* **the Inferencer lifts** — ``serve(replicas=2)`` and
  ``serve_decode(replicas=2)`` return Routers;
* **launch counts stay exact under concurrent dispatch** — the
  attention wrappers' counters take a lock, as two replica threads
  dispatch at once.

All CPU (``_host`` makes the host the default place, so a
ProcessReplica's worker runs with ``--cpu``). The process-backed
replica and the decode cluster keep the reference's slow mark.
"""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import cluster
from paddle_tpu_torch.cluster import (ClusterOverloadError, HealthAwarePolicy,
                                InProcessReplica, LeastOutstandingPolicy,
                                NoReadyReplicaError, POLICIES, Replica,
                                ReplicaPool, RoundRobinPolicy, Router,
                                get_policy, serve_cluster)
from paddle_tpu_torch.inferencer import Inferencer
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.serving import (BucketSpec, HealthState, QueueFullError,
                                ServerClosedError, ServingConfig,
                                ServingEngine, ServingError,
                                ServiceUnavailableError, WorkerDiedError)
from paddle_tpu_torch.serving.kv_pages import PagesExhaustedError
from paddle_tpu_torch.serving.metrics import ServingMetrics

torch.set_num_threads(1)

pytestmark = pytest.mark.cluster


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    """The process's default place is the host, so engines, servers and
    the worker processes they spawn (``--cpu``) run on the CPU."""
    from paddle_tpu_torch.core import executor
    monkeypatch.setattr(executor, "_FORCED_CPU", True)


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.disarm()
    yield
    faultinject.disarm()


# ---------------------------------------------------------------------------
# ServingMetrics.merge — the cluster stats() primitive
# ---------------------------------------------------------------------------

def test_merge_sums_counters_and_concatenates_windows():
    a, b = ServingMetrics(), ServingMetrics()
    a.incr("responses_total", 3)
    b.incr("responses_total", 5)
    b.incr("shed_total")
    for v in (0.010, 0.020):
        a.observe_latency(v)
    b.observe_latency(0.030)
    a.observe_window("ttft_s", 0.5)
    b.observe_window("ttft_s", 1.5)
    a.set_queue_depth(2)
    b.set_queue_depth(3)
    snap = ServingMetrics.merge(a, b).stats()
    assert snap["responses_total"] == 8
    assert snap["shed_total"] == 1
    assert snap["request_latency"]["count"] == 3
    assert snap["request_latency"]["p50_ms"] == pytest.approx(20.0)
    assert snap["ttft_s"]["count"] == 2
    assert snap["queue_depth"] == 5
    # the sources are untouched
    assert a.stats()["responses_total"] == 3


def test_merge_unions_counter_vocabularies():
    """A pool may mix classifier and decode replicas; the merged view
    carries both counter sets."""
    plain = ServingMetrics()
    decode = ServingMetrics(extra_counters=("decode_steps_total",))
    plain.incr("responses_total")
    decode.incr("decode_steps_total", 7)
    snap = ServingMetrics.merge(plain, decode).stats()
    assert snap["responses_total"] == 1
    assert snap["decode_steps_total"] == 7


def test_merge_empty_and_no_args_are_safe():
    assert ServingMetrics.merge().stats()["responses_total"] == 0
    snap = ServingMetrics.merge(ServingMetrics(),
                                ServingMetrics()).stats()
    assert snap["request_latency"] == {"p50_ms": None, "p95_ms": None,
                                       "p99_ms": None, "count": 0}


def test_merge_survives_non_finite_samples():
    a, b = ServingMetrics(), ServingMetrics()
    # non-finite values can only enter the reservoir directly (the
    # observe_* door drops them) — the merged percentiles must still
    # filter them out rather than going NaN
    with a._lock:
        a._latencies.extend([0.010, float("nan"), float("inf")])
    b.observe_latency(0.030)
    snap = ServingMetrics.merge(a, b).stats()
    assert snap["request_latency"]["count"] == 2
    assert snap["request_latency"]["p50_ms"] == pytest.approx(20.0)


def test_merge_rebounds_to_latency_window():
    from paddle_tpu_torch.serving.metrics import _LATENCY_WINDOW
    a, b = ServingMetrics(), ServingMetrics()
    for m in (a, b):
        with m._lock:
            m._latencies.extend([0.001] * _LATENCY_WINDOW)
    merged = ServingMetrics.merge(a, b)
    assert len(merged._latencies) == _LATENCY_WINDOW


# ---------------------------------------------------------------------------
# fakes — deterministic replicas for policy/router/pool units
# ---------------------------------------------------------------------------

class FakeHandle:
    def __init__(self, value=None, error=None):
        self._value, self._error = value, error

    def result(self, timeout=None):
        if self._error is not None:
            raise self._error
        return self._value

    def wait(self, timeout=None):
        return True


class FakeReplica(Replica):
    """Scriptable replica: submit() returns canned values or raises
    canned errors (one per call via ``errors``, then ``value``)."""

    def __init__(self, name="fake", value="ok", errors=(),
                 health=HealthState.READY, outstanding=0, admits=True,
                 alive=True):
        super().__init__(name)
        self.value = value
        self.errors = list(errors)
        self._health = health
        self._outstanding = outstanding
        self._admits = admits
        self._alive = alive
        self.submits = 0
        self.closed_with = None
        self.rebuilt = 0
        self.started = 0

    def submit(self, item, timeout=None, **kw):
        self.submits += 1
        if self.errors:
            raise self.errors.pop(0)
        return FakeHandle(value=(self.name, self.value, item))

    def outstanding(self):
        return self._outstanding

    def health_state(self):
        return self._health

    def admits(self):
        return self._admits

    def alive(self):
        return self._alive

    def start(self):
        self.started += 1
        self._alive = True
        self._health = HealthState.READY
        return self

    def rebuild(self, warmup=True):
        self.rebuilt += 1
        self._alive = True
        self._health = HealthState.READY
        return self

    def close(self, drain=False, drain_timeout=None):
        self.closed_with = {"drain": drain,
                            "drain_timeout": drain_timeout}
        self._health = HealthState.STOPPED
        return self

    def warmup(self):
        return {}

    def stats(self):
        return {"health_state": self._health}

    def crash(self):
        self._alive = False
        self._health = HealthState.DEGRADED


def _fake_pool(*replicas):
    """A monitorless pool whose factory hands out the given fakes in
    order (the pool accepts ready Replica instances from a factory)."""
    it = iter(replicas)
    pool = ReplicaPool(lambda: next(it), replicas=len(replicas),
                       revive_interval_s=0)
    return pool


# ---------------------------------------------------------------------------
# balancing policies
# ---------------------------------------------------------------------------

def test_round_robin_rotates():
    a, b, c = (FakeReplica(n) for n in "abc")
    pol = RoundRobinPolicy()
    assert [r.name for r in pol.order([a, b, c])] == ["a", "b", "c"]
    assert [r.name for r in pol.order([a, b, c])] == ["b", "c", "a"]
    assert [r.name for r in pol.order([a, b, c])] == ["c", "a", "b"]
    assert pol.order([]) == []


def test_least_outstanding_orders_by_load():
    a = FakeReplica("a", outstanding=5)
    b = FakeReplica("b", outstanding=1)
    c = FakeReplica("c", outstanding=3)
    assert [r.name for r in LeastOutstandingPolicy().order([a, b, c])] \
        == ["b", "c", "a"]


def test_health_aware_tiers_and_exclusions():
    ready_busy = FakeReplica("ready-busy", outstanding=9)
    ready_idle = FakeReplica("ready-idle", outstanding=0)
    degraded = FakeReplica("degraded", health=HealthState.DEGRADED)
    breaker_open = FakeReplica("breaker-open", admits=False)
    starting = FakeReplica("starting", health=HealthState.STARTING)
    stopped = FakeReplica("stopped", health=HealthState.STOPPED)
    draining = FakeReplica("draining", health=HealthState.DRAINING)
    order = HealthAwarePolicy().order(
        [stopped, breaker_open, degraded, ready_busy, draining,
         starting, ready_idle])
    # READY-and-admitting first (least outstanding wins), then
    # DEGRADED, then breaker-open; non-serving states never appear
    assert [r.name for r in order] == \
        ["ready-idle", "ready-busy", "degraded", "breaker-open"]


def test_get_policy_accepts_name_class_instance():
    assert isinstance(get_policy("round_robin"), RoundRobinPolicy)
    assert isinstance(get_policy(LeastOutstandingPolicy),
                      LeastOutstandingPolicy)
    pol = HealthAwarePolicy()
    assert get_policy(pol) is pol
    with pytest.raises(ValueError, match="unknown balancing policy"):
        get_policy("fastest_first")
    assert set(POLICIES) == {"round_robin", "least_outstanding",
                             "health_aware"}


# ---------------------------------------------------------------------------
# router — reroute / shed / failover ladder on fakes
# ---------------------------------------------------------------------------

def test_router_reroutes_a_refusing_replica():
    full = FakeReplica("full", outstanding=0,
                       errors=[QueueFullError("queue full")])
    spare = FakeReplica("spare", outstanding=1)
    router = Router(_fake_pool(full, spare),
                    policy="least_outstanding")
    name, _, _ = router.submit({"x": 1}).result()
    # (the pool renames replicas it adopts — compare live names)
    assert name == spare.name       # the full replica was tried first
    assert full.submits == 1 and spare.submits == 1
    assert router.stats()["reroutes_total"] == 1


def test_router_sheds_cluster_overload_when_every_queue_is_full():
    a = FakeReplica("a", errors=[QueueFullError("full")])
    b = FakeReplica("b", errors=[QueueFullError("full")])
    router = Router(_fake_pool(a, b))
    with pytest.raises(ClusterOverloadError):
        router.submit({"x": 1})
    snap = router.stats()
    assert snap["cluster_shed_total"] == 1
    assert snap["reroutes_total"] == 2
    # ClusterOverloadError IS a QueueFullError — existing client
    # backoff code keeps working unmodified
    assert issubclass(ClusterOverloadError, QueueFullError)


def test_router_no_ready_replica_when_pool_is_out():
    dead = FakeReplica("dead", alive=False)
    restarting = FakeReplica("restarting")
    restarting.restarting = True
    router = Router(_fake_pool(dead, restarting))
    with pytest.raises(NoReadyReplicaError):
        router.submit({"x": 1})
    assert issubclass(NoReadyReplicaError, ServiceUnavailableError)
    assert dead.submits == 0 and restarting.submits == 0


def test_router_cluster_queue_bound_sheds_before_any_replica():
    busy = FakeReplica("busy", outstanding=4)
    router = Router(_fake_pool(busy), max_cluster_queue=4)
    with pytest.raises(ClusterOverloadError, match="outstanding bound"):
        router.submit({"x": 1})
    assert busy.submits == 0


def test_router_pages_exhausted_never_reroutes():
    """A never-fits request fails identically on every replica —
    rerouting it would just burn the pool."""
    a = FakeReplica("a", errors=[PagesExhaustedError("too long")])
    b = FakeReplica("b")
    router = Router(_fake_pool(a, b), policy="round_robin")
    with pytest.raises(PagesExhaustedError):
        router.submit({"x": 1})
    assert b.submits == 0


def test_router_infer_fails_over_a_dying_replica():
    """The replica accepts the request, then dies with it in flight:
    infer() resubmits elsewhere — the crash costs latency, not the
    answer. (Death flips alive(), exactly like a real worker death,
    so the next pick skips the corpse.)"""
    dying = FakeReplica("dying", outstanding=0)

    class DyingHandle:
        def result(self, timeout=None):
            dying._alive = False     # the worker died with the request
            raise WorkerDiedError("replica died mid-request")
    dying.submit = lambda item, timeout=None, **kw: DyingHandle()
    spare = FakeReplica("spare", outstanding=1)
    router = Router(_fake_pool(dying, spare),
                    policy="least_outstanding")
    name, _, _ = router.infer({"x": 1}, timeout=5.0)
    assert name == spare.name
    assert router.stats()["failovers_total"] == 1


def test_router_infer_failover_off_raises_the_death():
    class DyingHandle:
        def result(self, timeout=None):
            raise WorkerDiedError("died")
    dying = FakeReplica("dying")
    dying.submit = lambda item, timeout=None, **kw: DyingHandle()
    router = Router(_fake_pool(dying, FakeReplica("spare")),
                    policy="round_robin")
    with pytest.raises(WorkerDiedError):
        router.infer({"x": 1}, timeout=5.0, failover=False)


def test_router_infer_terminates_when_everything_keeps_dying():
    class DyingHandle:
        def result(self, timeout=None):
            raise WorkerDiedError("died")
    fakes = [FakeReplica(f"r{i}") for i in range(3)]
    for f in fakes:
        f.submit = lambda item, timeout=None, **kw: DyingHandle()
    router = Router(_fake_pool(*fakes))
    with pytest.raises(WorkerDiedError):
        router.infer({"x": 1}, timeout=5.0)


# ---------------------------------------------------------------------------
# pool — lifecycle orchestration on fakes
# ---------------------------------------------------------------------------

def test_pool_scale_up_and_down():
    fakes = [FakeReplica(f"f{i}") for i in range(4)]
    it = iter(fakes)
    pool = ReplicaPool(lambda: next(it), replicas=2,
                       revive_interval_s=0)
    assert len(pool) == 2
    added = pool.scale_up(2)
    assert len(pool) == 4 and len(added) == 2
    # pool-assigned names stay unique across scaling
    assert len({r.name for r in pool.replicas()}) == 4
    removed = pool.scale_down(3, drain=True)
    assert len(pool) == 1 and len(removed) == 3
    for r in removed:
        assert r.closed_with == {"drain": True, "drain_timeout": None}
    # never below one replica
    assert pool.scale_down(5) == []
    assert len(pool) == 1


def test_pool_revive_dead_skips_stopped_and_restarting():
    dead = FakeReplica("dead", alive=False,
                       health=HealthState.DEGRADED)
    stopped = FakeReplica("stopped", alive=False,
                          health=HealthState.STOPPED)
    mid_restart = FakeReplica("mid-restart", alive=False,
                              health=HealthState.DEGRADED)
    mid_restart.restarting = True
    healthy = FakeReplica("healthy")
    pool = _fake_pool(dead, stopped, mid_restart, healthy)
    revived = pool.revive_dead()
    assert revived == [dead]
    assert dead.started == 1
    assert stopped.started == 0          # deliberately closed
    assert mid_restart.started == 0      # rolling restart owns it
    assert pool.stats()["revives_total"] == 1


def test_pool_monitor_thread_revives_automatically():
    dead = FakeReplica("dead", alive=False,
                       health=HealthState.DEGRADED)
    it = iter([dead])
    pool = ReplicaPool(lambda: next(it), replicas=1,
                       revive_interval_s=0.02)
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not dead.started:
            time.sleep(0.01)
        assert dead.started >= 1
    finally:
        pool.close()


def test_rolling_restart_rotation_order_and_floor():
    fakes = [FakeReplica(f"f{i}") for i in range(3)]
    pool = _fake_pool(*fakes)
    report = pool.rolling_restart(drain_timeout=1.0)
    assert report["restarted"] == [r.name for r in pool.replicas()]
    for r in fakes:
        assert r.closed_with == {"drain": True, "drain_timeout": 1.0}
        assert r.rebuilt == 1
        assert not r.restarting          # back in rotation
    # one at a time: the worst instant still had N-1 READY
    assert report["min_ready_observed"] == 2
    assert report["ready_after"] == 3
    assert pool.stats()["restarts_total"] == 3


def test_pool_stats_shape():
    pool = _fake_pool(FakeReplica("a"), FakeReplica("b"))
    snap = pool.stats()
    assert snap["n_replicas"] == 2 and snap["ready_replicas"] == 2
    assert [p["name"] for p in snap["replicas"]] \
        == [r.name for r in pool.replicas()]
    assert snap["cluster"] is None       # fakes expose no registry


def test_fault_point_registered():
    assert "serving_replica_crash" in faultinject.KNOWN_POINTS


# ---------------------------------------------------------------------------
# real engines — correctness, rolling restart, chaos
# ---------------------------------------------------------------------------

def _make_model():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h, size=10, act="softmax")
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
    return infer, pred, scope


def _engine_factory(infer, pred, scope, **cfg_kw):
    cfg_kw.setdefault("max_wait_ms", 5.0)
    cfg_kw.setdefault("max_queue", 64)

    def factory():
        return ServingEngine(infer, ["x"], [pred], scope=scope,
                             place=fluid.CPUPlace(),
                             buckets=BucketSpec(batch_sizes=(1, 2, 4)),
                             config=ServingConfig(**cfg_kw))
    return factory


def test_cluster_results_bit_exact_vs_single_engine():
    """Replicas share one read-only scope; whichever replica serves a
    request, the answer is IDENTICAL to a lone engine's."""
    infer, pred, scope = _make_model()
    factory = _engine_factory(infer, pred, scope)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(n, 8).astype(np.float32)}
             for n in (1, 2, 1, 2, 1, 1)]
    lone = factory()
    try:
        lone.warmup()
        refs = [lone.infer(f, timeout=30.0) for f in feeds]
    finally:
        lone.close()
    with serve_cluster(factory, replicas=2, warmup=True) as router:
        # spread across both replicas deterministically
        router.policy = RoundRobinPolicy()
        got = [router.infer(f, timeout=30.0) for f in feeds]
        snap = router.stats()
    for ref, out in zip(refs, got):
        np.testing.assert_array_equal(ref[0], out[0])
    assert snap["n_replicas"] == 2
    assert snap["cluster"]["responses_total"] == len(feeds)
    # both replicas actually served (round robin over 6 requests)
    per_replica = [m for m in snap["replicas"]]
    assert all(p["alive"] for p in per_replica)


def test_cluster_ready_count_and_outstanding_reads():
    infer, pred, scope = _make_model()
    factory = _engine_factory(infer, pred, scope)
    with serve_cluster(factory, replicas=2, warmup=True) as router:
        assert router.pool.ready_count() == 2
        assert router.pool.total_outstanding() == 0
        replica = router.pool.replicas()[0]
        assert isinstance(replica, InProcessReplica)
        assert replica.admits() and replica.alive()
        assert replica.health_state() == HealthState.READY


def test_cluster_rolling_restart_zero_loss_under_load():
    """The acceptance pin, test-sized: concurrent clients hammer the
    router while every replica is drained + rebuilt; nothing is lost,
    nothing surfaces a typed error, and READY never drops below N-1."""
    infer, pred, scope = _make_model()
    factory = _engine_factory(infer, pred, scope)
    with serve_cluster(factory, replicas=2, warmup=True) as router:
        outcomes = {"ok": 0, "typed": 0, "lost": 0}
        lock = threading.Lock()
        stop = threading.Event()
        ready_samples = []
        rng = np.random.RandomState(1)
        feed = {"x": rng.randn(2, 8).astype(np.float32)}

        def client():
            while not stop.is_set():
                try:
                    router.infer(feed, timeout=30.0)
                    key = "ok"
                except ServingError:
                    key = "typed"
                except Exception:            # noqa: BLE001 — tallied
                    key = "lost"
                with lock:
                    outcomes[key] += 1

        def poll():
            while not stop.is_set():
                ready_samples.append(router.pool.ready_count())
                stop.wait(0.005)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        threads.append(threading.Thread(target=poll, daemon=True))
        for t in threads:
            t.start()
        time.sleep(0.1)
        report = router.pool.rolling_restart(drain_timeout=30.0)
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(30.0)
    assert outcomes["lost"] == 0, outcomes
    assert outcomes["typed"] == 0, outcomes
    assert outcomes["ok"] > 0
    assert len(report["restarted"]) == 2
    assert min([report["min_ready_observed"]] + ready_samples) >= 1


def test_replica_crash_chaos_zero_loss_and_revival():
    """The serving_replica_crash drill: the fault point kills the
    replica the router just picked; failover absorbs it (zero lost,
    zero typed) and a revival sweep brings the replica back."""
    infer, pred, scope = _make_model()
    factory = _engine_factory(infer, pred, scope)
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.randn(1, 8).astype(np.float32)}
             for _ in range(6)]
    with serve_cluster(factory, replicas=2, warmup=True,
                       revive_interval_s=0.02) as router:
        faultinject.arm("serving_replica_crash", at=0)
        try:
            outs = [router.infer(f, timeout=30.0) for f in feeds[:1]]
        finally:
            faultinject.disarm("serving_replica_crash")
        assert outs[0][0].shape == (1, 10)
        # the monitor revives the crashed worker
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline \
                and router.pool.ready_count() < 2:
            time.sleep(0.01)
        snap = router.stats()
        assert snap["ready_replicas"] == 2
        assert snap["revives_total"] >= 1
        # post-recovery traffic is clean
        for f in feeds:
            assert router.infer(f, timeout=30.0)[0].shape == (1, 10)


def test_cluster_shed_is_typed_at_the_bound():
    """Real engines whose batcher is HOLDING work (a 4-row bucket that
    never fills, a far-away flush deadline): the replica's queue-full
    refusal surfaces as the cluster-typed overload error when there is
    nowhere left to reroute."""
    infer, pred, scope = _make_model()

    def factory():
        return ServingEngine(
            infer, ["x"], [pred], scope=scope,
            place=fluid.CPUPlace(),
            buckets=BucketSpec(batch_sizes=(4,)),
            config=ServingConfig(max_wait_ms=60_000.0, max_queue=2))

    pool = ReplicaPool(factory, replicas=1, revive_interval_s=0)
    router = Router(pool, max_cluster_queue=8)
    try:
        feed = {"x": np.zeros((1, 8), np.float32)}
        router.submit(feed, timeout=60.0)
        router.submit(feed, timeout=60.0)
        # replica queue full (2) but below the cluster bound: the
        # single replica refuses and there is nowhere to reroute
        with pytest.raises(ClusterOverloadError):
            router.submit(feed, timeout=60.0)
        snap = router.stats()
        assert snap["cluster_shed_total"] == 1
        assert snap["total_outstanding"] == 2
        # the POOL bound is the earlier gate when it is tighter
        router.max_cluster_queue = 2
        with pytest.raises(ClusterOverloadError,
                           match="outstanding bound"):
            router.submit(feed, timeout=60.0)
    finally:
        router.close()


def test_inferencer_serve_replicas_returns_router(tmp_path):
    infer, pred, scope = _make_model()
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = str(tmp_path / "model")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            model_dir, ["x"], [pred], exe, main_program=infer,
            serving_buckets=BucketSpec(batch_sizes=(1, 2, 4)))
    inferencer = Inferencer.from_inference_model(
        model_dir, place=fluid.CPUPlace())
    router = inferencer.serve(replicas=2, warmup=True)
    try:
        assert isinstance(router, Router)
        out = router.infer({"x": np.zeros((2, 8), np.float32)},
                           timeout=30.0)
        assert out[0].shape == (2, 10)
        # the manifest's buckets made it into every replica
        for replica in router.pool.replicas():
            assert replica.engine.buckets.batch_sizes == (1, 2, 4)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# warmup manifest — export-time serving geometry
# ---------------------------------------------------------------------------

def test_bucketspec_manifest_round_trip():
    spec = BucketSpec(batch_sizes=(1, 2, 8),
                      seq_lens={"tok": (16, 32)},
                      pad_values={"tok": 7})
    clone = BucketSpec.from_manifest(spec.to_manifest())
    assert clone.batch_sizes == spec.batch_sizes
    assert {k: tuple(v) for k, v in clone.seq_lens.items()} \
        == {"tok": (16, 32)}
    assert clone.pad_values == {"tok": 7}
    # the manifest is plain JSON
    json.dumps(spec.to_manifest())


def test_save_inference_model_persists_serving_manifest(tmp_path):
    infer, pred, scope = _make_model()
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = str(tmp_path / "model")
    spec = BucketSpec(batch_sizes=(2, 4))
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            model_dir, ["x"], [pred], exe, main_program=infer,
            serving_buckets=spec, decode_max_batch=8)
    manifest = fluid.io.load_serving_manifest(model_dir)
    assert manifest["buckets"]["batch_sizes"] == [2, 4]
    assert manifest["decode_max_batch"] == 8
    # from_saved_model warms exactly the exporter's buckets
    eng = ServingEngine.from_saved_model(model_dir,
                                         place=fluid.CPUPlace())
    try:
        assert eng.buckets.batch_sizes == (2, 4)
        report = eng.warmup()
        assert report["compiles"] == len(eng.buckets.batch_sizes)
    finally:
        eng.close()
    # an explicit buckets= overrides the manifest
    eng = ServingEngine.from_saved_model(
        model_dir, place=fluid.CPUPlace(),
        buckets=BucketSpec(batch_sizes=(1,)))
    try:
        assert eng.buckets.batch_sizes == (1,)
    finally:
        eng.close()


def test_artifacts_without_manifest_stay_loadable(tmp_path):
    infer, pred, scope = _make_model()
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = str(tmp_path / "plain")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, ["x"], [pred], exe,
                                      main_program=infer)
    assert fluid.io.load_serving_manifest(model_dir) == {}
    assert fluid.io.load_serving_manifest(
        str(tmp_path / "nowhere")) == {}
    eng = ServingEngine.from_saved_model(model_dir,
                                         place=fluid.CPUPlace())
    try:
        # falls back to the default bucket ladder
        assert eng.buckets.batch_sizes == BucketSpec().batch_sizes
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# process-backed replica + decode cluster — the heavyweight drills
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_process_replica_end_to_end(tmp_path):
    """The same router contract over a real OS process: spawn from a
    saved artifact, serve, SIGKILL it, revive by respawn."""
    from paddle_tpu_torch.cluster.replica import ProcessReplica
    infer, pred, scope = _make_model()
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = str(tmp_path / "model")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            model_dir, ["x"], [pred], exe, main_program=infer,
            serving_buckets=BucketSpec(batch_sizes=(1, 2)))
    ref_eng = ServingEngine.from_saved_model(model_dir,
                                             place=fluid.CPUPlace())
    feed = {"x": np.arange(8, dtype=np.float32).reshape(1, 8)}
    try:
        ref = ref_eng.infer(feed, timeout=30.0)
    finally:
        ref_eng.close()

    replica = ProcessReplica(model_dir, name="proc-0")
    try:
        replica.wait_ready()
        assert replica.alive()
        assert replica.health_state() == HealthState.READY
        out = replica.submit(feed, timeout=30.0).result(30.0)
        np.testing.assert_allclose(np.asarray(out[0]),
                                   np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-7)
        snap = replica.stats()
        assert snap["responses_total"] >= 1

        # SIGKILL: pending work fails typed, liveness flips
        replica.crash()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and replica.alive():
            time.sleep(0.02)
        assert not replica.alive()
        assert replica.health_state() == HealthState.DEGRADED
        with pytest.raises(WorkerDiedError):
            replica.submit(feed)

        # revival is a respawn that re-warms from the manifest
        replica.start()
        replica.wait_ready()
        out = replica.submit(feed, timeout=30.0).result(30.0)
        np.testing.assert_allclose(np.asarray(out[0]),
                                   np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-7)
    finally:
        replica.close()
    assert replica.health_state() == HealthState.STOPPED


@pytest.mark.slow
def test_process_replica_pool_via_router(tmp_path):
    """A pool of process replicas behind the stock Router — the same
    data plane that drives in-process engines drives OS processes."""
    from paddle_tpu_torch.cluster.replica import ProcessReplica
    infer, pred, scope = _make_model()
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = str(tmp_path / "model")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            model_dir, ["x"], [pred], exe, main_program=infer,
            serving_buckets=BucketSpec(batch_sizes=(1, 2)))

    def factory():
        return ProcessReplica(model_dir)

    pool = ReplicaPool(factory, replicas=2, revive_interval_s=0)
    router = Router(pool, policy="round_robin")
    try:
        for r in pool.replicas():
            r.wait_ready()
        feed = {"x": np.ones((1, 8), np.float32)}
        outs = [router.infer(feed, timeout=60.0) for _ in range(4)]
        for out in outs:
            assert np.asarray(out[0]).shape == (1, 10)
        # both processes took traffic (round robin, 4 requests)
        snap = router.stats()
        assert snap["n_replicas"] == 2
        assert all(p["alive"] for p in snap["replicas"])
    finally:
        router.close()


@pytest.mark.slow
def test_decode_engine_cluster(tmp_path):
    """The router drives DecodeEngine replicas too: same scope, two
    engines, greedy tokens identical to a lone engine's."""
    from paddle_tpu_torch.models.llama import LlamaConfig, \
        build_llama_generator
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
    cfg = LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_hidden=64, dtype="float32")
    gen_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(gen_p, startup):
        ptok = fluid.layers.data(name="ptok", shape=[1, 6],
                                 dtype="int64",
                                 append_batch_size=False)
        build_llama_generator(cfg, ptok, max_new_tokens=8)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)

    def factory():
        return DecodeEngine(
            cfg, scope=scope, place=fluid.CPUPlace(),
            config=DecodeConfig(max_batch=2, prompt_buckets=(4, 8),
                                max_new_tokens=8, page_size=8,
                                decode_block=4, prefill_batch=2,
                                default_timeout_s=120.0))

    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n in (3, 5, 4, 6)]
    lone = factory()
    try:
        lone.warmup()
        refs = [lone.generate(p, timeout=120.0) for p in prompts]
    finally:
        lone.close()
    with serve_cluster(factory, replicas=2, warmup=True) as router:
        router.policy = RoundRobinPolicy()
        replica = router.pool.replicas()[0]
        assert replica.engine.outstanding() == 0
        handles = [router.submit(p, timeout=120.0) for p in prompts]
        outs = [h.result(120.0) for h in handles]
        snap = router.stats()
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(np.asarray(ref),
                                      np.asarray(out))
    assert snap["cluster"]["responses_total"] == len(prompts)


# ---------------------------------------------------------------------------
# the port's own: the decode lift, exact launch counts
# ---------------------------------------------------------------------------

def test_inferencer_serve_decode_replicas_returns_router():
    """``serve_decode(replicas=2)`` is a Router over two decode engines
    sharing the Inferencer's scope (one copy of the weights), whose
    tokens equal a lone engine's."""
    from paddle_tpu_torch.models.llama import LlamaConfig, \
        build_llama_generator
    from paddle_tpu_torch.serving import DecodeConfig
    cfg = LlamaConfig(vocab_size=64, dim=32, n_layers=1, n_heads=4,
                      n_kv_heads=2, ffn_hidden=64, dtype="float32")
    gen_p, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(gen_p, startup):
        ptok = fluid.layers.data(name="ptok", shape=[1, 4], dtype="int64",
                                 append_batch_size=False)
        out = build_llama_generator(cfg, ptok, max_new_tokens=4)
    inf = Inferencer.__new__(Inferencer)
    inf.scope = fluid.Scope()
    inf._place = fluid.CPUPlace()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=inf.scope)
    conf = DecodeConfig(max_batch=2, prompt_buckets=(4,), max_new_tokens=4,
                        page_size=4, decode_block=2, prefill_batch=1,
                        default_timeout_s=120.0)
    p = np.array([3, 1, 4, 1], np.int64)
    lone = inf.serve_decode(cfg, config=conf, warmup=True)
    try:
        ref = lone.generate(p, timeout=120.0)
    finally:
        lone.close()
    router = inf.serve_decode(cfg, config=conf, replicas=2, warmup=True)
    try:
        assert isinstance(router, Router)
        engines = [r.engine for r in router.pool.replicas()]
        assert len(engines) == 2 and engines[0] is not engines[1]
        assert all(e.scope is inf.scope for e in engines)
        router.policy = RoundRobinPolicy()
        for _ in range(2):
            np.testing.assert_array_equal(
                np.asarray(router.generate(p, timeout=120.0)),
                np.asarray(ref))
    finally:
        router.close()
    del out


def test_launch_counts_are_exact_across_two_threads():
    """Two threads count launches and input copies at once through the
    wrappers' counting paths (``_count`` is what a kernel launch and a
    plain-route call add through; ``_aligned_copy`` copies an input the
    kernels cannot take): no increment is lost."""
    from paddle_tpu_torch.ops import flash_attention as fa
    fa.reset_launch_counts()
    sym = fa._ROUTES["flash_fwd"][0][1]
    view = torch.zeros(4, 4).t()            # not contiguous: copied
    n = 20000
    barrier = threading.Barrier(2)

    def work():
        barrier.wait()
        for _ in range(n):
            fa._count(fa.flash_fwd, sym)
            fa._count(fa.flash_bwd_dq, fa.PLAIN)
        for _ in range(n // 10):
            fa._aligned_copy(view)

    threads = [threading.Thread(target=work) for _ in range(2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)             # switch threads often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    finally:
        sys.setswitchinterval(old)
    try:
        assert fa.flash_fwd.launches == 2 * n
        assert fa.flash_fwd.launches_by_kernel[sym] == 2 * n
        assert fa.flash_bwd_dq.launches == 0
        assert fa.flash_bwd_dq.launches_by_kernel[fa.PLAIN] == 2 * n
        assert fa.flash_fwd.input_copies == 2 * (n // 10)
    finally:
        fa.reset_launch_counts()
