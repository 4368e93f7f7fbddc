"""Versioned-deployment suite (paddle_tpu/cluster/deploy.py): the
policy layer that closes the deployment loop — canary traffic
shifting, numerics-gated promotion, instant rollback.

What is pinned here:

* **weighted version routing is exact at the edges and fair in the
  middle** — weight 0 (or absence) NEVER routes, a lone weight 1.0
  ALWAYS routes, and a seeded split lands within tolerance of the
  requested ratio; the non-chosen weighted versions stay behind the
  chosen one as failover spill;
* **the numerics gate is optcheck's comparison applied to
  deployments** — identical outputs pass, perturbation/shape/arity
  drift and non-finite outputs fail loudly;
* **guardrails are a pure function** over two per-version stats
  snapshots — error-rate and p99 regressions flag, insufficient
  canary traffic abstains;
* **the DeploymentManager walks the gauntlet on scriptable fakes** —
  dark deploy, auto-reject + rollback on a regressed canary (via the
  ``serving_canary_regression`` fault point and via a lying
  ``eval_fn``), full promotion relabels the pool;
* **ServingMetrics.merge(label=)** namespaces per-version registries
  so two versions' counters never collide;
* **exports are versioned monotonically** — ``save_inference_model``
  auto-bumps ``model_version``, refuses to move a directory
  backwards, and the golden-request set round-trips beside the model.

All CPU, fake-first: only the export/engine stamp tests touch a real
(tiny) model.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch.cluster import (DeploymentError, DeploymentManager,
                                Guardrails, ModelVersion, Replica,
                                ReplicaPool, Router, check_numerics,
                                evaluate_guardrails)
from paddle_tpu_torch.cluster.membership import Membership
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.serving import HealthState
from paddle_tpu_torch.serving.metrics import ServingMetrics

pytestmark = [pytest.mark.cluster, pytest.mark.serving]


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
# fakes — versioned replicas for routing/deployment units
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


class VersionedFake(Replica):
    """Scriptable replica with a version label, a real metrics
    registry, and a rebuild() that records the factory it was swapped
    onto (the deploy manager's conversion primitive)."""

    def __init__(self, name, version=None):
        super().__init__(name)
        self.version = version
        self.metrics = ServingMetrics()
        self.submits = 0
        self.rebuilt_with = []      # factories, in conversion order
        self.drained = 0

    def submit(self, item, timeout=None, **kw):
        self.submits += 1
        self.metrics.incr("requests_total")
        self.metrics.incr("responses_total")
        return FakeHandle(value=(self.name, self.version, item))

    def outstanding(self):
        return 0

    def health_state(self):
        return HealthState.READY

    def admits(self):
        return True

    def alive(self):
        return True

    def start(self):
        return self

    def rebuild(self, warmup=True, factory=None):
        self.rebuilt_with.append(factory)
        self.last_rebuild_report = {"compiles": 0}
        return self

    def close(self, drain=False, drain_timeout=None):
        if drain:
            self.drained += 1
        return self

    def warmup(self):
        return {}

    def stats(self):
        return self.metrics.stats()

    def metrics_obj(self):
        return self.metrics

    def crash(self):
        pass


def _versioned_router(labels, seed=0, policy="round_robin"):
    """A router over one VersionedFake per label, with a pinned
    weight RNG."""
    fakes = [VersionedFake(f"r{i}", version=v)
             for i, v in enumerate(labels)]
    it = iter(fakes)
    pool = ReplicaPool(lambda: next(it), replicas=len(fakes),
                       revive_interval_s=0)
    return Router(pool, policy=policy, weight_seed=seed), fakes


def _routed_versions(router, n):
    return [router.submit(i).result()[1] for i in range(n)]


# ---------------------------------------------------------------------------
# weighted version routing
# ---------------------------------------------------------------------------

def test_weight_zero_and_absent_never_route():
    router, _ = _versioned_router(["v1", "v1", "v2"])
    # absent from the map == weight 0.0 (set_weights drops zeros)
    for weights in ({"v1": 1.0}, {"v1": 1.0, "v2": 0.0}):
        router.set_weights(weights)
        assert set(_routed_versions(router, 200)) == {"v1"}


def test_weight_one_always_routes():
    router, _ = _versioned_router(["v1", "v1", "v2"])
    router.set_weights({"v2": 1.0})
    assert set(_routed_versions(router, 200)) == {"v2"}


def test_weighted_split_is_fair_and_seed_deterministic():
    router, _ = _versioned_router(["v1", "v2"], seed=7)
    router.set_weights({"v1": 0.75, "v2": 0.25})
    picks = _routed_versions(router, 2000)
    frac_v2 = picks.count("v2") / len(picks)
    assert 0.19 <= frac_v2 <= 0.31     # ±6 sigma-ish at n=2000
    # the same seed replays the same draw sequence exactly
    router2, _ = _versioned_router(["v1", "v2"], seed=7)
    router2.set_weights({"v1": 0.75, "v2": 0.25})
    assert _routed_versions(router2, 2000) == picks


def test_weights_need_not_sum_to_one():
    router, _ = _versioned_router(["v1", "v2"], seed=3)
    router.set_weights({"v1": 3, "v2": 1})
    picks = _routed_versions(router, 2000)
    assert 0.19 <= picks.count("v2") / len(picks) <= 0.31


def test_set_weights_validation_and_clear():
    router, _ = _versioned_router(["v1", "v2"])
    with pytest.raises(ValueError):
        router.set_weights({"v1": -0.1})
    with pytest.raises(ValueError):
        router.set_weights({"v1": float("nan")})
    with pytest.raises(ValueError):
        router.set_weights({"v1": 0.0})     # nothing routable
    router.set_weights({"v1": 1.0})
    assert router.weights() == {"v1": 1.0}
    assert router.stats()["weights"] == {"v1": 1.0}
    router.set_weights(None)
    assert router.weights() is None
    # with routing cleared, every label is a candidate again
    assert set(_routed_versions(router, 50)) == {"v1", "v2"}


def test_weighted_version_without_replicas_spills_to_other():
    """The draw only considers versions that currently HAVE an
    eligible replica — a weight pointing at nothing must not blackhole
    its share of the traffic."""
    router, fakes = _versioned_router(["v1", "v1"])
    router.set_weights({"v1": 0.5, "ghost": 0.5})
    assert set(_routed_versions(router, 100)) == {"v1"}
    # and when NO weighted version has a replica, the typed no-capacity
    # signal fires (not a silent fall-through to unweighted routing)
    from paddle_tpu_torch.cluster import NoReadyReplicaError
    router.set_weights({"ghost": 1.0})
    with pytest.raises(NoReadyReplicaError):
        router.submit({"x": 1})


# ---------------------------------------------------------------------------
# check_numerics — the gate's comparison
# ---------------------------------------------------------------------------

def _golden_rows(val=1.0, n=3):
    return [[np.full((2, 4), val, np.float32)] for _ in range(n)]


def test_check_numerics_accepts_identical_and_tolerable():
    ref = _golden_rows(1.0)
    assert check_numerics(ref, _golden_rows(1.0))["ok"]
    near = _golden_rows(1.0 + 5e-6)      # inside rtol=1e-5
    assert check_numerics(ref, near)["ok"]


def test_check_numerics_rejects_perturbation():
    rep = check_numerics(_golden_rows(1.0), _golden_rows(1.001))
    assert not rep["ok"]
    assert rep["max_abs_err"] == pytest.approx(1e-3, rel=1e-2)
    assert "exceeds" in rep["worst"]


def test_check_numerics_rejects_contract_drift():
    ref = _golden_rows(1.0, n=2)
    # arity: candidate answered fewer requests
    assert not check_numerics(ref, ref[:1])["ok"]
    # fetch count per request
    two_fetch = [[r[0], r[0]] for r in ref]
    assert not check_numerics(ref, two_fetch)["ok"]
    # shape
    fat = [[np.ones((2, 8), np.float32)] for _ in ref]
    rep = check_numerics(ref, fat)
    assert not rep["ok"] and "shape" in rep["worst"]
    # non-finite output can never promote
    nan_rows = _golden_rows(1.0, n=2)
    nan_rows[1][0] = nan_rows[1][0].copy()
    nan_rows[1][0][0, 0] = np.nan
    assert not check_numerics(ref, nan_rows)["ok"]


# ---------------------------------------------------------------------------
# evaluate_guardrails — pure policy over stats snapshots
# ---------------------------------------------------------------------------

def _stats(requests=100, errors=0, timeouts=0, p99_ms=None, count=None):
    return {"requests_total": requests, "errors_total": errors,
            "timeouts_total": timeouts,
            "request_latency": {"p99_ms": p99_ms,
                                "count": requests
                                if count is None else count}}


def test_guardrails_abstain_below_min_traffic():
    g = Guardrails(min_canary_requests=50)
    bad = _stats(requests=10, errors=10)
    assert evaluate_guardrails(bad, _stats(), g) == []


def test_guardrails_flag_error_rate_regression():
    g = Guardrails(max_error_rate_delta=0.02, min_canary_requests=20)
    vio = evaluate_guardrails(_stats(requests=100, errors=10),
                              _stats(requests=100, errors=0), g)
    assert len(vio) == 1 and "error-rate" in vio[0]
    # timeouts count as errors too
    vio = evaluate_guardrails(_stats(requests=100, timeouts=10),
                              _stats(requests=100), g)
    assert vio and "error-rate" in vio[0]
    # inside the delta: clean
    assert evaluate_guardrails(_stats(requests=100, errors=1),
                               _stats(requests=100, errors=0), g) == []


def test_guardrails_judge_deltas_since_baseline():
    """An old error burst in the canary's lifetime counters must not
    fail a stage where it behaved — only the window since the stage
    baseline is judged."""
    g = Guardrails(min_canary_requests=20)
    baseline = _stats(requests=100, errors=50)
    now = _stats(requests=200, errors=50)     # 100 clean since
    assert evaluate_guardrails(now, _stats(requests=300), g,
                               canary_baseline=baseline,
                               incumbent_baseline=_stats(
                                   requests=100)) == []


def test_guardrails_flag_p99_regression_with_floor():
    g = Guardrails(max_p99_ratio=3.0, p99_floor_ms=50.0,
                   min_canary_requests=20)
    # canary p99 over 3x incumbent and over the floor: flagged
    vio = evaluate_guardrails(_stats(p99_ms=400.0),
                              _stats(p99_ms=100.0), g)
    assert len(vio) == 1 and "p99" in vio[0]
    # under the floor, microsecond noise never flags even at 100x
    assert evaluate_guardrails(_stats(p99_ms=4.0),
                               _stats(p99_ms=0.01), g) == []
    # within ratio: clean
    assert evaluate_guardrails(_stats(p99_ms=250.0),
                               _stats(p99_ms=100.0), g) == []


# ---------------------------------------------------------------------------
# DeploymentManager — the gauntlet on scriptable fakes
# ---------------------------------------------------------------------------

def _mk_manager(n=3, **mgr_kw):
    router, fakes = _versioned_router([None] * n, seed=11)
    mgr = DeploymentManager(router, **mgr_kw)
    good = lambda feed: [np.asarray(feed["x"], np.float64) * 2.0]
    mgr.register("v1", factory=lambda: "eng-v1", eval_fn=good)
    mgr.register("v2", factory=lambda: "eng-v2", eval_fn=good)
    mgr.set_incumbent("v1")
    mgr.record_golden([{"x": np.full((1, 4), float(i))}
                       for i in range(4)])
    return mgr, router, fakes


def test_set_incumbent_labels_pool_and_owns_traffic():
    mgr, router, fakes = _mk_manager()
    assert all(r.version == "v1" for r in fakes)
    assert router.weights() == {"v1": 1.0}
    assert mgr.incumbent == "v1" and mgr.canary is None


def test_deploy_canary_is_dark_and_accepted():
    mgr, router, fakes = _mk_manager()
    report = mgr.deploy_canary("v2", replicas=1)
    assert report["accepted"] and report["rewarm_compiles"] == 0
    assert report["numerics"]["ok"]
    # exactly one replica converted, by the drain choreography
    canaries = [r for r in fakes if r.version == "v2"]
    assert len(canaries) == 1
    assert canaries[0].drained == 1
    assert canaries[0].rebuilt_with == [mgr.version("v2").factory]
    # the canary is DARK: incumbent owns the whole weight map
    assert router.weights() == {"v1": 1.0}
    assert set(_routed_versions(router, 100)) == {"v1"}
    assert mgr.canary == "v2"


def test_deploy_canary_guards_registry_and_sizing():
    mgr, _, _ = _mk_manager()
    with pytest.raises(DeploymentError):
        mgr.deploy_canary("v1")              # already the incumbent
    with pytest.raises(DeploymentError):
        mgr.deploy_canary("nope")            # unregistered
    with pytest.raises(DeploymentError):
        mgr.deploy_canary("v2", replicas=3)  # nothing left incumbent
    mgr.deploy_canary("v2", replicas=1)
    with pytest.raises(DeploymentError):
        mgr.deploy_canary("v2")              # one canary at a time
    with pytest.raises(DeploymentError):
        mgr.set_incumbent("v2")              # not while canary active


def test_deploy_without_golden_set_is_a_hard_error():
    router, _ = _versioned_router([None, None])
    mgr = DeploymentManager(router)
    mgr.register("v1", factory=lambda: "e1", eval_fn=lambda f: [f["x"]])
    mgr.register("v2", factory=lambda: "e2", eval_fn=lambda f: [f["x"]])
    mgr.set_incumbent("v1")
    with pytest.raises(DeploymentError, match="golden"):
        mgr.deploy_canary("v2")


def test_fault_point_rejects_canary_before_traffic():
    """serving_canary_regression perturbs the canary's golden replay —
    the pre-traffic gate must auto-reject and roll back on its own."""
    assert "serving_canary_regression" in faultinject.KNOWN_POINTS
    mgr, router, fakes = _mk_manager()
    faultinject.arm("serving_canary_regression", at=0, times=100)
    report = mgr.deploy_canary("v2", replicas=1)
    faultinject.disarm()
    assert not report["accepted"]
    assert report["rejected"] == "numerics"
    rb = report["rollback"]
    assert rb["action"] == "rollback"
    assert rb["rewarm_compiles"] == 0
    # rolled all the way home: pool relabeled, weights repointed,
    # no canary left active, history remembers both acts
    assert all(r.version == "v1" for r in fakes)
    assert router.weights() == {"v1": 1.0}
    assert mgr.canary is None and mgr.incumbent == "v1"
    assert [h["action"] for h in mgr.history[-2:]] \
        == ["rollback", "deploy_canary"] or \
        [h["action"] for h in mgr.history[-2:]] \
        == ["deploy_canary", "rollback"]


def test_lying_eval_fn_rejected_at_ramp_stage():
    """A canary that passes at t=0 but regresses in flight is caught
    by the per-stage numerics RE-sample."""
    mgr, router, fakes = _mk_manager()
    state = {"honest": True}

    def flaky(feed):
        base = np.asarray(feed["x"], np.float64) * 2.0
        return [base if state["honest"] else base + 0.5]
    mgr.version("v2").eval_fn = flaky
    assert mgr.deploy_canary("v2", replicas=1)["accepted"]
    state["honest"] = False          # regress AFTER the dark gate
    report = mgr.promote(stages=(0.5, 1.0), stage_s=0.05, poll_s=0.01)
    assert not report["accepted"]
    assert report["rejected"] == "numerics"
    assert report["stage"] == 0.5
    assert all(r.version == "v1" for r in fakes)
    assert router.weights() == {"v1": 1.0}


def test_guardrail_regression_rejected_mid_ramp():
    mgr, router, fakes = _mk_manager(
        guardrails=Guardrails(max_error_rate_delta=0.02,
                              min_canary_requests=20))
    assert mgr.deploy_canary("v2", replicas=1)["accepted"]

    def observe(stage):
        # script the stage's traffic: the canary replica errors on
        # half its requests, the incumbents stay clean
        for r in fakes:
            m = r.metrics_obj()
            m.incr("requests_total", 60)
            if r.version == "v2":
                m.incr("errors_total", 30)
    report = mgr.promote(stages=(0.01, 1.0), stage_s=0.05,
                         poll_s=0.01, observe=observe)
    assert not report["accepted"]
    assert report["rejected"] == "guardrails"
    assert "error-rate" in report["reason"]
    assert all(r.version == "v1" for r in fakes)


def test_full_promotion_relabels_pool_and_repoints():
    mgr, router, fakes = _mk_manager()
    assert mgr.deploy_canary("v2", replicas=1)["accepted"]
    report = mgr.promote(stages=(0.01, 0.5, 1.0), stage_s=0.02,
                         poll_s=0.01)
    assert report["accepted"]
    assert len(report["timeline"]) == 2        # two gated sub-1.0 stages
    assert all(e["numerics"]["ok"] and not e["violations"]
               for e in report["timeline"])
    assert all(r.version == "v2" for r in fakes)
    assert router.weights() == {"v2": 1.0}
    assert mgr.incumbent == "v2" and mgr.canary is None
    assert report["rewarm_compiles"] == 0
    with pytest.raises(DeploymentError):
        mgr.promote()                          # nothing left to promote


def test_operator_rollback_and_status_views():
    mgr, router, fakes = _mk_manager()
    mgr.deploy_canary("v2", replicas=1)
    router.set_weights({"v1": 0.5, "v2": 0.5})
    for i in range(40):
        router.infer({"x": np.full((1, 4), float(i))})
    status = mgr.status()
    assert status["incumbent"] == "v1" and status["canary"] == "v2"
    versions = status["versions"]
    assert versions["v1"]["requests_total"] > 0
    assert versions["v2"]["requests_total"] > 0
    # the combined registry namespaces per version — nothing collides
    combined = status["combined"]
    assert combined["v1/requests_total"] \
        + combined["v2/requests_total"] >= 40
    report = mgr.rollback()
    assert report["reason"] == "operator"
    # repoint rounds to µs, the full rollback to ms — compare with the
    # coarser grain's slack
    assert report["serving_rollback_s"] + 1e-3 >= report["repoint_s"]
    assert report["repoint_s"] >= 0
    assert router.weights() == {"v1": 1.0}
    assert all(r.version == "v1" for r in fakes)


# ---------------------------------------------------------------------------
# ServingMetrics.merge(label=) — the per-version namespace
# ---------------------------------------------------------------------------

def test_labeled_merge_prefixes_counters_and_windows():
    a = ServingMetrics()
    a.incr("requests_total", 5)
    a.observe_latency(0.010)
    a.observe_window("ttft_s", 0.25)
    snap = ServingMetrics.merge(a, label="v2").stats()
    assert snap["v2/requests_total"] == 5
    assert snap["v2/request_latency"]["count"] == 1
    assert snap["v2/ttft_s"]["count"] == 1
    # the BASE counters of the merged registry stay untouched at 0 —
    # labeled merges never launder samples into the root namespace
    assert snap["requests_total"] == 0
    assert snap["request_latency"]["count"] == 0


def test_labeled_merges_compose_without_collision():
    v1, v2 = ServingMetrics(), ServingMetrics()
    v1.incr("errors_total", 3)
    v2.incr("errors_total", 7)
    combined = ServingMetrics.merge(
        ServingMetrics.merge(v1, label="v1"),
        ServingMetrics.merge(v2, label="v2")).stats()
    assert combined["v1/errors_total"] == 3
    assert combined["v2/errors_total"] == 7
    assert combined["errors_total"] == 0


def test_labeled_merge_empty_and_non_finite_windows():
    empty = ServingMetrics()
    snap = ServingMetrics.merge(empty, label="v9").stats()
    assert snap["v9/requests_total"] == 0
    assert snap["v9/request_latency"] == {"p50_ms": None,
                                          "p95_ms": None,
                                          "p99_ms": None, "count": 0}
    dirty = ServingMetrics()
    with dirty._lock:
        dirty._latencies.extend([0.010, float("nan"), float("inf")])
    snap = ServingMetrics.merge(dirty, label="v9").stats()
    assert snap["v9/request_latency"]["count"] == 1
    assert snap["v9/request_latency"]["p50_ms"] == pytest.approx(10.0)


# ---------------------------------------------------------------------------
# export stamps: monotonic model_version + the golden set on disk
# ---------------------------------------------------------------------------

def _export_tiny(model_dir, **save_kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        pred = fluid.layers.fc(x, size=3, act="softmax")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(
            model_dir, ["x"], [pred], exe,
            main_program=main.clone(for_test=True), **save_kw)


def _meta_version(model_dir):
    with open(os.path.join(model_dir, "__meta__.json")) as f:
        return json.load(f)["model_version"]


def test_model_version_auto_bumps_monotonically(tmp_path):
    model_dir = str(tmp_path / "m")
    _export_tiny(model_dir)
    assert _meta_version(model_dir) == 1
    _export_tiny(model_dir)                      # re-export: bump
    assert _meta_version(model_dir) == 2
    _export_tiny(model_dir, model_version=7)     # jump ahead: fine
    assert _meta_version(model_dir) == 7
    _export_tiny(model_dir)
    assert _meta_version(model_dir) == 8
    with pytest.raises(ValueError, match="monotonic"):
        _export_tiny(model_dir, model_version=3)  # never backwards
    assert _meta_version(model_dir) == 8          # refused ≠ clobbered


def test_model_version_surfaces_in_engine_stats(tmp_path):
    from paddle_tpu_torch.serving import ServingEngine
    model_dir = str(tmp_path / "m")
    _export_tiny(model_dir, model_version=42)
    eng = ServingEngine.from_saved_model(model_dir,
                                         place=fluid.CPUPlace())
    try:
        assert eng.model_version == 42
        assert eng.stats()["model_version"] == 42
    finally:
        eng.close()
    # and ModelVersion reads the same stamp (plus the params sha)
    mv = ModelVersion("v42", factory=lambda: None, model_dir=model_dir)
    assert mv.model_version == 42
    assert mv.params_sha
    assert not mv.has_artifacts          # no store in this export
    assert mv.snapshot()["model_version"] == 42


def test_membership_view_reports_member_model_version():
    class StatsFake:
        name = "m0"
        addr = None
        stale_after_s = None
        _last_stats = {"model_version": 3}
        _last_seen = None

        def refresh(self):
            return True

        def health_state(self):
            return HealthState.READY

        def alive(self):
            return True

        def outstanding(self):
            return 0

    membership = Membership([StatsFake()], refresh_interval_s=0)
    assert membership.view()[0]["model_version"] == 3


def test_golden_set_round_trips_beside_the_model(tmp_path):
    model_dir = str(tmp_path / "m")
    _export_tiny(model_dir)
    assert fluid.io.load_golden_set(model_dir) is None
    feeds = [{"img/raw": np.arange(4, dtype=np.float32).reshape(1, 4)},
             {"img/raw": np.zeros((1, 4), np.float32)}]
    outputs = [[np.full((1, 3), 0.5, np.float32)],
               [np.full((1, 3), 0.25, np.float32),
                np.ones((2, 2), np.float64)]]
    fluid.io.save_golden_set(model_dir, feeds, outputs)
    got_feeds, got_outputs = fluid.io.load_golden_set(model_dir)
    assert len(got_feeds) == 2 and len(got_outputs) == 2
    # slash-bearing feed names survive the npz key encoding
    np.testing.assert_array_equal(got_feeds[0]["img/raw"],
                                  feeds[0]["img/raw"])
    assert [len(row) for row in got_outputs] == [1, 2]
    for want_row, got_row in zip(outputs, got_outputs):
        for want, got in zip(want_row, got_row):
            np.testing.assert_array_equal(want, got)
    # a ModelVersion over the dir picks the disk golden up
    mv = ModelVersion("g", factory=lambda: None, model_dir=model_dir)
    g_feeds, g_outs = mv.golden()
    assert len(g_feeds) == 2
    # ...unless an explicit in-memory golden was pinned
    mv.set_golden(feeds[:1], outputs[:1])
    assert len(mv.golden()[0]) == 1
