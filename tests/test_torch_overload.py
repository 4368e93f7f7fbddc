"""Graceful degradation under overload, the torch port on the CPU: the
cases of tests/test_overload.py for the controllers
(serving/overload.py: AdmissionController, BrownoutController,
RetryBudget on fake clocks), ``ServingMetrics.merge`` over the overload
counters, and the decode engine's priority eviction and brownout ladder
(a tiny paged engine with ``auto_start=False``, on the reference's
generator weights carried across as numpy).

The reference's Router cases (tiered shed, SLO priority resolution, the
retry-storm budget, hedging, redrive inheritance) run on the port's
``cluster.Router`` against the same fake replicas, and its trace-helper
cases on the port's copy of ``tools/servebench.py``'s three helpers
(``tests/torch_traces.py``), over the shipped trace under
``tools/traces/``.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      QueueFullError, SLOClass)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.overload import (AdmissionController,
                                               BROWNOUT_STEPS,
                                               BrownoutController,
                                               RetryBudget, shed_counter)
from paddle_tpu_torch.serving.sched import PRIORITIES
from paddle_tpu_torch.cluster import ClusterOverloadError, Router
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.serving.batching import RequestTimeoutError
from paddle_tpu_torch.serving.health import HealthState, WorkerDiedError
from paddle_tpu_torch.serving.overload import RetryBudgetExhaustedError

torch.set_num_threads(1)

pytestmark = pytest.mark.serving


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------
# AdmissionController (fake clock, no threads)
# ---------------------------------------------------------------------

def test_admission_aimd_additive_up_multiplicative_down():
    clk = FakeClock()
    ac = AdmissionController(hard_ceiling=32, target_delay_s=0.5,
                             start_limit=8, interval_s=0.25,
                             min_limit=4, clock=clk)
    assert ac.limit() == 8.0
    # within the adapt interval: observe feeds the EWMA, limit holds
    ac.observe(0.1)
    assert ac.limit() == 8.0
    # under target + interval elapsed -> additive +1
    clk.advance(0.3)
    ac.observe(0.1)
    assert ac.limit() == 9.0
    # a sojourn spike pushes the EWMA over target -> x0.7 cut
    clk.advance(0.3)
    ac.observe(5.0)
    assert ac.limit() == pytest.approx(9.0 * 0.7)
    # sustained overload decays to min_limit, never below
    for _ in range(20):
        clk.advance(0.3)
        ac.observe(5.0)
    assert ac.limit() == 4.0
    # recovery climbs again, capped at the hard ceiling
    for _ in range(60):
        clk.advance(0.3)
        ac.observe(0.0)
    assert ac.limit() == 32.0


def test_admission_tiers_shed_in_strict_order():
    """Batch refuses first, then standard; interactive admits against
    the hard ceiling itself (the AIMD limit never throttles it)."""
    clk = FakeClock()
    ac = AdmissionController(hard_ceiling=16, start_limit=4, clock=clk)
    # limit 4: batch band 2.4, standard band 3.4, interactive 16
    assert not ac.admit(PRIORITIES["batch"], 3)
    assert ac.admit(PRIORITIES["standard"], 3)
    assert not ac.admit(PRIORITIES["standard"], 4)
    assert ac.admit(PRIORITIES["interactive"], 4)
    assert ac.admit(PRIORITIES["interactive"], 15)
    # ... but the fixed ceiling still binds interactive
    assert not ac.admit(PRIORITIES["interactive"], 16)
    snap = ac.snapshot()
    assert snap["admitted_total"] == 3
    assert snap["refused_total"] == 3
    assert snap["hard_ceiling"] == 16
    # an unknown (worse-than-batch) rank uses the batch fraction
    assert not ac.admit(7, 3)


def test_admission_validation_and_bad_samples():
    with pytest.raises(ValueError):
        AdmissionController(hard_ceiling=None)
    with pytest.raises(ValueError):
        AdmissionController(hard_ceiling=0)
    with pytest.raises(ValueError):
        AdmissionController(hard_ceiling=8, decrease=1.5)
    ac = AdmissionController(hard_ceiling=8, start_limit=6)
    ac.observe(float("nan"))
    ac.observe(-1.0)
    assert ac.snapshot()["sojourn_ewma_s"] is None
    assert ac.limit() == 6.0


# ---------------------------------------------------------------------
# BrownoutController (fake clock)
# ---------------------------------------------------------------------

def test_brownout_ladder_one_rung_per_call_with_dwell():
    clk = FakeClock()
    bo = BrownoutController(engage_at=0.8, revert_at=0.4, dwell_s=1.0,
                            clock=clk)
    assert bo.update(0.9) == (0, 0)       # dwell not yet served
    clk.advance(1.0)
    assert bo.update(0.9) == (0, 1)
    assert bo.update(0.9) == (1, 1)       # same instant: dwell again
    clk.advance(1.0)
    assert bo.update(0.9) == (1, 2)
    clk.advance(1.0)
    assert bo.update(0.9) == (2, 3)
    clk.advance(1.0)
    assert bo.update(1.0) == (3, 3)       # ladder top
    assert bo.level() == len(BROWNOUT_STEPS)
    assert all(bo.active(s) for s in BROWNOUT_STEPS)
    # hysteresis band: between revert_at and engage_at nothing moves
    clk.advance(1.0)
    assert bo.update(0.6) == (3, 3)
    # full revert, in reverse, one rung per dwell
    for lv in (2, 1, 0):
        clk.advance(1.0)
        assert bo.update(0.1) == (lv + 1, lv)
    assert bo.level() == 0
    assert not any(bo.active(s) for s in BROWNOUT_STEPS)


def test_brownout_validation():
    with pytest.raises(ValueError):
        BrownoutController(engage_at=0.4, revert_at=0.5)
    bo = BrownoutController()
    with pytest.raises(ValueError):
        bo.active("not_a_step")
    # pressure is clamped into [0, 1]
    bo.update(7.0)
    assert bo.pressure() == 1.0


# ---------------------------------------------------------------------
# RetryBudget
# ---------------------------------------------------------------------

def test_retry_budget_token_bucket():
    rb = RetryBudget(capacity=2, refill_ratio=0.5)
    assert rb.acquire() and rb.acquire()
    assert not rb.acquire()               # spent: fail fast
    snap = rb.snapshot()
    assert snap["acquired_total"] == 2 and snap["exhausted_total"] == 1
    rb.note_success()
    rb.note_success()                     # two successes = one token
    assert rb.tokens() == 1.0
    assert rb.acquire()
    # refill never exceeds capacity
    for _ in range(10):
        rb.note_success()
    assert rb.tokens() == 2.0
    with pytest.raises(ValueError):
        RetryBudget(capacity=0)
    with pytest.raises(ValueError):
        RetryBudget(capacity=4, refill_ratio=1.5)


def test_shed_counter_vocabulary():
    assert shed_counter(PRIORITIES["interactive"]) \
        == "shed_interactive_total"
    assert shed_counter(PRIORITIES["standard"]) == "shed_standard_total"
    assert shed_counter(PRIORITIES["batch"]) == "shed_batch_total"
    assert shed_counter(99) == "shed_standard_total"


# ---------------------------------------------------------------------
# ServingMetrics.merge over the overload counter vocabulary
# ---------------------------------------------------------------------

_OVERLOAD_COUNTERS = (
    "shed_interactive_total", "shed_standard_total", "shed_batch_total",
    "evictions_total", "brownout_engage_total", "brownout_revert_total",
    "brownout_cap_max_new_total", "brownout_spec_off_total",
    "brownout_chunk_defer_total")


def test_metrics_merge_sums_overload_counters():
    a = ServingMetrics(extra_counters=_OVERLOAD_COUNTERS)
    b = ServingMetrics(extra_counters=_OVERLOAD_COUNTERS)
    a.incr("shed_batch_total", 3)
    a.incr("brownout_engage_total", 2)
    b.incr("shed_batch_total", 2)
    b.incr("brownout_engage_total", 1)
    b.incr("brownout_revert_total", 1)
    merged = ServingMetrics.merge(a, b).stats()
    assert merged["shed_batch_total"] == 5
    assert merged["brownout_engage_total"] == 3
    assert merged["brownout_revert_total"] == 1
    assert merged["shed_interactive_total"] == 0
    # an empty registry (no overload vocabulary at all) merges
    # harmlessly — union-of-vocabularies semantics
    merged2 = ServingMetrics.merge(ServingMetrics(), a).stats()
    assert merged2["shed_batch_total"] == 3


def test_metrics_merge_label_namespaces_overload_counters():
    a = ServingMetrics(extra_counters=_OVERLOAD_COUNTERS)
    a.incr("shed_interactive_total", 4)
    v1 = ServingMetrics.merge(a, label="v1")
    v2 = ServingMetrics.merge(ServingMetrics(
        extra_counters=_OVERLOAD_COUNTERS), label="v2")
    both = ServingMetrics.merge(v1, v2).stats()
    # the canary's sheds never launder into the incumbent's
    assert both["v1/shed_interactive_total"] == 4
    assert both["v2/shed_interactive_total"] == 0
    assert "shed_interactive_total" not in both


def test_metrics_merge_empty_and_nonfinite_windows():
    a = ServingMetrics(extra_counters=_OVERLOAD_COUNTERS)
    a.observe_window("interactive.ttft_s", float("nan"))  # dropped
    a.observe_window("interactive.ttft_s", 0.5)
    # a poisoned reservoir (injected past the door check) must still
    # merge into finite percentiles
    with a._lock:
        a._windows["interactive.ttft_s"].append(float("inf"))
    b = ServingMetrics()                       # empty: no windows
    snap = ServingMetrics.merge(a, b).stats()
    w = snap["interactive.ttft_s"]
    assert w["count"] == 1 and w["p50_ms"] == pytest.approx(500.0)
    empty = ServingMetrics.merge(b).stats()
    assert empty["request_latency"]["count"] == 0


def test_metrics_counter_deltas_cover_overload_vocabulary():
    m = ServingMetrics(extra_counters=_OVERLOAD_COUNTERS)
    before = m.stats()
    m.incr("shed_standard_total")
    m.incr("brownout_cap_max_new_total", 2)
    d = m.counter_deltas(before)
    assert d["shed_standard_total"] == 1
    assert d["brownout_cap_max_new_total"] == 2
    assert d["shed_batch_total"] == 0


# ---------------------------------------------------------------------
# Engine-level: priority eviction + brownout effects (tiny model)
# ---------------------------------------------------------------------

CFG_KW = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
              ffn_hidden=64, dtype="float32")
CFG = LlamaConfig(**CFG_KW)


@pytest.fixture(scope="module")
def served_scope():
    gen_p, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(gen_p, startup):
        ptok = jfluid.layers.data(name="ptok", shape=[1, 6],
                                  dtype="int64", append_batch_size=False)
        jllama.build_llama_generator(jllama.LlamaConfig(**CFG_KW), ptok,
                                     max_new_tokens=2)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()
              if jscope.find_var(n) is not None}
    return weights.load_state(fluid.Scope(), arrays, torch.device("cpu"))


def _slo(priority):
    return SLOClass(name=priority, priority=priority)


def _prompt(rng):
    return rng.randint(0, CFG.vocab_size, (4,)).astype(np.int64)


def test_engine_priority_eviction_order(served_scope):
    """A full admission queue evicts strictly by priority: batch
    leaves first, interactive never yields to anything."""
    eng = DecodeEngine(
        CFG, scope=served_scope, place=fluid.CPUPlace(),
        config=DecodeConfig(max_batch=2, prompt_buckets=(4, 8),
                            max_new_tokens=8, page_size=8,
                            decode_block=4, prefill_batch=2,
                            max_queue=2, default_timeout_s=5.0),
        auto_start=False)               # queue never drains: exact state
    rng = np.random.RandomState(0)
    try:
        before = eng.metrics.stats()
        eng.submit(_prompt(rng), slo=_slo("batch"))
        b2 = eng.submit(_prompt(rng), slo=_slo("batch"))
        # interactive displaces the NEWEST worst-tier request (oldest
        # work in a class keeps its place), typed as a shed
        eng.submit(_prompt(rng), slo=_slo("interactive"))
        with pytest.raises(QueueFullError):
            b2.result(0)
        # equal rank never evicts: the new batch request sheds instead
        with pytest.raises(QueueFullError):
            eng.submit(_prompt(rng), slo=_slo("batch"))
        # standard outranks the remaining batch request
        eng.submit(_prompt(rng), slo=_slo("standard"))
        # queue is now [interactive, standard]: interactive arrivals
        # evict standard, and nothing can evict interactive
        eng.submit(_prompt(rng), slo=_slo("interactive"))
        with pytest.raises(QueueFullError):
            eng.submit(_prompt(rng), slo=_slo("interactive"))
        d = eng.metrics.counter_deltas(before)
        assert d["evictions_total"] == 3
        assert d["shed_batch_total"] == 3     # 2 evicted + 1 refused
        assert d["shed_standard_total"] == 1  # evicted by interactive
        assert d["shed_interactive_total"] == 1   # refused, NOT evicted
    finally:
        eng.close()


def test_engine_brownout_caps_batch_and_fully_reverts(served_scope):
    """Brownout level 1 caps BATCH-tier max_new (counted); other tiers
    are untouched; reverting restores full generation."""
    eng = DecodeEngine(
        CFG, scope=served_scope, place=fluid.CPUPlace(),
        config=DecodeConfig(max_batch=2, prompt_buckets=(4, 8),
                            max_new_tokens=8, page_size=8,
                            decode_block=4, prefill_batch=2,
                            default_timeout_s=5.0,
                            brownout={"engage_at": 0.7,
                                      "revert_at": 0.3,
                                      "dwell_s": 0.0}),
        auto_start=False)
    rng = np.random.RandomState(1)
    try:
        assert eng.brownout is not None
        cap = eng._bo_max_new_cap
        assert cap == 2                       # max_new_tokens // 4
        eng.brownout.update(1.0)              # level 1: cap engages
        assert eng.brownout.active("cap_batch_max_new")
        before = eng.metrics.stats()
        r_batch = eng.submit(_prompt(rng), max_new=8, slo=_slo("batch"))
        r_std = eng.submit(_prompt(rng), max_new=8,
                           slo=_slo("standard"))
        assert r_batch.max_new == cap         # degraded, typed, counted
        assert r_std.max_new == 8             # only batch pays
        d = eng.metrics.counter_deltas(before)
        assert d["brownout_cap_max_new_total"] == 1
        assert eng.stats()["brownout"]["level"] == 1
        # recovery: the cap lifts for new work
        eng.brownout.update(0.0)
        assert eng.brownout.level() == 0
        r_after = eng.submit(_prompt(rng), max_new=8,
                             slo=_slo("batch"))
        assert r_after.max_new == 8
    finally:
        eng.close()


# ---------------------------------------------------------------------
# Router against fake replicas (no engine, no XLA)
# ---------------------------------------------------------------------

class FakeHandle:
    def __init__(self, value="ok", error=None, ready=True):
        self._value, self._error = value, error
        self._ev = threading.Event()
        self._cbs = []
        if ready:
            self.settle()

    def settle(self, value=None):
        if value is not None:
            self._value = value
        self._ev.set()
        for cb in self._cbs:
            cb(self)
        self._cbs = []

    def add_done_callback(self, cb):
        if self._ev.is_set():
            cb(self)
        else:
            self._cbs.append(cb)

    def done(self):
        return self._ev.is_set()

    def wait(self, timeout=None):
        return self._ev.wait(timeout)

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise RequestTimeoutError("fake handle never settled")
        if self._error is not None:
            raise self._error
        return self._value


class FakeReplica:
    """Just enough replica surface for Router: a scripted ``plan`` of
    callables consumed one submit at a time (raise or return a
    handle); every submit's kwargs are recorded for inheritance
    assertions."""

    def __init__(self, name, role=None, outstanding=0, value="ok"):
        self.name, self.role = name, role
        self.version = None
        self.restarting = False
        self._alive = True
        self._out = outstanding
        self.value = value
        self.plan = []
        self.submits = []
        self.handoffs = []

    def alive(self):
        return self._alive

    def outstanding(self):
        return self._out

    def admits(self):
        return True

    def health_state(self):
        return HealthState.READY

    def crash(self):
        self._alive = False

    def submit(self, item, timeout=None, **kw):
        self.submits.append(dict(kw, item=item, timeout=timeout))
        if self.plan:
            return self.plan.pop(0)(self)
        return FakeHandle(value=self.value)

    def handoff(self, state, timeout=None, **kw):
        self.handoffs.append(dict(kw, state=state, timeout=timeout))
        return FakeHandle(value=self.value)

    def metrics_obj(self):
        return None


class FakePool:
    def __init__(self, *replicas):
        self._replicas = list(replicas)
        self.counters = {}

    def replicas(self):
        return list(self._replicas)

    def total_outstanding(self):
        return sum(r.outstanding() for r in self._replicas)

    def incr(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    def stats(self):
        return dict(self.counters)

    def close(self, **kw):
        pass


def test_router_tiered_shed_and_per_class_counts():
    rep = FakeReplica("r0", outstanding=3)
    pool = FakePool(rep)
    router = Router(pool, max_cluster_queue=16,
                    admission=AdmissionController(hard_ceiling=16,
                                                  start_limit=4))
    # limit 4 @ 3 outstanding: batch band 2.4 refuses, standard 3.4
    # admits, interactive rides the ceiling
    with pytest.raises(ClusterOverloadError) as ei:
        router.submit("x", priority="batch")
    assert ei.value.per_class == {"interactive": 0, "standard": 0,
                                  "batch": 0}
    assert router.submit("x", priority="standard").result(1) == "ok"
    assert router.submit("x", priority="interactive").result(1) == "ok"
    # the hard ceiling sheds even interactive — with its own counter
    rep._out = 16
    with pytest.raises(ClusterOverloadError):
        router.submit("x", priority="interactive")
    assert pool.counters["shed_batch_total"] == 1
    assert pool.counters["shed_interactive_total"] == 1
    assert pool.counters.get("shed_standard_total", 0) == 0
    over = router.stats()["overload"]
    assert over["admission"]["refused_total"] == 1
    assert over["shed_by_class"] == {"interactive": 1, "standard": 0,
                                     "batch": 1}
    assert over["retry_budget"] is None


def test_router_slo_priority_resolution():
    """Explicit priority= outranks the SLO's tier; SLO alone sets the
    tier; nothing at all is standard."""
    rep = FakeReplica("r0", outstanding=3)
    router = Router(FakePool(rep), max_cluster_queue=16,
                    admission=AdmissionController(hard_ceiling=16,
                                                  start_limit=4))
    batchy = SLOClass(name="bulk", priority="batch")
    with pytest.raises(ClusterOverloadError):
        router.submit("x", slo=batchy)
    # same SLO, explicitly promoted: admitted, and the SLO still rides
    # to the replica
    router.submit("x", slo=batchy, priority="interactive")
    assert rep.submits[-1]["slo"] is batchy


def test_router_retry_storm_budget_bounds_amplification():
    rep = FakeReplica("r0")
    pool = FakePool(rep)
    router = Router(pool, retry_budget=RetryBudget(capacity=2,
                                                   refill_ratio=0.0))
    try:
        # each armed call: the first attempt's answer drops in flight,
        # the forced retry costs one token
        for _ in range(2):
            faultinject.arm("serving_retry_storm", at=0, times=1)
            assert router.infer("x", timeout=5.0) == "ok"
        faultinject.arm("serving_retry_storm", at=0, times=1)
        with pytest.raises(RetryBudgetExhaustedError) as ei:
            router.infer("x", timeout=5.0)
        assert isinstance(ei.value.__cause__, WorkerDiedError)
        assert pool.counters["retry_budget_exhausted_total"] == 1
        assert pool.counters["failovers_total"] == 2
    finally:
        faultinject.disarm("serving_retry_storm")
    # disarmed: first-try success needs no budget
    assert router.infer("x", timeout=5.0) == "ok"


def test_router_hedges_interactive_tier():
    slow = FakeReplica("slow", outstanding=0)
    fast = FakeReplica("fast", outstanding=1, value="hedged")
    # the primary pick (least outstanding) never answers, and refuses
    # the hedge duplicate so it lands on the fast replica
    slow.plan = [lambda r: FakeHandle(ready=False),
                 lambda r: (_ for _ in ()).throw(
                     QueueFullError("full"))]
    pool = FakePool(slow, fast)
    router = Router(pool, retry_budget=RetryBudget(capacity=4),
                    hedge_delay_s=0.01)
    out = router.infer("x", timeout=5.0, priority="interactive")
    assert out == "hedged"
    assert pool.counters["hedges_total"] == 1
    assert pool.counters["hedge_wins_total"] == 1
    # standard tier never hedges: the slow primary answering late is
    # simply awaited
    slow.plan = []
    assert router.infer("x", timeout=5.0, priority="standard") == "ok"
    assert pool.counters["hedges_total"] == 1


def test_generate_redrive_inherits_deadline_slo_and_age():
    """The deadline/SLO-propagation satellite: a redriven prefill hop
    carries the ORIGINAL deadline's remainder, the original SLO, and
    ``queued_for_s`` backdating — never a fresh clock."""
    p0 = FakeReplica("p0", role="prefill", outstanding=0)
    p1 = FakeReplica("p1", role="prefill", outstanding=1)
    d0 = FakeReplica("d0", role="decode", value="tokens")

    def die_slowly(rep):
        time.sleep(0.05)
        rep.crash()
        raise WorkerDiedError("prefill died mid-request")

    p0.plan = [die_slowly]
    blob = {"kind": "kv_handoff"}
    p1.value = blob
    pool = FakePool(p0, p1, d0)
    router = Router(pool, retry_budget=RetryBudget(capacity=4))
    slo = SLOClass(ttft_target_s=1.0, name="chat",
                   priority="interactive")
    assert router.generate("x", timeout=5.0, slo=slo) == "tokens"
    hop = p1.submits[-1]
    assert hop["prefill_only"] is True
    assert hop["slo"] is slo
    assert hop["queued_for_s"] >= 0.04        # the first hop's burn
    assert hop["timeout"] < 5.0 - 0.04        # remainder, not a reset
    hand = d0.handoffs[-1]
    assert hand["state"] is blob and hand["slo"] is slo
    assert hand["timeout"] < 5.0
    assert pool.counters["handoff_redrives_total"] == 1
    assert pool.counters["handoffs_total"] == 1
    # the redrive consumed budget
    assert router.retry_budget.snapshot()["acquired_total"] == 1


# ---------------------------------------------------------------------
# Overload-trace helpers (the port's copy, tests/torch_traces.py, of
# tools/servebench.py's three)
# ---------------------------------------------------------------------

def test_gen_overload_trace_shape_and_mix():
    from torch_traces import gen_overload_trace
    t = gen_overload_trace(200, 2.0, np.random.RandomState(0))
    assert len(t["offsets"]) == 200
    assert np.all(np.diff(t["offsets"]) >= 0)
    assert set(t["classes"]) == {"interactive", "standard", "batch"}
    assert set(t["buckets"]) <= {8, 16}
    flash = [i for i, p in enumerate(t["phases"]) if p == "flash"]
    assert flash and flash == list(range(flash[0], flash[-1] + 1))
    assert np.array_equal(t["burst"],
                          np.asarray(t["phases"]) == "flash")
    # the flash segment really is denser than its neighbourhood
    flash_rate = len(flash) / (t["offsets"][flash[-1]]
                               - t["offsets"][flash[0]] + 1e-9)
    base_rate = 200 / t["offsets"][-1]
    assert flash_rate > 2.0 * base_rate
    with pytest.raises(ValueError):
        gen_overload_trace(8, 0.0, np.random.RandomState(0))
    with pytest.raises(ValueError):
        gen_overload_trace(8, 1.0, np.random.RandomState(0),
                           mix=(0.5, 0.2, 0.2))


def test_load_rich_trace_roundtrip(tmp_path):
    import json
    from torch_traces import load_rich_trace, load_trace
    doc = {"offsets": [0.0, 0.5, 1.0, 1.5],
           "class": ["interactive", "batch", "standard", "batch"],
           "bucket": [8, 16, 8, 16],
           "phase": ["diurnal", "flash", "flash", "diurnal"]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(doc))
    t = load_rich_trace(p)
    assert list(t["offsets"]) == doc["offsets"]
    assert t["classes"] == doc["class"]
    assert t["buckets"] == doc["bucket"]
    assert list(t["burst"]) == [False, True, True, False]
    offs, burst = load_trace(p)              # back-compat view
    assert list(offs) == doc["offsets"] and list(burst) == list(t["burst"])
    # a bare offset list still parses (the older format)
    p2 = tmp_path / "bare.json"
    p2.write_text(json.dumps([0.0, 1.0]))
    t2 = load_rich_trace(p2)
    assert t2["classes"] is None and not t2["burst"].any()
    # misaligned columns are a hard error, not silent truncation
    doc_bad = dict(doc)
    doc_bad["class"] = doc["class"][:2]
    p3 = tmp_path / "bad.json"
    p3.write_text(json.dumps(doc_bad))
    with pytest.raises(ValueError):
        load_rich_trace(p3)


def test_shipped_flashcrowd_trace_parses():
    import pathlib
    from torch_traces import load_rich_trace
    path = (pathlib.Path(__file__).resolve().parent.parent
            / "tools" / "traces" / "diurnal_flashcrowd.json")
    t = load_rich_trace(path)
    n = len(t["offsets"])
    assert n >= 64
    assert len(t["classes"]) == n and len(t["buckets"]) == n
    assert t["burst"].any() and not t["burst"].all()
    assert set(t["classes"]) == {"interactive", "standard", "batch"}
