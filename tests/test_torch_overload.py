"""Graceful degradation under overload, the torch port on the CPU: the
cases of tests/test_overload.py for the controllers
(serving/overload.py: AdmissionController, BrownoutController,
RetryBudget on fake clocks), ``ServingMetrics.merge`` over the overload
counters, and the decode engine's priority eviction and brownout ladder
(a tiny paged engine with ``auto_start=False``, on the reference's
generator weights carried across as numpy).

The reference's Router cases (tiered shed, SLO priority resolution, the
retry-storm budget, hedging, redrive inheritance) need ``cluster/``,
and its trace-helper cases test ``tools/servebench.py``: both wait for
ROADMAP.md item 'Fleet and analyzers'.
"""
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
