"""Continuous-batching decode serving, the JAX package against the torch
port on the CPU: the cases of tests/test_decode_serving.py (paged KV
cache, iteration-level scheduler, and the ``llama_paged_prefill``,
``llama_paged_decode`` and ``llama_paged_spec_step`` ops the engine
dispatches) run on the port's ``DecodeEngine``, plus its parity with
the reference's.

The reference's startup initializes the generator-layout weights and the
scope is carried across as numpy (paddle_tpu_torch.weights), so both
packages serve the same weights. Tolerances: greedy tokens integer-exact
(the port's engine against the port's fused generator, against its own
run-alone tokens, and against the reference ``DecodeEngine`` on the same
prompts); the paged ops' NextTok exact and their live pages within the
f32 tier (rtol 2e-4, atol 2e-5: float32 sums in another order).
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import llama as jllama
from paddle_tpu import serving as jserving

import paddle_tpu_torch as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           build_llama_generator,
                                           copy_weights_as_draft,
                                           quantize_generator_weights)
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.serving import (BucketError, DecodeConfig,
                                      DecodeEngine, PageAllocator,
                                      PagesExhaustedError, QueueFullError,
                                      RequestTimeoutError, WorkerDiedError)

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
              ffn_hidden=64, dtype="float32")
CFG = LlamaConfig(**CFG_KW)
JCFG = jllama.LlamaConfig(**CFG_KW)
GEN_PROMPT, GEN_NEW = 6, 8
POOL_TOL = dict(rtol=2e-4, atol=2e-5)


def _jax_generator_scope(cfg=JCFG, prompt=GEN_PROMPT, new=GEN_NEW):
    """The reference's generator startup run into a fresh JAX scope."""
    gen_p, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(gen_p, startup):
        ptok = jfluid.layers.data(name="ptok", shape=[1, prompt],
                                  dtype="int64", append_batch_size=False)
        jllama.build_llama_generator(cfg, ptok, max_new_tokens=new)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return scope


def _arrays(jscope):
    return {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()
            if jscope.find_var(n) is not None}


def _port_scope(arrays):
    return weights.load_state(fluid.Scope(), arrays, CPU)


@pytest.fixture(scope="module")
def jax_scope():
    return _jax_generator_scope()


@pytest.fixture(scope="module")
def served_scope(jax_scope):
    """The port's scope (the reference's weights) with the port's fused
    generator program, shared by every engine in this module."""
    gen_p, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(gen_p, startup):
        ptok = fluid.layers.data(name="ptok", shape=[1, GEN_PROMPT],
                                 dtype="int64", append_batch_size=False)
        gen_out = build_llama_generator(CFG, ptok, max_new_tokens=GEN_NEW)
    scope = _port_scope(_arrays(jax_scope))
    exe = fluid.Executor(fluid.CPUPlace())
    return scope, exe, gen_p, gen_out


ENGINE_CONF = dict(max_batch=4, prompt_buckets=(4, 8), max_new_tokens=8,
                   page_size=8, decode_block=4, prefill_batch=2,
                   default_timeout_s=120.0)


@pytest.fixture(scope="module")
def engine(served_scope):
    eng = DecodeEngine(CFG, scope=served_scope[0], place=fluid.CPUPlace(),
                       config=DecodeConfig(**ENGINE_CONF))
    eng.warmup()
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def jax_engine(jax_scope):
    eng = jserving.DecodeEngine(JCFG, scope=jax_scope,
                                place=jfluid.CPUPlace(),
                                config=jserving.DecodeConfig(**ENGINE_CONF))
    yield eng
    eng.close()


def _prompts(n, rng, lo=2, hi=8):
    return [rng.randint(0, CFG.vocab_size,
                        (int(rng.randint(lo, hi + 1)),)).astype(np.int64)
            for _ in range(n)]


# ---------------------------------------------------------------------
# page allocator (pure host-side unit tests)
# ---------------------------------------------------------------------

def test_page_allocator_basics():
    al = PageAllocator(n_pages=5, page_size=4)
    assert al.usable_pages == 4          # page 0 reserved
    assert al.pages_for(1) == 1 and al.pages_for(4) == 1
    assert al.pages_for(5) == 2
    got = al.alloc(3)
    assert got == [1, 2, 3] and al.available == 1 and al.in_use == 3
    with pytest.raises(PagesExhaustedError):
        al.alloc(2)
    assert al.available == 1             # failed alloc grants nothing
    al.free([2])
    assert sorted(al.alloc(2)) == [2, 4]


def test_page_allocator_exhaustion_is_queue_full_semantics():
    al = PageAllocator(n_pages=3, page_size=4)
    al.alloc(2)
    with pytest.raises(QueueFullError):   # typed shed, client backs off
        al.alloc(1)


def test_page_allocator_invariants():
    al = PageAllocator(n_pages=4, page_size=2)
    pages = al.alloc(2)
    al.free(pages[:1])
    with pytest.raises(ValueError):       # double free
        al.free(pages[:1])
    with pytest.raises(ValueError):       # null page never returnable
        al.free([0])
    with pytest.raises(ValueError):
        PageAllocator(n_pages=1, page_size=4)


# ---------------------------------------------------------------------
# ServingMetrics percentile windows (pure host-side unit tests)
# ---------------------------------------------------------------------

def test_metrics_stats_safe_on_empty_window():
    from paddle_tpu_torch.serving import ServingMetrics
    m = ServingMetrics()
    snap = m.stats()
    for window in ("request_latency", "batch_latency"):
        assert snap[window] == {"p50_ms": None, "p95_ms": None,
                                "p99_ms": None, "count": 0}


def test_metrics_stats_one_sample_window():
    from paddle_tpu_torch.serving import ServingMetrics
    m = ServingMetrics()
    m.observe_latency(0.25)
    m.observe_window("ttft_s", 0.5)
    snap = m.stats()
    lat = snap["request_latency"]
    assert lat["count"] == 1
    assert lat["p50_ms"] == lat["p95_ms"] == lat["p99_ms"] == 250.0
    assert snap["ttft_s"] == {"p50_ms": 500.0, "p95_ms": 500.0,
                              "p99_ms": 500.0, "count": 1}


def test_metrics_nonfinite_samples_never_poison_percentiles():
    from paddle_tpu_torch.serving import ServingMetrics
    m = ServingMetrics()
    m.observe_window("ttft_s", float("nan"))
    m.observe_window("ttft_s", float("inf"))
    assert "ttft_s" not in m.stats()     # nothing admitted, no window
    m.observe_window("ttft_s", 0.1)
    snap = m.stats()["ttft_s"]
    assert snap["count"] == 1 and snap["p99_ms"] == 100.0


def test_metrics_counter_deltas_include_extra_counters():
    from paddle_tpu_torch.serving import ServingMetrics
    m = ServingMetrics(extra_counters=("generated_tokens_total",))
    before = m.stats()
    m.incr("generated_tokens_total", 7)
    assert m.counter_deltas(before)["generated_tokens_total"] == 7


# ---------------------------------------------------------------------
# engine correctness
# ---------------------------------------------------------------------

def test_engine_matches_fused_generator(served_scope, engine, jax_scope):
    """The paged step programs serve the exact greedy tokens the fused
    llama_generate program gives from the same scope, in the port and
    in the reference."""
    scope, exe, gen_p, gen_out = served_scope
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, CFG.vocab_size, (1, GEN_PROMPT)).astype(
        np.int64)
    ref = exe.run(gen_p, feed={"ptok": prompt}, fetch_list=[gen_out],
                  scope=scope, mode="test")[0]
    got = engine.generate(prompt[0], max_new=GEN_NEW, timeout=120)
    np.testing.assert_array_equal(got, ref[0, GEN_PROMPT:])
    jgen_p = jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(
            jgen_p, jfluid.Program()):
        ptok = jfluid.layers.data(name="ptok", shape=[1, GEN_PROMPT],
                                  dtype="int64", append_batch_size=False)
        jout = jllama.build_llama_generator(JCFG, ptok,
                                            max_new_tokens=GEN_NEW)
    jref = np.asarray(jfluid.Executor(jfluid.CPUPlace()).run(
        jgen_p, feed={"ptok": prompt}, fetch_list=[jout], scope=jax_scope,
        mode="test")[0])
    np.testing.assert_array_equal(got, jref[0, GEN_PROMPT:])


def test_churn_no_recompiles_and_bit_identical(engine):
    """3x max_batch requests of varied lengths and max_new join and
    leave mid-stream: no step build, and every request's tokens equal
    its run-alone tokens exactly."""
    rng = np.random.RandomState(1)
    prompts = _prompts(3 * engine.config.max_batch, rng)
    new_lens = [int(rng.randint(2, 9)) for _ in prompts]
    counts_before = engine.exe.compile_counts()
    reqs = [engine.submit(p, max_new=n, timeout=120)
            for p, n in zip(prompts, new_lens)]
    together = [r.result(120) for r in reqs]
    alone = [engine.generate(p, max_new=n, timeout=120)
             for p, n in zip(prompts, new_lens)]
    assert engine.exe.compile_counts() == counts_before
    engine.assert_no_recompiles()
    for a, b, n in zip(together, alone, new_lens):
        assert len(a) == n
        np.testing.assert_array_equal(a, b)
    st = engine.stats()
    assert st["responses_total"] >= 2 * len(prompts)
    assert st["ttft_s"]["count"] >= 2 * len(prompts)
    assert st["pages_in_use"] == 0       # everything retired and freed


def test_churn_tokens_equal_the_reference_engine(engine, jax_engine):
    """The same churn wave through the reference DecodeEngine and the
    port's (both on the CPU, the same weights): every request's tokens
    integer-exact."""
    rng = np.random.RandomState(11)
    prompts = _prompts(3 * engine.config.max_batch, rng)
    new_lens = [int(rng.randint(2, 9)) for _ in prompts]
    want = [r.result(120) for r in [jax_engine.submit(p, max_new=n,
                                                      timeout=120)
                                    for p, n in zip(prompts, new_lens)]]
    got = [r.result(120) for r in [engine.submit(p, max_new=n, timeout=120)
                                   for p, n in zip(prompts, new_lens)]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_live_pages_equal_the_reference_engine(jax_scope, served_scope):
    """Mid-stream, after churn, every page a live request holds equals
    the reference engine's page (same allocator, same prompts, the same
    dispatch sequence: auto_start off, stepped by hand), within the f32
    tier; page 0 (the null page) is never compared — nothing reads it."""
    conf = dict(ENGINE_CONF, max_batch=2, prefill_batch=2)
    jeng = jserving.DecodeEngine(JCFG, scope=jax_scope,
                                 place=jfluid.CPUPlace(),
                                 config=jserving.DecodeConfig(**conf),
                                 auto_start=False)
    teng = DecodeEngine(CFG, scope=served_scope[0], place=fluid.CPUPlace(),
                        config=DecodeConfig(**conf), auto_start=False)
    rng = np.random.RandomState(12)
    prompts = _prompts(4, rng, lo=3, hi=8)
    try:
        for eng in (jeng, teng):
            policy = eng.config.retry_policy
            for p in prompts[:2]:           # churn: two requests retire
                eng.submit(p, max_new=2, timeout=120)
            for _ in range(3):
                eng._admit(policy)
                eng._step(policy)
            for p in prompts[2:]:           # two more reuse their pages
                eng.submit(p, max_new=8, timeout=120)
            eng._admit(policy)
            eng._step(policy)
        live = sorted(pg for s in teng.slots if s is not None
                      for pg in s.pages)
        assert live and live == sorted(pg for s in jeng.slots
                                       if s is not None for pg in s.pages)
        for tpool, jpool in ((teng._kp, jeng._kp), (teng._vp, jeng._vp)):
            np.testing.assert_allclose(tpool[:, live].numpy(),
                                       np.asarray(jpool)[:, live],
                                       **POOL_TOL)
    finally:
        jeng.close()
        teng.close()


def test_submit_validation(engine):
    with pytest.raises(BucketError):
        engine.submit(np.zeros(9, np.int64))      # > largest bucket
    with pytest.raises(ValueError):
        engine.submit(np.zeros(0, np.int64))
    with pytest.raises(ValueError):
        engine.submit(np.zeros(4, np.int64), max_new=99)


# ---------------------------------------------------------------------
# page pool under pressure: exhaustion, reuse, deadlines, eos
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tight_engine(served_scope):
    """Pool sized for ONE active request (3 usable pages), so admission
    waits for retirement and pages get reused at once."""
    eng = DecodeEngine(
        CFG, scope=served_scope[0], place=fluid.CPUPlace(),
        config=DecodeConfig(max_batch=2, prompt_buckets=(8,),
                            max_new_tokens=6, page_size=8,
                            decode_block=3, prefill_batch=1,
                            n_pages=4, default_timeout_s=120.0))
    eng.warmup()
    yield eng
    eng.close()


def test_never_fits_sheds_with_queue_full_semantics(served_scope):
    """A request that can never fit the page pool sheds at submit with
    QueueFullError semantics (PagesExhaustedError): no queueing, no
    compute, no step build."""
    eng = DecodeEngine(
        CFG, scope=served_scope[0], place=fluid.CPUPlace(),
        config=DecodeConfig(max_batch=2, prompt_buckets=(8,),
                            max_new_tokens=6, page_size=8, n_pages=3,
                            decode_block=3, prefill_batch=1),
        auto_start=False)
    assert eng._pages_needed(8, 6) > eng.allocator.usable_pages
    with pytest.raises(PagesExhaustedError):
        eng.submit(np.zeros(8, np.int64), max_new=6, timeout=5)
    with pytest.raises(QueueFullError):   # the same typed contract
        eng.submit(np.zeros(8, np.int64), max_new=6, timeout=5)
    assert eng.stats()["shed_total"] == 2
    assert eng.exe.total_compiles() == 0
    eng.close()


def test_transient_exhaustion_queues_and_reuses_pages(tight_engine):
    """Three requests through a one-request pool: admission waits for
    pages, retirement frees them, and the request that reuses a retired
    request's pages gives its run-alone tokens exactly (stale page
    contents lie behind the length mask)."""
    rng = np.random.RandomState(2)
    prompts = _prompts(3, rng, lo=4, hi=8)
    reqs = [tight_engine.submit(p, max_new=4, timeout=120)
            for p in prompts]
    together = [r.result(120) for r in reqs]
    alone = [tight_engine.generate(p, max_new=4, timeout=120)
             for p in prompts]
    for a, b in zip(together, alone):
        np.testing.assert_array_equal(a, b)
    st = tight_engine.stats()
    assert st["page_wait_total"] >= 1     # admission actually waited
    assert st["pages_in_use"] == 0
    tight_engine.assert_no_recompiles()


def test_deadline_in_queue_times_out(tight_engine):
    """A request whose deadline expires while it waits for pages is
    swept with RequestTimeoutError, not served stale."""
    rng = np.random.RandomState(3)
    long_req = tight_engine.submit(
        rng.randint(0, CFG.vocab_size, (8,)).astype(np.int64),
        max_new=6, timeout=120)
    starved = tight_engine.submit(
        rng.randint(0, CFG.vocab_size, (8,)).astype(np.int64),
        max_new=6, timeout=0.001)
    with pytest.raises(RequestTimeoutError):
        starved.result(30)
    assert len(long_req.result(120)) == 6


def test_eos_retires_early(served_scope, jax_scope):
    """eos_id retires a sequence at the step it is emitted; the kept
    prefix equals the no-eos run's, and the reference engine's with the
    same eos."""
    scope = served_scope[0]
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, CFG.vocab_size, (5,)).astype(np.int64)
    conf = dict(max_batch=2, prompt_buckets=(8,), max_new_tokens=8,
                page_size=8, decode_block=2, prefill_batch=1,
                default_timeout_s=120.0)
    plain = DecodeEngine(CFG, scope=scope, place=fluid.CPUPlace(),
                         config=DecodeConfig(**conf))
    try:
        full = plain.generate(prompt, max_new=8, timeout=120)
    finally:
        plain.close()
    eos = int(full[3])                    # force an eos mid-stream
    eng = DecodeEngine(CFG, scope=scope, place=fluid.CPUPlace(),
                       config=DecodeConfig(eos_id=eos, **conf))
    jeng = jserving.DecodeEngine(
        JCFG, scope=jax_scope, place=jfluid.CPUPlace(),
        config=jserving.DecodeConfig(eos_id=eos, **conf))
    try:
        got = eng.generate(prompt, max_new=8, timeout=120)
        want = jeng.generate(prompt, max_new=8, timeout=120)
    finally:
        eng.close()
        jeng.close()
    first = int(np.where(full == eos)[0][0])
    np.testing.assert_array_equal(got, full[:first + 1])
    assert got[-1] == eos
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------
# speculative engine mode
# ---------------------------------------------------------------------

def test_spec_mode_matches_greedy(served_scope, engine):
    """Speculative decoding as an engine mode (the target as its own
    draft): token streams equal the plain engine's, rows advancing at
    full gamma + 1 acceptance."""
    scope = served_scope[0]
    copy_weights_as_draft(scope)
    rng = np.random.RandomState(5)
    prompts = _prompts(6, rng, lo=3, hi=8)
    greedy = [engine.generate(p, max_new=6, timeout=120)
              for p in prompts]
    spec = DecodeEngine(
        CFG, scope=scope, place=fluid.CPUPlace(), draft_cfg=CFG,
        config=DecodeConfig(max_batch=4, prompt_buckets=(8,),
                            max_new_tokens=6, page_size=8, gamma=3,
                            prefill_batch=2, default_timeout_s=120.0))
    try:
        spec.warmup()
        reqs = [spec.submit(p, max_new=6, timeout=120) for p in prompts]
        got = [r.result(120) for r in reqs]
        spec.assert_no_recompiles()
        st = spec.stats()
    finally:
        spec.close()
    for a, b in zip(got, greedy):
        np.testing.assert_array_equal(a, b)
    # a perfect draft: every round advances gamma + 1 tokens
    assert st["spec_rounds_total"] > 0
    assert (st["spec_tokens_accepted_total"]
            == (spec.config.gamma + 1) * st["spec_rounds_total"])


# ---------------------------------------------------------------------
# int8 weight serving through the paged programs
# ---------------------------------------------------------------------

def test_quantized_engine_matches_quantized_generator(served_scope,
                                                      jax_scope):
    """quantize=True serves the W8A8 scope with the tokens of
    build_llama_generator(quantize=True) (qmat is shared), and of the
    reference's quantized engine on its own quantized scope."""
    base_scope, exe, _, _ = served_scope
    scope = _port_scope(weights.dump_state(base_scope))
    quantize_generator_weights(scope)
    qgen, qstart = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(qgen, qstart):
        ptok = fluid.layers.data(name="qtok", shape=[1, 6],
                                 dtype="int64", append_batch_size=False)
        qout = build_llama_generator(CFG, ptok, max_new_tokens=4,
                                     quantize=True)
    rng = np.random.RandomState(6)
    prompt = rng.randint(0, CFG.vocab_size, (1, 6)).astype(np.int64)
    ref = exe.run(qgen, feed={"qtok": prompt}, fetch_list=[qout],
                  scope=scope, mode="test")[0]
    conf = dict(max_batch=2, prompt_buckets=(8,), max_new_tokens=4,
                page_size=8, decode_block=2, prefill_batch=1,
                quantize=True, default_timeout_s=120.0)
    eng = DecodeEngine(CFG, scope=scope, place=fluid.CPUPlace(),
                       config=DecodeConfig(**conf))
    jscope = jfluid.Scope()
    for name, arr in _arrays(jax_scope).items():
        jscope.set(name, arr)
    jllama.quantize_generator_weights(jscope)
    jeng = jserving.DecodeEngine(JCFG, scope=jscope,
                                 place=jfluid.CPUPlace(),
                                 config=jserving.DecodeConfig(**conf))
    try:
        got = eng.generate(prompt[0], max_new=4, timeout=120)
        want = jeng.generate(prompt[0], max_new=4, timeout=120)
    finally:
        eng.close()
        jeng.close()
    np.testing.assert_array_equal(got, ref[0, 6:])
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------
# chaos: a worker crash loses nothing
# ---------------------------------------------------------------------

def test_worker_crash_zero_lost_requests(served_scope):
    """serving_worker_crash mid-stream: every submitted request settles
    with a result or a typed error, and start() revives the engine."""
    eng = DecodeEngine(
        CFG, scope=served_scope[0], place=fluid.CPUPlace(),
        config=DecodeConfig(max_batch=2, prompt_buckets=(8,),
                            max_new_tokens=6, page_size=8,
                            decode_block=2, prefill_batch=1,
                            watchdog_interval_s=0.02,
                            default_timeout_s=30.0))
    try:
        eng.warmup()
        rng = np.random.RandomState(7)
        prompts = _prompts(6, rng, lo=3, hi=8)
        # fires 2 worker loop iterations after the 6th admission, on
        # any host (a bare at= clock would race the submission loop)
        faultinject.arm("serving_worker_crash", at=2,
                        after=("decode_submit", 6))
        reqs = [eng.submit(p, max_new=6, timeout=30) for p in prompts]
        outcomes = []
        deadline = time.monotonic() + 30
        for r in reqs:
            assert r.wait(max(deadline - time.monotonic(), 0.1)), \
                "request neither completed nor failed — LOST"
            try:
                outcomes.append(("ok", r.result(0)))
            except WorkerDiedError:
                outcomes.append(("died", None))
        faultinject.disarm()
        assert any(o == "died" for o, _ in outcomes)
        assert eng.stats()["worker_died_total"] == 1
        assert eng.allocator.in_use == 0      # the crash freed every page
        eng.start()
        got = eng.generate(prompts[0], max_new=4, timeout=30)
        assert len(got) == 4
    finally:
        faultinject.disarm()
        eng.close()


# ---------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------

def test_drain_completes_admitted_requests(served_scope):
    eng = DecodeEngine(
        CFG, scope=served_scope[0], place=fluid.CPUPlace(),
        config=DecodeConfig(max_batch=2, prompt_buckets=(8,),
                            max_new_tokens=6, page_size=8,
                            decode_block=2, prefill_batch=1,
                            default_timeout_s=60.0))
    eng.warmup()
    rng = np.random.RandomState(8)
    reqs = [eng.submit(p, max_new=6, timeout=60)
            for p in _prompts(5, rng, lo=3, hi=8)]
    eng.close(drain=True)
    for r in reqs:
        assert len(r.result(1.0)) == 6    # all admitted work finished
    assert eng.stats()["drained_total"] >= 1


# ---------------------------------------------------------------------
# the decode-shape-hazard verifier lint (analysis/lints.py)
# ---------------------------------------------------------------------

def test_decode_shape_hazard_lint_fires_on_growing_concat():
    from paddle_tpu_torch.analysis import verify_program
    p, s = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(p, s):
        seq = fluid.layers.data(name="seq", shape=[-1, -1],
                                dtype="int64", append_batch_size=False)
        nxt = fluid.layers.data(name="nxt", shape=[-1, 1],
                                dtype="int64", append_batch_size=False)
        grown = fluid.layers.concat([seq, nxt], axis=1)
    diags = [d for d in verify_program(p, fetch_list=[grown])
             if d.code == "decode-shape-hazard"]
    assert len(diags) == 1
    assert diags[0].level == "warning"
    assert "recompiles" in diags[0].message


def test_decode_shape_hazard_lint_quiet_on_static_shapes():
    from paddle_tpu_torch.analysis import verify_program
    p, s = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(p, s):
        a = fluid.layers.data(name="a", shape=[-1, 4], dtype="float32",
                              append_batch_size=False)
        b = fluid.layers.data(name="b", shape=[-1, 4], dtype="float32",
                              append_batch_size=False)
        c = fluid.layers.concat([a, b], axis=1)
    assert not [d for d in verify_program(p, fetch_list=[c])
                if d.code == "decode-shape-hazard"]


# ---------------------------------------------------------------------
# the engine's place, and Inferencer.serve_decode
# ---------------------------------------------------------------------

def test_engine_default_place_is_the_card(served_scope, monkeypatch):
    """With no place the engine runs on core.executor.default_place():
    the card (which raises where CUDA is absent), or the host after
    force_cpu(), with the pools on that device."""
    from paddle_tpu_torch.core import executor
    monkeypatch.setattr(executor, "_FORCED_CPU", False)
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            DecodeEngine(CFG, scope=served_scope[0], auto_start=False,
                         config=DecodeConfig(**ENGINE_CONF))
    fluid.force_cpu()
    eng = DecodeEngine(CFG, scope=served_scope[0], auto_start=False,
                       config=DecodeConfig(**ENGINE_CONF))
    try:
        assert eng.exe.device.type == "cpu"
        assert eng._kp.device.type == "cpu"
        assert eng._kp.dtype == torch.float32
        assert tuple(eng._kp.shape) == tuple(eng.programs.kv_shape)
    finally:
        eng.close()


def test_inferencer_serve_decode(served_scope, tmp_path):
    """Inferencer.serve_decode wraps a DecodeEngine around the
    Inferencer's scope (params from disk) on its place; replicas > 1
    is a Router over engines (ROADMAP item 'Fleet and analyzers') and
    raises naming it."""
    scope, exe, gen_p, gen_out = served_scope
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, str(tmp_path), main_program=gen_p)

    def infer_func():
        ptok = fluid.layers.data(name="ptok", shape=[1, GEN_PROMPT],
                                 dtype="int64", append_batch_size=False)
        return build_llama_generator(CFG, ptok, max_new_tokens=GEN_NEW)

    inf = fluid.Inferencer(infer_func, str(tmp_path),
                           place=fluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="Fleet and analyzers"):
        inf.serve_decode(CFG, config=DecodeConfig(**ENGINE_CONF),
                         replicas=2)
    eng = inf.serve_decode(CFG, config=DecodeConfig(**ENGINE_CONF),
                           warmup=True)
    try:
        rng = np.random.RandomState(9)
        prompt = rng.randint(0, CFG.vocab_size, (1, GEN_PROMPT)).astype(
            np.int64)
        ref = exe.run(gen_p, feed={"ptok": prompt}, fetch_list=[gen_out],
                      scope=scope, mode="test")[0]
        got = eng.generate(prompt[0], max_new=GEN_NEW, timeout=120)
        np.testing.assert_array_equal(got, ref[0, GEN_PROMPT:])
        eng.assert_no_recompiles()
    finally:
        eng.close()
