"""Chunked prefill, SLO-aware scheduling and the in-process KV handoff
of the decode engine, the JAX package against the torch port on the
CPU: the cases of tests/test_slo_sched.py run on the port
(serving/sched.py, the ``llama_paged_prefill_chunk`` path of
serving/decode_engine.py, the KV export and import hooks), with the
reference's generator weights carried across as numpy.

Contracts: scheduling never changes tokens (whole, chunked, chunked
while co-scheduled, or split across two engines by a handoff: integer-
exact, and equal to the reference engine's chunked tokens); the chunk
program is one step build at [1, chunk_size]; the schedulers are pure
policies on fake clocks. The reference's cases that route handoffs
across a replica pool (``Router.generate`` over prefill and decode
roles, the ``serving_handoff_drop`` drill, and the slow process and
socket transports) run on the port's ``cluster/``, tokens equal to the
lone engine's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import llama as jllama
from paddle_tpu import serving as jserving

import paddle_tpu_torch as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           build_llama_generator)
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine, SLOClass,
                                      ServingError)
from paddle_tpu_torch.serving.sched import (FIFOScheduler, SLOScheduler,
                                            get_scheduler)

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
              ffn_hidden=64, dtype="float32")
CFG = LlamaConfig(**CFG_KW)
JCFG = jllama.LlamaConfig(**CFG_KW)
LONG_PROMPT, MAX_NEW, CHUNK = 12, 8, 4


@pytest.fixture(scope="module")
def jax_scope():
    gen_p, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(gen_p, startup):
        ptok = jfluid.layers.data(name="ptok", shape=[1, LONG_PROMPT],
                                  dtype="int64", append_batch_size=False)
        jllama.build_llama_generator(JCFG, ptok, max_new_tokens=MAX_NEW)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return scope


@pytest.fixture(scope="module")
def served_scope(jax_scope):
    """The reference's generator weights in a port scope, with the
    port's fused whole-prompt program for the long prompt."""
    gen_p, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(gen_p, startup):
        ptok = fluid.layers.data(name="ptok", shape=[1, LONG_PROMPT],
                                 dtype="int64", append_batch_size=False)
        gen_out = build_llama_generator(CFG, ptok, max_new_tokens=MAX_NEW)
    arrays = {n: np.asarray(jax_scope.find_var(n)) for n in jax_scope.keys()
              if jax_scope.find_var(n) is not None}
    scope = weights.load_state(fluid.Scope(), arrays, CPU)
    return scope, fluid.Executor(fluid.CPUPlace()), gen_p, gen_out


def _conf(**kw):
    base = dict(max_batch=4, prompt_buckets=(4, 16),
                max_new_tokens=MAX_NEW, page_size=8, decode_block=4,
                prefill_batch=2, default_timeout_s=120.0)
    base.update(kw)
    return base


def _cfg(**kw):
    return DecodeConfig(**_conf(**kw))


def _engine(scope, **kw):
    eng = DecodeEngine(CFG, scope=scope, place=fluid.CPUPlace(),
                       config=_cfg(**kw))
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def plain_engine(served_scope):
    """Whole-prompt-prefill engine: the exactness reference."""
    eng = _engine(served_scope[0])
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def chunk_engine(served_scope):
    """Chunked-prefill engine: prompts longer than CHUNK stream into
    their pages CHUNK tokens an engine iteration."""
    eng = _engine(served_scope[0], chunk_size=CHUNK)
    yield eng
    eng.close()


def _fused_ref(served_scope, prompt):
    scope, exe, gen_p, gen_out = served_scope
    full = exe.run(gen_p, feed={"ptok": prompt[None]}, fetch_list=[gen_out],
                   scope=scope, mode="test")[0]
    return full[0, len(prompt):]


def _prompt(rng, n):
    return rng.randint(0, CFG.vocab_size, (n,)).astype(np.int64)


# ---------------------------------------------------------------------
# scheduler policy units (fake clocks, no engine)
# ---------------------------------------------------------------------

class _Req:
    def __init__(self, enqueued_at, slo=None):
        self.enqueued_at = enqueued_at
        self.slo = slo


class _Slot:
    def __init__(self, req, first_token_at=None, emitted=()):
        self.req = req
        self.first_token_at = first_token_at
        self.emitted = list(emitted)


def test_slo_class_validates_targets():
    slo = SLOClass(ttft_target_s=0.25, tpot_target_s=0.05, name="chat")
    assert slo.ttft_target_s == 0.25 and slo.name == "chat"
    assert SLOClass().ttft_target_s is None       # both halves optional
    with pytest.raises(ValueError):
        SLOClass(ttft_target_s=0.0)
    with pytest.raises(ValueError):
        SLOClass(tpot_target_s=-1.0)


def test_get_scheduler_resolution():
    assert isinstance(get_scheduler(None), FIFOScheduler)
    assert isinstance(get_scheduler("fifo"), FIFOScheduler)
    assert isinstance(get_scheduler("slo"), SLOScheduler)
    custom = SLOScheduler(urgency_s=0.5)
    assert get_scheduler(custom) is custom        # instances pass through
    with pytest.raises(ValueError):
        get_scheduler("priority")


def test_fifo_is_arrival_order_always_willing():
    sched = FIFOScheduler()
    q = [_Req(3.0), _Req(1.0), _Req(2.0)]
    assert sched.order(q, now=10.0) == q          # no re-sort, ever
    assert sched.admit_now(q, [None, None], now=10.0)
    assert sched.admit_now([], [], now=10.0)


def test_edf_orders_by_ttft_deadline():
    sched = SLOScheduler()
    best_effort = _Req(0.0)                                 # inf deadline
    tight = _Req(1.0, SLOClass(ttft_target_s=0.1))          # deadline 1.1
    loose = _Req(0.5, SLOClass(ttft_target_s=10.0))         # deadline 10.5
    assert sched.order([best_effort, tight, loose], now=1.0) \
        == [tight, loose, best_effort]


def test_edf_is_fifo_among_equals():
    sched = SLOScheduler()
    a, b = _Req(0.0), _Req(1.0)                   # both deadline inf
    assert sched.order([b, a], now=2.0) == [a, b]
    slo = SLOClass(ttft_target_s=1.0)
    c, d = _Req(2.0, slo), _Req(2.0, slo)         # identical deadlines
    assert sched.order([c, d], now=2.0) == [c, d]


def test_tpot_guard_defers_prefill_admission():
    sched = SLOScheduler(urgency_s=0.05)
    queued = [_Req(0.0, SLOClass(ttft_target_s=100.0))]     # no urgency
    hungry = _Slot(_Req(0.0, SLOClass(tpot_target_s=0.1)),
                   first_token_at=0.0, emitted=[1, 2])
    # 2 tokens out, budget 0.2s, 0.3s elapsed: the stream is starving
    assert not sched.admit_now(queued, [hungry, None], now=0.3)
    # same stream within budget: admission is welcome
    assert sched.admit_now(queued, [hungry, None], now=0.15)


def test_ttft_urgency_outranks_tpot_guard():
    sched = SLOScheduler(urgency_s=0.05)
    urgent = [_Req(0.0, SLOClass(ttft_target_s=0.3))]   # slack 0.01s
    hungry = _Slot(_Req(0.0, SLOClass(tpot_target_s=0.1)),
                   first_token_at=0.0, emitted=[1, 2])
    assert sched.admit_now(urgent, [hungry], now=0.29)


def test_tpot_guard_ignores_unscored_streams():
    sched = SLOScheduler()
    queued = [_Req(0.0, SLOClass(ttft_target_s=100.0))]
    prefilling = _Slot(_Req(0.0, SLOClass(tpot_target_s=1e-9)),
                       first_token_at=None)       # no first token yet
    best_effort = _Slot(_Req(0.0), first_token_at=0.0, emitted=[1])
    assert sched.admit_now(queued, [prefilling, best_effort], now=99.0)


def test_admit_now_false_on_empty_queue():
    assert not SLOScheduler().admit_now([], [None], now=0.0)


# ---------------------------------------------------------------------
# chunked prefill: bit-parity + the no-recompile pin
# ---------------------------------------------------------------------

def test_chunk_parity_alone(served_scope, chunk_engine):
    p = _prompt(np.random.RandomState(0), LONG_PROMPT)
    before = chunk_engine.stats()["chunk_prefill_total"]
    out = chunk_engine.generate(p, timeout=120.0)
    np.testing.assert_array_equal(np.asarray(out),
                                  _fused_ref(served_scope, p))
    assert chunk_engine.stats()["chunk_prefill_total"] - before == 3


def test_chunk_parity_co_scheduled(served_scope, plain_engine,
                                   chunk_engine):
    """A chunked long prefill interleaved with decoding shorts: every
    request matches its solo whole-prompt tokens bit-for-bit."""
    rng = np.random.RandomState(1)
    prompts = [_prompt(rng, LONG_PROMPT)] \
        + [_prompt(rng, int(rng.randint(2, 5))) for _ in range(4)] \
        + [_prompt(rng, LONG_PROMPT)]
    refs = [plain_engine.generate(p, timeout=120.0) for p in prompts]
    handles = [chunk_engine.submit(p, timeout=120.0) for p in prompts]
    outs = [h.result(120.0) for h in handles]
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))


def test_chunk_churn_never_recompiles(served_scope, chunk_engine):
    """Long prompts of every length 5..16 stream through the one
    [1, chunk_size] chunk program: step-build counts pinned."""
    rng = np.random.RandomState(2)
    counts = dict(chunk_engine.exe.compile_counts())
    handles = [chunk_engine.submit(_prompt(rng, n), timeout=120.0)
               for n in range(CHUNK + 1, 17)]
    for h in handles:
        assert len(h.result(120.0)) == MAX_NEW
    chunk_engine.assert_no_recompiles()
    assert dict(chunk_engine.exe.compile_counts()) == counts


def test_chunk_with_speculation_refused(served_scope):
    with pytest.raises(NotImplementedError):
        DecodeEngine(CFG, scope=served_scope[0], place=fluid.CPUPlace(),
                     draft_cfg=CFG, config=_cfg(chunk_size=CHUNK))


# ---------------------------------------------------------------------
# KV handoff: in-process round trips
# ---------------------------------------------------------------------

def test_handoff_round_trip_in_process(served_scope, plain_engine,
                                       chunk_engine):
    """Prefill (chunked!) on one engine, decode on another: the blob
    carries the KV pages and the tokens come out bit-identical."""
    rng = np.random.RandomState(3)
    dec = _engine(served_scope[0])
    try:
        for n in (LONG_PROMPT, 3):
            p = _prompt(rng, n)
            ref = plain_engine.generate(p, timeout=120.0)
            blob = chunk_engine.submit(
                p, timeout=120.0, prefill_only=True).result(120.0)
            assert blob["kind"] == "kv_handoff"
            assert blob["page_size"] == 8 and not blob["done"]
            assert len(blob["emitted"]) == 1      # exactly first token
            out = dec.import_handoff(blob, timeout=120.0).result(120.0)
            np.testing.assert_array_equal(np.asarray(ref),
                                          np.asarray(out))
        snap = dec.stats()
        assert snap["handoff_import_total"] == 2
        assert chunk_engine.stats()["handoff_export_total"] >= 2
    finally:
        dec.close()


def test_handoff_import_is_idempotent(served_scope, plain_engine):
    """The router may replay a blob after a decode-replica death: a
    second import allocates fresh pages and decodes the same tokens."""
    p = _prompt(np.random.RandomState(4), 6)
    ref = plain_engine.generate(p, timeout=120.0)
    dec = _engine(served_scope[0])
    try:
        blob = plain_engine.submit(
            p, timeout=120.0, prefill_only=True).result(120.0)
        for _ in range(2):
            out = dec.import_handoff(blob, timeout=120.0).result(120.0)
            np.testing.assert_array_equal(np.asarray(ref),
                                          np.asarray(out))
    finally:
        dec.close()


def test_handoff_done_blob_short_circuits(served_scope, plain_engine):
    """max_new=1 finishes AT prefill: the blob says done and the
    importer resolves it without touching a decode slot."""
    p = _prompt(np.random.RandomState(5), 6)
    ref = plain_engine.generate(p, max_new=1, timeout=120.0)
    blob = plain_engine.submit(
        p, max_new=1, timeout=120.0, prefill_only=True).result(120.0)
    assert blob["done"] and not blob["pages"]
    dec = _engine(served_scope[0])
    try:
        out = dec.import_handoff(blob, timeout=120.0).result(120.0)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))
    finally:
        dec.close()


def test_handoff_import_rejects_bad_blobs(served_scope, plain_engine):
    dec = _engine(served_scope[0], page_size=4)
    try:
        with pytest.raises(ServingError):
            dec.import_handoff({"kind": "not_a_handoff"})
        blob = plain_engine.submit(
            _prompt(np.random.RandomState(6), 6),
            timeout=120.0, prefill_only=True).result(120.0)
        incomplete = {k: v for k, v in blob.items() if k != "pages"}
        with pytest.raises(ServingError):
            dec.import_handoff(incomplete)
        with pytest.raises(ServingError):      # page geometry mismatch
            dec.import_handoff(blob)
    finally:
        dec.close()


# ---------------------------------------------------------------------
# SLO attainment accounting
# ---------------------------------------------------------------------

def test_slo_counters_and_class_windows(served_scope):
    eng = _engine(served_scope[0], scheduler="slo")
    try:
        relaxed = SLOClass(ttft_target_s=1e6, tpot_target_s=1e6,
                           name="relaxed")
        tight = SLOClass(ttft_target_s=1e-9, tpot_target_s=1e-9,
                         name="tight")
        p = _prompt(np.random.RandomState(7), 4)
        eng.submit(p, timeout=120.0, slo=relaxed).result(120.0)
        eng.submit(p, timeout=120.0, slo=tight).result(120.0)
        eng.generate(p, timeout=120.0)           # no SLO: never scored
        snap = eng.stats()
        assert snap["slo_ttft_met"] == 1
        assert snap["slo_ttft_violated"] == 1
        assert snap["slo_tpot_met"] == 1
        assert snap["slo_tpot_violated"] == 1
        assert snap["relaxed.ttft_s"]["count"] == 1
        assert snap["tight.tpot_s"]["count"] == 1
        assert snap["scheduler"] == "slo"
    finally:
        eng.close()


def test_submit_rejects_non_slo_objects(plain_engine):
    with pytest.raises((TypeError, ValueError)):
        plain_engine.submit(np.zeros(4, np.int64), slo="interactive")


def test_chunk_tokens_equal_the_reference_chunk_engine(jax_scope,
                                                      chunk_engine):
    """Long and short prompts through the reference's chunked engine and
    the port's: tokens integer-exact."""
    rng = np.random.RandomState(8)
    prompts = [_prompt(rng, n) for n in (LONG_PROMPT, 3, 16, 7)]
    jeng = jserving.DecodeEngine(JCFG, scope=jax_scope,
                                 place=jfluid.CPUPlace(),
                                 config=jserving.DecodeConfig(
                                     **_conf(chunk_size=CHUNK)))
    try:
        want = [r.result(120.0) for r in [jeng.submit(p, timeout=120.0)
                                          for p in prompts]]
    finally:
        jeng.close()
    got = [r.result(120.0) for r in [chunk_engine.submit(p, timeout=120.0)
                                     for p in prompts]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_handoff_blob_pages_are_the_engines_pages(served_scope,
                                                  plain_engine):
    """The export copies only the request's pages (picked on the device)
    and the blob holds their values: in a float32 pool, the very bits a
    second engine's import writes back, so its decode gives the
    run-alone tokens."""
    p = _prompt(np.random.RandomState(9), 6)
    blob = plain_engine.submit(p, timeout=120.0,
                               prefill_only=True).result(120.0)
    n_pages = len(blob["pages"])
    assert blob["k"].shape == (CFG.n_layers, n_pages, 8, CFG.n_kv_heads,
                               CFG.dim // CFG.n_heads)
    assert blob["k"].dtype == np.float32 and blob["v"].shape == \
        blob["k"].shape
    dec = _engine(served_scope[0])
    try:
        req = dec.import_handoff(blob, timeout=120.0)
        out = req.result(120.0)
    finally:
        dec.close()
    np.testing.assert_array_equal(out, plain_engine.generate(p,
                                                             timeout=120.0))


# ---------------------------------------------------------------------
# disaggregated router + the serving_handoff_drop chaos drill
# ---------------------------------------------------------------------

def _role_pool(scope, n_prefill, n_decode):
    from paddle_tpu_torch.cluster import ReplicaPool, Router
    pool = ReplicaPool(
        lambda: DecodeEngine(CFG, scope=scope, place=fluid.CPUPlace(),
                             config=_cfg(chunk_size=CHUNK,
                                         scheduler="slo")),
        replicas=n_prefill + n_decode, warmup=False)
    reps = pool.replicas()
    for r in reps[:n_prefill]:
        r.role = "prefill"
    for r in reps[n_prefill:]:
        r.role = "decode"
    return pool, Router(pool)


def test_router_disaggregated_generate(served_scope, plain_engine):
    rng = np.random.RandomState(8)
    prompts = [_prompt(rng, LONG_PROMPT), _prompt(rng, 3)]
    refs = [plain_engine.generate(p, timeout=120.0) for p in prompts]
    pool, router = _role_pool(served_scope[0], 1, 1)
    try:
        slo = SLOClass(ttft_target_s=5.0, tpot_target_s=5.0,
                       name="chat")
        for p, ref in zip(prompts, refs):
            out = router.generate(p, max_new=MAX_NEW, timeout=120.0,
                                  slo=slo)
            np.testing.assert_array_equal(np.asarray(ref),
                                          np.asarray(out))
        snap = pool.stats()
        assert snap["handoffs_total"] == 2
        assert snap["handoff_redrives_total"] == 0
    finally:
        router.close()
        pool.close()


def test_router_generate_without_roles_degrades_to_infer(
        served_scope, plain_engine):
    p = _prompt(np.random.RandomState(9), 5)
    ref = plain_engine.generate(p, timeout=120.0)
    from paddle_tpu_torch.cluster import ReplicaPool, Router
    pool = ReplicaPool(
        lambda: DecodeEngine(CFG, scope=served_scope[0],
                             place=fluid.CPUPlace(), config=_cfg()),
        replicas=1, warmup=False)
    router = Router(pool)
    try:
        out = router.generate(p, max_new=MAX_NEW, timeout=120.0)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))
        assert pool.stats()["handoffs_total"] == 0
    finally:
        router.close()
        pool.close()


def test_handoff_drop_chaos_loses_nothing(served_scope, plain_engine):
    """The prefill replica dies WITH the finished KV blob mid-handoff:
    the router re-prefills on the survivor, the pool monitor revives
    the corpse, and the caller sees bit-identical tokens — never a
    lost request or an untyped error."""
    from paddle_tpu_torch.resilience import faultinject
    rng = np.random.RandomState(10)
    prompts = [_prompt(rng, LONG_PROMPT), _prompt(rng, 4)]
    refs = [plain_engine.generate(p, timeout=120.0) for p in prompts]
    pool, router = _role_pool(served_scope[0], 2, 1)
    faultinject.arm("serving_handoff_drop", at=0, times=1)
    try:
        for p, ref in zip(prompts, refs):
            out = router.generate(p, max_new=MAX_NEW, timeout=120.0)
            np.testing.assert_array_equal(np.asarray(ref),
                                          np.asarray(out))
        snap = pool.stats()
        assert snap["handoff_redrives_total"] >= 1
        assert snap["handoffs_total"] == 2
    finally:
        faultinject.disarm("serving_handoff_drop")
        router.close()
        pool.close()


# ---------------------------------------------------------------------
# handoff across the process and socket transports
# ---------------------------------------------------------------------

def _transport_trip(pre, dec, prompt, ref):
    """prefill_only on ``pre`` → wire blob → handoff on ``dec``; the
    SLO crosses as a plain dict (the restricted unpickler refuses
    custom classes) and is rebuilt worker-side."""
    slo = {"ttft_target_s": 5.0, "tpot_target_s": 5.0, "name": "chat"}
    blob = pre.submit(prompt, timeout=60.0, prefill_only=True,
                      max_new=MAX_NEW, slo=slo).result(60.0)
    assert blob["kind"] == "kv_handoff"
    out = dec.handoff(blob, timeout=60.0, slo=slo).result(60.0)
    np.testing.assert_array_equal(ref, np.asarray(out))


@pytest.mark.slow
def test_handoff_process_transport(tmp_path, served_scope,
                                   plain_engine):
    """Two ``proc_worker --decode --cpu`` processes over the saved decode
    model: the blob crosses the pipe as numpy."""
    from paddle_tpu_torch.cluster.replica import ProcessReplica
    from paddle_tpu_torch.models.llama import (load_decode_model,
                                               save_decode_model)
    p = _prompt(np.random.RandomState(11), LONG_PROMPT)
    ref = np.asarray(plain_engine.generate(p, timeout=120.0))
    model_dir = str(tmp_path / "decode_model")
    save_decode_model(model_dir, CFG, served_scope[0])
    cfg2, scope2 = load_decode_model(model_dir)
    assert cfg2 == CFG and scope2.has(next(iter(served_scope[0].keys())))
    common = dict(decode=True, prompt_buckets="4,16",
                  max_new_tokens=MAX_NEW, page_size=8,
                  place=fluid.CPUPlace())
    pre = ProcessReplica(model_dir, name="pre", role="prefill",
                         chunk_size=CHUNK, scheduler="slo", **common)
    dec = ProcessReplica(model_dir, name="dec", role="decode", **common)
    try:
        pre.wait_ready()
        dec.wait_ready()
        _transport_trip(pre, dec, p, ref)
    finally:
        pre.close()
        dec.close()


@pytest.mark.slow
def test_handoff_socket_transport(served_scope, plain_engine):
    from paddle_tpu_torch.cluster.net_worker import ReplicaServer
    from paddle_tpu_torch.cluster.remote import RemoteReplica
    p = _prompt(np.random.RandomState(12), LONG_PROMPT)
    ref = np.asarray(plain_engine.generate(p, timeout=120.0))
    scope = served_scope[0]

    def eng(**kw):
        return DecodeEngine(CFG, scope=scope, place=fluid.CPUPlace(),
                            config=_cfg(**kw))

    pre_srv = ReplicaServer(None, engine=eng(chunk_size=CHUNK),
                            token="slo-test", name="pre")
    dec_srv = ReplicaServer(None, engine=eng(), token="slo-test",
                            name="dec")
    pre = dec = None
    try:
        pre = RemoteReplica(pre_srv.addr, token="slo-test",
                            role="prefill")
        dec = RemoteReplica(dec_srv.addr, token="slo-test",
                            role="decode")
        _transport_trip(pre, dec, p, ref)
    finally:
        for r in (pre, dec):
            if r is not None:
                r.close()
        pre_srv.close()
        dec_srv.close()
