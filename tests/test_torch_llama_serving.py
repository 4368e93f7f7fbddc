"""The slice as a whole: ``build_llama``'s forward program served through
``ServingEngine``, the JAX package against the torch port on the CPU.

Both packages build the program with the same layer code; the JAX
startup initializes the weights and the scope is carried across as
numpy (paddle_tpu_torch.weights). At head dim 128 and T = 128 the JAX
side runs its Pallas flash kernel (K1) through the interpreter; at
LLAMA_TINY (head dim 16) it takes its plain path.

f32 tolerance: rtol/atol 1e-4 on logits (matmuls sum in another order);
the greedy token must match wherever the reference's top-1 margin
exceeds twice that tolerance.
"""
import numpy as np
import pytest
import torch

import ml_dtypes

import paddle_tpu as jfluid
import paddle_tpu.ops.pallas_attention as pa
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import BucketSpec as JBucketSpec
from paddle_tpu.serving import ServingEngine as JServingEngine

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.serving import BucketSpec, ServingEngine

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
HD128 = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             ffn_hidden=512, dtype="float32")
CPU = torch.device("cpu")


def _build(fluid, llama, cfg):
    """Fresh programs and name generator; returns (infer program,
    startup program, logits var)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        logits, loss = llama.build_llama(cfg, tokens)
    assert loss is None
    return main.clone(for_test=True), startup, logits


def _programs(cfg_kw):
    jprog = _build(jfluid, jllama, jllama.LlamaConfig(**cfg_kw))
    tprog = _build(tfluid, tllama, tllama.LlamaConfig(**cfg_kw))
    return jprog, tprog


def _jax_weights(jstartup):
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=scope)
    return scope, {n: np.asarray(scope.find_var(n)) for n in scope.keys()}


def _tokens(seed, b, t, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)) \
        .astype(np.int64)


def _assert_logits_match(got, want):
    np.testing.assert_allclose(got, want, **TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * (TOL["atol"] + TOL["rtol"]
                                                 * np.abs(top2[..., 1]))
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided])


@pytest.mark.parametrize("cfg_kw", [HD128, "tiny"])
def test_same_program_op_for_op(cfg_kw):
    """Identical op types, wiring, attrs and parameter names in the main
    and startup programs of both packages."""
    cfg_kw = dict(vars(jllama.LLAMA_TINY)) if cfg_kw == "tiny" else cfg_kw
    (jinf, jstart, jlog), (tinf, tstart, tlog) = _programs(cfg_kw)
    assert jlog.name == tlog.name
    for jp, tp in ((jinf, tinf), (jstart, tstart)):
        jops, tops = jp.global_block().ops, tp.global_block().ops
        assert [o.type for o in jops] == [o.type for o in tops]
        for jo, to in zip(jops, tops):
            assert (jo.inputs, jo.outputs) == (to.inputs, to.outputs)
            assert jo.attrs == to.attrs, jo.type
        assert sorted(p.name for p in jp.all_parameters()) == \
            sorted(p.name for p in tp.all_parameters())
        for name, jv in jp.global_block().vars.items():
            tv = tp.global_block().vars[name]
            assert (jv.shape, jv.dtype, jv.persistable) == \
                (tv.shape, tv.dtype, tv.persistable), name
    assert "multihead_attention" in [o.type for o in tinf.global_block().ops]


def test_weight_names_match_one_to_one():
    (_, jstart, _), (tinf, _, _) = _programs(HD128)
    _, arrays = _jax_weights(jstart)
    assert set(arrays) == {p.name for p in tinf.all_parameters()}
    scope = weights.load_state(tfluid.Scope(), arrays, CPU)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(scope.find_var(name).numpy(), arr)


@pytest.mark.parametrize("cfg_kw", [HD128, "tiny"])
def test_executor_forward_matches_reference(monkeypatch, cfg_kw):
    """Executor.run on the same tokens and carried weights. HD128 runs
    the reference's Pallas K1 (interpreted)."""
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    cfg_kw = dict(vars(jllama.LLAMA_TINY)) if cfg_kw == "tiny" else cfg_kw
    (jinf, jstart, jlog), (tinf, _, tlog) = _programs(cfg_kw)
    jscope, arrays = _jax_weights(jstart)
    toks = _tokens(1, 2, 128)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jinf, feed={"tokens": toks}, fetch_list=[jlog], scope=jscope)[0]
    scope = weights.load_state(tfluid.Scope(), arrays, CPU)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tinf, feed={"tokens": toks}, fetch_list=[tlog], scope=scope)[0]
    assert got.shape == want.shape == (2, 128, 256)
    _assert_logits_match(got, np.asarray(want))


@pytest.mark.parametrize("cfg_kw", [HD128, "tiny"])
def test_serving_engines_answer_alike(monkeypatch, cfg_kw):
    """The same requests through both packages' ServingEngines (one
    length bucket of 128, batch buckets 1 and 2): each answer matches,
    the port warms every bucket and builds nothing after, and K1's
    wrapper ran once per layer per dispatch."""
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    cfg_kw = dict(vars(jllama.LLAMA_TINY)) if cfg_kw == "tiny" else cfg_kw
    calls = []
    real = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda *a: calls.append(1) or real(*a))
    (jinf, jstart, jlog), (tinf, _, tlog) = _programs(cfg_kw)
    jscope, arrays = _jax_weights(jstart)
    scope = weights.load_state(tfluid.Scope(), arrays, CPU)
    lengths = (40, 128, 97)
    reqs = [_tokens(10 + i, 1, n) for i, n in enumerate(lengths)]

    jeng = JServingEngine(jinf, ["tokens"], [jlog], scope=jscope,
                          place=jfluid.CPUPlace(), optimize=False,
                          buckets=JBucketSpec(batch_sizes=(1, 2),
                                              seq_lens={"tokens": (128,)}))
    teng = ServingEngine(tinf, ["tokens"], [tlog], scope=scope,
                         place=tfluid.CPUPlace(),
                         buckets=BucketSpec(batch_sizes=(1, 2),
                                            seq_lens={"tokens": (128,)}))
    try:
        warm = teng.warmup()
        assert warm == {"signatures": 2, "compiles": 2}
        want = [jeng.infer({"tokens": r}, timeout=120) for r in reqs]
        pend = [teng.submit({"tokens": r}, timeout=120) for r in reqs]
        got = [p.result(120) for p in pend]
        teng.assert_no_recompiles()
        stats = teng.stats()
    finally:
        jeng.close()
        teng.close()
    assert stats["responses_total"] == len(reqs)
    assert len(calls) == cfg_kw["n_layers"] * (warm["signatures"]
                                              + stats["batches_total"])
    for n, g, w in zip(lengths, got, want):
        assert g[0].shape == (1, 128, 256)
        _assert_logits_match(g[0][:, :n], np.asarray(w[0])[:, :n])


def test_bfloat16_weights_carry_bit_for_bit():
    """JAX bf16 arrays (ml_dtypes) load as torch.bfloat16 bit for bit and
    dump back to the same bits; the bf16 forward then agrees with the
    reference at the bf16 tier (rtol/atol 5e-2: the two frameworks round
    matmul outputs and activations to bf16 at different points over two
    layers)."""
    cfg = dict(vars(jllama.LLAMA_TINY), dtype="bfloat16")
    (jinf, jstart, jlog), (tinf, _, tlog) = _programs(cfg)
    jscope, arrays = _jax_weights(jstart)
    assert arrays["tok_emb"].dtype == ml_dtypes.bfloat16
    scope = weights.load_state(tfluid.Scope(), arrays, CPU)
    for name, arr in arrays.items():
        t = scope.find_var(name)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      arr.view(np.int16))
    back = weights.dump_state(scope, bfloat16=ml_dtypes.bfloat16)
    for name, arr in arrays.items():
        assert back[name].dtype == arr.dtype
        np.testing.assert_array_equal(back[name].view(np.int16),
                                      arr.view(np.int16))
    widened = weights.dump_state(scope, names=["tok_emb"])["tok_emb"]
    np.testing.assert_array_equal(widened, arrays["tok_emb"].astype(
        np.float32))

    toks = _tokens(2, 2, 16)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jinf, feed={"tokens": toks}, fetch_list=[jlog], scope=jscope)[0]
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tinf, feed={"tokens": toks}, fetch_list=[tlog], scope=scope)[0]
    assert got.dtype == np.float32          # bf16 fetches widen to f32
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_k1_wrapper_is_on_the_served_path(monkeypatch):
    """Every layer's attention goes through K1's wrapper: on the CPU it
    runs the plain version, so the spy counts wrapper calls — one per
    layer per dispatch."""
    calls = []
    real = fa.flash_fwd

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(fa, "flash_fwd", spy)
    tinf, tstart, tlog = _build(tfluid, tllama,
                                tllama.LlamaConfig(**HD128))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    out = exe.run(tinf, feed={"tokens": _tokens(3, 2, 40)},
                  fetch_list=[tlog], scope=scope)[0]
    assert np.isfinite(out).all() and out.shape == (2, 40, 256)
    # [B*H, T, D]: 2 rows x 2 q heads (kv heads repeated), head dim 128
    assert calls == [(4, 40, 128)] * HD128["n_layers"]


def test_state_round_trips_and_startup_runs_on_the_place():
    tinf, tstart, tlog = _build(tfluid, tllama,
                                tllama.LlamaConfig(**HD128))
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(tstart, scope=scope)
    assert {p.name for p in tinf.all_parameters()} == set(scope.keys())
    emb = scope.find_var("tok_emb")
    assert emb.device.type == "cpu" and emb.dtype == torch.float32
    assert abs(float(emb.std()) - 0.02) < 0.002
    assert torch.equal(scope.find_var("final_norm"), torch.ones(256))
    dumped = weights.dump_state(scope)
    again = weights.load_state(tfluid.Scope(), dumped, CPU)
    for n in dumped:
        assert torch.equal(again.find_var(n), scope.find_var(n))
