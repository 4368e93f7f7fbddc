"""Speculative decoding (``llama_spec_generate``), the JAX package
against the torch port on the CPU: the cases of tests/test_spec_decode.py.

Greedy speculative decoding must emit exactly the target-only greedy
tokens: the port's spec tokens equal the port's plain greedy tokens and
the reference's spec tokens, with equal round statistics. Sampled
speculative decoding draws from torch generators, whose bits differ from
jax's, so it is held to the reference's distribution tests (per-position
total-variation distance to the plain sampler, with the reference's
calibrated tolerance and power check). The scope is carried across as
numpy from the reference's startup.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

CPU = torch.device("cpu")
TARGET = dict(vocab_size=97, dim=32, n_layers=3, n_heads=4, n_kv_heads=2,
              ffn_hidden=64, dtype="float32")
DRAFT = dict(vocab_size=97, dim=16, n_layers=1, n_heads=2, n_kv_heads=1,
             ffn_hidden=32, dtype="float32")
TINY = dict(vocab_size=24, dim=16, n_layers=1, n_heads=2, n_kv_heads=1,
            ffn_hidden=32, dtype="float32")
TINY_DRAFT = dict(vocab_size=24, dim=8, n_layers=1, n_heads=2,
                  n_kv_heads=1, ffn_hidden=16, dtype="float32")
PROMPT = 7


def _programs(fluid, llama, max_new, gamma, target=TARGET, draft=DRAFT,
              return_stats=False, prompt=PROMPT, **kw):
    """(spec program, its startup, spec fetches, plain generator program,
    its fetch) under fresh names; both read the same target names."""
    with fluid.unique_name.guard():
        spec_p, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(spec_p, startup):
            ptok = fluid.layers.data(name="ptok", shape=[-1, prompt],
                                     dtype="int64", append_batch_size=False)
            spec = llama.build_llama_spec_generator(
                llama.LlamaConfig(**target), llama.LlamaConfig(**draft),
                ptok, max_new_tokens=max_new, gamma=gamma,
                return_stats=return_stats, **kw)
        gen_p = fluid.Program()
        with fluid.program_guard(gen_p, fluid.Program()):
            gtok = fluid.layers.data(name="gtok", shape=[-1, prompt],
                                     dtype="int64", append_batch_size=False)
            gen = llama.build_llama_generator(llama.LlamaConfig(**target),
                                              gtok, max_new_tokens=max_new,
                                              **kw)
    return (spec_p, startup, list(spec) if return_stats else [spec], gen_p,
            gen)


def _scopes(jstartup, copy_draft=False, sharpen=0.0):
    """The reference's startup scope (the draft aliased to the target,
    the heads sharpened, as the reference test asks), and its port
    twin."""
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    if sharpen:
        for nm in ("lm_head", "draft.lm_head"):
            jscope.set(nm, np.asarray(jscope.find_var(nm)) * sharpen)
    if copy_draft:
        jllama.copy_weights_as_draft(jscope)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    return jscope, weights.load_state(tfluid.Scope(), arrays, CPU)


def _jrun(prog, fetch, scope, feed):
    return [np.asarray(x) for x in jfluid.Executor(jfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=scope, mode="test")]


def _trun(prog, fetch, scope, feed, exe=None):
    exe = exe or tfluid.Executor(tfluid.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                   mode="test")


def _run_both(max_new, gamma, batch=3, copy_draft=False, draft=DRAFT,
              seed=0):
    """Spec and plain greedy in the port, and spec in the reference, on
    the same carried scope; returns (prompt, plain, spec, reference spec,
    port stats, reference stats)."""
    jp = _programs(jfluid, jllama, max_new, gamma, draft=draft,
                   return_stats=True)
    tp = _programs(tfluid, tllama, max_new, gamma, draft=draft,
                   return_stats=True)
    jscope, scope = _scopes(jp[1], copy_draft)
    if copy_draft:
        tllama.copy_weights_as_draft(scope)
    prompt = np.random.RandomState(seed).randint(
        0, TARGET["vocab_size"], (batch, PROMPT)).astype(np.int64)
    plain = _trun(tp[3], [tp[4]], scope, {"gtok": prompt})[0]
    spec, r, e = _trun(tp[0], tp[2], scope, {"ptok": prompt})
    jspec, jr, je = _jrun(jp[0], jp[2], jscope, {"ptok": prompt})
    return prompt, plain, spec, jspec, (int(r), int(e)), (int(jr), int(je))


@pytest.mark.parametrize("case", [
    dict(max_new=11, gamma=3),                          # random draft
    dict(max_new=9, gamma=3, copy_draft=True, draft=TARGET),   # perfect
    dict(max_new=3, gamma=6),                           # gamma overshoot
    dict(max_new=1, gamma=4),                           # prefill only
    dict(max_new=14, gamma=2, batch=5, seed=3)],        # lockstep
    ids=["random_draft", "perfect_draft", "gamma_overshoot",
         "single_token", "batch_lockstep"])
def test_spec_decode_exact(case):
    """Every emitted token is a target argmax: the port's spec tokens
    equal its plain greedy tokens and the reference's spec tokens, with
    the same rounds and emitted count."""
    prompt, plain, spec, jspec, stats, jstats = _run_both(**case)
    np.testing.assert_array_equal(spec[:, :PROMPT], prompt)
    np.testing.assert_array_equal(spec, plain)
    np.testing.assert_array_equal(spec, jspec)
    assert stats == jstats
    assert stats[1] == case["max_new"]


def test_spec_decode_guards():
    with pytest.raises(ValueError, match="share a vocab"):
        _programs(tfluid, tllama, 4, 2, draft=dict(DRAFT, vocab_size=64))
    from paddle_tpu_torch.layers import transformer as tfl
    for bad_kw, msg in ((dict(temperature=-0.5), "temperature"),
                        (dict(temperature=0.8, top_p=0.0), "top_p"),
                        (dict(temperature=0.8, top_k=-2), "top_k"),
                        (dict(gamma=0), "gamma"),
                        (dict(max_new_tokens=0), "max_new_tokens")):
        with pytest.raises(ValueError, match=msg):
            with tfluid.unique_name.guard(), tfluid.program_guard(
                    tfluid.Program(), tfluid.Program()):
                ptok = tfluid.layers.data(name="p", shape=[-1, 4],
                                          dtype="int64",
                                          append_batch_size=False)
                kw = dict(dict(max_new_tokens=4), **bad_kw)
                tfl.llama_spec_generate(
                    ptok, vocab_size=32, dim=16, n_layers=1, n_heads=2,
                    n_kv_heads=1, ffn_hidden=32, draft_dim=16,
                    draft_n_layers=1, draft_n_heads=2, draft_n_kv_heads=1,
                    draft_ffn_hidden=32, **kw)


def test_spec_decode_draft_keeps_own_rope_base():
    """A draft with another rope base is served with its own: still
    exact, and the op's attrs carry both bases (as the reference's)."""
    draft = dict(DRAFT, rope_base=10000.0)
    assert draft["rope_base"] != tllama.LlamaConfig(**TARGET).rope_base
    _, plain, spec, jspec, _, _ = _run_both(max_new=8, gamma=2, draft=draft)
    np.testing.assert_array_equal(spec, plain)
    np.testing.assert_array_equal(spec, jspec)
    op = [o for o in _programs(tfluid, tllama, 4, 2, draft=draft)[0]
          .global_block().ops if o.type == "llama_spec_generate"][0]
    assert op.attr("draft_rope_base") == 10000.0
    assert op.attr("rope_base") == tllama.LlamaConfig(**TARGET).rope_base


def test_spec_decode_rejects_int8_scope():
    """The spec program on a quantized scope raises instead of feeding
    int8 tensors into float products."""
    tp = _programs(tfluid, tllama, 4, 2)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tp[1], scope=scope)
    tllama.quantize_generator_weights(scope)
    with pytest.raises(NotImplementedError, match="float-only"):
        _trun(tp[0], tp[2], scope, {"ptok": np.zeros((1, PROMPT), np.int64)},
              exe)


def test_spec_decode_eos_masking_matches_generator():
    """eos_id / pad_id: rows that emit eos keep emitting pad, and the spec
    output equals build_llama_generator(eos_id=...)'s and the
    reference's."""
    max_new, gamma = 12, 3
    jp0 = _programs(jfluid, jllama, max_new, gamma)
    jscope, scope = _scopes(jp0[1])
    prompt = np.random.RandomState(1).randint(
        0, TARGET["vocab_size"], (3, PROMPT)).astype(np.int64)
    tp0 = _programs(tfluid, tllama, max_new, gamma)
    free = _trun(tp0[3], [tp0[4]], scope, {"gtok": prompt})[0]
    eos = int(free[0, PROMPT + max_new // 2])
    tp = _programs(tfluid, tllama, max_new, gamma, eos_id=eos, pad_id=0)
    jp = _programs(jfluid, jllama, max_new, gamma, eos_id=eos, pad_id=0)
    want = _trun(tp[3], [tp[4]], scope, {"gtok": prompt})[0]
    got = _trun(tp[0], tp[2], scope, {"ptok": prompt})[0]
    assert (want[:, PROMPT:] == 0).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _jrun(jp[0], jp[2], jscope, {"ptok": prompt})[0])


def test_spec_decode_rejects_moe_configs():
    for target, draft in ((dict(TARGET, moe_experts=4), DRAFT),
                          (TARGET, dict(DRAFT, moe_experts=2))):
        with pytest.raises(NotImplementedError, match="MoE"):
            _programs(tfluid, tllama, 4, 2, target=target, draft=draft)


def test_spec_op_refuses_moe_inputs_as_dense_only():
    """The op itself, handed MoE FFN inputs, says speculative decoding
    is dense-only (as the reference's build_llama_spec_generator refuses
    MoE configs) and routes MoE to the plain generator."""
    from paddle_tpu_torch.core.registry import get_op
    rule = get_op("llama_spec_generate").lower
    with pytest.raises(NotImplementedError,
                       match="dense-only, as in the reference.*"
                             "build_llama_generator"):
        rule(None, {"MoeRouter": [torch.zeros(2, 2)]}, {})


def test_spec_decode_round_stats():
    """A perfect draft takes far fewer verification rounds than a random
    one for the same output; the port's rounds equal the reference's."""
    _, _, toks_p, _, (r_p, e_p), jstats_p = _run_both(
        12, 3, batch=2, copy_draft=True, draft=TARGET)
    _, _, toks_r, _, (r_r, e_r), jstats_r = _run_both(12, 3, batch=2)
    assert e_p == e_r == 12
    assert r_p <= 4 and r_r >= r_p
    assert (r_p, e_p) == jstats_p and (r_r, e_r) == jstats_r
    np.testing.assert_array_equal(toks_p, toks_r)


# ---------------------------------------------------------------------------
# sampled speculative decoding (temperature > 0)
# ---------------------------------------------------------------------------

def _sampling(max_new, gamma, temperature, draft=TINY_DRAFT,
              return_stats=False, **kw):
    return _programs(tfluid, tllama, max_new, gamma, target=TINY,
                     draft=draft, return_stats=return_stats,
                     temperature=temperature, **kw)


def _port_sampling_scope(draft=TINY_DRAFT, copy_draft=False):
    """The reference startup's scope for TINY and ``draft``, heads x 50
    (the reference's ``_sharpen``: random-init logits are near uniform,
    which every distribution trivially matches)."""
    jp = _programs(jfluid, jllama, 3, 2, target=TINY, draft=draft,
                   temperature=1.0)
    _, scope = _scopes(jp[1], sharpen=50.0)
    if copy_draft:
        tllama.copy_weights_as_draft(scope)
    return scope


def _empirical(exe, prog, fetch, scope, feed_name, prompt, n_runs,
               max_new, vocab):
    """Per-position marginals of the generated tokens over n_runs runs
    (each run at a new executor step)."""
    counts = np.zeros((max_new, vocab))
    for _ in range(n_runs):
        toks = _trun(prog, fetch, scope, {feed_name: prompt}, exe)[0]
        for j in range(max_new):
            np.add.at(counts[j], toks[:, PROMPT + j], 1)
    return counts / counts.sum(axis=1, keepdims=True)


def _tvd(p, q):
    return 0.5 * np.abs(p - q).sum(axis=-1)


def test_spec_sampling_topk1_is_exactly_greedy():
    """temperature > 0 with top_k = 1: the warped distributions are
    one-hot, so rejection resampling emits exactly the plain generator's
    tokens."""
    sp = _sampling(11, 3, 0.9, top_k=1)
    scope = _port_sampling_scope()
    prompt = np.random.RandomState(11).randint(
        0, TINY["vocab_size"], (3, PROMPT)).astype(np.int64)
    want = _trun(sp[3], [sp[4]], scope, {"gtok": prompt})[0]
    got = _trun(sp[0], sp[2], scope, {"ptok": prompt})[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("perfect", [False, True],
                         ids=["random_draft", "perfect_draft"])
def test_spec_sampling_matches_target_distribution(perfect):
    """Free sampling at temperature 1: the spec sampler's per-position
    marginals match the plain sampler's (TVD < 0.2, the reference's
    calibrated tolerance), while the plain sampler is far from uniform
    (the power check). With the draft equal to the target every draft is
    accepted: rounds hit the ceiling (one extra allowed, as the
    reference allows)."""
    max_new, gamma, batch, runs = 3, 2, 24, 14
    draft = TINY if perfect else TINY_DRAFT
    sp = _sampling(max_new, gamma, 1.0, draft=draft, return_stats=True)
    scope = _port_sampling_scope(draft, copy_draft=perfect)
    prompt = np.tile(np.random.RandomState(9 if perfect else 5).randint(
        0, TINY["vocab_size"], (1, PROMPT)).astype(np.int64), (batch, 1))
    exe = tfluid.Executor(tfluid.CPUPlace())
    if perfect:
        _, rounds, emitted = _trun(sp[0], sp[2], scope, {"ptok": prompt},
                                   exe)
        ideal = -(-(max_new - 1) // (gamma + 1))
        assert ideal <= int(rounds) <= ideal + 1
        assert int(emitted) == max_new
    p_gen = _empirical(exe, sp[3], [sp[4]], scope, "gtok", prompt, runs,
                       max_new, TINY["vocab_size"])
    p_spec = _empirical(exe, sp[0], sp[2][:1], scope, "ptok", prompt, runs,
                        max_new, TINY["vocab_size"])
    tol = 0.2
    uniform = np.full(TINY["vocab_size"], 1.0 / TINY["vocab_size"])
    for j in range(max_new):
        assert _tvd(p_gen[j], uniform) > 2 * tol, (j, _tvd(p_gen[j],
                                                           uniform))
        assert _tvd(p_spec[j], p_gen[j]) < tol, (j, _tvd(p_spec[j],
                                                         p_gen[j]))


def test_spec_sampling_eos_masking():
    """Sampled mode honors the eos/pad convention: with top_k = 1 and an
    eos the plain generator emits mid-sequence, both paths give the same
    pad-masked rows."""
    scope = _port_sampling_scope()
    sp0 = _sampling(10, 3, 0.7, top_k=1)
    prompt = np.random.RandomState(21).randint(
        0, TINY["vocab_size"], (4, PROMPT)).astype(np.int64)
    base = _trun(sp0[3], [sp0[4]], scope, {"gtok": prompt})[0]
    eos = int(base[:, PROMPT + 2:PROMPT + 8].flat[0])
    sp = _sampling(10, 3, 0.7, top_k=1, eos_id=eos, pad_id=0)
    want = _trun(sp[3], [sp[4]], scope, {"gtok": prompt})[0]
    got = _trun(sp[0], sp[2], scope, {"ptok": prompt})[0]
    assert (want[:, PROMPT:] == 0).any()
    np.testing.assert_array_equal(got, want)


def test_spec_greedy_draws_nothing_sampled_does():
    """Greedy spec decoding takes no key (the draw count of later ops is
    unchanged, as in the reference) and bypasses nothing; the sampled
    program is one that draws."""
    from paddle_tpu_torch.core.executor import _draws_rng
    greedy = _programs(tfluid, tllama, 4, 2)[0]
    sampled = _sampling(4, 2, 0.9)[0]
    assert not _draws_rng(greedy) and _draws_rng(sampled)


def test_trained_draft_achieves_real_acceptance():
    """An independently trained small draft (dim 16, 1 layer) speculating
    for a larger target (dim 48, 2 layers) on a learnable language (the
    reference's test, trained in the reference and carried across) clears
    2.5 tokens a round at gamma 4, and its output equals the port's plain
    greedy tokens."""
    V, SEQ, PRM, NEW, GAMMA = 64, 24, 6, 16, 4
    tgt = dict(vocab_size=V, dim=48, n_layers=2, n_heads=4, n_kv_heads=2,
               ffn_hidden=96, dtype="float32")
    drf = dict(vocab_size=V, dim=16, n_layers=1, n_heads=2, n_kv_heads=1,
               ffn_hidden=32, dtype="float32")

    def train(cfg, seed, steps=180):
        with jfluid.unique_name.guard():
            p, st = jfluid.Program(), jfluid.Program()
            p.random_seed = st.random_seed = seed
            with jfluid.program_guard(p, st):
                toks = jfluid.layers.data(name="toks", shape=[-1, SEQ],
                                          dtype="int64",
                                          append_batch_size=False)
                tgts = jfluid.layers.data(name="tgts", shape=[-1, SEQ],
                                          dtype="int64",
                                          append_batch_size=False)
                _, loss = jllama.build_llama(jllama.LlamaConfig(**cfg), toks,
                                             tgts, shard_pp=True)
                jfluid.optimizer.Adam(learning_rate=4e-3).minimize(loss)
        scope = jfluid.Scope()
        exe = jfluid.Executor(jfluid.CPUPlace())
        rng = np.random.RandomState(7)
        exe.run(st, scope=scope)
        for _ in range(steps):
            start = rng.randint(0, V, (16, 1))
            stride = rng.randint(1, 4, (16, 1))
            s = (start + stride * np.arange(SEQ + 1)) % V
            exe.run(p, feed={"toks": s[:, :-1], "tgts": s[:, 1:]},
                    fetch_list=[loss], scope=scope)
        return scope

    tscope, dscope = train(tgt, 11), train(drf, 13)
    arrays = {k: np.asarray(tscope.find_var(k)) for k in tscope.keys()}
    for sfx in tllama.GENERATOR_STACK_SUFFIXES:
        arrays[f"draft.{sfx}"] = np.asarray(dscope.find_var(f"blocks.{sfx}"))
    for nm in tllama.GENERATOR_SINGLETON_NAMES:
        arrays[f"draft.{nm}"] = np.asarray(dscope.find_var(nm))
    serve = weights.load_state(tfluid.Scope(), arrays, CPU)
    sp = _programs(tfluid, tllama, NEW, GAMMA, target=tgt, draft=drf,
                   return_stats=True, prompt=PRM)
    rng = np.random.RandomState(3)
    start, stride = rng.randint(0, V, (8, 1)), rng.randint(1, 4, (8, 1))
    prompts = ((start + stride * np.arange(PRM)) % V).astype(np.int64)
    toks, rounds, emitted = _trun(sp[0], sp[2], serve, {"ptok": prompts})
    plain = _trun(sp[3], [sp[4]], serve, {"gtok": prompts})[0]
    np.testing.assert_array_equal(toks, plain)
    r, e = int(rounds), int(emitted)
    assert e == NEW
    assert (e - 1) / max(r, 1) >= 2.5, (r, e)


def test_spec_decode_program_matches_reference_op_for_op():
    """Identical op, wiring and attrs, and the same parameter set (the
    draft's under ``draft.*``), in both packages."""
    jp = _programs(jfluid, jllama, 5, 2, return_stats=True,
                   draft=dataclasses.asdict(jllama.LlamaConfig(**DRAFT)))
    tp = _programs(tfluid, tllama, 5, 2, return_stats=True,
                   draft=dataclasses.asdict(tllama.LlamaConfig(**DRAFT)))
    jops, tops = jp[0].global_block().ops, tp[0].global_block().ops
    assert [(o.type, o.inputs, o.outputs, o.attrs) for o in jops] == \
        [(o.type, o.inputs, o.outputs, o.attrs) for o in tops]
    assert sorted(p.name for p in jp[0].all_parameters()) == \
        sorted(p.name for p in tp[0].all_parameters())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tfluid.Executor(tfluid.CPUPlace()).run(tp[1], scope=tfluid.Scope())
