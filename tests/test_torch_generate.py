"""The fused KV-cache generator (``llama_generate``), the JAX package
against the torch port on the CPU: the cases of
tests/test_llama_generate.py; the mesh and MoE cases build here (they
run in tests/test_torch_llama_mesh.py), and speculative decoding and the
paged engine refuse MoE by name.

Both packages build their programs with the same layer code; the JAX
startup (and, where the reference test trains, its Adam steps)
initializes the weights, and the scope is carried across as numpy
(paddle_tpu_torch.weights). Tolerances: greedy tokens exact; FirstProbs
rtol 1e-4 / atol 1e-6 (float32 sums in another order); warp_logits
within 1e-6; the int8 paths (``_act_quant``, ``qmat``'s int32, the int8
KV contractions, ``quantize_generator_weights``' values and scales)
exact on equal inputs.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import moe as jmoe
from paddle_tpu.ops import transformer_ops as jtops

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import moe as tmoe
from paddle_tpu_torch.ops import transformer_ops as ttops

torch.set_num_threads(1)

CPU = torch.device("cpu")
CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           ffn_hidden=64, dtype="float32")
PROMPT, NEW = 6, 5
PROBS_TOL = dict(rtol=1e-4, atol=1e-6)


def _gen(fluid, llama, cfg_kw=CFG, prompt=PROMPT, feed="ptok", **kw):
    """A generator program with its own startup, under fresh names;
    returns (program, startup, fetch list)."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        ptok = fluid.layers.data(name=feed, shape=[-1, prompt],
                                 dtype="int64", append_batch_size=False)
        out = llama.build_llama_generator(llama.LlamaConfig(**cfg_kw), ptok,
                                          **kw)
    return prog, startup, list(out) if isinstance(out, tuple) else [out]


def _train(fluid, llama, cfg_kw=CFG, stacked=True):
    """The training program (Adam) and its startup, as the reference
    test builds it."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name="tokens", shape=[-1, 16],
                                   dtype="int64", append_batch_size=False)
        targets = fluid.layers.data(name="targets", shape=[-1, 16],
                                    dtype="int64", append_batch_size=False)
        _, loss = llama.build_llama(llama.LlamaConfig(**cfg_kw), tokens,
                                    targets, shard_pp=stacked)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _forward(fluid, llama, cfg_kw=CFG, stacked=True):
    fwd = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(fwd,
                                                        fluid.Program()):
        ftok = fluid.layers.data(name="ftok", shape=[-1, -1],
                                 dtype="int64", append_batch_size=False)
        logits, _ = llama.build_llama(llama.LlamaConfig(**cfg_kw), ftok,
                                      None, shard_pp=stacked)
    return fwd, logits


def _jax_trained_scope(steps, seed, cfg_kw=CFG, stacked=True):
    """A JAX scope after its startup and ``steps`` Adam steps on random
    tokens (RandomState(seed)); returns (scope, rng after the steps)."""
    main, startup, loss = _train(jfluid, jllama, cfg_kw, stacked)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    rng = np.random.RandomState(seed)
    exe.run(startup, scope=scope)
    for _ in range(steps):
        toks = rng.randint(0, cfg_kw["vocab_size"], (4, 16)).astype(np.int64)
        exe.run(main, feed={"tokens": toks, "targets": np.roll(toks, -1, 1)},
                fetch_list=[loss], scope=scope)
    return scope, rng


def _arrays(jscope):
    return {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()
            if jscope.find_var(n) is not None}


def _port_scope(jscope):
    return weights.load_state(tfluid.Scope(), _arrays(jscope), CPU)


def _run_jax(prog, fetches, scope, feed):
    return [np.asarray(x) for x in jfluid.Executor(jfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetches, scope=scope, mode="test")]


def _run_port(prog, fetches, scope, feed, exe=None):
    exe = exe or tfluid.Executor(tfluid.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=fetches, scope=scope,
                   mode="test")


def test_same_generator_program_op_for_op():
    """Identical op, wiring, attrs and parameters in both packages, for
    the float, int8 (quantize) and int8-cache generators."""
    for kw in ({}, dict(quantize=True), dict(kv_int8=True,
                                             return_probs=True)):
        jp = _gen(jfluid, jllama, max_new_tokens=NEW, **kw)
        tp = _gen(tfluid, tllama, max_new_tokens=NEW, **kw)
        for j, t in zip(jp[:2], tp[:2]):
            jops, tops = j.global_block().ops, t.global_block().ops
            assert [o.type for o in jops] == [o.type for o in tops]
            for jo, to in zip(jops, tops):
                assert (jo.inputs, jo.outputs, jo.attrs) == \
                    (to.inputs, to.outputs, to.attrs)
            for name, jv in j.global_block().vars.items():
                tv = t.global_block().vars[name]
                assert (jv.shape, jv.dtype, jv.persistable) == \
                    (tv.shape, tv.dtype, tv.persistable), name


def test_generate_matches_full_recompute():
    """Greedy KV-cache generation on a briefly trained scope emits the
    reference's tokens, and the naive full-recompute greedy tokens of the
    port's own layer-stacked forward."""
    jscope, rng = _jax_trained_scope(5, 0)
    prompt = rng.randint(0, CFG["vocab_size"], (3, PROMPT)).astype(np.int64)
    jgen = _gen(jfluid, jllama, max_new_tokens=NEW)
    want = _run_jax(jgen[0], jgen[2], jscope, {"ptok": prompt})[0]
    scope = _port_scope(jscope)
    tgen = _gen(tfluid, tllama, max_new_tokens=NEW)
    got = _run_port(tgen[0], tgen[2], scope, {"ptok": prompt})[0]
    fwd, logits = _forward(tfluid, tllama)
    seq = prompt.copy()
    for _ in range(NEW):
        lg = _run_port(fwd, [logits], scope, {"ftok": seq})[0]
        seq = np.concatenate([seq, lg[:, -1].argmax(-1)[:, None]], axis=1)
    assert got.shape == (3, PROMPT + NEW)
    np.testing.assert_array_equal(got[:, :PROMPT], prompt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, seq)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_first_probs_match_reference(kv_int8):
    """FirstProbs (the first step's distribution from the prefill cache)
    within rtol 1e-4 / atol 1e-6 of the reference's, for the float and
    the int8 cache; tokens equal."""
    jscope, rng = _jax_trained_scope(3, 4)
    prompt = rng.randint(0, CFG["vocab_size"], (4, PROMPT)).astype(np.int64)
    kw = dict(max_new_tokens=NEW, return_probs=True, kv_int8=kv_int8)
    jgen = _gen(jfluid, jllama, **kw)
    want, wprobs = _run_jax(jgen[0], jgen[2], jscope, {"ptok": prompt})
    tgen = _gen(tfluid, tllama, **kw)
    got, probs = _run_port(tgen[0], tgen[2], _port_scope(jscope),
                           {"ptok": prompt})
    assert probs.shape == (4, CFG["vocab_size"])
    np.testing.assert_allclose(probs, wprobs, **PROBS_TOL)
    np.testing.assert_array_equal(got, want)


def test_generator_standalone_runs():
    """The generator program runs standalone (its own startup), in the
    vocabulary."""
    prog, startup, fetch = _gen(tfluid, tllama, max_new_tokens=NEW)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    got = _run_port(prog, fetch, scope,
                    {"ptok": np.zeros((2, PROMPT), np.int64)}, exe)[0]
    assert got.shape == (2, PROMPT + NEW)
    assert ((got >= 0) & (got < CFG["vocab_size"])).all()


def test_sampling_modes():
    """temperature > 0 with top_k = 1 equals greedy; free sampling gives
    in-range tokens, replays for the same seed and step, and changes
    with the executor's step. The greedy run draws nothing."""
    jscope, rng = _jax_trained_scope(0, 7)
    scope = _port_scope(jscope)
    prompt = rng.randint(0, CFG["vocab_size"], (2, PROMPT)).astype(np.int64)
    greedy = _gen(tfluid, tllama, max_new_tokens=NEW)
    k1 = _gen(tfluid, tllama, max_new_tokens=NEW, temperature=0.8, top_k=1)
    samp = _gen(tfluid, tllama, max_new_tokens=NEW, temperature=1.5,
                top_p=0.9)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"ptok": prompt}
    g = _run_port(greedy[0], greedy[2], scope, feed, exe)[0]
    np.testing.assert_array_equal(
        g, _run_port(k1[0], k1[2], scope, feed, exe)[0])
    fresh = tfluid.Executor(tfluid.CPUPlace())
    s1 = _run_port(samp[0], samp[2], scope, feed, fresh)[0]
    s2 = _run_port(samp[0], samp[2], scope, feed, fresh)[0]
    again = _run_port(samp[0], samp[2], scope, feed,
                      tfluid.Executor(tfluid.CPUPlace()))[0]
    assert ((s1 >= 0) & (s1 < CFG["vocab_size"])).all()
    np.testing.assert_array_equal(s1, again)
    assert not np.array_equal(s1[:, PROMPT:], s2[:, PROMPT:])
    from paddle_tpu_torch.core.executor import _draws_rng
    assert not _draws_rng(greedy[0])
    assert _draws_rng(k1[0]) and _draws_rng(samp[0])


def test_sampled_tokens_follow_the_warped_distribution():
    """The first sampled token of a row is drawn from softmax(warp_logits
    (FirstProbs' logits)): over many steps its empirical distribution is
    within a total-variation distance of 0.1 of that (top-k 8 keeps the
    support small enough for 600 draws), and nothing outside the top-k
    is ever drawn."""
    prog, startup, fetch = _gen(tfluid, tllama, max_new_tokens=1,
                                return_probs=True, temperature=0.9,
                                top_k=8)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    scope.set("lm_head", scope.find_var("lm_head") * 20)
    prompt = np.tile(np.arange(PROMPT, dtype=np.int64), (300, 1))
    counts = np.zeros(CFG["vocab_size"])
    for _ in range(2):
        toks, probs = _run_port(prog, fetch, scope, {"ptok": prompt}, exe)
        np.add.at(counts, toks[:, PROMPT], 1)
    logits = torch.log(torch.as_tensor(probs[:1]))
    want = torch.softmax(ttops.warp_logits(logits, 0.9, 8), -1)[0].numpy()
    assert not counts[want == 0].any()
    assert 0.5 * np.abs(counts / counts.sum() - want).sum() < 0.1


def test_generator_save_load_inference_model(tmp_path):
    """The generator program round-trips through save/load_inference_model
    and a fresh scope emits the same tokens."""
    prog, startup, fetch = _gen(tfluid, tllama, max_new_tokens=NEW)
    prompt = np.random.RandomState(9).randint(
        0, CFG["vocab_size"], (2, PROMPT)).astype(np.int64)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        want = exe.run(prog, feed={"ptok": prompt}, fetch_list=fetch,
                       mode="test")[0]
        tfluid.io.save_inference_model(str(tmp_path), ["ptok"], fetch, exe,
                                       main_program=prog)
    with tfluid.scope_guard(tfluid.Scope()):
        prog2, feeds, fetches = tfluid.io.load_inference_model(
            str(tmp_path), exe)
        got = exe.run(prog2, feed={feeds[0]: prompt}, fetch_list=fetches,
                      mode="test")[0]
    np.testing.assert_array_equal(got, want)


def test_quantized_generation_matches_reference():
    """W8A8: quantize_generator_weights in both packages on the same
    trained scope, then build_llama_generator(quantize=True): the port's
    int8 tensors and scales equal the reference's, its tokens equal the
    reference's int8 tokens, and (the reference test's claim) agree with
    the float generator on at least 90% of positions. The quantized
    reference scope also generates in the port as it is carried
    across."""
    jscope, rng = _jax_trained_scope(30, 1)
    prompt = rng.randint(0, CFG["vocab_size"], (8, PROMPT)).astype(np.int64)
    fgen = _gen(tfluid, tllama, max_new_tokens=NEW)
    scope = _port_scope(jscope)
    ref = _run_port(fgen[0], fgen[2], scope, {"ptok": prompt})[0]
    tllama.quantize_generator_weights(scope)
    jllama.quantize_generator_weights(jscope)
    jarr = _arrays(jscope)
    for name in ("blocks.wq", "blocks.w_down", "lm_head",
                 "blocks.wq@scale", "blocks.w_down@scale", "lm_head@scale"):
        t = scope.find_var(name)
        assert t.dtype == (torch.int8 if "@" not in name else torch.float32)
        np.testing.assert_array_equal(t.numpy(), jarr[name])
    jq = _gen(jfluid, jllama, feed="qtok", max_new_tokens=NEW,
              quantize=True)
    want = _run_jax(jq[0], jq[2], jscope, {"qtok": prompt})[0]
    tq = _gen(tfluid, tllama, feed="qtok", max_new_tokens=NEW,
              quantize=True)
    got = _run_port(tq[0], tq[2], scope, {"qtok": prompt})[0]
    carried = _run_port(tq[0], tq[2], _port_scope(jscope),
                        {"qtok": prompt})[0]
    np.testing.assert_array_equal(got[:, :PROMPT], prompt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(carried, want)
    assert (got == ref).mean() >= 0.9


def test_eos_masks_remaining_tokens():
    """After a row emits eos_id it emits pad_id (no early exit: the loop
    runs its fixed count), as the reference's."""
    jscope, rng = _jax_trained_scope(0, 3)
    scope = _port_scope(jscope)
    prompt = rng.randint(0, CFG["vocab_size"], (2, PROMPT)).astype(np.int64)
    base = _gen(tfluid, tllama, max_new_tokens=NEW)
    free = _run_port(base[0], base[2], scope, {"ptok": prompt})[0]
    eos, pad = int(free[0, PROMPT]), CFG["vocab_size"] - 1
    kw = dict(feed="etok", max_new_tokens=NEW, eos_id=eos, pad_id=pad)
    tgen = _gen(tfluid, tllama, **kw)
    got = _run_port(tgen[0], tgen[2], scope, {"etok": prompt})[0]
    jgen = _gen(jfluid, jllama, **kw)
    np.testing.assert_array_equal(
        got, _run_jax(jgen[0], jgen[2], jscope, {"etok": prompt})[0])
    for row in got:
        hits = np.where(row[PROMPT:] == eos)[0]
        if hits.size:
            assert (row[PROMPT + hits[0] + 1:] == pad).all()
    assert got[0, PROMPT] == eos and (got[0, PROMPT + 1:] == pad).all()
    np.testing.assert_array_equal(got[:, :PROMPT], prompt)


def test_mesh_and_moe_generation_refused_by_name():
    """The mesh and MoE generation cases build now (tp/dp
    sharding annotations, the MoE stacks, W8A8 on a dp mesh, quantized
    MoE; tests/test_torch_llama_mesh.py runs them); what stays refused,
    by name: speculative decoding and the paged engine with MoE
    configs, as in the reference."""
    for kw in (dict(shard_tp=True), dict(shard_dp=True),
               dict(quantize=True, shard_dp=True)):
        prog, _, outs = _gen(tfluid, tllama, max_new_tokens=NEW, **kw)
        gb = prog.global_block()
        if kw.get("shard_tp"):
            assert gb.var("blocks.wq").sharding == (None, None, "tp")
            assert gb.var("blocks.wo").sharding == (None, "tp", None)
        if kw.get("shard_dp"):
            assert outs[0].sharding == ("dp", None)
    moe = dict(CFG, ffn_hidden=48, moe_experts=4)
    for kw in ({}, dict(quantize=True)):
        prog, _, _ = _gen(tfluid, tllama, moe, max_new_tokens=NEW, **kw)
        gb = prog.global_block()
        assert tuple(gb.var("blocks.moe_w_gate").shape) == (2, 4, 32, 48)
        assert ("blocks.moe_w_gate@scale" in gb.vars) == bool(kw)
    assert callable(tmoe.moe_apply_no_drop)
    mcfg = tllama.LlamaConfig(**moe)
    with tfluid.unique_name.guard(), tfluid.program_guard(tfluid.Program(),
                                                          tfluid.Program()):
        ptok = tfluid.layers.data(name="ptok", shape=[-1, PROMPT],
                                  dtype="int64", append_batch_size=False)
        with pytest.raises(NotImplementedError, match="MoE"):
            tllama.build_llama_spec_generator(mcfg, mcfg, ptok, NEW)
        with pytest.raises(NotImplementedError, match="MoE"):
            tllama.build_llama_paged_programs(
                mcfg, max_batch=2, page_size=4, n_pages=8, pages_per_seq=4,
                prompt_buckets=(8,))


def test_unstacked_dense_weights_generate_via_stacking():
    """A dense model trained on the per-layer path serves through
    stack_generator_weights: the port stacks the carried per-layer scope
    and generates the reference's tokens and its own recompute's."""
    jscope, rng = _jax_trained_scope(3, 11, stacked=False)
    prompt = rng.randint(0, CFG["vocab_size"], (2, PROMPT)).astype(np.int64)
    scope = _port_scope(jscope)
    fwd, logits = _forward(tfluid, tllama, stacked=False)
    seq = prompt.copy()
    for _ in range(NEW):
        lg = _run_port(fwd, [logits], scope, {"ftok": seq})[0]
        seq = np.concatenate([seq, lg[:, -1].argmax(-1)[:, None]], axis=1)
    tllama.stack_generator_weights(tllama.LlamaConfig(**CFG), scope)
    jllama.stack_generator_weights(jllama.LlamaConfig(**CFG), jscope)
    np.testing.assert_array_equal(scope.find_var("blocks.w_up").numpy(),
                                  np.asarray(jscope.find_var("blocks.w_up")))
    tgen = _gen(tfluid, tllama, max_new_tokens=NEW)
    got = _run_port(tgen[0], tgen[2], scope, {"ptok": prompt})[0]
    jgen = _gen(jfluid, jllama, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, seq)
    np.testing.assert_array_equal(
        got, _run_jax(jgen[0], jgen[2], jscope, {"ptok": prompt})[0])


def test_unrolled_decode_matches_scan_decode():
    """unroll_layers / decode_unroll are kept on the op and change nothing
    in the port: the tokens equal the default's (and the reference's
    unrolled run's)."""
    jscope, _ = _jax_trained_scope(0, 0)
    scope = _port_scope(jscope)
    pv = np.random.RandomState(0).randint(
        0, CFG["vocab_size"], (2, PROMPT)).astype(np.int64)
    outs = {}
    for label, kw in (("base", {}), ("unrolled", dict(unroll_layers=True,
                                                      decode_unroll=3))):
        prog, _, fetch = _gen(tfluid, tllama, max_new_tokens=NEW, **kw)
        op = prog.global_block().ops[-1]
        assert op.attr("unroll_layers") == kw.get("unroll_layers", False)
        outs[label] = _run_port(prog, fetch, scope, {"ptok": pv})[0]
    jgen = _gen(jfluid, jllama, max_new_tokens=NEW, unroll_layers=True,
                decode_unroll=3)
    np.testing.assert_array_equal(outs["base"], outs["unrolled"])
    np.testing.assert_array_equal(
        outs["base"], _run_jax(jgen[0], jgen[2], jscope, {"ptok": pv})[0])


def test_kv_int8_generation_matches_bf16_cache():
    """int8 KV cache on a sharpened model (lm head x 40): the reference
    test's claims on the port (prompt echo, the first token equal to the
    full-precision cache's, > 80% token agreement, max |dp| < 0.02 and
    KL < 1e-3 on FirstProbs), and the port's int8-cache tokens equal the
    reference's."""
    jscope, _ = _jax_trained_scope(0, 0)
    jscope.set("lm_head", np.asarray(jscope.find_var("lm_head")) * 40)
    scope = _port_scope(jscope)
    prompt = np.random.RandomState(0).randint(
        0, CFG["vocab_size"], (4, PROMPT)).astype(np.int64)
    ref_p = _gen(tfluid, tllama, feed="t", max_new_tokens=12,
                 return_probs=True)
    q8_p = _gen(tfluid, tllama, feed="t", max_new_tokens=12, kv_int8=True,
                return_probs=True)
    ref, p_f = _run_port(ref_p[0], ref_p[2], scope, {"t": prompt})
    q8, p_8 = _run_port(q8_p[0], q8_p[2], scope, {"t": prompt})
    j8 = _gen(jfluid, jllama, feed="t", max_new_tokens=12, kv_int8=True,
              return_probs=True)
    want, wprobs = _run_jax(j8[0], j8[2], jscope, {"t": prompt})
    np.testing.assert_array_equal(q8, want)
    np.testing.assert_allclose(p_8, wprobs, **PROBS_TOL)
    np.testing.assert_array_equal(q8[:, :PROMPT], prompt)
    np.testing.assert_array_equal(q8[:, PROMPT], ref[:, PROMPT])
    assert (ref == q8).mean() > 0.8
    np.testing.assert_allclose(p_8.sum(-1), 1.0, atol=1e-5)
    assert np.abs(p_8 - p_f).max() < 0.02
    kl = (p_f * (np.log(p_f + 1e-12) - np.log(p_8 + 1e-12))).sum(-1)
    assert kl.max() < 1e-3


def test_builder_guards():
    """Sampling parameters and max_new_tokens fail when the generator is
    built, as the reference's."""
    for bad, msg in ((dict(temperature=-0.5), "temperature"),
                     (dict(temperature=0.8, top_p=0.0), "top_p"),
                     (dict(temperature=0.8, top_k=-2), "top_k"),
                     (dict(max_new_tokens=0), "max_new_tokens")):
        kw = dict(dict(max_new_tokens=NEW), **bad)
        with pytest.raises(ValueError, match=msg):
            _gen(tfluid, tllama, **kw)
        with pytest.raises(ValueError, match=msg):
            _gen(jfluid, jllama, **kw)


# ---------------------------------------------------------------------------
# the pieces, on equal inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.9), (0.8, 50, 0.9),
    (0.5, 1, 0.5)])
def test_warp_logits_matches_reference(temperature, top_k, top_p):
    logits = np.random.RandomState(2).randn(3, 97).astype(np.float32) * 3
    want = np.asarray(jtops.warp_logits(jnp.asarray(logits), temperature,
                                        top_k, top_p))
    got = ttops.warp_logits(torch.as_tensor(logits), temperature, top_k,
                            top_p).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == -1e30, want == -1e30)


def test_warp_logits_guards():
    x = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="top_k"):
        ttops.warp_logits(x, 1.0, top_k=-1)
    with pytest.raises(ValueError, match="top_p"):
        ttops.warp_logits(x, 1.0, top_p=0.0)


@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 5, 2, 16)])
def test_act_quant_bit_equal(shape):
    x = (np.random.RandomState(1).randn(*shape) * 3).astype(np.float32)
    x[0, ...] = 0.0                         # an all-zero row: scale 1e-8/127
    jq, js = jmoe._act_quant(jnp.asarray(x))
    tq, ts = tmoe._act_quant(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", [(1, 4096, 64), (4, 512, 96),
                                   (17, 384, 40), (32, 256, 8)])
def test_qmat_int32_and_result_match_reference(m, k, n):
    """qmat's int32 accumulators equal the exact product, and its float
    result equals the reference's qmat on the same int8 weight and
    scales."""
    rng = np.random.RandomState(m)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    sc = (rng.rand(1, n).astype(np.float32) + 0.5) / 127
    xq, _ = tmoe._act_quant(torch.as_tensor(x))
    y32 = ttops.int8_mm(xq, torch.as_tensor(w))
    assert y32.dtype == torch.int32
    np.testing.assert_array_equal(
        y32.numpy(), xq.numpy().astype(np.int64) @ w.astype(np.int64))
    got = ttops.qmat(torch.as_tensor(x), {"W": torch.as_tensor(w),
                                          "WScale": torch.as_tensor(sc)},
                     "W").numpy()
    want = np.asarray(jtops.qmat(jnp.asarray(x), {
        "W": jnp.asarray(w), "WScale": jnp.asarray(sc)}, "W"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eq,a_shape,b_shape", [
    ("bqgrd,bkgd->bgrqk", (2, 3, 2, 2, 1100), (2, 5, 2, 1100)),
    ("bgrqk,bkgd->bqgrd", (1, 2, 2, 3, 2500), (1, 2500, 2, 8))])
def test_int8_contraction_exact_past_1040(eq, a_shape, b_shape):
    """The int8 KV-cache contractions over more than 1040 terms (where a
    single float32 sum of 127**2-sized products would round) equal the
    int64 product and the reference's int32 einsum."""
    rng = np.random.RandomState(0)
    a = rng.choice([-127, 127], a_shape).astype(np.int8)
    b = rng.choice([-127, 127], b_shape).astype(np.int8)
    got = ttops.int8_einsum(eq, torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    want = np.einsum(eq, a.astype(np.int64), b.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jnp.einsum(eq, jnp.asarray(a), jnp.asarray(b),
                     preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_generator_weights_bit_equal(dtype):
    """The port's torch recipe (per layer, head in column blocks) gives
    the reference numpy recipe's int8 values and scales bit for bit,
    from float32 and from bfloat16 weights."""
    cfg = dict(CFG, dtype=dtype)
    rng = np.random.RandomState(5)
    names = [f"blocks.{s}" for s in tllama._QUANT_SUFFIXES] + ["lm_head"]
    shapes = {"blocks.wq": (2, 32, 32), "blocks.wk": (2, 32, 16),
              "blocks.wv": (2, 32, 16), "blocks.wo": (2, 32, 32),
              "blocks.w_gate": (2, 32, 64), "blocks.w_up": (2, 32, 64),
              "blocks.w_down": (2, 64, 32), "lm_head": (32, 64)}
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    arrays = {n: (rng.randn(*shapes[n]) * 0.05).astype(npdt) for n in names}
    arrays["lm_head"][:, 3] = 0                 # an all-zero column
    jscope = jfluid.Scope()
    for n, a in arrays.items():
        jscope.set(n, a)
    jllama.quantize_generator_weights(jscope)
    scope = weights.load_state(tfluid.Scope(), arrays, CPU)
    tllama.quantize_generator_weights(scope)
    for n in names:
        for key in (n, n + "@scale"):
            np.testing.assert_array_equal(
                scope.find_var(key).numpy(), np.asarray(jscope.find_var(key)),
                err_msg=key)
    assert tllama.LlamaConfig(**cfg).dtype == dtype


def test_int8_scope_carries_across():
    """weights.load_state carries int8 arrays and their float32 @scale
    companions as int8 and float32 tensors, and dump_state gives them
    back unchanged."""
    arrays = {"blocks.wq": np.arange(-6, 6, dtype=np.int8).reshape(3, 4),
              "blocks.wq@scale": np.full((1, 4), 0.5, np.float32)}
    scope = weights.load_state(tfluid.Scope(), arrays, CPU)
    assert scope.find_var("blocks.wq").dtype == torch.int8
    back = weights.dump_state(scope)
    for n, a in arrays.items():
        assert back[n].dtype == a.dtype
        np.testing.assert_array_equal(back[n], a)


def test_moe_config_dataclass_unchanged():
    """The port's LlamaConfig keeps the reference's fields (MoE ones
    included), so a saved llama_config.json loads in either package."""
    assert [f.name for f in dataclasses.fields(tllama.LlamaConfig)] == \
        [f.name for f in dataclasses.fields(jllama.LlamaConfig)]
