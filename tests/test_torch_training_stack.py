"""The reference's train-benchmark path through the torch port, against
the JAX package: the layer-stacked decoder (``build_llama(shard_pp=
True)``, ``llama_decoder_stack``) with per-layer remat, the
vocab-chunked fused loss (``fused_head_chunk``), ``memory_optimize``'s
policies and the NaN guard.

Both packages build each program with the same layer code; the JAX
startup initializes the state and the scope crosses as numpy
(paddle_tpu_torch.weights). The reference runs its Pallas path as its
own tests run it on the CPU (``_FORCE_INTERPRET``; head dims 16 and 64
are off its D % 128 == 0 gate, so its attention takes the plain path).

Tolerances: the fused loss at tests/test_fused_loss.py's (forward rtol
1e-5 / atol 1e-5, dH and dW rtol 1e-4 / atol 1e-5); the Llama steps in
float32 at rtol 2e-4 / atol 2e-5 for the loss and every gradient, and
rtol 2e-4 for the losses of 3 Adam steps (only summation order
differs); served logits rtol 2e-4 / atol 2e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu.ops.pallas_attention as pa
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.fused_loss import _fused_ce

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_loss as fl
from paddle_tpu_torch.serving import BucketSpec, ServingConfig, ServingEngine

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_RTOL = 2e-4
TINY = dict(vars(jllama.LLAMA_TINY))                    # head dim 16
HD64 = dict(TINY, dim=128, n_heads=2, n_kv_heads=1)     # head dim 64
CHUNK = 48      # 256 = 5 x 48 + 16: the last chunk slides back by 32


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)


# ---------------------------------------------------------------------------
# the fused loss against the reference's _fused_ce
# ---------------------------------------------------------------------------

FUSED_CASES = {
    # name: (N, D, V, chunk, ignore some targets)
    "aligned": (24, 16, 64, 16, False),
    "sliding_last_chunk": (24, 16, 53, 16, False),
    "ignore_index": (24, 16, 53, 16, True),
    "chunk_past_vocab": (24, 16, 53, 64, False),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_loss_matches_reference(case):
    n, d, v, chunk, ignore = FUSED_CASES[case]
    rng = np.random.RandomState(1)
    h = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, v).astype(np.float32)
    t = rng.randint(0, v, (n,)).astype(np.int64)
    if ignore:
        t[::3] = -100
    gw = rng.rand(n).astype(np.float32)  # non-uniform cotangent
    jchunk = min(chunk, v)               # the reference op clamps

    def jloss(h_, w_):
        return jnp.sum(_fused_ce(h_, w_, jnp.asarray(t), jchunk, v, -100)
                       * gw)

    want = np.asarray(_fused_ce(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(t), jchunk, v, -100))
    dh_w, dw_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                                  jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = fl.fused_head_cross_entropy(th, tw, torch.from_numpy(t), chunk)
    (got * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_w),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_w),
                               rtol=1e-4, atol=1e-5)
    if ignore:
        assert (got.detach().numpy()[::3] == 0).all()


def test_fused_loss_chunk_start_slides_the_last_chunk_back():
    # the last chunk ends at V; the columns an earlier chunk covered are
    # pushed to NEG_BIG, so the online log-sum-exp sees each column once
    assert [fl._chunk_start(i, 16, 53) for i in range(4)] == [0, 16, 32, 37]
    h = torch.randn(3, 4)
    w = torch.randn(4, 53)
    logits, _, start = fl._chunk_logits(h, w, 3, 16, 53)
    assert start == 37
    assert (logits[:, :11] == fl.NEG_BIG).all()
    torch.testing.assert_close(logits[:, 11:], h @ w[:, 48:])


# ---------------------------------------------------------------------------
# the stacked, rematerialised Llama against the reference
# ---------------------------------------------------------------------------


def _llama(fluid, llama, cfg, policy=None, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        targets = fluid.layers.data(name="targets", shape=[-1, -1],
                                    dtype="int64", append_batch_size=False)
        _, loss = llama.build_llama(llama.LlamaConfig(**cfg), tokens,
                                    targets, **kw)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    if policy:
        fluid.memory_optimize(main, policy=policy)
    return main, startup, loss


def _pair(cfg, policy=None, **kw):
    """(jax main, loss), (port main, loss), jax scope, port scope — one
    JAX startup carried into the port."""
    jm, js, jl = _llama(jfluid, jllama, cfg, policy, **kw)
    tm, ts, tl = _llama(tfluid, tllama, cfg, policy, **kw)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(js, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    tscope = weights.load_state(tfluid.Scope(), arrays, CPU)
    return (jm, jl), (tm, tl), jscope, tscope


def _feed(step, vocab=256, b=2, t=16):
    toks = np.random.RandomState(300 + step).randint(0, vocab, (b, t)) \
        .astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _grad_names(prog):
    return sorted(v for v in prog.global_block().vars if v.endswith("@GRAD"))


def _scalar(x):
    return float(np.asarray(x).reshape(()))


def _check_step_and_adam(jpair, tpair, jscope, tscope, steps=3):
    """Loss and every gradient of one step, then ``steps`` Adam steps'
    losses, port against reference."""
    (jm, jl), (tm, tl) = jpair, tpair
    grads = _grad_names(tm)
    assert grads == _grad_names(jm) and grads
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    want = jexe.run(jm, feed=_feed(0), fetch_list=[jl] + grads, scope=jscope)
    got = texe.run(tm, feed=_feed(0), fetch_list=[tl] + grads, scope=tscope)
    for name, g, w in zip(["loss"] + grads, got, want):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w), **TOL, err_msg=name)
    jls, tls = [], []
    for s in range(1, steps + 1):
        jls.append(_scalar(jexe.run(jm, feed=_feed(s), fetch_list=[jl],
                                    scope=jscope)[0]))
        tls.append(_scalar(texe.run(tm, feed=_feed(s), fetch_list=[tl],
                                    scope=tscope)[0]))
    np.testing.assert_allclose(tls, jls, rtol=LOSS_RTOL)
    assert all(np.isfinite(tls))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["logits", "fused"])
@pytest.mark.parametrize("cfg", [TINY, HD64], ids=["hd16", "hd64"])
def test_stacked_llama_trains_as_the_reference(cfg, chunk, remat):
    jpair, tpair, jscope, tscope = _pair(cfg, shard_pp=True,
                                         fused_head_chunk=chunk, remat=remat)
    _check_step_and_adam(jpair, tpair, jscope, tscope)


def test_stacked_program_is_the_reference_program():
    """Op types, parameter names, shapes and dtypes, one for one."""
    (jm, _), (tm, _), _, _ = _pair(TINY, shard_pp=True,
                                   fused_head_chunk=CHUNK)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert "llama_decoder_stack" in [op.type for op in tm.global_block().ops]
    assert "fused_head_cross_entropy" in \
        [op.type for op in tm.global_block().ops]
    jp = {p.name: (tuple(p.shape), p.dtype) for p in jm.all_parameters()}
    tp = {p.name: (tuple(p.shape), p.dtype) for p in tm.all_parameters()}
    assert tp == jp
    assert tp["blocks.wq"][0][0] == TINY["n_layers"]


def test_stacked_op_keeps_scan_unroll_and_n_micro_and_ignores_them():
    """On one device ``scan_unroll`` and ``pp_n_micro`` change nothing,
    as in the reference's branch without a 'pp' mesh axis."""
    losses = []
    for kw in ({}, dict(scan_unroll=2, pp_n_micro=2)):
        (_, _), (tm, tl), _, tscope = _pair(TINY, shard_pp=True,
                                            fused_head_chunk=CHUNK, **kw)
        op = next(o for o in tm.global_block().ops
                  if o.type == "llama_decoder_stack")
        assert op.attr("scan_unroll") == kw.get("scan_unroll", 1)
        assert op.attr("n_micro") == kw.get("pp_n_micro", 0)
        losses.append(tfluid.Executor(tfluid.CPUPlace()).run(
            tm, feed=_feed(0), fetch_list=[tl], scope=tscope)[0])
    np.testing.assert_array_equal(losses[0], losses[1])


def test_fused_head_chunk_without_targets_raises_and_hides_logits():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        tokens = tfluid.layers.data(name="tokens", shape=[-1, -1],
                                    dtype="int64", append_batch_size=False)
        with pytest.raises(ValueError, match="requires targets"):
            tllama.build_llama(tllama.LLAMA_TINY, tokens,
                               fused_head_chunk=CHUNK)
        logits, loss = tllama.build_llama(tllama.LLAMA_TINY, tokens, tokens,
                                          shard_pp=True,
                                          fused_head_chunk=CHUNK)
    assert logits is None and loss is not None


def test_stacked_forward_serves_as_the_reference():
    """The forward-only stacked program (logits through lm_head) behind
    the port's ServingEngine, against the reference's Executor on each
    request alone."""
    progs = {}
    for name, fluid, llama in (("jax", jfluid, jllama),
                               ("port", tfluid, tllama)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                       dtype="int64", append_batch_size=False)
            logits, _ = llama.build_llama(llama.LlamaConfig(**HD64), tokens,
                                          shard_pp=True)
        progs[name] = (main.clone(for_test=True), startup, logits)
    jinfer, jstart, jlogits = progs["jax"]
    tinfer, _, tlogits = progs["port"]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tscope = weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, CPU)
    engine = ServingEngine(tinfer, ["tokens"], [tlogits], scope=tscope,
                           place=tfluid.CPUPlace(),
                           buckets=BucketSpec(batch_sizes=(1, 2),
                                              seq_lens={"tokens": (8, 16)}),
                           config=ServingConfig(max_wait_ms=5.0))
    rng = np.random.RandomState(7)
    reqs = [rng.randint(0, 256, (1, n)).astype(np.int64) for n in (5, 16)]
    try:
        answers = [engine.infer({"tokens": r}, timeout=60.0) for r in reqs]
    finally:
        engine.close()
    for r, ans in zip(reqs, answers):
        want = np.asarray(jexe.run(jinfer, feed={"tokens": r},
                                   fetch_list=[jlogits], scope=jscope)[0])
        np.testing.assert_allclose(ans[0][:, :r.shape[1]], want, **TOL)


# ---------------------------------------------------------------------------
# memory_optimize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "everything_saveable"])
@pytest.mark.parametrize("model", ["unrolled", "stacked"])
def test_memory_optimize_matches_reference(model, policy):
    """The forward segment under the policy's checkpoint: the loss and
    every gradient as the reference's under the same policy; on the
    stacked model the checkpoint nests around each layer's own."""
    kw = dict(shard_pp=True, fused_head_chunk=CHUNK) \
        if model == "stacked" else {}
    jpair, tpair, jscope, tscope = _pair(HD64, policy, **kw)
    _check_step_and_adam(jpair, tpair, jscope, tscope, steps=1)


def _count_k1(monkeypatch):
    """Count FlashAttention's calls of K1's wrapper (the CPU runs its
    plain version)."""
    calls = []
    real = fa.flash_fwd

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_fwd", counted)
    return calls


@pytest.mark.parametrize("remat,policy,per_layer", [
    (False, None, 1), (True, None, 2), (True, "nothing_saveable", 3),
    (True, "dots_saveable", 3), (True, "everything_saveable", 2)])
def test_remat_recomputes_the_forward_kernel(monkeypatch, remat, policy,
                                             per_layer):
    """K1 runs once a layer a step, twice under per-layer remat (the
    backward's recompute), and once more under a checkpoint of the
    whole forward segment, whose recompute runs each layer's forward
    again — with the gradients of the run without any remat."""
    (_, _), (tm, tl), _, tscope = _pair(HD64, policy, shard_pp=True,
                                        fused_head_chunk=CHUNK, remat=remat)
    (_, _), (bm, bl), _, bscope = _pair(HD64, shard_pp=True,
                                        fused_head_chunk=CHUNK, remat=False)
    grads = _grad_names(tm)
    exe = tfluid.Executor(tfluid.CPUPlace())
    want = exe.run(bm, feed=_feed(0), fetch_list=[bl] + grads, scope=bscope)
    calls = _count_k1(monkeypatch)
    got = exe.run(tm, feed=_feed(0), fetch_list=[tl] + grads, scope=tscope)
    assert len(calls) == per_layer * HD64["n_layers"]
    for name, g, w in zip(["loss"] + grads, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("policy,match", [
    ("recompute_norms", "Conv nets"), ("save_conv_only", "Conv nets"),
    ("save_only_these_names", "factory"),
    ("save_anything_except_these_names", "factory"),
    ("offload_dot_with_no_batch_dims", "offload"),
    ("auto", "Fleet and analyzers")])
def test_memory_optimize_refuses_by_name(policy, match):
    main = _llama(tfluid, tllama, TINY)[0]
    with pytest.raises(NotImplementedError, match=match) as e:
        tfluid.memory_optimize(main, policy=policy)
    assert policy in str(e.value)
    assert main._remat_policy is None


def test_memory_optimize_print_log_and_unknown_policy():
    main = _llama(tfluid, tllama, TINY)[0]
    with pytest.raises(NotImplementedError, match="print_log"):
        tfluid.memory_optimize(main, print_log=True)
    with pytest.raises(ValueError, match="unknown remat policy"):
        tfluid.memory_optimize(main, policy="not_a_policy")
    v = main.version
    tfluid.memory_optimize(main)
    assert main._remat_policy == "dots_saveable" and main.version > v
    tfluid.memory_optimize(main, policy=None)
    assert main._remat_policy is None


# ---------------------------------------------------------------------------
# the NaN guard
# ---------------------------------------------------------------------------


def test_nan_guard_matches_reference():
    """Clean weights: the guarded step equals the unguarded one. One
    planted inf in blocks.wq: both packages raise FloatingPointError
    naming the same op outputs, after writing the scope. repeats > 1
    raises ValueError."""
    (jm, jl), (tm, tl), jscope, tscope = _pair(TINY, shard_pp=True,
                                               fused_head_chunk=CHUNK)
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    grads = _grad_names(tm)
    guarded = tm.clone()
    tfluid.debugger.enable_nan_guard(guarded)
    assert guarded._nan_guard and not tm._nan_guard
    plain_scope = weights.load_state(tfluid.Scope(),
                                     weights.dump_state(tscope), CPU)
    got = texe.run(guarded, feed=_feed(0), fetch_list=[tl] + grads,
                   scope=tscope)
    want = texe.run(tm, feed=_feed(0), fetch_list=[tl] + grads,
                    scope=plain_scope)
    for name, g, w in zip(["loss"] + grads, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert "__nan_guard__" not in tscope.keys()

    jfluid.debugger.enable_nan_guard(jm)
    wq = np.asarray(jscope.find_var("blocks.wq")).copy()
    wq[0, 0, 0] = np.inf
    jscope.set("blocks.wq", jnp.asarray(wq))
    tscope.set("blocks.wq", torch.from_numpy(wq.copy()))
    with pytest.raises(FloatingPointError) as je:
        jexe.run(jm, feed=_feed(1), fetch_list=[jl], scope=jscope)
    with pytest.raises(FloatingPointError) as te:
        texe.run(guarded, feed=_feed(1), fetch_list=[tl], scope=tscope)
    assert str(te.value) == str(je.value)
    assert "llama_decoder_stack -> " in str(te.value)
    # the scope was written before the guard raised
    assert not torch.isfinite(tscope.find_var("blocks.wq")).all()
    with pytest.raises(ValueError, match="NaN guard"):
        texe.run(guarded, feed=_feed(1), fetch_list=[tl], scope=tscope,
                 repeats=2)
    tfluid.debugger.disable_nan_guard(guarded)
    out = texe.run(guarded, feed=_feed(1), fetch_list=[tl], scope=tscope)
    assert not np.isfinite(out[0]).all()


def test_nan_guard_flags_once_under_remat():
    """Under memory_optimize the forward segment runs twice; the guard
    keeps one flag a float op output, labelled as without remat."""
    labels = []
    for policy in (None, "nothing_saveable"):
        (_, _), (tm, tl), _, tscope = _pair(TINY, policy, shard_pp=True,
                                            fused_head_chunk=CHUNK)
        tfluid.debugger.enable_nan_guard(tm)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tm, feed=_feed(0), fetch_list=[tl], scope=tscope)
        step_fn = next(iter(exe._cache.values()))[0]
        labels.append(list(step_fn.guard_labels))
    assert labels[0] == labels[1] and len(labels[0]) == len(set(labels[0]))


def test_stacked_llama_refuses_mesh_knobs_by_name():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        tokens = tfluid.layers.data(name="tokens", shape=[-1, -1],
                                    dtype="int64", append_batch_size=False)
        with pytest.raises(NotImplementedError, match="1f1b"):
            tllama.build_llama(tllama.LLAMA_TINY, tokens, tokens,
                               shard_pp=True, pp_schedule="1f1b")
        with pytest.raises(NotImplementedError, match="mesh"):
            tllama.build_llama(tllama.LLAMA_TINY, tokens, tokens,
                               shard_pp=True, shard_dp=True)
        with pytest.raises(ValueError, match="shard_pp composes"):
            tllama.build_llama(tllama.LLAMA_TINY, tokens, tokens,
                               shard_pp=True, shard_tp=True)
        with pytest.raises(ValueError, match="moe_experts"):
            tllama.build_llama(dataclasses.replace(tllama.LLAMA_TINY,
                                                   moe_experts=4),
                               tokens, tokens, shard_pp=True)


def test_train_step_donates_its_state(monkeypatch):
    """As the reference's Executor donates its state buffers, a train
    step writes each optimizer update into the scope's own tensor —
    Adam's rule itself, so nothing is left to copy in but the beta
    powers' new tensors — with the reference's numbers."""
    from paddle_tpu_torch.core import lowering as pt_lowering
    copied = []
    real_donate = pt_lowering._donate

    def spy(op, env, state):
        copied.extend(n for names in op.outputs.values() for n in names
                      if n in state
                      and env.d[n].data_ptr() != state[n].data_ptr())
        return real_donate(op, env, state)

    monkeypatch.setattr(pt_lowering, "_donate", spy)
    (jm, jl), (tm, tl), jscope, tscope = _pair(TINY, shard_pp=True,
                                               fused_head_chunk=CHUNK)
    before = {n: tscope.find_var(n) for n in tscope.keys()}
    initial = before["blocks.wq"].clone()
    tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=_feed(0),
                                           fetch_list=[tl], scope=tscope)
    jfluid.Executor(jfluid.CPUPlace()).run(jm, feed=_feed(0),
                                           fetch_list=[jl], scope=jscope)
    assert copied and all("_pow_acc" in n for n in copied), copied
    for name in ("blocks.wq", "lm_head", "blocks.wq_moment1_0",
                 next(n for n in copied if "beta1_pow" in n)):
        assert tscope.find_var(name) is before[name], name
        np.testing.assert_allclose(tscope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   **TOL, err_msg=name)
    assert not torch.equal(before["blocks.wq"], initial)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_updates_a_large_parameter_in_slices_bit_for_bit(monkeypatch,
                                                              dtype):
    """A parameter past ADAM_CHUNK elements is updated a slice at a time
    (so the optimizer segment's float32 temporaries stay small); every
    output is the whole-tensor update's, bit for bit, in the stored
    dtype."""
    from paddle_tpu_torch.core.registry import get_op
    from paddle_tpu_torch.ops import optimizer_ops
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    ins = {"Param": [torch.randn(300, 37, generator=g).to(dt)],
           "Grad": [torch.randn(300, 37, generator=g).to(dt)],
           "Moment1": [(torch.randn(300, 37, generator=g) * 0.1).to(dt)],
           "Moment2": [(torch.rand(300, 37, generator=g) * 0.1).to(dt)],
           "Beta1Pow": [torch.tensor([0.9 ** 3])],
           "Beta2Pow": [torch.tensor([0.999 ** 3])],
           "LearningRate": [torch.tensor([1e-3])]}
    whole = get_op("adam").lower(None, ins, {})
    monkeypatch.setattr(optimizer_ops, "ADAM_CHUNK", 1000)
    sliced = get_op("adam").lower(None, ins, {})
    for slot, (want,) in whole.items():
        got, = sliced[slot]
        assert got.dtype == want.dtype == dt, slot
        assert torch.equal(got, want), slot


def test_trained_stacked_scope_crosses_both_ways():
    """A reference scope trained with shard_pp=True (2 Adam steps) loads
    into the port as numpy and gives the reference's next loss; the
    port's scope, trained on, crosses back and gives the port's."""
    (jm, jl), (tm, tl), jscope, _ = _pair(HD64, shard_pp=True,
                                          fused_head_chunk=CHUNK)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for s in range(2):
        jexe.run(jm, feed=_feed(s), fetch_list=[jl], scope=jscope)
    tscope = weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, CPU)
    want = jexe.run(jm, feed=_feed(2), fetch_list=[jl], scope=jscope)[0]
    got = texe.run(tm, feed=_feed(2), fetch_list=[tl], scope=tscope)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=LOSS_RTOL)
    back = jfluid.Scope()
    for n, a in weights.dump_state(tscope).items():
        back.set(n, jnp.asarray(a))
    assert set(back.keys()) == set(jscope.keys())
    want = texe.run(tm, feed=_feed(3), fetch_list=[tl], scope=tscope)[0]
    got = jexe.run(jm, feed=_feed(3), fetch_list=[jl], scope=back)[0]
    np.testing.assert_allclose(np.asarray(got), want, rtol=LOSS_RTOL)


def test_fetched_and_dumped_state_keeps_its_values_after_later_steps():
    """A donating step updates the scope's tensors in place; what an
    earlier run fetched, or weights.dump_state took, stays as it was."""
    (_, _), (tm, tl), _, tscope = _pair(TINY, shard_pp=True,
                                        fused_head_chunk=CHUNK)
    exe = tfluid.Executor(tfluid.CPUPlace())
    fetched = exe.run(tm, feed=_feed(0), fetch_list=["blocks.wq", tl],
                      scope=tscope)[0]
    dumped = weights.dump_state(tscope, ["blocks.wq"])["blocks.wq"]
    kept = fetched.copy(), dumped.copy()
    exe.run(tm, feed=_feed(1), fetch_list=[tl], scope=tscope)
    assert not np.array_equal(tscope.find_var("blocks.wq").numpy(), kept[0])
    np.testing.assert_array_equal(fetched, kept[0])
    np.testing.assert_array_equal(dumped, kept[1])
