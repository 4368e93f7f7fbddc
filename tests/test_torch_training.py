"""Training through the torch port's Executor, against the JAX package.

Both packages build each train program with the same layer code and the
same ``optimizer.minimize``; the JAX startup initializes the state and
the scope is carried across as numpy (paddle_tpu_torch.weights). Then
the same feeds go through both executors.

Tolerances (the f32 tiers of tests/test_attention.py and
tests/test_llama.py): step-1 gradients rtol 2e-3 / atol 2e-4; per-step
losses rtol 2e-3; parameters after SGD steps rtol 1e-5 / atol 1e-6
(the update is elementwise; only the gradients' summation order
differs). Optimizer rules: f32 rtol 1e-5 / atol 1e-6; bf16 storage one
bf16 ulp (rtol 2**-7), since both round the same f32 result to bf16.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import paddle_tpu as jfluid
import paddle_tpu.ops.pallas_attention as pa
from paddle_tpu.core import lowering as jax_lowering
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.core import lowering as pt_lowering
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
LOSS_RTOL = 2e-3


def _mnist(fluid, make_opt, size=10):
    """The verify recipe: fc → softmax_with_cross_entropy → mean → opt."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[784], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        logits = fluid.layers.fc(x, size=size)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        make_opt(fluid).minimize(loss)
    return main, startup, loss


def _llama(fluid, llama, cfg_kw, make_opt):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name="tokens", shape=[-1, -1],
                                   dtype="int64", append_batch_size=False)
        targets = fluid.layers.data(name="targets", shape=[-1, -1],
                                    dtype="int64", append_batch_size=False)
        _, loss = llama.build_llama(llama.LlamaConfig(**cfg_kw), tokens,
                                    targets)
        make_opt(fluid).minimize(loss)
    return main, startup, loss


def _mnist_feed(step, batch=16):
    rng = np.random.RandomState(100 + step)
    y = rng.randint(0, 10, (batch, 1)).astype(np.int64)
    x = (np.eye(10, 784, dtype=np.float32)[y[:, 0]] * 3.0
         + rng.randn(batch, 784).astype(np.float32))
    return {"x": x, "y": y}


def _llama_feed(step, b=2, t=16, vocab=256):
    toks = np.random.RandomState(200 + step).randint(0, vocab, (b, t)) \
        .astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


TINY = dict(vars(jllama.LLAMA_TINY))
HD128 = dict(vocab_size=256, dim=256, n_layers=1, n_heads=2, n_kv_heads=1,
             ffn_hidden=256, dtype="float32")
# head dim 256: the reference's Pallas kernels take it (D % 128 == 0),
# as the port's kernels do in 128-column slices
HD256 = dict(vocab_size=256, dim=512, n_layers=1, n_heads=2, n_kv_heads=1,
             ffn_hidden=256, dtype="float32")


def _pair(build, *args):
    """(jax main, startup, loss), (port main, startup, loss) and one JAX
    startup scope carried into a port scope."""
    jprog = build(jfluid, *args) if build is _mnist else \
        build(jfluid, jllama, *args)
    tprog = build(tfluid, *args) if build is _mnist else \
        build(tfluid, tllama, *args)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jprog[1], scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    tscope = weights.load_state(tfluid.Scope(), arrays, CPU)
    return jprog, tprog, jscope, tscope


def _adam(fluid):
    return fluid.optimizer.Adam(learning_rate=0.01)


def _sgd(fluid):
    return fluid.optimizer.SGD(learning_rate=0.1)


def _grad_names(prog):
    return sorted(v for v in prog.global_block().vars if v.endswith("@GRAD"))


def _scalar(x):
    return float(np.asarray(x).reshape(()))


@pytest.mark.parametrize("model", ["mnist", "llama_tiny", "llama_hd128",
                                   "llama_hd256"])
def test_training_matches_reference(monkeypatch, model):
    """Step-1 gradients of every parameter, then the per-step losses of
    5 Adam steps on fresh feeds. ``llama_hd128`` and ``llama_hd256``
    (head dims 128 and 256, T = 128) run the reference's Pallas K1, K2
    and K3 through the interpreter."""
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    if model == "mnist":
        (jm, _, jl), (tm, _, tl), jscope, tscope = _pair(_mnist, _adam)
        feed, steps = _mnist_feed, 5
    else:
        cfg = {"llama_tiny": TINY, "llama_hd128": HD128,
               "llama_hd256": HD256}[model]
        (jm, _, jl), (tm, _, tl), jscope, tscope = _pair(_llama, cfg, _adam)
        t = 16 if model == "llama_tiny" else 128
        feed = lambda s: _llama_feed(s, t=t)  # noqa: E731
        steps = 5 if model == "llama_tiny" else 2
    grads = _grad_names(tm)
    assert grads == _grad_names(jm) and grads
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    want = jexe.run(jm, feed=feed(0), fetch_list=[jl] + grads, scope=jscope)
    got = texe.run(tm, feed=feed(0), fetch_list=[tl] + grads, scope=tscope)
    np.testing.assert_allclose(_scalar(got[0]), _scalar(want[0]),
                               rtol=LOSS_RTOL)
    for name, g, w in zip(grads, got[1:], want[1:]):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=name)
    jl_, tl_ = [], []
    for s in range(1, steps):
        jl_.append(_scalar(jexe.run(jm, feed=feed(s), fetch_list=[jl],
                                    scope=jscope)[0]))
        tl_.append(_scalar(texe.run(tm, feed=feed(s), fetch_list=[tl],
                                    scope=tscope)[0]))
    np.testing.assert_allclose(tl_, jl_, rtol=LOSS_RTOL)
    assert all(np.isfinite(tl_))


def test_params_after_sgd_steps_match_reference():
    (jm, _, jl), (tm, _, tl), jscope, tscope = _pair(_mnist, _sgd)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for s in range(3):
        jexe.run(jm, feed=_mnist_feed(s), fetch_list=[jl], scope=jscope)
        texe.run(tm, feed=_mnist_feed(s), fetch_list=[tl], scope=tscope)
    names = [p.name for p in tm.all_parameters()]
    assert names
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def _mnist_reg_clip(fluid, lr_mult=1.0):
    """Two fc layers whose parameters carry every regularizer and
    gradient clip the optimizer applies, and a per-parameter learning
    rate multiplier: L2Decay + GradientClipByGlobalNorm, L1Decay +
    GradientClipByValue, GradientClipByNorm."""
    main, startup = fluid.Program(), fluid.Program()
    reg, clip = fluid.regularizer, fluid.clip
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[784], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, param_attr=fluid.ParamAttr(
            regularizer=reg.L2Decay(1e-2),
            gradient_clip=clip.GradientClipByGlobalNorm(0.5)),
            bias_attr=fluid.ParamAttr(
                regularizer=reg.L1Decay(1e-3),
                gradient_clip=clip.GradientClipByValue(0.05)))
        logits = fluid.layers.fc(h, size=10, param_attr=fluid.ParamAttr(
            gradient_clip=clip.GradientClipByNorm(0.2),
            learning_rate=lr_mult))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_regularizers_clips_and_lr_multiplier_match_reference():
    """The ops regularizer.py and clip.py append (scale, sign,
    elementwise add/div/max/mul, clip, clip_by_norm, squared_l2_norm,
    sum, sqrt, fill_constant) and a ParamAttr learning-rate multiplier
    (a scaled lr var) give the reference's parameters after 3 SGD
    steps."""
    jm, jstart, jl = _mnist_reg_clip(jfluid, lr_mult=0.5)
    tm, _, tl = _mnist_reg_clip(tfluid, lr_mult=0.5)
    types = [o.type for o in tm.global_block().ops]
    assert types == [o.type for o in jm.global_block().ops]
    for op in ("clip", "clip_by_norm", "squared_l2_norm", "sign", "sqrt"):
        assert op in types, op
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    tscope = weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, CPU)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for s in range(3):
        want = jexe.run(jm, feed=_mnist_feed(s), fetch_list=[jl],
                        scope=jscope)
        got = texe.run(tm, feed=_mnist_feed(s), fetch_list=[tl],
                       scope=tscope)
        np.testing.assert_allclose(_scalar(got[0]), _scalar(want[0]),
                                   rtol=LOSS_RTOL)
    for p in tm.all_parameters():
        np.testing.assert_allclose(tscope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=1e-5, atol=1e-6, err_msg=p.name)


@pytest.mark.parametrize("model", ["mnist", "llama_tiny"])
def test_minimize_program_is_the_reference_program(model):
    """Identical op types, wiring, attrs and variable names (params,
    @GRAD vars, accumulators, learning rate) in the main and startup
    programs that ``minimize`` leaves behind."""
    if model == "mnist":
        jp, tp = _mnist(jfluid, _adam), _mnist(tfluid, _adam)
    else:
        jp = _llama(jfluid, jllama, TINY, _adam)
        tp = _llama(tfluid, tllama, TINY, _adam)
    assert jp[2].name == tp[2].name
    for jprog, tprog in zip(jp[:2], tp[:2]):
        jops, tops = jprog.global_block().ops, tprog.global_block().ops
        assert [o.type for o in jops] == [o.type for o in tops]
        for jo, to in zip(jops, tops):
            assert (jo.inputs, jo.outputs) == (to.inputs, to.outputs)
            assert jo.attrs == to.attrs, jo.type
        jvars, tvars = jprog.global_block().vars, tprog.global_block().vars
        assert sorted(jvars) == sorted(tvars)
        for name, jv in jvars.items():
            tv = tvars[name]
            assert (jv.shape, jv.dtype, jv.persistable) == \
                (tv.shape, tv.dtype, tv.persistable), name
    types = [o.type for o in tp[0].global_block().ops]
    assert "backward" in types and types.count("adam") == len(
        tp[0].all_parameters())


def _opt_inputs(rule, dtype, seed):
    """Inputs of one update rule: Param, Grad and the rule's state in
    ``dtype`` storage (non-negative where the rule takes a square root
    or a quotient of it); LearningRate and beta powers stay float32."""
    r = np.random.RandomState(seed)
    shape = (6, 5)

    def arr(nonneg=False, lo=0.0):
        a = r.randn(*shape).astype(np.float32)
        return np.abs(a) + lo if nonneg else a

    state = {"Param": arr(), "Grad": arr()}
    extra = {
        "sgd": {}, "proximal_gd": {},
        "momentum": {"Velocity": arr()},
        "adam": {"Moment1": arr(), "Moment2": arr(True)},
        "lamb": {"Moment1": arr(), "Moment2": arr(True)},
        "adamax": {"Moment": arr(), "InfNorm": arr(True)},
        "adagrad": {"Moment": arr(True)},
        "decayed_adagrad": {"Moment": arr(True)},
        "proximal_adagrad": {"Moment": arr(True)},
        "adadelta": {"AvgSquaredGrad": arr(True),
                     "AvgSquaredUpdate": arr(True)},
        "rmsprop": {"MeanSquare": arr(True, 1.0), "Moment": arr(),
                    "MeanGrad": arr() * 0.1},
        "ftrl": {"SquaredAccumulator": arr(True, 0.5),
                 "LinearAccumulator": arr()},
    }[rule]
    state.update(extra)
    f32 = {"LearningRate": np.asarray([0.01], np.float32)}
    if rule in ("adam", "adamax"):
        f32["Beta1Pow"] = np.asarray([0.9 ** 3], np.float32)
    if rule == "adam":
        f32["Beta2Pow"] = np.asarray([0.999 ** 3], np.float32)
    if rule == "adadelta":
        f32 = {}
    jins = {k: [jnp.asarray(v, dtype)] for k, v in state.items()}
    tins = {k: [torch.from_numpy(v).to(getattr(torch, dtype))]
            for k, v in state.items()}
    for k, v in f32.items():
        jins[k] = [jnp.asarray(v)]
        tins[k] = [torch.from_numpy(v)]
    return jins, tins


OPT_ATTRS = {
    "sgd": {}, "momentum": {"mu": 0.9, "use_nesterov": True},
    "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    "adamax": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    "adagrad": {"epsilon": 1e-6},
    "decayed_adagrad": {"decay": 0.95, "epsilon": 1e-6},
    "adadelta": {"rho": 0.95, "epsilon": 1e-6},
    "rmsprop": {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
                "centered": True},
    "ftrl": {"l1": 0.1, "l2": 0.01, "lr_power": -0.5},
    "lamb": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
             "weight_decay": 0.01},
    "proximal_gd": {"l1": 0.01, "l2": 0.01},
    "proximal_adagrad": {"l1": 0.01, "l2": 0.01},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", sorted(OPT_ATTRS))
def test_optimizer_rule_matches_reference(rule, dtype):
    """Each of the 12 update rules against the JAX rule on the same
    inputs: arithmetic in f32, every output stored in its input's
    dtype."""
    jins, tins = _opt_inputs(rule, dtype, seed=len(rule))
    jctx = jax_lowering.LoweringContext(None, "train", None)
    tctx = pt_lowering.LoweringContext(None, "train", CPU, 0, 1)
    want = jax_registry.get_op(rule).lower(jctx, jins, dict(OPT_ATTRS[rule]))
    got = pt_registry.get_op(rule).lower(tctx, tins, dict(OPT_ATTRS[rule]))
    assert set(got) == set(want)
    for slot in want:
        w, g = want[slot][0], got[slot][0]
        assert g.dtype == getattr(torch, dtype), slot
        w = np.asarray(jnp.asarray(w, jnp.float32))
        tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
            dict(rtol=2 ** -7, atol=1e-6)
        np.testing.assert_allclose(g.float().numpy(), w, **tol,
                                   err_msg=f"{rule}.{slot}")


def test_repeats_runs_steps_on_one_feed():
    """run(repeats=k) is k runs on the same feed: same state after, the
    last step's fetches; outside [1, 32] it is refused."""
    tm, tstart, tl = _mnist(tfluid, _adam)
    exe = tfluid.Executor(tfluid.CPUPlace())
    a, b = tfluid.Scope(), tfluid.Scope()
    exe.run(tstart, scope=a)
    for n in a.keys():
        b.set(n, a.find_var(n).clone())
    feed = _mnist_feed(0)
    for _ in range(3):
        last = exe.run(tm, feed=feed, fetch_list=[tl], scope=a)
    got = exe.run(tm, feed=feed, fetch_list=[tl], scope=b, repeats=3)
    np.testing.assert_array_equal(got[0], last[0])
    for n in a.keys():
        assert torch.equal(a.find_var(n), b.find_var(n)), n
    for bad in (0, 33):
        with pytest.raises(ValueError, match="repeats"):
            exe.run(tm, feed=feed, fetch_list=[tl], scope=b, repeats=bad)


def test_unreached_parameter_gets_a_zero_gradient():
    """A parameter the loss does not reach gets a zero @GRAD, as
    jax.value_and_grad gives, and SGD leaves it unchanged."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[784], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            fluid.layers.fc(x, size=4, param_attr=fluid.ParamAttr(
                name="unused.w"), bias_attr=False)
            logits = fluid.layers.fc(x, size=10)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, startup, loss

    jm, jstart, jl = build(jfluid)
    tm, _, tl = build(tfluid)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    tscope = weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, CPU)
    before = tscope.find_var("unused.w").clone()
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=_mnist_feed(0), fetch_list=["unused.w@GRAD"], scope=jscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=_mnist_feed(0), fetch_list=["unused.w@GRAD"], scope=tscope)
    assert not np.asarray(want[0]).any() and not got[0].any()
    assert got[0].shape == (784, 4)
    assert torch.equal(tscope.find_var("unused.w"), before)


def test_loss_softmax_is_computed_only_when_read(monkeypatch):
    """softmax_with_cross_entropy's Softmax output, which a train step's
    loss does not read, is skipped (as jax.jit drops it as dead code);
    fetched, it is computed and equals the reference's."""
    wanted = []
    real = pt_lowering.LoweringContext.wants
    monkeypatch.setattr(
        pt_lowering.LoweringContext, "wants",
        lambda self, slot: wanted.append(
            (self.op.type, slot, real(self, slot))) or real(self, slot))
    (jm, _, jl), (tm, _, tl), jscope, tscope = _pair(_mnist, _sgd)
    fresh = weights.load_state(
        tfluid.Scope(), {n: np.asarray(jscope.find_var(n))
                         for n in jscope.keys()}, CPU)
    sm = next(op.output("Softmax")[0] for op in tm.global_block().ops
              if op.type == "softmax_with_cross_entropy")
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tm, feed=_mnist_feed(0), fetch_list=[tl], scope=tscope)
    assert wanted == [("softmax_with_cross_entropy", "Softmax", False)]
    wanted.clear()
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=_mnist_feed(0), fetch_list=[jl, sm], scope=jscope)
    got = texe.run(tm, feed=_mnist_feed(0), fetch_list=[tl, sm],
                   scope=fresh)
    assert wanted == [("softmax_with_cross_entropy", "Softmax", True)]
    assert got[1].shape == (16, 10)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_optimizer_state_round_trips_through_weights():
    """The whole train state — parameters, Adam moments, the float32
    beta*_pow_acc and learning_rate_* — carries from the JAX package to
    the port and back through weights.py, bit for bit in bf16, and
    training continues alike on either side."""
    cfg = dict(TINY, dtype="bfloat16")
    (jm, _, jl), (tm, _, tl), jscope, tscope = _pair(_llama, cfg, _adam)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    for s in range(2):
        jexe.run(jm, feed=_llama_feed(s), fetch_list=[jl], scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()}
    kinds = {"moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc",
             "learning_rate"}
    assert all(any(k in n for n in arrays) for k in kinds)
    for n, a in arrays.items():
        if "pow_acc" in n or n.startswith("learning_rate"):
            assert a.dtype == np.float32, n
        else:
            assert a.dtype == ml_dtypes.bfloat16, n
    tscope = weights.load_state(tfluid.Scope(), arrays, CPU)
    np.testing.assert_allclose(
        tscope.find_var(next(n for n in arrays if "beta2_pow" in n)).numpy(),
        [0.999 ** 3], rtol=1e-6)
    back = weights.dump_state(tscope, bfloat16=ml_dtypes.bfloat16)
    assert set(back) == set(arrays)
    for n, a in arrays.items():
        assert back[n].dtype == a.dtype, n
        np.testing.assert_array_equal(back[n].view(np.uint8),
                                      a.view(np.uint8), err_msg=n)
    # one more step on either side from the carried state
    want = jexe.run(jm, feed=_llama_feed(2), fetch_list=[jl], scope=jscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=_llama_feed(2), fetch_list=[tl], scope=tscope)
    np.testing.assert_allclose(_scalar(got[0]), _scalar(want[0]), rtol=2e-2)
    np.testing.assert_allclose(
        tscope.find_var(next(n for n in arrays if "beta1_pow" in n)).numpy(),
        [0.9 ** 4], rtol=1e-6)


def test_train_step_runs_the_backward_kernels_once_per_layer(monkeypatch):
    """Every layer's attention backward goes through K2's and K3's
    wrappers (on the CPU they run the plain versions): one call each per
    layer per step, after one K1 call per layer."""
    calls = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(fa, name)
        monkeypatch.setattr(
            fa, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    tm, tstart, tl = _llama(tfluid, tllama, TINY, _adam)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    exe.run(tm, feed=_llama_feed(0), fetch_list=[tl], scope=scope)
    n = TINY["n_layers"]
    assert calls == ["flash_fwd"] * n + ["flash_bwd_dq", "flash_bwd_dkv"] * n
