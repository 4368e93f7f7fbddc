"""Shared helpers of the sequence tests (``test_torch_sequence.py``,
``test_torch_rnn.py``, ``test_torch_seq_models.py``): the same numpy
inputs through a rule or a program of the JAX package and of the port,
compared whole — padded positions included.

Tolerances (ROADMAP "Tolerance"): float32 forwards rtol 2e-4 / atol 2e-5,
gradients (the port's autograd against the reference's ``jax.vjp`` /
``jax.grad``) rtol 2e-3 / atol 2e-4; integer outputs (lengths, indices,
ids) by value, since the port's ``canonical_int`` is int64 where the
reference's is int32.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core import lowering as jax_lowering
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import sequence as jseq
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.core import lowering as pt_lowering
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import sequence as tseq

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
CPU = torch.device("cpu")
PKGS = (("jax", jfluid, jseq), ("port", tfluid, tseq))


class S:
    """A sequence input spec: padded numpy ``data``, ``lengths`` (and
    level-2 ``counts``), made into each package's SequenceBatch."""

    def __init__(self, data, lengths, counts=None):
        self.data = np.asarray(data)
        self.lengths = np.asarray(lengths)
        self.counts = None if counts is None else np.asarray(counts)


def seqs(arrs, dtype=None, bucket=8):
    """('seq', ...) feed spec: each package's to_sequence_batch."""
    return ("seq", arrs, dtype, bucket)


def nested(arrs, dtype=None):
    """('nested', ...) feed spec: each package's
    to_nested_sequence_batch."""
    return ("nested", arrs, dtype)


def make_feed(which, spec):
    """``spec`` (name -> array, seqs(...) or nested(...)) as the feed of
    package ``which`` ("jax" or "port")."""
    mod = jseq if which == "jax" else tseq
    feed = {}
    for k, v in spec.items():
        if isinstance(v, tuple) and v and v[0] == "seq":
            feed[k] = mod.to_sequence_batch(v[1], dtype=v[2], bucket=v[3])
        elif isinstance(v, tuple) and v and v[0] == "nested":
            feed[k] = mod.to_nested_sequence_batch(v[1], dtype=v[2])
        else:
            feed[k] = v
    return feed


def _is_seq(v):
    return hasattr(v, "lengths") and hasattr(v, "data") \
        and not isinstance(v, (np.ndarray, torch.Tensor))


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def leaves(v, label="out"):
    """[(label, array)] of a fetched value: a SequenceBatch's data,
    lengths and (level 2) counts, or the array."""
    if _is_seq(v):
        out = [(f"{label}.data", _np(v.data)),
               (f"{label}.lengths", _np(v.lengths))]
        if getattr(v, "outer_counts", None) is not None:
            out.append((f"{label}.counts", _np(v.outer_counts)))
        return out
    return [(label, _np(v))]


def assert_same(got, want, tol=FWD, label="out"):
    """The port's value ``got`` against the reference's ``want``, whole:
    floats within ``tol``, integers and bools by value."""
    g, w = leaves(got, label), leaves(want, label)
    # a level-2 value whose counts one side derives from its lengths
    names = {n for n, _ in g} & {n for n, _ in w}
    g = [(n, a) for n, a in g if n in names]
    w = [(n, a) for n, a in w if n in names]
    assert [n for n, _ in g] == [n for n, _ in w], (g, w)
    for (name, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **tol)


# ---------------------------------------------------------------------------
# one rule, both packages
# ---------------------------------------------------------------------------


def _jin(v):
    if isinstance(v, S):
        return jseq.SequenceBatch(
            jnp.asarray(v.data), jnp.asarray(v.lengths, jnp.int32),
            None if v.counts is None else jnp.asarray(v.counts, jnp.int32))
    return jnp.asarray(v)


def _tin(v):
    if isinstance(v, S):
        return tseq.SequenceBatch(
            torch.from_numpy(v.data.copy()),
            torch.from_numpy(v.lengths.astype(np.int64)),
            None if v.counts is None
            else torch.from_numpy(v.counts.astype(np.int64)))
    return torch.from_numpy(np.array(v))


def _is_float(d):
    if isinstance(d, torch.Tensor):
        return d.is_floating_point()
    return jnp.issubdtype(d.dtype, jnp.floating)


def _float_outs(outs):
    """The float tensors of a rule's outputs, in slot order (a
    SequenceBatch's data)."""
    return [d for slot in sorted(outs) for v in outs[slot]
            for d in [v.data if _is_seq(v) else v] if _is_float(d)]


def rule_pair(op, ins, attrs=None, grad=(), seed=0, mode="test"):
    """Run ``op``'s rule in both packages on ``ins`` (slot -> [array or
    S]); compare every output whole, and the gradients of the float
    inputs of the ``grad`` slots through one random cotangent per float
    output. Returns (reference outputs, port outputs)."""
    attrs = dict(attrs or {})
    keys = [(s, i) for s in grad for i, v in enumerate(ins[s])
            if np.asarray(v.data if isinstance(v, S) else v).dtype.kind
            == "f"]

    def jrun(*diff):
        jins = {s: [_jin(v) for v in vals] for s, vals in ins.items()}
        for (s, i), d in zip(keys, diff):
            v = jins[s][i]
            jins[s][i] = (jseq.SequenceBatch(d, v.lengths, v.outer_counts)
                          if isinstance(v, jseq.SequenceBatch) else d)
        ctx = jax_lowering.LoweringContext(None, mode,
                                           jax.random.PRNGKey(0))
        return jax_registry.get_op(op).lower(ctx, jins, dict(attrs))

    def data_of(v):
        return v.data if isinstance(v, S) else np.asarray(v)

    diff0 = [jnp.asarray(data_of(ins[s][i])) for s, i in keys]
    jout = jrun(*diff0)
    tins = {s: [_tin(v) for v in vals] for s, vals in ins.items()}
    tleaves = []
    for s, i in keys:
        v = tins[s][i]
        d = (v.data if isinstance(v, tseq.SequenceBatch) else v)
        d.requires_grad_()
        tleaves.append(d)
    ctx = pt_lowering.LoweringContext(None, mode, CPU, 0, 1)
    with torch.enable_grad():
        tout = pt_registry.get_op(op).lower(ctx, tins, dict(attrs))
    assert set(tout) == set(jout), (set(tout), set(jout))
    for slot in jout:
        for k, (a, b) in enumerate(zip(tout[slot], jout[slot])):
            assert_same(a, b, FWD, f"{op}.{slot}[{k}]")
    if keys:
        jflat = _float_outs(jout)
        rng = np.random.RandomState(seed + 7)
        cots = [rng.randn(*o.shape).astype(np.float32) for o in jflat]

        def jsum(*diff):
            return sum(jnp.sum(o * c) for o, c in
                       zip(_float_outs(jrun(*diff)), cots))

        jg = jax.grad(jsum, argnums=tuple(range(len(keys))))(*diff0)
        with torch.enable_grad():
            total = sum((o * torch.from_numpy(c)).sum() for o, c in
                        zip(_float_outs(tout), cots))
            tg = torch.autograd.grad(total, tleaves, allow_unused=True)
        for (s, i), a, b, leaf in zip(keys, tg, jg, tleaves):
            a = torch.zeros_like(leaf) if a is None else a
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f"{op} d{s}[{i}]", **GRAD)
    return jout, tout


# ---------------------------------------------------------------------------
# one program, both packages
# ---------------------------------------------------------------------------


def build_both(build, grads=False):
    """``build(fluid)`` (called under each package's fresh programs and
    name generator) returns the fetch variables; with ``grads`` the
    first is a scalar loss and ``append_backward`` adds every
    parameter's gradient. Returns {which: (main, startup, fetch names,
    parameter names)}."""
    out = {}
    for which, pkg, _ in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            fetches = build(pkg)
            params = sorted(p.name for p in main.all_parameters())
            if grads:
                pkg.append_backward(fetches[0], parameter_list=params)
        out[which] = (main, startup, [f.name for f in fetches], params)
    assert out["jax"][2] == out["port"][2]
    assert out["jax"][3] == out["port"][3]
    return out


def reference_state(startup):
    """The reference's startup state as numpy, and in a JAX scope."""
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=jscope)
    state = {n: np.asarray(jscope.find_var(n)) for n in jscope.keys()
             if jscope.find_var(n) is not None}
    return jscope, state


def port_scope(state):
    return weights.load_state(tfluid.Scope(), state, CPU)


def program_pair(build, feed, grads=False, mode=None, return_numpy=True):
    """Build ``build`` in both packages, start both from the reference's
    startup state, run one step on ``feed`` (a make_feed spec) and
    compare every fetch whole (and, with ``grads``, every parameter's
    gradient at the gradient tier). Returns (reference fetches, port
    fetches)."""
    progs = build_both(build, grads)
    jm, js, names, params = progs["jax"]
    tm = progs["port"][0]
    jscope, state = reference_state(js)
    tscope = port_scope(state)
    fetch = names + ([p + "@GRAD" for p in params] if grads else [])
    jout = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=make_feed("jax", feed), fetch_list=fetch, scope=jscope,
        mode=mode, return_numpy=return_numpy)
    tout = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=make_feed("port", feed), fetch_list=fetch, scope=tscope,
        mode=mode, return_numpy=return_numpy)
    for i, (name, a, b) in enumerate(zip(fetch, tout, jout)):
        assert_same(a, b, GRAD if name.endswith("@GRAD") else FWD, name)
    return jout, tout
